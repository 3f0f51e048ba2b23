"""Transformer model of the port (reference layout): full-sequence and
paged forwards."""
