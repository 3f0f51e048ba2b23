"""Paged transformer model of the port (reference layout)."""
