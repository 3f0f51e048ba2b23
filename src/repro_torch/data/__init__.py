"""Data pipeline of the port (the reference's ``repro.data``): the
synthetic corpus and packed loader, batches bitwise the reference's."""
