"""Training substrate of the port (the reference's ``repro.training``):
optimizers on dict trees of tensors (``optimizer``), int8 gradient
compression with error feedback (``compression``), checkpoints in the
reference's on-disk format (``checkpoint``) and the supervised step loop
with restart (``fault_tolerance``, a verbatim copy)."""
