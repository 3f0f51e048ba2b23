"""PyTorch/CUDA port of the serving system (``repro``), run on an NVIDIA
H100.  Same sub-package layout as ``repro``; the paged decode attention
kernels are hand-written CUDA for Hopper (``csrc/``)."""
