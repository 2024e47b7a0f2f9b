# The erasure-coding dataplane's tile kernels: a GF(256) product of one
# coefficient row with K source slabs per tile, and a K-way XOR per tile,
# written in CUDA C++ for Hopper (csrc/ragged_tiles.cu) behind four
# entries in ops.py. Submodules are imported where used; nothing here
# builds or loads the CUDA library (kernels/_build.py does, at first use).
from repro_torch.kernels import backend

__all__ = ["backend"]
