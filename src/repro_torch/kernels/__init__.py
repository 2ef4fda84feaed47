"""Hand-written Hopper kernels of the port and their plain versions.

Ported: the forward HBFP matmul (`hbfp_matmul.hbfp_matmul_fwd`, CUDA C++
in `csrc/hbfp_matmul_fwd.cu`). The backward GEMMs, flash attention and the
packing quantizer are queued in ROADMAP section B.
"""
