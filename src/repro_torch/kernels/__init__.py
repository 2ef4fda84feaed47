"""Hand-written Hopper kernels of the port and their plain versions.

Ported: the three HBFP GEMMs of training (`hbfp_matmul.hbfp_matmul_fwd`,
`hbfp_dgrad`, `hbfp_wgrad`; CUDA C++ in `csrc/hbfp_matmul_fwd.cu` and
`csrc/hbfp_matmul_bwd.cu` over the shared `csrc/hbfp_common.cuh`). Flash
attention and the packing quantizer are queued in ROADMAP section B.
"""
