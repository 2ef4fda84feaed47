"""Hand-written Hopper kernels of the port and their plain versions.

Every TPU kernel of the reference has its counterpart here: the three
HBFP GEMMs of training (`hbfp_matmul.hbfp_matmul_fwd`, `hbfp_dgrad`,
`hbfp_wgrad`; CUDA C++ in `csrc/hbfp_matmul_fwd.cu` and
`csrc/hbfp_matmul_bwd.cu` over the shared `csrc/hbfp_common.cuh`), the
flash attention forward and backward (`hbfp_flash_attn.hbfp_flash_fwd`,
`hbfp_flash_dq`, `hbfp_flash_dkv`; `csrc/hbfp_flash_attn.cu`) and the
FP→BFP conversion with its fused stats (`bfp_quantize.bfp_quantize`;
`csrc/bfp_quantize.cu`), which the numerics taps and packed checkpoints
run.
"""
