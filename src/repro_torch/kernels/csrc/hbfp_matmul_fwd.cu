// Forward HBFP matmul for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the TPU kernel repro/kernels/hbfp_matmul.py: hbfp_matmul_pallas
// (body _matmul_kernel). It computes, for y[M,N] = x[M,K] . w[K,N],
//
//     y = sum over K-blocks kb, ascending, of part_kb * scale_kb
//
// with x quantized to m-bit mantissas with one exponent per (row, K-block)
// (or per (row, block) group), w either quantized per (bk x bn) tile (or
// per (block x block) group) or taken as given when the caller narrowed it
// already (quantize_w = 0, the serving path). Exponent groups follow the
// reference's (bk, bn) tiles, not this kernel's CTA tile: two small passes
// quantize x (and w) into scratch with their group scales, then the GEMM
// pass contracts. The passes and the GEMM live in hbfp_common.cuh, shared
// with the backward kernels (hbfp_matmul_bwd.cu).
//
// Exactness. Each K-block's partial sum is held on its own and added to
// the f32 accumulator in ascending K-block order with explicit
// round-to-nearest multiply and add (no FMA contraction), as the reference
// does. The partial sums are exact: integral mantissas (|q| <= 127 at
// m <= 8) against narrow or quantized weights give products below 2^14 in
// units of the tile's step and sums of at most a few hundred of them, so
// f32 FMA is exact; at 8 < m <= 12 the products reach 2^22 and the sums
// are taken in float64, exact, and rounded once. Only the block > 0 path
// (dequantized operands with varying exponents) is held to a tolerance.
// Rounding is round-half-even (rintf); the stochastic stream hashes the
// int32 global element index in uint32 arithmetic exactly as
// kernels/common.py does.
//
// Bound at the yi-9b serving shapes (H100 SXM, 3.35 TB/s, 989 TFLOP/s
// bf16): a generate tick at M = 8 moves the ~17 GB of bf16 weights once,
// 5.1 ms at the memory rate, with 2MKN far below the compute line, so
// decode is bytes-bound; a 512-token prefill does ~8.8 TFLOP, ~8.9 ms at
// the bf16 tensor-core rate, so it is bound by operations.
//
// What this simple design leaves on the table: it runs on CUDA cores in
// f32 (no mma/wgmma, no TMA, no cp.async pipelining), re-reads the
// quantized x scratch once per N-tile, and at M <= 16 a 16 x 64 CTA tile
// puts only N/64 CTAs on the 132 SMs. A later slice replaces the GEMM pass
// with bf16/int8 wgmma fed by TMA.

#include "hbfp_common.cuh"

using namespace hbfp;

// Plain C entry point. x: [M,K] f32 or bf16 (x_bf16); w: [K,N] f32 or bf16
// (w_bf16); y: [M,N] f32. Scratch, allocated by the caller: xq [M,K] f32,
// sx [M, K/gx] f32, and when quantize_w is set wq [K,N] f32 and
// sw [K/gk, N/gn] f32. (bk, bn) are the reference's clipped, block-aligned
// tiles; M, K, N must be multiples of them. Returns a cudaError_t code.
extern "C" int hbfp_matmul_fwd(const void* x, int x_bf16, const void* w,
                               int w_bf16, float* y, float* xq, float* sx,
                               float* wq, float* sw, int M, int K, int N,
                               int bk, int bn, int mbits, int stochastic,
                               int quantize_w, int block, int seed,
                               void* stream_ptr) {
  if (M <= 0 || K <= 0 || N <= 0 || bk <= 0 || bn <= 0 || K % bk ||
      N % bn || mbits < 2 || mbits > 12 || block < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool x_sub = block > 0 && block < bk;
  const bool w_sub = block > 0 && (block < bk || block < bn);
  const int gx = x_sub ? block : bk;
  const int gk = w_sub ? min(block, bk) : bk;
  const int gn = w_sub ? min(block, bn) : bn;
  if (bk % gx || (quantize_w && (bk % gk || bn % gn)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = quantize_w ? ((x_sub || w_sub) ? kModeDeq : kModeInt)
                              : (x_sub ? kModeDeq : kModeRawW);
  const int dequant = mode == kModeDeq;
  const uint32_t useed = static_cast<uint32_t>(seed);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  if (x_bf16)
    launch_quantize_rows<__nv_bfloat16>(x, xq, sx, M, K, gx, mbits,
                                        stochastic, useed, kStreamX, dequant,
                                        stream);
  else
    launch_quantize_rows<float>(x, xq, sx, M, K, gx, mbits, stochastic,
                                useed, kStreamX, dequant, stream);
  if (quantize_w) {
    if (w_bf16)
      launch_quantize_w<__nv_bfloat16>(w, wq, sw, K, N, gk, gn, mbits,
                                       stochastic, useed, dequant, stream);
    else
      launch_quantize_w<float>(w, wq, sw, K, N, gk, gn, mbits, stochastic,
                               useed, dequant, stream);
  }
  launch_gemm_case<false>(quantize_w, mode, mbits, w_bf16, xq, sx, w, wq,
                          sw, y, M, K, N, bk, bn, stream);
  return static_cast<int>(cudaGetLastError());
}
