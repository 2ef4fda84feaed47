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
// pass contracts. The passes and the CUDA-core GEMM live in
// hbfp_common.cuh, the tensor-core GEMM in hbfp_gemm_sm90.cuh, both shared
// with B2 (hbfp_matmul_bwd.cu).
//
// Exactness. Each K-block's partial sum is held on its own and added to
// the f32 accumulator in ascending K-block order with explicit
// round-to-nearest multiply and add (no FMA contraction), as the reference
// does. The partial sums are exact: integral mantissas (|q| <= 127 at
// m <= 8) against narrow or quantized weights give products below 2^14 in
// units of the tile's step, summed exactly in int32 by the int8 wgmma
// and rounded once, or in f32 by the bf16 wgmma and the CUDA-core FMA,
// exact below 2^24 units; at 8 < m <= 12 the products reach 2^22 and the sums
// are taken in float64, exact, and rounded once. Only the block > 0 path
// (dequantized operands with varying exponents) is held to a tolerance.
// Rounding is round-half-even (rintf); the stochastic stream hashes the
// int32 global element index in uint32 arithmetic exactly as
// kernels/common.py does: the index in the one-process operand, so that a
// rank holding a part of x or w (a data shard's rows, a tensor-parallel
// column or row block) draws one process's numbers (IndexBase).
//
// Routes (tc_route in hbfp_gemm_sm90.cuh; the wrapper's gemm_route
// mirrors it). int8_wgmma: quantize_w set, no sub-tile groups, m <= 8 (the
// training forward): the row pass writes int8 mantissas, the weight pass
// int8 mantissas transposed to [N, K] (wgmma takes 8-bit operands K-major
// only), and the GEMM runs s8 x s8 -> s32 wgmma, exact per K-block.
// bf16_wgmma: quantize_w unset, no x sub-groups, bf16 weights, m <= 8 (the
// served projections, prefill, the adaptive path after a widen): bf16 x
// mantissas against w as stored, read MN-major by TMA, bf16 wgmma with f32
// sums. cuda_core: the rest (m 9-12, block > 0, f32 raw weights), on
// hbfp_common.cuh's f32 GEMM, unchanged.
//
// Bound on this card (H100 SXM: 3.35 TB/s, 1,979 TOP/s int8, 989 TFLOP/s
// bf16). A decode tick at M = 8 streams the ~17 GB of yi-9b's bf16
// weights once, 5.1 ms at the memory rate: bytes-bound, so at M <= 64 the
// K-blocks split across CTAs (an ordered fold keeps the sum bit for bit)
// until even N = 512 fills the 132 SMs. Training (gemma2-2b, M = 4096)
// and prefill do 2MKN operations far above 295 per byte: bound by the
// tensor-core rate, 0.33 ms a gemma2-2b layer in int8.
//
// What the design leaves on the table: inside a warpgroup the K-block's
// promotion waits for its wgmma group (the two consumer warpgroups overlap
// each other, but no second partial fragment overlaps a warpgroup's next
// K-block with its promotion: the int32 partial, the f32 accumulator and
// the 128 x 128 tile already fill the registers); a 128 x 128 int8 tile
// does 128 operations per byte it reads through L2, likely too few to
// feed the int8 tensor cores from L2 (its bandwidth is not measured here;
// no 2-CTA TMA multicast, no persistent tiles); the weight pass reads w with scalar loads and writes
// the transposed int8 tile element by element; and the quantized operands
// still make a round trip through device memory (int8 or bf16 now, a
// quarter or half of the former f32 scratch).

#include "hbfp_common.cuh"
#include "hbfp_gemm_sm90.cuh"

using namespace hbfp;

// Plain C entry point. x: [M,K] f32 or bf16 (x_bf16); w: [K,N] f32 or bf16
// (w_bf16); y: [M,N] f32. Scratch, allocated by the caller for the call's
// route, the other pointers null. cuda_core: xq [M,K] f32, sx [M, K/gx]
// f32, and when quantize_w is set wq [K,N] f32 and sw [K/gk, N/gn] f32.
// int8_wgmma: xq8 [M,K] int8, sx, wq8 [N,K] int8 (transposed), sw.
// bf16_wgmma: xq8 [M,K] bf16, sx. Both tensor-core routes at M <= 64 take
// part [K/bk, M, N] f32 when the K-blocks are split. (bk, bn) are the
// reference's clipped, block-aligned tiles; M, K, N must be multiples of
// them. A scratch set that does not match the route is refused. x_amax:
// null, or [M, K/gx] f32 group amaxes that the row pass takes instead of
// x's own (the global row max of a tensor-parallel shard). (x_row,
// x_col, x_ld) and (w_row, w_col, w_ld): each operand's part in the
// one-process operand, padded (IndexBase in hbfp_common.cuh; (0, 0, K)
// and (0, 0, N) for the whole operands); only stochastic rounding reads
// them. Returns a cudaError_t code.
extern "C" int hbfp_matmul_fwd(const void* x, int x_bf16, const void* w,
                               int w_bf16, float* y, float* xq, float* sx,
                               float* wq, float* sw, void* xq8, void* wq8,
                               float* part, int M, int K, int N, int bk,
                               int bn, int mbits, int stochastic,
                               int quantize_w, int block, int seed,
                               int x_row, int x_col, int x_ld, int w_row,
                               int w_col, int w_ld, const float* x_amax,
                               void* stream_ptr) {
  IndexBase xib, wib;
  if (M <= 0 || K <= 0 || N <= 0 || bk <= 0 || bn <= 0 || K % bk ||
      N % bn || mbits < 2 || mbits > 12 || block < 0 ||
      !make_base(x_row, x_col, x_ld, K, &xib) ||
      !make_base(w_row, w_col, w_ld, N, &wib))
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
  const int route = sm90::tc_route(quantize_w, mode, mbits, w_bf16, bk, bn, N);
  const bool i8 = route == sm90::kRouteInt8;

  if (route == sm90::kRouteCudaCore) {
    if (xq == nullptr || xq8 != nullptr || (quantize_w && wq == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (x_bf16)
      launch_quantize_rows<__nv_bfloat16>(x, xq, sx, M, K, gx, mbits,
                                          stochastic, useed, kStreamX, xib,
                                          dequant, stream,
          x_amax);
    else
      launch_quantize_rows<float>(x, xq, sx, M, K, gx, mbits, stochastic,
                                  useed, kStreamX, xib, dequant, stream,
          x_amax);
    if (quantize_w) {
      if (w_bf16)
        launch_quantize_w<__nv_bfloat16>(w, wq, sw, K, N, gk, gn, mbits,
                                         stochastic, useed, wib, dequant, stream);
      else
        launch_quantize_w<float>(w, wq, sw, K, N, gk, gn, mbits, stochastic,
                                 useed, wib, dequant, stream);
    }
    launch_gemm_case<false>(quantize_w, mode, mbits, w_bf16, xq, sx, w, wq,
                            sw, y, M, K, N, bk, bn, stream);
    return static_cast<int>(cudaGetLastError());
  }

  if (xq8 == nullptr || xq != nullptr || i8 != (wq8 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (i8) {
    int8_t* q = static_cast<int8_t*>(xq8);
    if (x_bf16)
      launch_quantize_rows<__nv_bfloat16>(x, q, sx, M, K, bk, mbits,
                                          stochastic, useed, kStreamX, xib, 0,
                                          stream,
          x_amax);
    else
      launch_quantize_rows<float>(x, q, sx, M, K, bk, mbits, stochastic,
                                  useed, kStreamX, xib, 0, stream,
          x_amax);
    int8_t* qw = static_cast<int8_t*>(wq8);
    if (w_bf16)
      launch_quantize_w<__nv_bfloat16, int8_t, true>(
          w, qw, sw, K, N, bk, bn, mbits, stochastic, useed, wib, 0, stream);
    else
      launch_quantize_w<float, int8_t, true>(w, qw, sw, K, N, bk, bn, mbits,
                                             stochastic, useed, wib, 0, stream);
  } else {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(xq8);
    if (x_bf16)
      launch_quantize_rows<__nv_bfloat16>(x, q, sx, M, K, bk, mbits,
                                          stochastic, useed, kStreamX, xib, 0,
                                          stream,
          x_amax);
    else
      launch_quantize_rows<float>(x, q, sx, M, K, bk, mbits, stochastic,
                                  useed, kStreamX, xib, 0, stream,
          x_amax);
  }
  const cudaError_t e = sm90::tc_gemm<false>(
      route, !i8, xq8, sx, i8 ? wq8 : w, sw, y, part, M, K, N, bk, bn,
      mbits, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
