// Backward HBFP GEMMs for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// hbfp_dgrad replaces the TPU kernel repro/kernels/hbfp_matmul.py:
// hbfp_dgrad_pallas (body _dgrad_kernel):
//
//     dx[M,K] = sum over N-blocks nb, ascending, of part_nb * scale_nb,
//     part_nb = Q_row(g)[M, nb] . Q_tile(w)[K, nb]^T
//
// g is quantized per (row, bn-wide N-block) (or per (row, block) group) on
// the STREAM_G offset; w per (bk x bn) tile (or (block x block) group) on
// STREAM_W with its own element index, the forward's, so a matching tiling
// replays the forward's draws; quantize_w = 0 takes w as given (narrowed
// upstream). w is read in its stored [K, N] layout and contracted along its
// rows: nothing is transposed in memory. The quantize passes and the GEMM
// passes are B1's (hbfp_common.cuh, hbfp_gemm_sm90.cuh) with the
// contraction over N, so B2 keeps B1's exactness: each N-block's partial
// sum is exact (integral mantissas; int32 on the int8 route, f32 on the
// bf16 and CUDA-core routes at m <= 8, float64 above) and the partial
// sums are added in ascending N-block order with explicit round-to-nearest
// multiply and add.
// For block = 0 B2 equals its plain version (hbfp_dgrad_plain) bit for bit.
//
// hbfp_wgrad replaces hbfp_matmul.py: hbfp_wgrad_pallas (body
// _wgrad_kernel):
//
//     dw[K,N] = sum over tokens m of x^[m,K] (outer) g^[m,N]
//
// with x^ = Q_row(x) * dx per (row, bk-wide K-block) on STREAM_X (B1's x
// pass, so the forward's quantization is replayed when the tiles match)
// and g^ = Q_row(g) * dg per (row, bn-wide N-block) on STREAM_G, both
// dequantized in scratch. The per-token scales ride the contraction, so
// the f32 sum depends on its order; the reference and the plain version
// add one f32 product per M-block of bm tokens, in ascending order. B3 is
// held to its plain version within 2·M·2^-24·(|x^|^T|g^|), and its
// quantized operands bit for bit.
//
// B3's routes (wgrad_route below; the wrapper's `wgrad_route` mirrors
// it). bf16_wgmma (m <= 8: every training call): the row passes write x^
// and g^ in bf16, which is exact. Each value is q * delta with |q| <= 127
// (seven significant bits of bf16's eight) and delta = 2^(e - m + 2),
// e in [-100, 126], so |q * delta| lies in [2^-106, 127 * 2^120]: always
// a normal bf16, never a subnormal, whatever the exponent groups (block >
// 0 included). Each product of two such values has at most 14 significant
// bits and is exact in f32 unless it falls below f32's normal range
// (2^-126, products of two operands near their floors, which this
// argument leaves out). The GEMM (tc_wgrad below, on the engine of
// hbfp_gemm_sm90.cuh) reads x^ [M, K] and g^ [M, N] as stored, both
// MN-major, and contracts over tokens: each M-block of bm tokens runs in its own f32 fragment (the
// tensor core's accumulation inside one block is its own) and is added
// in ascending M-block order with __fadd_rn, the plain version's order of
// blocks. cuda_core (m 9-12, or tiles the tensor cores do not take): f32
// scratch and the CUDA-core GEMM below, tokens in ascending order.
//
// Bound at gemma2-2b's training shapes (M = 4096 tokens, H100 SXM):
// every projection does 2MKN operations over a few hundred MB, far above
// the 295 operations per byte at which the tensor cores become the limit,
// so both are bound by operations: 0.32 ms a layer for B2 at the int8 rate
// (m <= 8 mantissas are exact in int8), 0.65 ms for B3 at the bf16 rate
// (its dequantized m <= 8 operands are exact in bf16).
//
// B2's routes are B1's (hbfp_gemm_sm90.cuh: tc_route). int8_wgmma (the
// training dgrad): g's int8 mantissas [M, N] against w's int8 mantissas
// in w's own [K, N] layout, which is K-major for a contraction over N, so
// nothing is transposed; s8 x s8 -> s32 wgmma, exact per N-block.
// bf16_wgmma (the adaptive path after a widen: w narrowed upstream, bf16):
// g's bf16 mantissas against w as stored. cuda_core: the rest, unchanged.
// At M <= 64 the N-blocks split across CTAs with B1's ordered fold.
//
// What the design leaves on the table: B2 shares B1's (the promotion
// waits for its wgmma group inside a warpgroup, the 128 x 128 tile is
// bound by L2 bytes before the tensor cores, scalar weight pass). B3's
// bf16 operands still make a round trip through device memory (half the
// former f32 scratch), and its M-block promotion waits for the block's
// wgmma group as B1's does.

#include "hbfp_common.cuh"
#include "hbfp_gemm_sm90.cuh"

using namespace hbfp;

namespace {

// B3's route (the wrapper's `wgrad_route` mirrors it): bf16 wgmma where
// the dequantized operands are exact in bf16 (m <= 8), the M-block is a
// whole number of 64-token stages and both operands' rows are 16-byte
// multiples for TMA; else the CUDA cores.
int wgrad_route(int mbits, int M, int K, int N, int bm) {
  if (mbits <= 8 && bm % 64 == 0 && M % bm == 0 && K % 8 == 0 && N % 8 == 0)
    return sm90::kRouteBf16;
  return sm90::kRouteCudaCore;
}

// B3's GEMM on the bf16 route: dw[K, N] = sum over M-blocks mb of bm
// tokens, ascending, of part_mb = xh[mb, K]^T . gh[mb, N], with xh [M, K]
// and gh [M, N] the dequantized bf16 operands as stored, both read
// MN-major (the contraction runs down their rows), promoted with scale
// 1.0: acc = __fadd_rn(acc, part_mb), as the plain version adds one f32
// product per M-block. part: [M/bm, K, N] f32 when decode_splits() > 1
// (K <= 64), folded in ascending order.
cudaError_t tc_wgrad(const void* xh, const void* gh, float* dw, float* part,
                     int M, int K, int N, int bm, cudaStream_t st) {
  const int nwg = K <= sm90::kSmallM ? 1 : 2;
  const int splits = sm90::decode_splits(K, N, M / bm);
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!sm90::encode_map(&ta, xh, false, M, K, 64, 64) ||
      !sm90::encode_map(&tb, gh, false, M, N, 64, 64))
    return cudaErrorInvalidValue;
  return nwg == 1
      ? sm90::launch_tc<1, false, true, false, true>(ta, tb, nullptr, nullptr, dw, part, K, M, N, bm, N, splits, 0, st)
      : sm90::launch_tc<2, false, true, false, true>(ta, tb, nullptr, nullptr, dw, part, K, M, N, bm, N, splits, 0, st);
}

// dw[K, N] = xq[M, K]^T . gq[M, N] over dequantized operands. CTA tile
// 64 x 64 of dw; thread (tx, ty) owns rows ty + 16 i and columns tx + 16 j
// and adds the tokens in ascending order.
__global__ void __launch_bounds__(kThreads)
wgrad_gemm_kernel(const float* __restrict__ xq, const float* __restrict__ gq,
                  float* __restrict__ dw, int M, int K, int N) {
  constexpr int R = kTN / 16;
  __shared__ float xs[kKC][kTN + 1];
  __shared__ float gs[kKC][kTN + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.y * kTN;
  const int n0 = blockIdx.x * kTN;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;

  for (int mm = 0; mm < M; mm += kKC) {
    const int mlen = min(kKC, M - mm);
    __syncthreads();
    for (int e = threadIdx.x; e < kKC * kTN; e += kThreads) {
      const int m = e / kTN, c = e % kTN;
      float xv = 0.0f, gv = 0.0f;
      if (m < mlen) {
        if (k0 + c < K) xv = xq[static_cast<size_t>(mm + m) * K + k0 + c];
        if (n0 + c < N) gv = gq[static_cast<size_t>(mm + m) * N + n0 + c];
      }
      xs[m][c] = xv;
      gs[m][c] = gv;
    }
    __syncthreads();
    for (int m = 0; m < mlen; ++m) {
      float av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = xs[m][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = gs[m][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= K) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) dw[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry point of B2. g: [M,N] f32 or bf16 (g_bf16); w: [K,N] f32
// or bf16 (w_bf16); dx: [M,K] f32. Scratch, allocated by the caller for
// the call's route, the other pointers null. cuda_core: gq [M,N] f32,
// sg [M, N/gg] f32, and when quantize_w is set wq [K,N] f32 and
// sw [K/gk, N/gn] f32. int8_wgmma: gq8 [M,N] int8, sg, wq8 [K,N] int8,
// sw. bf16_wgmma: gq8 [M,N] bf16, sg. Both tensor-core routes at M <= 64
// take part [N/bn, M, K] f32 when the N-blocks are split. (bk, bn) are
// the reference's clipped, block-aligned tiles; K and N must be multiples
// of them. A scratch set that does not match the route is refused.
// g_amax: null, or [M, N/gg] f32 group amaxes taken instead of g's own.
// (g_row, g_col, g_ld), (w_row, w_col, w_ld): the operands' parts in the
// one-process operands (IndexBase in hbfp_common.cuh; (0, 0, N) and
// (0, 0, N) whole). Returns a cudaError_t code.
extern "C" int hbfp_dgrad(const void* g, int g_bf16, const void* w,
                          int w_bf16, float* dx, float* gq, float* sg,
                          float* wq, float* sw, void* gq8, void* wq8,
                          float* part, int M, int K, int N, int bk, int bn,
                          int mbits, int stochastic, int quantize_w,
                          int block, int seed, int g_row, int g_col,
                          int g_ld, int w_row, int w_col, int w_ld,
                          const float* g_amax, void* stream_ptr) {
  IndexBase gib, wib;
  if (M <= 0 || K <= 0 || N <= 0 || bk <= 0 || bn <= 0 || K % bk ||
      N % bn || mbits < 2 || mbits > 12 || block < 0 ||
      !make_base(g_row, g_col, g_ld, N, &gib) ||
      !make_base(w_row, w_col, w_ld, N, &wib))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool g_sub = block > 0 && block < bn;
  const bool w_sub = block > 0 && (block < bk || block < bn);
  const int gg = g_sub ? block : bn;
  const int gk = w_sub ? min(block, bk) : bk;
  const int gn = w_sub ? min(block, bn) : bn;
  if (bn % gg || (quantize_w && (bk % gk || bn % gn)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = quantize_w ? ((g_sub || w_sub) ? kModeDeq : kModeInt)
                              : (g_sub ? kModeDeq : kModeRawW);
  const int dequant = mode == kModeDeq;
  const uint32_t useed = static_cast<uint32_t>(seed);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // contraction over N (blocks of bn), output columns over K (tiles of bk)
  const int route = sm90::tc_route(quantize_w, mode, mbits, w_bf16, bn, bk, 0);
  const bool i8 = route == sm90::kRouteInt8;

  if (route == sm90::kRouteCudaCore) {
    if (gq == nullptr || gq8 != nullptr || (quantize_w && wq == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (g_bf16)
      launch_quantize_rows<__nv_bfloat16>(g, gq, sg, M, N, gg, mbits,
                                          stochastic, useed, kStreamG, gib,
                                          dequant, stream,
          g_amax);
    else
      launch_quantize_rows<float>(g, gq, sg, M, N, gg, mbits, stochastic,
                                  useed, kStreamG, gib, dequant, stream,
          g_amax);
    if (quantize_w) {
      if (w_bf16)
        launch_quantize_w<__nv_bfloat16>(w, wq, sw, K, N, gk, gn, mbits,
                                         stochastic, useed, wib, dequant, stream);
      else
        launch_quantize_w<float>(w, wq, sw, K, N, gk, gn, mbits, stochastic,
                                 useed, wib, dequant, stream);
    }
    launch_gemm_case<true>(quantize_w, mode, mbits, w_bf16, gq, sg, w, wq,
                           sw, dx, M, N, K, bn, bk, stream);
    return static_cast<int>(cudaGetLastError());
  }

  if (gq8 == nullptr || gq != nullptr || i8 != (wq8 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (i8) {
    int8_t* q = static_cast<int8_t*>(gq8);
    if (g_bf16)
      launch_quantize_rows<__nv_bfloat16>(g, q, sg, M, N, bn, mbits,
                                          stochastic, useed, kStreamG, gib, 0,
                                          stream,
          g_amax);
    else
      launch_quantize_rows<float>(g, q, sg, M, N, bn, mbits, stochastic,
                                  useed, kStreamG, gib, 0, stream,
          g_amax);
    int8_t* qw = static_cast<int8_t*>(wq8);
    if (w_bf16)
      launch_quantize_w<__nv_bfloat16, int8_t>(w, qw, sw, K, N, bk, bn,
                                               mbits, stochastic, useed, wib, 0,
                                               stream);
    else
      launch_quantize_w<float, int8_t>(w, qw, sw, K, N, bk, bn, mbits,
                                       stochastic, useed, wib, 0, stream);
  } else {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(gq8);
    if (g_bf16)
      launch_quantize_rows<__nv_bfloat16>(g, q, sg, M, N, bn, mbits,
                                          stochastic, useed, kStreamG, gib, 0,
                                          stream,
          g_amax);
    else
      launch_quantize_rows<float>(g, q, sg, M, N, bn, mbits, stochastic,
                                  useed, kStreamG, gib, 0, stream,
          g_amax);
  }
  const cudaError_t e = sm90::tc_gemm<true>(
      route, false, gq8, sg, i8 ? wq8 : w, sw, dx, part, M, N, K, bn, bk,
      mbits, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Plain C entry point of B3. x: [M,K] f32 or bf16 (x_bf16); g: [M,N] f32
// or bf16 (g_bf16); dw: [K,N] f32. Scratch, allocated by the caller for
// the call's route, the other pointers null; the dequantized operands are
// readable after the call. cuda_core: xq [M,K] f32, gq [M,N] f32.
// bf16_wgmma: xh [M,K] bf16, gh [M,N] bf16, and part [M/bm, K, N] f32
// when the M-blocks are split (K <= 64). Both: sx [M, K/gx] f32,
// sg [M, N/gg] f32. K and N must be multiples of (bk, bn), M of bm. A
// scratch set that does not match the route is refused. x_amax, g_amax:
// null, or the operand's [M, K/gx] / [M, N/gg] f32 group amaxes taken
// instead of its own. (x_row, x_col, x_ld), (g_row, g_col, g_ld): the
// operands' parts in the one-process operands (IndexBase; (0, 0, K) and
// (0, 0, N) whole). Returns a cudaError_t code.
extern "C" int hbfp_wgrad(const void* x, int x_bf16, const void* g,
                          int g_bf16, float* dw, float* xq, float* sx,
                          float* gq, float* sg, void* xh, void* gh,
                          float* part, int M, int K, int N, int bm, int bk,
                          int bn, int mbits, int stochastic, int block,
                          int seed, int x_row, int x_col, int x_ld,
                          int g_row, int g_col, int g_ld,
                          const float* x_amax, const float* g_amax,
                          void* stream_ptr) {
  IndexBase xib, gib;
  if (M <= 0 || K <= 0 || N <= 0 || bm <= 0 || bk <= 0 || bn <= 0 ||
      M % bm || K % bk || N % bn || mbits < 2 || mbits > 12 || block < 0 ||
      !make_base(x_row, x_col, x_ld, K, &xib) ||
      !make_base(g_row, g_col, g_ld, N, &gib))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gx = (block > 0 && block < bk) ? block : bk;
  const int gg = (block > 0 && block < bn) ? block : bn;
  if (bk % gx || bn % gg) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t useed = static_cast<uint32_t>(seed);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  if (wgrad_route(mbits, M, K, N, bm) == sm90::kRouteBf16) {
    if (xh == nullptr || gh == nullptr || xq != nullptr || gq != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(xh);
    __nv_bfloat16* gb = static_cast<__nv_bfloat16*>(gh);
    if (x_bf16)
      launch_quantize_rows<__nv_bfloat16>(x, xb, sx, M, K, gx, mbits,
                                          stochastic, useed, kStreamX, xib, 1,
                                          stream,
          x_amax);
    else
      launch_quantize_rows<float>(x, xb, sx, M, K, gx, mbits, stochastic,
                                  useed, kStreamX, xib, 1, stream,
          x_amax);
    if (g_bf16)
      launch_quantize_rows<__nv_bfloat16>(g, gb, sg, M, N, gg, mbits,
                                          stochastic, useed, kStreamG, gib, 1,
                                          stream,
          g_amax);
    else
      launch_quantize_rows<float>(g, gb, sg, M, N, gg, mbits, stochastic,
                                  useed, kStreamG, gib, 1, stream,
          g_amax);
    const cudaError_t e = tc_wgrad(xh, gh, dw, part, M, K, N, bm,
                                         stream);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }

  if (xq == nullptr || gq == nullptr || xh != nullptr || gh != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    launch_quantize_rows<__nv_bfloat16>(x, xq, sx, M, K, gx, mbits,
                                        stochastic, useed, kStreamX, xib, 1,
                                        stream,
          x_amax);
  else
    launch_quantize_rows<float>(x, xq, sx, M, K, gx, mbits, stochastic,
                                useed, kStreamX, xib, 1, stream,
          x_amax);
  if (g_bf16)
    launch_quantize_rows<__nv_bfloat16>(g, gq, sg, M, N, gg, mbits,
                                        stochastic, useed, kStreamG, gib, 1,
                                        stream,
          g_amax);
  else
    launch_quantize_rows<float>(g, gq, sg, M, N, gg, mbits, stochastic,
                                useed, kStreamG, gib, 1, stream,
          g_amax);
  dim3 grid((N + kTN - 1) / kTN, (K + kTN - 1) / kTN);
  wgrad_gemm_kernel<<<grid, kThreads, 0, stream>>>(xq, gq, dw, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
