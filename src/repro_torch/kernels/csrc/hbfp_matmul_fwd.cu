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
// pass contracts.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kExpFloor = -100;
constexpr int kExpCeil = 126;
constexpr uint32_t kStreamX = 0x00000000u;
constexpr uint32_t kStreamW = 0x40000000u;

enum Mode { kModeInt = 0, kModeRawW = 1, kModeDeq = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int max_exponent(float amax) {
  const uint32_t bits = __float_as_uint(amax);
  const int e = static_cast<int>((bits >> 23) & 0xFFu) - 127;
  return min(max(e, kExpFloor), kExpCeil);
}

__device__ __forceinline__ float pow2i(int e) {
  return __uint_as_float(static_cast<uint32_t>(e + 127) << 23);
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

__device__ __forceinline__ float uniform_from_index(uint32_t seed,
                                                    uint32_t idx) {
  uint32_t s = (idx * 0x9E3779B9u) ^ seed;
  s = xorshift32(xorshift32(s | 1u));
  return static_cast<float>((s >> 7) & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float quantize_val(float x, float delta, float lim,
                                              int stochastic, uint32_t seed,
                                              uint32_t idx) {
  float v = __fdiv_rn(x, delta);
  v = stochastic ? floorf(__fadd_rn(v, uniform_from_index(seed, idx)))
                 : rintf(v);
  return fminf(fmaxf(v, -lim), lim);
}

// One warp per (row, group of gx columns): amax, exponent, mantissas.
// xq gets integral mantissas, or mantissa * delta when dequant is set;
// sx[row, group] gets delta.
template <typename XT>
__global__ void quantize_x_kernel(const XT* __restrict__ x,
                                  float* __restrict__ xq,
                                  float* __restrict__ sx, int M, int K,
                                  int gx, int mbits, int stochastic,
                                  uint32_t seed, int dequant) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int ngroups = K / gx;
  if (warp >= M * ngroups) return;
  const int row = warp / ngroups;
  const int g = warp % ngroups;
  const size_t base = static_cast<size_t>(row) * K +
                      static_cast<size_t>(g) * gx;
  float amax = 0.0f;
  for (int c = lane; c < gx; c += 32) amax = fmaxf(amax, fabsf(to_f(x[base + c])));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float delta = pow2i(max_exponent(amax) - mbits + 2);
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  for (int c = lane; c < gx; c += 32) {
    const uint32_t idx = static_cast<uint32_t>(row) * static_cast<uint32_t>(K) +
                         static_cast<uint32_t>(g * gx + c) + kStreamX;
    const float q = quantize_val(to_f(x[base + c]), delta, lim, stochastic,
                                 seed, idx);
    xq[base + c] = dequant ? __fmul_rn(q, delta) : q;
  }
  if (lane == 0) sx[static_cast<size_t>(row) * ngroups + g] = delta;
}

// One CTA per (gk x gn) weight group: amax by block reduction, then the
// group's mantissas (or dequantized values) into wq and delta into sw.
template <typename WT>
__global__ void quantize_w_kernel(const WT* __restrict__ w,
                                  float* __restrict__ wq,
                                  float* __restrict__ sw, int K, int N,
                                  int gk, int gn, int mbits, int stochastic,
                                  uint32_t seed, int dequant) {
  __shared__ float red[32];
  const int n0 = blockIdx.x * gn;
  const int k0 = blockIdx.y * gk;
  const int count = gk * gn;
  float amax = 0.0f;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int r = t / gn, c = t % gn;
    amax = fmaxf(amax, fabsf(to_f(w[static_cast<size_t>(k0 + r) * N + n0 + c])));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int nwarps = blockDim.x >> 5;
    amax = threadIdx.x < nwarps ? red[threadIdx.x] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (threadIdx.x == 0) red[0] = amax;
  }
  __syncthreads();
  const float delta = pow2i(max_exponent(red[0]) - mbits + 2);
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int r = t / gn, c = t % gn;
    const size_t off = static_cast<size_t>(k0 + r) * N + n0 + c;
    const uint32_t idx =
        static_cast<uint32_t>(k0 + r) * static_cast<uint32_t>(N) +
        static_cast<uint32_t>(n0 + c) + kStreamW;
    const float q = quantize_val(to_f(w[off]), delta, lim, stochastic, seed, idx);
    wq[off] = dequant ? __fmul_rn(q, delta) : q;
  }
  if (threadIdx.x == 0) sw[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = delta;
}

constexpr int kTN = 64;       // CTA tile columns
constexpr int kKC = 32;       // K chunk staged in shared memory
constexpr int kThreads = 256; // 16 x 16 threads

__device__ __forceinline__ void mac(float& p, float a, float b) {
  p = fmaf(a, b, p);
}
__device__ __forceinline__ void mac(double& p, float a, float b) {
  p = fma(static_cast<double>(a), static_cast<double>(b), p);
}
__device__ __forceinline__ float part_f(float p) { return p; }
__device__ __forceinline__ float part_f(double p) { return __double2float_rn(p); }

// GEMM pass. CTA tile (16*RM) x 64; thread (tx, ty) owns rows ty + 16 i and
// columns tx + 16 j. Per K-block the partial sums live in `part`; at the
// block's end they are scaled and added to `acc` in K-block order.
template <int RM, int MODE, typename WT, typename PT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ xq, const float* __restrict__ sx,
            const WT* __restrict__ w, const float* __restrict__ sw,
            float* __restrict__ y, int M, int K, int N, int bk, int bn) {
  constexpr int TM = 16 * RM;
  constexpr int RN = kTN / 16;
  __shared__ float xs[kKC][TM + 1];
  __shared__ float ws[kKC][kTN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * kTN;
  const int nkb = K / bk;
  const int nbn = N / bn;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < nkb; ++kb) {
    PT part[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) part[i][j] = PT(0);

    for (int c0 = 0; c0 < bk; c0 += kKC) {
      const int klen = min(kKC, bk - c0);
      const int kbase = kb * bk + c0;
      __syncthreads();
      for (int e = threadIdx.x; e < TM * kKC; e += kThreads) {
        const int m = e / kKC, k = e % kKC;
        float v = 0.0f;
        if (m0 + m < M && k < klen)
          v = xq[static_cast<size_t>(m0 + m) * K + kbase + k];
        xs[k][m] = v;
      }
      for (int e = threadIdx.x; e < kKC * kTN; e += kThreads) {
        const int k = e / kTN, n = e % kTN;
        float v = 0.0f;
        if (n0 + n < N && k < klen)
          v = to_f(w[static_cast<size_t>(kbase + k) * N + n0 + n]);
        ws[k][n] = v;
      }
      __syncthreads();
      for (int k = 0; k < klen; ++k) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) mac(part[i][j], a[i], b[j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = min(m0 + ty + 16 * i, M - 1);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = min(n0 + tx + 16 * j, N - 1);
        const float p = part_f(part[i][j]);
        if (MODE == kModeInt) {
          const float s = __fmul_rn(sx[static_cast<size_t>(row) * nkb + kb],
                                    sw[static_cast<size_t>(kb) * nbn + col / bn]);
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(p, s));
        } else if (MODE == kModeRawW) {
          acc[i][j] = __fadd_rn(acc[i][j],
                                __fmul_rn(p, sx[static_cast<size_t>(row) * nkb + kb]));
        } else {
          acc[i][j] = __fadd_rn(acc[i][j], p);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) y[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

template <int MODE, typename WT, typename PT>
void launch_gemm(const float* xq, const float* sx, const void* w,
                 const float* sw, float* y, int M, int K, int N, int bk,
                 int bn, cudaStream_t stream) {
  const WT* wt = static_cast<const WT*>(w);
  if (M <= 16) {
    dim3 grid((N + kTN - 1) / kTN, (M + 15) / 16);
    gemm_kernel<1, MODE, WT, PT><<<grid, kThreads, 0, stream>>>(
        xq, sx, wt, sw, y, M, K, N, bk, bn);
  } else {
    dim3 grid((N + kTN - 1) / kTN, (M + 63) / 64);
    gemm_kernel<4, MODE, WT, PT><<<grid, kThreads, 0, stream>>>(
        xq, sx, wt, sw, y, M, K, N, bk, bn);
  }
}

}  // namespace

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

  const long long warps = static_cast<long long>(M) * (K / gx);
  const int qblocks = static_cast<int>((warps * 32 + kThreads - 1) / kThreads);
  if (x_bf16)
    quantize_x_kernel<__nv_bfloat16><<<qblocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), xq, sx, M, K, gx, mbits,
        stochastic, useed, dequant);
  else
    quantize_x_kernel<float><<<qblocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), xq, sx, M, K, gx, mbits, stochastic,
        useed, dequant);

  if (quantize_w) {
    dim3 grid(N / gn, K / gk);
    if (w_bf16)
      quantize_w_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(w), wq, sw, K, N, gk, gn, mbits,
          stochastic, useed, dequant);
    else
      quantize_w_kernel<float><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(w), wq, sw, K, N, gk, gn, mbits,
          stochastic, useed, dequant);
    if (mode == kModeInt) {
      if (mbits <= 8)
        launch_gemm<kModeInt, float, float>(xq, sx, wq, sw, y, M, K, N, bk, bn, stream);
      else
        launch_gemm<kModeInt, float, double>(xq, sx, wq, sw, y, M, K, N, bk, bn, stream);
    } else {
      launch_gemm<kModeDeq, float, float>(xq, sx, wq, sw, y, M, K, N, bk, bn, stream);
    }
  } else if (mode == kModeRawW) {
    if (w_bf16)
      launch_gemm<kModeRawW, __nv_bfloat16, float>(xq, sx, w, sw, y, M, K, N, bk, bn, stream);
    else
      launch_gemm<kModeRawW, float, float>(xq, sx, w, sw, y, M, K, N, bk, bn, stream);
  } else {
    if (w_bf16)
      launch_gemm<kModeDeq, __nv_bfloat16, float>(xq, sx, w, sw, y, M, K, N, bk, bn, stream);
    else
      launch_gemm<kModeDeq, float, float>(xq, sx, w, sw, y, M, K, N, bk, bn, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
