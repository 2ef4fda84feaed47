// Shared device code of the HBFP GEMM kernels for Hopper (sm_90a): the
// exponent and rounding helpers, the two quantize passes and the CUDA-core
// GEMM pass with exact per-block partial sums (the `cuda_core` route; the
// tensor-core routes are in hbfp_gemm_sm90.cuh). hbfp_matmul_fwd.cu (B1)
// and hbfp_matmul_bwd.cu (B2 dgrad, B3 wgrad) include it; each build
// hashes both headers together with its source.
//
// Quantization follows repro_torch/kernels/common.py bit for bit:
// exponent floor(log2 amax) from the f32 bit field, clamped to
// [-100, 126]; step delta = 2^(e - m + 2); round half to even (rintf) or
// floor(v + u) with u from the paper's xorshift stream, hashed in uint32
// on the int32 global element index plus the operand's stream offset.
// The global index is the element's in the operand one process quantizes
// (IndexBase): a rank that holds a part of it draws one process's
// numbers there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hbfp {

constexpr int kExpFloor = -100;
constexpr int kExpCeil = 126;
constexpr uint32_t kStreamX = 0x00000000u;
constexpr uint32_t kStreamG = 0x20000000u;
constexpr uint32_t kStreamW = 0x40000000u;

// kModeInt: integral mantissas on both sides, partial * (s_a * s_w);
// kModeRawW: integral rows against the given (pre-narrowed) w,
// partial * s_a; kModeDeq: dequantized operands, partial added as is.
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

// The reciprocal 2^(m - 2 - e) of a group's step 2^(e - m + 2), e the
// clamped exponent of amax: a normal f32 for every e in [-100, 126] and
// 2 <= m <= 16, so x * inv_step is the same real as x / step and rounds
// to the same f32, subnormal quotients included. The quantizers multiply
// by it where the CUDA-core kernels divide, bit for bit alike.
__device__ __forceinline__ float inv_step(float amax, int mbits) {
  return pow2i(mbits - 2 - max_exponent(amax));
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

// Where an operand's part lies in the one-process operand, both padded
// to their tiles: local element (r, c) draws at index
// (row_off + r) * ld + col_off + c (+ the operand's stream offset), in
// uint32, so it wraps exactly as the one-process int32 index does.
// {0, 0, C} is the whole [R, C] operand. Kernels/common.py: flat_base.
struct IndexBase {
  uint32_t row_off, col_off, ld;
};

__device__ __forceinline__ uint32_t base_index(const IndexBase& b,
                                               uint32_t r, uint32_t c) {
  return (b.row_off + r) * b.ld + b.col_off + c;
}

__device__ __forceinline__ float quantize_val(float x, float delta, float lim,
                                              int stochastic, uint32_t seed,
                                              uint32_t idx) {
  float v = __fdiv_rn(x, delta);
  v = stochastic ? floorf(__fadd_rn(v, uniform_from_index(seed, idx)))
                 : rintf(v);
  return fminf(fmaxf(v, -lim), lim);
}

constexpr int kThreads = 256;  // every kernel here runs 256 threads

// Mantissa stores of the quantize passes: f32 as computed, or the
// integral m <= 8 mantissa as int8 or bf16 (both exact) for the
// tensor-core GEMMs (hbfp_gemm_sm90.cuh).
__device__ __forceinline__ void store_q(float* q, size_t i, float v) {
  q[i] = v;
}
__device__ __forceinline__ void store_q(int8_t* q, size_t i, float v) {
  q[i] = static_cast<int8_t>(__float2int_rn(v));
}
__device__ __forceinline__ void store_q(__nv_bfloat16* q, size_t i, float v) {
  q[i] = __float2bfloat16_rn(v);
}

// Row pass. One warp per (row, group of gx columns) of a [M, C] operand:
// amax, exponent, mantissas. q gets integral mantissas (f32, or int8/bf16
// for QT of the tensor-core routes), or mantissa * delta when dequant is
// set; s[row, group] gets delta. `stream` is the operand's offset in the
// stochastic stream (kStreamX, kStreamG), `ib` its part's index base. A
// non-null amax_in [M, C/gx]
// (one value per row when the row is one group) is taken as each group's
// amax instead of the group's own: the global row max of a row whose
// columns are split over tensor-parallel ranks, so that every rank's part
// takes the one-process exponent.
template <typename XT, typename QT = float>
__global__ void quantize_rows_kernel(const XT* __restrict__ x,
                                     QT* __restrict__ q,
                                     float* __restrict__ s, int M, int C,
                                     int gx, int mbits, int stochastic,
                                     uint32_t seed, uint32_t stream,
                                     IndexBase ib, int dequant,
                                     const float* __restrict__ amax_in) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int ngroups = C / gx;
  if (warp >= M * ngroups) return;
  const int row = warp / ngroups;
  const int g = warp % ngroups;
  const size_t base = static_cast<size_t>(row) * C +
                      static_cast<size_t>(g) * gx;
  float amax = 0.0f;
  if (amax_in != nullptr) {
    amax = amax_in[static_cast<size_t>(row) * ngroups + g];
  } else {
    for (int c = lane; c < gx; c += 32)
      amax = fmaxf(amax, fabsf(to_f(x[base + c])));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float delta = pow2i(max_exponent(amax) - mbits + 2);
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  for (int c = lane; c < gx; c += 32) {
    const uint32_t idx = base_index(ib, static_cast<uint32_t>(row),
                                    static_cast<uint32_t>(g * gx + c)) +
                         stream;
    const float v = quantize_val(to_f(x[base + c]), delta, lim, stochastic,
                                 seed, idx);
    store_q(q, base + c, dequant ? __fmul_rn(v, delta) : v);
  }
  if (lane == 0) s[static_cast<size_t>(row) * ngroups + g] = delta;
}

// Weight pass. One CTA per (gk x gn) group of w [K, N]: amax by block
// reduction, then the group's mantissas (or dequantized values) into wq
// and delta into sw [K/gk, N/gn]. TRANS writes wq transposed, [N, K]
// (the forward's int8 operand, K-major for wgmma), threads running along
// K. The stream index is w's own element index (at its part's base `ib`),
// so the forward and dgrad replay the same draws.
template <typename WT, typename QT = float, bool TRANS = false>
__global__ void quantize_w_kernel(const WT* __restrict__ w,
                                  QT* __restrict__ wq,
                                  float* __restrict__ sw, int K, int N,
                                  int gk, int gn, int mbits, int stochastic,
                                  uint32_t seed, IndexBase ib, int dequant) {
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
    const int r = TRANS ? t % gk : t / gn, c = TRANS ? t / gk : t % gn;
    const size_t off = static_cast<size_t>(k0 + r) * N + n0 + c;
    const uint32_t idx = base_index(ib, static_cast<uint32_t>(k0 + r),
                                    static_cast<uint32_t>(n0 + c)) +
                         kStreamW;
    const float q = quantize_val(to_f(w[off]), delta, lim, stochastic, seed, idx);
    store_q(wq, TRANS ? static_cast<size_t>(n0 + c) * K + k0 + r : off,
            dequant ? __fmul_rn(q, delta) : q);
  }
  if (threadIdx.x == 0) sw[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = delta;
}

template <typename XT, typename QT = float>
void launch_quantize_rows(const void* x, QT* q, float* s, int M, int C,
                          int gx, int mbits, int stochastic, uint32_t seed,
                          uint32_t stream, IndexBase ib, int dequant,
                          cudaStream_t st, const float* amax_in = nullptr) {
  const long long warps = static_cast<long long>(M) * (C / gx);
  const int blocks = static_cast<int>((warps * 32 + kThreads - 1) / kThreads);
  quantize_rows_kernel<XT, QT><<<blocks, kThreads, 0, st>>>(
      static_cast<const XT*>(x), q, s, M, C, gx, mbits, stochastic, seed,
      stream, ib, dequant, amax_in);
}

template <typename WT, typename QT = float, bool TRANS = false>
void launch_quantize_w(const void* w, QT* wq, float* sw, int K, int N,
                       int gk, int gn, int mbits, int stochastic,
                       uint32_t seed, IndexBase ib, int dequant,
                       cudaStream_t st) {
  dim3 grid(N / gn, K / gk);
  quantize_w_kernel<WT, QT, TRANS><<<grid, kThreads, 0, st>>>(
      static_cast<const WT*>(w), wq, sw, K, N, gk, gn, mbits, stochastic,
      seed, ib, dequant);
}

// The index base an entry point takes for a [rows, cols] operand: its
// part at (row_off, col_off) of a one-process operand `ld` long a row.
// false when the part's columns pass the row.
inline bool make_base(int row_off, int col_off, int ld, int cols,
                      IndexBase* out) {
  if (row_off < 0 || col_off < 0 || ld <= 0 ||
      static_cast<long long>(col_off) + cols > ld)
    return false;
  *out = IndexBase{static_cast<uint32_t>(row_off),
                   static_cast<uint32_t>(col_off),
                   static_cast<uint32_t>(ld)};
  return true;
}

constexpr int kTN = 64;  // CTA tile columns
constexpr int kKC = 32;  // contraction chunk staged in shared memory

__device__ __forceinline__ void mac(float& p, float a, float b) {
  p = fmaf(a, b, p);
}
__device__ __forceinline__ void mac(double& p, float a, float b) {
  p = fma(static_cast<double>(a), static_cast<double>(b), p);
}
__device__ __forceinline__ float part_f(float p) { return p; }
__device__ __forceinline__ float part_f(double p) { return __double2float_rn(p); }

// GEMM pass: y[M, O] = sum over contraction blocks cb, ascending, of
// part_cb scaled per MODE. a: [M, C] quantized rows with scales
// sa[M, C/cblk]. w: [C, O] as stored (W_T false, the forward), or [O, C]
// read as stored and contracted along its rows (W_T true, dgrad: no
// transpose in memory); sw holds w's tile scales in w's own [rows/gk,
// cols/gn] layout. CTA tile (16*RM) x 64; thread (tx, ty) owns rows
// ty + 16 i and columns tx + 16 j. Each block's partial sums live in
// `part` (exact: integral mantissas, f32 at m <= 8, float64 above) and are
// added to `acc` at the block's end with explicit round-to-nearest
// multiply and add, so the compiler cannot contract them into an FMA.
template <int RM, int MODE, bool W_T, typename WT, typename PT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ sa,
            const WT* __restrict__ w, const float* __restrict__ sw,
            float* __restrict__ y, int M, int C, int O, int cblk, int oblk) {
  constexpr int TM = 16 * RM;
  constexpr int RN = kTN / 16;
  __shared__ float as[kKC][TM + 1];
  __shared__ float ws[kKC][kTN + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * TM;
  const int o0 = blockIdx.x * kTN;
  const int ncb = C / cblk;
  const int nob = O / oblk;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  for (int cb = 0; cb < ncb; ++cb) {
    PT part[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) part[i][j] = PT(0);

    for (int c0 = 0; c0 < cblk; c0 += kKC) {
      const int clen = min(kKC, cblk - c0);
      const int cbase = cb * cblk + c0;
      __syncthreads();
      for (int e = threadIdx.x; e < TM * kKC; e += kThreads) {
        const int m = e / kKC, k = e % kKC;
        float v = 0.0f;
        if (m0 + m < M && k < clen)
          v = a[static_cast<size_t>(m0 + m) * C + cbase + k];
        as[k][m] = v;
      }
      for (int e = threadIdx.x; e < kKC * kTN; e += kThreads) {
        // consecutive threads read consecutive addresses of w
        const int k = W_T ? e % kKC : e / kTN;
        const int o = W_T ? e / kKC : e % kTN;
        float v = 0.0f;
        if (o0 + o < O && k < clen)
          v = W_T ? to_f(w[static_cast<size_t>(o0 + o) * C + cbase + k])
                  : to_f(w[static_cast<size_t>(cbase + k) * O + o0 + o]);
        ws[k][o] = v;
      }
      __syncthreads();
      for (int k = 0; k < clen; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) mac(part[i][j], av[i], bv[j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = min(m0 + ty + 16 * i, M - 1);
      const float s_a = sa[static_cast<size_t>(row) * ncb + cb];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = min(o0 + tx + 16 * j, O - 1);
        const float p = part_f(part[i][j]);
        if (MODE == kModeInt) {
          const float s_w = W_T ? sw[static_cast<size_t>(col / oblk) * ncb + cb]
                                : sw[static_cast<size_t>(cb) * nob + col / oblk];
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(p, __fmul_rn(s_a, s_w)));
        } else if (MODE == kModeRawW) {
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(p, s_a));
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
      const int col = o0 + tx + 16 * j;
      if (col < O) y[static_cast<size_t>(row) * O + col] = acc[i][j];
    }
  }
}

template <int MODE, bool W_T, typename WT, typename PT>
void launch_gemm(const float* a, const float* sa, const void* w,
                 const float* sw, float* y, int M, int C, int O, int cblk,
                 int oblk, cudaStream_t stream) {
  const WT* wt = static_cast<const WT*>(w);
  if (M <= 16) {
    dim3 grid((O + kTN - 1) / kTN, (M + 15) / 16);
    gemm_kernel<1, MODE, W_T, WT, PT><<<grid, kThreads, 0, stream>>>(
        a, sa, wt, sw, y, M, C, O, cblk, oblk);
  } else {
    dim3 grid((O + kTN - 1) / kTN, (M + 63) / 64);
    gemm_kernel<4, MODE, W_T, WT, PT><<<grid, kThreads, 0, stream>>>(
        a, sa, wt, sw, y, M, C, O, cblk, oblk);
  }
}

// The GEMM of one (quantize_w, mode) case of the forward or dgrad: picks
// the partial-sum type by width and w's storage type for the raw paths.
template <bool W_T>
void launch_gemm_case(int quantize_w, int mode, int mbits, int w_bf16,
                      const float* a, const float* sa, const void* w,
                      const float* wq, const float* sw, float* y, int M,
                      int C, int O, int cblk, int oblk, cudaStream_t st) {
  if (quantize_w) {
    if (mode == kModeInt) {
      if (mbits <= 8)
        launch_gemm<kModeInt, W_T, float, float>(a, sa, wq, sw, y, M, C, O, cblk, oblk, st);
      else
        launch_gemm<kModeInt, W_T, float, double>(a, sa, wq, sw, y, M, C, O, cblk, oblk, st);
    } else {
      launch_gemm<kModeDeq, W_T, float, float>(a, sa, wq, sw, y, M, C, O, cblk, oblk, st);
    }
  } else if (mode == kModeRawW) {
    if (w_bf16)
      launch_gemm<kModeRawW, W_T, __nv_bfloat16, float>(a, sa, w, sw, y, M, C, O, cblk, oblk, st);
    else
      launch_gemm<kModeRawW, W_T, float, float>(a, sa, w, sw, y, M, C, O, cblk, oblk, st);
  } else {
    if (w_bf16)
      launch_gemm<kModeDeq, W_T, __nv_bfloat16, float>(a, sa, w, sw, y, M, C, O, cblk, oblk, st);
    else
      launch_gemm<kModeDeq, W_T, float, float>(a, sa, w, sw, y, M, C, O, cblk, oblk, st);
  }
}

}  // namespace hbfp
