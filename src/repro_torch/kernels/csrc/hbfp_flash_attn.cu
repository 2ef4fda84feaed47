// HBFP flash attention for Hopper (sm_90a): the forward (B4, replaces
// repro/kernels/hbfp_flash_attn.py `hbfp_flash_attention` /
// `_flash_kernel`), the dQ pass (B5, `hbfp_flash_attention_bwd` /
// `_flash_dq_kernel`) and the dK/dV pass (B6, `_flash_dkv_kernel`). Each
// takes int8 wgmma where m_qk, m_pv <= 8 and the shapes fit its tiles
// (route `int8_wgmma`: B4 in hbfp_flash_fwd_sm90.cuh, B5 and B6 in
// hbfp_flash_bwd_sm90.cuh); the CUDA-core kernels below run every other
// call (route `cuda_core`: m > 8, head dims and blocks the tiles do not
// take).
//
// What bounds them on this card: per causal (q-block, k-block) pair the
// integral contractions QKᵀ, PV and dp = do·vᵀ are int8 work (1,979 TOP/s
// at m <= 8) and dq, dk, dv are f32 sums of exact products (bf16 rate,
// their m <= 8 operands being exact in bf16); q, k, v, do are read and the
// outputs written once, a few MB, so all three are bound by operations.
// The tensor-core routes run the integral products as s8 wgmma and dq,
// dk, dv as bf16 wgmma; the CUDA-core kernels below run every contraction
// as f32 FMAs on integral mantissas (exact below 2^24) or int32 above
// m = 8, far from that bound.
//
// Design (the CUDA-core kernels; the tensor-core routes keep the same
// groups and block order, see their headers). The [S×S] score matrix
// never reaches device memory: a CTA keeps its q rows (B4, B5) or its
// whole k-block (B6) in shared memory and loops over the other operand's
// blocks in ascending order, skipping the blocks the causal mask hides,
// exactly as the reference's grid does.
// Quantization groups are the reference's, whatever the CTA tile:
//   forward:  q·α and k per row over hd at m_qk; p per row over bk and
//             v per column over bk at m_pv;
//   backward: q·α, k per row over hd at m_qk; v, do per row over hd at
//             m_pv; ds per row over bk at m_qk; the normalized p per row
//             over bk at m_pv.
// Each of these groups lies in one CTA (B4/B5 split a q-block into
// 64-row CTAs, B6 walks a q-block in 32-row chunks, and every group is
// row-local or spans one k-block), so the split changes no value.
// Integral contractions are exact and scaled by the product of the two
// scales, as the reference does; every other f32 operation is an explicit
// round-to-nearest intrinsic (no FMA contraction) or expf/logf, so scores,
// probabilities and every quantized operand equal the plain PyTorch
// version's on the card, and the forward's row sum of p runs in the order
// the plain version emulates (kernels/ref.py `_row_sum`). Only the f32
// contractions dq, dk, dv sum in another order than the plain version.
#include <algorithm>

#include "hbfp_common.cuh"

namespace hbfp {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;     // q rows of a B4 / B5 CTA
constexpr int kChunk = 32;    // q rows of one B6 chunk
constexpr int kMaxHd = 128;   // head dim <= 16 * 8 (eight columns a thread)

__device__ __forceinline__ void mac(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}
__device__ __forceinline__ void mac(int& acc, float a, float b) {
  acc += __float2int_rn(a) * __float2int_rn(b);
}
__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(int v) { return __int2float_rn(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lim_of(int mbits) {
  return static_cast<float>((1 << (mbits - 1)) - 1);
}

__device__ __forceinline__ float step_of(float amax, int mbits) {
  return pow2i(max_exponent(amax) - mbits + 2);
}

__device__ __forceinline__ float qnear(float x, float delta, float lim) {
  return quantize_val(x, delta, lim, 0, 0u, 0u);
}

// Max over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float half_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// acc[i][j] += Σ_k A(row_i, k) · B(k, col_j) over k < K, with rows
// ty + TY·i and columns tx + 16·j; A(r, k) = A[r·a_rs + k·a_ks] and
// B(k, c) = B[k·b_ks + c·b_cs]. Rows and columns past the tile read its
// last valid one (their results are never used).
template <int RI, int CJ, int TY, typename AT>
__device__ __forceinline__ void tile_mm(AT (&acc)[RI][CJ], const float* A,
                                        int a_rs, int a_ks, int nrows,
                                        const float* B, int b_ks, int b_cs,
                                        int ncols, int K, int ty, int tx) {
  int ao[RI], bo[CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) ao[i] = min(ty + TY * i, nrows - 1) * a_rs;
#pragma unroll
  for (int j = 0; j < CJ; ++j) bo[j] = min(tx + 16 * j, ncols - 1) * b_cs;
  for (int kk = 0; kk < K; ++kk) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[ao[i] + kk * a_ks];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[bo[j] + kk * b_ks];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) mac(acc[i][j], a[i], b[j]);
  }
}

// Rows [0, n) of x [n, hd] (row stride hd), times `mul` when use_mul (q·α
// in f32), quantized per row over hd at mbits: integral mantissas to
// dst[r·(hd+1) + d], steps to dscale[r]. One warp per row.
template <typename XT>
__device__ void load_rows(const XT* __restrict__ x, int n, int hd, float mul,
                          bool use_mul, int mbits, float* dst, float* dscale) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float lim = lim_of(mbits);
  for (int r = threadIdx.x >> 5; r < n; r += nwarps) {
    float vals[kMaxHd / 32];
    float amax = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxHd / 32; ++t) {
      const int d = lane + 32 * t;
      float v = d < hd ? to_f(x[static_cast<size_t>(r) * hd + d]) : 0.0f;
      if (use_mul) v = __fmul_rn(v, mul);
      vals[t] = v;
      amax = fmaxf(amax, fabsf(v));
    }
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float delta = step_of(amax, mbits);
#pragma unroll
    for (int t = 0; t < kMaxHd / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) dst[r * (hd + 1) + d] = qnear(vals[t], delta, lim);
    }
    if (lane == 0) dscale[r] = delta;
  }
}

// Number of k-blocks q-block qb visits (the reference's causal skip).
__device__ __forceinline__ int n_kblocks(int qb, int S, int bq, int bk,
                                         int causal) {
  return causal ? min(S / bk, (qb * bq + bq - 1) / bk + 1) : S / bk;
}

// ---------------------------------------------------------------------------
// B4: forward. Grid (S / R, BH), 256 threads; R = min(64, bq) q rows.
// ---------------------------------------------------------------------------
template <typename XT, typename QA, typename PA>
__global__ void __launch_bounds__(256)
flash_fwd_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
                 const XT* __restrict__ v, XT* __restrict__ o,
                 float* __restrict__ lse, int S, int hd, int bq, int bk,
                 int mqk, int mpv, int causal, float scale) {
  extern __shared__ float sm[];
  const int R = min(kRows, bq);
  const int ldh = hd + 1, ldk = bk + 1;
  float* qs = sm;                     // [R][ldh] q mantissas
  float* kv = qs + R * ldh;           // [bk][ldh] k, then v, mantissas
  float* ps = kv + bk * ldh;          // [R][ldk] p mantissas
  float* qsc = ps + R * ldk;          // [R]
  float* kvsc = qsc + R;              // [max(bk, hd)] k rows, then v columns
  float* psc = kvsc + max(bk, hd);    // [R]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * R;
  const int qb = r0 / bq;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * hd;
  const float lim_pv = lim_of(mpv);

  load_rows(q + base + static_cast<size_t>(r0) * hd, R, hd, scale, true, mqk,
            qs, qsc);

  float m_i[4], l_i[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int nk = n_kblocks(qb, S, bq, bk, causal);
  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();
    load_rows(k + base + static_cast<size_t>(kb) * bk * hd, bk, hd, 1.0f,
              false, mqk, kv, kvsc);
    __syncthreads();
    QA part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = QA(0);
    tile_mm<4, 8, 16>(part, qs, ldh, 1, R, kv, 1, ldh, bk, hd, ty, tx);

    float p[4][8], alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(ty + 16 * i, R - 1);
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        float s = __fmul_rn(as_f(part[i][j]),
                            __fmul_rn(qsc[r], kvsc[min(c, bk - 1)]));
        if (causal && kb * bk + c > r0 + r) s = kNegInf;
        p[i][j] = s;
        if (c < bk) mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m_i[i], half_max(mx));
      alpha[i] = expf(__fsub_rn(m_i[i], m_new));
      float sum = 0.0f, pmax = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        const float e = c < bk ? expf(__fsub_rn(p[i][j], m_new)) : 0.0f;
        p[i][j] = e;
        sum = j == 0 ? e : __fadd_rn(sum, e);
        pmax = fmaxf(pmax, e);
      }
      for (int off = 8; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      l_i[i] = __fadd_rn(__fmul_rn(l_i[i], alpha[i]), sum);
      m_i[i] = m_new;
      const float dp = step_of(half_max(pmax), mpv);
      if (ty + 16 * i < R) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          if (c < bk) ps[r * ldk + c] = qnear(p[i][j], dp, lim_pv);
        }
        if (tx == 0) psc[r] = dp;
      }
    }
    __syncthreads();
    // v per column over the k-block
    const XT* vb = v + base + static_cast<size_t>(kb) * bk * hd;
    for (int e = tid; e < bk * hd; e += blockDim.x)
      kv[(e / hd) * ldh + e % hd] = to_f(vb[e]);
    __syncthreads();
    if (tid < hd) {
      float amax = 0.0f;
      for (int c = 0; c < bk; ++c) amax = fmaxf(amax, fabsf(kv[c * ldh + tid]));
      kvsc[tid] = step_of(amax, mpv);
    }
    __syncthreads();
    for (int e = tid; e < bk * hd; e += blockDim.x) {
      const int c = e / hd, d = e % hd;
      kv[c * ldh + d] = qnear(kv[c * ldh + d], kvsc[d], lim_pv);
    }
    __syncthreads();
    PA part2[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part2[i][j] = PA(0);
    tile_mm<4, 8, 16>(part2, ps, ldk, 1, R, kv, ldh, 1, hd, bk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(ty + 16 * i, R - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = min(tx + 16 * j, hd - 1);
        const float pv = __fmul_rn(as_f(part2[i][j]),
                                   __fmul_rn(psc[r], kvsc[d]));
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], alpha[i]), pv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= R) continue;
    const float lc = fmaxf(l_i[i], 1e-30f);
    const size_t row = base + static_cast<size_t>(r0 + r) * hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(o + row + d, __fdiv_rn(acc[i][j], lc));
    }
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(blockIdx.y) * S + r0 + r] =
          __fadd_rn(m_i[i], logf(lc));
  }
}

// ---------------------------------------------------------------------------
// B5: dq. Grid (S / R, BH), 256 threads; R = min(64, bq) q rows.
// ---------------------------------------------------------------------------
template <typename XT, typename QA, typename PA>
__global__ void __launch_bounds__(256)
flash_dq_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
                const XT* __restrict__ v, const XT* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                XT* __restrict__ dq, int S, int hd, int bq, int bk, int mqk,
                int mpv, int causal, float scale) {
  extern __shared__ float sm[];
  const int R = min(kRows, bq);
  const int ldh = hd + 1, ldk = bk + 1;
  float* qs = sm;                     // [R][ldh] q·α mantissas
  float* dos = qs + R * ldh;          // [R][ldh] do mantissas
  float* kv = dos + R * ldh;          // [bk][ldh] v, then k (then k̂)
  float* dss = kv + bk * ldh;         // [R][ldk] dequantized ds
  float* qsc = dss + R * ldk;         // [R]
  float* dosc = qsc + R;              // [R]
  float* kvsc = dosc + R;             // [bk]
  float* lse_s = kvsc + bk;           // [R]
  float* delta_s = lse_s + R;         // [R]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * R;
  const int qb = r0 / bq;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * hd;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * S + r0;
  const float lim_qk = lim_of(mqk);

  load_rows(q + base + static_cast<size_t>(r0) * hd, R, hd, scale, true, mqk,
            qs, qsc);
  load_rows(dout + base + static_cast<size_t>(r0) * hd, R, hd, 1.0f, false,
            mpv, dos, dosc);
  for (int r = tid; r < R; r += blockDim.x) {
    lse_s[r] = lse[rbase + r];
    delta_s[r] = delta[rbase + r];
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = n_kblocks(qb, S, bq, bk, causal);
  for (int kb = 0; kb < nk; ++kb) {
    const size_t kbase = base + static_cast<size_t>(kb) * bk * hd;
    __syncthreads();
    load_rows(v + kbase, bk, hd, 1.0f, false, mpv, kv, kvsc);
    __syncthreads();
    float dp[4][8];
    {
      PA part[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = PA(0);
      tile_mm<4, 8, 16>(part, dos, ldh, 1, R, kv, 1, ldh, bk, hd, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = min(ty + 16 * i, R - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dp[i][j] = __fmul_rn(as_f(part[i][j]),
                               __fmul_rn(dosc[r], kvsc[min(tx + 16 * j, bk - 1)]));
      }
    }
    __syncthreads();
    load_rows(k + kbase, bk, hd, 1.0f, false, mqk, kv, kvsc);
    __syncthreads();
    {
      QA part[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = QA(0);
      tile_mm<4, 8, 16>(part, qs, ldh, 1, R, kv, 1, ldh, bk, hd, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = min(ty + 16 * i, R - 1);
        float dmax = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          float s = __fmul_rn(as_f(part[i][j]),
                              __fmul_rn(qsc[r], kvsc[min(c, bk - 1)]));
          if (causal && kb * bk + c > r0 + r) s = kNegInf;
          const float p = expf(__fsub_rn(s, lse_s[r]));
          const float ds = __fmul_rn(p, __fsub_rn(dp[i][j], delta_s[r]));
          dp[i][j] = ds;
          if (c < bk) dmax = fmaxf(dmax, fabsf(ds));
        }
        const float dd = step_of(half_max(dmax), mqk);
        if (ty + 16 * i < R) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = tx + 16 * j;
            if (c < bk)
              dss[r * ldk + c] = __fmul_rn(qnear(dp[i][j], dd, lim_qk), dd);
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < bk * hd; e += blockDim.x) {
      const int c = e / hd, d = e % hd;
      kv[c * ldh + d] = __fmul_rn(kv[c * ldh + d], kvsc[c]);
    }
    __syncthreads();
    float part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
    tile_mm<4, 8, 16>(part, dss, ldk, 1, R, kv, ldh, 1, hd, bk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(part[i][j], scale));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= R) continue;
    const size_t row = base + static_cast<size_t>(r0 + r) * hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(dq + row + d, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// B6: dk, dv. Grid (S / bk, BH), 512 threads; the CTA holds its k-block and
// walks the visible q-blocks in ascending order, kChunk q rows at a time.
// ---------------------------------------------------------------------------
template <typename XT, typename QA, typename PA>
__global__ void __launch_bounds__(512, 1)
flash_dkv_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
                 const XT* __restrict__ v, const XT* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, XT* __restrict__ dk,
                 XT* __restrict__ dv, int S, int hd, int bq, int bk, int mqk,
                 int mpv, int causal, float scale) {
  extern __shared__ float sm[];
  const int RC = min(kChunk, bq);
  const int ldh = hd + 1, ldk = bk + 1;
  float* ks = sm;                     // [bk][ldh] k mantissas
  float* vs = ks + bk * ldh;          // [bk][ldh] v mantissas
  float* qs = vs + bk * ldh;          // [RC][ldh] q·α mantissas, then q̂
  float* dos = qs + RC * ldh;         // [RC][ldh] do mantissas, then dô
  float* ps = dos + RC * ldh;         // [RC][ldk] dequantized p
  float* dss = ps + RC * ldk;         // [RC][ldk] dequantized ds
  float* ksc = dss + RC * ldk;        // [bk]
  float* vsc = ksc + bk;              // [bk]
  float* qsc = vsc + bk;              // [RC]
  float* dosc = qsc + RC;             // [RC]
  float* lse_s = dosc + RC;           // [RC]
  float* delta_s = lse_s + RC;        // [RC]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kb = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * hd;
  const float lim_qk = lim_of(mqk), lim_pv = lim_of(mpv);

  load_rows(k + base + static_cast<size_t>(kb) * bk * hd, bk, hd, 1.0f, false,
            mqk, ks, ksc);
  load_rows(v + base + static_cast<size_t>(kb) * bk * hd, bk, hd, 1.0f, false,
            mpv, vs, vsc);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  const int qb0 = causal ? (kb * bk) / bq : 0;
  for (int r0 = qb0 * bq; r0 < S; r0 += RC) {
    const size_t qrow = base + static_cast<size_t>(r0) * hd;
    __syncthreads();
    load_rows(q + qrow, RC, hd, scale, true, mqk, qs, qsc);
    load_rows(dout + qrow, RC, hd, 1.0f, false, mpv, dos, dosc);
    for (int r = tid; r < RC; r += blockDim.x) {
      lse_s[r] = lse[static_cast<size_t>(blockIdx.y) * S + r0 + r];
      delta_s[r] = delta[static_cast<size_t>(blockIdx.y) * S + r0 + r];
    }
    __syncthreads();
    QA sp[1][8];
    PA dpp[1][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sp[0][j] = QA(0);
      dpp[0][j] = PA(0);
    }
    tile_mm<1, 8, 32>(sp, qs, ldh, 1, RC, ks, 1, ldh, bk, hd, ty, tx);
    tile_mm<1, 8, 32>(dpp, dos, ldh, 1, RC, vs, 1, ldh, bk, hd, ty, tx);
    {
      const int r = min(ty, RC - 1);
      float p[8], ds[8], pmax = 0.0f, dmax = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        const int cc = min(c, bk - 1);
        float s = __fmul_rn(as_f(sp[0][j]), __fmul_rn(qsc[r], ksc[cc]));
        if (causal && kb * bk + c > r0 + r) s = kNegInf;
        p[j] = expf(__fsub_rn(s, lse_s[r]));
        const float dp = __fmul_rn(as_f(dpp[0][j]), __fmul_rn(dosc[r], vsc[cc]));
        ds[j] = __fmul_rn(p[j], __fsub_rn(dp, delta_s[r]));
        if (c < bk) {
          pmax = fmaxf(pmax, fabsf(p[j]));
          dmax = fmaxf(dmax, fabsf(ds[j]));
        }
      }
      const float pd = step_of(half_max(pmax), mpv);
      const float dd = step_of(half_max(dmax), mqk);
      if (ty < RC) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          if (c < bk) {
            ps[r * ldk + c] = __fmul_rn(qnear(p[j], pd, lim_pv), pd);
            dss[r * ldk + c] = __fmul_rn(qnear(ds[j], dd, lim_qk), dd);
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < RC * hd; e += blockDim.x) {
      const int r = e / hd, d = e % hd;
      qs[r * ldh + d] = __fmul_rn(qs[r * ldh + d], qsc[r]);
      dos[r * ldh + d] = __fmul_rn(dos[r * ldh + d], dosc[r]);
    }
    __syncthreads();
    // dv[c][d] += Σ_r p̂[r][c]·dô[r][d];  dk[c][d] += Σ_r dŝ[r][c]·q̂[r][d]
    tile_mm<4, 8, 32>(dv_acc, ps, 1, ldk, bk, dos, ldh, 1, hd, RC, ty, tx);
    tile_mm<4, 8, 32>(dk_acc, dss, 1, ldk, bk, qs, ldh, 1, hd, RC, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 32 * i;
    if (c >= bk) continue;
    const size_t row = base + static_cast<size_t>(kb * bk + c) * hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        store(dk + row + d, dk_acc[i][j]);
        store(dv + row + d, dv_acc[i][j]);
      }
    }
  }
}

size_t fwd_smem(int hd, int bq, int bk) {
  const int R = std::min(kRows, bq);
  return sizeof(float) * (static_cast<size_t>(R) * (hd + 1) +
                          static_cast<size_t>(bk) * (hd + 1) +
                          static_cast<size_t>(R) * (bk + 1) + 2 * R +
                          std::max(bk, hd));
}

size_t dq_smem(int hd, int bq, int bk) {
  const int R = std::min(kRows, bq);
  return sizeof(float) * (2 * static_cast<size_t>(R) * (hd + 1) +
                          static_cast<size_t>(bk) * (hd + 1) +
                          static_cast<size_t>(R) * (bk + 1) + 4 * R + bk);
}

size_t dkv_smem(int hd, int bq, int bk) {
  const int RC = std::min(kChunk, bq);
  return sizeof(float) * (2 * static_cast<size_t>(bk) * (hd + 1) +
                          2 * static_cast<size_t>(RC) * (hd + 1) +
                          2 * static_cast<size_t>(RC) * (bk + 1) + 2 * bk +
                          4 * RC);
}

// Shapes the kernels take: power-of-two blocks up to 128 dividing S, and
// hd <= 128. The Python wrapper checks the same before launching.
bool shapes_ok(int S, int hd, int bq, int bk, int mqk, int mpv) {
  auto pow2_le128 = [](int b) { return b >= 1 && b <= 128 && (b & (b - 1)) == 0; };
  return pow2_le128(bq) && pow2_le128(bk) && S % bq == 0 && S % bk == 0 &&
         hd >= 1 && hd <= kMaxHd && mqk >= 2 && mqk <= 12 && mpv >= 2 &&
         mpv <= 12;
}

template <typename XT, typename QA, typename PA>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int S, int hd, int bq, int bk, int mqk,
               int mpv, int causal, float scale, cudaStream_t st) {
  const size_t smem = fwd_smem(hd, bq, bk);
  auto kern = flash_fwd_kernel<XT, QA, PA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / std::min(kRows, bq), BH);
  kern<<<grid, 256, smem, st>>>(
      static_cast<const XT*>(q), static_cast<const XT*>(k),
      static_cast<const XT*>(v), static_cast<XT*>(o), lse, S, hd, bq, bk, mqk,
      mpv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename QA, typename PA>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int S,
              int hd, int bq, int bk, int mqk, int mpv, int causal,
              float scale, cudaStream_t st) {
  const size_t smem = dq_smem(hd, bq, bk);
  auto kern = flash_dq_kernel<XT, QA, PA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / std::min(kRows, bq), BH);
  kern<<<grid, 256, smem, st>>>(
      static_cast<const XT*>(q), static_cast<const XT*>(k),
      static_cast<const XT*>(v), static_cast<const XT*>(dout), lse, delta,
      static_cast<XT*>(dq), S, hd, bq, bk, mqk, mpv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename QA, typename PA>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int BH, int S, int hd, int bq, int bk, int mqk, int mpv,
               int causal, float scale, cudaStream_t st) {
  const size_t smem = dkv_smem(hd, bq, bk);
  auto kern = flash_dkv_kernel<XT, QA, PA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / bk, BH);
  kern<<<grid, 512, smem, st>>>(
      static_cast<const XT*>(q), static_cast<const XT*>(k),
      static_cast<const XT*>(v), static_cast<const XT*>(dout), lse, delta,
      static_cast<XT*>(dk), static_cast<XT*>(dv), S, hd, bq, bk, mqk, mpv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace hbfp

// The int8 wgmma routes of B4 and of B5/B6; they use the helpers above
// (store, kNegInf)
#include "hbfp_flash_fwd_sm90.cuh"
#include "hbfp_flash_bwd_sm90.cuh"

// Picks the instantiation: storage type by `bf16`, and for each of the QK
// and PV sides an f32 contraction (exact at m <= 8) or an int32 one.
#define HBFP_FLASH_DISPATCH(FN, ...)                                        \
  do {                                                                      \
    using hbfp::flash::FN;                                                  \
    const bool iq = mqk > 8, ip = mpv > 8;                                  \
    if (bf16) {                                                             \
      if (iq && ip) return FN<__nv_bfloat16, int, int>(__VA_ARGS__);        \
      if (iq) return FN<__nv_bfloat16, int, float>(__VA_ARGS__);            \
      if (ip) return FN<__nv_bfloat16, float, int>(__VA_ARGS__);            \
      return FN<__nv_bfloat16, float, float>(__VA_ARGS__);                  \
    }                                                                       \
    if (iq && ip) return FN<float, int, int>(__VA_ARGS__);                  \
    if (iq) return FN<float, int, float>(__VA_ARGS__);                      \
    if (ip) return FN<float, float, int>(__VA_ARGS__);                      \
    return FN<float, float, float>(__VA_ARGS__);                            \
  } while (0)

// The scratch of B5's and B6's int8 route, or none (all null) on the CUDA
// cores: int8 q·α, k, do, v [BH*S, 128]; their f32 row steps [BH*S]; bf16
// h0 (B5: k̂; B6: q̂) and h1 (B6: dô) [BH*S, 128].
static bool bwd_scratch(bool tc, void* const* p, int n,
                        hbfp::flash::BwdScratch* w) {
  for (int i = 0; i < n; ++i)
    if ((p[i] != nullptr) != tc) return false;
  *w = {static_cast<int8_t*>(p[0]), static_cast<int8_t*>(p[1]),
        static_cast<int8_t*>(p[2]), static_cast<int8_t*>(p[3]),
        static_cast<float*>(p[4]), static_cast<float*>(p[5]),
        static_cast<float*>(p[6]), static_cast<float*>(p[7]),
        static_cast<__nv_bfloat16*>(p[8]),
        static_cast<__nv_bfloat16*>(n > 9 ? p[9] : nullptr)};
  return true;
}

extern "C" {

// q, k, v: [BH, S, hd] (bf16 when `bf16`, else f32), contiguous. Writes o
// (same type) and, when lse is not null, lse [BH, S] f32. The route is
// decided here (flash_tc_route) and the caller allocates its scratch, the
// other pointers null: int8_wgmma takes q8, k8 [BH*S, 128] int8, vt8
// [BH*128, S] int8, qsc, ksc [BH*S] f32 and vsc [BH, S/bk, 128] f32;
// cuda_core takes none. Returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for shapes the kernels do not take or
// a scratch set that does not match the route.
int hbfp_flash_fwd(const void* q, const void* k, const void* v, int bf16,
                   void* o, void* lse, void* q8, void* k8, void* vt8,
                   void* qsc, void* ksc, void* vsc, int BH, int S, int hd,
                   int bq, int bk, int mqk, int mpv, int causal, float scale,
                   void* stream) {
  using namespace hbfp::flash;
  if (!shapes_ok(S, hd, bq, bk, mqk, mpv))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = flash_tc_route(S, hd, bq, bk, mqk, mpv) == kFlashInt8;
  void* scratch[] = {q8, k8, vt8, qsc, ksc, vsc};
  for (void* p : scratch)
    if ((p != nullptr) != tc) return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    auto fn = bf16 ? launch_fwd_tc<__nv_bfloat16> : launch_fwd_tc<float>;
    return fn(q, k, v, o, static_cast<float*>(lse), static_cast<int8_t*>(q8),
              static_cast<int8_t*>(k8), static_cast<int8_t*>(vt8),
              static_cast<float*>(qsc), static_cast<float*>(ksc),
              static_cast<float*>(vsc), BH, S, hd, bq, bk, mqk, mpv, causal,
              scale, static_cast<cudaStream_t>(stream));
  }
  HBFP_FLASH_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse), BH, S,
                      hd, bq, bk, mqk, mpv, causal, scale,
                      static_cast<cudaStream_t>(stream));
}

// dq [BH, S, hd] from q, k, v, do (one type) and the forward's lse and
// D = rowsum(do ∘ o), both [BH, S] f32. The route is decided here
// (flash_bwd_tc_route); int8_wgmma takes the scratch q8, k8, do8, v8, qsc,
// ksc, dosc, vsc and kh, cuda_core none.
int hbfp_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  int bf16, void* dq, void* q8, void* k8, void* do8,
                  void* v8, void* qsc, void* ksc, void* dosc, void* vsc,
                  void* kh, int BH, int S, int hd, int bq, int bk, int mqk,
                  int mpv, int causal, float scale, void* stream) {
  using namespace hbfp::flash;
  if (!shapes_ok(S, hd, bq, bk, mqk, mpv))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = flash_bwd_tc_route(S, hd, bq, bk, mqk, mpv) == kFlashInt8;
  void* scratch[] = {q8, k8, do8, v8, qsc, ksc, dosc, vsc, kh};
  BwdScratch w;
  if (!bwd_scratch(tc, scratch, 9, &w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    auto fn = bf16 ? launch_dq_tc<__nv_bfloat16> : launch_dq_tc<float>;
    return fn(q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, w, BH, S, hd, bq, bk,
              mqk, mpv, causal, scale, static_cast<cudaStream_t>(stream));
  }
  HBFP_FLASH_DISPATCH(launch_dq, q, k, v, dout,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dq, BH, S, hd, bq, bk,
                      mqk, mpv, causal, scale,
                      static_cast<cudaStream_t>(stream));
}

// dk, dv [BH, S, hd] from the same inputs; int8_wgmma takes the scratch
// q8, k8, do8, v8, qsc, ksc, dosc, vsc, qh and doh, cuda_core none.
int hbfp_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int bf16, void* dk, void* dv, void* q8, void* k8,
                   void* do8, void* v8, void* qsc, void* ksc, void* dosc,
                   void* vsc, void* qh, void* doh, int BH, int S, int hd,
                   int bq, int bk, int mqk, int mpv, int causal, float scale,
                   void* stream) {
  using namespace hbfp::flash;
  if (!shapes_ok(S, hd, bq, bk, mqk, mpv))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = flash_bwd_tc_route(S, hd, bq, bk, mqk, mpv) == kFlashInt8;
  void* scratch[] = {q8, k8, do8, v8, qsc, ksc, dosc, vsc, qh, doh};
  BwdScratch w;
  if (!bwd_scratch(tc, scratch, 10, &w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    auto fn = bf16 ? launch_dkv_tc<__nv_bfloat16> : launch_dkv_tc<float>;
    return fn(q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dk, dv, w, BH, S, hd, bq, bk,
              mqk, mpv, causal, scale, static_cast<cudaStream_t>(stream));
  }
  HBFP_FLASH_DISPATCH(launch_dkv, q, k, v, dout,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dk, dv, BH, S, hd, bq,
                      bk, mqk, mpv, causal, scale,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
