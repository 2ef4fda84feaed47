// B4 (the HBFP flash-attention forward) on Hopper's tensor cores: the
// `int8_wgmma` route of hbfp_flash_fwd (hbfp_flash_attn.cu), replacing
// repro/kernels/hbfp_flash_attn.py `hbfp_flash_attention` / `_flash_kernel`
// where m_qk, m_pv <= 8. The CUDA-core kernel of hbfp_flash_attn.cu keeps
// the other calls (flash_tc_route decides; the wrapper's `flash_route`
// mirrors it).
//
// Why int8 is exact. At m <= 8 both contractions are integral: QK^T takes
// q*alpha and k quantized per row over hd at m_qk, PV takes p per row and
// v per column over the k-block at m_pv; every mantissa fits int8, and
// s8 x s8 -> s32 wgmma sums them exactly (|sum| <= 127^2 * 128 < 2^22), as
// the reference's `_qdot` does with int32 sums. Everything else B4 does is
// elementwise, a max, or the row sum of p, computed here with the same
// explicit round-to-nearest f32 ops, expf and logf as the CUDA-core kernel
// (the quantizers multiply by the exact reciprocal of their power-of-two
// step, which rounds as the division does), so o and lse equal the plain
// version (kernels/ref.py hbfp_flash_attn_ref) bit for bit.
//
// The row sum's order. `_row_sum` adds 16 virtual lanes L = c mod 16, each
// over j = c div 16 ascending, then folds them by a halving tree (8, 4, 2,
// 1). In the m64nNk32 s32 accumulator a thread holds, for each of its two
// rows, the columns c = 8 i + 2 (lane % 4) + e (e in {0, 1}): the virtual
// lanes {2q, 2q + 1, 8 + 2q, 9 + 2q} (q = lane % 4) for every j. It sums
// each in registers over j ascending; the tree's off-8 step pairs L with
// L + 8 inside the thread, off-4 is a shuffle with lane ^ 2, off-2 with
// lane ^ 1, and off-1 adds e = 0 to e = 1 inside the thread. IEEE addition
// is commutative, so both partners of a shuffle hold the same bits.
//
// Design.
//   pre-pass   flash_rows_prepass (operands q, k): q*alpha and k per row
//              over hd into int8 [BH*S, 128] (zero past hd) with their f32
//              row steps;
//              flash_vt_prepass: v per column over each k-block into int8
//              v^T [BH*128, S] (rows past hd zero) with steps
//              [BH, S/bk, 128]. Both depend on no q-block, so they replace
//              the CUDA-core kernel's per-CTA re-quantization of k and v,
//              and with v^T both PV operands are K-major, as int8 wgmma
//              requires.
//   main       flash_tc_kernel: one CTA per (128 q rows, B*H), heaviest
//              causal tiles first; two consumer warpgroups of 64 rows and
//              one producer warpgroup. The producer's first thread TMA-loads
//              the q tile once and rings (k tile, v^T tile, k steps, v
//              steps) through kFlashStages stages. Per k-block a consumer
//              runs QK^T as m64n128k32 wgmma into int32, the f32 online
//              softmax in registers, quantizes p per row, writes its int8 p
//              rows to its own 128-byte-swizzled shared tile, fences the
//              async proxy, and runs PV as m64n128k32 wgmma from shared
//              memory; the causal k-block skip is the reference's, per
//              warpgroup's q-block.
//   bk = 64    QK^T still runs n128 (the columns past 64 are ignored), and
//              PV runs over 128 columns with p's upper 64 zero, so the
//              v^T tile's second half adds nothing.
//
// Bound (H100 SXM): at yi-9b's training shape (B*H 32, S 4096, hd 128,
// causal) the two contractions are 2 * 2 * 2.2e9 int8 MACs, 0.07 ms at
// 1,979 TOP/s; the f32 softmax around them (an expf per kept score at the
// special-function rate, and the scale, mask, max, sum and quantize ops at
// the f32 rate) is larger, and chip_smoke.py reports both bounds.
//
// What the design leaves on the table: no overlap between a warpgroup's
// softmax and its next QK^T (no ping-pong schedule), p makes a round trip
// through shared memory, and the pre-pass writes and re-reads the int8
// operands through device memory.
#pragma once

#include "hbfp_gemm_sm90.cuh"

namespace hbfp {
namespace flash {

constexpr int kFlashHP = 128;      // head dim padded: one 128-byte int8 row
constexpr int kFlashRows = 128;    // q rows of a CTA
constexpr int kFlashStages = 3;
constexpr int kFlashTile = 128 * 128;                  // bytes of a tile
constexpr int kFlashStageBytes = 2 * kFlashTile + 2 * 128 * 4;
constexpr int kFlashSmem = 2 * kFlashTile + kFlashStages * kFlashStageBytes +
                           (2 * kFlashStages + 1) * 8 + 1024;

enum FlashRoute { kFlashCudaCore = 0, kFlashInt8 = 1 };

// int8 wgmma where both contractions are integral at m <= 8, hd fits one
// padded 128-byte row, the blocks are whole warpgroup tiles and S whole
// 128-row CTAs.
inline int flash_tc_route(int S, int hd, int bq, int bk, int mqk, int mpv) {
  return mqk <= 8 && mpv <= 8 && hd % 32 == 0 && hd <= kFlashHP &&
                 bq % 64 == 0 && bk % 64 == 0 && S % kFlashRows == 0
             ? kFlashInt8
             : kFlashCudaCore;
}

// The step 2^e of a group (e = floor(log2 amax) - m + 2, in [-106, 126]
// at m <= 8); its reciprocal is `inv_step` (hbfp_common.cuh).
__device__ __forceinline__ float flash_step(float amax, int mbits) {
  return pow2i(max_exponent(amax) - mbits + 2);
}

__device__ __forceinline__ float flash_q(float x, float inv, float lim) {
  return fminf(fmaxf(rintf(__fmul_rn(x, inv)), -lim), lim);
}

// Up to four [rows, hd] operands, one per blockIdx.y, each quantized per
// row over hd at its own width, one warp per row; operand 0 is first
// multiplied by `scale` in f32 (q*alpha). Each writes its int8 mantissas
// to x8 [rows, 128] (zero past hd) and its f32 row steps to sc, and, where
// xh is set, the dequantized rows in bf16 to xh [rows, 128] (exact: an
// integer |q| <= 127 times a power-of-two step >= 2^-106). B4 passes
// (q, k); B5 and B6 (hbfp_flash_bwd_sm90.cuh) pass (q, k, do, v).
// Two f32 values (exact in bf16) as one register of bf16, lo in the low
// half: a column pair of a fragment row.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct FlashRows {
  const void* x[4];
  int8_t* x8[4];
  float* sc[4];
  __nv_bfloat16* xh[4];
  int mbits[4];
};

template <typename XT>
__global__ void __launch_bounds__(256)
flash_rows_prepass(const FlashRows a, int rows, int hd, float scale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int op = blockIdx.y;
  const XT* x = static_cast<const XT*>(a.x[op]);
  const int mbits = a.mbits[op];
  float vals[4];
  float amax = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int d = 4 * lane + t;
    float v = d < hd ? to_f(x[static_cast<size_t>(row) * hd + d]) : 0.0f;
    if (op == 0) v = __fmul_rn(v, scale);
    vals[t] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float delta = flash_step(amax, mbits);
  const float inv = inv_step(amax, mbits);
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  float mq[4];
  uint32_t packed = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    mq[t] = flash_q(vals[t], inv, lim);
    packed |= (static_cast<uint32_t>(__float2int_rn(mq[t])) & 0xFFu) << (8 * t);
  }
  const size_t off = static_cast<size_t>(row) * kFlashHP;
  reinterpret_cast<uint32_t*>(a.x8[op] + off)[lane] = packed;
  if (lane == 0) a.sc[op][row] = delta;
  if (a.xh[op] != nullptr) {
    reinterpret_cast<uint2*>(a.xh[op] + off)[lane] =
        make_uint2(pack_bf16(__fmul_rn(mq[0], delta), __fmul_rn(mq[1], delta)),
                   pack_bf16(__fmul_rn(mq[2], delta), __fmul_rn(mq[3], delta)));
  }
}

// v [BH, S, hd] per column over each k-block of bk rows, quantized at mpv
// and written transposed: vt8 [BH*128, S] (rows past hd zero), steps
// vsc [BH, S/bk, 128]. Grid (S/bk, BH, 128/32): 32 columns per CTA.
template <typename XT>
__global__ void __launch_bounds__(256)
flash_vt_prepass(const XT* __restrict__ v, int8_t* __restrict__ vt8,
                 float* __restrict__ vsc, int S, int hd, int bk, int mpv) {
  __shared__ float tile[128][33];
  __shared__ float red[8][32];
  __shared__ float inv[32];
  const int kb = blockIdx.x, bh = blockIdx.y, d0 = blockIdx.z * 32;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(bh) * S + static_cast<size_t>(kb) * bk;
  for (int e = tid; e < bk * 32; e += 256) {
    const int c = e >> 5, dd = e & 31;
    tile[c][dd] = d0 + dd < hd ? to_f(v[(row0 + c) * hd + d0 + dd]) : 0.0f;
  }
  __syncthreads();
  {
    const int dd = tid & 31, part = tid >> 5;
    float amax = 0.0f;
    for (int c = part; c < bk; c += 8) amax = fmaxf(amax, fabsf(tile[c][dd]));
    red[part][dd] = amax;
  }
  __syncthreads();
  if (tid < 32) {
    float amax = red[0][tid];
#pragma unroll
    for (int p = 1; p < 8; ++p) amax = fmaxf(amax, red[p][tid]);
    inv[tid] = inv_step(amax, mpv);
    vsc[(static_cast<size_t>(bh) * (S / bk) + kb) * kFlashHP + d0 + tid] =
        flash_step(amax, mpv);
  }
  __syncthreads();
  const float lim = static_cast<float>((1 << (mpv - 1)) - 1);
  for (int e = tid; e < bk * 32; e += 256) {
    const int dd = e / bk, c = e % bk;
    const float m = flash_q(tile[c][dd], inv[dd], lim);
    vt8[(static_cast<size_t>(bh) * kFlashHP + d0 + dd) * S +
        static_cast<size_t>(kb) * bk + c] =
        static_cast<int8_t>(__float2int_rn(m));
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// bar.sync `id` over one warpgroup's 128 threads, or over `threads`
__device__ __forceinline__ void wg_sync(int id, int threads = 128) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of (row r, byte c) in a [rows x 128] int8 tile with the
// 128-byte swizzle that TMA writes and wgmma's K-major descriptor reads
// (16-byte chunk index XOR row mod 8), the tile 1024-byte aligned.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

template <int BK, typename OT>
__global__ void __launch_bounds__(384, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ qsc, const float* __restrict__ ksc,
                const float* __restrict__ vsc, OT* __restrict__ o,
                float* __restrict__ lse, int S, int hd, int bq, int causal,
                int mpv) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* sq = sm;                          // [128 x 128] q mantissas
  uint8_t* sp = sm + kFlashTile;             // 2 x [64 x 128] p mantissas
  uint8_t* stages = sm + 2 * kFlashTile;     // k, v^T, k steps, v steps
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kFlashStages * kFlashStageBytes);
  uint64_t* empty = full + kFlashStages;
  uint64_t* qbar = empty + kFlashStages;

  const int nqt = gridDim.x;
  const int r0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * kFlashRows;
  const int bh = blockIdx.y;
  const int nkb = S / BK;
  const size_t rbase = static_cast<size_t>(bh) * S;
  // k-blocks each warpgroup's q-block visits (the reference's skip)
  auto n_kb = [&](int row) {
    const int qb = row / bq;
    return causal ? min(nkb, (qb * bq + bq - 1) / BK + 1) : nkb;
  };
  const int nk = n_kb(r0 + 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFlashStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, kFlashTile);
      tma_load(sq, &tq, qbar, 0, static_cast<int>(rbase) + r0);
      const uint32_t bytes = BK * 128 + kFlashTile + BK * 4 + 128 * 4;
      for (int s = 0; s < nk; ++s) {
        const int st = s % kFlashStages;
        mbar_wait(&empty[st], ((s / kFlashStages) & 1) ^ 1);
        uint8_t* base = stages + st * kFlashStageBytes;
        mbar_expect_tx(&full[st], bytes);
        tma_load(base, &tk, &full[st], 0, static_cast<int>(rbase) + s * BK);
        tma_load(base + kFlashTile, &tv, &full[st], s * BK, bh * kFlashHP);
        bulk_load(base + 2 * kFlashTile, ksc + rbase + static_cast<size_t>(s) * BK,
                  BK * 4, &full[st]);
        bulk_load(base + 2 * kFlashTile + 512,
                  vsc + (static_cast<size_t>(bh) * nkb + s) * kFlashHP,
                  kFlashHP * 4, &full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q4 = lane % 4;
  const int lrow = warp * 16 + lane / 4;              // and lrow + 8
  const int row = r0 + wg * 64 + lrow;                // in [0, S)
  const int nk_w = n_kb(r0 + wg * 64);
  const float lim_pv = static_cast<float>((1 << (mpv - 1)) - 1);
  uint8_t* my_p = sp + wg * (kFlashTile / 2);
  const uint32_t q_addr = smem_u32(sq) + wg * (kFlashTile / 2);
  const uint32_t p_addr = smem_u32(my_p);

  float qs[2], m_i[2], l_i[2], acc[64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qs[h] = qsc[rbase + row + 8 * h];
    m_i[h] = kNegInf;
    l_i[h] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  if (BK < 128) {
    // p's columns past BK stay zero: PV then adds nothing from them
    uint4* z = reinterpret_cast<uint4*>(my_p) + tid * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i] = make_uint4(0, 0, 0, 0);
    wg_sync(1 + wg);
  }
  mbar_wait(qbar, 0);

  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb % kFlashStages;
    mbar_wait(&full[st], (kb / kFlashStages) & 1);
    if (kb < nk_w) {
      uint8_t* base = stages + st * kFlashStageBytes;
      const uint32_t k_addr = smem_u32(base);
      const uint32_t v_addr = k_addr + kFlashTile;
      const float* ks = reinterpret_cast<const float*>(base + 2 * kFlashTile);
      const float* vs = ks + 128;

      // s = Q(q*alpha) . Q(k)^T, exact int32
      int sf[64];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_step(sf, make_desc(q_addr + u * 32, 16, 1024),
                   make_desc(k_addr + u * 32, 16, 1024), u);
      wgmma_commit();
      wgmma_wait0();
      fence_frag(sf);

      // scores, mask and row max
      float p[64], mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * q4 + (i & 1);
        float s = __fmul_rn(small_int_to_float(sf[i]), __fmul_rn(qs[h], ks[c]));
        if (causal && kb * BK + c > row + 8 * h) s = kNegInf;
        p[i] = s;
        mx[h] = fmaxf(mx[h], s);
      }
      float alpha[2], m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m_i[h], mx[h]);
        alpha[h] = expf(__fsub_rn(m_i[h], m_new[h]));
      }
      // p = exp(s - m_new), the row sum in _row_sum's order, and max |p|
      float t[2][2][2], pmax[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1, e = i & 1, oct = i >> 2;
        const float ev = expf(__fsub_rn(p[i], m_new[h]));
        p[i] = ev;
        pmax[h] = fmaxf(pmax[h], ev);
        float& tv_ = t[h][oct & 1][e];
        tv_ = oct < 2 ? ev : __fadd_rn(tv_, ev);
      }
      float dp[2], dp_inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float u0 = __fadd_rn(t[h][0][0], t[h][1][0]);          // off 8
        float u1 = __fadd_rn(t[h][0][1], t[h][1][1]);
        u0 = __fadd_rn(u0, __shfl_xor_sync(0xffffffffu, u0, 2));  // off 4
        u1 = __fadd_rn(u1, __shfl_xor_sync(0xffffffffu, u1, 2));
        u0 = __fadd_rn(u0, __shfl_xor_sync(0xffffffffu, u0, 1));  // off 2
        u1 = __fadd_rn(u1, __shfl_xor_sync(0xffffffffu, u1, 1));
        const float sum = __fadd_rn(u0, u1);                      // off 1
        l_i[h] = __fadd_rn(__fmul_rn(l_i[h], alpha[h]), sum);
        m_i[h] = m_new[h];
        pmax[h] = fmaxf(pmax[h], __shfl_xor_sync(0xffffffffu, pmax[h], 1));
        pmax[h] = fmaxf(pmax[h], __shfl_xor_sync(0xffffffffu, pmax[h], 2));
        dp[h] = flash_step(pmax[h], mpv);
        dp_inv[h] = inv_step(pmax[h], mpv);
      }
      // Q(p) per row into this warpgroup's swizzled p tile
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * q4;
        const int m0 = __float2int_rn(flash_q(p[i], dp_inv[h], lim_pv));
        const int m1 = __float2int_rn(flash_q(p[i + 1], dp_inv[h], lim_pv));
        *reinterpret_cast<uint16_t*>(my_p + swz(lrow + 8 * h, c)) =
            static_cast<uint16_t>((m0 & 0xFF) | ((m1 & 0xFF) << 8));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);

      // pv = Q(p) . Q(v), exact int32
      int pf[64];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_step(pf, make_desc(p_addr + u * 32, 16, 1024),
                   make_desc(v_addr + u * 32, 16, 1024), u);
      wgmma_commit();
      wgmma_wait0();
      fence_frag(pf);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        const int d = 8 * (i >> 2) + 2 * q4 + (i & 1);
        const float pv = __fmul_rn(small_int_to_float(pf[i]), __fmul_rn(dp[h], vs[d]));
        acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[h]), pv);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(l_i[h], 1e-30f);
    const size_t orow = (rbase + row + 8 * h) * hd;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int d = 8 * (i >> 2) + 2 * q4 + (i & 1);
      if (d < hd) store(o + orow + d, __fdiv_rn(acc[i], lc));
    }
    if (lse != nullptr && q4 == 0)
      lse[rbase + row + 8 * h] = __fadd_rn(m_i[h], logf(lc));
  }
}

// The int8 route: the pre-pass into the caller's scratch (q8, k8 [BH*S,
// 128] int8; vt8 [BH*128, S] int8; qsc, ksc [BH*S] f32; vsc [BH, S/bk,
// 128] f32), then the main kernel.
template <typename XT>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, int8_t* q8, int8_t* k8, int8_t* vt8, float* qsc,
                  float* ksc, float* vsc, int BH, int S, int hd, int bq, int bk,
                  int mqk, int mpv, int causal, float scale, cudaStream_t st) {
  const int rows = BH * S;
  dim3 g1((rows * 32 + 255) / 256, 2);
  const FlashRows rw = {{q, k, nullptr, nullptr}, {q8, k8, nullptr, nullptr},
                        {qsc, ksc, nullptr, nullptr},
                        {nullptr, nullptr, nullptr, nullptr}, {mqk, mqk, 0, 0}};
  flash_rows_prepass<XT><<<g1, 256, 0, st>>>(rw, rows, hd, scale);
  dim3 g2(S / bk, BH, kFlashHP / 32);
  flash_vt_prepass<XT><<<g2, 256, 0, st>>>(static_cast<const XT*>(v), vt8,
                                           vsc, S, hd, bk, mpv);
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_map(&tq, q8, true, rows, kFlashHP, kFlashRows, kFlashHP) ||
      !sm90::encode_map(&tk, k8, true, rows, kFlashHP, bk, kFlashHP) ||
      !sm90::encode_map(&tv, vt8, true, BH * kFlashHP, S, kFlashHP, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bk == 128 ? flash_tc_kernel<128, XT> : flash_tc_kernel<64, XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kFlashSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / kFlashRows, BH);
  kern<<<grid, 384, kFlashSmem, st>>>(tq, tk, tv, qsc, ksc, vsc,
                                      static_cast<XT*>(o), lse, S, hd, bq,
                                      causal, mpv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace hbfp
