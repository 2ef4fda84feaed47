// B5 (dq) and B6 (dk, dv), the HBFP flash-attention backward, on Hopper's
// tensor cores: the `int8_wgmma` routes of hbfp_flash_dq and
// hbfp_flash_dkv (hbfp_flash_attn.cu), replacing
// repro/kernels/hbfp_flash_attn.py `hbfp_flash_attention_bwd` /
// `_flash_dq_kernel` (:205) and `_flash_dkv_kernel` (:241) where m_qk,
// m_pv <= 8 and the shapes fit B4's tiles (flash_bwd_tc_route; the
// wrapper's `flash_bwd_route` mirrors it). The CUDA-core kernels of
// hbfp_flash_attn.cu keep the other calls.
//
// What bounds them. Per kept (q, k) pair the integral contractions
// s = Q(q*alpha).Q(k)^T and dp = Q(do).Q(v)^T are int8 work (1,979 TOP/s)
// and dq += ds^.k^ (B5), dv += p^T.do^ and dk += ds^T.q^ (B6) are f32 sums
// of exact products (the bf16 rate); around them, an expf and some twenty
// f32 ops per score. q, k, v, do are read and the outputs written once, a
// few tens of MB, so both kernels are bound by operations.
//
// Why the products stay exact. At m <= 8 s and dp are sums of int8
// products, exact in s8 x s8 -> s32 wgmma (|sum| <= 127^2 * 128 < 2^22)
// and rounded once to f32, as the reference's `_qdot` does. p =
// expf(s*dq*dk - lse), ds = p*(dp - D) and the quantized p^ and ds^ are
// built with the same explicit round-to-nearest f32 ops and expf as the
// CUDA-core kernels (quantizers multiply by the step's exact reciprocal),
// so every quantized operand equals the plain version's bit for bit. The
// dequantized operands k^, q^, do^, p^, ds^ are an integer |q| <= 127
// times a power of two >= 2^-106 (the quantizer's step floor): exact,
// normal bf16. Their products are exact in f32, and bf16 wgmma with f32
// accumulation sums them; only the order of the f32 additions differs
// from the plain version, within 2*S*2^-24*sum|a||b| (chip_smoke.py
// `_flash_grad_ok`). Two operands near the step floor can make a product
// below f32's normal range (2^-126): the tensor core keeps such products
// and sums as subnormals rather than flushing them to zero
// (tests/test_torch_flash_bwd_tc.py drives dq below 2^-126 on the card
// and finds it nonzero wherever the plain version's is, within the
// bound).
//
// Design.
//   pre-pass   flash_rows_prepass (hbfp_flash_fwd_sm90.cuh) on (q, k, do,
//              v): int8 q*alpha and k at m_qk, do and v at m_pv, each
//              [BH*S, 128] with f32 row steps, plus the bf16 k^ (B5) or
//              q^ and do^ (B6) [BH*S, 128]. The kernels never re-quantize
//              an operand per CTA.
//   B5 main    flash_dq_tc_kernel: one CTA per (128 q rows, B*H), the
//              heaviest causal q tiles launched first; two consumer
//              warpgroups of 64 q rows and a producer whose first thread
//              TMA-loads the q and do tiles once and rings (k, v, k^
//              tiles, k and v steps) through kDqStages stages. Per visible
//              k-block, in ascending order: s and dp as m64n128k32 int8
//              wgmma; p, ds, the row max of |ds| (quad-local in the
//              fragment) and ds^ in registers; ds^ packed to bf16 straight
//              from the m64n128 accumulator into wgmma's register-A
//              fragment (the two layouts coincide for k16 slices); the
//              k-block's partial dq = ds^.k^ as m64n128k16 bf16 wgmma with
//              k^ [bk, hd] read MN-major, in its own fragment, promoted in
//              order as the plain version does: dq = dq + partial*alpha.
//   B6 main    flash_dkv_tc_kernel: one CTA per (128 k rows, B*H), the
//              first (heaviest) k tiles launched first; each consumer
//              warpgroup owns 64 k rows and their dk, dv accumulators; the
//              producer rings 64-row q chunks (q, do, q^, do^ tiles, the
//              chunk's q and do steps, lse and D) from the first q-block
//              the CTA's k-blocks see. Per chunk a warpgroup runs s and dp
//              for the chunk's q rows against its own 64 k columns (m64n64k32
//              int8 wgmma), so its fragment rows are q rows: p and ds are
//              quantized per q row over the k-block, and at bk = 128 the
//              row maxima of the two warpgroups' halves meet through a
//              small shared buffer and one named barrier. p^ and ds^ go as
//              bf16 to 128-byte-swizzled shared tiles [q rows x k cols],
//              fenced into the async proxy, and dv += p^T.do^, dk +=
//              ds^T.q^ run as m64n128k16 bf16 wgmma with A read MN-major
//              through the transpose bit (B3's A descriptor) and B MN-major.
//   bk = 64    B5 runs s and dp n128 and ignores the columns past 64, and
//              dq over 64 k rows; a B6 CTA spans two k-blocks, one per
//              warpgroup, whose row groups need no exchange.
//
// Summation order. B5 keeps one f32 fragment per k-block and adds it with
// __fadd_rn in the plain version's ascending k-block order, alpha applied
// per block as the plain version does; only the order inside a block's
// 128-term sum differs. B6's dk and dv accumulate across q chunks in the
// wgmma accumulator (a per-block fragment would need 2 x 64 more registers
// a thread beside s, dp, dk and dv), so its whole S-long sum runs in the
// tensor core's order.
//
// Registers. s, dp and dq (B5) or s, dp, dk and dv (B6) need some 190
// registers a consumer thread: the producer warpgroup gives up registers
// (setmaxnreg 40) so the consumers get 232, as in B4 (ptxas: B5 spills
// nothing, B6 at bk 128 four bytes).
//
// What the design leaves on the table: no overlap of one warpgroup's f32
// work with the other's wgmma, p^ and ds^ round-trip through shared memory
// in B6, and the pre-pass writes and re-reads the operands through device
// memory (int8 and bf16 copies of each).
#pragma once

#include "hbfp_flash_fwd_sm90.cuh"

namespace hbfp {
namespace flash {

constexpr int kBwdThreads = 384;   // two consumer warpgroups + a producer
constexpr int kDqStages = 2;
// k, v int8 tiles; k^ as two bf16 [128 x 64] atoms; k and v steps
constexpr int kDqStage = 2 * kFlashTile + 2 * kFlashTile + 1024;
constexpr int kDqSmem = 2 * kFlashTile + kDqStages * kDqStage +
                        (2 * kDqStages + 1) * 8 + 1024;
constexpr int kKvChunk = 64;       // q rows per B6 step
constexpr int kKvStages = 3;
// q, do int8 [64 x 128]; q^, do^ as two bf16 [64 x 64] atoms each; the
// chunk's q steps, do steps, lse and D
constexpr int kKvStage = 2 * 8192 + 2 * 16384 + 1024;
// k, v int8 tiles; p^ and ds^ [64 x 64] bf16 per warpgroup; k and v
// steps; the row-max exchange [2 chunk parities][2 warpgroups][64][2]
constexpr int kKvFixed = 2 * kFlashTile + 2 * kFlashTile + 1024 + 2048;
constexpr int kKvSmem = kKvFixed + kKvStages * kKvStage +
                        (2 * kKvStages + 1) * 8 + 1024;

// The backward takes B4's tiles: int8 wgmma at m <= 8, hd a multiple of
// 32 up to one padded 128-byte row, blocks of whole 64-row warpgroup tiles
// (B6's 64-row q chunks then lie in one q-block) and S of whole 128-row
// CTAs.
inline int flash_bwd_tc_route(int S, int hd, int bq, int bk, int mqk,
                              int mpv) {
  return flash_tc_route(S, hd, bq, bk, mqk, mpv);
}

#define HBFP_D32                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31}"
#define HBFP_OP32(C) \
  HBFP_OP8(C, 0), HBFP_OP8(C, 8), HBFP_OP8(C, 16), HBFP_OP8(C, 24)

// d[32] (+)= A[64 x 32] . B[32 x 64], s8 x s8 -> s32, both K-major
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " HBFP_D32
      ", %32, %33, p;\n}\n"
      : HBFP_OP32(HBFP_RW_I)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A[64 x 16] . B[16 x 128], bf16 -> f32; A from registers (the
// m64k16 fragment, two bf16 a register), B MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HBFP_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HBFP_OP64(HBFP_RW_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---------------------------------------------------------------------------
// B5: dq. Grid (BH, S / 128), 384 threads.
// ---------------------------------------------------------------------------
template <int BK, typename OT>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tkh,
                   const float* __restrict__ qsc,
                   const float* __restrict__ ksc,
                   const float* __restrict__ dosc,
                   const float* __restrict__ vsc,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, OT* __restrict__ dq,
                   int S, int hd, int bq, int causal, int mqk, float scale) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* sq = sm;                          // [128 x 128] q*alpha mantissas
  uint8_t* sdo = sm + kFlashTile;            // [128 x 128] do mantissas
  uint8_t* stages = sm + 2 * kFlashTile;     // k, v, k^, k steps, v steps
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kDqStages * kDqStage);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;

  const int r0 = (static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)) * 128;
  const int bh = blockIdx.x;
  const int nkb = S / BK;
  const size_t rbase = static_cast<size_t>(bh) * S;
  // k-blocks each warpgroup's q-block visits (the reference's skip)
  auto n_kb = [&](int row) {
    const int qb = row / bq;
    return causal ? min(nkb, (qb * bq + bq - 1) / BK + 1) : nkb;
  };
  const int nk = n_kb(r0 + 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
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
      const int q0 = static_cast<int>(rbase) + r0;
      mbar_expect_tx(qbar, 2 * kFlashTile);
      tma_load(sq, &tq, qbar, 0, q0);
      tma_load(sdo, &tdo, qbar, 0, q0);
      const uint32_t bytes = 2 * BK * 128 + 2 * BK * 128 + 2 * BK * 4;
      for (int s = 0; s < nk; ++s) {
        const int st = s % kDqStages;
        mbar_wait(&empty[st], ((s / kDqStages) & 1) ^ 1);
        uint8_t* base = stages + st * kDqStage;
        const int k_row = static_cast<int>(rbase) + s * BK;
        mbar_expect_tx(&full[st], bytes);
        tma_load(base, &tk, &full[st], 0, k_row);
        tma_load(base + kFlashTile, &tv, &full[st], 0, k_row);
        tma_load(base + 2 * kFlashTile, &tkh, &full[st], 0, k_row);
        tma_load(base + 2 * kFlashTile + BK * 128, &tkh, &full[st], 64, k_row);
        bulk_load(base + 4 * kFlashTile, ksc + k_row, BK * 4, &full[st]);
        bulk_load(base + 4 * kFlashTile + 512, vsc + k_row, BK * 4, &full[st]);
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
  const float lim_qk = static_cast<float>((1 << (mqk - 1)) - 1);
  const uint32_t q_addr = smem_u32(sq) + wg * (kFlashTile / 2);
  const uint32_t do_addr = smem_u32(sdo) + wg * (kFlashTile / 2);

  float qs[2], dos[2], ls[2], dl[2], acc[64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = rbase + row + 8 * h;
    qs[h] = qsc[r];
    dos[h] = dosc[r];
    ls[h] = lse[r];
    dl[h] = delta[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  mbar_wait(qbar, 0);

  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb % kDqStages;
    mbar_wait(&full[st], (kb / kDqStages) & 1);
    if (kb < nk_w) {
      uint8_t* base = stages + st * kDqStage;
      const uint32_t k_addr = smem_u32(base);
      const uint32_t v_addr = k_addr + kFlashTile;
      const uint32_t kh_addr = k_addr + 2 * kFlashTile;
      const float* ks = reinterpret_cast<const float*>(base + 4 * kFlashTile);
      const float* vs = ks + 128;

      // s = Q(q*alpha) . Q(k)^T and dp = Q(do) . Q(v)^T, exact int32
      int sf[64], pf[64];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_step(sf, make_desc(q_addr + u * 32, 16, 1024),
                   make_desc(k_addr + u * 32, 16, 1024), u);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_step(pf, make_desc(do_addr + u * 32, 16, 1024),
                   make_desc(v_addr + u * 32, 16, 1024), u);
      wgmma_commit();
      wgmma_wait0();
      fence_frag(sf);
      fence_frag(pf);

      // p = exp(s - lse), ds = p * (dp - D), and the row max of |ds|
      float ds[BK / 2], dmax[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * q4 + (i & 1);
        float s = __fmul_rn(small_int_to_float(sf[i]), __fmul_rn(qs[h], ks[c]));
        if (causal && kb * BK + c > row + 8 * h) s = kNegInf;
        const float p = expf(__fsub_rn(s, ls[h]));
        const float dp = __fmul_rn(small_int_to_float(pf[i]),
                                   __fmul_rn(dos[h], vs[c]));
        ds[i] = __fmul_rn(p, __fsub_rn(dp, dl[h]));
        dmax[h] = fmaxf(dmax[h], fabsf(ds[i]));
      }
      float dd[2], dinv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dmax[h] = fmaxf(dmax[h], __shfl_xor_sync(0xffffffffu, dmax[h], 1));
        dmax[h] = fmaxf(dmax[h], __shfl_xor_sync(0xffffffffu, dmax[h], 2));
        dd[h] = flash_step(dmax[h], mqk);
        dinv[h] = inv_step(dmax[h], mqk);
      }
      // ds^ = Q(ds) * step in bf16, as the A fragment of each k16 slice:
      // register r of slice t holds fragment elements 8t + 2r, 8t + 2r + 1
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * t + 2 * r, h = r & 1;
          a[t][r] = pack_bf16(__fmul_rn(flash_q(ds[i], dinv[h], lim_qk), dd[h]),
                              __fmul_rn(flash_q(ds[i + 1], dinv[h], lim_qk), dd[h]));
        }

      // this k-block's dq partial = ds^ . k^ in its own fragment
      float part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i] = 0.0f;
      fence_frag(part);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        wgmma_rs(part, a[t], make_desc(kh_addr + t * 16 * 128, BK * 128, 1024),
                 t);
      wgmma_commit();
      wgmma_wait0();
      fence_frag(part);
      fence_frag(a);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], scale));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t orow = (rbase + row + 8 * h) * hd;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int d = 8 * (i >> 2) + 2 * q4 + (i & 1);
      if (d < hd) store(dq + orow + d, acc[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// B6: dk, dv. Grid (BH, S / 128), 384 threads.
// ---------------------------------------------------------------------------
template <int BK, typename OT>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tqh,
                    const __grid_constant__ CUtensorMap tdoh,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const float* __restrict__ qsc,
                    const float* __restrict__ dosc,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, OT* __restrict__ dk,
                    OT* __restrict__ dv, int S, int hd, int bq, int causal,
                    int mqk, int mpv) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* sk = sm;                              // [128 x 128] k mantissas
  uint8_t* sv = sm + kFlashTile;                 // [128 x 128] v mantissas
  uint8_t* sp = sm + 2 * kFlashTile;             // 2 x [64 q x 64 k] p^ bf16
  uint8_t* sds = sm + 3 * kFlashTile;            // 2 x [64 q x 64 k] ds^ bf16
  float* kvs = reinterpret_cast<float*>(sm + 4 * kFlashTile);  // k, v steps
  float* red = kvs + 256;                        // row-max exchange
  uint8_t* stages = sm + kKvFixed;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kKvStages * kKvStage);
  uint64_t* empty = full + kKvStages;
  uint64_t* kvbar = empty + kKvStages;

  const int k0 = static_cast<int>(blockIdx.y) * 128;
  const int bh = blockIdx.x;
  const size_t rbase = static_cast<size_t>(bh) * S;
  // the first q-block the CTA's first k-block visits (the reference's
  // skip); the q rows before a warpgroup's own k rows add exact zeros
  const int c0 = causal ? (k0 / bq) * bq : 0;
  const int nch = (S - c0) / kKvChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int kr = static_cast<int>(rbase) + k0;
      mbar_expect_tx(kvbar, 2 * kFlashTile + 2 * 128 * 4);
      tma_load(sk, &tk, kvbar, 0, kr);
      tma_load(sv, &tv, kvbar, 0, kr);
      bulk_load(kvs, ksc + kr, 128 * 4, kvbar);
      bulk_load(kvs + 128, vsc + kr, 128 * 4, kvbar);
      const uint32_t bytes = kKvStage;
      for (int s = 0; s < nch; ++s) {
        const int st = s % kKvStages;
        mbar_wait(&empty[st], ((s / kKvStages) & 1) ^ 1);
        uint8_t* base = stages + st * kKvStage;
        const int qr = static_cast<int>(rbase) + c0 + s * kKvChunk;
        mbar_expect_tx(&full[st], bytes);
        tma_load(base, &tq, &full[st], 0, qr);
        tma_load(base + 8192, &tdo, &full[st], 0, qr);
        tma_load(base + 16384, &tqh, &full[st], 0, qr);
        tma_load(base + 24576, &tqh, &full[st], 64, qr);
        tma_load(base + 32768, &tdoh, &full[st], 0, qr);
        tma_load(base + 40960, &tdoh, &full[st], 64, qr);
        bulk_load(base + 49152, qsc + qr, kKvChunk * 4, &full[st]);
        bulk_load(base + 49408, dosc + qr, kKvChunk * 4, &full[st]);
        bulk_load(base + 49664, lse + qr, kKvChunk * 4, &full[st]);
        bulk_load(base + 49920, delta + qr, kKvChunk * 4, &full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q4 = lane % 4;
  const int lrow = warp * 16 + lane / 4;    // q row of s, k row of dk/dv
  const int kw = k0 + wg * 64;              // this warpgroup's first k row
  const float lim_qk = static_cast<float>((1 << (mqk - 1)) - 1);
  const float lim_pv = static_cast<float>((1 << (mpv - 1)) - 1);
  const float* ks = kvs + wg * 64;
  const float* vs = kvs + 128 + wg * 64;
  const uint32_t k_addr = smem_u32(sk) + wg * (kFlashTile / 2);
  const uint32_t v_addr = smem_u32(sv) + wg * (kFlashTile / 2);
  uint8_t* my_p = sp + wg * (kFlashTile / 2);
  uint8_t* my_ds = sds + wg * (kFlashTile / 2);
  const uint32_t p_addr = smem_u32(my_p), ds_addr = smem_u32(my_ds);

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  mbar_wait(kvbar, 0);

  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch % kKvStages;
    mbar_wait(&full[st], (ch / kKvStages) & 1);
    uint8_t* base = stages + st * kKvStage;
    const uint32_t q_addr = smem_u32(base);
    const uint32_t do_addr = q_addr + 8192;
    const uint32_t qh_addr = q_addr + 16384;
    const uint32_t doh_addr = q_addr + 32768;
    const float* cq = reinterpret_cast<const float*>(base + 49152);
    const float* cdo = cq + kKvChunk;
    const float* cl = cdo + kKvChunk;
    const float* cd = cl + kKvChunk;
    const int qrow0 = c0 + ch * kKvChunk;

    // s and dp of the chunk's 64 q rows against this warpgroup's 64 k rows
    int sf[32], pf[32];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wgmma_n64(sf, make_desc(q_addr + u * 32, 16, 1024),
                make_desc(k_addr + u * 32, 16, 1024), u);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wgmma_n64(pf, make_desc(do_addr + u * 32, 16, 1024),
                make_desc(v_addr + u * 32, 16, 1024), u);
    wgmma_commit();
    wgmma_wait0();
    fence_frag(sf);
    fence_frag(pf);

    float p[32], ds[32], pmax[2] = {0.0f, 0.0f}, dmax[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * q4 + (i & 1);
      const int r = lrow + 8 * h;
      float s = __fmul_rn(small_int_to_float(sf[i]), __fmul_rn(cq[r], ks[c]));
      if (causal && kw + c > qrow0 + r) s = kNegInf;
      p[i] = expf(__fsub_rn(s, cl[r]));
      const float dp = __fmul_rn(small_int_to_float(pf[i]),
                                 __fmul_rn(cdo[r], vs[c]));
      ds[i] = __fmul_rn(p[i], __fsub_rn(dp, cd[r]));
      pmax[h] = fmaxf(pmax[h], fabsf(p[i]));
      dmax[h] = fmaxf(dmax[h], fabsf(ds[i]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        pmax[h] = fmaxf(pmax[h], __shfl_xor_sync(0xffffffffu, pmax[h], off));
        dmax[h] = fmaxf(dmax[h], __shfl_xor_sync(0xffffffffu, dmax[h], off));
      }
    if (BK == 128) {
      // a q row's group spans both warpgroups' 64 k columns
      float* rb = red + (ch & 1) * 256;
      if (q4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rb[(wg * 64 + lrow + 8 * h) * 2] = pmax[h];
          rb[(wg * 64 + lrow + 8 * h) * 2 + 1] = dmax[h];
        }
      }
      wg_sync(3, 256);       // both consumer warpgroups
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pmax[h] = fmaxf(pmax[h], rb[((1 - wg) * 64 + lrow + 8 * h) * 2]);
        dmax[h] = fmaxf(dmax[h], rb[((1 - wg) * 64 + lrow + 8 * h) * 2 + 1]);
      }
    }
    float pd[2], pinv[2], dd[2], dinv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pd[h] = flash_step(pmax[h], mpv);
      pinv[h] = inv_step(pmax[h], mpv);
      dd[h] = flash_step(dmax[h], mqk);
      dinv[h] = inv_step(dmax[h], mqk);
    }
    // p^ and ds^ in bf16 into this warpgroup's swizzled [q x k] tiles
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const int r = lrow + 8 * h;
      const int off = swz(r, 16 * (i >> 2) + 4 * q4);
      *reinterpret_cast<uint32_t*>(my_p + off) =
          pack_bf16(__fmul_rn(flash_q(p[i], pinv[h], lim_pv), pd[h]),
                    __fmul_rn(flash_q(p[i + 1], pinv[h], lim_pv), pd[h]));
      *reinterpret_cast<uint32_t*>(my_ds + off) =
          pack_bf16(__fmul_rn(flash_q(ds[i], dinv[h], lim_qk), dd[h]),
                    __fmul_rn(flash_q(ds[i + 1], dinv[h], lim_qk), dd[h]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + wg);

    // dv += p^T . do^ and dk += ds^T . q^ over the chunk's 64 q rows
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wgmma_step<1, 1>(dv_acc, make_desc(p_addr + u * 2048, 8192, 1024),
                       make_desc(doh_addr + u * 2048, 8192, 1024), 1);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wgmma_step<1, 1>(dk_acc, make_desc(ds_addr + u * 2048, 8192, 1024),
                       make_desc(qh_addr + u * 2048, 8192, 1024), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_frag(dv_acc);
    fence_frag(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t orow = (rbase + kw + lrow + 8 * h) * hd;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int d = 8 * (i >> 2) + 2 * q4 + (i & 1);
      if (d < hd) {
        store(dk + orow + d, dk_acc[i]);
        store(dv + orow + d, dv_acc[i]);
      }
    }
  }
}

// The int8 routes' scratch, in the C entry points' order: int8 q*alpha,
// k, do, v [BH*S, 128]; their f32 row steps [BH*S]; the bf16 k^ (B5) or
// q^, do^ (B6) [BH*S, 128].
struct BwdScratch {
  int8_t *q8, *k8, *do8, *v8;
  float *qsc, *ksc, *dosc, *vsc;
  __nv_bfloat16 *h0, *h1;
};

template <typename XT>
void launch_bwd_prepass(const void* q, const void* k, const void* v,
                        const void* dout, const BwdScratch& w,
                        __nv_bfloat16* qh, __nv_bfloat16* kh,
                        __nv_bfloat16* doh, int rows, int hd, float scale,
                        int mqk, int mpv, cudaStream_t st) {
  const FlashRows rw = {{q, k, dout, v}, {w.q8, w.k8, w.do8, w.v8},
                        {w.qsc, w.ksc, w.dosc, w.vsc}, {qh, kh, doh, nullptr},
                        {mqk, mqk, mpv, mpv}};
  dim3 g((rows * 32 + 255) / 256, 4);
  flash_rows_prepass<XT><<<g, 256, 0, st>>>(rw, rows, hd, scale);
}

template <typename XT>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, const BwdScratch& w, int BH, int S, int hd, int bq,
                 int bk, int mqk, int mpv, int causal, float scale,
                 cudaStream_t st) {
  const int rows = BH * S;
  launch_bwd_prepass<XT>(q, k, v, dout, w, nullptr, w.h0, nullptr, rows, hd,
                         scale, mqk, mpv, st);
  CUtensorMap tq, tdo, tk, tv, tkh;
  if (!sm90::encode_map(&tq, w.q8, true, rows, kFlashHP, 128, kFlashHP) ||
      !sm90::encode_map(&tdo, w.do8, true, rows, kFlashHP, 128, kFlashHP) ||
      !sm90::encode_map(&tk, w.k8, true, rows, kFlashHP, bk, kFlashHP) ||
      !sm90::encode_map(&tv, w.v8, true, rows, kFlashHP, bk, kFlashHP) ||
      !sm90::encode_map(&tkh, w.h0, false, rows, kFlashHP, bk, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bk == 128 ? flash_dq_tc_kernel<128, XT> : flash_dq_tc_kernel<64, XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, S / 128);
  kern<<<grid, kBwdThreads, kDqSmem, st>>>(
      tq, tdo, tk, tv, tkh, w.qsc, w.ksc, w.dosc, w.vsc, lse, delta,
      static_cast<XT*>(dq), S, hd, bq, causal, mqk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, const BwdScratch& w, int BH, int S,
                  int hd, int bq, int bk, int mqk, int mpv, int causal,
                  float scale, cudaStream_t st) {
  const int rows = BH * S;
  launch_bwd_prepass<XT>(q, k, v, dout, w, w.h0, nullptr, w.h1, rows, hd,
                         scale, mqk, mpv, st);
  CUtensorMap tk, tv, tq, tdo, tqh, tdoh;
  if (!sm90::encode_map(&tk, w.k8, true, rows, kFlashHP, 128, kFlashHP) ||
      !sm90::encode_map(&tv, w.v8, true, rows, kFlashHP, 128, kFlashHP) ||
      !sm90::encode_map(&tq, w.q8, true, rows, kFlashHP, kKvChunk, kFlashHP) ||
      !sm90::encode_map(&tdo, w.do8, true, rows, kFlashHP, kKvChunk, kFlashHP) ||
      !sm90::encode_map(&tqh, w.h0, false, rows, kFlashHP, kKvChunk, 64) ||
      !sm90::encode_map(&tdoh, w.h1, false, rows, kFlashHP, kKvChunk, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bk == 128 ? flash_dkv_tc_kernel<128, XT> : flash_dkv_tc_kernel<64, XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, S / 128);
  kern<<<grid, kBwdThreads, kKvSmem, st>>>(
      tk, tv, tq, tdo, tqh, tdoh, w.ksc, w.vsc, w.qsc, w.dosc, lse, delta,
      static_cast<XT*>(dk), static_cast<XT*>(dv), S, hd, bq, causal, mqk,
      mpv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace hbfp
