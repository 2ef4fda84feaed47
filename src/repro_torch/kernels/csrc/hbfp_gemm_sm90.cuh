// Tensor-core GEMM pass of B1 (hbfp_matmul_fwd), B2 (hbfp_dgrad) and B3's
// bf16 route (hbfp_wgrad, hbfp_matmul_bwd.cu: tc_wgrad) for Hopper
// (sm_90a): TMA loads into a 4-stage shared-memory ring, wgmma on int8
// mantissas (int32 sums) or bf16 mantissas (f32 sums), and the
// reference's per-K-block promotion in ascending K-block order.
//
//     y[M, O] = sum over contraction blocks kb, ascending, of
//               part_kb * (s_a * s_w)        (kRouteInt8)
//               part_kb * s_a                (kRouteBf16)
//               part_kb                      (B3: s_a null, the scales
//                                             inside the operands)
//
// Routes. kRouteInt8 takes integral m <= 8 mantissas of both operands
// (quantize_w set, no sub-tile groups): the int32 sum of a K-block is
// exact and __int2float_rn rounds it once, as the plain version's float64
// partial does. kRouteBf16 takes bf16 x mantissas (|q| <= 127, exact in
// bf16) against weights taken as stored in bf16 (quantize_w unset): each
// product is exact in f32 and so is the K-block's sum wherever the weights
// were narrowed on the kernel's tile. Everything else (m > 8, block > 0,
// f32 raw weights, tiles the tensor-core shapes do not take) stays on the
// CUDA-core gemm_kernel of hbfp_common.cuh: tc_route() decides, and the
// Python wrapper (kernels/hbfp_matmul.py: gemm_route) mirrors it.
//
// CTA. 64 x NWG rows by 128 columns: NWG consumer warpgroups (one per 64
// rows) and one producer warpgroup. The producer's first thread keeps TMA
// loads of A [rows, 128 bytes of K] and B [128 columns, 128 bytes of K] in
// flight, 128-byte swizzled, completion counted on the stage's `full`
// mbarrier; each consumer warp releases a stage on its `empty` mbarrier
// once its wgmmas on it have completed. A stage holds 4 wgmma K-steps (k32
// for s8, k16 for bf16), and a K-block is a whole number of stages (the
// routes take contraction blocks of 128-byte multiples: bk = 128 on every
// main path, 1024 spans eight stages). The K-block's partial lives in its
// own register fragment (scale-d = 0 on the block's first step); after
// its last stage the group is waited on, the stage released, and the
// partial promoted with explicit round-to-nearest multiply and add:
// acc = __fadd_rn(acc, __fmul_rn(part, scale)), the scales fetched before
// the wait.
//
// Small M (<= 64, the decode tick). One consumer warpgroup, and the
// contraction's K-blocks split across grid.z when the N tiles alone would
// leave the card idle. Each K-block's scaled partial t_kb =
// __fmul_rn(part_kb, scale_kb) is one exact value whoever computes it, so
// the CTAs write t_kb to an f32 scratch [nkb, M, O] and fold_kernel adds
// them with __fadd_rn in ascending kb from 0.0f: bit for bit the result of
// the single-CTA loop.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hbfp_common.cuh"

namespace hbfp {
namespace sm90 {

enum Route { kRouteCudaCore = 0, kRouteInt8 = 1, kRouteBf16 = 2 };

constexpr int kBN = 128;         // CTA tile columns
constexpr int kRowBytes = 128;   // K bytes per stage row: one swizzle span
constexpr int kStages = 4;
constexpr int kSteps = 4;        // wgmma K-steps per stage, 32 bytes each
constexpr int kBTileBytes = kBN * kRowBytes;
constexpr int kSMs = 132;        // H100 SXM
constexpr int kSmallM = 64;      // M at or below: one warpgroup, split-K

// The route of one call. cblk: contraction block (bk fwd, bn dgrad), a
// whole number of 128-byte stages; oblk: output-column group of w's
// scales, whole 8-column fragment pairs; b_mn_cols: w's row length when B
// is read MN-major (the forward's stored [K, N], 16-byte rows for TMA),
// else 0.
inline int tc_route(int quantize_w, int mode, int mbits, int w_bf16,
                    int cblk, int oblk, int b_mn_cols) {
  if (mbits > 8) return kRouteCudaCore;
  if (quantize_w && mode == kModeInt && cblk % 128 == 0 && oblk % 8 == 0)
    return kRouteInt8;
  if (!quantize_w && mode == kModeRawW && w_bf16 && cblk % 64 == 0 &&
      b_mn_cols % 8 == 0)
    return kRouteBf16;
  return kRouteCudaCore;
}

// K-range splits of a small-M call: enough CTAs for two waves, whole
// K-blocks per split, no empty split.
inline int decode_splits(int M, int O, int nkb) {
  if (M > kSmallM) return 1;
  const int ctas = (O + kBN - 1) / kBN;
  if (ctas >= kSMs) return 1;
  const int want = min(nkb, (2 * kSMs + ctas - 1) / ctas);
  const int per = (nkb + want - 1) / want;
  return (nkb + per - 1) / per;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spins inside the asm block, so the compiler sees no divergent loop
// around the wgmmas that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major: LBO 16 B
// (unused inside one swizzle span), SBO 1024 B between 8-row groups.
// MN-major: LBO between 64-element MN atoms, SBO 1024 B between 8-row K
// groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a fragment (an
// accumulator, or B5's register-A slices [T][4]) across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_frag(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int T>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[T][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[t][r])::"memory");
}

#define HBFP_D64                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63}"
#define HBFP_OP8(C, i)                                                 \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),         \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define HBFP_OP64(C)                                                   \
  HBFP_OP8(C, 0), HBFP_OP8(C, 8), HBFP_OP8(C, 16), HBFP_OP8(C, 24),    \
      HBFP_OP8(C, 32), HBFP_OP8(C, 40), HBFP_OP8(C, 48), HBFP_OP8(C, 56)
#define HBFP_RW_I(x) "+r"(x)
#define HBFP_RW_F(x) "+f"(x)

// d[64] (+)= A[64 x 32] . B[32 x 128], s8 x s8 -> s32, both K-major
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HBFP_D64
      ", %64, %65, p;\n}\n"
      : HBFP_OP64(HBFP_RW_I)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A[64 x 16] . B[16 x 128], bf16 -> f32; A K-major (TA = 0)
// or MN-major (TA = 1, B3's x^ read in its stored [M, K]), B K-major
// (TB = 0) or MN-major (TB = 1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HBFP_D64
      ", %64, %65, p, 1, 1, %68, %67;\n}\n"
      : HBFP_OP64(HBFP_RW_F)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}

// int32 -> f32, exact below 2^22 in magnitude: the integer lands in the
// mantissa of 1.5 * 2^23 (one integer add, one f32 subtract, both at the
// full f32 rate; I2F issues at a quarter of it).
__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);
}

// The scales of K-block kb for this thread's two rows and sixteen column
// pairs: s_a per row (1.0 where sa is null: B3's operands carry their
// scales), s_w per column pair's weight group (I8 only).
template <bool I8, bool W_T>
__device__ __forceinline__ void load_scales(const float* __restrict__ sa,
                                            const float* __restrict__ sw,
                                            int kb, int ncb, int nob, int M,
                                            int r_lo, const int (&cg)[16],
                                            float (&s_a)[2], float (&s_w)[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    s_a[h] = sa == nullptr
                 ? 1.0f
                 : sa[static_cast<size_t>(min(r_lo + 8 * h, M - 1)) * ncb + kb];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    s_w[j] = !I8 ? 1.0f
           : W_T ? sw[static_cast<size_t>(cg[j]) * ncb + kb]
                 : sw[static_cast<size_t>(kb) * nob + cg[j]];
}

// t = part * scale of one fragment element, with explicit round-to-nearest
// ops. FAST: the int32 partial is known below 2^22 (small_int_to_float).
template <bool I8, bool FAST, typename Acc>
__device__ __forceinline__ float scaled(Acc v, float s_a, float s_w) {
  if constexpr (I8) {
    const float p = FAST ? small_int_to_float(v) : __int2float_rn(v);
    return __fmul_rn(p, __fmul_rn(s_a, s_w));
  } else {
    return __fmul_rn(v, s_a);
  }
}

// Promotes one K-block's fragment: acc = __fadd_rn(acc, t) in place, or,
// for a split contraction, t written to part[kb] (the fold adds it).
template <bool I8, bool FAST, typename Acc>
__device__ __forceinline__ void promote(const Acc (&pt)[64], float (&acc)[64],
                                        const float (&s_a)[2],
                                        const float (&s_w)[16], float* part,
                                        int kb, int M, int O, int r_lo,
                                        int c_lo) {
  if (part == nullptr) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = __fadd_rn(acc[i], scaled<I8, FAST>(pt[i], s_a[(i >> 1) & 1],
                                                  s_w[i >> 2]));
    return;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = r_lo + 8 * ((i >> 1) & 1);
    const int col = c_lo + 8 * (i >> 2) + (i & 1);
    if (row < M && col < O)
      part[(static_cast<size_t>(kb) * M + row) * O + col] =
          scaled<I8, FAST>(pt[i], s_a[(i >> 1) & 1], s_w[i >> 2]);
  }
}

template <bool I8, typename Acc>
__device__ __forceinline__ void promote_any(bool fast, const Acc (&pt)[64],
                                            float (&acc)[64],
                                            const float (&s_a)[2],
                                            const float (&s_w)[16],
                                            float* part, int kb, int M,
                                            int O, int r_lo, int c_lo) {
  if (I8 && fast)
    promote<I8, true>(pt, acc, s_a, s_w, part, kb, M, O, r_lo, c_lo);
  else
    promote<I8, false>(pt, acc, s_a, s_w, part, kb, M, O, r_lo, c_lo);
}

// I8: int8 operands (kRouteInt8), else bf16 (kRouteBf16). B_MN: B is w's
// stored [C, O] (the forward's bf16 route), read MN-major; else B is
// [O, C], K-major. A_MN: A is stored [C, M] and read MN-major (B3's x^,
// bf16 only), else [M, C], K-major. W_T: w's scales are [O/oblk, C/cblk]
// (dgrad), else [C/cblk, O/oblk]. part: f32 scratch [nkb, M, O] of scaled K-block partials when
// grid.z > 1, folded afterwards; else y is written. fast_cvt: every int32
// partial is below 2^22 (lim^2 * cblk).
//
// Threads: NWG consumer warpgroups, then one producer warpgroup whose
// first thread issues every TMA load. With two consumer warpgroups the
// producer gives up registers (setmaxnreg) so the consumers hold their
// partial and accumulator fragments (2 x 64) without spilling.
template <int NWG, bool I8, bool B_MN, bool W_T, bool A_MN>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
               const __grid_constant__ CUtensorMap tma_b,
               const float* __restrict__ sa, const float* __restrict__ sw,
               float* __restrict__ y, float* __restrict__ part, int M, int C,
               int O, int cblk, int oblk, int kb_per_split, int fast_cvt) {
  using Acc = typename std::conditional<I8, int, float>::type;
  constexpr int kABytes = NWG * 64 * kRowBytes;
  constexpr int kStageBytes = kABytes + kBTileBytes;
  constexpr int kStep = I8 ? 32 : 16;           // elements per K-step
  constexpr int kStageK = kSteps * kStep;       // elements per stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int ncb = C / cblk;
  const int nob = O / oblk;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(ncb, kb0 + kb_per_split);
  const int spk = cblk / kStep;                 // K-steps per K-block
  const int t0 = kb0 * spk;
  const int nst = (kb1 - kb0) * spk / kSteps;
  const int m0 = blockIdx.y * NWG * 64;
  const int o0 = blockIdx.x * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, provably uniform across the warp (a shuffled
  // value), so the compiler keeps the consumers' wgmmas asynchronous
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == NWG) {
    // producer warpgroup: its first thread issues every load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NWG * 128) {
      for (int s = 0; s < nst; ++s) {
        const int st = s % kStages;
        mbar_wait(&empty[st], ((s / kStages) & 1) ^ 1);
        uint8_t* a_dst = sm + st * kStageBytes;
        uint8_t* b_dst = a_dst + kABytes;
        const int kc = t0 * kStep + s * kStageK;
        mbar_expect_tx(&full[st], kStageBytes);
        if (A_MN) {
#pragma unroll
          for (int w = 0; w < NWG; ++w)
            tma_load(a_dst + w * 64 * kRowBytes, &tma_a, &full[st],
                     m0 + w * 64, kc);
        } else {
          tma_load(a_dst, &tma_a, &full[st], kc, m0);
        }
        if (B_MN) {
          tma_load(b_dst, &tma_b, &full[st], o0, kc);
          tma_load(b_dst + kBTileBytes / 2, &tma_b, &full[st], o0 + 64, kc);
        } else {
          tma_load(b_dst, &tma_b, &full[st], kc, o0);
        }
      }
    }
  } else {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;  // and +8
    const int c_lo = o0 + 2 * (lane % 4);                        // + 8j, +1
    float* out = gridDim.z > 1 ? part : nullptr;
    int cg[16];                   // w's scale group of each column pair
#pragma unroll
    for (int j = 0; j < 16; ++j) cg[j] = min(c_lo + 8 * j, O - 1) / oblk;
    Acc pt[64];
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      pt[i] = Acc(0);
      acc[i] = 0.0f;
    }

    for (int s = 0; s < nst; ++s) {
      const int st = s % kStages;
      const uint32_t a_addr = smem_u32(sm + st * kStageBytes) + wg * 64 * kRowBytes;
      const uint32_t b_addr = smem_u32(sm + st * kStageBytes) + kABytes;
      const int tb = t0 + s * kSteps;           // the stage's first K-step
      const bool kb_first = tb % spk == 0;
      const bool kb_last = (tb + kSteps) % spk == 0;
      const int kb = tb / spk;
      float s_a[2] = {0.0f, 0.0f}, s_w[16];
      if (kb_last)
        load_scales<I8, W_T>(sa, sw, kb, ncb, nob, M, r_lo, cg, s_a, s_w);
      mbar_wait(&full[st], (s / kStages) & 1);
      fence_frag(pt);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const uint64_t da =
            A_MN ? make_desc(a_addr + u * 16 * kRowBytes, kBTileBytes / 2, 1024)
                 : make_desc(a_addr + u * 32, 16, 1024);
        const uint64_t db =
            B_MN ? make_desc(b_addr + u * 16 * kRowBytes, kBTileBytes / 2, 1024)
                 : make_desc(b_addr + u * 32, 16, 1024);
        const int accumulate = !(kb_first && u == 0);
        if constexpr (I8)
          wgmma_step(pt, da, db, accumulate);
        else
          wgmma_step<A_MN ? 1 : 0, B_MN ? 1 : 0>(pt, da, db, accumulate);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_frag(pt);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (kb_last)
        promote_any<I8>(fast_cvt, pt, acc, s_a, s_w, out, kb, M, O, r_lo,
                        c_lo);
    }

    if (out == nullptr) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int row = r_lo + 8 * ((i >> 1) & 1);
        const int col = c_lo + 8 * (i >> 2) + (i & 1);
        if (row < M && col < O) y[static_cast<size_t>(row) * O + col] = acc[i];
      }
    }
  }
}

// y[i] = ascending fold of part[kb][i] from 0.0f: the single-CTA loop's
// sum of the same scaled partials.
__global__ void fold_kernel(const float* __restrict__ part,
                            float* __restrict__ y, int nkb, long long MO) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MO) return;
  float acc = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) acc = __fadd_rn(acc, part[kb * MO + i]);
  y[i] = acc;
}

// 2-D tensor map over a row-major [rows, cols] matrix of 1- or 2-byte
// elements, box [box_rows, box_cols], 128-byte swizzle, zero fill.
inline bool encode_map(CUtensorMap* map, const void* ptr, bool bytes1,
                       int rows, int cols, int box_rows, int box_cols) {
  const size_t esize = bytes1 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map,
             bytes1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, bool I8, bool B_MN, bool W_T, bool A_MN = false>
cudaError_t launch_tc(const CUtensorMap& ta, const CUtensorMap& tb,
                      const float* sa, const float* sw, float* y,
                      float* part, int M, int C, int O, int cblk, int oblk,
                      int splits, int fast_cvt, cudaStream_t st) {
  constexpr int smem = kStages * (NWG * 64 * kRowBytes + kBTileBytes) +
                       1024 + 2 * kStages * 8;
  auto kern = tc_gemm_kernel<NWG, I8, B_MN, W_T, A_MN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nkb = C / cblk;
  const int per = (nkb + splits - 1) / splits;
  dim3 grid((O + kBN - 1) / kBN, (M + NWG * 64 - 1) / (NWG * 64), splits);
  kern<<<grid, (NWG + 1) * 128, smem, st>>>(ta, tb, sa, sw, y, part, M, C,
                                            O, cblk, oblk, per, fast_cvt);
  if (splits > 1) {
    const long long MO = static_cast<long long>(M) * O;
    fold_kernel<<<static_cast<int>((MO + kThreads - 1) / kThreads), kThreads,
                  0, st>>>(part, y, nkb, MO);
  }
  return cudaGetLastError();
}

// The GEMM pass of a tensor-core route. a: [M, C] mantissas (int8 or bf16)
// with scales sa [M, C/cblk]; b: int8 [O, C] (kRouteInt8), bf16 [O, C]
// (kRouteBf16, dgrad) or bf16 [C, O] (kRouteBf16, forward: b_mn);
// sw: w's scales (kRouteInt8). part: [nkb, M, O] f32 when
// decode_splits() > 1, else unused. mbits bounds the int32 partials.
template <bool W_T>
cudaError_t tc_gemm(int route, bool b_mn, const void* a, const float* sa,
                    const void* b, const float* sw, float* y, float* part,
                    int M, int C, int O, int cblk, int oblk, int mbits,
                    cudaStream_t st) {
  const bool i8 = route == kRouteInt8;
  const long long lim = (1 << (mbits - 1)) - 1;
  const int fast = i8 && lim * lim * cblk < (1LL << 22);
  const int nwg = M <= kSmallM ? 1 : 2;
  const int splits = decode_splits(M, O, C / cblk);
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const int elems = i8 ? 128 : 64;              // K elements per stage row
  CUtensorMap ta, tb;
  bool ok = encode_map(&ta, a, i8, M, C, nwg * 64, elems);
  ok = ok && (b_mn ? encode_map(&tb, b, false, C, O, 64, 64)
                   : encode_map(&tb, b, i8, O, C, kBN, elems));
  if (!ok) return cudaErrorInvalidValue;
  if (i8) {
    return nwg == 1
        ? launch_tc<1, true, false, W_T>(ta, tb, sa, sw, y, part, M, C, O, cblk, oblk, splits, fast, st)
        : launch_tc<2, true, false, W_T>(ta, tb, sa, sw, y, part, M, C, O, cblk, oblk, splits, fast, st);
  }
  if (b_mn) {
    if constexpr (W_T) return cudaErrorInvalidValue;   // dgrad reads K-major
    else
      return nwg == 1
          ? launch_tc<1, false, true, false>(ta, tb, sa, sw, y, part, M, C, O, cblk, oblk, splits, fast, st)
          : launch_tc<2, false, true, false>(ta, tb, sa, sw, y, part, M, C, O, cblk, oblk, splits, fast, st);
  }
  return nwg == 1
      ? launch_tc<1, false, false, W_T>(ta, tb, sa, sw, y, part, M, C, O, cblk, oblk, splits, fast, st)
      : launch_tc<2, false, false, W_T>(ta, tb, sa, sw, y, part, M, C, O, cblk, oblk, splits, fast, st);
}

}  // namespace sm90
}  // namespace hbfp
