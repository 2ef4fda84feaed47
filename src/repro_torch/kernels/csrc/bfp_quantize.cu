// FP -> BFP conversion (the paper's "FP-to-BFP unit", section 5.3) for
// Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the TPU kernel repro/kernels/bfp_quantize.py: bfp_quantize_pallas
// (body _quantize_kernel). For x [R, C] and exponent tiles (tr x tc) on the
// zero-padded grid [ceil(R/tr) x ceil(C/tc)] it computes, per tile,
//
//     e = clamp(floor(log2 amax), -100, 126)   (f32 bit field)
//     q = clip(round(x / 2^(e - m + 2)), -(2^(m-1) - 1), 2^(m-1) - 1)
//
// and writes the mantissas q [R, C] (int8 for m <= 8, else int16), one int8
// exponent per tile and, with stats, the per-tile count of saturated
// elements (|round(x / delta)| > lim) and the exponent min and max per
// block of (block_r x block_c) elements on the reference's _fit_block grid.
// Rounding is round-half-even (rintf) or floor(v + u) with u from the
// paper's xorshift stream, indexed by row * Cp + col with Cp the PADDED
// column count, hashed in uint32 exactly as kernels/common.py does; when x
// is a part of the operand one process converts (a rank's shard of a
// weight), by (row_off + row) * ld + col_off + col, that operand's index
// (IndexBase in hbfp_common.cuh; (0, 0, Cp) for the whole x).
// Elements past R or C are the reference's zero padding: they count 0 in
// the amax and are never written, so the input is never copied. x / delta
// is computed as x * inv_step (hbfp_common.cuh): the same correctly
// rounded f32.
//
// Bound: HBM bytes. The function reads x once and writes the mantissas,
// the exponents and the counts once (about 1.25x the f32 input at m <= 8);
// it does a few flops per element, far below the compute line. At yi-9b's
// head (4096 x 64000 f32) that is 1.31 GB, 0.39 ms at 3.35 TB/s.
//
// Routes. The wrapper (kernels/bfp_quantize.py) owns the policy: it picks
// the route from the shape (bfp_quantize_route, never by failure), plans
// the launch (band_plan, split_ctas) and passes the plan in; the entry
// point here refuses a plan its kernels cannot run (band_ok, vec_ok):
//
//  * banded: rows of C*4 (f32) or C*2 (bf16) bytes that are 16-byte
//    multiples, tc a multiple of the vector width, x 16-byte aligned, and
//    one tile within a CTA. A CTA owns a band of RB tile rows by T whole
//    tiles (24 x 24 f32: one tile row by 16 tiles; 128 x 128: one tile;
//    1 x 4096 bf16 rows: four tiles). Each thread loads up to kBandItems
//    16-byte vectors of ONE tile into registers, all loads issued before
//    any is used; per-vector maxima fold into the thread's, then into the
//    tile's through __match_any_sync / __reduce_max_sync on the bit
//    pattern (non-negative floats order like their bits) and a shared
//    atomicMax. The conversion runs from the registers: x is read from HBM
//    once. Mantissas go out as one 4-, 8- or 16-byte store per vector.
//    Clip counts sum the same way (integers: deterministic); the tile's
//    exponent and count are written by the CTA that owns it.
//  * split: every other shape: tiles too large for one CTA (tile = None,
//    one exponent per matrix), and rows or tiles that are not whole
//    16-byte vectors (then scalar, V = 1). Pass 1 writes each CTA's amax
//    over kSplitItems vectors per thread; pass 2 folds its tile's
//    partials, converts, writes the exponent and per-CTA clip counts; with
//    stats pass 3 sums them per tile. Two reads of x are inherent once x
//    exceeds the 50 MB L2; no memset, no atomics on global memory.
//
// With stats a last small kernel reduces the exponent grid to the
// per-block min and max; it reads one byte per tile. (A banded CTA rarely
// covers whole fitted blocks: at tile 24 yi-9b's blocks are 9 x 19 tiles.)

#include "hbfp_common.cuh"

using namespace hbfp;

namespace {

enum QuantRoute { kRouteBanded = 0, kRouteSplit = 1 };

constexpr int kVecBytes = 16;      // one vector access
constexpr int kBandItems = 8;      // vectors a banded thread holds
constexpr int kBandThreads = 512;  // most threads of a banded CTA
constexpr int kQThreads = 256;     // threads of a split CTA
constexpr int kSplitItems = 8;     // vectors (or scalars) a split thread takes

// Geometry of a banded CTA (the wrapper's band_plan). A tile row is
// vt = tc / V vectors; a CTA covers RB tile rows by T tiles. Its threads
// form Wt columns by Hs * RB rows: thread (c, h) takes vector columns
// c + p * Wt (p < P; P > 1 only when T = 1) and rows h % Hs + q * Hs
// (q < Q) of tile row h / Hs, so all its vectors lie in one tile.
struct Band {
  int vt, T, RB, Wt, P, Hs, Q, threads;
};

// 16-byte vectors: rows of whole vectors, tiles of whole vectors, x
// aligned.
inline bool vec_ok(int C, int tc, int x_bf16, const void* x) {
  const int esize = x_bf16 ? 2 : 4;
  return reinterpret_cast<uintptr_t>(x) % kVecBytes == 0 &&
         (static_cast<long long>(C) * esize) % kVecBytes == 0 &&
         tc % (kVecBytes / esize) == 0;
}

// A banded plan the kernel runs correctly: every vector of every tile
// taken by one thread, each thread's vectors in one tile, the CTA within
// its launch bound and its shared arrays (a slot per tile).
inline bool band_ok(const Band& b, int tr) {
  const bool cols = b.T == 1 ? b.Wt * b.P >= b.vt
                             : b.P == 1 && b.Wt == b.T * b.vt;
  return b.vt > 0 && b.T > 0 && b.RB > 0 && b.P > 0 && b.Hs > 0 &&
         b.Q > 0 && cols && b.Hs * b.Q >= tr &&
         b.P * b.Q <= kBandItems && b.RB * b.T <= kBandThreads &&
         b.threads % 32 == 0 && b.threads <= kBandThreads &&
         b.Wt * b.Hs * b.RB <= b.threads;
}

// Split: a tile is `chunks` chunks of kQThreads * kSplitItems vectors of V
// elements (V = 1: scalar), taken grid-stride by the wrapper's n CTAs.
inline int split_chunks(int tr, int tc, int V) {
  const long long per = static_cast<long long>(kQThreads) * kSplitItems;
  return static_cast<int>((static_cast<long long>(tr) * (tc / V) + per - 1) /
                          per);
}

// ---------------------------------------------------------------------------
// Vector helpers: a 16-byte vector of XT as V floats, and V mantissas as
// one store.

template <typename XT>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ static float get(const uint4& r, int e) {
    const uint32_t w = e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
    return __uint_as_float(w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float get(const uint4& r, int e) {
    const int k = e >> 1;
    const uint32_t w = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
    return __uint_as_float((e & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
};

__device__ __forceinline__ uint32_t pack4_i8(const int* q) {
  return (q[0] & 0xFF) | ((q[1] & 0xFF) << 8) | ((q[2] & 0xFF) << 16) |
         (static_cast<uint32_t>(q[3] & 0xFF) << 24);
}

__device__ __forceinline__ uint32_t pack2_i16(const int* q) {
  return (q[0] & 0xFFFF) | (static_cast<uint32_t>(q[1] & 0xFFFF) << 16);
}

// V mantissas q to mant + off (off a multiple of V elements).
template <int V>
__device__ __forceinline__ void store_mant(int8_t* mant, size_t off,
                                           const int* q) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(mant + off) = pack4_i8(q);
  } else {
    *reinterpret_cast<uint2*>(mant + off) =
        make_uint2(pack4_i8(q), pack4_i8(q + 4));
  }
}

template <int V>
__device__ __forceinline__ void store_mant(int16_t* mant, size_t off,
                                           const int* q) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(mant + off) =
        make_uint2(pack2_i16(q), pack2_i16(q + 2));
  } else {
    *reinterpret_cast<uint4*>(mant + off) =
        make_uint4(pack2_i16(q), pack2_i16(q + 2), pack2_i16(q + 4),
                   pack2_i16(q + 6));
  }
}

// One element: v = x * inv rounded (half to even, or floor(v + u) on the
// stream at idx), clip counted, clamped.
__device__ __forceinline__ int convert_one(float x, float inv, float lim,
                                           int stochastic, uint32_t seed,
                                           uint32_t idx, int& nclip) {
  float v = __fmul_rn(x, inv);
  v = stochastic ? floorf(__fadd_rn(v, uniform_from_index(seed, idx)))
                 : rintf(v);
  nclip += fabsf(v) > lim;
  return static_cast<int>(fminf(fmaxf(v, -lim), lim));
}

struct Geom {
  int R, C, tr, tc, nTr, nTc, Cp;
  IndexBase ib;  // the stochastic index base of x's part
};

// ---------------------------------------------------------------------------
// banded

template <typename XT, typename MT>
__global__ void __launch_bounds__(kBandThreads, 2)
    banded_kernel(const XT* __restrict__ x, MT* __restrict__ mant,
                  int8_t* __restrict__ expo, int* __restrict__ clip, Geom g,
                  Band b, int gx, int mbits, int stochastic, uint32_t seed) {
  constexpr int V = Vec<XT>::V;
  __shared__ unsigned int s_amax[kBandThreads];
  __shared__ int s_clip[kBandThreads];
  const int t = threadIdx.x;
  const int by = blockIdx.x / gx, bx = blockIdx.x % gx;
  const bool active = t < b.Wt * b.Hs * b.RB;
  const int c = t % b.Wt, h = t / b.Wt;
  const int tcol = b.T == 1 ? 0 : c / b.vt;      // the thread's tile
  const int key = active ? (h / b.Hs) * b.T + tcol : -1;
  const int vi0 = c - tcol * b.vt;               // vector column in the tile
  const int ri0 = h % b.Hs;                      // row in the tile
  const int row0 = (by * b.RB + h / b.Hs) * g.tr + ri0;
  const int col0 = ((bx * b.T + tcol) * b.vt + vi0) * V;

  // item i is (p, q): vector column vi0 + p * Wt, row ri0 + q * Hs
  bool in[kBandItems];
  uint4 raw[kBandItems];
  {
    int p = 0, q = 0;
#pragma unroll
    for (int i = 0; i < kBandItems; ++i) {
      const int row = row0 + q * b.Hs, col = col0 + p * b.Wt * V;
      in[i] = active && vi0 + p * b.Wt < b.vt && ri0 + q * b.Hs < g.tr &&
              row < g.R && col < g.C;
      raw[i] = in[i] ? __ldg(reinterpret_cast<const uint4*>(
                           x + static_cast<size_t>(row) * g.C + col))
                     : make_uint4(0u, 0u, 0u, 0u);
      if (++q == b.Q) {
        q = 0;
        ++p;
      }
    }
  }
  for (int i = t; i < b.RB * b.T; i += blockDim.x) {
    s_amax[i] = 0u;
    s_clip[i] = 0;
  }
  __syncthreads();
  float tmax = 0.0f;
#pragma unroll
  for (int i = 0; i < kBandItems; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e)
      tmax = fmaxf(tmax, fabsf(Vec<XT>::get(raw[i], e)));
  const unsigned int group = __match_any_sync(0xffffffffu, key);
  const bool leader = active && (t & 31) == __ffs(group) - 1;
  const unsigned int wmax = __reduce_max_sync(group, __float_as_uint(tmax));
  if (leader) atomicMax(&s_amax[key], wmax);
  __syncthreads();

  for (int i = t; i < b.RB * b.T; i += blockDim.x) {
    const int ei = by * b.RB + i / b.T, ej = bx * b.T + i % b.T;
    if (ei < g.nTr && ej < g.nTc)
      expo[static_cast<size_t>(ei) * g.nTc + ej] = static_cast<int8_t>(
          max_exponent(__uint_as_float(s_amax[i])));
  }
  const float inv = inv_step(__uint_as_float(active ? s_amax[key] : 0u),
                             mbits);
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  int nclip = 0;
  {
    int p = 0, q = 0;
#pragma unroll
    for (int i = 0; i < kBandItems; ++i) {
      const int row = row0 + q * b.Hs, col = col0 + p * b.Wt * V;
      if (in[i]) {
        const uint32_t idx = base_index(g.ib, static_cast<uint32_t>(row),
                                        static_cast<uint32_t>(col));
        int qv[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          qv[e] = convert_one(Vec<XT>::get(raw[i], e), inv, lim, stochastic,
                              seed, idx + e, nclip);
        store_mant<V>(mant, static_cast<size_t>(row) * g.C + col, qv);
      }
      if (++q == b.Q) {
        q = 0;
        ++p;
      }
    }
  }
  if (clip == nullptr) return;
  const int wsum = __reduce_add_sync(group, nclip);
  if (leader) atomicAdd(&s_clip[key], wsum);
  __syncthreads();
  for (int i = t; i < b.RB * b.T; i += blockDim.x) {
    const int ei = by * b.RB + i / b.T, ej = bx * b.T + i % b.T;
    if (ei < g.nTr && ej < g.nTc)
      clip[static_cast<size_t>(ei) * g.nTc + ej] = s_clip[i];
  }
}

// ---------------------------------------------------------------------------
// split

__device__ __forceinline__ unsigned int block_max_bits(unsigned int v,
                                                       unsigned int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = __reduce_max_sync(0xffffffffu,
                          threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x]
                                                          : 0u);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Loads vector i of this thread in chunk `chunk` of tile `tile` (V
// elements; zeros past the tile or past R, C) and returns its element
// offset row * C + col, or -1 when it lies outside x. Tile-local vector k
// is row k / vt, vector column k % vt of the tile.
template <typename XT, int V>
__device__ __forceinline__ long long split_load(const XT* __restrict__ x,
                                                const Geom& g, int tile,
                                                int chunk, int i, float* v,
                                                uint32_t& idx) {
  const uint32_t vt = static_cast<uint32_t>(g.tc / V);
  const uint32_t k = (static_cast<uint32_t>(chunk) * kSplitItems + i) *
                         kQThreads + threadIdx.x;
  const uint32_t r = k / vt;
  const int row = (tile / g.nTc) * g.tr + static_cast<int>(r);
  const int col = (tile % g.nTc) * g.tc + static_cast<int>(k - r * vt) * V;
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = 0.0f;
  if (r >= static_cast<uint32_t>(g.tr) || row >= g.R || col >= g.C)
    return -1;
  const long long off = static_cast<long long>(row) * g.C + col;
  idx = base_index(g.ib, static_cast<uint32_t>(row),
                   static_cast<uint32_t>(col));
  if constexpr (V == 1) {
    v[0] = to_f(x[off]);
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + off));
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = Vec<XT>::get(raw, e);
  }
  return off;
}

// Pass 1: CTA (tile, j) takes chunks j, j + n, ... (n = split_ctas) and
// writes their amax bits to part[tile * n + j].
template <typename XT, int V>
__global__ void __launch_bounds__(kQThreads)
    split_amax_kernel(const XT* __restrict__ x,
                      unsigned int* __restrict__ part, Geom g, int chunks,
                      int n) {
  __shared__ unsigned int red[32];
  const int tile = blockIdx.x / n;
  float m = 0.0f;
  for (int ch = blockIdx.x % n; ch < chunks; ch += n) {
#pragma unroll
    for (int i = 0; i < kSplitItems; ++i) {
      float v[V];
      uint32_t idx;
      split_load<XT, V>(x, g, tile, ch, i, v, idx);
#pragma unroll
      for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  }
  const unsigned int bits = block_max_bits(__float_as_uint(m), red);
  if (threadIdx.x == 0) part[blockIdx.x] = bits;
}

// Pass 2: fold the tile's n partials, convert the same chunks as pass 1;
// CTA (tile, 0) writes the exponent, each CTA its clip count to
// cpart[blockIdx.x] (when cpart is set).
template <typename XT, typename MT, int V>
__global__ void __launch_bounds__(kQThreads)
    split_convert_kernel(const XT* __restrict__ x, MT* __restrict__ mant,
                         int8_t* __restrict__ expo,
                         const unsigned int* __restrict__ part,
                         int* __restrict__ cpart, Geom g, int chunks, int n,
                         int mbits, int stochastic, uint32_t seed) {
  __shared__ unsigned int red[32];
  const int tile = blockIdx.x / n;
  unsigned int m = 0u;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    m = max(m, part[static_cast<size_t>(tile) * n + k]);
  const float amax = __uint_as_float(block_max_bits(m, red));
  if (blockIdx.x % n == 0 && threadIdx.x == 0)
    expo[tile] = static_cast<int8_t>(max_exponent(amax));
  const float inv = inv_step(amax, mbits);
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  int nclip = 0;
  for (int ch = blockIdx.x % n; ch < chunks; ch += n) {
    float v[kSplitItems][V];
    long long off[kSplitItems];
    uint32_t idx[kSplitItems];
#pragma unroll
    for (int i = 0; i < kSplitItems; ++i)
      off[i] = split_load<XT, V>(x, g, tile, ch, i, v[i], idx[i]);
#pragma unroll
    for (int i = 0; i < kSplitItems; ++i) {
      if (off[i] < 0) continue;
      int qv[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        qv[e] = convert_one(v[i][e], inv, lim, stochastic, seed, idx[i] + e,
                            nclip);
      if constexpr (V == 1)
        mant[off[i]] = static_cast<MT>(qv[0]);
      else
        store_mant<V>(mant, static_cast<size_t>(off[i]), qv);
    }
  }
  if (cpart == nullptr) return;
  __syncthreads();  // every thread has read red[0]
  nclip = __reduce_add_sync(0xffffffffu, nclip);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = nclip;
  __syncthreads();
  if (threadIdx.x < 32) {
    nclip = __reduce_add_sync(
        0xffffffffu, threadIdx.x < (blockDim.x >> 5)
                         ? static_cast<int>(red[threadIdx.x])
                         : 0);
    if (threadIdx.x == 0) cpart[blockIdx.x] = nclip;
  }
}

// Pass 3 (stats): clip[tile] = the sum of its n CTAs' counts, a warp a
// tile.
__global__ void split_clip_kernel(const int* __restrict__ cpart,
                                  int* __restrict__ clip, int n_tiles,
                                  int n) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_tiles) return;
  int s = 0;
  for (int k = lane; k < n; k += 32) s += cpart[static_cast<size_t>(w) * n + k];
  s = __reduce_add_sync(0xffffffffu, s);
  if (lane == 0) clip[w] = s;
}

// ---------------------------------------------------------------------------
// stats: exponent min and max per block of (btr x btc) tiles, a warp a
// block.
__global__ void block_minmax_kernel(const int8_t* __restrict__ expo,
                                    int* __restrict__ emin,
                                    int* __restrict__ emax, int nTc, int btr,
                                    int btc, int nBc, int n_blocks) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_blocks) return;
  const int bi = w / nBc, bj = w % nBc;
  int lo = 127, hi = -128;
  for (int t = lane; t < btr * btc; t += 32) {
    const int e = expo[static_cast<size_t>(bi * btr + t / btc) * nTc +
                       bj * btc + t % btc];
    lo = min(lo, e);
    hi = max(hi, e);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    emin[w] = lo;
    emax[w] = hi;
  }
}

template <typename XT, typename MT>
void launch_convert(int route, int V, const Band& b, int n, const void* x,
                    void* mant, int8_t* expo, int* clip,
                    unsigned int* scratch, const Geom& g, int mbits,
                    int stochastic, uint32_t seed, cudaStream_t stream) {
  constexpr int VX = Vec<XT>::V;
  const XT* xt = static_cast<const XT*>(x);
  MT* mt = static_cast<MT*>(mant);
  const int n_tiles = g.nTr * g.nTc;
  if (route == kRouteBanded) {
    const int gx = (g.nTc + b.T - 1) / b.T;
    const unsigned grid = static_cast<unsigned>(gx) *
                          ((g.nTr + b.RB - 1) / b.RB);
    banded_kernel<XT, MT><<<grid, b.threads, 0, stream>>>(
        xt, mt, expo, clip, g, b, gx, mbits, stochastic, seed);
    return;
  }
  const int chunks = split_chunks(g.tr, g.tc, V);
  const unsigned grid = static_cast<unsigned>(n_tiles) * n;
  int* cpart = clip != nullptr ? reinterpret_cast<int*>(scratch + grid)
                               : nullptr;
  if (V == VX) {
    split_amax_kernel<XT, VX><<<grid, kQThreads, 0, stream>>>(
        xt, scratch, g, chunks, n);
    split_convert_kernel<XT, MT, VX><<<grid, kQThreads, 0, stream>>>(
        xt, mt, expo, scratch, cpart, g, chunks, n, mbits, stochastic, seed);
  } else {
    split_amax_kernel<XT, 1><<<grid, kQThreads, 0, stream>>>(
        xt, scratch, g, chunks, n);
    split_convert_kernel<XT, MT, 1><<<grid, kQThreads, 0, stream>>>(
        xt, mt, expo, scratch, cpart, g, chunks, n, mbits, stochastic, seed);
  }
  if (clip != nullptr)
    split_clip_kernel<<<(n_tiles * 32 + 255) / 256, 256, 0, stream>>>(
        cpart, clip, n_tiles, n);
}

template <typename XT>
void launch_by_mantissa(int mant_16, int route, int V, const Band& b, int n,
                        const void* x, void* mant, int8_t* expo, int* clip,
                        unsigned int* scratch, const Geom& g, int mbits,
                        int stochastic, uint32_t seed, cudaStream_t stream) {
  if (mant_16)
    launch_convert<XT, int16_t>(route, V, b, n, x, mant, expo, clip,
                                scratch, g, mbits, stochastic, seed, stream);
  else
    launch_convert<XT, int8_t>(route, V, b, n, x, mant, expo, clip, scratch,
                               g, mbits, stochastic, seed, stream);
}

}  // namespace

// Plain C entry point. x: [R, C] f32 or bf16 (x_bf16), contiguous; mant:
// [R, C] int8, or int16 when mant_16; expo: [R/tr, C/tc] int8 on the padded
// tile grid; with stats, clip [R/tr, C/tc] int32 and emin, emax
// [Rp/block_r, Cp/block_c] int32 (block_r, block_c in elements, the
// reference's fitted blocks), else those three are null. (tr, tc) are the
// reference's clipped tiles. The plan is the wrapper's: `route`, the
// elements V of one access (the vector width, or 1 for scalar split),
// the banded geometry (T, RB, Wt, P, Hs, Q, threads; see Band) and the
// split route's CTAs per tile n_split. scratch holds scratch_words uint32:
// split needs n_tiles * n_split words (twice that with stats), banded
// none. A plan the kernels cannot run is refused. (row_off, col_off, ld):
// x's part in the padded one-process operand for the stochastic index
// ((0, 0, Cp) for the whole x; ld >= col_off + C). Returns a cudaError_t
// code.
extern "C" int bfp_quantize(const void* x, int x_bf16, void* mant,
                            int mant_16, int8_t* expo, int* clip, int* emin,
                            int* emax, unsigned int* scratch, int R, int C,
                            int tr, int tc, int block_r, int block_c,
                            int mbits, int stochastic, int seed,
                            int row_off, int col_off, int ld,
                            int with_stats, int route, int V, int T, int RB,
                            int Wt, int P, int Hs, int Q, int threads,
                            int n_split, int scratch_words,
                            void* stream_ptr) {
  if (R <= 0 || C <= 0 || tr <= 0 || tc <= 0 || tr > R || tc > C ||
      static_cast<long long>(tr) * tc > 0x7fffffffLL || mbits < 2 ||
      mbits > 16 || block_r <= 0 || block_c <= 0 ||
      block_r % tr || block_c % tc || (mant_16 != 0) != (mbits > 8) ||
      (with_stats && (clip == nullptr || emin == nullptr || emax == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nTr = (R + tr - 1) / tr, nTc = (C + tc - 1) / tc;
  const int Rp = nTr * tr, Cp = nTc * tc;
  IndexBase ib;
  if (Rp % block_r || Cp % block_c || !make_base(row_off, col_off, ld, C, &ib))
    return static_cast<int>(cudaErrorInvalidValue);
  const int VX = kVecBytes / (x_bf16 ? 2 : 4);
  const bool vec = vec_ok(C, tc, x_bf16, x);
  if (!(V == 1 || (V == VX && vec)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Band b{tc / V, T, RB, Wt, P, Hs, Q, threads};
  const long long n_tiles = static_cast<long long>(nTr) * nTc;
  if (route == kRouteBanded) {
    if (V != VX || !band_ok(b, tr))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (route == kRouteSplit) {
    if (n_split <= 0 || n_tiles * n_split > 0x7fffffffLL ||
        scratch == nullptr ||
        scratch_words < n_tiles * n_split * (with_stats ? 2 : 1))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g{R, C, tr, tc, nTr, nTc, Cp, ib};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const uint32_t useed = static_cast<uint32_t>(seed);
  int* clip_out = with_stats ? clip : nullptr;
  if (x_bf16)
    launch_by_mantissa<__nv_bfloat16>(mant_16, route, V, b, n_split, x, mant,
                                      expo, clip_out, scratch, g, mbits,
                                      stochastic, useed, stream);
  else
    launch_by_mantissa<float>(mant_16, route, V, b, n_split, x, mant, expo,
                              clip_out, scratch, g, mbits, stochastic, useed,
                              stream);
  if (with_stats) {
    const int btr = block_r / tr, btc = block_c / tc;
    const int nBc = Cp / block_c;
    const int n_blocks = (Rp / block_r) * nBc;
    const int grid = (n_blocks * 32 + 255) / 256;
    block_minmax_kernel<<<grid, 256, 0, stream>>>(expo, emin, emax, nTc, btr,
                                                  btc, nBc, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
