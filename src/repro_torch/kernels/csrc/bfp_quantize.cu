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
// column count, hashed in uint32 exactly as kernels/common.py does.
// Elements past R or C are the reference's zero padding: they count 0 in
// the amax and are never written, so the input is never copied.
//
// Bound: HBM bytes. The function reads x once and writes the mantissas,
// the exponents and the counts once (about 1.25x the f32 input at m <= 8);
// it does a few flops per element, far below the compute line. At yi-9b's
// head (4096 x 64000 f32) that is 1.31 GB, 0.39 ms at 3.35 TB/s.
//
// Design. Exponent tiles of up to kFusedMax elements (every tile of the
// training path: 128 x 128 weights, 24 x 24, 1 x 4096 activation rows) take
// one CTA each: an amax pass, a block reduction, then the quantize pass,
// whose second read of the tile mostly hits L2. Larger tiles (tile = None,
// one exponent for a whole matrix) are split over CTAs of kChunk elements:
// an amax pass that atomicMax-es the bit pattern of |x| (non-negative
// floats order like their bits, so the result does not depend on the order
// of the atomics), then the quantize pass with atomicAdd-ed clip counts
// (integer, so deterministic too). A last small pass reduces the exponent
// grid to the per-block min and max. What this simple design leaves on the
// table: no vectorized 16-byte loads, a second read of each tile instead of
// keeping it in shared memory or registers, and one 256-thread CTA even
// for 24 x 24 tiles.

#include "hbfp_common.cuh"

using namespace hbfp;

namespace {

constexpr int kQThreads = 256;
constexpr int kFusedMax = 32768;  // tile elements one CTA converts
constexpr int kChunk = 16384;     // elements per CTA of a split tile

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The stored exponent, read back from delta's bit pattern as the
// reference does: the clamped floor(log2 amax) while delta is normal.
__device__ __forceinline__ int stored_exponent(float delta, int mbits) {
  return static_cast<int>((__float_as_uint(delta) >> 23) & 0xFFu) - 127 +
         (mbits - 2);
}

struct Tile {
  int R, C, tr, tc, nTc, Cp;
};

// Converts elements [t0, t1) (tile-local, row-major) of tile `tile`;
// returns this thread's count of saturated elements.
template <typename XT, typename MT>
__device__ __forceinline__ int convert_range(const XT* __restrict__ x,
                                             MT* __restrict__ mant,
                                             const Tile& g, int tile,
                                             int t0, int t1,
                                             float delta, int mbits,
                                             int stochastic, uint32_t seed) {
  const float lim = static_cast<float>((1 << (mbits - 1)) - 1);
  const int r0 = (tile / g.nTc) * g.tr;
  const int c0 = (tile % g.nTc) * g.tc;
  int nclip = 0;
  for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    const int r = r0 + t / g.tc;
    const int c = c0 + t % g.tc;
    if (r >= g.R || c >= g.C) continue;
    const size_t off = static_cast<size_t>(r) * g.C + c;
    float v = __fdiv_rn(to_f(x[off]), delta);
    if (stochastic) {
      const uint32_t idx = static_cast<uint32_t>(r) *
                               static_cast<uint32_t>(g.Cp) +
                           static_cast<uint32_t>(c);
      v = floorf(__fadd_rn(v, uniform_from_index(seed, idx)));
    } else {
      v = rintf(v);
    }
    nclip += fabsf(v) > lim;
    mant[off] = static_cast<MT>(static_cast<int>(fminf(fmaxf(v, -lim), lim)));
  }
  return nclip;
}

template <typename XT>
__device__ __forceinline__ float range_amax(const XT* __restrict__ x,
                                            const Tile& g, int tile,
                                            int t0, int t1) {
  const int r0 = (tile / g.nTc) * g.tr;
  const int c0 = (tile % g.nTc) * g.tc;
  float amax = 0.0f;
  for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    const int r = r0 + t / g.tc;
    const int c = c0 + t % g.tc;
    if (r < g.R && c < g.C)
      amax = fmaxf(amax, fabsf(to_f(x[static_cast<size_t>(r) * g.C + c])));
  }
  return amax;
}

// One CTA per exponent tile.
template <typename XT, typename MT>
__global__ void __launch_bounds__(kQThreads)
    quantize_tile_kernel(const XT* __restrict__ x, MT* __restrict__ mant,
                         int8_t* __restrict__ expo, int* __restrict__ clip,
                         Tile g, int mbits, int stochastic, uint32_t seed) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int tile = blockIdx.x;
  const int count = g.tr * g.tc;
  const float amax = block_max(range_amax(x, g, tile, 0, count), redf);
  const float delta = pow2i(max_exponent(amax) - mbits + 2);
  const int nclip = convert_range(x, mant, g, tile, 0, count, delta, mbits,
                                  stochastic, seed);
  if (threadIdx.x == 0)
    expo[tile] = static_cast<int8_t>(stored_exponent(delta, mbits));
  if (clip != nullptr) {
    const int total = block_sum(nclip, redi);
    if (threadIdx.x == 0) clip[tile] = total;
  }
}

// Split tiles, pass 1: each CTA's amax of kChunk elements, atomicMax-ed
// as bits into amax_bits[tile] (zeroed by the caller).
template <typename XT>
__global__ void __launch_bounds__(kQThreads)
    split_amax_kernel(const XT* __restrict__ x,
                      unsigned int* __restrict__ amax_bits, Tile g,
                      int chunks) {
  __shared__ float redf[32];
  const int tile = blockIdx.x / chunks;
  const int t0 = (blockIdx.x % chunks) * kChunk;
  const int t1 = min(t0 + kChunk, g.tr * g.tc);
  const float amax = block_max(range_amax(x, g, tile, t0, t1), redf);
  if (threadIdx.x == 0 && amax > 0.0f)
    atomicMax(&amax_bits[tile], __float_as_uint(amax));
}

// Split tiles, pass 2: convert kChunk elements; clip counts atomicAdd-ed
// into clip[tile] (zeroed by the caller).
template <typename XT, typename MT>
__global__ void __launch_bounds__(kQThreads)
    split_convert_kernel(const XT* __restrict__ x, MT* __restrict__ mant,
                         const unsigned int* __restrict__ amax_bits,
                         int* __restrict__ clip, Tile g, int chunks,
                         int mbits, int stochastic, uint32_t seed) {
  __shared__ int redi[32];
  const int tile = blockIdx.x / chunks;
  const int t0 = (blockIdx.x % chunks) * kChunk;
  const int t1 = min(t0 + kChunk, g.tr * g.tc);
  const float delta =
      pow2i(max_exponent(__uint_as_float(amax_bits[tile])) - mbits + 2);
  const int nclip = convert_range(x, mant, g, tile, t0, t1, delta, mbits,
                                  stochastic, seed);
  if (clip != nullptr) {
    const int total = block_sum(nclip, redi);
    if (threadIdx.x == 0 && total > 0) atomicAdd(&clip[tile], total);
  }
}

// Split tiles, pass 3: the exponent of every tile.
__global__ void split_exponent_kernel(const unsigned int* __restrict__ amax_bits,
                                      int8_t* __restrict__ expo, int n_tiles,
                                      int mbits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  const float delta =
      pow2i(max_exponent(__uint_as_float(amax_bits[t])) - mbits + 2);
  expo[t] = static_cast<int8_t>(stored_exponent(delta, mbits));
}

// Stats: exponent min and max per block of (btr x btc) tiles, one warp per
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
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    emin[w] = lo;
    emax[w] = hi;
  }
}

template <typename XT, typename MT>
void launch_convert(const void* x, void* mant, int8_t* expo, int* clip,
                    unsigned int* amax_bits, const Tile& g, int n_tiles,
                    int mbits, int stochastic, uint32_t seed,
                    cudaStream_t stream) {
  const XT* xt = static_cast<const XT*>(x);
  MT* mt = static_cast<MT*>(mant);
  const int count = g.tr * g.tc;
  if (count <= kFusedMax) {
    quantize_tile_kernel<XT, MT><<<n_tiles, kQThreads, 0, stream>>>(
        xt, mt, expo, clip, g, mbits, stochastic, seed);
    return;
  }
  const int chunks = (count + kChunk - 1) / kChunk;
  const int grid = n_tiles * chunks;
  cudaMemsetAsync(amax_bits, 0, sizeof(unsigned int) * n_tiles, stream);
  if (clip != nullptr)
    cudaMemsetAsync(clip, 0, sizeof(int) * n_tiles, stream);
  split_amax_kernel<XT><<<grid, kQThreads, 0, stream>>>(xt, amax_bits, g,
                                                        chunks);
  split_convert_kernel<XT, MT><<<grid, kQThreads, 0, stream>>>(
      xt, mt, amax_bits, clip, g, chunks, mbits, stochastic, seed);
  split_exponent_kernel<<<(n_tiles + 255) / 256, 256, 0, stream>>>(
      amax_bits, expo, n_tiles, mbits);
}

template <typename XT>
void launch_by_mantissa(int mant_16, const void* x, void* mant, int8_t* expo,
                        int* clip, unsigned int* amax_bits, const Tile& g,
                        int n_tiles, int mbits, int stochastic, uint32_t seed,
                        cudaStream_t stream) {
  if (mant_16)
    launch_convert<XT, int16_t>(x, mant, expo, clip, amax_bits, g, n_tiles,
                                mbits, stochastic, seed, stream);
  else
    launch_convert<XT, int8_t>(x, mant, expo, clip, amax_bits, g, n_tiles,
                               mbits, stochastic, seed, stream);
}

}  // namespace

// Plain C entry point. x: [R, C] f32 or bf16 (x_bf16), contiguous; mant:
// [R, C] int8, or int16 when mant_16; expo: [R/tr, C/tc] int8 on the padded
// tile grid; with stats, clip [R/tr, C/tc] int32 and emin, emax
// [Rp/block_r, Cp/block_c] int32 (block_r, block_c in elements, the
// reference's fitted blocks), else those three are null. amax_bits:
// scratch of one uint32 per tile, used when a tile exceeds one CTA. (tr,
// tc) are the reference's clipped tiles. Returns a cudaError_t code.
extern "C" int bfp_quantize(const void* x, int x_bf16, void* mant,
                            int mant_16, int8_t* expo, int* clip, int* emin,
                            int* emax, unsigned int* amax_bits, int R, int C,
                            int tr, int tc, int block_r, int block_c,
                            int mbits, int stochastic, int seed,
                            int with_stats, void* stream_ptr) {
  if (R <= 0 || C <= 0 || tr <= 0 || tc <= 0 || tr > R || tc > C ||
      static_cast<long long>(tr) * tc > 0x7fffffffLL || mbits < 2 ||
      mbits > 16 || block_r <= 0 || block_c <= 0 ||
      block_r % tr || block_c % tc || (mant_16 != 0) != (mbits > 8) ||
      (with_stats && (clip == nullptr || emin == nullptr || emax == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nTr = (R + tr - 1) / tr, nTc = (C + tc - 1) / tc;
  const int Rp = nTr * tr, Cp = nTc * tc;
  if (Rp % block_r || Cp % block_c)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile g{R, C, tr, tc, nTc, Cp};
  const int n_tiles = nTr * nTc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const uint32_t useed = static_cast<uint32_t>(seed);
  int* clip_out = with_stats ? clip : nullptr;
  if (x_bf16)
    launch_by_mantissa<__nv_bfloat16>(mant_16, x, mant, expo, clip_out,
                                      amax_bits, g, n_tiles, mbits,
                                      stochastic, useed, stream);
  else
    launch_by_mantissa<float>(mant_16, x, mant, expo, clip_out, amax_bits,
                              g, n_tiles, mbits, stochastic, useed, stream);
  if (with_stats) {
    const int btr = block_r / tr, btc = block_c / tc;
    const int nBc = Cp / block_c;
    const int n_blocks = (Rp / block_r) * nBc;
    const int threads = 256;
    const int grid = (n_blocks * 32 + threads - 1) / threads;
    block_minmax_kernel<<<grid, threads, 0, stream>>>(expo, emin, emax, nTc,
                                                      btr, btc, nBc,
                                                      n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
