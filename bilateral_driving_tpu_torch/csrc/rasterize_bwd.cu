// Tile compositing, backward: per-intersection gradients of the features.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/rasterize_pallas.py
// (rasterize_bwd -> _make_bwd_kernel). The TPU kernel turns each chunk into
// (128, 1024) blocks, a Hillis-Steele suffix scan and matrix products, and
// parks the gradients of chunks shared by two tiles in side buffers that
// the caller adds back. On Hopper one thread owns one pixel, and every entry
// belongs to exactly one (tile, chunk) pair, so a block writes only its own
// range: no side buffers and no atomics.
//
// Math, per pixel of a tile's live chunk (n_live, from the forward), from
// the transmittance the forward checkpointed at the chunk's entry (ckpt, see
// csrc/rasterize_fwd.cu), sweeping the chunk forward:
//   pass 1: S = sum_k w_k G_k over the chunk,
//   pass 2: at entry k, with P the running sum of w G up to and including k,
//           suffix = (S - P) + carry   (carry = sum of w G of later chunks),
//           d_alpha = T_k G_k - suffix / max(1 - alpha_k, 0.001),
// gated to 0 < alpha < 0.999, where G = sum_ch color[ch] g[ch] over r, g, b,
// depth and 1 (the alpha channel) and w = alpha T. Transmittance is never
// divided back out, so it cannot drift. Then d_sigma = -alpha d_alpha,
// chained through sigma = 1/2 a dx^2 + 1/2 c dy^2 + b dx dy - logop
// (dx = pixel - mean, relative to the tile origin, as the forward builds
// it), and d_color = g w.
//
// S and P in double: late in a chunk the suffix is a small difference of
// two large sums, and 1 / (1 - alpha) scales its error up to 1000 times;
// in double that difference keeps f32 precision (H100 runs f64 at half
// the f32 rate, one add per pair).
//
// Parallel over the live (tile, chunk) pairs. A block per tile walking its
// chunks in turn is as slow as the heaviest tile while most SMs idle (170
// tiles of 1 to 44 live chunks on the flagship's training step); but the
// only thing a chunk takes from the others is its carry, and every chunk's
// entry transmittance is already in ckpt. So one call runs four kernels on
// the caller's stream:
//   items: one block lists the live pairs (tile, chunk), tile by tile, and
//          zeroes the two passes' tickets;
//   sums:  pass 1 for every pair, S stored in double per (slot, pixel), slot
//          = ckpt_off[tile] + chunk as for the checkpoints;
//   carry: a block per tile adds (float)S over its live chunks, last chunk
//          first, storing each chunk's carry before adding its own S: the
//          order of the serial walk, so every carry is the same float;
//   grads: pass 2 for every pair from its own double S, carry and
//          checkpoint, writing the pair's entries.
// sums and grads are persistent grids (as many 1024-thread blocks as fit on
// the card) that take pairs from an atomic ticket.
//
// Each entry's 10 gradients are sums over the tile's 1024 pixels: a warp
// reduction (skipped, as exact zeros, where no pixel of the warp passed the
// alpha gate), then the 32 warp partials summed in warp order. The warp
// reduction adds the same pairs of addends as a shuffle-down tree per row
// (what lane 0 holds after v += shfl_down(v, 16), 8, 4, 2, 1), but lanes
// split the rows at each level and swap the halves they give away: 12
// shuffles per entry instead of 50. a + b and b + a round alike, so the
// result is the tree's to the bit. The order is fixed, so the result is
// deterministic, as the TPU kernel's is. Entries of a tile past its live
// chunks are not written (the caller zeroes the output), so
// early-terminated and out-of-range entries stay exactly 0.
//
// Built with --fmad=false so that alpha rounds exactly as in the forward
// kernel and the gate decides the same entries.
//
// Bound: operations. Per live (entry, pixel) pair two sweeps of the
// forward's sigma and exp, plus ~40 f32 operations for the gradient, while
// the features are 40 bytes per entry read once per chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kChunk = 128;
constexpr int kNFeat = 10;   // x y a b c logop r g b depth
constexpr int kOut = 5;      // r g b depth alpha
constexpr int kGroup = 32;   // entries whose warp partials are held at once
// work buffer: [0] live pairs, [1] [2] the passes' tickets, [3] unused,
// then pair i as (tile, chunk) at int2 index 2 + i
constexpr int kWorkHead = 4;

__global__ void __launch_bounds__(kPix)
bwd_items_kernel(const int* __restrict__ n_live, int n_tiles,
                 int* __restrict__ work) {
  __shared__ int warp_total[kWarps];
  __shared__ int base;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  int2* items = reinterpret_cast<int2*>(work + kWorkHead);
  if (p == 0) base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += kPix) {
    const int t = t0 + p;
    const int nl = t < n_tiles ? n_live[t] : 0;
    int incl = nl;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int first = base + incl - nl;
    for (int w = 0; w < warp; ++w) first += warp_total[w];
    for (int c = 0; c < nl; ++c) items[first + c] = make_int2(t, c);
    __syncthreads();   // every thread has read base and warp_total
    if (p == kPix - 1) base = first + nl;
    __syncthreads();
  }
  if (p == 0) {
    work[0] = base;
    work[1] = 0;
    work[2] = 0;
  }
}

// The next pair from a ticket, the same for the whole block; also the
// barrier before the block overwrites what the previous pair staged.
__device__ __forceinline__ int next_item(int* ticket, int* s_item) {
  __syncthreads();
  if (threadIdx.x == 0) *s_item = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_item;
}

// One live pair's place: its tile's range, first entry of the chunk, slot.
struct Pair {
  int t, c, start, end, base, slot;
};

__device__ __forceinline__ Pair pair_of(int2 it, const int* starts,
                                        const int* counts,
                                        const int* ckpt_off) {
  Pair q;
  q.t = it.x;
  q.c = it.y;
  q.start = starts[q.t];
  q.end = q.start + counts[q.t];
  q.base = (q.start / kChunk + q.c) * kChunk;
  q.slot = ckpt_off[q.t] + q.c;
  return q;
}

__device__ __forceinline__ void stage(float (&sf)[kNFeat][kChunk],
                                      const float* feats, int cap, int base) {
  for (int i = threadIdx.x; i < kNFeat * kChunk; i += kPix)
    sf[i / kChunk][i % kChunk] =
        feats[(size_t)(i / kChunk) * cap + base + i % kChunk];
}

// Sums v[0..9] over the warp as the shuffle-down tree does (see the note at
// the top), with 12 shuffles. Returns the row whose total this lane holds
// (rows 0-4 in lanes 0, 2, 4, 8, 12; rows 5-9 16 lanes on), or -1.
__device__ __forceinline__ int warp_sum10(const float (&v)[kNFeat], int lane,
                                          float* total) {
  const unsigned m = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  // lanes l and l ^ 16: rows 0-4 stay in the low lane, 5-9 in the high one
  float w[5];
#pragma unroll
  for (int r = 0; r < 5; ++r)
    w[r] = (b4 ? v[5 + r] : v[r])
           + __shfl_xor_sync(m, b4 ? v[r] : v[5 + r], 16);
  // l ^ 8: w[0..2] stay low, w[3..4] high
  float x[3];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    x[r] = (b3 ? w[3 + r] : w[r])
           + __shfl_xor_sync(m, b3 ? w[r] : w[3 + r], 8);
  x[2] = w[2] + __shfl_xor_sync(m, w[2], 8);
  // l ^ 4: of three rows x0, x1 stay low and x2 goes high; of two, x0 low
  // and x1 high
  const float y0 = (b2 ? (b3 ? x[1] : x[2]) : x[0])
                   + __shfl_xor_sync(m, b2 ? x[0] : (b3 ? x[1] : x[2]), 4);
  const float y1 = x[1] + __shfl_xor_sync(m, x[1], 4);
  // l ^ 2: of two rows y0 stays low and y1 goes high; one row stays low
  const float z = (b1 ? y1 : y0) + __shfl_xor_sync(m, b1 ? y0 : y1, 2);
  // l ^ 1
  *total = z + __shfl_xor_sync(m, z, 1);
  if (lane & 1) return -1;
  const int half = b4 ? 5 : 0;
  if (!b3) {
    if (!b2) return half + (b1 ? 1 : 0);
    return b1 ? -1 : half + 2;
  }
  return b1 ? -1 : half + 3 + (b2 ? 1 : 0);
}

__global__ void __launch_bounds__(kPix)
bwd_sums_kernel(const float* __restrict__ feats, int cap,
                const int* __restrict__ starts,
                const int* __restrict__ counts,
                const int* __restrict__ ckpt_off,
                const float* __restrict__ ckpt,
                const float* __restrict__ gout, int ntx,
                int* __restrict__ work, double* __restrict__ sums) {
  __shared__ float sf[kNFeat][kChunk];
  __shared__ int s_item;
  const int p = threadIdx.x;
  const float px = (float)(p % kTile) + 0.5f;
  const float py = (float)(p / kTile) + 0.5f;
  const int total = work[0];
  const int2* items = reinterpret_cast<const int2*>(work + kWorkHead);
  for (;;) {
    const int i = next_item(work + 1, &s_item);
    if (i >= total) break;
    const Pair q = pair_of(items[i], starts, counts, ckpt_off);
    stage(sf, feats, cap, q.base);
    __syncthreads();
    const float ox = (float)((q.t % ntx) * kTile);
    const float oy = (float)((q.t / ntx) * kTile);
    const float* go = gout + (size_t)q.t * kOut * kPix + p;
    const float g0 = go[0], g1 = go[kPix], g2 = go[2 * kPix],
                g3 = go[3 * kPix], g4 = go[4 * kPix];
    const int j0 = max(q.start - q.base, 0);
    const int j1 = min(q.end - q.base, kChunk);
    float T = ckpt[(size_t)q.slot * kPix + p];
    double S = 0.0;
    for (int j = j0; j < j1; ++j) {
      const float dx = px - (sf[0][j] - ox);
      const float dy = py - (sf[1][j] - oy);
      const float sigma = 0.5f * sf[2][j] * dx * dx
                          + 0.5f * sf[4][j] * dy * dy
                          + sf[3][j] * dx * dy - sf[5][j];
      const float e = expf(-sigma);
      const float alpha = e > 0.999f ? 0.999f : e;
      if (!(alpha >= 1.0f / 255.0f)) continue;
      const float G = sf[6][j] * g0 + sf[7][j] * g1 + sf[8][j] * g2
                      + sf[9][j] * g3 + g4;
      S += (double)(alpha * T * G);
      T *= 1.0f - alpha;
    }
    sums[(size_t)q.slot * kPix + p] = S;
  }
}

__global__ void __launch_bounds__(kPix)
bwd_carry_kernel(const int* __restrict__ n_live,
                 const int* __restrict__ ckpt_off,
                 const double* __restrict__ sums,
                 float* __restrict__ carry) {
  const int nl = n_live[blockIdx.x];
  const size_t first = (size_t)ckpt_off[blockIdx.x] * kPix + threadIdx.x;
  float cr = 0.0f;
#pragma unroll 8
  for (int c = nl - 1; c >= 0; --c) {
    const size_t k = first + (size_t)c * kPix;
    carry[k] = cr;
    cr += (float)sums[k];
  }
}

__global__ void __launch_bounds__(kPix)
bwd_grads_kernel(const float* __restrict__ feats, int cap,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts,
                 const int* __restrict__ ckpt_off,
                 const float* __restrict__ ckpt,
                 const float* __restrict__ gout, int ntx,
                 int* __restrict__ work, const double* __restrict__ sums,
                 const float* __restrict__ carry,
                 float* __restrict__ dfeats) {
  __shared__ float sf[kNFeat][kChunk];
  __shared__ float part[kWarps][kNFeat][kGroup];
  __shared__ int s_item;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = (float)(p % kTile) + 0.5f;
  const float py = (float)(p / kTile) + 0.5f;
  const int total = work[0];
  const int2* items = reinterpret_cast<const int2*>(work + kWorkHead);
  for (;;) {
    const int i = next_item(work + 2, &s_item);
    if (i >= total) break;
    const Pair q = pair_of(items[i], starts, counts, ckpt_off);
    stage(sf, feats, cap, q.base);
    __syncthreads();
    const float ox = (float)((q.t % ntx) * kTile);
    const float oy = (float)((q.t / ntx) * kTile);
    const float* go = gout + (size_t)q.t * kOut * kPix + p;
    const float g0 = go[0], g1 = go[kPix], g2 = go[2 * kPix],
                g3 = go[3 * kPix], g4 = go[4 * kPix];
    const int j0 = max(q.start - q.base, 0);
    const int j1 = min(q.end - q.base, kChunk);
    const size_t k = (size_t)q.slot * kPix + p;
    const double S = sums[k];
    const float cr = carry[k];
    float T = ckpt[k];
    double P = 0.0;
    for (int jg = j0; jg < j1; jg += kGroup) {
      const int jn = min(jg + kGroup, j1);
      for (int j = jg; j < jn; ++j) {
        const float a = sf[2][j], b = sf[3][j], cq = sf[4][j];
        const float dx = px - (sf[0][j] - ox);
        const float dy = py - (sf[1][j] - oy);
        const float sigma = 0.5f * a * dx * dx + 0.5f * cq * dy * dy
                            + b * dx * dy - sf[5][j];
        const float e = expf(-sigma);
        const float alpha = e > 0.999f ? 0.999f : e;
        const bool hit = alpha >= 1.0f / 255.0f;
        float v[kNFeat];
#pragma unroll
        for (int r = 0; r < kNFeat; ++r) v[r] = 0.0f;
        if (hit) {
          const float G = sf[6][j] * g0 + sf[7][j] * g1 + sf[8][j] * g2
                          + sf[9][j] * g3 + g4;
          const float w = alpha * T;
          P += (double)(w * G);
          if (alpha < 0.999f) {
            const float suffix = (float)(S - P) + cr;
            const float one_m = fmaxf(1.0f - alpha, 1.0f - 0.999f);
            const float d_alpha = T * G - suffix / one_m;
            const float ds = -(alpha * d_alpha);
            v[0] = -(ds * (a * dx + b * dy));
            v[1] = -(ds * (cq * dy + b * dx));
            v[2] = ds * (0.5f * dx * dx);
            v[3] = ds * (dx * dy);
            v[4] = ds * (0.5f * dy * dy);
            v[5] = -ds;
          }
          v[6] = g0 * w;
          v[7] = g1 * w;
          v[8] = g2 * w;
          v[9] = g3 * w;
          T *= 1.0f - alpha;
        }
        if (__any_sync(0xffffffffu, hit)) {
          float sum;
          const int row = warp_sum10(v, lane, &sum);
          if (row >= 0) part[warp][row][j - jg] = sum;
        } else if (lane < kNFeat) {
          part[warp][lane][j - jg] = 0.0f;   // no pixel of the warp passed
        }
      }
      __syncthreads();
      if (p < kNFeat * kGroup) {
        const int r = p / kGroup;
        const int jj = p % kGroup;
        if (jg + jj < jn) {
          float s = 0.0f;
          for (int wi = 0; wi < kWarps; ++wi) s += part[wi][r][jj];
          dfeats[(size_t)r * cap + q.base + jg + jj] = s;
        }
      }
      __syncthreads();
    }
  }
}

// Persistent grid of one kernel: as many blocks as fit on every SM of the
// current device, found once per kernel and device.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int* cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return 132;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPix, 0);
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

int sums_blocks[16];
int grads_blocks[16];

}  // namespace

// feats: (rows >= 10, cap) f32 sorted; starts, counts, n_live, ckpt_off:
// (n_tiles,) i32; ckpt: (slots, 1024) f32 from the forward; gout:
// (n_tiles, 5, 1024) f32; dfeats: (10, cap) f32, zeroed by the caller.
// Scratch, uninitialised: work (4 + 2 slots) i32, sums (slots, 1024) f64,
// carry (slots, 1024) f32.
extern "C" int rasterize_bwd_launch(const float* feats, int cap,
                                    const int* starts, const int* counts,
                                    const int* n_live, const int* ckpt_off,
                                    const float* ckpt, const float* gout,
                                    int n_tiles, int ntx, int* work,
                                    double* sums, float* carry,
                                    float* dfeats, void* stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  bwd_items_kernel<<<1, kPix, 0, s>>>(n_live, n_tiles, work);
  bwd_sums_kernel<<<persistent_blocks(bwd_sums_kernel, sums_blocks), kPix,
                    0, s>>>(feats, cap, starts, counts, ckpt_off, ckpt, gout,
                            ntx, work, sums);
  bwd_carry_kernel<<<n_tiles, kPix, 0, s>>>(n_live, ckpt_off, sums, carry);
  bwd_grads_kernel<<<persistent_blocks(bwd_grads_kernel, grads_blocks), kPix,
                     0, s>>>(feats, cap, starts, counts, ckpt_off, ckpt, gout,
                             ntx, work, sums, carry, dfeats);
  return (int)cudaGetLastError();
}
