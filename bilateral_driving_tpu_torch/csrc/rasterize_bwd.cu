// Tile compositing, backward: per-intersection gradients of the features.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/rasterize_pallas.py
// (rasterize_bwd -> _make_bwd_kernel). The TPU kernel turns each chunk into
// (128, 1024) blocks, a Hillis-Steele suffix scan and matrix products, and
// parks the gradients of chunks shared by two tiles in side buffers that
// the caller adds back. On Hopper one thread owns one pixel, and every entry
// belongs to exactly one tile, so a block writes only its own range: no side
// buffers and no atomics.
//
// One block of 1024 threads per 32x32 tile. The tile's live chunks (n_live,
// from the forward) are walked in reverse. Each chunk starts from the
// transmittance the forward checkpointed at its entry (ckpt, see
// csrc/rasterize_fwd.cu) and is swept forward twice per pixel:
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
// Each entry's 10 gradients are sums over the tile's 1024 pixels: a warp
// shuffle tree per warp (skipped, as exact zeros, where no pixel of the
// warp passed the alpha gate), then the 32 warp partials summed in warp
// order. The order is fixed, so the result is deterministic, as the TPU
// kernel's is. Entries of the tile past its live chunks are not written
// (the caller zeroes the output), so early-terminated and out-of-range
// entries stay exactly 0.
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

__global__ void __launch_bounds__(kPix)
rasterize_bwd_kernel(const float* __restrict__ feats, int cap,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ n_live,
                     const int* __restrict__ ckpt_off,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ gout, int ntx,
                     float* __restrict__ dfeats) {
  __shared__ float sf[kNFeat][kChunk];
  __shared__ float part[kWarps][kNFeat][kGroup];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int start = starts[t];
  const int end = start + counts[t];
  const int fc = start / kChunk;
  const int nl = n_live[t];
  const float ox = (float)((t % ntx) * kTile);
  const float oy = (float)((t / ntx) * kTile);
  const float px = (float)(p % kTile) + 0.5f;
  const float py = (float)(p / kTile) + 0.5f;
  const float* go = gout + (size_t)t * kOut * kPix + p;
  const float g0 = go[0], g1 = go[kPix], g2 = go[2 * kPix],
              g3 = go[3 * kPix], g4 = go[4 * kPix];

  float carry = 0.0f;
  for (int c = nl - 1; c >= 0; --c) {
    const int base = (fc + c) * kChunk;
    for (int i = p; i < kNFeat * kChunk; i += kPix)
      sf[i / kChunk][i % kChunk] =
          feats[(size_t)(i / kChunk) * cap + base + i % kChunk];
    __syncthreads();
    const float T0 = ckpt[((size_t)ckpt_off[t] + c) * kPix + p];
    const int j0 = max(start - base, 0);
    const int j1 = min(end - base, kChunk);

    // pass 1: the chunk's total of w G for this pixel
    float T = T0;
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

    // pass 2: per-entry gradients, reduced over the tile in groups
    T = T0;
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
            const float suffix = (float)(S - P) + carry;
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
#pragma unroll
          for (int r = 0; r < kNFeat; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[r] += __shfl_down_sync(0xffffffffu, v[r], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kNFeat; ++r) part[warp][r][j - jg] = v[r];
        }
      }
      __syncthreads();
      if (p < kNFeat * kGroup) {
        const int r = p / kGroup;
        const int jj = p % kGroup;
        if (jg + jj < jn) {
          float s = 0.0f;
          for (int wi = 0; wi < kWarps; ++wi) s += part[wi][r][jj];
          dfeats[(size_t)r * cap + base + jg + jj] = s;
        }
      }
      __syncthreads();
    }
    carry += (float)S;
    __syncthreads();   // before the next chunk overwrites sf
  }
}

}  // namespace

// feats: (rows >= 10, cap) f32 sorted; starts, counts, n_live, ckpt_off:
// (n_tiles,) i32; ckpt: (slots, 1024) f32 from the forward; gout:
// (n_tiles, 5, 1024) f32; dfeats: (10, cap) f32, zeroed by the caller.
extern "C" int rasterize_bwd_launch(const float* feats, int cap,
                                    const int* starts, const int* counts,
                                    const int* n_live, const int* ckpt_off,
                                    const float* ckpt, const float* gout,
                                    int n_tiles, int ntx, float* dfeats,
                                    void* stream) {
  if (n_tiles > 0)
    rasterize_bwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
        feats, cap, starts, counts, n_live, ckpt_off, ckpt, gout, ntx,
        dfeats);
  return (int)cudaGetLastError();
}
