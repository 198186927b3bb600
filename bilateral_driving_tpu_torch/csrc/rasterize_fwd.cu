// Front-to-back tile compositing, forward only.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/rasterize_pallas.py
// (rasterize_fwd -> _make_fwd_kernel). The TPU kernel turns each 128-entry
// chunk into matrix products and a prefix-product scan over (128, 1024)
// blocks; on Hopper one thread owns one pixel and walks the chunk in order.
//
// One block of 1024 threads per 32x32 tile. The tile's sorted range
// [start, start + count) is read in the same global 128-aligned chunks the
// TPU kernel reads, starting at chunk start / 128; each chunk's 10 feature
// rows are staged in shared memory, and entries outside the range are
// skipped (alpha 0 in the TPU kernel). Per entry and pixel:
//   sigma = 1/2 a dx^2 + 1/2 c dy^2 + b dx dy - logop,
//   dx, dy = pixel centre - mean, both relative to the tile origin;
//   alpha = min(exp(-sigma), 0.999), dropped below 1/255.
// After each chunk the whole tile stops once no pixel's transmittance is
// above 1e-4 (__syncthreads_or), the TPU kernel's per-tile early stop at the
// same chunk boundaries. Outputs r, g, b, the depth numerator and
// alpha = 1 - T_final. The transmittance checkpoints the TPU kernel writes
// for its backward are not written: the training slice adds its own.
//
// Built with --fmad=false so that sigma and alpha round exactly as the
// plain PyTorch version's separate elementwise operations do.
//
// Bound: operations. Every live entry costs ~26 f32 operations and one exp
// per pixel, while its features are 40 bytes read once per tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kChunk = 128;
constexpr int kNFeat = 10;   // x y a b c logop r g b depth
constexpr int kOut = 5;      // r g b depth alpha

__global__ void __launch_bounds__(kPix)
rasterize_fwd_kernel(const float* __restrict__ feats, int cap,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx,
                     float* __restrict__ out) {
  __shared__ float sf[kNFeat][kChunk];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = starts[t];
  const int end = start + counts[t];
  const int fc = start / kChunk;
  const int nch = counts[t] > 0 ? (end + kChunk - 1) / kChunk - fc : 0;
  const float ox = (float)((t % ntx) * kTile);
  const float oy = (float)((t / ntx) * kTile);
  const float px = (float)(p % kTile) + 0.5f;
  const float py = (float)(p / kTile) + 0.5f;

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const int base = (fc + c) * kChunk;
    for (int i = p; i < kNFeat * kChunk; i += kPix)
      sf[i / kChunk][i % kChunk] =
          feats[(size_t)(i / kChunk) * cap + base + i % kChunk];
    __syncthreads();
    const int j0 = max(start - base, 0);
    const int j1 = min(end - base, kChunk);
    for (int j = j0; j < j1; ++j) {
      const float mx = sf[0][j] - ox;
      const float my = sf[1][j] - oy;
      const float dx = px - mx;
      const float dy = py - my;
      const float sigma = 0.5f * sf[2][j] * dx * dx
                          + 0.5f * sf[4][j] * dy * dy
                          + sf[3][j] * dx * dy - sf[5][j];
      const float e = expf(-sigma);
      const float alpha = e > 0.999f ? 0.999f : e;   // NaN stays NaN
      if (!(alpha >= 1.0f / 255.0f)) continue;        // and is dropped here
      const float w = alpha * T;
      cr += w * sf[6][j];
      cg += w * sf[7][j];
      cb += w * sf[8][j];
      cd += w * sf[9][j];
      T *= 1.0f - alpha;
    }
    // also the barrier before the next chunk overwrites sf
    if (!__syncthreads_or(T > 1e-4f)) break;
  }
  float* o = out + (size_t)t * kOut * kPix + p;
  o[0 * kPix] = cr;
  o[1 * kPix] = cg;
  o[2 * kPix] = cb;
  o[3 * kPix] = cd;
  o[4 * kPix] = 1.0f - T;
}

}  // namespace

// feats: (rows >= 10, cap) f32, rows 0..9 used; starts, counts: (n_tiles,)
// i32; out: (n_tiles, 5, 1024) f32.
extern "C" int rasterize_fwd_launch(const float* feats, int cap,
                                    const int* starts, const int* counts,
                                    int n_tiles, int ntx, float* out,
                                    void* stream) {
  if (n_tiles > 0)
    rasterize_fwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
        feats, cap, starts, counts, ntx, out);
  return (int)cudaGetLastError();
}
