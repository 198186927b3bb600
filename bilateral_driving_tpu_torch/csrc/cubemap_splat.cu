// Bilinear cube-map backward: pixel cotangents splatted into the texture
// gradient.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/cubemap.py (splat_grad
// -> _splat_kernel). A TPU has no scatter-add worth the name, so that kernel
// gathers each 32x32 image tile's pixels into a dense texture window as two
// one-hot matrix products and read-modify-writes the window, and falls back
// to an XLA scatter when a tile's texels do not fit the window. Hopper adds
// to global memory atomically: one thread per pixel adds its 4 corners x 3
// channels with atomicAdd into the zeroed (6 * 3, R, R) gradient. There is
// no window, so there is no fallback. Pixels with face -1 (padding) add
// nothing.
//
// Float atomics add in an order that changes from run to run, so texels fed
// by several pixels differ from the plain version by rounding only.
//
// Bound: bytes. Each pixel's 32 input bytes are read once and each touched
// texel's 3 channels written; the adds are 12 per pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void splat_kernel(const int* __restrict__ face,
                             const int* __restrict__ u0,
                             const int* __restrict__ v0,
                             const float* __restrict__ fu,
                             const float* __restrict__ fv,
                             const float* __restrict__ g, int npix, int res,
                             float* __restrict__ dz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const int f = face[i];
  if (f < 0) return;
  const int u = u0[i];
  const int v = v0[i];
  const float wu = fu[i];
  const float wv = fv[i];
  const size_t plane = (size_t)res * res;
  const size_t cell = (size_t)v * res + u;
  for (int ch = 0; ch < 3; ++ch) {
    const float gc = g[(size_t)i * 3 + ch];
    float* d = dz + (size_t)(f * 3 + ch) * plane + cell;
    atomicAdd(d, gc * (1.0f - wv) * (1.0f - wu));
    atomicAdd(d + 1, gc * (1.0f - wv) * wu);
    atomicAdd(d + res, gc * wv * (1.0f - wu));
    atomicAdd(d + res + 1, gc * wv * wu);
  }
}

}  // namespace

// face, u0, v0: (npix,) i32; fu, fv: (npix,) f32; g: (npix, 3) f32;
// dz: (18, res, res) f32, zeroed by the caller.
extern "C" int splat_grad_launch(const int* face, const int* u0,
                                 const int* v0, const float* fu,
                                 const float* fv, const float* g, int npix,
                                 int res, float* dz, void* stream) {
  if (npix > 0) {
    const int threads = 256;
    splat_kernel<<<(npix + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(face, u0, v0, fu, fv, g, npix,
                                           res, dz);
  }
  return (int)cudaGetLastError();
}
