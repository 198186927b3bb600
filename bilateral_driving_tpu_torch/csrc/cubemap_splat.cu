// Bilinear cube-map backward: pixel cotangents splatted into the texture
// gradient.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/cubemap.py (splat_grad
// -> _splat_kernel). A TPU has no scatter-add worth the name, so that kernel
// gathers each 32x32 image tile's pixels into a dense texture window as two
// one-hot matrix products and read-modify-writes the window, and falls back
// to an XLA scatter when a tile's texels do not fit the window. Hopper adds
// to global memory atomically, so there is no window and no fallback.
//
// The gradient is written in the texture parameter's own layout,
// (6, R, R, 3) contiguous, so the caller hands it to the optimizer as it is.
// Bound: bytes. The function returns the dense gradient, so its 6 R^2 x 12
// bytes are written whatever the pixels touch, and each pixel's 32 input
// bytes are read once. The zero fill is that write and takes most of the
// time; the adds (a few per pixel) mostly hit lines it left in L2.
//
// One launch does all the work, in blocks of two roles taken from a ticket
// (an atomic counter, so every block's role is known only once it runs):
//   fill:  the first tickets zero the gradient with 16-byte stores, then
//          count themselves done;
//   splat: the later tickets take 512 pixels each, read them while the fill
//          runs, wait until every fill block is done, then add. A pixel's
//          two u-neighbouring corners are 6 contiguous floats on each of its
//          2 texel rows; each run of 6 is added with Hopper's vector atomics
//          (float4 and float2 where the address is aligned, scalar at the
//          ends): 2 to 4 adds per row in place of 6. A pixel with face -1
//          (padding) or with all three cotangents exactly 0 adds nothing.
// A splat block waits only on fill blocks that took their tickets before it
// and so are running already: no deadlock whatever the card runs beside it.
// A wait that outlasts about a second traps rather than hangs the card. The
// last splat block past its wait clears the counters for the next launch on
// the stream, so the caller zeroes them only once, when it allocates them.
// One launch instead of a fill kernel and a splat kernel saves a launch's
// host time, which bounds the call when the host is slow, at a few
// microseconds of device time (the ticket and the fill's fences); reading
// the pixels during the fill hides their latency.
//
// Float atomics add in an order that changes from run to run, so texels fed
// by several pixels differ from the plain version by rounding only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFillUnroll = 16;                 // float4 stores per thread
constexpr int kPixPerThread = 2;
constexpr long long kMaxWait = 1ll << 31;       // clock cycles, about 1 s
// counter words: the ticket and the splat blocks done share a line; the
// fill blocks done, which the splat blocks poll, has its own
constexpr int kTicket = 0, kSplatDone = 1, kFillDone = 32;

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// d[0..5] += a[0..5], d 4-byte aligned; the widest aligned vector adds
__device__ __forceinline__ void add6(float* d, const float (&a)[6]) {
  switch ((reinterpret_cast<uintptr_t>(d) >> 2) & 3) {
    case 0:
      atomicAdd(reinterpret_cast<float4*>(d),
                make_float4(a[0], a[1], a[2], a[3]));
      atomicAdd(reinterpret_cast<float2*>(d + 4), make_float2(a[4], a[5]));
      break;
    case 1:
      atomicAdd(d, a[0]);
      atomicAdd(reinterpret_cast<float2*>(d + 1), make_float2(a[1], a[2]));
      atomicAdd(reinterpret_cast<float2*>(d + 3), make_float2(a[3], a[4]));
      atomicAdd(d + 5, a[5]);
      break;
    case 2:
      atomicAdd(reinterpret_cast<float2*>(d), make_float2(a[0], a[1]));
      atomicAdd(reinterpret_cast<float4*>(d + 2),
                make_float4(a[2], a[3], a[4], a[5]));
      break;
    default:
      atomicAdd(d, a[0]);
      atomicAdd(reinterpret_cast<float4*>(d + 1),
                make_float4(a[1], a[2], a[3], a[4]));
      atomicAdd(d + 5, a[5]);
      break;
  }
}

// One pixel's 6 adds on each of its two texel rows.
struct PixelAdds {
  bool on;
  size_t cell;
  float top[6], bot[6];
};

__device__ __forceinline__ PixelAdds pixel_adds(
    int i, const int* face, const int* u0, const int* v0, const float* fu,
    const float* fv, const float* g, int npix, int res) {
  PixelAdds a;
  a.on = false;
  a.cell = 0;
  if (i >= npix || face[i] < 0) return a;
  const float g0 = g[(size_t)i * 3];
  const float g1 = g[(size_t)i * 3 + 1];
  const float g2 = g[(size_t)i * 3 + 2];
  a.on = g0 != 0.0f || g1 != 0.0f || g2 != 0.0f;
  const float wu = fu[i];
  const float wv = fv[i];
  // the plain version's products, (g (1 - wv)) (1 - wu) and so on
  a.top[0] = g0 * (1.0f - wv) * (1.0f - wu);
  a.top[1] = g1 * (1.0f - wv) * (1.0f - wu);
  a.top[2] = g2 * (1.0f - wv) * (1.0f - wu);
  a.top[3] = g0 * (1.0f - wv) * wu;
  a.top[4] = g1 * (1.0f - wv) * wu;
  a.top[5] = g2 * (1.0f - wv) * wu;
  a.bot[0] = g0 * wv * (1.0f - wu);
  a.bot[1] = g1 * wv * (1.0f - wu);
  a.bot[2] = g2 * wv * (1.0f - wu);
  a.bot[3] = g0 * wv * wu;
  a.bot[4] = g1 * wv * wu;
  a.bot[5] = g2 * wv * wu;
  a.cell = ((size_t)face[i] * res + v0[i]) * res + u0[i];
  return a;
}

__global__ void __launch_bounds__(kThreads)
splat_grad_kernel(const int* __restrict__ face, const int* __restrict__ u0,
                  const int* __restrict__ v0, const float* __restrict__ fu,
                  const float* __restrict__ fv, const float* __restrict__ g,
                  int npix, int res, float* __restrict__ dz,
                  unsigned fill_blocks, unsigned* __restrict__ words) {
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(&words[kTicket], 1u);
  __syncthreads();
  const unsigned ticket = s_ticket;
  const unsigned splat_blocks = gridDim.x - fill_blocks;
  if (ticket < fill_blocks) {
    const size_t n = (size_t)6 * res * res * 3;
    const size_t n4 = n / 4;
    float4* out = reinterpret_cast<float4*>(dz);
    const size_t first = (size_t)ticket * kThreads * kFillUnroll + tid;
#pragma unroll
    for (int k = 0; k < kFillUnroll; ++k) {
      const size_t i = first + (size_t)k * kThreads;
      if (i < n4) out[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (ticket == 0 && tid < (int)(n - n4 * 4)) dz[n4 * 4 + tid] = 0.0f;
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      const unsigned done = atomicAdd(&words[kFillDone], 1u);
      // with no splat block, the last fill block clears the counters
      if (splat_blocks == 0 && done == fill_blocks - 1) {
        words[kTicket] = 0u;
        words[kFillDone] = 0u;
      }
    }
    return;
  }
  PixelAdds px[kPixPerThread];
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q)
    px[q] = pixel_adds(
        ((int)(ticket - fill_blocks) * kPixPerThread + q) * kThreads + tid,
        face, u0, v0, fu, fv, g, npix, res);
  if (tid == 0) {
    const long long t0 = clock64();
    while (load_acquire(&words[kFillDone]) < fill_blocks) {
      if (clock64() - t0 > kMaxWait) __trap();
      __nanosleep(1000);
    }
    // the last splat block past its wait clears the counters: every block
    // has its ticket and every fill block is counted
    if (atomicAdd(&words[kSplatDone], 1u) == splat_blocks - 1) {
      words[kTicket] = 0u;
      words[kSplatDone] = 0u;
      words[kFillDone] = 0u;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q) {
    if (px[q].on) {
      add6(dz + px[q].cell * 3, px[q].top);
      add6(dz + (px[q].cell + res) * 3, px[q].bot);
    }
  }
}

}  // namespace

// face, u0, v0: (npix,) i32; fu, fv: (npix,) f32; g: (npix, 3) f32;
// dz: (6, res, res, 3) f32, 16-byte aligned, filled here; words: 33 u32
// counters, zero when the stream's first launch starts (each launch leaves
// them zero), used by one stream only.
extern "C" int splat_grad_launch(const int* face, const int* u0,
                                 const int* v0, const float* fu,
                                 const float* fv, const float* g, int npix,
                                 int res, float* dz, unsigned* words,
                                 void* stream) {
  const size_t n4 = (size_t)6 * res * res * 3 / 4;
  const size_t per_fill = (size_t)kThreads * kFillUnroll;
  const size_t per_splat = (size_t)kThreads * kPixPerThread;
  const unsigned fill_blocks =
      n4 > 0 ? (unsigned)((n4 + per_fill - 1) / per_fill) : 1u;
  const unsigned splat_blocks =
      npix > 0 ? (unsigned)((npix + per_splat - 1) / per_splat) : 0u;
  splat_grad_kernel<<<fill_blocks + splat_blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(face, u0, v0, fu, fv, g, npix,
                                              res, dz, fill_blocks, words);
  return (int)cudaGetLastError();
}
