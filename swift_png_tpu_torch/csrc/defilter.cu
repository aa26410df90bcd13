// K3: PNG scanline defilter as an anti-diagonal wavefront.
//
// Replaces the Pallas kernel swift_png_tpu/ops/unfilter_pallas.py (_kernel,
// launched by defilter_pallas), whose function the JAX production path
// serves with the XLA scan ops/unfilter.py::defilter_batch.
//
// Byte (y, i) depends on (y, i - delay), (y - 1, i) and (y - 1, i - delay),
// so pixel groups g = i / delay on one anti-diagonal d = y + g are
// independent.  One block per image, one thread per row: at step d, thread
// y defilters its pixel group g = d - y.  A thread keeps its own left pixel
// and the up-left pixel in registers; the pixel above comes from the
// neighbouring thread through a double-buffered shared slot, written one
// step earlier.  Images taller than the block run in row chunks; the first
// row of a chunk reads the row above from device memory, which the previous
// chunk finished.  Filter types 5..255 predict 0.
//
// What bounds it: H + G - 1 block-wide barriers per image and the serial
// dependency along the diagonal, not the 2 bytes per pixel byte it moves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int predict(int ft, int a, int b, int c) {
  switch (ft) {
    case 1: return a;
    case 2: return b;
    case 3: return (a + b) >> 1;
    case 4: {
      const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
      return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
    }
    default: return 0;
  }
}

// the launch bound caps registers so a 1024-thread block fits one SM
__global__ void __launch_bounds__(kMaxThreads)
    defilter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int pitch, int delay) {
  __shared__ uint8_t up[2][kMaxThreads][8];
  const uint8_t* src = in + static_cast<size_t>(blockIdx.x) * H * (pitch + 1);
  uint8_t* dst = out + static_cast<size_t>(blockIdx.x) * H * pitch;
  const int G = pitch / delay;
  const int t = threadIdx.x;
  for (int y0 = 0; y0 < H; y0 += blockDim.x) {
    const int y = y0 + t;
    const int rows = min(static_cast<int>(blockDim.x), H - y0);
    const bool live = t < rows;
    const int ft = live ? src[static_cast<size_t>(y) * (pitch + 1)] : 0;
    const uint8_t* x = src + static_cast<size_t>(y) * (pitch + 1) + 1;
    uint8_t* o = dst + static_cast<size_t>(y) * pitch;
    int a[8], c[8];
    for (int k = 0; k < 8; ++k) a[k] = c[k] = 0;
    for (int d = 0; d < rows + G - 1; ++d) {
      const int g = d - t;
      if (live && g >= 0 && g < G) {
        const int cur = d & 1;
        for (int k = 0; k < delay; ++k) {
          int b = 0;
          if (t > 0)
            b = up[cur ^ 1][t - 1][k];
          else if (y > 0)
            b = o[static_cast<ptrdiff_t>(g * delay + k) - pitch];
          const int v = (x[g * delay + k] + predict(ft, a[k], b, c[k])) & 255;
          o[g * delay + k] = static_cast<uint8_t>(v);
          up[cur][t][k] = static_cast<uint8_t>(v);
          a[k] = v;
          c[k] = b;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K3 on `stream`: in (B, H, 1 + pitch) u8 -> out (B, H, pitch) u8,
// delay in 1..8, pitch % delay == 0.
extern "C" int spt_defilter(const void* in, void* out, int B, int H,
                            int pitch, int delay, void* stream) {
  if (B <= 0 || H <= 0 || pitch <= 0) return 0;
  if (delay < 1 || delay > 8 || pitch % delay)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  defilter_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, pitch,
      delay);
  return static_cast<int>(cudaGetLastError());
}
