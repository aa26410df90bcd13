// K4: distance-menu match candidates, top 2 per position.
//
// Replaces the Pallas kernel swift_png_tpu/ops/deflate_optimal.py
// _make_cand_kernel (launched by menu_candidates_pallas_batch), which takes
// eq rows that XLA shifted and partly doubled, and finishes the suffix runs
// by log-doubling in a chunk-per-lane tile.
//
// For image i (bytes data[i*stride, i*stride + n)), menu slot j (distance
// d, decade cost c) and position p, the run is the number of consecutive
// q >= p with q < n, q >= d and data[q] == data[q - d], capped at 258.
// The score run*64 - c (run >= 3, d > 0; else -1) keeps the best two slots
// in slot order with strict '>'; the output is dist << 9 | run, or 1 << 9.
//
// One warp per 1,024 positions, one lane per position of a 32-position
// window, windows walked backwards.  For each slot the warp ballots the
// window's equalities; a lane's run is the count of set bits from its own
// bit up, plus the run carried in from the window after it when the bits
// reach the window's end.  The carry into a warp's last window comes from
// nine windows (288 >= 258 positions) of halo ballots.  So each position
// costs one compare per slot, not a scan of up to 258 bytes.
//
// What bounds it: its bytes (data read once, 8 bytes of candidates written
// per position); the work is a few integer operations per position and
// slot.  Reads of data[q - d] go through the read-only cache.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 32;
constexpr int kWarps = 4;
constexpr int kSpan = 1024;        // positions per warp
constexpr int kHaloWindows = 9;    // 288 positions of look-ahead

// Run length at this lane from the window's ballot and the carried run of
// the next window's first position.
__device__ __forceinline__ int run_at(unsigned mask, int carry, int lane) {
  const unsigned m = mask >> lane;
  const int ones = (m == 0xFFFFFFFFu) ? 32 : __ffs(~m) - 1;
  return ones == 32 - lane ? min(ones + carry, 258) : ones;
}

__global__ void __launch_bounds__(kWarps * 32)
    cand_kernel(const uint8_t* __restrict__ data,
                const int* __restrict__ dists, const int* __restrict__ costs,
                const int* __restrict__ nvec, int* __restrict__ out,
                long long ntot, int stride, int dmax) {
  __shared__ int dist_s[kMaxSlots], cost_s[kMaxSlots];
  const long long b0 = static_cast<long long>(blockIdx.x) * kWarps * kSpan;
  const int img = static_cast<int>(b0 / stride);
  if (threadIdx.x < kMaxSlots) {
    const int j = threadIdx.x;
    dist_s[j] = j < dmax ? dists[img * dmax + j] : 0;
    cost_s[j] = j < dmax ? costs[img * dmax + j] : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint8_t* base = data + static_cast<long long>(img) * stride;
  const int n = nvec[img];
  const int c0 = static_cast<int>(b0 - static_cast<long long>(img) * stride)
                 + warp * kSpan;

  int carry[kMaxSlots];
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    int c = 0;
    const int d = dist_s[j];
    if (j < dmax && d > 0) {
      for (int w = kHaloWindows - 1; w >= 0; --w) {
        const int q = c0 + kSpan + w * 32 + lane;
        const bool e = q < n && q >= d && __ldg(base + q) == __ldg(base + q - d);
        const int r = run_at(__ballot_sync(0xFFFFFFFFu, e), c, lane);
        c = __shfl_sync(0xFFFFFFFFu, r, 0);
      }
    }
    carry[j] = c;
  }

  const long long o0 = static_cast<long long>(img) * stride;
  for (int w = kSpan / 32 - 1; w >= 0; --w) {
    const int p = c0 + w * 32 + lane;
    const int cur = p < n ? __ldg(base + p) : -1;
    int s1 = -1, s2 = -1, v1 = 1 << 9, v2 = 1 << 9;
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      const int d = dist_s[j];
      if (j < dmax && d > 0) {
        const bool e = cur >= 0 && p >= d && cur == __ldg(base + p - d);
        const int r = run_at(__ballot_sync(0xFFFFFFFFu, e), carry[j], lane);
        carry[j] = __shfl_sync(0xFFFFFFFFu, r, 0);
        const int score = r >= 3 ? r * 64 - cost_s[j] : -1;
        if (score > s1) {
          s2 = s1; v2 = v1; s1 = score; v1 = (d << 9) | r;
        } else if (score > s2) {
          s2 = score; v2 = (d << 9) | r;
        }
      }
    }
    out[o0 + p] = v1;
    out[ntot + o0 + p] = v2;
  }
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K4 on `stream`: data (B * stride) u8, dists/costs (B, dmax) i32,
// nvec (B,) i32 -> out (2, B * stride) i32.  stride % 4096 == 0, dmax <= 32.
extern "C" int spt_cand(const void* data, const void* dists, const void* costs,
                        const void* nvec, void* out, int B, int stride,
                        int dmax, void* stream) {
  if (B <= 0) return 0;
  if (stride <= 0 || stride % (kWarps * kSpan) || dmax < 0 ||
      dmax > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntot = static_cast<long long>(B) * stride;
  const long long blocks = ntot / (kWarps * kSpan);
  cand_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(dists),
      static_cast<const int*>(costs), static_cast<const int*>(nvec),
      static_cast<int*>(out), ntot, stride, dmax);
  return static_cast<int>(cudaGetLastError());
}
