// K3: PNG scanline defilter as an anti-diagonal wavefront.
//
// Replaces the Pallas kernel swift_png_tpu/ops/unfilter_pallas.py (_kernel,
// launched by defilter_pallas), whose function the JAX production path
// serves with the XLA scan ops/unfilter.py::defilter_batch.
//
// Byte (y, i) depends on (y, i - delay), (y - 1, i) and (y - 1, i - delay),
// so pixel groups g = i / delay on one anti-diagonal d = y + g are
// independent.  One block per image, one thread per row: at step d, thread
// y defilters its pixel group g = d - y, then the block meets at one
// barrier.  A thread keeps its left and up-left pixels in registers (a
// pixel of delay 4 is one 32-bit word); the pixel above is the neighbouring
// lane's left pixel, taken with __shfl_up_sync, and only lane 31 of one
// warp hands it to lane 0 of the next through a double-buffered shared
// slot.  Images taller than the block run in row chunks; the first row of
// a chunk takes the row above from device memory, which the previous chunk
// finished.  Filter types 5..255 predict 0.
//
// How bytes move.  The steps run in phases of K steps, S = K * delay bytes
// of a row per phase (8 steps and 32 bytes at delay 4).  The Pallas kernel
// skews its input so that every row reads the same column at one step;
// here the block stages the skewed window instead.  While phase q runs,
// cp.async copies the input of phase q+1 of every row that has work in it
// into shared memory as the aligned 16-byte chunks that hold its bytes,
// consecutive lanes on consecutive chunks, and the chunks that phase q-1
// finished leave each row's 128-byte output ring as 16-byte stores the same
// way.  The diagonal loop touches shared memory only.  No alignment is
// assumed: a row's bytes sit in its chunks and its ring at their device
// address modulo 16, so every device access is an aligned 16-byte chunk.  A
// load reads whole chunks that hold at least one byte of the row (an
// aligned chunk cannot cross a page, so this never faults; the other bytes
// are discarded).  Only a chunk that straddles two rows is written byte by
// byte, once per row end; rings are turned by 16 * (row % 8) bytes against
// bank conflicts.
//
// What bounds it.  Before, every warp issued 2 * delay one-byte device
// accesses per step, each lane on another row: 8 * 32 = 256 L1 line
// requests per warp per step at delay 4, about 4,100 per SM per step for a
// 512-row image, which at about one line per cycle was most of the ~5,700
// cycles a step took.  Now a row that has work in a phase moves 3 chunks
// in and 2 out per 8 steps, at most 2 + 2 lines: at most 512 * 4 / 8 = 256
// line requests per SM per step, about 85 on average over the wavefront
// (256 busy rows, each chunk run within one or two lines).  What is left
// is issue on the 32 SMs that hold a block, 16 warps each: the predictor
// arithmetic (about 25 instructions per byte, branch-free because the rows
// of a warp mix filter types), the shuffle and the shared-memory bytes of
// each step, the staging loops, and one block barrier per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunks = 3;      // 16-byte chunks that hold a phase's input
constexpr int kRing = 128;      // bytes of a row's output ring

// Phase geometry for a delay: K steps (even, so a step's slot parity is
// known at compile time) of S bytes a row.  S + 15 <= 16 * kChunks, so
// kChunks aligned chunks hold a phase's input at any alignment, and
// 2 * S + 15 <= kRing, so the ring holds a phase being written beside the
// two that are being flushed.  W4 aligned words hold S bytes.
template <int D>
struct Geo {
  static constexpr int K = D == 1 ? 32 : D == 2 ? 16 : D == 3 ? 8
                           : D == 4 ? 8 : 4;
  static constexpr int S = K * D;
  static constexpr int W4 = (S + 6) / 4;
  static constexpr int NW = (D + 3) / 4;     // words of one pixel
  static_assert(S + 15 <= 16 * kChunks && 2 * S + 15 <= kRing, "phase");
};

template <int D>
constexpr size_t smem_bytes(int threads) {
  return static_cast<size_t>(threads) * (2 * 16 * kChunks + kRing)
         + (2 * Geo<D>::W4 + 2 * 32 * Geo<D>::NW) * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int byte_of(const uint32_t* w, int k) {
  return static_cast<int>((w[k >> 2] >> (8 * (k & 3))) & 255u);
}

// Rows of a chunk whose pixel groups [qK - r, qK - r + K) meet [0, G).
template <int D>
__device__ __forceinline__ int2 phase_rows(int q, int R, int G) {
  const int lo = q * Geo<D>::K - G + 1, hi = q * Geo<D>::K + Geo<D>::K;
  return make_int2(lo > 0 ? lo : 0, hi < R ? hi : R);
}

// Copy phase q's input bytes of the chunk's rows into buffer q & 1: the
// aligned 16-byte chunks that hold a byte of the row's segment.
template <int D>
__device__ __forceinline__ void stage_in(uint8_t* in_s, const uint8_t* src,
                                         int y0, int R, int G, int pitch,
                                         int q) {
  using Gm = Geo<D>;
  const int2 rows = phase_rows<D>(q, R, G);
  uint8_t* buf = in_s + (q & 1) * blockDim.x * 16 * kChunks;
  for (int i = threadIdx.x; i < (rows.y - rows.x) * kChunks;
       i += blockDim.x) {
    const int r = rows.x + i / kChunks, j = i % kChunks;
    const uintptr_t row = reinterpret_cast<uintptr_t>(
        src + static_cast<size_t>(y0 + r) * (pitch + 1) + 1);
    const uintptr_t a =
        ((row + static_cast<intptr_t>(q * Gm::K - r) * D) & ~uintptr_t{15})
        + 16 * j;
    if (a + 16 > row && a < row + pitch)
      cp_async16(buf + (r * kChunks + j) * 16, a);
  }
}

// Write the aligned 16-byte chunks of the chunk's rows whose last byte of
// the row phase q finished, from the rows' output rings.  Whole chunks go
// as one 16-byte store; only a chunk that straddles a row's end goes byte
// by byte, once per row end.
template <int D>
__device__ __forceinline__ void flush_out(const uint8_t* ring, uint8_t* dst,
                                          int y0, int R, int G, int pitch,
                                          int q) {
  using Gm = Geo<D>;
  const int2 rows = phase_rows<D>(q, R, G);
  for (int i = threadIdx.x; i < (rows.y - rows.x) * kChunks;
       i += blockDim.x) {
    const int r = rows.x + i / kChunks, j = i % kChunks;
    const uintptr_t row = reinterpret_cast<uintptr_t>(
        dst + static_cast<size_t>(y0 + r) * pitch);
    const uintptr_t end = row + pitch;
    const uintptr_t seg = row + static_cast<intptr_t>(q * Gm::K - r) * D;
    const uintptr_t e0 = seg < row ? row : (seg < end ? seg : end);
    const uintptr_t e1 = seg + Gm::S < row ? row
                         : (seg + Gm::S < end ? seg + Gm::S : end);
    const uintptr_t a = (seg & ~uintptr_t{15}) + 16 * j;
    const uintptr_t lo = a > row ? a : row;
    const uintptr_t hi = a + 16 < end ? a + 16 : end;
    if (lo >= hi || hi <= e0 || hi > e1) continue;
    const uint8_t* rs = ring + r * kRing;
    const int rot = 16 * (r & 7);
    if (lo == a && hi == a + 16) {
      *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(
          rs + ((a + rot) & (kRing - 1)));
    } else {
      for (uintptr_t b = lo; b < hi; ++b)
        *reinterpret_cast<uint8_t*>(b) = rs[(b + rot) & (kRing - 1)];
    }
  }
}

// the launch bound caps registers so a 1024-thread block fits one SM
template <int D>
__global__ void __launch_bounds__(kMaxThreads)
    defilter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int pitch) {
  using Gm = Geo<D>;
  constexpr int K = Gm::K, S = Gm::S, W4 = Gm::W4, NW = Gm::NW;
  extern __shared__ __align__(16) uint8_t smem[];
  const int T = blockDim.x;
  uint8_t* in_s = smem;                                // [2][T][kChunks][16]
  uint8_t* ring = in_s + 2 * T * 16 * kChunks;         // [T][kRing]
  uint32_t* up_s = reinterpret_cast<uint32_t*>(ring + T * kRing);  // [2][W4]
  uint32_t* slot = up_s + 2 * W4;                      // [2][32][NW]
  const uint8_t* src = in + static_cast<size_t>(blockIdx.x) * H * (pitch + 1);
  uint8_t* dst = out + static_cast<size_t>(blockIdx.x) * H * pitch;
  const int G = pitch / D;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int y0 = 0; y0 < H; y0 += T) {
    const int R = min(T, H - y0);
    const int P = (R + G - 1 + K - 1) / K;
    const int y = y0 + t;
    const bool live = t < R;
    const int ft = live ? src[static_cast<size_t>(y) * (pitch + 1)] : 0;
    const bool f1 = ft == 1, f2 = ft == 2, f3 = ft == 3, f4 = ft == 4;
    // where phase 0's segment of the row starts, as device addresses: the
    // input in its staged chunks (mod 16), the output in its ring (mod
    // kRing, each row's ring turned by 16 * (row & 7) against bank
    // conflicts), the row above the chunk in its staged words (mod 4)
    const uintptr_t in0 = reinterpret_cast<uintptr_t>(
        src + static_cast<size_t>(y) * (pitch + 1) + 1) - uintptr_t(t) * D;
    const uintptr_t out0 = reinterpret_cast<uintptr_t>(
        dst + static_cast<size_t>(y) * pitch) - uintptr_t(t) * D
        + 16 * (t & 7);
    const uintptr_t up_row = reinterpret_cast<uintptr_t>(dst)
                             + static_cast<size_t>(y0 > 0 ? y0 - 1 : 0) * pitch;
    const bool up_loader = y0 > 0 && t < W4;
    auto up_load = [&](int q) -> uint32_t {
      const uintptr_t a = ((up_row + static_cast<size_t>(q) * S)
                           & ~uintptr_t{3}) + 4 * t;
      if (a + 4 > up_row && a < up_row + pitch)
        return __ldcg(reinterpret_cast<const unsigned*>(a));
      return 0;
    };

    stage_in<D>(in_s, src, y0, R, G, pitch, 0);
    cp_async_commit();
    if (up_loader) up_s[t] = up_load(0);
    cp_async_wait_all();
    __syncthreads();

    uint32_t aw[NW], cw[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) aw[i] = cw[i] = 0;
    uint8_t* xring = ring + t * kRing;
    for (int q = 0; q < P; ++q) {
      if (q + 1 < P) stage_in<D>(in_s, src, y0, R, G, pitch, q + 1);
      cp_async_commit();
      // issued now, stored to shared memory before the phase's last barrier
      const uint32_t upw = up_loader && q + 1 < P ? up_load(q + 1) : 0;
      if (q > 0) flush_out<D>(ring, dst, y0, R, G, pitch, q - 1);
      const size_t qs = static_cast<size_t>(q) * S;
      const uint8_t* xin = in_s + ((q & 1) * T + t) * 16 * kChunks
                           + ((in0 + qs) & 15);
      const int ro = static_cast<int>((out0 + qs) & (kRing - 1));
      const uint8_t* xu = reinterpret_cast<const uint8_t*>(up_s + (q & 1) * W4)
                          + ((up_row + qs) & 3);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int g = q * K + s - t;
        uint32_t bw[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) bw[i] = __shfl_up_sync(kFull, aw[i], 1);
        if (lane == 0) {
          if (warp > 0) {
#pragma unroll
            for (int i = 0; i < NW; ++i)
              bw[i] = slot[((s & 1) ^ 1) * 32 * NW + (warp - 1) * NW + i];
          } else {
#pragma unroll
            for (int i = 0; i < NW; ++i) bw[i] = 0;
            if (y0 > 0) {
#pragma unroll
              for (int k = 0; k < D; ++k)
                bw[k >> 2] |= uint32_t(xu[s * D + k]) << (8 * (k & 3));
            }
          }
        }
        if (live && g >= 0 && g < G) {
          uint32_t nw[NW];
#pragma unroll
          for (int i = 0; i < NW; ++i) nw[i] = 0;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const int a = byte_of(aw, k), b = byte_of(bw, k),
                      c = byte_of(cw, k);
            const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
            const int paeth = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            int p = f1 ? a : 0;
            p = f2 ? b : p;
            p = f3 ? (a + b) >> 1 : p;
            p = f4 ? paeth : p;
            const uint32_t v = (xin[s * D + k] + p) & 255;
            xring[(ro + s * D + k) & (kRing - 1)] = static_cast<uint8_t>(v);
            nw[k >> 2] |= v << (8 * (k & 3));
          }
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            cw[i] = bw[i];
            aw[i] = nw[i];
          }
        }
        if (lane == 31) {
#pragma unroll
          for (int i = 0; i < NW; ++i)
            slot[(s & 1) * 32 * NW + warp * NW + i] = aw[i];
        }
        if (s == K - 1) {
          cp_async_wait_all();
          if (up_loader && q + 1 < P) up_s[((q + 1) & 1) * W4 + t] = upw;
        }
        __syncthreads();
      }
    }
    flush_out<D>(ring, dst, y0, R, G, pitch, P - 1);
    __syncthreads();
  }
}

template <int D>
int launch(const void* in, void* out, int B, int H, int pitch,
           cudaStream_t stream) {
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = smem_bytes<D>(threads);
  cudaError_t err = cudaFuncSetAttribute(
      defilter_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  defilter_kernel<D><<<B, threads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, pitch);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int H, int* threads, int* smem, int* warps) {
  int n = ((H + 31) / 32) * 32;
  if (n > kMaxThreads) n = kMaxThreads;
  *threads = n;
  *smem = static_cast<int>(smem_bytes<D>(n));
  cudaError_t err = cudaFuncSetAttribute(
      defilter_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, defilter_kernel<D>, n, *smem);
  *warps = blocks * (n / 32);
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K3 on `stream`: in (B, H, 1 + pitch) u8 -> out (B, H, pitch) u8,
// delay in 1..8, pitch % delay == 0.  Neither pointer needs any alignment.
extern "C" int spt_defilter(const void* in, void* out, int B, int H,
                            int pitch, int delay, void* stream) {
  if (B <= 0 || H <= 0 || pitch <= 0) return 0;
  if (delay < 1 || delay > 8 || pitch % delay)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (delay) {
    case 1: return launch<1>(in, out, B, H, pitch, s);
    case 2: return launch<2>(in, out, B, H, pitch, s);
    case 3: return launch<3>(in, out, B, H, pitch, s);
    case 4: return launch<4>(in, out, B, H, pitch, s);
    case 5: return launch<5>(in, out, B, H, pitch, s);
    case 6: return launch<6>(in, out, B, H, pitch, s);
    case 7: return launch<7>(in, out, B, H, pitch, s);
    default: return launch<8>(in, out, B, H, pitch, s);
  }
}

// K3's launch shape for an image of H rows at `delay`: threads per block,
// dynamic shared memory per block, and the warps one SM holds (CUDA's
// occupancy calculator).
extern "C" int spt_defilter_occupancy(int H, int delay, int* threads,
                                      int* smem, int* warps) {
  switch (delay) {
    case 1: return occupancy<1>(H, threads, smem, warps);
    case 2: return occupancy<2>(H, threads, smem, warps);
    case 3: return occupancy<3>(H, threads, smem, warps);
    case 4: return occupancy<4>(H, threads, smem, warps);
    case 5: return occupancy<5>(H, threads, smem, warps);
    case 6: return occupancy<6>(H, threads, smem, warps);
    case 7: return occupancy<7>(H, threads, smem, warps);
    case 8: return occupancy<8>(H, threads, smem, warps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
