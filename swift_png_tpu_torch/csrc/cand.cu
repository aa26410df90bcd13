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
// What bounds it: its bytes.  Data is read once and 8 bytes of candidates
// are written per position, so the output stores are most of the bound.
// The work is a few integer operations per position and slot.  The design
// keeps it there, with no serial chain and every store coalesced:
//
// * Equality masks a word at a time.  A lane owns 32 consecutive positions,
//   a warp 1,024, a block of 4 warps 4,096 (stride % 4096 == 0 keeps a
//   block in one image).  The block stages its bytes, and the bytes up to
//   8 KB before them, in shared memory (one pad word per 8, so the lanes'
//   32-byte-apart reads fall in 32 banks); bytes outside the buffer are
//   never read.  Per slot a lane reads 9 words at p - d, realigns them with
//   __funnelshift_r and compares 4 bytes per step (a zero-byte test, the
//   four flags gathered by one multiply) into one 32-bit equality mask.  A
//   distance above 8 KB reads the same words from global memory.
// * Runs from the masks.  The run at bit b is the count of ones of the mask
//   from b up; when it reaches bit 31 it goes on with the run from the next
//   lane's first position: one suffix scan over the lanes of (ones from bit
//   0, mask all ones), taken only when some lane's mask is all ones.  Past
//   the warp's last position that run comes from a 288-position look-ahead
//   row (9 lanes, two slots per pass, one per half-warp), built only when
//   lane 31's run reaches its last position.
// * Selection only where a match can exist.  mask & mask >> 1 & mask >> 2
//   (with the next lane's bits) marks the runs of 3 or more.  The masks and
//   runs go to shared memory; a position no lane of the warp marks is
//   "none" without work, a group of 4 that every lane marks runs its slots
//   once for all 4 (runs counted down from the group's end), any other
//   marked position runs its slots alone.  The running top 2 keeps strict
//   '>' in slot order: with costs in [0, 2^16) as one key per slot,
//   (score + 1) << 14 | (31 - slot) << 9 | run, and three min/max; with
//   any other costs, by the plain version's compares.
// * Coalesced stores.  Each position's top 2 leaves the selection as a
//   14-bit (slot, run) pair per candidate in one word, in the buffer that
//   held the staged bytes; then lane l of the warp stores positions
//   128 i + 4 l .. + 3 of both candidates as 16-byte stores, 512 bytes in a
//   row per instruction.  (Each lane storing its own 32 positions, 128
//   bytes apart across the warp, cost more than the rest of the kernel.)
// * No work past n: a warp whose positions all lie at or past n only
//   stores, and a block past n stores and leaves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSpan = 1024;                 // positions per warp, 32 a lane
constexpr int kBlockSpan = kWarps * kSpan;  // positions per block
constexpr int kLookLanes = 9;               // 9 × 32 = 288 >= 258 look-ahead
constexpr int kBack = 8192;                 // distances read from shared memory
constexpr int kCap = 258;
constexpr int kNone = 1 << 9;
constexpr unsigned kFull = 0xFFFFFFFFu;
// staged bytes: 16-aligned, from kBack before the block's first position to
// past the last look-ahead lane's words
constexpr int kStageBytes = kBack + kBlockSpan + kLookLanes * 32 + 96;
constexpr int kStageWords = kStageBytes / 4;
constexpr int kStagePhys = kStageWords + kStageWords / 8 + 1;

// Word w of the staged bytes sits at w + w / 8 (one pad word per 8).
__device__ __forceinline__ int phys(int w) { return w + (w >> 3); }

// The aligned word at address a, bytes outside [lo, hi) read as 0.
__device__ __forceinline__ uint32_t gword(uintptr_t a, uintptr_t lo,
                                          uintptr_t hi) {
  if (a >= lo && a + 4 <= hi)
    return __ldg(reinterpret_cast<const uint32_t*>(a));
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (a + i >= lo && a + i < hi)
      w |= static_cast<uint32_t>(__ldg(reinterpret_cast<const uint8_t*>(a + i)))
           << (8 * i);
  return w;
}

// The 32 bytes from staged byte offset o as 8 words.
__device__ __forceinline__ void read_staged(const uint32_t* sm, int o,
                                            uint32_t (&w)[8]) {
  const int w0 = o >> 2;
  const uint32_t sh = static_cast<uint32_t>(o & 3) * 8u;
  uint32_t prev = sm[phys(w0)];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t nxt = sm[phys(w0 + k + 1)];
    w[k] = __funnelshift_r(prev, nxt, sh);
    prev = nxt;
  }
}

// The 32 bytes from address a (bytes outside [lo, hi) as 0) as 8 words.
__device__ __forceinline__ void read_global(uintptr_t a, uintptr_t lo,
                                            uintptr_t hi, uint32_t (&w)[8]) {
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(3);
  const uint32_t sh = static_cast<uint32_t>(a & 3) * 8u;
  uint32_t prev = gword(a0, lo, hi);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t nxt = gword(a0 + 4 * (k + 1), lo, hi);
    w[k] = __funnelshift_r(prev, nxt, sh);
    prev = nxt;
  }
}

// Bit b set where byte b of a equals byte b of b_ (32 bytes as 8 words).
__device__ __forceinline__ uint32_t eq_mask(const uint32_t (&a)[8],
                                            const uint32_t (&b)[8]) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t t = a[k] ^ b[k];
    // 0x80 in each zero byte of t
    const uint32_t z = ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
    // the flags of bytes 0..3 land in bits 28..31, no two products overlap
    m |= ((z * 0x00204081u) >> 28) << (4 * k);
  }
  return m;
}

// Bits b of a lane's 32 positions p + b with lo <= p + b < hi.
__device__ __forceinline__ uint32_t range_mask(int p, int lo, int hi) {
  const int a = lo - p, e = hi - p;
  const uint32_t m_lo = a <= 0 ? kFull : (a >= 32 ? 0u : kFull << a);
  const uint32_t m_hi = e >= 32 ? kFull : (e <= 0 ? 0u : kFull >> (32 - e));
  return m_lo & m_hi;
}

// Run of equal bytes from a lane's first position, in lanes of `width`:
// ones of the mask from bit 0, and when the mask is all ones, on into the
// next lane.  Lanes that `live` is false for end every run.
template <int kWidth>
__device__ __forceinline__ int lane_runs(uint32_t e, bool live, int tail,
                                         bool last) {
  int v = live ? __clz(__brev(~e)) : 0;
  bool a = live && e == kFull;
  if (last) {
    if (a) v += tail;
    a = false;
  }
  if (__any_sync(kFull, a)) {
    // a stays set only over lanes whose masks are all ones, and the last
    // lane of a width (31; 9..15 of a look-ahead half) never is one, so
    // the lane read is inside the width while a is set
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const int v2 = __shfl_down_sync(kFull, v, off, kWidth);
      const int a2 = __shfl_down_sync(kFull, static_cast<int>(a), off, kWidth);
      if (a) {
        v += v2;
        a = a2 != 0;
      }
    }
  }
  return min(v, kCap);
}

// Staged bytes and, once every warp's masks are built, each warp's output
// codes: 32 rows of 36 words (32 codes and a pad), so 8 lanes storing 16
// bytes each, or reading one row's 8 chunks, hit 32 banks.
constexpr int kRowWords = 36;
constexpr int kCodeWords = kWarps * 32 * kRowWords;
constexpr int kSmemWords = kStagePhys > kCodeWords ? kStagePhys : kCodeWords;

// One position's top 2 as a code: per candidate (31 - slot) << 9 | run in
// 14 bits, 0 for none; candidate 1 in the low half.
__device__ __forceinline__ uint32_t top2_code(uint32_t k1, uint32_t k2) {
  return (k1 & 0x3FFFu) | (k2 & 0x3FFFu) << 16;
}

__global__ void __launch_bounds__(kThreads)
    cand_kernel(const uint8_t* __restrict__ data,
                const int* __restrict__ dists, const int* __restrict__ costs,
                const int* __restrict__ nvec, int* __restrict__ out,
                long long ntot, int stride, int dmax) {
  __shared__ int dist_s[kMaxSlots], cost_s[kMaxSlots];
  __shared__ int kbase_s[kMaxSlots], rmin_s[kMaxSlots];
  __shared__ __align__(16) uint32_t smem[kSmemWords];
  // per slot and thread: the lane's equality mask and the run from the
  // next lane's first position (slot-major, so a warp's lanes hit 32 banks)
  extern __shared__ uint32_t lane_s[];
  const long long b0 = static_cast<long long>(blockIdx.x) * kBlockSpan;
  const int img = static_cast<int>(b0 / stride);
  const int bq = static_cast<int>(b0 - static_cast<long long>(img) * stride);
  const int n = nvec[img];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = bq + warp * kSpan;
  const int p = c0 + lane * 32;
  // coalesced output: pass i stores positions c0 + 128 i + 4 lane .. + 3
  int4* o1 = reinterpret_cast<int4*>(out + b0 + warp * kSpan + 4 * lane);
  int4* o2 = reinterpret_cast<int4*>(out + ntot + b0 + warp * kSpan +
                                     4 * lane);
  const int4 none = make_int4(kNone, kNone, kNone, kNone);
  if (bq >= n) {
    // the whole block lies past the image's bytes
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o1[32 * i] = none;
      o2[32 * i] = none;
    }
    return;
  }
  if (tid < kMaxSlots) {
    const int d = tid < dmax ? dists[img * dmax + tid] : 0;
    const int c = tid < dmax ? costs[img * dmax + tid] : 0;
    dist_s[tid] = d;
    cost_s[tid] = c;
    // a slot's key is run * (2^20 + 1) + kbase where it scores:
    // ((score + 1) << 14 | (31 - slot) << 9 | run), for costs in [0, 2^16)
    kbase_s[tid] = static_cast<int>((1u - static_cast<uint32_t>(c)) << 14) +
                   ((31 - tid) << 9);
    rmin_s[tid] = d > 0 ? max(3, (c + 63) >> 6) : 1 << 30;
  }
  __syncthreads();
  // the staged region reaches back to the largest distance it serves;
  // slots past the last live one (menus end in 0 slots) are not visited
  int back = 0, nslot = 0;
  bool narrow = true;  // every cost in [0, 2^16): scores fit the keys
  for (int j = 0; j < dmax; ++j) {
    const int d = dist_s[j];
    if (d > 0) nslot = j + 1;
    if (d > 0 && d <= kBack) back = max(back, d);
    narrow = narrow && cost_s[j] >= 0 && cost_s[j] < (1 << 16);
  }
  const uintptr_t lo = reinterpret_cast<uintptr_t>(data);
  const uintptr_t hi = lo + static_cast<uintptr_t>(ntot);
  const uintptr_t img0 = lo + static_cast<uintptr_t>(img) * stride;
  const uintptr_t rs = (img0 + bq - back) & ~static_cast<uintptr_t>(15);
  const uintptr_t re =
      (img0 + bq + kBlockSpan + kLookLanes * 32 + 40 + 15) &
      ~static_cast<uintptr_t>(15);
  const int chunks = static_cast<int>((re - rs) >> 4);
  uint32_t* stage = smem;
  for (int c = tid; c < chunks; c += kThreads) {
    const uintptr_t a = rs + 16 * static_cast<uintptr_t>(c);
    uint32_t w[4];
    if (a >= lo && a + 16 <= hi) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = gword(a + 4 * i, lo, hi);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) stage[phys(4 * c + i)] = w[i];
  }
  __syncthreads();

  // a warp whose positions all lie at or past n only stores
  const bool work = c0 < n;
  uint32_t* eq_s = lane_s;
  int* rn_s = reinterpret_cast<int*>(lane_s + dmax * kThreads);
  uint32_t any3 = 0;  // positions where some slot's run is 3 or more
  if (work) {
    // staged byte offset of image position q is orel + q
    const int orel = static_cast<int>(img0 - rs);
    uint32_t own[8];
    read_staged(stage, orel + p, own);
    const uint32_t live = range_mask(p, 0, n);
    // the look-ahead row: lane l < 9 of each half-warp holds positions
    // c0 + 1024 + 32 l for one slot of a pair
    const int l = lane & 15;
    const bool la = l < kLookLanes;
    const int pl = c0 + kSpan + 32 * (la ? l : 0);
    const uint32_t live_la = la ? range_mask(pl, 0, n) : 0u;
#pragma unroll 1
    for (int j0 = 0; j0 < nslot; j0 += 2) {
      uint32_t e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = j0 + h < dmax ? dist_s[j0 + h] : 0;
        e[h] = 0;
        if (d > 0 && d < c0 + kSpan) {
          uint32_t w[8];
          if (d <= kBack)
            read_staged(stage, orel + p - d, w);
          else
            read_global(img0 + p - d, lo, hi, w);
          e[h] = eq_mask(own, w) & live;
          if (c0 < d) e[h] &= range_mask(p, d, n);
        }
      }
      // the look-ahead matters to a slot only where lane 31's run reaches
      // its last position
      const unsigned need =
          __shfl_sync(kFull, (e[0] >> 31) | (e[1] >> 31) << 1, 31);
      uint32_t la_m[2] = {0u, 0u};
      int la_r[2] = {0, 0};
      if (need) {
        const int h = lane >> 4;
        const int dl = j0 + h < dmax ? dist_s[j0 + h] : 0;
        uint32_t el = 0;
        if (la && ((need >> h) & 1u) && dl > 0) {
          uint32_t own_la[8], w[8];
          read_staged(stage, orel + pl, own_la);
          if (dl <= kBack)
            read_staged(stage, orel + pl - dl, w);
          else
            read_global(img0 + pl - dl, lo, hi, w);
          el = eq_mask(own_la, w) & live_la & range_mask(pl, dl, n);
        }
        const int rl = lane_runs<16>(el, la, 0, false);
        la_m[0] = __shfl_sync(kFull, el, 0);
        la_m[1] = __shfl_sync(kFull, el, 16);
        la_r[0] = __shfl_sync(kFull, rl, 0);
        la_r[1] = __shfl_sync(kFull, rl, 16);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + h;
        const int r0 = lane_runs<32>(e[h], true, la_r[h], lane == 31);
        int r = __shfl_down_sync(kFull, r0, 1);
        uint32_t nx = __shfl_down_sync(kFull, e[h], 1);
        if (lane == 31) {
          r = la_r[h];
          nx = la_m[h];
        }
        if (j < dmax) {
          eq_s[j * kThreads + tid] = e[h];
          rn_s[j * kThreads + tid] = r;
        }
        any3 |=
            e[h] & __funnelshift_r(e[h], nx, 1) & __funnelshift_r(e[h], nx, 2);
      }
    }
  }
  // the staged bytes are read by now: the buffer takes the output codes
  __syncthreads();
  uint32_t* codes = smem + warp * 32 * kRowWords;
  if (work) {
    uint32_t* row = codes + lane * kRowWords;
#pragma unroll 1
    for (int g = 0; g < 8; ++g) {
      uint32_t cw[4];
      const unsigned quad = __reduce_or_sync(kFull, (any3 >> (4 * g)) & 15u);
      if (quad == 15u && narrow) {
        uint32_t k1[4] = {0u, 0u, 0u, 0u}, k2[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
        for (int j = 0; j < nslot; ++j) {
          const uint32_t e = eq_s[j * kThreads + tid];
          const int rn = rn_s[j * kThreads + tid];
          const int rmin = rmin_s[j];
          const uint32_t kb = static_cast<uint32_t>(kbase_s[j]);
          const int b = 4 * g + 4;
          const uint32_t t = b < 32 ? ~e >> b : 0u;
          int run = t ? __ffs(t) - 1 : min(32 - b + rn, kCap);
#pragma unroll
          for (int r = 3; r >= 0; --r) {
            run = (e >> (4 * g + r)) & 1u ? min(run + 1, kCap) : 0;
            const uint32_t key =
                run >= rmin ? static_cast<uint32_t>(run) * 0x100001u + kb : 0u;
            k2[r] = max(k2[r], min(k1[r], key));
            k1[r] = max(k1[r], key);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) cw[r] = top2_code(k1[r], k2[r]);
        *reinterpret_cast<uint4*>(row + 4 * g) =
            make_uint4(cw[0], cw[1], cw[2], cw[3]);
        continue;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = 4 * g + r;
        cw[r] = 0;
        if (!((quad >> r) & 1u)) continue;
        if (narrow) {
          // top 2 of the keys: unique per slot, larger for a higher score
          // and, on a tie, for the earlier slot, as strict '>' keeps it
          uint32_t k1 = 0, k2 = 0;
#pragma unroll 1
          for (int j = 0; j < nslot; ++j) {
            const uint32_t t = ~eq_s[j * kThreads + tid] >> b;
            const int run =
                t ? __ffs(t) - 1 : min(32 - b + rn_s[j * kThreads + tid], kCap);
            const uint32_t key =
                run >= rmin_s[j]
                    ? static_cast<uint32_t>(run) * 0x100001u +
                          static_cast<uint32_t>(kbase_s[j])
                    : 0u;
            k2 = max(k2, min(k1, key));
            k1 = max(k1, key);
          }
          cw[r] = top2_code(k1, k2);
        } else {
          int s1 = -1, s2 = -1;
          uint32_t k1 = 0, k2 = 0;
#pragma unroll 1
          for (int j = 0; j < nslot; ++j) {
            const uint32_t t = ~eq_s[j * kThreads + tid] >> b;
            const int run =
                t ? __ffs(t) - 1 : min(32 - b + rn_s[j * kThreads + tid], kCap);
            // int32 arithmetic that wraps, as the plain version's
            const int score =
                run >= 3 && dist_s[j] > 0
                    ? static_cast<int>(static_cast<uint32_t>(run) * 64u -
                                       static_cast<uint32_t>(cost_s[j]))
                    : -1;
            const uint32_t key = static_cast<uint32_t>((31 - j) << 9 | run);
            if (score > s1) {
              s2 = s1;
              k2 = k1;
              s1 = score;
              k1 = key;
            } else if (score > s2) {
              s2 = score;
              k2 = key;
            }
          }
          cw[r] = top2_code(k1, k2);
        }
      }
      *reinterpret_cast<uint4*>(row + 4 * g) =
          make_uint4(cw[0], cw[1], cw[2], cw[3]);
    }
  }
  __syncwarp();
  // pass i: lane l stores positions 128 i + 4 l .. + 3, row 4 i + l / 8
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    if (!work) {
      o1[32 * i] = none;
      o2[32 * i] = none;
      continue;
    }
    const uint4 cc = *reinterpret_cast<const uint4*>(
        codes + (4 * i + (lane >> 3)) * kRowWords + 4 * (lane & 7));
    const uint32_t cv[4] = {cc.x, cc.y, cc.z, cc.w};
    int v1[4], v2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t a = cv[r] & 0x3FFFu, b = cv[r] >> 16;
      v1[r] = a ? dist_s[31 - (a >> 9)] << 9 | static_cast<int>(a & 511u)
                : kNone;
      v2[r] = b ? dist_s[31 - (b >> 9)] << 9 | static_cast<int>(b & 511u)
                : kNone;
    }
    o1[32 * i] = make_int4(v1[0], v1[1], v1[2], v1[3]);
    o2[32 * i] = make_int4(v2[0], v2[1], v2[2], v2[3]);
  }
}

// Dynamic shared memory of a launch: each thread's mask and run per slot.
size_t lane_bytes(int dmax) {
  return static_cast<size_t>(dmax) * kThreads * 2 * sizeof(uint32_t);
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Warps of the kernel resident on one SM at its launch shape, for menus of
// 16 slots (the levels' default menu).
extern "C" int spt_resident_warps(int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, cand_kernel, kThreads, lane_bytes(16));
  *warps = blocks * kWarps;
  return static_cast<int>(err);
}

// Launch K4 on `stream`: data (B * stride) u8, dists/costs (B, dmax) i32,
// nvec (B,) i32 -> out (2, B * stride) i32.  stride % 4096 == 0, dmax <= 32.
extern "C" int spt_cand(const void* data, const void* dists, const void* costs,
                        const void* nvec, void* out, int B, int stride,
                        int dmax, void* stream) {
  if (B <= 0) return 0;
  if (stride <= 0 || stride % kBlockSpan || dmax < 0 || dmax > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntot = static_cast<long long>(B) * stride;
  const unsigned blocks = static_cast<unsigned>(ntot / kBlockSpan);
  const size_t smem = lane_bytes(dmax);
  cudaError_t err = cudaFuncSetAttribute(
      cand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lane_bytes(kMaxSlots)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cand_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(dists),
      static_cast<const int*>(costs), static_cast<const int*>(nvec),
      static_cast<int*>(out), ntot, stride, dmax);
  return static_cast<int>(cudaGetLastError());
}
