// K5: min-cost LZ77 parse of each 1,024-byte chunk (the optimal parse).
//
// Replaces the Pallas kernel swift_png_tpu/ops/deflate_optimal.py
// _make_dp_kernel (launched by optimal_parse_device, once per iteration of
// _dp_iterated), which runs 128 chunks side by side on a tile's lanes.
//
// Per chunk of clen live bytes: cost[0] = 0, the rest INF.  At position i
// (in order), the literal edge i -> i+1 costs dep_lit[byte]; then for each
// of the two candidates (dist << 9 | run) the edges i -> i+L for L in
// 3..min(run, clen-i, 258) cost ddep[decade(dist)] + runcost[L-3].  Every
// relaxation is strict '<', the literal first and candidate 0 before
// candidate 1, so ties resolve as on the TPU.  The backtrack from clen
// writes each term at its end position: 0xF8000000 | byte for a literal,
// dd << 27 | (dist - base) << 14 | (L - rbase) << 9 | 0x100 | rd for a
// match, sets valid there, and counts the symbols (lit/run rows 0..287,
// distance decades 288..317) into the image's 320-row histogram.
//
// What bounds it: each chunk is a chain of clen dependent steps (position
// i+1 reads the cost that position i's edges settle), up to 2 x 256 edges a
// step on long matches; its bytes (data, candidates, terms) are 14 per
// position.  Throughput is the number of chains in flight times the length
// of one step, and the design works on both:
//
// * One warp per chunk, eight chunks (always of one image: cpi % 8 == 0)
//   per block.  Shared state per chunk is 4 KB: the cost of the live window
//   [i, i+258] in a 512-entry ring (slot i-1 is reset to INF at step i, for
//   position i+511), provenance as int16 (edge kind and length; the
//   distance is read back from the candidate at the edge's source), and a
//   1,024-bit mask of the parse's term ends.  One histogram per block, with
//   shared atomics.  37.5 KB per block and at most 51 registers: five
//   blocks, 40 warps, per SM.
// * One relaxation phase and one __syncwarp() per position.  Lane l
//   relaxes lengths 3 + l, 35 + l, ... of both candidates at once, and lane
//   0 the literal edge too: its target, i+1, is no candidate's (those start
//   at i+3), so the literal needs no phase of its own.  Per target length
//   the two candidates merge in registers, best = (c1 < c0) ? c1 : c0 with
//   an absent candidate as INT_MAX, then one `best < cost[i+L]`.  This is
//   exactly "candidate 0, then candidate 1, strict <" against v = cost[i+L]:
//     - c0 < v and c1 < c0: the old order takes c0, then c1; best is c1.
//     - c0 < v and c1 >= c0: the old order keeps c0; best is c0.
//     - c0 >= v: the old order takes c1 iff c1 < v; best is c1 iff
//       c1 < c0, and then c1 < v iff the old order takes it; otherwise
//       best = c0 >= v and c1 >= c0 >= v, so neither updates.
//   An absent candidate (L past its reach) is INT_MAX, never < v, and never
//   < the other; equal costs keep candidate 0, as the old order does.
// * Per-position constants off the chain: when a lane loads its position
//   of a 32-position window it computes the literal cost, each candidate's
//   reach min(run, clen - i, 258) and its decade cost ddep[decade(dist)];
//   the step shuffles them in.  The run costs of the lane's lengths sit in
//   registers.
// * Two shortcuts that only reorder int32 sums, exact while no sum wraps:
//   the wrapper refuses cost tables with an entry outside [0, 2^20), so a
//   cost stays under 1,024 * 2^20 + 2^21 < 2^31 (the level's own tables
//   are quarter bits, under 128):
//     - A window from which no candidate edge leaves (photographic content,
//       nearly every window) is a chain of literal edges only, cost[i+1] =
//       min(a[i+1], cost[i] + lit[i]) with a the cost earlier windows left
//       there: a min-plus scan over the warp in five shuffle rounds in place
//       of 32 steps.  Provenance is the literal exactly where the step would
//       take it, cost[i] + lit[i] < a[i+1].
//     - Both candidates reach lengths [3, min(q0, q1)], where c1 < c0 is
//       b1 < b0 for the base costs b = cost[i] + ddep, so the merge is made
//       once per position; only the longer candidate reaches beyond.
// * The backtrack walks provenance in shared memory on lane 0 and only
//   marks the term ends; then every lane writes the terms of its positions
//   (coalesced, zeros between terms), reading the chunk's bytes in
//   32-byte rows and, per match, the distance of the winning candidate at
//   the match's source, and counts the histogram with shared atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NB = 1024;
constexpr int kWarps = 8;
constexpr int kRows = 320;
constexpr int kRing = 512;
constexpr int kMaxLen = 258;
constexpr int INF = 1 << 28;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int decade_of(int dist) {
  const int dm1 = dist - 1;
  const int bl = dm1 > 0 ? min(32 - __clz(dm1), 16) : 0;
  const int hi = (dm1 >> max(bl - 2, 0)) & 1;
  return dist <= 4 ? dm1 : 2 * (bl - 1) + hi;
}

// Reach of one candidate from position pos: 0 when it has no edge.
__device__ __forceinline__ int reach_of(int cv, int rem) {
  const int r = min(min(cv & 0x1FF, rem), kMaxLen);
  return r >= 3 ? r : 0;
}

__global__ void __launch_bounds__(kWarps * 32, 5)
    dp_kernel(const uint8_t* __restrict__ data, const int* __restrict__ clens,
              const int* __restrict__ cand, const int* __restrict__ dep_lit,
              const int* __restrict__ runcost, const int* __restrict__ ddep,
              const int* __restrict__ rdinfo, const int* __restrict__ dbase,
              int* __restrict__ terms, uint8_t* __restrict__ valid,
              int* __restrict__ hist, long long ntot, int cpi) {
  __shared__ int cost_s[kWarps][kRing];
  __shared__ uint16_t prov_s[kWarps][NB + 2];  // L | kind << 9 (1 literal)
  __shared__ uint32_t path_s[kWarps][NB / 32];
  __shared__ int hist_s[kRows];
  __shared__ int lit_t[256], run_t[256], rdi_t[256], dd_t[32], db_t[32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x * kWarps + warp;
  const int img = blockIdx.x * kWarps / cpi;
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    lit_t[k] = dep_lit[img * 256 + k];
    run_t[k] = runcost[img * 256 + k];
    rdi_t[k] = rdinfo[k];
  }
  if (threadIdx.x < 32) {
    dd_t[threadIdx.x] = ddep[img * 32 + threadIdx.x];
    db_t[threadIdx.x] = dbase[threadIdx.x];
  }
  for (int k = threadIdx.x; k < kRows; k += blockDim.x) hist_s[k] = 0;
  int* cost = cost_s[warp];
  uint16_t* prov = prov_s[warp];
  uint32_t* path = path_s[warp];
  for (int k = lane; k < kRing; k += 32) cost[k] = k == 0 ? 0 : INF;
  for (int k = lane; k <= NB; k += 32) prov[k] = 0;
  path[lane] = 0;
  __syncthreads();

  const int clen = clens[chunk];
  const long long cb = static_cast<long long>(chunk) * NB;
  int rt[8];  // run cost of L = 3 + lane + 32 m
#pragma unroll
  for (int m = 0; m < 8; ++m) rt[m] = run_t[lane + 32 * m];
  for (int w = 0; w < clen; w += 32) {
    // this lane's position of the window: its constants
    const int pos = w + lane;
    const long long P = cb + pos;
    const int lit_l = lit_t[data[P]];
    const int c0 = cand[P], c1 = cand[ntot + P];
    const int rem = clen - pos;
    const int reach_l = reach_of(c0, rem) | reach_of(c1, rem) << 16;
    const int dd0 = decade_of(c0 >> 9), dd1 = decade_of(c1 >> 9);
    const int e0_l = (dd0 >= 0 && dd0 < 32) ? dd_t[dd0] : 0;
    const int e1_l = (dd1 >= 0 && dd1 < 32) ? dd_t[dd1] : 0;
    const int kend = min(32, clen - w);
    if (__all_sync(kFull, reach_l == 0)) {
      // No candidate edge leaves the window: its costs are a min-plus
      // scan.  Lane l holds f_l(x) = min(a, x + lit) for target w + l + 1
      // (a = the cost that earlier windows' edges left there) as (A, B);
      // composing g after f gives (min(A_g, A_f + B_g), B_f + B_g).
      const int cw = cost[w & (kRing - 1)];
      const int a_own = cost[(w + lane + 1) & (kRing - 1)];
      __syncwarp();  // every lane has read slot w before lane 0 resets it
      int A = a_own, Bs = lit_l;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int A2 = __shfl_up_sync(kFull, A, d);
        const int B2 = __shfl_up_sync(kFull, Bs, d);
        if (lane >= d) {
          A = min(A, A2 + Bs);
          Bs = B2 + Bs;
        }
      }
      const int cnext = min(A, cw + Bs);  // cost[w + lane + 1]
      int cprev = __shfl_up_sync(kFull, cnext, 1);
      if (lane == 0) cprev = cw;
      if (lane < kend) {
        if (cprev + lit_l < a_own) prov[w + lane + 1] = 1;
        // the ring as the steps leave it: only the next window's first
        // position keeps its cost, the consumed slots are INF again
        cost[(w + lane + 1) & (kRing - 1)] = lane == kend - 1 ? cnext : INF;
      }
      if (lane == 0) {
        cost[(w - 1) & (kRing - 1)] = INF;
        cost[w & (kRing - 1)] = INF;
      }
      __syncwarp();
      continue;
    }
    for (int k = 0; k < kend; ++k) {
      const int i = w + k;
      const int ci = cost[i & (kRing - 1)];
      const int litc = __shfl_sync(kFull, lit_l, k);
      const int rr = __shfl_sync(kFull, reach_l, k);
      const int b0 = ci + __shfl_sync(kFull, e0_l, k);
      const int b1 = ci + __shfl_sync(kFull, e1_l, k);
      const int q0 = rr & 0xFFFF, q1 = rr >> 16;
      const int qmax = max(q0, q1);
      if (lane == 0) {
        const int t = (i + 1) & (kRing - 1);
        const int lc = ci + litc;
        if (lc < cost[t]) {
          cost[t] = lc;
          prov[i + 1] = 1;
        }
      } else if (lane == 31) {
        cost[(i - 1) & (kRing - 1)] = INF;  // becomes position i + 511
      }
      // both candidates reach [3, qlo]; only the longer one (qlo, qmax]
      const int qlo = min(q0, q1);
      const bool t1 = b1 < b0, long1 = q1 > q0;
      const int bmin = t1 ? b1 : b0, blong = long1 ? b1 : b0;
      const int kmin = (t1 ? 2 : 1) << 9, klong = (long1 ? 2 : 1) << 9;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int L = 3 + lane + 32 * m;
        if (L > qmax) break;
        const bool both = L <= qlo;
        const int best = (both ? bmin : blong) + rt[m];
        const int t = (i + L) & (kRing - 1);
        if (best < cost[t]) {
          cost[t] = best;
          prov[i + L] = static_cast<uint16_t>(L | (both ? kmin : klong));
        }
      }
      __syncwarp();
    }
  }

  if (lane == 0) {
    int i = clen;
    while (i >= 1) {
      const int ln = prov[i] & 0x1FF;
      if (ln == 0) break;
      path[(i - 1) >> 5] |= 1u << ((i - 1) & 31);
      i -= ln;
    }
  }
  __syncwarp();
  for (int p = lane; p < NB; p += 32) {
    int term = 0;
    uint8_t v = 0;
    if ((path[p >> 5] >> (p & 31)) & 1u) {
      const int pr = prov[p + 1];
      const int ln = pr & 0x1FF;
      if (ln == 1) {
        const int byte = data[cb + p];
        term = static_cast<int>(0xF8000000u | static_cast<unsigned>(byte));
        atomicAdd(&hist_s[byte], 1);
      } else {
        const long long src = cb + p + 1 - ln;
        const int dist = cand[((pr >> 9) - 1) * ntot + src] >> 9;
        const int rinfo = rdi_t[ln - 3];
        const int rd = rinfo & 31;
        const int rbase = (rinfo >> 5) & 0x1FF;
        const int dd = decade_of(dist);
        const int dbv = (dd >= 0 && dd < 32) ? db_t[dd] : 0;
        term = static_cast<int>(
            (static_cast<unsigned>(dd) << 27) |
            (static_cast<unsigned>(dist - dbv) << 14) |
            (static_cast<unsigned>(ln - rbase) << 9) | 0x100u |
            static_cast<unsigned>(rd));
        atomicAdd(&hist_s[257 + rd], 1);
        if (dd >= 0 && dd < 32) atomicAdd(&hist_s[288 + dd], 1);
      }
      v = 1;
    }
    terms[cb + p] = term;
    valid[cb + p] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kRows; k += blockDim.x)
    if (hist_s[k]) atomicAdd(hist + img * kRows + k, hist_s[k]);
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Warps of this kernel resident on one SM at its launch shape.
extern "C" int spt_resident_warps(int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, dp_kernel, kWarps * 32, 0);
  *warps = blocks * kWarps;
  return static_cast<int>(err);
}

// Launch K5 on `stream`: data (C * 1024) u8, clen (C,) i32, cand (2, C*1024)
// i32, dep_lit/runcost (B, 256), ddep (B, 32), rdinfo (256,), dbase (32,)
// i32 -> terms (C*1024) i32, valid (C*1024) u8, hist (B, 320) i32 (zeroed
// by the caller).  cpi (chunks per image) % 8 == 0, C % cpi == 0.
extern "C" int spt_dp_parse(const void* data, const void* clen,
                            const void* cand, const void* dep_lit,
                            const void* runcost, const void* ddep,
                            const void* rdinfo, const void* dbase,
                            void* terms, void* valid, void* hist, int chunks,
                            int cpi, void* stream) {
  if (chunks <= 0) return 0;
  if (cpi <= 0 || cpi % kWarps || chunks % cpi)
    return static_cast<int>(cudaErrorInvalidValue);
  dp_kernel<<<chunks / kWarps, kWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(clen),
      static_cast<const int*>(cand), static_cast<const int*>(dep_lit),
      static_cast<const int*>(runcost), static_cast<const int*>(ddep),
      static_cast<const int*>(rdinfo), static_cast<const int*>(dbase),
      static_cast<int*>(terms), static_cast<uint8_t*>(valid),
      static_cast<int*>(hist), static_cast<long long>(chunks) * NB, cpi);
  return static_cast<int>(cudaGetLastError());
}
