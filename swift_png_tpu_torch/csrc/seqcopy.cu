// K2: in-order execution of merged LZ77 match records, one block per stream.
//
// Replaces the Pallas kernel swift_png_tpu/ops/inflate_seqcopy.py
// (_seqcopy_kernel, launched by seqcopy_expand) and its feasibility version
// tools/exp_seqcopy.py (_kernel, launched by seqcopy), whose function is a
// subset of K2's.
//
// Each stream's output row starts as its literal-placed bytes.  Its records
// (pos, d, len) run in stream order with forward-copy semantics:
// out[pos + i] = out[pos + i - d] for i in [0, len).  Unrolled, that is the
// closed form out[pos + i] = out[pos - d + (i % d)]: the bytes [pos - d, pos)
// are final before the record starts, so every byte of a record is
// independent of the others.  The TPU kernel holds the whole stream in VMEM
// and its records in scalar-prefetch memory; here the stream's bytes pass
// through a ring in shared memory and its records are staged there too.
//
// Two paths, chosen per stream by the same rule as records_well_formed in
// ops/inflate_seqcopy.py, applied to the records as they are staged (a
// prefix max of the record ends over the block):
//
// * Ring path (well-formed streams: after dropping records with len <= 0,
//   every record has 1 <= d <= min(pos, 32768), pos + len <= Opad and pos at
//   or after the previous record's end).  The stream runs in 48 KB segments
//   through a 128 KB ring indexed by stream position.  A segment's literal
//   bytes arrive by cp.async 16-byte copies while the segment before it runs
//   its records; the records whose targets fall in the segment run there,
//   each over the ring only (a record that reaches past the segment runs the
//   rest in the next one, as a piece (pos', d, len') with the same d: the
//   same forward copy); then the segment, final now, leaves as 16-byte
//   stores.  Sources lie at most 32,768 bytes before a target, so the ring
//   holds them: while segment [b, b + 48K) runs, the ring holds [b - 32K,
//   b + 48K) and the next segment's copies land in the slots of [b - 80K,
//   b - 32K).  The records run in groups: a group is up to 7 consecutive
//   records whose sources end at or before the group's first target, so
//   none reads what another writes.  Warp 7 plans up to 8 groups at a time
//   from the staged records (and stages the next 2,048 by 4-byte cp.async)
//   while warps 0-6 run the groups it planned before, one after another
//   with a barrier of the 7 warps between them, the longest record of a
//   group on the warps its other records (one warp each) leave.  A record's
//   bytes run over the ring only: one with len <= d is a plain copy, aligned
//   16-byte chunks inside (two ring chunks and funnel shifts) and bytes at
//   its ends; d in {1, 2, 4} stores one pattern word 16 bytes at a time;
//   any other runs as aligned 4-byte words, each from two 4-byte reads a
//   period apart (the bytes before and after the period wraps), 4 words a
//   thread loaded before any is stored; i % d advances by a per-record
//   step, with a float reciprocal for the first value.
// * Global path (any other stream): every record over `out` in device
//   memory, a byte per thread per step.  Hostile records stay inside the
//   stream's row: a write at or past Opad is dropped, a source
//   before byte 0 reads 0, and a record with d < 1 does nothing; `starts` is
//   clipped to [0, nrec].  The plain version does the same.
//
// What bounds it: on the ring path, one group after another, each as long
// as its slowest record and a barrier, on B of the card's 132 SMs; a run of
// records that each read the one before (a small d) takes a group per
// record.  The bytes stream in and out beside it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkers = kWarps - 1;      // warps that run records
constexpr int kGroups = 8;                // record groups planned at once
constexpr int kRing = 1 << 17;            // ring bytes (power of two)
constexpr int kRingMask = kRing - 1;
constexpr int kSeg = 48 << 10;            // segment bytes (multiple of 16)
constexpr int kMaxDist = 32768;
constexpr int kBatch = 2048;              // records staged at once
constexpr int kPerThread = kBatch / kThreads;
static_assert(kRing >= kMaxDist + 2 * kSeg, "the next segment must not land "
              "on the live window");
// the ring, the staged records, two plans, the scan scratch
constexpr size_t kSmemBytes = kRing + kBatch * sizeof(int4) +
                              2 * (kGroups * kWorkers + 1) * sizeof(int4) +
                              32 * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x % d for 0 <= x < 2^22, with inv = 1 / d rounded: the quotient from the
// float product is off by at most one either way.
__device__ __forceinline__ int mod_small(int x, int d, float inv) {
  const int q = __float2int_rz(__int2float_rz(x) * inv);
  int r = x - q * d;
  if (r < 0) r += d;
  else if (r >= d) r -= d;
  return r;
}

// Records [cb, cb + n) into rec[0, n) as (pos, d, len, -) by threads t of
// nt: coalesced 4-byte cp.async copies, waited for here.
__device__ void stage(const int32_t* __restrict__ recs, int cb, int n,
                      int4* rec, int t, int nt) {
  int* dst = reinterpret_cast<int*>(rec);
  const int32_t* src = recs + 3LL * cb;
  for (int w = t; w < 3 * n; w += nt) {
    const int i = w / 3;
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + 4 * i + (w - 3 * i)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src + w));
  }
  cp_async_wait_all();
}

// Exclusive prefix max over the block of v >= 0 (0 for thread 0); `total`
// receives the block's max.
__device__ int block_excl_max(int v, int* scan, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) scan[warp] = x;
  int ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = 0;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = max(before, scan[w]);
    all = max(all, scan[w]);
  }
  __syncthreads();
  *total = all;
  return max(before, ex);
}

// The ring-path rule over the stream's records [rs, re), staged in batches.
// Leaves the last batch staged in rec.
__device__ bool well_formed(const int32_t* __restrict__ recs, int rs, int re,
                            int Opad, int4* rec, int* scan) {
  bool ok = true;
  int carry = 0;                          // the largest end so far
  for (int cb = rs; cb < re; cb += kBatch) {
    const int n = min(kBatch, re - cb);
    __syncthreads();
    stage(recs, cb, n, rec, threadIdx.x, kThreads);
    __syncthreads();
    const int lo = threadIdx.x * kPerThread;
    const int hi = min(lo + kPerThread, n);
    int ends[kPerThread];
    int mx = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      ends[k] = -1;                       // len <= 0: dropped
      if (lo + k < hi) {
        const int4 v = rec[lo + k];
        if (v.z > 0) {
          const bool own = v.y >= 1 && v.y <= kMaxDist && v.y <= v.x &&
                           v.z <= Opad - v.x;
          ok = ok && own;
          ends[k] = own ? v.x + v.z : 0;
          mx = max(mx, ends[k]);
        }
      }
    }
    int total;
    int running = max(carry, block_excl_max(mx, scan, &total));
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (ends[k] >= 0) {
        ok = ok && rec[lo + k].x >= running;
        running = max(running, ends[k]);
      }
    }
    carry = max(carry, total);
  }
  return __syncthreads_and(ok) != 0;
}

// Stream bytes [lo, hi) of `src` into the ring (lo % 16 == 0): 16-byte
// cp.async copies where the row is aligned, bytes otherwise.
__device__ void fetch(const uint8_t* __restrict__ src, uint8_t* ring, int lo,
                      int hi, bool vec) {
  int tail = lo;
  if (vec) {
    for (int c = (lo >> 4) + threadIdx.x; c < (hi >> 4); c += kThreads)
      cp_async16(ring + ((c << 4) & kRingMask), src + (c << 4));
    tail = max(lo, hi & ~15);
  }
  for (int q = tail + threadIdx.x; q < hi; q += kThreads)
    ring[q & kRingMask] = src[q];
}

// Ring bytes [lo, hi) out to `o` (lo % 16 == 0) by threads t of n.
__device__ void flush(uint8_t* o, const uint8_t* ring, int lo, int hi,
                      bool vec, int t, int n) {
  int tail = lo;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(ring);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int c = (lo >> 4) + t; c < (hi >> 4); c += n)
      o4[c] = r4[(c & (kRingMask >> 4))];
    tail = max(lo, hi & ~15);
  }
  for (int q = tail + t; q < hi; q += n) o[q] = ring[q & kRingMask];
}

// Write word value v at stream bytes [q0, q0 + 4), only those in [a, e).
__device__ __forceinline__ void put(uint8_t* ring, int q0, uint32_t v, int a,
                                    int e) {
  if (q0 >= a && q0 + 4 <= e) {
    *reinterpret_cast<uint32_t*>(ring + (q0 & kRingMask)) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q0 + j >= a && q0 + j < e)
        ring[(q0 + j) & kRingMask] = static_cast<uint8_t>(v >> (8 * j));
  }
}

// Four bytes of the ring from stream position s on (any alignment).
__device__ __forceinline__ uint32_t read4(const uint8_t* ring, int s) {
  const uint32_t* ring32 = reinterpret_cast<const uint32_t*>(ring);
  s &= kRingMask;
  return __funnelshift_r(ring32[s >> 2],
                         ring32[((s >> 2) + 1) & (kRingMask >> 2)],
                         8 * (s & 3));
}

// Sixteen bytes from two aligned ring chunks x, y starting W words and sh
// bits into x (W is the record's source offset in words, uniform).
template <int W>
__device__ __forceinline__ uint4 shift16(uint4 x, uint4 y, int sh) {
  const uint32_t in[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  return make_uint4(__funnelshift_r(in[W], in[W + 1], sh),
                    __funnelshift_r(in[W + 1], in[W + 2], sh),
                    __funnelshift_r(in[W + 2], in[W + 3], sh),
                    __funnelshift_r(in[W + 3], in[W + 4], sh));
}

// The aligned chunks [c0, c1) of a record with no self-overlap: chunk c is
// the 16 bytes from 16 c - d, two per thread and step, loads before stores.
template <int W>
__device__ void copy_chunks(uint8_t* ring, int c0, int c1, int d, int tid,
                            int nthr) {
  const uint4* r16 = reinterpret_cast<const uint4*>(ring);
  uint4* w16 = reinterpret_cast<uint4*>(ring);
  constexpr int kM16 = kRingMask >> 4;
  const int sh = 8 * ((-d) & 3);
  for (int c = c0 + tid; c < c1; c += 2 * nthr) {
    const int s0 = ((16 * c - d) & kRingMask) >> 4;
    const int s1 = ((16 * (c + nthr) - d) & kRingMask) >> 4;
    const uint4 x0 = r16[s0], y0 = r16[(s0 + 1) & kM16];
    const uint4 x1 = r16[s1], y1 = r16[(s1 + 1) & kM16];
    w16[c & kM16] = shift16<W>(x0, y0, sh);
    if (c + nthr < c1) w16[(c + nthr) & kM16] = shift16<W>(x1, y1, sh);
  }
}

// Record (a, d, e - a) with e - a <= d: out[q] = ring[q - d], its sources
// all before a.  Aligned 16-byte chunks inside, bytes at the two ends.
__device__ void copy_back(uint8_t* ring, int a, int d, int e, int tid,
                          int nthr) {
  const int c0 = (a + 15) >> 4, c1 = e >> 4;
  if (c0 >= c1) {
    for (int q = a + tid; q < e; q += nthr)
      ring[q & kRingMask] = ring[(q - d) & kRingMask];
    return;
  }
  // threads 0-15: bytes [a, 16 c0); threads 16-31: bytes [16 c1, e)
  const int q = tid < 16 ? a + tid : 16 * c1 + tid - 16;
  const bool edge = tid < 32 && q < (tid < 16 ? 16 * c0 : e);
  const uint8_t b = ring[(q - d) & kRingMask];
  switch (((-d) & 15) >> 2) {
    case 0: copy_chunks<0>(ring, c0, c1, d, tid, nthr); break;
    case 1: copy_chunks<1>(ring, c0, c1, d, tid, nthr); break;
    case 2: copy_chunks<2>(ring, c0, c1, d, tid, nthr); break;
    default: copy_chunks<3>(ring, c0, c1, d, tid, nthr); break;
  }
  if (edge) ring[q & kRingMask] = b;
}

// Record (a, d, e - a) over the ring by nthr threads (a multiple of 32):
// out[q] = out[a - d + (q - a) % d].  Thread t takes the aligned words t,
// t + nthr, ... from a & ~3, reading the sources of up to 4 words before
// storing them (sources lie before a, targets at or after it).
__device__ void run_record(uint8_t* ring, int a, int d, int e, int tid,
                           int nthr) {
  if (e - a <= d) {
    copy_back(ring, a, d, e, tid, nthr);
    return;
  }
  const int A = a & ~3;
  const int g = A - a;                    // -3 .. 0
  const int nw = (e - A + 3) >> 2;
  if (d <= 4 && (d & (d - 1)) == 0) {
    // d divides 4: every aligned word holds the same pattern; 16-byte
    // stores inside the record, words at its two ends
    uint32_t p = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p |= static_cast<uint32_t>(
               ring[(a - d + ((j - a) & (d - 1))) & kRingMask]) << (8 * j);
    const int c0 = (a + 15) >> 4, c1 = e >> 4;
    if (c0 < c1) {
      uint4* ring16 = reinterpret_cast<uint4*>(ring);
      for (int c = c0 + tid; c < c1; c += nthr)
        ring16[c & (kRingMask >> 4)] = make_uint4(p, p, p, p);
      // the words of [A, 16 c0) on threads 0-3, of [16 c1, e) on 4-7
      const int q0 = tid < 4 ? A + 4 * tid : 16 * c1 + 4 * (tid - 4);
      if (tid < 8 && q0 < (tid < 4 ? 16 * c0 : e)) put(ring, q0, p, a, e);
    } else {
      for (int w = tid; w < nw; w += nthr) put(ring, A + 4 * w, p, a, e);
    }
    return;
  }
  // mm = (4 w) % d for this thread's word w; 3 <= d < e - a from here.  A
  // word whose bytes wrap the period takes bytes k = d - m on from the
  // period before: x from s = a - d + m, y from s - d.
  int mm, step;
  if (d >= 4 * nthr) {
    mm = 4 * tid;
    step = 4 * nthr;
  } else {
    const float inv = __frcp_rn(static_cast<float>(d));
    mm = mod_small(4 * tid, d, inv);
    step = mod_small(4 * nthr, d, inv);
  }
  for (int w0 = tid; w0 < nw; w0 += 4 * nthr) {
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int m = mm + g;                     // (q0 - a) mod d
      if (m < 0) m += d;
      const uint32_t x = read4(ring, a - d + m);
      const uint32_t y = read4(ring, a - 2 * d + m);
      const int kx = d - m;
      const uint32_t keep = kx >= 4 ? 0xffffffffu : (1u << (8 * kx)) - 1;
      v[k] = (x & keep) | (y & ~keep);
      mm += step;
      if (mm >= d) mm -= d;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (w0 + k * nthr < nw) put(ring, A + 4 * (w0 + k * nthr), v[k], a, e);
  }
}

// The scheduler warp's state: the next record, the staged batch [sb, se)
// and whether the segment has run its last group.
struct Cursor {
  int r, sb, se;
  bool done;
};

// One phase's plan: kGroups groups of up to kWorkers records, run one group
// after another by the workers; in each group, worker warp w runs work[g][w]
// = (a, d, e, first thread | threads << 16), e <= a for none.
struct Plan {
  int4 work[kGroups][kWorkers];
  int groups;                             // 0: the segment is done
};
static_assert(sizeof(Plan) == (kGroups * kWorkers + 1) * sizeof(int4),
              "kSmemBytes counts a plan as whole int4s");

// The scheduler plans the next phase of segment [base, end) from the 32
// records from cur.r on.  A group is up to kWorkers consecutive records
// whose sources end at or before the group's first target, so no record of
// a group reads what another writes; its longest record takes the workers
// its k - 1 others leave, one warp each.  A record that reaches past `end`
// ends the segment's groups and runs the rest in the next segment.
__device__ void plan(const int32_t* __restrict__ recs, int re, int base,
                     int end, int4* rec, Cursor& cur, Plan* p) {
  const int lane = threadIdx.x & 31;
  int groups = 0;
  // a view of no-op records alone plans no group: look at the next one
  while (groups == 0 && !cur.done && cur.r < re) {
    if (cur.r + 32 > cur.se && cur.se < re) {
      cur.sb = cur.r;
      cur.se = min(re, cur.r + kBatch);
      stage(recs, cur.sb, cur.se - cur.sb, rec, lane, 32);
      __syncwarp();
    }
    const int n = min(32, cur.se - cur.r);    // records in view
    const int4 c = rec[min(cur.r + lane, cur.se - 1) - cur.sb];
    const bool act = c.z > 0;
    const int a = max(c.x, base), e = min(c.x + c.z, end);
    const int src_end = a - c.y + min(e - a, c.y);
    const unsigned cutm =
        __ballot_sync(0xffffffffu, lane < n && act && c.x + c.z > end);
    int s = 0;                            // the group's first record
    while (groups < kGroups && s < n) {
      const int as = __shfl_sync(0xffffffffu, a, s);
      const int xs = __shfl_sync(0xffffffffu, c.x, s);
      const bool acts = __shfl_sync(0xffffffffu, act, s);
      if (!acts) {                        // a no-op record
        ++s;
        continue;
      }
      if (xs >= end) {                    // it starts in a later segment
        cur.done = true;
        break;
      }
      const bool in = lane > s && lane < s + kWorkers && lane < n &&
                      (!act || (c.x < end && src_end <= as));
      const unsigned ok = (__ballot_sync(0xffffffffu, in) >> s) | 1u;
      const int lead = __ffs(~ok) - 1;    // records that may share the group
      const unsigned cuts = cutm >> s;
      const int kc = cuts ? __ffs(cuts) - 1 : kWorkers;
      const int k = min(lead, kc + 1);
      // the group's longest record takes the warps the others leave: worker
      // w < k - 1 runs the w-th other record
      const int len = act ? max(e - a, 0) : 0;
      const int top =
          __reduce_max_sync(0xffffffffu, lane >= s && lane < s + k
                                             ? len << 5 | (31 - lane) : 0);
      const int big = 31 - (top & 31);
      const int other = s + lane + (s + lane >= big);
      const int from = lane < k - 1 ? other : big;
      const int va = __shfl_sync(0xffffffffu, a, from);
      const int vd = __shfl_sync(0xffffffffu, c.y, from);
      const int ve = __shfl_sync(0xffffffffu, act ? e : a, from);
      if (lane < kWorkers)
        p->work[groups][lane] = make_int4(
            va, vd, ve,
            lane < k - 1 ? 32 << 16
                         : (lane - (k - 1)) * 32 | (8 - k) * 32 << 16);
      ++groups;
      if (kc < k) {                       // the cut record runs on next time
        s += k - 1;
        cur.done = true;
        break;
      }
      s += k;
    }
    cur.r += s;
  }
  if (lane == 0) p->groups = groups;
}

// The ring path, once the first segment's bytes are on their way.
__device__ void ring_path(const int32_t* __restrict__ recs, int rs, int re,
                          const uint8_t* __restrict__ src, uint8_t* o,
                          int Opad, bool vec, uint8_t* ring, int4* rec,
                          Plan* plans) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // well_formed left the stream's last batch staged: reuse it when it is
  // the only one
  Cursor cur{rs, rs, re - rs <= kBatch ? re : rs, false};
  int base = 0, end = min(kSeg, Opad), slot = 0;
  if (warp == kWorkers) plan(recs, re, base, end, rec, cur, plans);
  for (;;) {
    // the segment's bytes have landed, the last one's flush is done
    cp_async_wait_all();
    __syncthreads();
    const int next = Opad - end > kSeg ? end + kSeg : Opad;
    if (end < Opad) fetch(src, ring, end, next, vec);
    for (;; slot ^= 1) {
      const Plan* p = plans + slot;
      const int groups = p->groups;
      if (groups == 0) break;
      if (warp == kWorkers) {
        plan(recs, re, base, end, rec, cur, plans + (slot ^ 1));
      } else {
        for (int g = 0; g < groups; ++g) {
          const int4 v = p->work[g][warp];
          if (v.z > v.x)
            run_record(ring, v.x, v.y, v.z, (v.w & 0xffff) + lane,
                       v.w >> 16);
          // the workers alone order one group before the next
          if (g + 1 < groups)
            asm volatile("bar.sync 1, %0;" ::"n"(kWorkers * 32) : "memory");
        }
      }
      __syncthreads();
    }
    // the workers flush the segment while the scheduler plans the next
    // one's first phase, into the slot no warp reads again
    slot ^= 1;
    if (warp < kWorkers) {
      flush(o, ring, base, end, vec, threadIdx.x, kWorkers * 32);
    } else if (end < Opad) {
      cur.done = false;
      plan(recs, re, end, next, rec, cur, plans + slot);
    }
    if (end == Opad) break;
    base = end;
    end = next;
  }
}

__device__ void global_path(const int32_t* __restrict__ recs, int rs, int re,
                            const uint8_t* __restrict__ src, uint8_t* o,
                            int Opad) {
  const int t = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int i = t; i < (Opad >> 4); i += kThreads) o4[i] = s4[i];
    for (int i = (Opad & ~15) + t; i < Opad; i += kThreads) o[i] = src[i];
  } else {
    for (int i = t; i < Opad; i += kThreads) o[i] = src[i];
  }
  __syncthreads();
  for (int r = rs; r < re; ++r) {
    const long long pos = recs[3LL * r];
    const int d = recs[3LL * r + 1];
    const long long len = recs[3LL * r + 2];
    if (d >= 1) {
      // targets q = pos + i in [0, Opad) with 0 <= i < len; the rest are
      // dropped.  Valid records have 0 <= i < Opad, so the modulus is a
      // 32-bit one; only a hostile pos < 0 takes the 64-bit one.
      const long long q0 = max(pos, 0LL);
      const long long q1 = min(pos + len, static_cast<long long>(Opad));
      for (long long q = q0 + t; q < q1; q += kThreads) {
        const long long i = q - pos;
        const long long m =
            i < d ? i : (i <= INT32_MAX ? static_cast<int>(i) % d : i % d);
        const long long s = pos - d + m;
        o[q] = s >= 0 ? o[s] : 0;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    seqcopy_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ recs,
                   const uint8_t* __restrict__ lit, uint8_t* out, int Opad,
                   int nrec, int32_t* paths) {
  extern __shared__ uint4 smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);
  int4* rec = reinterpret_cast<int4*>(ring + kRing);
  Plan* plans = reinterpret_cast<Plan*>(rec + kBatch);
  int* scan = reinterpret_cast<int*>(plans + 2);
  const size_t row = static_cast<size_t>(blockIdx.x) * Opad;
  const int rs = min(max(starts[blockIdx.x], 0), nrec);
  const int re = min(max(starts[blockIdx.x + 1], rs), nrec);
  const bool vec = ((reinterpret_cast<uintptr_t>(lit + row) |
                     reinterpret_cast<uintptr_t>(out + row)) & 15) == 0;
  // an aligned first segment comes in while the records are checked
  if (vec) fetch(lit + row, ring, 0, min(kSeg, Opad), true);
  const bool ring_ok = well_formed(recs, rs, re, Opad, rec, scan);
  if (paths != nullptr && threadIdx.x == 0) paths[blockIdx.x] = ring_ok;
  if (ring_ok) {
    if (!vec) fetch(lit + row, ring, 0, min(kSeg, Opad), false);
    ring_path(recs, rs, re, lit + row, out + row, Opad, vec, ring, rec,
              plans);
  } else {
    cp_async_wait_all();
    global_path(recs, rs, re, lit + row, out + row, Opad);
  }
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Lets the kernel take kSmemBytes of dynamic shared memory on the current
// device (once per device and process).
static cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(seqcopy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

extern "C" int spt_resident_warps(int* warps) {
  cudaError_t err = allow_smem();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, seqcopy_kernel, kThreads, kSmemBytes);
  *warps = blocks * kWarps;
  return static_cast<int>(err);
}

// Launch K2 on `stream`: starts (B + 1,) i32, recs (nrec, 3) i32
// [stream-local pos, d, len], lit (B, Opad) u8 -> out (B, Opad) u8, and
// where `paths` is not null, paths (B,) i32: 1 for a stream that took the
// ring path, 0 for the global path.
extern "C" int spt_seqcopy(const void* starts, const void* recs,
                           const void* lit, void* out, int B, int Opad,
                           int nrec, void* paths, void* stream) {
  if (B <= 0 || Opad <= 0) return 0;
  if (nrec < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  seqcopy_kernel<<<B, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(recs),
      static_cast<const uint8_t*>(lit), static_cast<uint8_t*>(out), Opad,
      nrec, static_cast<int32_t*>(paths));
  return static_cast<int>(cudaGetLastError());
}
