// K1: lockstep DEFLATE token decode + byte stamp + Adler-32 partials.
//
// Replaces the Pallas kernel swift_png_tpu/ops/inflate_pallas.py
// (_make_kernel, launched by decode_stamp_pallas).  Each OB-byte output unit
// of each stream decodes its own tokens from its own span words, starting at
// the bit and byte its checkpoint index gives, so units are independent: one
// thread per unit.
//
// What bounds it: each thread's token loop is a serial chain (bit window,
// code-length search, symbol lookup, stamp), so the kernel is bound by the
// latency of that chain and by how many chains an SM keeps in flight, not by
// the bytes it moves (the 4-byte attr output is the largest term).  The
// design keeps the chain short and the SM full:
//
// * Tables by block.  The batch's canonical tables sit in a pool, one row
//   per DEFLATE block, and each unit carries one block id (two with
//   multiblock tables).  A warp's 32 consecutive units nearly always share a
//   block, so every table load is one address for the warp.  The literal/
//   length thresholds and adjust deltas of the unit's current block live in
//   registers (30 values, reloaded on the one block switch a unit may make),
//   so the literal decode reads no table but the packed symbol row.  (A
//   first-level table per block, 10 bits literal/length and 8 distance,
//   measured slower on the H100: its load takes 32 scattered addresses per
//   warp and sits on the chain, where the 15 compares take registers only.)
// * The distance code is decoded only after a length symbol.
// * A three-word register cache of the unit's span: a word is loaded once
//   as the cursor reaches it, not twice per window.
// * The Adler partials (s1 += d, s2 += (ob - b) * d) fold in at each owned
//   literal, and no stamp row is kept in shared memory: each thread writes
//   its row's bytes in order (covered bytes, then the uncovered tail, each
//   exactly once) through a 32-word staging row in shared memory that goes
//   out as eight 16-byte stores, a quarter of the store requests of one
//   4-byte store per byte.  18 KB per 128-thread block leaves the SM's
//   resident warps to the registers (the launch bounds ask for 16 at least).
//
// The TPU kernel's lane layout and one-hot selects do not carry over; its
// step budget does.  Each unit gets its 1,024-unit tile's (bound, mode)
// from the host (kbound, two int32 per unit), and counts steps as the TPU
// kernel's loops do: mode 0 one token a step; mode 2 one token a step, a
// literal that follows a literal or a match riding on the same step; mode 1
// (all-literal tiles) 8 * ((bound + 3) >> 2) literals, any other code bad and
// no coverage flag.  A valid unit ends at its coverage inside the budget;
// the budget decides how far a corrupt one runs, so the flags are the TPU
// kernel's.  Counting costs a compare and two flags per token.
//
// Output contract (the torch tail reads it as the JAX tail reads the
// kernel's): attr (U, ob) int32, flag (U,) int32 (1 bad code, 2 coverage
// short), s1 (U,) = sum d and s2 (U,) = sum (ob - b) * d over the unit's
// owned literal bytes, int64.  Bytes the unit does not stamp are -32768.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = -32768;
constexpr int kThreads = 128;
constexpr int kTabRows = 72;

__device__ __forceinline__ uint32_t word_at(const uint32_t* sp, int S, int i) {
  return (i >= 0 && i < S) ? __ldg(sp + i) : 0u;
}

// The unit's span words cq, cq + 1, cq + 2, held in registers.
struct SpanCache {
  const uint32_t* sp;
  int S;
  int cq;
  uint32_t c0, c1, c2;

  __device__ __forceinline__ void seek(int wq) {
    if (wq == cq) return;
    if (wq == cq + 1) {
      c0 = c1;
      c1 = c2;
      c2 = word_at(sp, S, wq + 2);
    } else if (wq == cq + 2) {
      c0 = c2;
      c1 = word_at(sp, S, wq + 1);
      c2 = word_at(sp, S, wq + 2);
    } else {
      c0 = word_at(sp, S, wq);
      c1 = word_at(sp, S, wq + 1);
      c2 = word_at(sp, S, wq + 2);
    }
    cq = wq;
  }

  // 32-bit little-endian bit window starting at bit `bit` of the span
  // (words outside the span read as zero).
  __device__ __forceinline__ uint32_t window(int bit) {
    seek(bit >> 5);
    const uint32_t sub = static_cast<uint32_t>(bit) & 31u;
    return (c0 >> sub) | (sub ? (c1 << (32u - sub)) : 0u);
  }
};

// Literal/length tree of one block in registers: thresholds lim[l] << (15-l)
// for l = 1..15 and the adjust adj[1] followed by its deltas adj[l] -
// adj[l-1] (int32, wrapping as the per-step sum of the reference does).
struct LitTree {
  int thr[15];
  int dlt[15];

  __device__ __forceinline__ void load(const int32_t* tb) {
#pragma unroll
    for (int t = 0; t < 15; ++t) thr[t] = __ldg(tb + 1 + t);
    int prev = __ldg(tb + 17);
    dlt[0] = prev;
#pragma unroll
    for (int t = 1; t < 15; ++t) {
      const int cur = __ldg(tb + 17 + t);
      dlt[t] = static_cast<int>(static_cast<uint32_t>(cur) -
                                static_cast<uint32_t>(prev));
      prev = cur;
    }
  }

  // Code length (16 = no code) and symbol-index adjust of the next code.
  __device__ __forceinline__ void decode(int r15, int& len, int& a) const {
    len = 1;
    a = dlt[0];
#pragma unroll
    for (int t = 1; t <= 15; ++t) {
      const bool ge = r15 >= thr[t - 1];
      len += ge;
      if (t < 15 && ge) a += dlt[t];
    }
  }
};

// The same search against a tree read from the pool (the distance tree).
__device__ __forceinline__ void canon(const int32_t* thr, const int32_t* adj,
                                      int r15, int& len, int& a) {
  len = 1;
  a = __ldg(adj);
#pragma unroll
  for (int t = 1; t <= 15; ++t) {
    const bool ge = r15 >= __ldg(thr + t - 1);
    len += ge;
    if (t < 15 && ge) a += __ldg(adj + t) - __ldg(adj + t - 1);
  }
}

__device__ __forceinline__ int rev15(uint32_t x) {
  return static_cast<int>(__brev(x & 0x7FFFu) >> 17);
}

constexpr int kStage = 36;  // words per thread's staging row (16-byte rows)

// Row writer: positions arrive in order, each once; every 32 of them go out
// as eight 16-byte stores (ob % 32 == 0 keeps each piece 16-byte aligned).
struct RowOut {
  int32_t* row;
  int32_t* st;

  __device__ __forceinline__ void put(int p, int v) {
    st[p & 31] = v;
    if ((p & 31) == 31) {
      const int4* s4 = reinterpret_cast<const int4*>(st);
      int4* d4 = reinterpret_cast<int4*>(row + (p & ~31));
#pragma unroll
      for (int j = 0; j < 8; ++j) d4[j] = s4[j];
    }
  }
};

__global__ void __launch_bounds__(kThreads, 4) decode_stamp_kernel(
    const uint32_t* __restrict__ spans, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ pool_t, const int32_t* __restrict__ pool_s,
    const int32_t* __restrict__ ids, const int32_t* __restrict__ kbound,
    int32_t* __restrict__ attr, int32_t* __restrict__ flag,
    long long* __restrict__ s1, long long* __restrict__ s2, int U, int S,
    int ob, int R, int multiblock) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  const int mrows = multiblock ? 4 : 3;
  const int32_t* m = meta + static_cast<size_t>(u) * mrows;
  const int sub0 = m[0], skip = m[1], owned = m[2];
  const int jumpv = multiblock ? m[3] : 0;
  const int kb = kbound[2 * static_cast<size_t>(u)];
  const int mode = kbound[2 * static_cast<size_t>(u) + 1];
  const bool lit_only = mode == 1, pair = mode == 2;
  const int steps = lit_only ? 8 * ((kb + 3) >> 2) : kb;
  const int id_a = ids[static_cast<size_t>(u) * (multiblock ? 2 : 1)];
  const int id_b = multiblock ? ids[static_cast<size_t>(u) * 2 + 1] : id_a;
  __shared__ __align__(16) int32_t stage_s[kThreads * kStage];
  RowOut out{attr + static_cast<size_t>(u) * ob,
             stage_s + threadIdx.x * kStage};

  SpanCache span{spans + static_cast<size_t>(u) * S, S, -4, 0u, 0u, 0u};
  const int32_t* tb = pool_t + static_cast<size_t>(id_a) * kTabRows;
  const int32_t* sy = pool_s + static_cast<size_t>(id_a) * R;
  LitTree lit;
  lit.load(tb);

  const int lim = min(owned, ob);
  long long a1 = 0, a2 = 0;
  int bitrel = sub0, cur = -skip, fl = 0;
  // a unit's tokens cover [-skip, cur): a negative skip leaves a head
  for (int p = 0; p < min(cur, ob); ++p) out.put(p, kSentinel);
  bool sw = false;  // switched to the next block's tables
  int taken = 0;      // steps of the budget taken
  bool free = false;  // a literal now rides on the step taken (mode 2)
  while (cur < owned) {
    const uint32_t win = span.window(bitrel);

    // literal/length code
    const int r15 = rev15(win);
    int l, adj;
    lit.decode(r15, l, adj);
    const bool lbad = l > 15;
    const int ls = min(l, 15);
    const int code = r15 >> (15 - ls);
    const int symidx = min(max(code + adj, 0), 3 * R - 1);
    const int q3 = symidx / 3, r3 = symidx - 3 * q3;
    const int sym = (__ldg(sy + q3) >> (10 * r3)) & 1023;
    const bool is_lit = !lbad && sym < 256;
    const bool is_eob = !lbad && sym == 256;
    const bool is_runtok = !lbad && sym >= 257 && sym <= 285;

    const bool rides = free && is_lit;
    free = false;
    if (!rides) {
      if (taken >= steps) break;
      ++taken;
    }
    if (is_lit) {
      if (cur >= 0 && cur < ob) {
        out.put(cur, -(sym + 1));
        if (cur < lim) {
          a1 += sym;
          a2 += static_cast<long long>(ob - cur) * sym;
        }
      }
      bitrel = static_cast<int>(static_cast<uint32_t>(bitrel) +
                                static_cast<uint32_t>(ls));
      cur += 1;
      free = pair && !rides;
      continue;
    }
    if (lit_only) {
      fl |= 1;
      break;
    }
    if (is_eob) {
      // boundary EOB: jump over the next block's header, switch tables
      // (once per unit; the index guarantees at most one crossing)
      if (!(multiblock && jumpv > 0 && !sw)) {
        fl |= 1;
        break;
      }
      bitrel = static_cast<int>(static_cast<uint32_t>(bitrel) +
                                static_cast<uint32_t>(ls + jumpv));
      sw = true;
      tb = pool_t + static_cast<size_t>(id_b) * kTabRows;
      sy = pool_s + static_cast<size_t>(id_b) * R;
      lit.load(tb);
      continue;
    }
    if (!is_runtok) {
      fl |= 1;
      break;
    }

    // length extra bits, then the distance code
    const int dec = min(max(sym - 257, 0), 28);
    const int e_run = (dec < 4 || dec == 28) ? 0 : (dec >> 2) - 1;
    const int rbase = dec < 4 ? dec + 3
                      : (dec == 28 ? 258 : ((4 + (dec & 3)) << e_run) + 3);
    const int run =
        rbase + static_cast<int>((win >> ls) & ((1u << e_run) - 1u));
    const uint32_t win2 = span.window(static_cast<int>(
        static_cast<uint32_t>(bitrel) + static_cast<uint32_t>(ls + e_run)));
    const int r15d = rev15(win2);
    int dl, dadj;
    canon(tb + 33, tb + 49, r15d, dl, dadj);
    const bool dbad = dl > 15;
    const int dls = min(dl, 15);
    const int dcode = r15d >> (15 - dls);
    const int didx = min(max(dcode + dadj, 0), 31);
    const uint32_t wd = static_cast<uint32_t>(__ldg(tb + 64 + (didx >> 2)));
    const int dsym = static_cast<int>((wd >> ((didx & 3) << 3)) & 255u);
    if (dbad || dsym > 29) {
      fl |= 1;
      break;
    }
    const int e_d = dsym < 4 ? 0 : (dsym >> 1) - 1;
    const int dbase = dsym < 4 ? dsym + 1 : ((2 + (dsym & 1)) << e_d) + 1;
    const int dist =
        dbase + static_cast<int>((win2 >> dls) & ((1u << e_d) - 1u));
    const int hi = min(cur + run, ob);
    for (int p = max(cur, 0); p < hi; ++p) out.put(p, dist - 1);
    // wrap like the reference's int32 cursor (a hostile jump must not be
    // undefined behaviour)
    bitrel = static_cast<int>(static_cast<uint32_t>(bitrel) +
                              static_cast<uint32_t>(ls + e_run + dls + e_d));
    cur += run;
    free = pair;
  }
  if (cur < owned && !lit_only) fl |= 2;
  // the covered bytes end at cur: the rest of the row is uncovered
  for (int p = min(max(cur, 0), ob); p < ob; ++p) out.put(p, kSentinel);
  flag[u] = fl;
  s1[u] = a1;
  s2[u] = a2;
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Warps of this kernel resident on one SM at its launch shape.
extern "C" int spt_resident_warps(int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, decode_stamp_kernel, kThreads, 0);
  *warps = blocks * (kThreads / 32);
  return static_cast<int>(err);
}

// Launch K1 on `stream`.  U units of S span words; ob output bytes per unit;
// pool_t (P, 72) and pool_s (P, R) int32 block tables; ids (U, 1|2) int32
// pool rows per unit; kbound (U, 2) int32 step budget and mode per unit;
// multiblock selects two ids and 4 meta columns.
// ob is a multiple of 32 (checkpoint indexes hold multiples of 64).
extern "C" int spt_decode_stamp(const void* spans, const void* meta,
                                const void* pool_t, const void* pool_s,
                                const void* ids, const void* kbound,
                                void* attr, void* flag, void* s1, void* s2,
                                int U, int S, int ob, int R, int multiblock,
                                void* stream) {
  if (U <= 0) return 0;
  if (ob <= 0 || ob % 32 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (U + kThreads - 1) / kThreads;
  decode_stamp_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(spans), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(pool_t), static_cast<const int32_t*>(pool_s),
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(kbound),
      static_cast<int32_t*>(attr), static_cast<int32_t*>(flag),
      static_cast<long long*>(s1), static_cast<long long*>(s2), U, S, ob, R,
      multiblock);
  return static_cast<int>(cudaGetLastError());
}
