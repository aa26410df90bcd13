// K1: lockstep DEFLATE token decode + byte stamp + Adler-32 partials.
//
// Replaces the Pallas kernel swift_png_tpu/ops/inflate_pallas.py
// (_make_kernel, launched by decode_stamp_pallas).  Each OB-byte output unit
// of each stream decodes its own tokens from its own span words and its own
// canonical tables, so units are independent: one thread per unit.
//
// What bounds it: each thread's token loop is serial and branchy (a bit
// window, 2 x 15 threshold compares, dependent table loads), so the kernel
// is bound by instruction latency, not by the bytes it moves (the 4-byte
// attr output is the largest term).  The design keeps the stamped row of
// each unit in shared memory as int16 (every attr value fits: -32768
// uncovered, -(sym+1) literal, dist-1 match), so the per-token stamps never
// touch device memory; the block then writes its rows out as int32 with
// coalesced stores.  Span words and tables are read through the read-only
// cache.  The TPU kernel's lane layout, one-hot selects, tile step bounds
// and tile modes do not carry over: each unit stops at its own bound.
//
// Output contract (the torch tail reads it as the JAX tail reads the
// kernel's): attr (U, ob) int32, flag (U,) int32 (1 bad code, 2 coverage
// short), s1 (U,) = sum d and s2 (U,) = sum (ob - b) * d over the unit's
// owned literal bytes, int64.  Bytes the unit does not stamp stay -32768.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = -32768;

__device__ __forceinline__ uint32_t word_at(const uint32_t* sp, int S, int i) {
  return (i >= 0 && i < S) ? __ldg(sp + i) : 0u;
}

// 32-bit little-endian bit window starting at bit `bit` of the unit's span
// (words outside the span read as zero).
__device__ __forceinline__ uint32_t window32(const uint32_t* sp, int S,
                                             int bit) {
  const int wq = bit >> 5;
  const uint32_t sub = static_cast<uint32_t>(bit) & 31u;
  const uint32_t w0 = word_at(sp, S, wq);
  const uint32_t w1 = word_at(sp, S, wq + 1);
  return (w0 >> sub) | (sub ? (w1 << (32u - sub)) : 0u);
}

// Canonical decode of the next code: `thr` holds the thresholds
// lim[l] << (15 - l) for l = 1..15 and `adj` the offsets offset[l] - first[l].
// Returns the code length (16 = no code) and the symbol-index adjust,
// accumulated as the TPU kernel does (adj[0] plus the deltas below l).
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

__global__ void decode_stamp_kernel(
    const uint32_t* __restrict__ spans, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ tabs, const int32_t* __restrict__ symtab,
    const int32_t* __restrict__ kbound, int32_t* __restrict__ attr,
    int32_t* __restrict__ flag, long long* __restrict__ s1,
    long long* __restrict__ s2, int U, int S, int ob, int R, int multiblock,
    int stride) {
  extern __shared__ int16_t rows[];
  const int u0 = blockIdx.x * blockDim.x;
  const int nrows = min(static_cast<int>(blockDim.x), U - u0);
  for (int i = threadIdx.x; i < nrows * stride; i += blockDim.x)
    rows[i] = static_cast<int16_t>(kSentinel);
  __syncthreads();

  const int u = u0 + threadIdx.x;
  if (u < U) {
    int16_t* row = rows + threadIdx.x * stride;
    const int mrows = multiblock ? 4 : 3;
    const int trows = multiblock ? 144 : 72;
    const int srows = multiblock ? 2 * R : R;
    const int32_t* m = meta + static_cast<size_t>(u) * mrows;
    const int sub0 = m[0], skip = m[1], owned = m[2];
    const int jumpv = multiblock ? m[3] : 0;
    const int kb = kbound[u];
    const uint32_t* sp = spans + static_cast<size_t>(u) * S;
    const int32_t* tab0 = tabs + static_cast<size_t>(u) * trows;
    const int32_t* sym0 = symtab + static_cast<size_t>(u) * srows;

    int bitrel = sub0, cur = -skip, fl = 0;
    bool sw = false;  // switched to the next block's tables
    for (int k = 0; k < kb && cur < owned; ++k) {
      const int32_t* tb = tab0 + (sw ? 72 : 0);
      const int32_t* sy = sym0 + (sw ? R : 0);
      const uint32_t win = window32(sp, S, bitrel);

      // literal/length code
      const int r15 = rev15(win);
      int l, adj;
      canon(tb + 1, tb + 17, r15, l, adj);
      const bool lbad = l > 15;
      const int ls = min(l, 15);
      const int code = r15 >> (15 - ls);
      const int symidx = min(max(code + adj, 0), 3 * R - 1);
      const int q3 = symidx / 3, r3 = symidx - 3 * q3;
      const int sym = (__ldg(sy + q3) >> (10 * r3)) & 1023;
      const int dec = min(max(sym - 257, 0), 28);
      const int e_run = (dec < 4 || dec == 28) ? 0 : (dec >> 2) - 1;
      const int rbase = dec < 4 ? dec + 3
                        : (dec == 28 ? 258 : ((4 + (dec & 3)) << e_run) + 3);
      const int run =
          rbase + static_cast<int>((win >> ls) & ((1u << e_run) - 1u));
      const bool is_lit = !lbad && sym < 256;
      const bool is_eob = !lbad && sym == 256;
      const bool is_runtok = !lbad && sym >= 257 && sym <= 285;

      // distance code (read for every token, used for matches only)
      const uint32_t win2 = window32(sp, S, bitrel + ls + e_run);
      const int r15d = rev15(win2);
      int dl, dadj;
      canon(tb + 33, tb + 49, r15d, dl, dadj);
      const bool dbad = dl > 15;
      const int dls = min(dl, 15);
      const int dcode = r15d >> (15 - dls);
      const int didx = min(max(dcode + dadj, 0), 31);
      const uint32_t wd = static_cast<uint32_t>(__ldg(tb + 64 + (didx >> 2)));
      const int dsym = static_cast<int>((wd >> ((didx & 3) << 3)) & 255u);
      const int ds = min(dsym, 29);
      const int e_d = ds < 4 ? 0 : (ds >> 1) - 1;
      const int dbase = ds < 4 ? ds + 1 : ((2 + (ds & 1)) << e_d) + 1;
      const int dist =
          dbase + static_cast<int>((win2 >> dls) & ((1u << e_d) - 1u));
      const bool is_match = is_runtok && !dbad && dsym <= 29;

      // boundary EOB: jump over the next block's header, switch tables
      // (once per unit; the index guarantees at most one crossing)
      const bool may_jump = multiblock && is_eob && jumpv > 0 && !sw;
      const bool bad = lbad || (is_eob && !may_jump) ||
                       (!is_lit && !is_eob && !is_runtok) ||
                       (is_runtok && !is_match);
      if (bad) {
        fl |= 1;
        break;
      }
      const int tl = is_lit ? 1 : (is_match ? run : 0);
      const int16_t aux = static_cast<int16_t>(is_lit ? -(sym + 1) : dist - 1);
      const int hi = min(cur + tl, ob);
      for (int p = max(cur, 0); p < hi; ++p) row[p] = aux;
      int step = is_lit ? ls : ls + e_run + dls + e_d;
      if (may_jump) {
        step = ls + jumpv;
        sw = true;
      }
      // wrap like the reference's int32 cursor (a hostile jump must not
      // be undefined behaviour)
      bitrel = static_cast<int>(static_cast<uint32_t>(bitrel) +
                                static_cast<uint32_t>(step));
      cur += tl;
    }
    if (cur < owned) fl |= 2;

    long long a1 = 0, a2 = 0;
    const int lim = min(owned, ob);
    for (int b = 0; b < lim; ++b) {
      const int a = row[b];
      if (a < 0 && a != kSentinel) {
        const int d = -a - 1;
        a1 += d;
        a2 += static_cast<long long>(ob - b) * d;
      }
    }
    flag[u] = fl;
    s1[u] = a1;
    s2[u] = a2;
  }
  __syncthreads();

  // coalesced write-out of the block's rows
  for (int r = 0; r < nrows; ++r) {
    const int16_t* row = rows + r * stride;
    int32_t* dst = attr + static_cast<size_t>(u0 + r) * ob;
    for (int c = threadIdx.x; c < ob; c += blockDim.x) dst[c] = row[c];
  }
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K1 on `stream`.  U units of S span words; ob output bytes per unit;
// R packed literal-symbol rows per table; multiblock selects the
// two-column tables (meta has 4 columns, tabs 144, symtab 2R).
extern "C" int spt_decode_stamp(const void* spans, const void* meta,
                                const void* tabs, const void* symtab,
                                const void* kbound, void* attr, void* flag,
                                void* s1, void* s2, int U, int S, int ob,
                                int R, int multiblock, void* stream) {
  if (U <= 0) return 0;
  // shared-memory row stride in int16 (even keeps rows 4-byte aligned; the
  // +2 staggers rows across banks)
  const int stride = ob + 2;
  int threads = (75 * 1024) / (2 * stride);
  if (threads > 128) threads = 128;
  if (threads >= 32) threads -= threads % 32;
  if (threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(threads) * stride * sizeof(int16_t);
  cudaError_t err = cudaFuncSetAttribute(
      decode_stamp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (U + threads - 1) / threads;
  decode_stamp_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(spans), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(tabs), static_cast<const int32_t*>(symtab),
      static_cast<const int32_t*>(kbound), static_cast<int32_t*>(attr),
      static_cast<int32_t*>(flag), static_cast<long long*>(s1),
      static_cast<long long*>(s2), U, S, ob, R, multiblock, stride);
  return static_cast<int>(cudaGetLastError());
}
