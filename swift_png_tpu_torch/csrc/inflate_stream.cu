// The general DEFLATE inflate, one whole stream per block of one warp.
//
// Replaces no TPU kernel.  The JAX package's fused inflate
// (swift_png_tpu/ops/inflate_fused.py) is XLA code: a while loop over the
// blocks, each decoded position-parallel.  The port ran the same loop on
// the host as torch ops (ops/inflate_fused.py::_inflate, about 600 ops a
// Huffman block), so the card idled while the host issued them.  This
// kernel runs the loop on the card: block header, stored copy, the dynamic
// header's code-length code and tables, token decode and the output bytes,
// serially through a stream's blocks, one stream per CTA.
//
// Exactness.  For every stream it gives what _inflate gives at the budget
// its caller names (status, end bit, block count, and the output bytes, a
// failed stream's included); InflateFused.run on the card passes the first
// budget of its retry loop and the last, and gets the result of the loop
// without rerunning the stream:
//
// * A Huffman block's outcome depends on the budget (window bytes W, token
//   ranks T) only through whether the block fits it: its path, decoded at
//   the largest budget named, needs ranks T_need (the terminal rank + 1)
//   and bits N_need (the last position its window check reads); it fits
//   (W, T) when N_need < 8W - 56 and T_need <= T.  A block that fits gives
//   the same tokens and flags at every budget; one that does not gives
//   F_OVERFLOW, no tokens, and the end of its first token.  So the stream
//   at (W, T) is the unbounded run cut at its first block that does not
//   fit, and it overflows at (W, T) when a block does not fit or the token
//   cap overflowed.  The kernel keeps the stream's largest needs and the
//   state at its first block that does not fit the last budget, and at the
//   end picks the run the retry loop stops at (the unbounded one when it
//   fits the last budget, or the first and no token cap overflowed; else
//   the cut one).  The needs go back to the caller, which counts the
//   retries from them.
// * Tables and bad codes follow _parse_dynamic, _canonical_params and
//   _canonical_decode, over-subscribed and incomplete codes included: the
//   code length of a window is the first l with (code_l < lim[l]), lim from
//   the counts as there; a code-length 16 repeats the last value that was
//   not a 16 (0 after a 17/18 run), and a 16 with none before it writes -1,
//   an unused length; a dynamic block with a bad header still decodes with
//   the tables it built and keeps its tokens.
// * F_BAD_DISTANCE and F_OUTPUT_MISMATCH are judged after the block loop
//   over every token kept, as _inflate's assembly judges them: a match
//   whose distance passes its start before out_size, or no token with
//   bytes when out_size > 0; the int32 sum of the lengths against out_size.
//   A bad distance does not stop a stream.  Bytes past out_size are counted
//   and not written.  A row reads as _inflate reads it: n bytes, a window
//   or a word at the end clamped into the row as lax.dynamic_slice and
//   JAX's gathers clamp them (for InflateFused, n is the retry loop's
//   zero-padded bucket).
// * A failed stream's bytes are the assembly's over the tokens kept: a
//   match's byte before byte 0 reads byte 0, and the bytes from the tokens'
//   end to out_size run the last token with bytes on (a literal repeated, a
//   match's period, a stored block's row bytes), or the first token where
//   none has bytes.  The fast first pass cannot give them (it writes the
//   bytes of a block it then drops, and skips a match before byte 0), so a
//   failed stream takes a second pass over its kept blocks, token by token.
// * The one difference: the plain path wraps the running start of a token
//   in int32, which changes which token owns a byte only when a stream's
//   tokens hold 2^31 bytes or more; the kernel counts starts in 64 bits.
//
// Design.  One warp per stream, every lane running the same decode: the
// table reads are broadcasts and the reader's words one load, so no lane
// waits on another for a token.  The output's last 64 KB live in a ring in
// shared memory: a literal is one shared store, a match's bytes are copied
// there by the warp (byte k reads q - d + k % d, before the match's start
// q, so no byte waits on another; __syncwarp orders them against the
// stores before), and the ring leaves for the output row 16 KB at a time,
// 16 bytes a lane.  Tables live in shared memory, built by the warp for
// each Huffman block: a 10-bit primary table per alphabet whose entries
// carry the run's and the distance's base and extra bits, the canonical
// limits for codes of 11 to 15 bits, and a 12-bit table of literal pairs
// (two literals whose codes fit 12 bits).  The hot loop (fast_run, not
// inlined, every value in registers) takes two pair lookups between
// branches and handles a match or a long literal code where a lookup finds
// none; its limits (ranks, ring room, window, the input ring's next half)
// are counted down in 32 bits and checked once a step, so that any token
// near a limit, the end-of-block code and every bad code go through the
// exact per-token path.  The compressed bytes pass through a 2 KB ring in
// shared memory, a half staged by cp.async while the other is read, and a
// refill is branch-free, from a word loaded a refill ahead.
//
// What bounds it: the serial chain of one stream's tokens, a shared-memory
// lookup and the shifts after it, about 68 cycles a lookup with nothing
// else (measured on the card) and 20 more for each branch on its result:
// about 90 cycles a literal and a few hundred a match.  A 512x512
// photograph's stream (about 0.8 MB, 0.68 M literals and 0.11 M matches)
// takes about 65 ms on one SM (H100).  Bytes do not bound it: a stream
// moves its compressed bytes in and its output out once, under a
// microsecond at the card's 3.35 TB/s.  B streams take B of the card's 132
// SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                // one warp per stream
constexpr int64_t kNever = INT64_MAX / 4; // the need of a path no budget ends
constexpr int kInfo = 8;                  // int64 words of results per stream
constexpr int kRing = 1 << 16;            // output ring in shared memory
constexpr int kRingMask = kRing - 1;
constexpr int kChunk = 1 << 14;           // ring bytes written out at once
static_assert(kRing - kChunk >= 32768 + 258 + 16, "a match's sources must "
              "stay in the ring while it is written");
constexpr int kPair = 12;                 // bits of the literal-pair table
constexpr int kIn = 512;                  // input ring, 32-bit words
constexpr int kInMask = kIn - 1;
constexpr int kHalf = kIn / 2;            // input words staged at once

enum : int64_t {
  F_BAD_BLOCK = 1, F_BAD_CODE = 2, F_OVERFLOW = 4, F_TOO_MANY_BLOCKS = 8,
  F_OUTPUT_MISMATCH = 16, F_BAD_PARITY = 32, F_BAD_DISTANCE = 64
};

__constant__ uint16_t kRunBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
    67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kRunExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
    5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
    769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
__constant__ uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13};
__constant__ uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4,
                                   12, 3, 13, 2, 14, 1, 15};

enum Kind { kLit, kDist, kMeta };

// A table entry: symbol | length << 9, and for the literal/length alphabet
// the run's extra bits << 13 and base << 16, for the distances the extra
// bits << 13 and base << 17 (of the symbol clamped to 29, as the plain
// path clamps it).  Literals carry no more than symbol and length.
template <Kind K>
__device__ __forceinline__ uint32_t entry(int len, int sym) {
  uint32_t e = static_cast<uint32_t>(sym | len << 9);
  if (K == kLit && sym >= 257) {
    const int d = sym - 257 < 28 ? sym - 257 : 28;
    e |= static_cast<uint32_t>(kRunExtra[d]) << 13 |
         static_cast<uint32_t>(kRunBase[d]) << 16;
  } else if (K == kDist) {
    const int d = sym < 29 ? sym : 29;
    e |= static_cast<uint32_t>(kDistExtra[d]) << 13 |
         static_cast<uint32_t>(kDistBase[d]) << 17;
  }
  return e;
}

// What a table gives where no code matches: a length of 0, and for the
// distances symbol 0 (the plain path decodes (0, 0) there).  In the primary
// table of the two Huffman alphabets it also marks a code longer than PB
// bits; the distance one marks that with 0, which no entry is.
template <Kind K>
__device__ __forceinline__ uint32_t none() {
  return K == kLit ? 511u : K == kDist ? entry<kDist>(0, 0) : 0u;
}

// Canonical decode tables of N symbols.  prim[x] for the next PB stream
// bits x (LSB first): the entry of the code they start, or the marker of a
// longer one (511 for literals and lengths, 0 for distances and the
// code-length code, whose codes never pass PB).  lim[l] = first[l] +
// count[l]; sym[base[l] + code] is the symbol of the l-bit code `code`
// (MSB first).
template <Kind K, int N, int PB>
struct Table {
  uint32_t prim[1 << PB];
  int32_t lim[16];
  int32_t base[16];
  uint16_t sym[N];
};

struct Smem {
  Table<kLit, 288, 10> lit;
  Table<kDist, 32, 10> dist;
  Table<kMeta, 19, 7> meta;
  int8_t lens[320];        // the code lengths a dynamic header transmits
  int16_t rank[288];       // a symbol's rank among those of its length
  int32_t count[16];
  int32_t offset[16];
  uint32_t in[kIn];        // the fast run's input ring
  // for the next kPair stream bits: up to two literals whose codes fit them
  // (byte 0 and 1), their count << 26, their bits << 28; where the first
  // code is no literal of at most 10 bits, its sm.lit.prim entry (which
  // leaves bits 25-31 clear)
  uint32_t pair[1 << kPair];
};

// A stream's tables (one stream per block) and its output ring.
__shared__ Smem sm;
extern __shared__ uint4 ring_mem[];

__device__ __forceinline__ uint8_t* ring_bytes() {
  return reinterpret_cast<uint8_t*>(ring_mem);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The tables of code lengths len(s), s < N (a length <= 0: no code).
template <Kind K, int N, int PB, class Len>
__device__ void build(Table<K, N, PB>& t, Smem& sm, int lane, Len len) {
  for (int l = lane; l < 16; l += kLanes) sm.count[l] = 0;
  __syncwarp();
  for (int c = 0; c < N; c += kLanes) {
    const int s = c + lane;
    const int L = s < N ? len(s) : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, L);
    const int r = __popc(peers & lanes_below(lane));
    const int before = sm.count[L];
    __syncwarp();
    if (s < N) sm.rank[s] = static_cast<int16_t>(before + r);
    if (r == 0) sm.count[L] = before + __popc(peers);
    __syncwarp();
  }
  if (lane == 0) {
    int32_t first = 0, offset = 0;
    t.lim[0] = 0;
    t.base[0] = 0;
    sm.offset[0] = 0;
    for (int l = 1; l < 16; ++l) {
      const int32_t c = sm.count[l];
      t.lim[l] = first + c;
      t.base[l] = offset - first;
      sm.offset[l] = offset;
      offset += c;
      first = (first + c) << 1;
    }
  }
  __syncwarp();
  for (int s = lane; s < N; s += kLanes) {
    const int L = len(s);
    if (L > 0) t.sym[sm.offset[L] + sm.rank[s]] = static_cast<uint16_t>(s);
  }
  __syncwarp();
  for (int x = lane; x < (1 << PB); x += kLanes) {
    const uint32_t v = __brev(static_cast<uint32_t>(x)) >> (32 - PB);
    uint32_t e = K == kLit ? 511u : 0u;
    for (int l = 1; l <= PB; ++l) {
      const uint32_t code = v >> (PB - l);
      if (code < static_cast<uint32_t>(t.lim[l])) {
        e = entry<K>(l, t.sym[t.base[l] + code]);
        break;
      }
    }
    t.prim[x] = e;
  }
  __syncwarp();
}

// sm.pair from sm.lit.
__device__ void build_pairs(int lane) {
  for (int x = lane; x < (1 << kPair); x += kLanes) {
    const uint32_t e1 = sm.lit.prim[x & 1023];
    uint32_t t = e1;
    if (!(e1 & 256)) {
      const int l1 = static_cast<int>((e1 >> 9) & 15);
      const uint32_t e2 = sm.lit.prim[(x >> l1) & 1023];
      const int l2 = static_cast<int>((e2 >> 9) & 15);
      t = (e2 & 256) || l1 + l2 > kPair
              ? (e1 & 255) | 1u << 26 | static_cast<uint32_t>(l1) << 28
              : (e1 & 255) | (e2 & 255) << 8 | 2u << 26 |
                    static_cast<uint32_t>(l1 + l2) << 28;
    }
    sm.pair[x] = t;
  }
  __syncwarp();
}

// The entry of the code at the next 15 stream bits (of the two Huffman
// alphabets), none<K>() if no code matches.
template <Kind K, int N, int PB>
__device__ __forceinline__ uint32_t decode(const Table<K, N, PB>& t,
                                           uint32_t bits) {
  const uint32_t e = t.prim[bits & ((1u << PB) - 1)];
  if (e != (K == kLit ? 511u : 0u)) return e;
  const uint32_t v = __brev(bits) >> 17;    // 15 bits, MSB first
  for (int l = PB + 1; l <= 15; ++l) {
    const uint32_t code = v >> (15 - l);
    if (code < static_cast<uint32_t>(t.lim[l]))
      return entry<K>(l, t.sym[t.base[l] + code]);
  }
  return none<K>();
}

// 64 stream bits in registers and the next 32-bit word loaded ahead.
struct Bits {
  const uint32_t* __restrict__ w;
  int64_t nw;               // words in the row; the rest reads as 0
  int64_t wi;               // the word `pf` holds
  uint64_t bb;
  int nb;                   // valid bits in bb
  uint32_t pf;

  __device__ __forceinline__ uint32_t load(int64_t i) const {
    return i < nw ? __ldg(w + i) : 0u;
  }
  __device__ __forceinline__ void seek(int64_t pos) {
    wi = pos >> 5;
    const int sh = static_cast<int>(pos & 31);
    bb = (static_cast<uint64_t>(load(wi)) |
          static_cast<uint64_t>(load(wi + 1)) << 32) >> sh;
    nb = 64 - sh;
    wi += 2;
    pf = load(wi);
  }
  // at least 32 valid bits after it
  __device__ __forceinline__ void fill() {
    if (nb <= 32) refill();
  }
  __device__ __forceinline__ int64_t pos() const { return wi * 32 - nb; }
  __device__ __forceinline__ void refill() {
    bb |= static_cast<uint64_t>(pf) << nb;
    nb += 32;
    pf = load(++wi);
  }
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(bb);
  }
  __device__ __forceinline__ void skip(int n) {
    bb >>= n;
    nb -= n;
  }
};

// The kinds of token the plain path keeps.
enum Tok : int { kLitTok, kMatchTok, kStoredTok };

// What the stream's output holds so far: the bytes of the tokens kept, the
// assembly's two judgements over them, and the token whose bytes the
// assembly runs on past the last one (the last token with bytes, else the
// first token): its kind, start and literal, distance or stored bytes'
// first row byte.  Only the exact per-token path and the stored copy keep
// `last`; the second pass (see the kernel) runs them alone.
struct Out {
  int64_t o;                // bytes of the tokens so far (64-bit starts)
  bool any;                 // a token with bytes
  bool bad_dist;            // a match reaching before byte 0, below out_size
  int last;                 // Tok
  int64_t last_start, last_arg;
};

// The output's last kRing bytes, in shared memory, written out to the
// stream's row kChunk bytes at a time, 16 bytes a lane (only bytes below
// out_size leave).  Byte q sits at buf[q & kRingMask]; bytes from `out` on
// have not left yet.
struct Ring {
  uint8_t* __restrict__ buf;
  uint8_t* __restrict__ dst;
  int64_t O;
  int64_t out;              // a multiple of kChunk until the last write-out

  __device__ void write_out(int64_t end, int lane) {
    __syncwarp();
    const int64_t stop = end < O ? end : O;
    const int64_t whole = out + ((stop - out) & ~int64_t{15});
    for (int64_t q = out + 16 * lane; q < whole; q += 16 * kLanes)
      *reinterpret_cast<uint4*>(dst + q) =
          *reinterpret_cast<const uint4*>(buf + (q & kRingMask));
    for (int64_t q = whole + lane; q < stop; q += kLanes)
      dst[q] = buf[q & kRingMask];
    out = end;
    __syncwarp();
  }
  // room to write bytes up to `end`, the last 32 KB before it kept
  __device__ __forceinline__ void reserve(int64_t end, int lane) {
    while (end > out + kRing) write_out(out + kChunk, lane);
  }
};

// A Huffman block's path.
struct Path {
  bool eob;                 // ended at an end-of-block code
  bool bad;                 // ended at a bad code (kind 3)
  int64_t tokens;           // tokens before the end-of-block code
  int64_t end;              // bit after the end-of-block code
  int64_t first_end;        // bit after the first token
  int64_t need_bits;        // the last window position the path checks
  int64_t need_ranks;       // ranks the path needs
};

// A stream's row as _inflate reads it: `n` bytes (past `stride`, the
// bytes held in memory, they read as 0), where a 32-bit word at byte k
// reads at min(k, n - 4) and a byte at min(i, n - 1).
struct Row {
  const uint8_t* __restrict__ src;
  int64_t stride;
  int64_t n;

  __device__ __forceinline__ uint32_t raw(int64_t i) const {
    return static_cast<uint64_t>(i) < static_cast<uint64_t>(stride) ? src[i]
                                                                    : 0u;
  }
  __device__ __forceinline__ uint8_t byte_at(int64_t i) const {
    return static_cast<uint8_t>(raw(i < n - 1 ? i : n - 1));
  }
  // the bits from bit `pos` on (at least 25 of them)
  __device__ __forceinline__ uint32_t bits_at(int64_t pos) const {
    int64_t k = pos >> 3;
    if (k > n - 4) k = n - 4;
    const uint32_t w = raw(k) | raw(k + 1) << 8 | raw(k + 2) << 16 |
                       raw(k + 3) << 24;
    return w >> (pos & 7);
  }
  // the bit a window of `size` bytes for bit `pos` starts at
  // (lax.dynamic_slice keeps the window inside the row)
  __device__ __forceinline__ int64_t window(int64_t pos, int64_t size) const {
    int64_t s = pos >> 3;
    if (s > n - 3 - size) s = n - 3 - size;
    return 8 * (s > 0 ? s : 0);
  }
};

// Shared memory by a 32-bit address held in a register: a loop that
// reaches the ring and the tables through these keeps their base addresses
// (the compiler otherwise derives a shared window's base again at every
// access through a generic pointer).
#ifdef __CUDA_ARCH__
using saddr = uint32_t;
__device__ __forceinline__ saddr smem_addr(const void* p) {
  saddr a = static_cast<saddr>(__cvta_generic_to_shared(p));
  asm volatile("" : "+r"(a));
  return a;
}
__device__ __forceinline__ uint32_t lds_u32(saddr a) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds_u8(saddr a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts_u8(saddr a, uint32_t v) {
  asm volatile("st.shared.u8 [%0], %1;" : : "r"(a), "r"(v) : "memory");
}
// 4 bytes from device memory into shared memory without waiting, or 0 in
// place of them where `valid` is false
__device__ __forceinline__ void cp_async4(saddr a, const uint32_t* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               : : "r"(a), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" : : : "memory");
}
#else
using saddr = uintptr_t;
__device__ __forceinline__ saddr smem_addr(const void* p) {
  return reinterpret_cast<saddr>(p);
}
__device__ __forceinline__ uint32_t lds_u32(saddr a) {
  return *reinterpret_cast<const uint32_t*>(a);
}
__device__ __forceinline__ uint32_t lds_u8(saddr a) {
  return *reinterpret_cast<const uint8_t*>(a);
}
__device__ __forceinline__ void sts_u8(saddr a, uint32_t v) {
  *reinterpret_cast<uint8_t*>(a) = static_cast<uint8_t>(v);
}
__device__ __forceinline__ void cp_async4(saddr a, const uint32_t* src,
                                          bool valid) {
  *reinterpret_cast<uint32_t*>(a) = valid ? *src : 0u;
}
__device__ __forceinline__ void cp_async_wait() {}
#endif

__device__ __forceinline__ int32_t clamp30(int64_t v) {
  return v < (1 << 30) ? static_cast<int32_t>(v) : (1 << 30);
}

// A match's bytes into the ring at `ring`: byte k of `run` at q reads
// q - dist + k % dist, before q, so no byte waits on another.
__device__ __forceinline__ void copy_match(saddr ring, uint32_t q,
                                           uint32_t dist, int run, int lane) {
  __syncwarp();
  if (run <= kLanes && run <= static_cast<int>(dist)) {
    if (lane < run)
      sts_u8(ring + ((q + lane) & kRingMask),
             lds_u8(ring + ((q + lane - dist) & kRingMask)));
  } else if (run <= static_cast<int>(dist)) {
    for (int k = lane; k < run; k += kLanes)
      sts_u8(ring + ((q + k) & kRingMask),
             lds_u8(ring + ((q + k - dist) & kRingMask)));
  } else {
    // k % dist, k by 32, through a float reciprocal: exact, as k and dist
    // are far below 2^12
    const float inv = __frcp_rn(static_cast<float>(dist));
    uint32_t m = lane - dist * __float2uint_rz((lane + 0.5f) * inv);
    const uint32_t step = kLanes - dist * __float2uint_rz((kLanes + 0.5f) *
                                                          inv);
    for (int k = lane; k < run; k += kLanes) {
      sts_u8(ring + ((q + k) & kRingMask),
             lds_u8(ring + ((q - dist + m) & kRingMask)));
      m += step;
      if (m >= dist) m -= dist;
    }
  }
}

// `n` bytes of a match at q of distance `dist` as _inflate's assembly gives
// them when the match may reach before byte 0: byte k reads q - dist +
// k % dist, and a byte before byte 0 reads byte 0 (0 while q is 0: the
// assembly clamps the pointer to byte 0, which then points at itself).
// Every source lies before q and at most 32 KB before it, and n is at most
// kChunk, so no byte overwrites a source.
__device__ void copy_clamped(uint8_t* buf, int64_t q, int64_t dist, int64_t n,
                             int lane) {
  __syncwarp();
  const uint8_t v0 = q > 0 ? buf[0] : 0;
  for (int64_t k = lane; k < n; k += kLanes) {
    const int64_t src = q - dist + k % dist;
    buf[(q + k) & kRingMask] = src < 0 ? v0 : buf[src & kRingMask];
  }
  __syncwarp();
}

// A fast run's reader and limits going in, its counts coming out; every
// lane holds the same.
struct FastRun {
  uint64_t bb;
  const uint32_t* w;
  int64_t nw, wi;
  int32_t nb;
  uint32_t pf;
  uint32_t q;               // ring position of the next byte
  int32_t before;           // bytes before the run, at most 2^20
  int32_t room, ranks, words;
  int32_t tokens, bytes;
  bool bad_dist;
};
__shared__ FastRun fr;

// Input words [first, first + n) of the row into the input ring (0 past
// the row), one word a lane at a time, without waiting.
__device__ __forceinline__ void stage(saddr in, int64_t first, int n,
                                      int lane) {
  for (int k = lane; k < n; k += kLanes) {
    const int64_t i = first + k;
    cp_async4(in + 4 * (static_cast<uint32_t>(i) & kInMask),
              fr.w + (i < fr.nw ? i : 0), i < fr.nw);
  }
}

// Literals and matches decoded with their checks made for the whole run:
// at most fr.ranks tokens, fr.room bytes before the last one (which then
// fits: a match is at most 258 bytes), and fr.words reader refills (two a
// token at most, all below the window's end).  It stops before an
// end-of-block code, a bad code, or a limit, the reader left at that
// token; a match that reaches before byte 0 (fr.before + bytes so far) is
// only marked, as the plain path marks it.  The input passes through a
// ring in shared memory, staged half a ring ahead by cp.async, so that a
// refill waits on shared memory only.  Not inlined, so that its loop keeps
// its few values in registers: it runs once per stretch of a block between
// such stops.
__device__ __noinline__ void fast_run(int lane) {
  const saddr ring = smem_addr(ring_bytes());
  const saddr in = smem_addr(sm.in);
  const int64_t wi0 = fr.wi;                       // the next word to load
  stage(in, wi0, kIn, lane);
  cp_async_wait();
  __syncwarp();
  uint64_t bb = fr.bb;
  int32_t nb = fr.nb;
  uint32_t a = static_cast<uint32_t>(wi0);        // next word, low bits
  const uint32_t q0 = fr.q;
  uint32_t q = q0;
  int32_t room = fr.room, ranks = fr.ranks, words = fr.words;
  // bytes before q: fr.before + (q - q0), at most 2^20 + 2^30
  const uint32_t before = static_cast<uint32_t>(fr.before) - q0;
  bool bad = false;
  const auto refill = [&]() {
    bb |= static_cast<uint64_t>(lds_u32(in + 4 * (a & kInMask))) << nb;
    nb += 32;
    --words;
    if ((++a & (kHalf - 1)) == 0) {
      // entering a half of the ring: it has arrived; the half left behind
      // takes the words after it
      cp_async_wait();
      __syncwarp();
      stage(in, wi0 + static_cast<int64_t>(a - static_cast<uint32_t>(wi0)) +
                    kHalf, kHalf, lane);
    }
  };
  // The match whose length code (entry e) starts at the reader's low bits
  // lo: its length, its distance, its bytes; `more` tops the reader up.
  // False, having written nothing, if the distance code is bad: the caller
  // backs the reader out of it.
  const auto match = [&](uint32_t e, uint32_t lo, auto more) {
    const int l = static_cast<int>((e >> 9) & 15);
    const int eb = static_cast<int>((e >> 13) & 7);
    const int run = static_cast<int>(e >> 16) +
                    static_cast<int>((lo >> l) & ((1u << eb) - 1u));
    bb >>= l + eb;
    nb -= l + eb;
    more();
    const uint32_t lo2 = static_cast<uint32_t>(bb);
    uint32_t de = sm.dist.prim[lo2 & 1023];
    if (de == 0) de = decode(sm.dist, lo2);        // a code over 10 bits
    const int dl = static_cast<int>((de >> 9) & 15);
    if (dl == 0 || (de & 511) > 29) return false;
    const int db = static_cast<int>((de >> 13) & 15);
    const uint32_t dist = (de >> 17) + ((lo2 >> dl) & ((1u << db) - 1u));
    bb >>= dl + db;
    nb -= dl + db;
    more();
    if (dist > before + q)
      bad = true;
    else
      copy_match(ring, q, dist, run, lane);
    q += run;
    room -= run;
    --ranks;
    return true;
  };
  while (ranks > 0 && room >= 0 && words >= 2) {
    if (nb <= 32) refill();
    // The common tokens: literals, up to two a lookup of sm.pair, two
    // lookups a step and one branch (a lookup that finds no literal
    // consumes nothing: its bytes go past the end and are overwritten
    // later, so the step's end tests both), then, where a lookup found
    // none, a literal of a longer code or a match.  Refills go in beside
    // the lookups, branch-free, from a word loaded ahead; the loop stops
    // before a refill could cross into a half of the input ring not yet
    // waited for, and before a token the budgets may not cover: a step
    // takes at most 4 tokens and bytes and 2 refills, a match after it 1
    // token, 258 bytes (room keeps them) and 2 refills.
    {
      const int32_t cross = kHalf - 1 - static_cast<int32_t>(a & (kHalf - 1));
      const int32_t allowed = words - 2 < cross ? words - 2 : cross;
      int32_t refills = allowed;
      uint32_t next = lds_u32(in + 4 * (a & kInMask));
      const auto fill = [&]() {
        const bool need = nb <= 32;
        const uint32_t ahead = lds_u32(in + 4 * ((a + 1) & kInMask));
        if (need) bb |= static_cast<uint64_t>(next) << nb;
        nb += need ? 32 : 0;
        next = need ? ahead : next;
        a += need;
        refills -= need;
      };
      while (ranks >= 5 && room >= 4 && refills >= 4) {
        uint32_t e = 0;
        bool none = false;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          e = sm.pair[static_cast<uint32_t>(bb) & ((1u << kPair) - 1)];
          fill();
          const int len = static_cast<int>(e >> 28);
          bb >>= len;
          nb -= len;
          sts_u8(ring + (q & kRingMask), e);
          sts_u8(ring + ((q + 1) & kRingMask), e >> 8);
          const uint32_t n = (e >> 26) & 3;
          q += n;
          room -= n;
          ranks -= n;
          none |= n == 0;
        }
        if (!none) continue;
        // the code at the reader is no literal of at most 10 bits: e is its
        // sm.lit.prim entry
        const uint32_t lo = static_cast<uint32_t>(bb);
        if (e == 511) e = decode(sm.lit, lo);        // a code over 10 bits
        const int sym = static_cast<int>(e & 511);
        const int l = static_cast<int>((e >> 9) & 15);
        if (sym < 256) {
          bb >>= l;
          nb -= l;
          fill();
          sts_u8(ring + (q & kRingMask), e);
          ++q;
          --room;
          --ranks;
          continue;
        }
        if (sym == 256 || sym > 285) break;        // end of block, bad code
        const uint64_t bb0 = bb;
        const int32_t nb0 = nb, refills0 = refills;
        const uint32_t a0 = a, next0 = next;
        if (!match(e, lo, fill)) {
          bb = bb0;
          nb = nb0;
          refills = refills0;
          a = a0;
          next = next0;
          break;
        }
      }
      words -= allowed - refills;
    }
    if (!(ranks > 0 && room >= 0 && words >= 2)) break;
    if (nb <= 32) refill();
    const uint32_t lo = static_cast<uint32_t>(bb);
    uint32_t e = sm.lit.prim[lo & 1023];
    if (e & 256) {
      if (e == 511) e = decode(sm.lit, lo);        // a code over 10 bits
      const int sym = static_cast<int>(e & 511);
      if (sym >= 256) {
        if (sym == 256 || sym > 285) break;        // end of block, bad code
        const uint64_t bb0 = bb;
        const int32_t nb0 = nb;
        const uint32_t a0 = a;
        if (!match(e, lo, [&]() { if (nb <= 32) refill(); })) {
          bb = bb0;
          nb = nb0;
          a = a0;
          break;
        }
        continue;
      }
    }
    const int l = static_cast<int>((e >> 9) & 15);
    bb >>= l;
    nb -= l;
    sts_u8(ring + (q & kRingMask), e);
    ++q;
    --room;
    --ranks;
  }
  cp_async_wait();
  __syncwarp();
  fr.bb = bb;
  fr.nb = nb;
  fr.wi = wi0 + static_cast<int64_t>(a - static_cast<uint32_t>(wi0));
  fr.pf = fr.wi < fr.nw ? __ldg(fr.w + fr.wi) : 0u;
  fr.tokens = fr.ranks - ranks;
  fr.bytes = static_cast<int32_t>(q - q0);
  fr.bad_dist = bad;
}

// Decode one Huffman block from bit `start` with the tables in sm.lit and
// sm.dist, in a window of `wbytes` bytes and `ranks` ranks (positions
// relative to the window, as _decode_window counts them), writing its bytes
// below out_size into the ring; with `fast`, stretches between tokens near a
// limit go through fast_run.
__device__ Path decode_block(Smem& sm, Bits& bits, const Row& row,
                             int64_t start, int64_t wbytes, int64_t ranks,
                             Ring& ring, Out& out, bool fast, int lane) {
  Path r{false, false, 0, 0, 0, kNever, kNever};
  const int64_t wbase = row.window(start, wbytes);
  const int64_t shift = (start & ~int64_t{7}) - wbase;   // read -> stream bit
  const int64_t limit = wbase + 8 * wbytes - 56;
  // while the reader's next word is below `near`, every bit it holds lies
  // below `limit`
  const int64_t near = (limit - 1) >> 5;
  const int64_t O = ring.O;
  uint8_t* __restrict__ buf = ring.buf;
  bits.seek(wbase + (start & 7));
  for (int64_t rank = 0;; ++rank) {
    if (fast && rank > 0) {
      const int64_t room = (ring.out + kRing < O ? ring.out + kRing : O) -
                           out.o;
      const int64_t words = near - 1 - bits.wi;
      if (room > 258 && words >= 2 && rank < ranks) {
        fr.bb = bits.bb;
        fr.w = bits.w;
        fr.nw = bits.nw;
        fr.wi = bits.wi;
        fr.nb = bits.nb;
        fr.q = static_cast<uint32_t>(out.o);
        fr.before = out.o < (1 << 20) ? static_cast<int32_t>(out.o)
                                       : (1 << 20);
        fr.room = clamp30(room - 258);
        fr.ranks = clamp30(ranks - rank);
        fr.words = clamp30(words);
        fast_run(lane);
        bits.bb = fr.bb;
        bits.wi = fr.wi;
        bits.nb = fr.nb;
        bits.pf = fr.pf;
        out.o += fr.bytes;
        out.any |= fr.tokens > 0;
        out.bad_dist |= fr.bad_dist;
        rank += fr.tokens;
      }
    }
    // one token, each check made for it
    if (rank >= ranks) return r;                   // no end within the ranks
    bits.fill();
    const uint32_t b = bits.peek();
    const uint32_t e = decode(sm.lit, b);
    const int l = static_cast<int>((e >> 9) & 15);
    const int sym = static_cast<int>(e & 511);
    if (sym < 256) {                               // literal
      bits.skip(l);
      const int64_t nxt = bits.pos();
      if (rank == 0) r.first_end = nxt + shift;
      if (nxt >= limit) return r;                  // kind 4, over the window
      const int64_t o = out.o;
      if (o < O) {
        ring.reserve(o + 1, lane);
        buf[o & kRingMask] = static_cast<uint8_t>(sym);
      }
      out.o = o + 1;
      out.any = true;
      out.last = kLitTok;
      out.last_start = o;
      out.last_arg = sym;
      continue;
    }
    if (sym == 256) {                              // end of block
      const int64_t at = bits.pos();
      r.eob = true;
      r.tokens = rank;
      r.end = at + l + shift;
      if (rank == 0) r.first_end = r.end;
      r.need_bits = rank > 0 ? at - wbase : -1;
      r.need_ranks = rank + 1;
      return r;
    }
    // a match, or a bad code (none: symbol 511, length 0) with the step
    // the plain path gives it
    const int eb = static_cast<int>((e >> 13) & 7);
    const int run = static_cast<int>(e >> 16) +
                    static_cast<int>((b >> l) & ((1u << eb) - 1u));
    bits.skip(l + eb);
    bits.fill();
    const uint32_t b2 = bits.peek();
    const uint32_t de = decode(sm.dist, b2);
    const int dl = static_cast<int>((de >> 9) & 15);
    const int db = static_cast<int>((de >> 13) & 15);
    const uint32_t dist = (de >> 17) + ((b2 >> dl) & ((1u << db) - 1u));
    bits.skip(dl + db);
    const int64_t nxt = bits.pos();
    if (rank == 0) r.first_end = nxt + shift;
    if (nxt >= limit) return r;                    // kind 4, over the window
    const bool match = l > 0 && sym <= 285 && dl > 0 && (de & 511) <= 29;
    if (!match) {                                  // kind 3
      r.bad = true;
      r.need_bits = nxt - wbase;
      r.need_ranks = rank + 1;
      return r;
    }
    const int64_t o = out.o;
    if (o < O) {
      const int n = O - o < run ? static_cast<int>(O - o) : run;
      ring.reserve(o + n, lane);
      if (dist > o) {
        out.bad_dist = true;
        copy_clamped(buf, o, dist, n, lane);
      } else {
        copy_match(smem_addr(buf), static_cast<uint32_t>(o), dist, n, lane);
      }
    }
    out.o = o + run;
    out.any = true;
    out.last = kMatchTok;
    out.last_start = o;
    out.last_arg = dist;
  }
}

// Parse the dynamic header at bit `pos` (after the block's 3 header bits)
// into the tables, as _parse_dynamic does; returns the bit its token decode
// starts at, and sets `bad`.
__device__ int64_t parse_dynamic(Smem& sm, Bits& bits, const Row& row,
                                 int64_t pos, bool& bad, int lane) {
  // the 14 + 57 bits of counts and code-length lengths; read bit by bit
  // where a word of them would pass the row's end and clamp
  const bool clamps = (pos >> 3) + 9 > row.n - 4;
  bits.seek(pos);
  const uint32_t w = clamps ? row.bits_at(pos) : bits.peek();
  const int hlit = static_cast<int>(w & 31) + 257;
  const int hdist = static_cast<int>((w >> 5) & 31) + 1;
  const int hclen = static_cast<int>((w >> 10) & 15) + 4;
  bad = hlit > 286 || hdist > 30;
  bits.skip(14);
  uint32_t meta = 0;                               // 3 bits a symbol, 19
  uint64_t meta_hi = 0;
  for (int i = 0; i < hclen; ++i) {
    bits.fill();
    const uint64_t v =
        (clamps ? row.bits_at(pos + 14 + 3 * i) : bits.peek()) & 7;
    bits.skip(3);
    const int s = kOrder[i];
    if (s < 10) meta |= static_cast<uint32_t>(v) << (3 * s);
    else meta_hi |= v << (3 * (s - 10));
  }
  build(sm.meta, sm, lane, [&](int s) {
    return static_cast<int>(s < 10 ? (meta >> (3 * s)) & 7
                                   : (meta_hi >> (3 * (s - 10))) & 7);
  });
  const int64_t cl = pos + 14 + 3 * hclen;
  const int64_t wbase = row.window(cl, 1024);
  const int64_t shift = (cl & ~int64_t{7}) - wbase;
  bits.seek(wbase + (cl & 7));
  const int total = hlit + hdist;
  for (int k = lane; k < 320; k += kLanes) sm.lens[k] = 0;
  __syncwarp();
  int o = 0;
  int prev = -1;            // the last value that was not a 16
  int64_t end = bits.pos();
  while (o < total) {
    bits.fill();
    const uint32_t b = bits.peek();
    const uint32_t e = sm.meta.prim[b & 127];     // 0: no code
    const int l = static_cast<int>(e >> 9);
    const int sym = static_cast<int>(e & 511);
    if (l == 0) {
      // an invalid code repeats where it stands: value 0, one length each
      bad = true;
      break;
    }
    const int extra = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
    const int eb = static_cast<int>((b >> l) & ((1u << extra) - 1u));
    const int cnt = sym < 16 ? 1 : sym <= 17 ? 3 + eb : 11 + eb;
    int val;
    if (sym == 16) {
      val = prev;
      if (prev < 0) bad = true;
    } else {
      val = sym < 16 ? sym : 0;
      prev = val;
    }
    const int stop = o + cnt < total ? o + cnt : total;
    for (int k = o + lane; k < stop; k += kLanes)
      sm.lens[k] = static_cast<int8_t>(val);
    bits.skip(l + extra);
    end = bits.pos();
    o += cnt;
  }
  __syncwarp();
  if (o != total) bad = true;
  build(sm.lit, sm, lane, [&](int s) {
    const int v = s < hlit ? sm.lens[s] : 0;
    return v > 0 ? v : 0;
  });
  build(sm.dist, sm, lane, [&](int s) {
    const int v = s < hdist ? sm.lens[hlit + s] : 0;
    return v > 0 ? v : 0;
  });
  build_pairs(lane);
  return end + shift;
}

struct Budget {
  int64_t w0, t0;           // the retry loop's first budget
  int64_t wl, tl;           // and its last
  int64_t tok_cap, max_blocks;
};

__device__ __forceinline__ bool fits(int64_t need_bits, int64_t need_ranks,
                                     int64_t w, int64_t t) {
  return need_bits < 8 * w - 56 && need_ranks <= t;
}

__global__ void __launch_bounds__(kLanes)
inflate_stream_kernel(const uint8_t* __restrict__ data, int64_t stride,
                      int64_t n, uint8_t* __restrict__ out,
                      int64_t out_stride, int64_t O, Budget bg,
                      int64_t* __restrict__ info) {
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t b = blockIdx.x;
  const Row row{data + b * stride, stride, n};
  Ring ring{ring_bytes(), out + b * out_stride, O, 0};
  int64_t top = 0;                  // bytes written into the ring
  Bits bits{reinterpret_cast<const uint32_t*>(row.src), stride >> 2, 0, 0, 0,
            0};
  const int64_t wbytes = bg.w0 > bg.wl ? bg.w0 : bg.wl;
  const int64_t ranks = bg.t0 > bg.tl ? bg.t0 : bg.tl;

  Out acc{0, false, false, kLitTok, 0, 0};
  int64_t bitpos = 0, tok = 0, blk = 0, status = 0;
  int64_t need_bits = -1, need_ranks = 0;
  bool cap = false;                 // the token cap overflowed
  bool cut = false;                 // a block did not fit the last budget
  Out cut_acc = acc;
  int64_t cut_status = 0, cut_end = 0, cut_blocks = 0;
  bool fixed_built = false;
  bool dropped = false;             // the last block's tokens were dropped

  // The blocks from `bitpos` on, to the final one, the first one that sets
  // a flag, or `limit` blocks in all.
  const auto blocks = [&](int64_t limit, bool fast) {
    for (;;) {
      const uint32_t hdr = row.bits_at(bitpos) & 7;
      const bool final = hdr & 1;
      const int btype = static_cast<int>(hdr >> 1);
      int64_t flag = 0, T = 0, end = 0;
      dropped = false;
      if (btype == 3) {
        flag = F_BAD_BLOCK;
      } else if (btype == 0) {
        const int64_t at = (bitpos + 10) >> 3;
        const uint32_t w = row.bits_at(8 * at);
        const int64_t len = w & 0xFFFF;
        if ((len ^ 0xFFFF) != (w >> 16)) flag |= F_BAD_PARITY;
        T = 1;
        end = 8 * (at + 4 + len);
        const int64_t o = acc.o;
        const int64_t stop = O - o < len ? O : o + len;
        for (int64_t q = o; q < stop; q += kChunk) {
          const int64_t end = stop - q < kChunk ? stop : q + kChunk;
          ring.reserve(end, lane);
          for (int64_t k = q + lane; k < end; k += kLanes)
            ring.buf[k & kRingMask] = row.byte_at(at + 4 + (k - o));
        }
        if (len > 0 || tok == 0) {
          acc.last = kStoredTok;
          acc.last_start = o;
          acc.last_arg = at + 4;
        }
        acc.o = o + len;
        acc.any |= len > 0;
        if (stop > top) top = stop;
      } else {
        int64_t start = bitpos + 3;
        int64_t tflag = 0;
        if (btype == 2) {
          bool bad = false;
          start = parse_dynamic(sm, bits, row, start, bad, lane);
          if (bad) tflag = F_BAD_CODE;
          fixed_built = false;
        } else if (!fixed_built) {
          build(sm.lit, sm, lane, [](int s) {
            return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
          });
          build(sm.dist, sm, lane, [](int) { return 5; });
          build_pairs(lane);
          fixed_built = true;
        }
        const Out before = acc;
        const Path p = decode_block(sm, bits, row, start, wbytes, ranks, ring,
                                    acc, fast, lane);
        if (acc.o > top) top = acc.o;
        if (!cut && !fits(p.need_bits, p.need_ranks, bg.wl, bg.tl)) {
          cut = true;
          cut_acc = before;
          cut_status = status | tflag | F_OVERFLOW |
                       (blk + 1 >= bg.max_blocks && !final ? F_TOO_MANY_BLOCKS
                                                           : 0);
          cut_end = p.first_end;
          cut_blocks = blk + 1;
        }
        if (p.need_bits > need_bits) need_bits = p.need_bits;
        if (p.need_ranks > need_ranks) need_ranks = p.need_ranks;
        flag |= tflag;
        if (p.eob) {
          T = p.tokens;
          end = p.end;
        } else {
          acc = before;
          dropped = true;
          end = p.first_end;
          flag |= p.bad ? F_BAD_CODE : F_OVERFLOW;
        }
      }
      if (tok + T > bg.tok_cap) {
        flag |= F_OVERFLOW;
        cap = true;
      }
      ++blk;
      if (blk >= bg.max_blocks && !final) flag |= F_TOO_MANY_BLOCKS;
      bitpos = end;
      tok += T;
      status |= flag;
      if (final || status != 0 || blk >= limit) break;
    }
  };

  blocks(kNever, true);
  ring.write_out(top < O ? top : O, lane);

  // the run the retry loop stops at
  const bool whole =
      fits(need_bits, need_ranks, bg.wl, bg.tl) ||
      (fits(need_bits, need_ranks, bg.w0, bg.t0) && !cap);
  // the blocks whose tokens it keeps
  const int64_t kept = whole ? blk - dropped : cut_blocks - 1;
  if (!whole) {
    acc = cut_acc;
    status = cut_status;
    bitpos = cut_end;
    blk = cut_blocks;
  }
  if (static_cast<int64_t>(static_cast<int32_t>(
          static_cast<uint32_t>(acc.o))) != O)
    status |= F_OUTPUT_MISMATCH;
  if (acc.bad_dist || (O > 0 && !acc.any)) status |= F_BAD_DISTANCE;
  if (lane == 0) {
    int64_t* r = info + b * kInfo;
    r[0] = status;
    r[1] = bitpos;
    r[2] = blk;
    r[3] = need_bits;
    r[4] = need_ranks;
    r[5] = cap;
    r[6] = acc.o;
    r[7] = 0;
  }
  if (status == 0) return;

  // A failed stream's bytes, as _inflate's assembly gives them: a second
  // pass over the kept blocks alone, token by token (the first may have
  // written a dropped block's bytes over the ring, and skipped the bytes of
  // a match that reaches before byte 0), then the last token run on to
  // out_size.
  acc = Out{0, false, false, kLitTok, 0, 0};
  bitpos = tok = blk = status = top = 0;
  ring.out = 0;
  fixed_built = false;
  if (kept > 0) blocks(kept, false);
  uint8_t* __restrict__ buf = ring.buf;
  for (int64_t q = acc.o; q < O; q += kChunk) {
    const int64_t end = O - q < kChunk ? O : q + kChunk;
    ring.reserve(end, lane);
    if (acc.last == kMatchTok) {
      copy_clamped(buf, q, acc.last_arg, end - q, lane);
    } else {
      for (int64_t k = q + lane; k < end; k += kLanes)
        buf[k & kRingMask] =
            acc.last == kLitTok
                ? static_cast<uint8_t>(acc.last_arg)
                : row.byte_at(acc.last_arg + (k - acc.last_start));
    }
  }
  ring.write_out(O, lane);
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Lets the kernel take the ring's kRing bytes of dynamic shared memory on
// the current device (once per device and process).
static cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(inflate_stream_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRing);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Launch on `stream`: data (B, stride) u8 (stride a multiple of 4), read as
// rows of n bytes (the bytes past stride as 0; n >= 1027 and n >= the
// largest window + 3) -> out (B, out_stride) u8, whose first out_size bytes
// of a row it writes, and
// info (B, 8) i64 [status, end bit, blocks, the largest bits and ranks a
// block needs, 1 if the token cap overflowed, the bytes of the tokens, 0].
// (w0, t0) and (wl, tl) are the retry loop's first and last budgets (equal
// for one budget).
extern "C" int spt_inflate_stream(const void* data, long long stride,
                                  long long n, int B, void* out,
                                  long long out_stride,
                                  long long out_size, long long w0,
                                  long long t0, long long wl, long long tl,
                                  long long tok_cap, long long max_blocks,
                                  void* info, void* stream) {
  if (B <= 0) return 0;
  if (stride <= 0 || stride % 4 != 0 || n < 1027 || out_size < 0 ||
      out_stride < out_size || n < 3 + (w0 > wl ? w0 : wl))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Budget bg{w0, t0, wl, tl, tok_cap, max_blocks};
  inflate_stream_kernel<<<B, kLanes, kRing,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), stride, n,
      static_cast<uint8_t*>(out), out_stride, out_size, bg,
      static_cast<int64_t*>(info));
  return static_cast<int>(cudaGetLastError());
}
