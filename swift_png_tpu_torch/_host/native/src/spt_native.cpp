// spt_native: the host-native runtime tier of swift_png_tpu_torch (a copy
// of swift_png_tpu/native/src/spt_native.cpp).
//
// From-scratch DEFLATE/zlib/gzip codec, checksums, and PNG defilter in
// C++ — the sequential engine that complements the device kernels the way
// the reference's hand-tuned Swift hot loops do (behavioral counterparts:
// LZ77.InflatorBuffers.Stream.swift token loop :266-381, DeflatorWindow
// match search :115-212, PNG.Decoder.defilter :152-196).  No external
// libraries; exact same stream semantics as the Python tier.
//
// Build: python -m swift_png_tpu_torch._host.native.build

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

extern "C" {

// Bump on ANY exported-signature change; the Python loader refuses (and
// rebuilds) a library whose version doesn't match, so a stale cached .so
// can never be called through a new ABI (e.g. spt_build_index gained a
// pair_steps pointer for v3 indexes).
int spt_abi_version() { return 6; }

// ---------------------------------------------------------------------------
// checksums
// ---------------------------------------------------------------------------

static uint32_t crc_tables[8][256];
static bool crc_init_done = false;

static void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (c & 1 ? 0xEDB88320u : 0);
        crc_tables[0][i] = c;
    }
    for (int s = 1; s < 8; s++)
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t p = crc_tables[s - 1][i];
            crc_tables[s][i] = crc_tables[0][p & 0xFF] ^ (p >> 8);
        }
    crc_init_done = true;
}

uint32_t spt_crc32(const uint8_t* data, size_t n, uint32_t state) {
    crc_init();
    uint32_t crc = state ^ 0xFFFFFFFFu;
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t w;
        memcpy(&w, data + i, 8);
        w ^= crc;
        crc = crc_tables[7][w & 0xFF] ^ crc_tables[6][(w >> 8) & 0xFF]
            ^ crc_tables[5][(w >> 16) & 0xFF] ^ crc_tables[4][(w >> 24) & 0xFF]
            ^ crc_tables[3][(w >> 32) & 0xFF] ^ crc_tables[2][(w >> 40) & 0xFF]
            ^ crc_tables[1][(w >> 48) & 0xFF] ^ crc_tables[0][(w >> 56) & 0xFF];
    }
    for (; i < n; i++) crc = crc_tables[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

uint32_t spt_adler32(const uint8_t* data, size_t n, uint32_t state) {
    uint32_t s1 = state & 0xFFFF, s2 = (state >> 16) & 0xFFFF;
    size_t i = 0;
    while (i < n) {
        size_t run = std::min<size_t>(n - i, 5552);  // LZ77.MRC32.swift:26-48
        for (size_t k = 0; k < run; k++) { s1 += data[i + k]; s2 += s1; }
        s1 %= 65521; s2 %= 65521;
        i += run;
    }
    return (s2 << 16) | s1;
}

// ---------------------------------------------------------------------------
// inflate
// ---------------------------------------------------------------------------

static const uint16_t RUN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
    35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t RUN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,
    4,4,4,4,5,5,5,5,0};
static const uint16_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,
    193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,
    9,9,10,10,11,11,12,12,13,13};
static const uint8_t CLO[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

struct BitReader {
    const uint8_t* data;
    size_t n;
    size_t pos = 0;        // byte cursor
    uint64_t acc = 0;
    int bits = 0;

    void refill() {
        if (pos + 8 <= n) {  // branch-free bulk refill on the hot path
            uint64_t w;
            memcpy(&w, data + pos, 8);
            acc |= w << bits;
            int take = (63 - bits) >> 3;
            pos += take;
            bits += take * 8;
            return;
        }
        while (bits <= 56) {
            uint64_t b = pos < n ? data[pos] : 0;
            acc |= b << bits;
            bits += 8;
            pos++;
        }
    }
    uint32_t peek(int c) { refill(); return acc & ((1u << c) - 1); }
    // no-refill variants for decoding a whole token from one refill
    uint32_t peek_nf(int c) const { return acc & ((1u << c) - 1); }
    void drop(int c) { acc >>= c; bits -= c; }
    uint32_t read(int c) { uint32_t v = peek(c); drop(c); return v; }
    uint32_t read_nf(int c) { uint32_t v = peek_nf(c); drop(c); return v; }
    void align() { int r = bits & 7; acc >>= r; bits -= r; }
    size_t byte_cursor() const { return pos - bits / 8; }
    bool overrun() const { return byte_cursor() > n + 8; }
};

// flat decode LUT: entry = (len << 16) | symbol, indexed by the next
// `width` bits where width = actual max code length (≤ max_len); returns
// the width via out param, or -1 on malformed lengths
static int build_table(const uint8_t* lengths, int nsym, int max_len,
                       std::vector<uint32_t>& table) {
    int counts[16] = {0};
    int used = 0, one_sym = -1, width = 1;
    for (int s = 0; s < nsym; s++)
        if (lengths[s]) {
            counts[lengths[s]]++;
            used++;
            one_sym = s;
            if (lengths[s] > width) width = lengths[s];
        }
    if (width > max_len) return -1;
    table.assign(size_t(1) << width, 0);
    if (used == 0) return width;
    if (used == 1) {  // 1-bit stub (HuffmanTree.swift:112-174 semantics)
        for (size_t i = 0; i < table.size(); i += 2)
            table[i] = (1u << 16) | one_sym;
        return width;
    }
    // kraft check
    long kraft = 0;
    for (int l = 1; l <= width; l++) kraft += (long)counts[l] << (width - l);
    if (kraft != (1L << width)) return -1;
    int next_code[16], code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    for (int s = 0; s < nsym; s++) {
        int l = lengths[s];
        if (!l) continue;
        int c = next_code[l]++;
        // bit-reverse c over l bits
        uint32_t rev = 0;
        for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
        for (size_t i = rev; i < table.size(); i += size_t(1) << l)
            table[i] = ((uint32_t)l << 16) | s;
    }
    return width;
}

// two-level decode LUT: 10-bit root + per-prefix subtables.  The flat
// table above sizes 2^width (up to 128 KB at width 15) and is rebuilt
// per block — multi-block foreign streams (zlib -9 emits ~40 blocks per
// image) paid the build writes AND the cache misses on every lookup.
// Root entries: (len << 16) | sym for codes of length <= 10 (replicated);
// longer prefixes store 0x80000000 | (subw << 24) | sub_base, and the
// subtable entry at bits [10, 10+subw) holds the full (len << 16) | sym.
static int build_table2(const uint8_t* lengths, int nsym,
                        std::vector<uint32_t>& root,
                        std::vector<uint32_t>& sub) {
    const int RB = 10;
    int counts[16] = {0};
    int used = 0, one_sym = -1, width = 1;
    for (int s = 0; s < nsym; s++)
        if (lengths[s]) {
            counts[lengths[s]]++;
            used++;
            one_sym = s;
            if (lengths[s] > width) width = lengths[s];
        }
    if (width > 15) return -1;
    root.assign(size_t(1) << RB, 0);
    sub.clear();
    if (used == 0) return width;
    if (used == 1) {  // 1-bit stub (HuffmanTree.swift:112-174 semantics)
        for (size_t i = 0; i < root.size(); i += 2)
            root[i] = (1u << 16) | one_sym;
        return width;
    }
    long kraft = 0;
    for (int l = 1; l <= width; l++) kraft += (long)counts[l] << (width - l);
    if (kraft != (1L << width)) return -1;
    int next_code[16], code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    // pass 1: per-root-prefix subtable widths for codes longer than RB
    uint8_t subw[1 << RB];
    memset(subw, 0, sizeof subw);
    if (width > RB) {
        int nc[16];
        memcpy(nc, next_code, sizeof nc);
        for (int s = 0; s < nsym; s++) {
            int l = lengths[s];
            if (!l) continue;
            int c = nc[l]++;
            if (l <= RB) continue;
            uint32_t rev = 0;
            for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
            uint32_t pfx = rev & ((1u << RB) - 1);
            if (l - RB > subw[pfx]) subw[pfx] = (uint8_t)(l - RB);
        }
        size_t base = 0;
        for (uint32_t p = 0; p < (1u << RB); p++)
            if (subw[p]) {
                root[p] = 0x80000000u | ((uint32_t)subw[p] << 24)
                          | (uint32_t)base;
                base += size_t(1) << subw[p];
            }
        sub.assign(base, 0);
    }
    // pass 2: fill
    for (int s = 0; s < nsym; s++) {
        int l = lengths[s];
        if (!l) continue;
        int c = next_code[l]++;
        uint32_t rev = 0;
        for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
        if (l <= RB) {
            for (size_t i = rev; i < root.size(); i += size_t(1) << l)
                root[i] = ((uint32_t)l << 16) | s;
        } else {
            uint32_t pfx = rev & ((1u << RB) - 1);
            uint32_t hi = rev >> RB;          // l - RB bits
            uint32_t e = root[pfx];
            uint32_t sb = e & 0xFFFFFF;
            int sw = (e >> 24) & 15;
            for (size_t i = hi; i < (size_t(1) << sw);
                 i += size_t(1) << (l - RB))
                sub[sb + i] = ((uint32_t)l << 16) | s;
        }
    }
    return width;
}

// error codes
enum {
    SPT_OK = 0, SPT_E_BLOCKTYPE = -1, SPT_E_PARITY = -2, SPT_E_TABLE = -3,
    SPT_E_CODELEN = -4, SPT_E_DISTANCE = -5, SPT_E_OUTPUT = -6,
    SPT_E_TRUNCATED = -7, SPT_E_HEADER = -8, SPT_E_CHECKSUM = -9,
    SPT_E_ARG = -10,
};

// raw DEFLATE body → dst; returns bytes written or negative error.
// consumed (optional) receives the byte length of the compressed body.
long long spt_inflate_raw(const uint8_t* src, size_t srclen, uint8_t* dst,
                          size_t dstcap, size_t* consumed) {
    BitReader br{src, srclen};
    size_t out = 0;
    std::vector<uint32_t> lit_root, lit_sub, dist_root, dist_sub;
    uint8_t lens[320];
    for (;;) {
        uint32_t final_ = br.read(1);
        uint32_t btype = br.read(2);
        if (br.overrun()) return SPT_E_TRUNCATED;
        if (btype == 0) {
            br.align();
            uint32_t len = br.read(16);
            uint32_t nlen = br.read(16);
            if ((len ^ 0xFFFF) != nlen) return SPT_E_PARITY;
            size_t start = br.byte_cursor();
            if (start + len > srclen) return SPT_E_TRUNCATED;
            if (out + len > dstcap) return SPT_E_OUTPUT;
            memcpy(dst + out, src + start, len);
            out += len;
            br = BitReader{src, srclen};
            br.pos = start + len;
        } else if (btype == 3) {
            return SPT_E_BLOCKTYPE;
        } else {
            int lit_max = 15, dist_max = 15;
            if (btype == 1) {
                static std::vector<uint32_t> flit_r, flit_s, fdist_r,
                    fdist_s;
                if (flit_r.empty()) {
                    uint8_t ll[288], dl[32];
                    for (int i = 0; i < 144; i++) ll[i] = 8;
                    for (int i = 144; i < 256; i++) ll[i] = 9;
                    for (int i = 256; i < 280; i++) ll[i] = 7;
                    for (int i = 280; i < 288; i++) ll[i] = 8;
                    // all 32 five-bit codes exist; symbols 30/31 are
                    // rejected at decode time (RFC 1951 §3.2.6)
                    for (int i = 0; i < 32; i++) dl[i] = 5;
                    build_table2(ll, 288, flit_r, flit_s);
                    build_table2(dl, 32, fdist_r, fdist_s);
                }
                lit_root = flit_r; lit_sub = flit_s;
                dist_root = fdist_r; dist_sub = fdist_s;
                lit_max = 9; dist_max = 5;
            } else {
                uint32_t hlit = br.read(5) + 257;
                uint32_t hdist = br.read(5) + 1;
                uint32_t hclen = br.read(4) + 4;
                if (hlit > 286) return SPT_E_TABLE;
                uint8_t mlens[19] = {0};
                for (uint32_t i = 0; i < hclen; i++)
                    mlens[CLO[i]] = br.read(3);
                std::vector<uint32_t> meta;
                int meta_w = build_table(mlens, 19, 7, meta);
                if (meta_w < 0) return SPT_E_TABLE;
                uint32_t total = hlit + hdist;
                memset(lens, 0, sizeof lens);
                uint32_t i = 0;
                while (i < total) {
                    uint32_t e = meta[br.peek(meta_w)];
                    int l = e >> 16;
                    if (!l) return SPT_E_CODELEN;
                    int sym = e & 0xFFFF;
                    br.drop(l);
                    if (sym < 16) {
                        lens[i++] = sym;
                    } else if (sym == 16) {
                        if (i == 0) return SPT_E_CODELEN;
                        uint32_t r = 3 + br.read(2);
                        if (i + r > total) return SPT_E_CODELEN;
                        uint8_t v = lens[i - 1];
                        while (r--) lens[i++] = v;
                    } else if (sym == 17) {
                        uint32_t r = 3 + br.read(3);
                        if (i + r > total) return SPT_E_CODELEN;
                        i += r;
                    } else {
                        uint32_t r = 11 + br.read(7);
                        if (i + r > total) return SPT_E_CODELEN;
                        i += r;
                    }
                    if (br.overrun()) return SPT_E_TRUNCATED;
                }
                bool any = false;
                for (uint32_t s = 0; s < hlit; s++) if (lens[s]) any = true;
                if (!any) return SPT_E_TABLE;
                lit_max = build_table2(lens, hlit, lit_root, lit_sub);
                if (lit_max < 0) return SPT_E_TABLE;
                dist_max = build_table2(lens + hlit, hdist, dist_root,
                                        dist_sub);
                if (dist_max < 0) return SPT_E_TABLE;
            }
            const uint32_t* LR = lit_root.data();
            const uint32_t* LS = lit_sub.data();
            const uint32_t* DR = dist_root.data();
            const uint32_t* DS = dist_sub.data();
#define SPT_LOOKUP(e_, R_, S_)                                           \
            e_ = R_[br.peek_nf(10)];                                     \
            if ((int32_t)e_ < 0)                                         \
                e_ = S_[(e_ & 0xFFFFFF)                                  \
                        + (br.peek_nf(10 + ((e_ >> 24) & 15)) >> 10)];
            for (;;) {
                // one refill covers a whole token (≤ 48 bits < 56 available)
                br.refill();
                uint32_t e;
                SPT_LOOKUP(e, LR, LS)
                int l = e >> 16;
                if (!l) return SPT_E_TABLE;
                int sym = e & 0xFFFF;
                br.drop(l);
                if (sym < 256) {
                    if (out >= dstcap) return SPT_E_OUTPUT;
                    dst[out++] = (uint8_t)sym;
                    // literal fast path: decode more literals from the
                    // same refill while enough bits remain
                    while (br.bits >= lit_max) {
                        SPT_LOOKUP(e, LR, LS)
                        l = e >> 16;
                        sym = e & 0xFFFF;
                        if (!l || sym >= 256) break;
                        br.drop(l);
                        if (out >= dstcap) return SPT_E_OUTPUT;
                        dst[out++] = (uint8_t)sym;
                    }
                    if (!l) return SPT_E_TABLE;
                    if (sym < 256) {
                        if (br.overrun()) return SPT_E_TRUNCATED;
                        continue;
                    }
                    br.refill();
                    SPT_LOOKUP(e, LR, LS)
                    l = e >> 16;
                    if (!l) return SPT_E_TABLE;
                    sym = e & 0xFFFF;
                    br.drop(l);
                    if (sym < 256) {
                        if (out >= dstcap) return SPT_E_OUTPUT;
                        dst[out++] = (uint8_t)sym;
                        if (br.overrun()) return SPT_E_TRUNCATED;
                        continue;
                    }
                }
                if (sym == 256) {
                    break;
                } else {
                    if (sym > 285) return SPT_E_TABLE;
                    int d = sym - 257;
                    uint32_t run = RUN_BASE[d] + br.read_nf(RUN_EXTRA[d]);
                    uint32_t de;
                    SPT_LOOKUP(de, DR, DS)
                    int dl = de >> 16;
                    if (!dl) return SPT_E_DISTANCE;
                    int dsym = de & 0xFFFF;
                    if (dsym > 29) return SPT_E_DISTANCE;
                    br.drop(dl);
                    uint32_t dist = DIST_BASE[dsym] + br.read_nf(DIST_EXTRA[dsym]);
                    if (dist > out) return SPT_E_DISTANCE;
                    if (out + run > dstcap) return SPT_E_OUTPUT;
                    // forward byte copy handles overlap
                    // (LZ77.InflatorOut.swift:124-139)
                    uint8_t* p = dst + out;
                    if (dist >= 8 && out + run + 8 <= dstcap) {
                        const uint8_t* q = p - dist;
                        for (uint32_t k = 0; k < run; k += 8)
                            memcpy(p + k, q + k, 8);
                    } else if (out + run + 8 <= dstcap) {
                        // self-overlapping short distance: chunk-double
                        // through the already-written period (each pass
                        // copies `avail` bytes, then the valid period
                        // doubles — an RLE run costs log2(run) passes)
                        uint32_t k = 0, avail = dist;
                        while (k < run) {
                            uint32_t c = run - k < avail ? run - k : avail;
                            // pointer form: k + t - avail is negative on
                            // the first pass (unsigned wrap would read
                            // 4 GB away); p + k - avail >= dst - dist
                            uint8_t* w = p + k;
                            const uint8_t* qq = w - avail;
                            if (c >= 8) {
                                for (uint32_t t = 0; t < c; t += 8)
                                    memcpy(w + t, qq + t, 8);
                            } else {
                                for (uint32_t t = 0; t < c; t++)
                                    w[t] = qq[t];
                            }
                            k += c;
                            avail <<= 1;
                        }
                    } else {
                        const uint8_t* q = p - dist;
                        for (uint32_t k = 0; k < run; k++) p[k] = q[k];
                    }
                    out += run;
                }
                if (br.overrun()) return SPT_E_TRUNCATED;
            }
#undef SPT_LOOKUP
        }
        if (final_) break;
    }
    if (consumed) {
        br.align();
        *consumed = br.byte_cursor();
    }
    return (long long)out;
}

// format: 0 = zlib (verify adler), 1 = ios/raw, 2 = gzip (verify crc)
long long spt_inflate(const uint8_t* src, size_t srclen, uint8_t* dst,
                      size_t dstcap, int format) {
    if (format == 0) {
        if (srclen < 6) return SPT_E_TRUNCATED;
        uint8_t cmf = src[0], flg = src[1];
        if ((cmf & 0x0F) != 8) return SPT_E_HEADER;
        if ((cmf * 256 + flg) % 31) return SPT_E_HEADER;
        if (flg & 0x20) return SPT_E_HEADER;
        size_t used = 0;
        long long n = spt_inflate_raw(src + 2, srclen - 2, dst, dstcap, &used);
        if (n < 0) return n;
        if (2 + used + 4 > srclen) return SPT_E_TRUNCATED;
        uint32_t declared = (uint32_t)src[2 + used] << 24
            | (uint32_t)src[2 + used + 1] << 16
            | (uint32_t)src[2 + used + 2] << 8 | src[2 + used + 3];
        if (spt_adler32(dst, n, 1) != declared) return SPT_E_CHECKSUM;
        return n;
    }
    if (format == 1) return spt_inflate_raw(src, srclen, dst, dstcap, nullptr);
    if (format == 2) {
        if (srclen < 18) return SPT_E_TRUNCATED;
        if (src[0] != 0x1F || src[1] != 0x8B || src[2] != 8)
            return SPT_E_HEADER;
        uint8_t flags = src[3];
        if (flags & 0xE0) return SPT_E_HEADER;
        if (flags & 0x02) return SPT_E_HEADER;  // header CRC unsupported
        size_t off = 10;
        if (flags & 0x04) {
            if (off + 2 > srclen) return SPT_E_TRUNCATED;
            off += 2 + (size_t)(src[off] | src[off + 1] << 8);
            if (off > srclen) return SPT_E_TRUNCATED;
        }
        for (int s = 0; s < 2; s++) {
            if (flags & (s == 0 ? 0x08 : 0x10)) {
                while (off < srclen && src[off]) off++;
                if (off >= srclen) return SPT_E_TRUNCATED;
                off++;
            }
        }
        if (off > srclen) return SPT_E_TRUNCATED;
        size_t used = 0;
        long long n = spt_inflate_raw(src + off, srclen - off, dst, dstcap,
                                      &used);
        if (n < 0) return n;
        if (off + used + 8 > srclen) return SPT_E_TRUNCATED;
        const uint8_t* t = src + off + used;
        uint32_t declared = t[0] | t[1] << 8 | (uint32_t)t[2] << 16
            | (uint32_t)t[3] << 24;
        if (spt_crc32(dst, n, 0) != declared) return SPT_E_CHECKSUM;
        return n;
    }
    return SPT_E_ARG;
}

// ---------------------------------------------------------------------------
// PNG defilter / filter
// ---------------------------------------------------------------------------

static inline int paeth(int a, int b, int c) {
    // branchless form of PNG.paeth (PNG.swift:123-147)
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

// rows: H rows of (1 + pitch) bytes, defiltered in place
int spt_defilter(uint8_t* rows, int H, int pitch, int bpp) {
    std::vector<uint8_t> zero(pitch, 0);
    uint8_t* prev = zero.data();
    for (int y = 0; y < H; y++) {
        uint8_t* line = rows + (size_t)y * (pitch + 1);
        uint8_t f = line[0];
        uint8_t* cur = line + 1;
        switch (f) {
        case 0: break;
        case 1:
            for (int i = bpp; i < pitch; i++) cur[i] += cur[i - bpp];
            break;
        case 2:
            for (int i = 0; i < pitch; i++) cur[i] += prev[i];
            break;
        case 3:
            for (int i = 0; i < bpp && i < pitch; i++)
                cur[i] += prev[i] >> 1;
            for (int i = bpp; i < pitch; i++)
                cur[i] += (cur[i - bpp] + prev[i]) >> 1;
            break;
        case 4:
            for (int i = 0; i < bpp && i < pitch; i++) cur[i] += prev[i];
            for (int i = bpp; i < pitch; i++)
                cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
            break;
        default: break;  // invalid filter passes through, like the reference
        }
        prev = cur;
    }
    return 0;
}

// filter-select: raw rows (H × pitch) → out rows (H × (1+pitch)),
// minimum sum-of-abs-Int8 heuristic (PNG.Encoder.swift:132-234)
int spt_filter_select(const uint8_t* rows, int H, int pitch, int bpp,
                      uint8_t* out) {
    std::vector<uint8_t> zero(pitch, 0);
    std::vector<uint8_t> cand(5 * (size_t)pitch);
    const uint8_t* prev = zero.data();
    for (int y = 0; y < H; y++) {
        const uint8_t* cur = rows + (size_t)y * pitch;
        uint8_t* c0 = cand.data();
        uint8_t* c1 = c0 + pitch;
        uint8_t* c2 = c1 + pitch;
        uint8_t* c3 = c2 + pitch;
        uint8_t* c4 = c3 + pitch;
        for (int i = 0; i < pitch; i++) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            int b = prev[i];
            int c = i >= bpp ? prev[i - bpp] : 0;
            c0[i] = cur[i];
            c1[i] = (uint8_t)(cur[i] - a);
            c2[i] = (uint8_t)(cur[i] - b);
            c3[i] = (uint8_t)(cur[i] - ((a + b) >> 1));
            c4[i] = (uint8_t)(cur[i] - paeth(a, b, c));
        }
        long best_score = -1;
        int best = 0;
        for (int f = 0; f < 5; f++) {
            const uint8_t* c = cand.data() + (size_t)f * pitch;
            long score = 0;
            for (int i = 0; i < pitch; i++)
                score += abs((int8_t)c[i]);
            if (best_score < 0 || score < best_score) {
                best_score = score;
                best = f;
            }
        }
        uint8_t* o = out + (size_t)y * (pitch + 1);
        o[0] = (uint8_t)best;
        memcpy(o + 1, cand.data() + (size_t)best * pitch, pitch);
        prev = cur;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// multithreaded batch entry points
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

extern "C" {

// decode `count` independent streams in parallel; srcs/dsts are pointer
// arrays, sizes in elements.  Returns 0 if every stream succeeded; the
// per-stream results land in `results` (bytes written or negative error).
int spt_inflate_batch(const uint8_t** srcs, const size_t* srclens,
                      uint8_t** dsts, const size_t* dstcaps,
                      long long* results, int count, int format,
                      int threads) {
    if (threads <= 0)
        threads = (int)std::thread::hardware_concurrency();
    if (threads > count) threads = count;
    if (threads < 1) threads = 1;
    std::vector<std::thread> pool;
    std::atomic_int next{0};
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= count) return;
            results[i] = spt_inflate(srcs[i], srclens[i], dsts[i],
                                     dstcaps[i], format);
        }
    };
    for (int t = 0; t < threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    int ok = 0;
    for (int i = 0; i < count; i++)
        if (results[i] < 0) ok = -1;
    return ok;
}

// parallel defilter over a batch of images laid out back to back
int spt_defilter_batch(uint8_t* rows, int count, int H, int pitch, int bpp,
                       int threads) {
    if (threads <= 0)
        threads = (int)std::thread::hardware_concurrency();
    if (threads > count) threads = count;
    if (threads < 1) threads = 1;
    size_t stride = (size_t)H * (pitch + 1);
    std::vector<std::thread> pool;
    std::atomic_int next{0};
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= count) return;
            spt_defilter(rows + stride * i, H, pitch, bpp);
        }
    };
    for (int t = 0; t < threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}


// ---------------------------------------------------------------------------
// checkpoint index builder (lz77/index.py fast path): one sequential walk
// over a raw-DEFLATE body recording, for every `ob`-output-byte unit, the
// bit position of its first token, the mid-token skip, and its decode
// tables.  v2 handles any mix of dynamic/fixed/stored blocks within the
// structural limits the lockstep kernel supports: at most one block
// boundary per unit (recorded as an `eob_jump` over the next header) and
// stored regions that cross units only via recorded inter-block gaps
// (5 bytes per header crossed; flush markers between stored blocks
// stack into gap_len).  Empty dynamic blocks (Z_FULL_FLUSH markers
// between data blocks) fold into the boundary jump instead of spending
// the unit's single table switch.
// Returns the unit count, 0 when the stream is outside the fast path
// (caller falls back to the general engines), or a negative error.

static int parse_huffman_tables(BitReader& br, int btype, uint8_t* lit288,
                                uint8_t* dist32) {
    if (btype == 1) {  // RFC 1951 fixed code lengths
        for (int i = 0; i < 144; i++) lit288[i] = 8;
        for (int i = 144; i < 256; i++) lit288[i] = 9;
        for (int i = 256; i < 280; i++) lit288[i] = 7;
        for (int i = 280; i < 288; i++) lit288[i] = 8;
        for (int i = 0; i < 32; i++) dist32[i] = 5;
        return 0;
    }
    int hlit = br.read(5) + 257;
    int hdist = br.read(5) + 1;
    int hclen = br.read(4) + 4;
    if (hlit > 286 || hdist > 30) return SPT_E_TABLE;
    uint8_t mlens[19] = {0};
    for (int i = 0; i < hclen; i++) mlens[CLO[i]] = (uint8_t)br.read(3);
    std::vector<uint32_t> meta;
    int meta_w = build_table(mlens, 19, 7, meta);
    if (meta_w < 0) return SPT_E_TABLE;
    uint8_t lens[288 + 32] = {0};
    int total = hlit + hdist;
    for (int got = 0; got < total;) {
        uint32_t e = meta[br.peek(meta_w)];
        int l = e >> 16, sym = e & 0xFFFF;
        if (!l) return SPT_E_CODELEN;
        br.drop(l);
        if (sym < 16) lens[got++] = (uint8_t)sym;
        else if (sym == 16) {
            if (!got) return SPT_E_CODELEN;
            int r = 3 + br.read(2);
            if (got + r > total) return SPT_E_CODELEN;
            for (int i = 0; i < r; i++) lens[got + i] = lens[got - 1];
            got += r;
        } else {
            int r = (sym == 17 ? 3 + br.read(3) : 11 + br.read(7));
            if (got + r > total) return SPT_E_CODELEN;
            got += r;  // lens already zero
        }
    }
    memset(lit288, 0, 288);
    memset(dist32, 0, 32);
    memcpy(lit288, lens, hlit);
    memcpy(dist32, lens + hlit, hdist);
    return 0;
}

long long spt_build_index(const uint8_t* body, size_t n, uint64_t out_size,
                          uint32_t ob, uint32_t max_blocks,
                          uint64_t* bit_pos, uint32_t* skip,
                          uint32_t* n_tokens, uint32_t* unit_block,
                          uint8_t* unit_kind, uint32_t* eob_jump,
                          uint32_t* gap_off, uint32_t* gap_len,
                          uint32_t* pair_steps,
                          uint8_t* lit_lengths,
                          uint8_t* dist_lengths, uint64_t* info) {
    if (!out_size || n < 4 || ob < 64) return 0;
    const uint32_t GAP_NONE = 0xFFFF;
    BitReader br{body, n};

    uint64_t U = (out_size + ob - 1) / ob;
    for (uint64_t u = 0; u < U; u++) {
        bit_pos[u] = 0; skip[u] = 0; n_tokens[u] = 0;
        unit_block[u] = 0; unit_kind[u] = 0; eob_jump[u] = 0;
        gap_off[u] = GAP_NONE; gap_len[u] = 0; pair_steps[u] = 0;
    }
    uint64_t o = 0, unit = 0, unit_end = ob, toks = 0, match_bytes = 0;
    uint64_t match_segs = 0;
    long long last_seg = -1;
    // lockstep steps when the device kernel absorbs trailing literals:
    // a step consumes token t, plus token t+1 iff t is a literal or
    // match (not EOB) and t+1 is a literal
    uint64_t psteps = 0;
    bool pend_open = false;
    bool unit_open = false, stored_open = false;
    uint32_t chain_gap = 0;
    long long pending_unit = -1;
    uint64_t pending_end = 0;
    uint32_t n_blocks = 0;
    std::vector<uint32_t> lit_table, dist_table;
    int final_blk = 0;

    for (;;) {
        int final_ = br.read(1);
        int btype = br.read(2);
        final_blk = final_;
        if (br.overrun()) return SPT_E_TABLE;
        if (btype == 3) return SPT_E_BLOCKTYPE;
        if (btype == 0) {
            // ---- stored block -----------------------------------------
            br.align();
            uint32_t len = br.read(16);
            uint32_t nlen = br.read(16);
            if ((len ^ 0xFFFF) != nlen) return SPT_E_PARITY;
            uint64_t db0 = br.byte_cursor();
            if ((db0 + len) > n) return SPT_E_TABLE;
            // an empty stored block (flush marker) inside an open stored
            // chain stacks another 5-byte header onto the copy-source
            // gap (recorded per unit in gap_len)
            if (len == 0 && stored_open) {
                chain_gap += 5;
                if (final_) break;
                continue;
            }
            if (len > 0) {
                if (pending_unit >= 0) return 0;  // token/stored mix
                if (o + len > out_size) return 0;
                if (o % ob != 0) {
                    if (!stored_open) return 0;   // huffman/stored mix
                    if (gap_off[unit] != GAP_NONE) return 2;  // >1 gap in
                    // one unit: the v5 HOST walker carries extra gaps —
                    // return the retry code instead of "not indexable"
                    gap_off[unit] = (uint32_t)(o % ob);
                    gap_len[unit] = chain_gap + 5;
                }
                uint64_t end_o = o + len;
                uint64_t first_u = (o % ob == 0) ? o / ob : o / ob + 1;
                for (uint64_t u = first_u; u < (end_o + ob - 1) / ob; u++) {
                    bit_pos[u] = (db0 + (u * ob - o)) * 8;
                    skip[u] = 0;
                    n_tokens[u] = 0;
                    unit_kind[u] = 1;
                    unit_block[u] = n_blocks ? n_blocks - 1 : 0;
                }
                o = end_o;
                unit = end_o / ob < U ? end_o / ob : U - 1;
                unit_end = (unit + 1) * ob;
                toks = 0;
                unit_open = false;
                stored_open = end_o % ob != 0 && end_o != out_size;
                chain_gap = 0;
            }
            // seek past the stored data (byte-aligned)
            br.pos = db0 + len;
            br.acc = 0;
            br.bits = 0;
            if (final_) break;
            continue;
        }
        // ---- huffman block --------------------------------------------
        if (stored_open) return 0;  // tokens would mix into a stored unit
        if (n_blocks >= max_blocks) return 0;
        uint8_t* lit288 = lit_lengths + (size_t)n_blocks * 288;
        uint8_t* dist32 = dist_lengths + (size_t)n_blocks * 32;
        int perr = parse_huffman_tables(br, btype, lit288, dist32);
        if (perr < 0) return perr;
        uint32_t bid = n_blocks++;
        int lit_w = build_table(lit288, 288, 15, lit_table);
        if (lit_w < 0) return SPT_E_TABLE;
        bool have_dist = false;
        for (int i = 0; i < 32; i++) have_dist |= dist32[i] != 0;
        int dist_w = 1;
        if (have_dist) {
            dist_w = build_table(dist32, 32, 15, dist_table);
            if (dist_w < 0) return SPT_E_TABLE;
        } else {
            dist_table.assign(2, 0);
        }
        // a pending boundary jump is finalized at this block's FIRST
        // token (below) so empty flush blocks fold into the jump

        // ---- token walk -----------------------------------------------
        bool eob = false;
        bool first_tok = true;
        for (;;) {
            uint64_t tbit = br.pos * 8 - br.bits;
            uint32_t e = lit_table[br.peek(lit_w)];
            int l = e >> 16, sym = e & 0xFFFF;
            if (!l || br.overrun()) return SPT_E_TABLE;
            if (first_tok && pending_unit >= 0) {
                if (sym == 256 && unit_open && !final_) {
                    // empty block: fold header+EOB into the jump and
                    // drop its tables (the crossing unit's second table
                    // column is unit_block+1, the next REAL block)
                    n_blocks--;
                    br.drop(l);
                    pending_end = br.pos * 8 - br.bits;
                    eob = true;
                    break;
                }
                if (eob_jump[pending_unit] != 0) return 0;  // 2nd bound
                if (tbit <= pending_end ||
                    tbit - pending_end > 0xFFFFFFFFull)
                    return 0;
                eob_jump[pending_unit] = (uint32_t)(tbit - pending_end);
                pending_unit = -1;
            }
            first_tok = false;
            br.drop(l);
            uint64_t tlen = 0;
            if (sym == 256) {
                if (unit_open && !final_) {
                    toks++;  // boundary EOB: zero-output token
                    psteps++;
                    pend_open = false;
                    pending_unit = (long long)unit;
                }
                pending_end = br.pos * 8 - br.bits;
                eob = true;
            } else if (sym < 256) {
                if (!unit_open) {
                    bit_pos[unit] = tbit;
                    skip[unit] = 0;
                    unit_block[unit] = bid;
                    unit_open = true;
                    toks = 0;
                    psteps = 0;
                    pend_open = false;
                }
                tlen = 1;
            } else if (sym > 285) {
                return SPT_E_TABLE;
            } else {
                if (!unit_open) {
                    bit_pos[unit] = tbit;
                    skip[unit] = 0;
                    unit_block[unit] = bid;
                    unit_open = true;
                    toks = 0;
                    psteps = 0;
                    pend_open = false;
                }
                int dec = sym - 257;
                uint32_t run = RUN_BASE[dec] + br.read(RUN_EXTRA[dec]);
                uint32_t e2 = dist_table[br.peek(dist_w)];
                int dl = e2 >> 16, dsym = e2 & 0xFFFF;
                if (!dl || dsym > 29) return SPT_E_TABLE;
                br.drop(dl);
                uint32_t dist = DIST_BASE[dsym] + br.read(DIST_EXTRA[dsym]);
                if (dist > o) return SPT_E_DISTANCE;
                match_bytes += run;
                long long s0 = (long long)(o >> 6);
                long long s1 = (long long)((o + run - 1) >> 6);
                long long lo = (s0 - 1 > last_seg) ? s0 - 1 : last_seg;
                match_segs += (uint64_t)(s1 - lo);
                last_seg = s1;
                tlen = run;
            }
            if (eob) break;
            toks++;
            if (sym < 256 && pend_open) {
                pend_open = false;        // absorbed into the open step
            } else {
                psteps++;
                pend_open = true;         // lit/match both leave a slot
            }
            o += tlen;
            if (o > out_size) return SPT_E_OUTPUT;
            while (o >= unit_end && unit + 1 < U) {
                n_tokens[unit] = (uint32_t)toks;
                pair_steps[unit] = (uint32_t)psteps;
                unit++;
                if (o > unit_end) {
                    // a crossing token is always a match (tlen > 1)
                    bit_pos[unit] = tbit;
                    skip[unit] = (uint32_t)(tlen - (o - unit_end));
                    unit_block[unit] = bid;
                    unit_open = true;
                    toks = 1;
                    psteps = 1;
                } else {
                    unit_open = false;
                    toks = 0;
                    psteps = 0;
                }
                // a crossing match (toks == 1) may still absorb a
                // following literal; an exact boundary starts closed
                pend_open = toks == 1;
                unit_end += ob;
            }
        }
        if (final_) break;
    }
    (void)final_blk;
    if (unit_open || toks) {
        n_tokens[unit] = (uint32_t)toks;
        pair_steps[unit] = (uint32_t)psteps;
    }
    if (o != out_size) return 0;
    info[0] = br.pos * 8 - br.bits;  // end bit
    info[1] = match_bytes;
    info[2] = match_segs;
    info[3] = n_blocks ? n_blocks : 0;
    for (uint64_t u = 0; u < U; u++) {
        if (n_tokens[u] > 0xFFFF || skip[u] > 0xFFFF) return 0;
        if (u && bit_pos[u] - bit_pos[u - 1] > 0xFFFFFFFFull) return 0;
    }
    return (long long)U;
}

}  // extern "C"\n