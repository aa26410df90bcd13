// spt_native deflate: hash-chain LZ77 + dynamic-Huffman DEFLATE encoder.
//
// Level semantics match the reference's DeflatorSearch table
// (Sources/LZ77/Deflator/LZ77.DeflatorSearch.swift:13-35): 0–3 greedy,
// 4–7 lazy, 8–13 full minimum-cost-path with iterated cost refinement
// (DeflatorMatches.swift:225-379).  Code lengths come from package-merge
// (optimal length-limited, ≤ the reference's heap+limitHeight sizes).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <unordered_map>

extern "C" {
uint32_t spt_crc32(const uint8_t*, size_t, uint32_t);
uint32_t spt_adler32(const uint8_t*, size_t, uint32_t);
}

namespace {

const uint16_t RUN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
    35,43,51,59,67,83,99,115,131,163,195,227,258};
const uint8_t RUN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,
    4,4,4,4,5,5,5,5,0};
const uint16_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,
    193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,
    9,9,10,10,11,11,12,12,13,13};
const uint8_t CLO[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

// decade tables built through C++11 magic statics (thread-safe once-init)
int run_decade(int run) {
    static const std::vector<int> table = [] {
        std::vector<int> t(259, 0);
        for (int d = 0; d < 29; d++) {
            int base = RUN_BASE[d], span = 1 << RUN_EXTRA[d];
            for (int r = base; r < base + span && r <= 258; r++) t[r] = d;
        }
        t[258] = 28;
        return t;
    }();
    return table[run];
}

int dist_decade(int dist) {
    static const std::vector<int> table = [] {
        std::vector<int> t(32769, 0);
        for (int d = 0; d < 30; d++) {
            int base = DIST_BASE[d];
            long span = 1L << DIST_EXTRA[d];
            for (long x = base; x < base + span && x <= 32768; x++)
                t[x] = d;
        }
        return t;
    }();
    return table[dist];
}

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int bits = 0;

    void write(uint32_t v, int c) {
        acc |= (uint64_t)(v & ((1u << c) - 1)) << bits;
        bits += c;
        while (bits >= 8) {
            out.push_back((uint8_t)acc);
            acc >>= 8;
            bits -= 8;
        }
    }
    void pad() { if (bits) { out.push_back((uint8_t)acc); acc = 0; bits = 0; } }
    void bytes(const uint8_t* p, size_t n) {
        pad();
        out.insert(out.end(), p, p + n);
    }
};

uint32_t rev_bits(uint32_t c, int l) {
    uint32_t r = 0;
    for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
    return r;
}

// package-merge optimal length-limited code lengths
// (huffman.py lengths_from_frequencies counterpart)
void pm_lengths(const long* freq, int n, int limit, bool force, uint8_t* out) {
    memset(out, 0, n);
    std::vector<int> used;
    for (int s = 0; s < n; s++) if (freq[s]) used.push_back(s);
    if (used.empty()) {
        if (force && n >= 2) out[0] = out[1] = 1;
        return;
    }
    if (used.size() == 1) {
        out[used[0]] = 1;
        if (force && n >= 2) out[used[0] != 0 ? 0 : 1] = 1;
        return;
    }
    struct Item { long w; std::vector<int> syms; };
    std::vector<Item> items;
    for (int s : used) items.push_back({freq[s], {s}});
    std::sort(items.begin(), items.end(),
              [](const Item& a, const Item& b) {
                  return a.w != b.w ? a.w < b.w : a.syms[0] < b.syms[0]; });
    std::vector<Item> level = items;
    for (int it = 0; it < limit - 1; it++) {
        std::vector<Item> paired;
        for (size_t i = 0; i + 1 < level.size(); i += 2) {
            Item m{level[i].w + level[i + 1].w, level[i].syms};
            m.syms.insert(m.syms.end(), level[i + 1].syms.begin(),
                          level[i + 1].syms.end());
            paired.push_back(std::move(m));
        }
        for (const Item& x : items) paired.push_back(x);
        std::stable_sort(paired.begin(), paired.end(),
                         [](const Item& a, const Item& b) { return a.w < b.w; });
        level = std::move(paired);
    }
    size_t take = 2 * used.size() - 2;
    for (size_t i = 0; i < take && i < level.size(); i++)
        for (int s : level[i].syms) out[s]++;
}

void canonical_codes(const uint8_t* lengths, int n, uint16_t* codes) {
    int counts[16] = {0};
    for (int s = 0; s < n; s++) counts[lengths[s]]++;
    counts[0] = 0;
    int next_code[17] = {0}, code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    for (int s = 0; s < n; s++)
        codes[s] = lengths[s] ? next_code[lengths[s]]++ : 0;
}

// term packing identical to the Python tier (LZ77.DeflatorTerm.swift)
inline uint32_t pack_literal(int v) { return 0xF8000000u | v; }
inline uint32_t pack_match(int run, int dist) {
    int rd = run_decade(run), dd = dist_decade(dist);
    return ((uint32_t)dd << 27) | ((uint32_t)(dist - DIST_BASE[dd]) << 14)
        | ((uint32_t)(run - RUN_BASE[rd]) << 9) | 0x100 | rd;
}

void emit_metaterms(const std::vector<int>& lengths,
                    std::vector<std::pair<int, int>>& terms) {
    size_t i = 0, n = lengths.size();
    while (i < n) {
        int value = lengths[i];
        size_t j = i;
        while (j < n && lengths[j] == value) j++;
        int reps = (int)(j - i);
        if (value == 0) {
            while (reps > 138) { terms.push_back({18, 138 - 11}); reps -= 138; }
            if (reps > 10) terms.push_back({18, reps - 11});
            else if (reps > 2) terms.push_back({17, reps - 3});
            else for (int k = 0; k < reps; k++) terms.push_back({0, 0});
        } else {
            terms.push_back({value, 0});
            reps -= 1;
            while (reps > 6) { terms.push_back({16, 6 - 3}); reps -= 6; }
            if (reps > 2) terms.push_back({16, reps - 3});
            else for (int k = 0; k < reps; k++) terms.push_back({value, 0});
        }
        i = j;
    }
}

void write_dynamic_block(BitWriter& bw, const std::vector<uint32_t>& terms,
                         bool final_, const uint8_t* ll, const uint8_t* dl) {
    uint16_t lc[288], dc[30];
    canonical_codes(ll, 288, lc);
    canonical_codes(dl, 30, dc);
    int r = 257;
    for (int s = 0; s < 288; s++) if (ll[s] && s + 1 > r) r = s + 1;
    int d = 1;
    for (int s = 0; s < 30; s++) if (dl[s]) d = s + 1;
    std::vector<int> seq;
    for (int s = 0; s < r; s++) seq.push_back(ll[s]);
    for (int s = 0; s < d; s++) seq.push_back(dl[s]);
    std::vector<std::pair<int, int>> meta;
    emit_metaterms(seq, meta);
    long mfreq[19] = {0};
    for (auto& t : meta) mfreq[t.first]++;
    uint8_t mlen[19];
    pm_lengths(mfreq, 19, 7, false, mlen);
    uint16_t mcode[19];
    canonical_codes(mlen, 19, mcode);
    int hclen = 19;
    while (hclen > 4 && mlen[CLO[hclen - 1]] == 0) hclen--;

    bw.write(final_ ? 1 : 0, 1);
    bw.write(2, 2);
    bw.write(r - 257, 5);
    bw.write(d - 1, 5);
    bw.write(hclen - 4, 4);
    for (int i = 0; i < hclen; i++) bw.write(mlen[CLO[i]], 3);
    for (auto& t : meta) {
        bw.write(rev_bits(mcode[t.first], mlen[t.first]), mlen[t.first]);
        if (t.first == 16) bw.write(t.second, 2);
        else if (t.first == 17) bw.write(t.second, 3);
        else if (t.first == 18) bw.write(t.second, 7);
    }
    for (uint32_t term : terms) {
        if (term >> 27 == 31 && !(term & 0x100)) {
            int v = term & 0xFF;
            bw.write(rev_bits(lc[v], ll[v]), ll[v]);
        } else {
            int rd = term & 0xFF, dd = term >> 27;
            int s = 257 + rd;
            bw.write(rev_bits(lc[s], ll[s]), ll[s]);
            if (RUN_EXTRA[rd]) bw.write((term >> 9) & 0x1F, RUN_EXTRA[rd]);
            bw.write(rev_bits(dc[dd], dl[dd]), dl[dd]);
            if (DIST_EXTRA[dd]) bw.write((term >> 14) & 0x1FFF,
                                         DIST_EXTRA[dd]);
        }
    }
    bw.write(rev_bits(lc[256], ll[256]), ll[256]);
}

void trees_from_terms(const std::vector<uint32_t>& terms, uint8_t* ll,
                      uint8_t* dl) {
    long lfreq[288] = {0}, dfreq[30] = {0};
    for (uint32_t term : terms) {
        if (term >> 27 == 31 && !(term & 0x100)) lfreq[term & 0xFF]++;
        else { lfreq[257 + (term & 0xFF)]++; dfreq[term >> 27]++; }
    }
    lfreq[256] = 1;
    pm_lengths(lfreq, 286, 15, true, ll);
    ll[286] = ll[287] = 0;
    pm_lengths(dfreq, 30, 15, false, dl);
}

struct Searcher {
    static const int HBITS = 16;
    const uint8_t* data;
    size_t n;
    std::vector<int32_t> head, prev;
    int attempts, goal;
    size_t max_dist;  // window size from the requested exponent (<= 32768)
    size_t inserted = 0;

    Searcher(const uint8_t* d, size_t len, int att, int g,
             size_t maxd = 32768)
        : data(d), n(len), head(1 << HBITS, -1), prev(len, -1),
          attempts(att), goal(g), max_dist(maxd) {}

    uint32_t hash(size_t p) const {
        uint32_t key;
        memcpy(&key, data + p, 4);
        return (key * 2654435761u) >> (32 - HBITS);
    }
    void insert_upto(size_t pos) {
        size_t hi = n >= 3 ? std::min(pos, n - 3) : 0;
        for (; inserted < hi; inserted++) {
            uint32_t h = hash(inserted);
            prev[inserted] = head[h];
            head[h] = (int32_t)inserted;
        }
    }
    // best (run, dist); run < 6 means "emit literal" per the reference's
    // match threshold (DeflatorWindow.match, …Window.swift:128-141)
    void best(size_t pos, int limit, int& brun, int& bdist) const {
        brun = 0; bdist = 0;
        if (limit < 4 || pos + 4 > n) return;
        uint32_t key;
        memcpy(&key, data + pos, 4);
        int32_t cand = pos < prev.size() ? prev[pos] : -1;
        int tries = attempts;
        while (cand >= 0 && tries > 0 && pos - cand <= max_dist) {
            uint32_t ck;
            memcpy(&ck, data + cand, 4);
            if (ck == key) {
                tries--;
                int run = 4;
                while (run < limit && data[cand + run] == data[pos + run])
                    run++;
                if (run > brun) {
                    brun = run;
                    bdist = (int)(pos - cand);
                    if (run >= goal || run >= limit) break;
                }
            }
            cand = prev[cand];
        }
    }
    // all candidate (run, dist) pairs for the optimal-parse DAG
    void all(size_t pos, int limit,
             std::vector<std::pair<int, int>>& out) const {
        out.clear();
        if (limit < 4 || pos + 4 > n) return;
        uint32_t key;
        memcpy(&key, data + pos, 4);
        int32_t cand = pos < prev.size() ? prev[pos] : -1;
        int tries = attempts;
        while (cand >= 0 && tries > 0 && pos - cand <= max_dist) {
            uint32_t ck;
            memcpy(&ck, data + cand, 4);
            if (ck == key) {
                tries--;
                int run = 4;
                while (run < limit && data[cand + run] == data[pos + run])
                    run++;
                out.push_back({run, (int)(pos - cand)});
                if (run >= goal) break;
            }
            cand = prev[cand];
        }
    }
};

struct Depths {  // DeflatorMatches.Depths (0.25-bit fixed point)
    uint32_t s[542];
    bool generic = true;

    Depths() { reset(); }
    void reset() {
        for (int i = 0; i < 256; i++) s[i] = 33;
        for (int r = 3; r <= 258; r++)
            s[253 + r] = 30 + (RUN_EXTRA[run_decade(r)] << 2);
        for (int d = 0; d < 30; d++) s[512 + d] = 19 + (DIST_EXTRA[d] << 2);
    }
    void update(const uint8_t* ll, const uint8_t* dl) {
        for (int sym = 0; sym < 286; sym++) {
            int l = ll[sym];
            if (!l) continue;
            if (sym < 256) s[sym] = l << 2;
            else if (sym > 256) {
                int d = sym - 257;
                int span = 1 << RUN_EXTRA[d];
                int lo = 253 + RUN_BASE[d];
                for (int k = lo; k < std::min(lo + span, 512); k++)
                    s[k] = (l + RUN_EXTRA[d]) << 2;
            }
        }
        for (int d = 0; d < 30; d++)
            if (dl[d]) s[512 + d] = (dl[d] + DIST_EXTRA[d]) << 2;
        generic = false;
    }
    void generalize() {
        Depths def;
        for (int i = 0; i < 542; i++)
            s[i] = (s[i] & def.s[i]) + ((s[i] ^ def.s[i]) >> 1);
    }
};

struct Params { int strategy, attempts, goal, iterations; };

Params search_parameters(int level) {
    // DeflatorSearch.swift:13-35 (strategy 0 greedy, 1 lazy, 2 full)
    static const Params table[13] = {
        {0, 1, 6, 0}, {0, 2, 8, 0}, {0, 4, 10, 0}, {0, 40, 24, 0},
        {1, 20, 32, 0}, {1, 40, 54, 0}, {1, 64, 80, 0}, {1, 100, 160, 0},
        {2, 14, 20, 1}, {2, 20, 32, 2}, {2, 30, 50, 3}, {2, 60, 80, 4},
        {2, 100, 133, 5},
    };
    if (level <= 0) return table[0];
    if (level >= 13) return {2, 1 << 30, 258, 6};
    return table[level];
}

const size_t GRAPH_NODES = 16384;

void optimal_parse(const uint8_t* data, size_t start, size_t stop, size_t n,
                   Searcher& win, Depths& depths, int iterations,
                   std::vector<uint32_t>& terms) {
    size_t nn = stop - start;
    std::vector<std::vector<std::pair<int, int>>> edges(nn);
    std::vector<std::pair<int, int>> tmp;
    for (size_t p = start; p < stop; p++) {
        int limit = (int)std::min<size_t>({n - p, 258, stop - p});
        win.insert_upto(p + 1);
        win.all(p, limit, edges[p - start]);
    }
    int iters = std::max(1, iterations * (depths.generic ? 2 : 1));
    const long long INF = 1LL << 60;
    std::vector<long long> cost(nn + 1);
    std::vector<int> from_len(nn + 1), from_dist(nn + 1);
    for (int it = 0; it < iters; it++) {
        std::fill(cost.begin(), cost.end(), INF);
        cost[0] = 0;
        for (size_t i = 0; i < nn; i++) {
            long long ci = cost[i];
            if (ci >= INF) continue;
            long long c = ci + depths.s[data[start + i]];
            if (c < cost[i + 1]) {
                cost[i + 1] = c;
                from_len[i + 1] = 1;
                from_dist[i + 1] = 0;
            }
            if (nn - i < 3) continue;
            for (auto& e : edges[i]) {
                int dd = dist_decade(e.second);
                long long dc = ci + depths.s[512 + dd];
                int maxlen = (int)std::min<size_t>(e.first, nn - i);
                for (int len = 3; len <= maxlen; len++) {
                    long long cc = dc + depths.s[253 + len];
                    if (cc < cost[i + len]) {
                        cost[i + len] = cc;
                        from_len[i + len] = len;
                        from_dist[i + len] = e.second;
                    }
                }
            }
        }
        terms.clear();
        size_t i = nn;
        while (i > 0) {
            int len = from_len[i];
            if (len == 1) terms.push_back(pack_literal(data[start + i - 1]));
            else terms.push_back(pack_match(len, from_dist[i]));
            i -= len;
        }
        std::reverse(terms.begin(), terms.end());
        if (it + 1 < iters) {
            uint8_t ll[288], dl[30];
            trees_from_terms(terms, ll, dl);
            depths.update(ll, dl);
        }
    }
}

}  // namespace

extern "C" {

long long spt_deflate_blocks_w(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t dstcap, int level, int format,
                               long block_terms, int exponent);

// format: 0 = zlib, 1 = raw/ios, 2 = gzip.  Returns bytes written or <0.
// block_terms: token budget per dynamic block (0 → default 16384); larger
// blocks decode faster on the device path (fewer dispatch-bound rounds).
long long spt_deflate_blocks(const uint8_t* src, size_t n, uint8_t* dst,
                             size_t dstcap, int level, int format,
                             long block_terms) {
    return spt_deflate_blocks_w(src, n, dst, dstcap, level, format,
                                block_terms, 15);
}

// exponent 8…15 selects the match window (1 << e) and, for zlib, the
// declared CINFO — the reference honors it end-to-end
// (LZ77.DeflatorBuffers.swift:22-23, LZ77.StreamHeader.swift:56-62)
long long spt_deflate_blocks_w(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t dstcap, int level, int format,
                               long block_terms, int exponent) {
    if (exponent < 8 || exponent > 15) return -7;
    Params par = search_parameters(level);
    // per-call block budget (no mutable global: the batch entry
    // points run deflate on concurrent threads)
    const size_t BLOCK_TERMS = block_terms > 0 ? (size_t)block_terms
                                               : 16384;
    BitWriter bw;
    if (format == 0) {
        uint8_t cmf = (uint8_t)(((exponent - 8) << 4) | 0x08);
        uint8_t flg = (uint8_t)(~((cmf * 256) % 31) & 31);
        bw.out.push_back(cmf);
        bw.out.push_back(flg);
    } else if (format == 2) {
        const uint8_t hdr[10] = {0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 0xFF};
        bw.out.insert(bw.out.end(), hdr, hdr + 10);
    }

    if (n < 3) {
        bw.write(1, 1);
        bw.write(0, 2);
        bw.pad();
        bw.write((uint32_t)n, 16);
        bw.write(~(uint32_t)n & 0xFFFF, 16);
        bw.bytes(src, n);
    } else {
        Searcher win(src, n, par.attempts, par.goal,
                     (size_t)1 << exponent);
        Depths depths;
        std::vector<uint32_t> terms;
        terms.reserve(BLOCK_TERMS + 4);
        if (par.strategy == 2) {
            // parse chunking (GRAPH_NODES input bytes per DAG) is
            // decoupled from block framing when a block budget is
            // requested explicitly: terms accumulate until block_terms,
            // so a large budget yields the single-block streams the
            // indexed device decoder prefers.  Default (block_terms 0)
            // keeps one block per parse chunk — per-chunk trees track
            // local statistics and measure ~0.2 % smaller on the
            // reference baselines.
            const bool budgeted = block_terms > 0;
            std::vector<uint32_t> pending;
            pending.reserve(BLOCK_TERMS + GRAPH_NODES);
            size_t pos = 0;
            while (pos < n) {
                size_t stop = std::min(n, pos + GRAPH_NODES);
                if (n - stop < 3) stop = n;
                optimal_parse(src, pos, stop, n, win, depths,
                              par.iterations, terms);
                pending.insert(pending.end(), terms.begin(), terms.end());
                terms.clear();
                depths.generalize();
                pos = stop;
                if (!budgeted || pending.size() >= BLOCK_TERMS
                        || pos == n) {
                    uint8_t ll[288], dl[30];
                    trees_from_terms(pending, ll, dl);
                    write_dynamic_block(bw, pending, pos == n, ll, dl);
                    pending.clear();
                }
            }
        } else {
            // greedy/lazy parse under a given short-match policy: the
            // reference accepts only run > 5 (DeflatorWindow.match,
            // ...Window.swift:121-130); runs of 4-5 at cheap distances
            // win big on short-match data (16-bit photographic rows),
            // so both policies are tried and the smaller stream kept
            auto parse = [&](int min_run, size_t short_far,
                             BitWriter& out) {
                Searcher w2(src, n, par.attempts, par.goal,
                            (size_t)1 << exponent);
                std::vector<uint32_t> tv;
                tv.reserve(BLOCK_TERMS + 4);
                bool lazy = par.strategy == 1;
                size_t pos = 0;
                auto ok = [&](int run, int dist) {
                    return run >= 6 || (run >= min_run
                                        && (size_t)dist < short_far);
                };
                while (pos < n) {
                    if (tv.size() >= BLOCK_TERMS) {
                        uint8_t ll[288], dl[30];
                        trees_from_terms(tv, ll, dl);
                        write_dynamic_block(out, tv, false, ll, dl);
                        tv.clear();
                    }
                    int limit = (int)std::min<size_t>(n - pos, 258);
                    w2.insert_upto(pos + 1);
                    int run, dist;
                    w2.best(pos, limit, run, dist);
                    if (ok(run, dist)) {
                        if (lazy && pos + 1 < n) {
                            w2.insert_upto(pos + 2);
                            int run2, dist2;
                            w2.best(pos + 1,
                                    (int)std::min<size_t>(n - pos - 1, 258),
                                    run2, dist2);
                            if (run2 > run && ok(run2, dist2)) {
                                tv.push_back(pack_literal(src[pos]));
                                tv.push_back(pack_match(run2, dist2));
                                w2.insert_upto(pos + 1 + run2);
                                pos += 1 + run2;
                                continue;
                            }
                        }
                        tv.push_back(pack_match(run, dist));
                        w2.insert_upto(pos + run);
                        pos += run;
                    } else {
                        tv.push_back(pack_literal(src[pos]));
                        pos += 1;
                    }
                }
                uint8_t ll[288], dl[30];
                trees_from_terms(tv, ll, dl);
                write_dynamic_block(out, tv, true, ll, dl);
            };
            BitWriter a, b;
            parse(6, 0, a);         // reference policy
            parse(4, 1024, b);      // short-cheap policy
            size_t abits = a.out.size() * 8 + a.bits;
            size_t bbits = b.out.size() * 8 + b.bits;
            BitWriter& winner = bbits < abits ? b : a;
            // bit-append the winning block section after the header
            for (uint8_t byte : winner.out) bw.write(byte, 8);
            if (winner.bits) bw.write((uint32_t)winner.acc, winner.bits);
        }
    }
    bw.pad();
    if (format == 0) {
        uint32_t a = spt_adler32(src, n, 1);
        uint8_t t[4] = {(uint8_t)(a >> 24), (uint8_t)(a >> 16),
                        (uint8_t)(a >> 8), (uint8_t)a};
        bw.out.insert(bw.out.end(), t, t + 4);
    } else if (format == 2) {
        uint32_t c = spt_crc32(src, n, 0);
        uint8_t t[8] = {(uint8_t)c, (uint8_t)(c >> 8), (uint8_t)(c >> 16),
                        (uint8_t)(c >> 24), (uint8_t)n, (uint8_t)(n >> 8),
                        (uint8_t)(n >> 16), (uint8_t)(n >> 24)};
        bw.out.insert(bw.out.end(), t, t + 8);
    }
    if (bw.out.size() > dstcap) return -6;
    memcpy(dst, bw.out.data(), bw.out.size());
    return (long long)bw.out.size();
}

long long spt_deflate(const uint8_t* src, size_t n, uint8_t* dst,
                      size_t dstcap, int level, int format) {
    return spt_deflate_blocks(src, n, dst, dstcap, level, format, 0);
}

// Sample statistics for the device optimal parse: one greedy pass at
// `level`'s search parameters over `src`, histogramming the match
// distances it finds plus the lit/run-symbol and distance-decade
// frequencies.  Feeds the distance menu and the Depths warm start
// without the Python-side token walk (which cost ~30 ms per image).
// Writes up to `topn` most frequent distances to `top_out`; returns the
// count written.
long long spt_sample_stats(const uint8_t* src, size_t n, int level,
                           int32_t* top_out, int topn,
                           long long* lit_freq /*286*/,
                           long long* dist_freq /*30*/) {
    memset(lit_freq, 0, 286 * sizeof(long long));
    memset(dist_freq, 0, 30 * sizeof(long long));
    if (n < 8) return 0;
    Params par = search_parameters(level >= 8 ? 7 : level);
    Searcher win(src, n, par.attempts, par.goal, 32768);
    std::unordered_map<int, long long> hist;
    size_t pos = 0;
    while (pos < n) {
        int limit = (int)std::min<size_t>(n - pos, 258);
        win.insert_upto(pos + 1);
        int run, dist;
        win.best(pos, limit, run, dist);
        if (run >= 6) {
            hist[dist] += 1;
            lit_freq[257 + run_decade(run)] += 1;
            dist_freq[dist_decade(dist)] += 1;
            win.insert_upto(pos + run);
            pos += run;
        } else {
            lit_freq[src[pos]] += 1;
            pos += 1;
        }
    }
    lit_freq[256] += 1;
    std::vector<std::pair<long long, int>> order;
    order.reserve(hist.size());
    for (auto& kv : hist) order.push_back({kv.second, kv.first});
    std::sort(order.begin(), order.end(),
              [](const auto& a, const auto& b) {
                  return a.first != b.first ? a.first > b.first
                                            : a.second < b.second;
              });
    int k = 0;
    for (auto& e : order) {
        if (k >= topn) break;
        top_out[k++] = e.second;
    }
    return k;
}

}  // extern "C"
