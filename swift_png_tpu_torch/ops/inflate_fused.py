"""The general DEFLATE inflate, position-parallel, as torch ops on a device.

Counterpart of ``swift_png_tpu/ops/inflate_fused.py`` (XLA code with no
Pallas kernel).  Per block, on the device:

* a dynamic block's code-length code is decoded at every bit position of
  a 1 KB window, and pointer doubling over the positions picks the path of
  transmitted symbols (no sequential scan);
* token decode uses canonical compare decoding: the code length is the
  number of left-aligned thresholds ``T[l] = lim[l] << (15 - l)`` at or
  below the reversed 15-bit window (a ``searchsorted``, as the thresholds
  never decrease), then one gather into the length-sorted symbol table;
* every bit position of the block's window decodes one token, and pointer
  doubling extracts the path of ``t_max`` ranks from the block's first
  bit; its first end-of-block code ends the block.

Each block's tokens (literal, match or stored run) go into one token
buffer; after the last block a scatter-max and a running maximum give each
output byte its token, and pointer doubling resolves the back-references.
The Adler-32 is computed on the device.

The JAX version runs the block loop in ``lax.while_loop`` and branches with
``lax.switch``/``lax.cond``.  Here the loop and the branches run on the
host: each block's three header bits and a stored block's length come from
the host copy of the compressed bytes, and each Huffman block ends with one
read of its token count, end bit and flags.  Every field the JAX function
returns is reproduced, corrupt streams included: ``lax.dynamic_slice``
clamps its start (so a window can begin before the block), JAX gathers
clamp their indices, and the token sums wrap as int32.  Words are int64 so that the shifts of the 32-bit window never
sign-extend.

:func:`inflate_fused_batch` runs B streams in lockstep, each block step over
the streams still decoding; every stream gets what :func:`inflate_fused`
gives it alone (as ``vmap`` of the JAX function does).

That is the plain version, for CPU tensors.  On a CUDA device every entry
point here launches ``inflate_stream`` (``csrc/inflate_stream.cu``)
instead: one warp per stream decodes the whole stream serially, with the
same status, end bit, block count, bytes and Adler-32, a failed stream's
included.  It also takes the retry loop of :class:`InflateFused`'s budgets
in one launch (:func:`_inflate_cuda`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels, trace
from .._host.lz77 import constants as C
from .._host.lz77.errors import (DecompressionError, GzipStreamHeaderError,
                                 StreamHeaderError)
from .._kernels import resolve_device

__all__ = ["inflate_fused", "InflateFused", "inflate_fused_batch",
           "InflateFusedBatch"]

# token kinds in the global buffer
K_LIT, K_MATCH, K_STORED = 0, 1, 2
# status flags
OK = 0
F_BAD_BLOCK = 1        # reserved block type / malformed header
F_BAD_CODE = 2         # invalid Huffman code on the token path
F_OVERFLOW = 4         # block exceeded the window or rank budget
F_TOO_MANY_BLOCKS = 8
F_OUTPUT_MISMATCH = 16
F_BAD_PARITY = 32
F_BAD_DISTANCE = 64

_MAX_SYMS = 288        # literal alphabet size; the dist tree uses 32
_TWIN_WORDS = 1 << 10  # code-length window: tables take < 2^13 bits
_M = 320               # ≤ 320 transmitted code-length symbols

_CONSTS: dict = {}


def _rev16(x):
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    return ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)


def _fixed_params():
    """The fixed block's literal and distance code lengths."""
    lit = np.zeros(_MAX_SYMS, np.int64)
    lit[:144] = 8
    lit[144:256] = 9
    lit[256:280] = 7
    lit[280:288] = 8
    return lit, np.full(32, 5, np.int64)


def _consts(dev: torch.device) -> dict:
    """Constant tables on ``dev`` (made once per device)."""
    c = _CONSTS.get(dev)
    if c is None:
        lit, dist = _fixed_params()
        t = {
            # 15-bit reversal: ``_rev16(x) >> 1`` for every 15-bit x
            "rev15": _rev16(np.arange(1 << 15, dtype=np.int64)) >> 1,
            "run_extra": C.RUN_EXTRA, "run_base": C.RUN_BASE,
            "dist_extra": C.DISTANCE_EXTRA, "dist_base": C.DISTANCE_BASE,
            "clo": np.array(C.CODELENGTH_ORDER),
            "fixed_lit": lit, "fixed_dist": dist,
        }
        c = {k: trace.upload(np.asarray(v, np.int64), dev)
             for k, v in t.items()}
        _CONSTS[dev] = c
    return c


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` with JAX's gather rule for the indices met here,
    which are never negative: an index past the end reads the last
    element."""
    return torch.gather(x, -1, idx.clamp(max=x.shape[-1] - 1))


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as JAX's int32 sums wrap."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _canonical_params(lengths: torch.Tensor):
    """Canonical decode parameters of ``(B, n)`` code lengths: ``(lim,
    first, offset, symbols)``, the first three ``(B, 16)`` for lengths
    0…15 (``lim[l] = first[l] + count[l]`` over MSB-first codes), then the
    ``(B, n)`` symbols sorted by (length, symbol), unused ones last."""
    B, n = lengths.shape
    dev = lengths.device
    counts = torch.zeros((B, 16), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, lengths.clamp(0, 15), (lengths > 0).long())
    counts[:, 0] = 0
    # first[l+1] = (first[l] + count[l]) << 1, first[1] = 0; closed form:
    # first[l] = Σ_{1 ≤ k < l} count[k] << (l - k)
    k = torch.arange(16, device=dev)
    shift = k[None, :] - k[:, None]                      # [k, l] = l - k
    use = (k[:, None] >= 1) & (shift > 0)
    first = ((counts[:, :, None] << shift.clamp(min=0)) * use).sum(1)
    lim = first + counts
    offset = torch.cumsum(counts, 1) - counts
    key = (torch.where(lengths > 0, lengths, 99) * 1024
           + torch.arange(n, device=dev))
    symbols = torch.argsort(key, dim=1)
    return lim, first, offset, symbols


def _canonical_decode(rev15, lim, first, offset, symbols):
    """Decode one MSB-first 15-bit reversed window per element of ``(B,
    N)`` ``rev15``.  The thresholds ``T[l] = lim[l] << (15 - l)`` never
    decrease (``T[l+1] - T[l] = count[l+1] << (14 - l)``), so the code
    length is ``1 + #{l ≥ 1 : rev15 ≥ T[l]}``.  Returns ``(length,
    symbol)``; length 0 ⇒ invalid code."""
    n = symbols.shape[1]
    T = lim << (15 - torch.arange(16, device=lim.device))
    l = 1 + torch.searchsorted(T[:, 1:].contiguous(), rev15, right=True)
    found = l <= 15
    ls = l.clamp(1, 15)
    code_l = rev15 >> (15 - ls)
    symidx = torch.gather(offset - first, 1, ls) + code_l
    sym = torch.gather(symbols, 1, symidx.clamp(0, n - 1))
    return torch.where(found, ls, 0), torch.where(found, sym, 0)


def _peek(W: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor):
    """≥ 25-bit little-endian windows at bit ``pos`` (``(R, m)``) of the
    word rows ``W[rows]``; the word index is clamped into ``W``."""
    w = W[rows[:, None], (pos >> 3).clamp(0, W.shape[1] - 1)]
    return w >> (pos & 7)


def _peek_win(Wwin: torch.Tensor, pos: torch.Tensor):
    """:func:`_peek` within one window per row (``pos`` ``(N,)`` or
    ``(R, N)``)."""
    idx = (pos >> 3).clamp(0, Wwin.shape[1] - 1)
    w = torch.gather(Wwin, 1, idx.expand(Wwin.shape[0], -1))
    return w >> (pos & 7)


def _window(W: torch.Tensor, rows: torch.Tensor, start: torch.Tensor,
            size: int) -> torch.Tensor:
    """``lax.dynamic_slice(W[row], (start,), (size,))`` per row: the start
    is clamped so that the slice stays inside the row."""
    s = start.clamp(0, W.shape[1] - size)
    return W[rows[:, None], s[:, None]
             + torch.arange(size, device=W.device)]


def _path(p0: torch.Tensor, nxt: torch.Tensor, ranks: int,
          clamp: bool) -> torch.Tensor:
    """``(R, ranks)``: the position reached from ``p0`` after r steps of
    ``nxt``, for every rank r.  Pointer doubling over the path itself:
    ranks ``[2^k, 2^(k+1))`` are ranks ``[0, 2^k)`` taken ``2^k`` steps on
    (the JAX version doubles with a masked update per rank, to the same
    positions).  With ``clamp``, indices past the end read the last
    element, as JAX's gathers do; without, they must be in range."""
    take = _take if clamp else (lambda x, i: torch.gather(x, 1, i))
    P = p0[:, None]
    jump = nxt
    while P.shape[1] < ranks:
        P = torch.cat([P, take(jump, P)], 1)
        if P.shape[1] < ranks:
            jump = take(jump, jump)
    return P[:, :ranks]


def _parse_dynamic(W: torch.Tensor, rows: torch.Tensor,
                   bitpos: torch.Tensor, c: dict):
    """Parse the dynamic Huffman descriptions at ``bitpos`` (``(R,)``) of
    the streams ``rows``.  Returns ``(pos_after_tables, lit_lengths (R,
    288), dist_lengths (R, 32), bad)``."""
    dev = W.device
    R = rows.shape[0]
    w = _peek(W, rows, bitpos[:, None])[:, 0]
    hlit = (w & 31) + 257
    hdist = ((w >> 5) & 31) + 1
    hclen = ((w >> 10) & 15) + 4
    # RFC 1951 caps: hlit ≤ 286, hdist ≤ 30, rejected up front
    hdr_bad = (hlit > 286) | (hdist > 30)
    pos = bitpos + 14
    i = torch.arange(19, device=dev)
    mvals = _peek(W, rows, pos[:, None] + 3 * i) & 7
    mvals = torch.where(i < hclen[:, None], mvals, 0)
    meta = torch.zeros((R, 19), dtype=torch.int64, device=dev)
    meta.scatter_(1, c["clo"].expand(R, -1), mvals)
    pos = pos + 3 * hclen
    mparams = _canonical_params(meta)
    total = hlit + hdist

    # position-parallel decode of the code-length stream over a small
    # window, the same path extraction as the token stage
    start_byte = pos >> 3
    Wwin = _window(W, rows, start_byte, _TWIN_WORDS)
    p = torch.arange(_TWIN_WORDS * 8 - 56, device=dev)
    w = _peek_win(Wwin, p)
    l, sym = _canonical_decode(c["rev15"][w & 0x7F], *mparams)
    is16 = sym == 16
    is17 = sym == 17
    is18 = sym == 18
    extra = torch.where(is16, 2, torch.where(is17, 3,
                                             torch.where(is18, 7, 0)))
    ebits = (w >> l) & ((1 << extra) - 1)
    count = torch.where(sym < 16, 1,
                        torch.where(is16 | is17, 3 + ebits, 11 + ebits))
    invalid = (l == 0) | (sym > 18)
    nxt = torch.where(invalid, p, p + l + extra)

    ranks = torch.arange(_M, device=dev)
    # a path may step past the window's end: clamped as JAX's gathers
    P = _path(pos & 7, nxt, _M, True)
    symP = _take(sym, P)
    countP = _take(count, P)
    is16P = _take(is16, P)
    starts = torch.cumsum(countP, 1) - countP   # code-length index
    live = starts < total[:, None]
    m_count = live.sum(1)                       # tokens actually consumed
    bad = (live & _take(invalid, P)).any(1)
    # exact fit: the last live token must land exactly on `total`
    end_idx = torch.where(live, starts + countP, 0).max(1).values
    bad = bad | (end_idx != total)
    # value per token: explicit length, 0 for 17/18, the previous token's
    # written length for 16 (0 after a 17/18 run — zlib semantics)
    v0 = torch.where(symP < 16, symP, 0)
    explicit = torch.where(is16P, -1, v0)
    # forward fill of the explicit values: the last one at or before i
    last = torch.cummax(torch.where(explicit >= 0, ranks, -1), 1).values
    filled = torch.where(last >= 0,
                         torch.gather(explicit, 1, last.clamp(min=0)), -1)
    prev_filled = torch.cat(
        [torch.full((R, 1), -1, dtype=torch.int64, device=dev),
         filled[:, :-1]], 1)
    vals = torch.where(is16P, prev_filled, v0)
    bad = bad | (live & is16P & (prev_filled < 0)).any(1)

    # scatter each token's rank at its start index, fill runs forward
    tid0 = torch.full((R, _M + 1), -1, dtype=torch.int64, device=dev)
    tid0.scatter_reduce_(1, torch.where(live, starts, _M).clamp(0, _M),
                         torch.where(live, ranks, -1), "amax")
    tid = torch.cummax(tid0[:, :_M], 1).values
    lens = torch.gather(vals, 1, tid.clamp(0, _M - 1))
    lens = torch.where((ranks < total[:, None]) & (tid >= 0), lens, 0)
    a288 = torch.arange(_MAX_SYMS, device=dev)
    lit_lengths = torch.where(a288 < hlit[:, None], lens[:, :_MAX_SYMS], 0)
    a32 = torch.arange(32, device=dev)
    dist_lengths = torch.where(
        a32 < hdist[:, None],
        torch.gather(lens, 1, (hlit[:, None] + a32).clamp(0, _M - 1)), 0)
    # bit position after the last live token
    last_rank = (m_count - 1).clamp(0, _M - 1)
    Pl = torch.gather(P, 1, last_rank[:, None])
    end_pos = (start_byte * 8 + Pl[:, 0] + _take(l, Pl)[:, 0]
               + _take(extra, Pl)[:, 0])
    end_pos = torch.where(m_count > 0, end_pos, pos)
    return end_pos, lit_lengths, dist_lengths, bad | hdr_bad


def _decode_window(Wwin: torch.Tensor, p0: torch.Tensor, lit_params,
                   dist_params, t_max: int, c: dict):
    """Position-parallel token decode and path extraction over one window
    per row.  Returns ``(T, end_rel, flag, chunk_kind, chunk_len,
    chunk_a)``: the first ``T`` path tokens (EOB excluded, tail zeroed),
    ``(R, t_max)``, and ``end_rel``, the bit after the EOB token relative
    to the window's base."""
    dev = Wwin.device
    WIN = Wwin.shape[1] * 8 - 56
    p = torch.arange(WIN, device=dev)
    w1 = _peek_win(Wwin, p)
    l, sym = _canonical_decode(c["rev15"][w1 & 0x7FFF], *lit_params)
    decade = (sym - 257).clamp(0, 28)
    eb = c["run_extra"][decade]
    run = c["run_base"][decade] + ((w1 >> l) & ((1 << eb) - 1))
    p2 = p + l + eb
    w2 = _peek_win(Wwin, p2)
    dl, dsym_raw = _canonical_decode(c["rev15"][w2 & 0x7FFF], *dist_params)
    dsym = dsym_raw.clamp(0, 29)
    db = c["dist_extra"][dsym]
    p3 = p2 + dl
    w3 = _peek_win(Wwin, p3)
    dist = c["dist_base"][dsym] + (w3 & ((1 << db) - 1))

    is_lit = (l > 0) & (sym < 256)
    is_eob = (l > 0) & (sym == 256)
    is_match = ((l > 0) & (sym >= 257) & (sym <= 285) & (dl > 0)
                & (dsym_raw <= 29))
    step = torch.where(is_lit | is_eob, l, l + eb + dl + db)
    nxt = p + step
    overflow = (nxt >= WIN) & ~is_eob
    # 0 lit / 1 match / 2 eob / 3 bad / 4 window-overflow
    kind = torch.where(is_lit, 0, torch.where(is_match, 1,
                                              torch.where(is_eob, 2, 3)))
    kind = torch.where(overflow & (kind != 2), 4, kind)
    nxt = torch.where(kind >= 2, p, nxt)

    ranks = torch.arange(t_max, device=dev)
    # every nxt lies inside the window: kinds 2-4 stay put
    P = _path(p0, nxt, t_max, False)
    kP = torch.gather(kind, 1, P)
    eob_hit = kP == 2
    has_eob = eob_hit.any(1)
    # the first EOB rank, 0 when there is none (``jnp.argmax``)
    T = torch.where(eob_hit, ranks, t_max).min(1).values
    T = torch.where(has_eob, T, 0)
    before = ranks < T[:, None]
    badpath = ((before & (kP == 3)).any(1)
               | (~has_eob & (kP == 3).any(1)))
    ovfpath = ~has_eob | (before & (kP == 4)).any(1)
    flag = torch.where(badpath, F_BAD_CODE,
                       torch.where(ovfpath, F_OVERFLOW, 0))
    PT = torch.gather(P, 1, T[:, None])
    end_rel = (PT + torch.gather(step, 1, PT))[:, 0]
    lit = kP == 0
    chunk_kind = torch.where(before, torch.where(lit, K_LIT, K_MATCH), 0)
    chunk_len = torch.where(
        before, torch.where(lit, 1, torch.gather(run, 1, P)), 0)
    chunk_a = torch.where(before, torch.where(
        lit, torch.gather(sym, 1, P), torch.gather(dist, 1, P)), 0)
    return T, end_rel, flag, chunk_kind, chunk_len, chunk_a


def _host_words(Dh: np.ndarray, rows: np.ndarray, k: np.ndarray):
    """The little-endian 32-bit words at byte ``k`` of the host streams
    ``Dh[rows]``, ``k`` clamped into the word array."""
    k = np.clip(k, 0, Dh.shape[1] - 4)
    b = Dh[rows[:, None], k[:, None] + np.arange(4)].astype(np.int64)
    return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24


def _adler_device(out: torch.Tensor, out_size: int) -> torch.Tensor:
    """Adler-32 of each row's first ``out_size`` bytes, on the device
    (int64 sums are exact, so the JAX version's chunked ``_mod_sum`` has no
    counterpart here)."""
    d = out[:, :out_size].long()
    w = out_size - torch.arange(out_size, device=out.device)
    s1 = (1 + d.sum(1)) % 65521
    s2 = (out_size + (w * d).sum(1)) % 65521
    return (s2 << 16) | s1


def _inflate(Dh: np.ndarray, Dd: torch.Tensor, out_size: int,
             win_words: int, t_max: int, max_blocks: int, tok_cap: int):
    """The fused inflate of the rows of ``Dh`` (host) / ``Dd`` (its copy on
    the device), in lockstep.  Returns ``(out (B, padded) uint8 on the
    device, status, end_bit, adler, blocks)``, the last four numpy
    ``(B,)``."""
    B, n = Dh.shape
    dev = Dd.device
    c = _consts(dev)
    d = Dd.long()
    W = d[:, :-3] | d[:, 1:-2] << 8 | d[:, 2:-1] << 16 | d[:, 3:] << 24
    TOKP = tok_cap + t_max + 1
    tk = torch.zeros((B, TOKP), dtype=torch.int64, device=dev)
    tl = torch.zeros_like(tk)
    ta = torch.zeros_like(tk)
    bitpos = np.zeros(B, np.int64)
    tok = np.zeros(B, np.int64)
    blk = np.zeros(B, np.int64)
    status = np.zeros(B, np.int64)
    done = np.zeros(B, bool)
    ar_t = torch.arange(t_max, device=dev)

    with trace.span("inflate_fused.blocks"):
        while True:
            act = np.nonzero(~done & (status == 0))[0]
            if act.size == 0:
                break
            bp = bitpos[act]
            hdr = (_host_words(Dh, act, bp >> 3) >> (bp & 7)) & 7
            final = (hdr & 1) == 1
            btype = hdr >> 1
            flag = np.where(btype == 3, F_BAD_BLOCK, 0)
            T = np.zeros(act.size, np.int64)
            end_bit = np.zeros(act.size, np.int64)
            tok_w = np.minimum(tok[act], tok_cap)

            # Huffman blocks (fixed and dynamic) on the device
            hsel = np.nonzero((btype == 1) | (btype == 2))[0]
            if hsel.size:
                rows = trace.upload(act[hsel], dev)
                H = hsel.size
                pos_tables = trace.upload(bp[hsel] + 3, dev)
                litL = c["fixed_lit"].expand(H, -1)
                distL = c["fixed_dist"].expand(H, -1)
                tflag = torch.zeros(H, dtype=torch.int64, device=dev)
                dsel = np.nonzero(btype[hsel] == 2)[0]
                if dsel.size:
                    di = trace.upload(dsel, dev)
                    end_pos, dlit, ddist, bad = _parse_dynamic(
                        W, rows[di], pos_tables[di], c)
                    pos_tables = pos_tables.index_copy(0, di, end_pos)
                    litL = litL.index_copy(0, di, dlit)
                    distL = distL.index_copy(0, di, ddist)
                    tflag = tflag.index_copy(
                        0, di, torch.where(bad, F_BAD_CODE, 0))
                start_byte = pos_tables >> 3
                Wwin = _window(W, rows, start_byte, win_words)
                Th, end_rel, hflag, ck, cl, ca = _decode_window(
                    Wwin, pos_tables & 7, _canonical_params(litL),
                    _canonical_params(distL), t_max, c)
                at = trace.upload(tok_w[hsel], dev)[:, None] + ar_t
                tk[rows[:, None], at] = ck
                tl[rows[:, None], at] = cl
                ta[rows[:, None], at] = ca
                got = trace.fetch(torch.stack([Th, start_byte * 8 + end_rel,
                                               hflag | tflag])).numpy()
                T[hsel] = got[0]
                end_bit[hsel] = got[1]
                flag[hsel] |= got[2]

            # stored blocks: scalar work on the host bytes
            aligned = (bp + 3 + 7) & ~7
            base_byte = aligned >> 3
            wlen = _host_words(Dh, act, base_byte)
            slen = wlen & 0xFFFF
            snlen = (wlen >> 16) & 0xFFFF
            is_stored = btype == 0
            T[is_stored] = 1
            end_bit[is_stored] = 8 * (base_byte + 4 + slen)[is_stored]
            flag |= np.where(is_stored & ((slen ^ 0xFFFF) != snlen),
                             F_BAD_PARITY, 0)
            ssel = np.nonzero(is_stored)[0]
            if ssel.size:
                # one token each; entries at or past a stream's token count
                # are never read, so the rest of its row is not cleared
                r = trace.upload(act[ssel], dev)
                at = trace.upload(tok_w[ssel], dev)
                tk[r, at] = K_STORED
                tl[r, at] = trace.upload(slen[ssel], dev)
                ta[r, at] = trace.upload(base_byte[ssel] + 4, dev)

            flag |= np.where(tok[act] + T > tok_cap, F_OVERFLOW, 0)
            blk[act] += 1
            flag |= np.where((blk[act] >= max_blocks) & ~final,
                             F_TOO_MANY_BLOCKS, 0)
            bitpos[act] = end_bit
            tok[act] += T
            done[act] = final
            status[act] |= flag

    # ---- global assembly ------------------------------------------------
    with trace.span("inflate_fused.assemble"):
        O = out_size
        ranks = torch.arange(TOKP, device=dev)
        valid = ranks < trace.upload(tok, dev)[:, None]
        outlen = torch.where(valid, tl, 0)
        starts = _i32(torch.cumsum(outlen, 1) - outlen)
        total = _i32(outlen.sum(1))
        tid0 = torch.full((B, O + 1), -1, dtype=torch.int64, device=dev)
        tid0.scatter_reduce_(1, starts.clamp(0, O),
                             torch.where(valid & (outlen > 0), ranks, -1),
                             "amax")
        tid = torch.cummax(tid0[:, :O], 1).values if O else tid0[:, :0]
        safe = tid.clamp(0, TOKP - 1)
        kj = torch.gather(tk, 1, safe)
        aj = torch.gather(ta, 1, safe)
        sj = torch.gather(starts, 1, safe)
        j = torch.arange(O, device=dev)
        ptr = torch.where(kj == K_MATCH, j - aj, j)
        bad_dist = ((ptr < 0) | (tid < 0)).any(1)
        ptr = ptr.clamp(0, max(O - 1, 0))
        litv = torch.where(kj == K_LIT, aj, 0)
        litv = torch.where(
            kj == K_STORED,
            torch.gather(Dd, 1, (aj + (j - sj)).clamp(0, n - 1)).long(),
            litv).to(torch.uint8)
        while True:
            nxt = torch.gather(ptr, 1, ptr)
            with trace.sync():
                same = torch.equal(nxt, ptr)
            if same:
                break
            ptr = nxt
        out = torch.gather(litv, 1, ptr)
        outp = torch.nn.functional.pad(out, (0, (-O) % 32768))
        adler = _adler_device(outp, O)
        fin = trace.fetch(
            torch.stack([total, bad_dist.long(), adler])).numpy()
        status |= np.where(fin[0] != O, F_OUTPUT_MISMATCH, 0)
        status |= np.where(fin[1] != 0, F_BAD_DISTANCE, 0)
    return outp, status, bitpos, fin[2], blk


def inflate_stream_cuda(D: torch.Tensor, n: int, out_size: int,
                        first: tuple, last: tuple, max_blocks: int,
                        tok_cap: int):
    """Launch ``inflate_stream`` over the rows of ``D`` (``(B, stride)``
    uint8 on the card, ``stride`` a multiple of 4, 4-byte aligned), each
    read as ``n`` bytes (those past ``stride`` as 0), at the budgets
    ``first`` and ``last`` (window bytes, rank budget): the first and last
    of the retry loop, or one budget twice.  ``n`` holds the code-length
    window and the largest window (``lax.dynamic_slice`` refuses a slice
    longer than its row).  Returns ``out`` ``(B, out_size`` padded to 32
    K``)`` uint8 and ``info`` ``(B, 8)`` int64 (status, end bit, blocks,
    the largest window bits and ranks a block needs, 1 where the token cap
    overflowed, the bytes of the tokens, 0), both on the card."""
    _kernels.require(D, "D", torch.uint8, 2)
    B, stride = D.shape
    if stride % 4 or D.data_ptr() % 4:
        raise ValueError(f"the rows must be 4-byte aligned words: stride "
                         f"{stride}, address {D.data_ptr():#x}")
    need = max(_TWIN_WORDS, first[0], last[0]) + 3
    if n < need:
        raise ValueError(f"a row of {n} bytes is shorter than the "
                         f"{need} its windows take")
    out = torch.zeros((B, out_size + (-out_size) % 32768), dtype=torch.uint8,
                      device=D.device)
    info = torch.empty((B, 8), dtype=torch.int64, device=D.device)
    _kernels.KERNELS["inflate_stream"].launch(
        D.data_ptr(), stride, n, B, out.data_ptr(), out.shape[1], out_size,
        first[0], first[1], last[0], last[1], tok_cap, max_blocks,
        info.data_ptr(), _kernels.stream_of(D))
    return out, info


def _inflate_cuda(D: torch.Tensor, n: int, out_size: int, first: tuple,
                  last: tuple, max_blocks: int, tok_cap: int):
    """:func:`_inflate` of the rows of ``D`` on the card, through the
    kernel.  Returns ``(out, status, end_bit, adler, blocks, info)``, the
    middle four numpy ``(B,)`` and ``info`` the kernel's numpy ``(B, 8)``."""
    if D.shape[1] % 4 or D.data_ptr() % 4 or not D.is_contiguous():
        # whole words from an aligned start: a copy, zeros past the row
        Dc = D.new_zeros((D.shape[0], D.shape[1] + (-D.shape[1]) % 4))
        Dc[:, :D.shape[1]] = D
        D = Dc
    with trace.span("inflate_fused.blocks"):
        out, info = inflate_stream_cuda(D, n, out_size, first, last,
                                        max_blocks, tok_cap)
        info = trace.fetch(info).numpy()
    with trace.span("inflate_fused.assemble"):
        adler = trace.fetch(_adler_device(out, out_size)).numpy()
    return out, info[:, 0], info[:, 1], adler, info[:, 2], info


def _fused(Ds: torch.Tensor, out_size: int, win_words: int, t_max: int,
           max_blocks: int, tok_cap: int):
    """``(out, status, end_bit, adler, blocks)`` of the rows of ``Ds`` at
    one budget: the kernel on a CUDA device, :func:`_inflate` elsewhere."""
    if Ds.device.type == "cuda":
        budget = (win_words, t_max)
        return _inflate_cuda(Ds, Ds.shape[1], out_size, budget, budget,
                             max_blocks, tok_cap)[:5]
    return _inflate(trace.fetch(Ds).numpy(), Ds, out_size, win_words, t_max,
                    max_blocks, tok_cap)


def inflate_fused(D: torch.Tensor, *, out_size: int, win_words: int,
                  t_max: int, max_blocks: int, tok_cap: int):
    """Decode a complete raw-DEFLATE stream on ``D``'s device.

    Args:
      D: ``(nbytes_pad,)`` uint8 — compressed bytes zero-padded by at least
        ``win_words + 8``.
      out_size: exact decompressed size.
      win_words: per-block decode window in bytes.
      t_max: per-block token rank budget.
      max_blocks: block-loop bound.
      tok_cap: global token budget (≥ out_size is always safe).

    Returns:
      ``(out (padded to 32 K), status, end_bit, adler)``; status 0 =
      success.  ``out`` is on ``D``'s device, the rest are ints.
    """
    out, status, end_bit, adler, _ = _fused(D[None], out_size, win_words,
                                            t_max, max_blocks, tok_cap)
    return out[0], int(status[0]), int(end_bit[0]), int(adler[0])


def inflate_fused_batch(Ds: torch.Tensor, *, out_size: int, win_words: int,
                        t_max: int, max_blocks: int, tok_cap: int):
    """Batched fused inflate: ``(B, nbytes_pad)`` streams decoded in
    lockstep, each block step over the streams still decoding.  Returns
    ``(out (B, padded), status, end_bit, adler)``, the last three numpy
    ``(B,)``; row b equals :func:`inflate_fused` of ``Ds[b]``."""
    return _fused(Ds, out_size, win_words, t_max, max_blocks, tok_cap)[:4]


def _raise_status(status: int):
    """Raise the error of a failed stream's status: one per failure class,
    the host engine's cases, the first that applies in this order."""
    if status & F_BAD_BLOCK:
        raise DecompressionError.invalid_block_type_code(3)
    if status & F_BAD_PARITY:
        raise DecompressionError.invalid_block_element_count_parity(0, 0)
    if status & F_BAD_DISTANCE:
        raise DecompressionError.invalid_string_reference()
    if status & F_BAD_CODE:
        raise DecompressionError.invalid_huffman_table()
    if status & F_OUTPUT_MISMATCH:
        # the wrong byte count for the declared output: a truncated or
        # overlong body
        raise DecompressionError.invalid_stream_checksum(0, 0)
    if status & (F_TOO_MANY_BLOCKS | F_OVERFLOW):
        # budgets exhausted after growing to the stream-derived ceilings:
        # only malformed streams can get here
        raise DecompressionError.invalid_block_type_code(3)
    raise DecompressionError.invalid_huffman_table()


def _retries(info: np.ndarray, first: tuple, caps: tuple) -> int:
    """The retries :class:`InflateFused`'s loop makes from budget ``first``
    towards ``caps`` over streams whose needs the kernel reported: a stream
    overflows at a budget that one of its blocks does not fit, and at every
    budget once its token cap overflowed."""
    need_bits, need_ranks, cap = info[:, 3], info[:, 4], info[:, 5]
    (win, t_max), retries = first, 0
    while (((need_bits >= 8 * win - 56) | (need_ranks > t_max)
            | (cap != 0)).any()
           and (win < caps[0] or t_max < caps[1])):
        win = min(win * 4, caps[0])
        t_max = min(t_max * 4, caps[1])
        retries += 1
    return retries


def _stack(bodies: list[bytes], width: int) -> np.ndarray:
    """The bodies as the rows of a zero-padded ``(B, width)`` uint8 array."""
    Ds = np.zeros((len(bodies), width), np.uint8)
    for i, b in enumerate(bodies):
        Ds[i, :len(b)] = np.frombuffer(b, np.uint8)
    return Ds


def _pow2_at_least(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b <<= 1
    return b


class InflateFused:
    """Host wrapper: padding buckets, the budget retry and the error
    mapping.  ``device``: ``cuda`` unless the caller names another.
    ``last_run`` holds the last run's block count (the most of any stream)
    and its budget retries.  On a CUDA device one kernel launch gives what
    the retry loop gives (:func:`_inflate_cuda`); the retries are counted
    from the needs it reports."""

    def __init__(self, win_bytes: int = 1 << 17, t_max: int = 1 << 15,
                 max_blocks: int = 1 << 14, device=None):
        self.win_bytes = win_bytes
        self.t_max = t_max
        self.max_blocks = max_blocks
        self.device = resolve_device(device)
        self.last_run = {"blocks": 0, "retries": 0}

    def _decode(self, bodies: list[bytes], out_size: int):
        """The raw DEFLATE ``bodies`` after the budget retries: ``(out (B,
        padded) on the device, status, adler)``, the last two numpy."""
        if self.device.type == "cuda":
            return self._decode_kernel(bodies, out_size)
        return self._decode_plain(bodies, out_size)

    @staticmethod
    def _caps(bodies: list[bytes], out_size: int) -> tuple[int, int]:
        """The retry loop's ceilings: valid single blocks may span the whole
        stream and carry up to out_size+1 tokens — the ceilings must cover
        both, or valid data gets mislabeled corrupt."""
        return (_pow2_at_least(max(len(b) for b in bodies) + 16, 1 << 12,
                               1 << 30),
                _pow2_at_least(out_size + 1, 1 << 10, 1 << 30))

    def _decode_plain(self, bodies: list[bytes], out_size: int):
        caps = self._caps(bodies, out_size)
        nmax = max(len(b) for b in bodies)
        win, t_max, retries = self.win_bytes, self.t_max, 0
        while True:
            Ds = _stack(bodies, 1 << max(12, (nmax + win + 7).bit_length()))
            out, st, _, adler, blk = _inflate(
                Ds, trace.upload(Ds, self.device), out_size, win, t_max,
                self.max_blocks, out_size + 1)
            self.last_run = {"blocks": int(blk.max()), "retries": retries}
            if (st & F_OVERFLOW).any() and (win < caps[0]
                                            or t_max < caps[1]):
                win = min(win * 4, caps[0])
                t_max = min(t_max * 4, caps[1])
                retries += 1
                continue
            return out, st, adler

    def _decode_kernel(self, bodies: list[bytes], out_size: int):
        caps = self._caps(bodies, out_size)
        first = (self.win_bytes, self.t_max)
        # the retry loop stops at its first budget or at the ceilings
        last = first if first[0] >= caps[0] and first[1] >= caps[1] else caps
        Ds = _stack(bodies, (max(len(b) for b in bodies) + 3) & ~3 or 4)
        # rows read as the retry loop pads them: zeros past the body
        out, st, _, adler, blk, info = _inflate_cuda(
            trace.upload(Ds, self.device),
            Ds.shape[1] + max(first[0], last[0]) + 8, out_size, first, last,
            self.max_blocks, out_size + 1)
        self.last_run = {"blocks": int(blk.max()),
                         "retries": _retries(info, first, caps)}
        return out, st, adler

    def run(self, body: bytes, out_size: int):
        """Raw DEFLATE body → (output tensor on the device, adler) or
        raises."""
        out, st, adler = self._decode([body], out_size)
        if st[0] != OK:
            _raise_status(int(st[0]))
        return out[0], int(adler[0])

    def inflate(self, data: bytes, out_size: int, format: str = "zlib",
                keep_on_device: bool = False):
        """Complete zlib/ios/gzip stream → decompressed bytes: a numpy
        array, or a tensor on the device with ``keep_on_device``."""
        with trace.span("inflate_fused.inflate"):
            if format == "zlib":
                if len(data) < 6:
                    # 2-byte header + 4-byte Adler trailer minimum
                    raise DecompressionError.invalid_stream_checksum(0, 0)
                cmf, flg = data[0], data[1]
                if cmf & 0x0F != 0x08:
                    raise StreamHeaderError.invalid_compression_method(
                        cmf & 0x0F)
                if (cmf * 256 + flg) % 31 != 0:
                    raise StreamHeaderError.invalid_check_bits()
                if flg & 0x20:
                    raise StreamHeaderError.unexpected_dictionary()
                out, adler = self.run(data[2:], out_size)
                declared = int.from_bytes(data[-4:], "big")
                if adler != declared:
                    raise DecompressionError.invalid_stream_checksum(
                        declared, adler)
            elif format == "ios":
                out, _ = self.run(data, out_size)
            elif format == "gzip":
                from .._host.lz77.checksums import crc32

                if len(data) < 18 or data[0] != 0x1F or data[1] != 0x8B:
                    raise GzipStreamHeaderError.invalid_sigil()
                if data[2] != 0x08:
                    raise GzipStreamHeaderError.invalid_compression_method(
                        data[2])
                flags = data[3]
                if flags & 0b1110_0000:
                    raise GzipStreamHeaderError.invalid_flag_bits(flags)
                if flags & 0x02:
                    raise GzipStreamHeaderError.header_checksum_unsupported()
                off = 10
                if flags & 0x04:
                    off += 2 + int.from_bytes(data[off:off + 2], "little")
                for bit in (0x08, 0x10):
                    if flags & bit:
                        off = data.index(b"\x00", off) + 1
                out, _ = self.run(data[off:], out_size)
                isize = int.from_bytes(data[-4:], "little")
                if isize != out_size & 0xFFFFFFFF:
                    raise DecompressionError.invalid_stream_checksum(
                        isize, out_size)
                if not keep_on_device:
                    declared = int.from_bytes(data[-8:-4], "little")
                    host = trace.fetch(out[:out_size]).numpy()
                    computed = crc32(host)
                    if computed != declared:
                        raise DecompressionError.invalid_stream_checksum(
                            declared, computed)
                    return host
            else:
                raise ValueError(f"unknown format {format!r}")
            out = out[:out_size]
            return out if keep_on_device else trace.fetch(out).numpy()


class InflateFusedBatch(InflateFused):
    """Batch wrapper: the same buckets and retry over a stacked batch."""

    def run_batch(self, bodies: list[bytes], out_size: int):
        out, st, adler = self._decode(bodies, out_size)
        if (st != OK).any():
            raise DecompressionError.invalid_huffman_table()
        return out, adler

    def inflate_batch(self, datas: list[bytes], out_size: int,
                      format: str = "zlib", keep_on_device: bool = True):
        """Batch of complete zlib/ios streams → ``(B, out_size)`` bytes."""
        if format == "zlib":
            bodies = [d[2:] for d in datas]
            out, adler = self.run_batch(bodies, out_size)
            for i, d in enumerate(datas):
                declared = int.from_bytes(d[-4:], "big")
                if int(adler[i]) != declared:
                    raise DecompressionError.invalid_stream_checksum(
                        declared, int(adler[i]))
        elif format == "ios":
            out, _ = self.run_batch(datas, out_size)
        else:
            raise ValueError(f"unknown format {format!r}")
        out = out[:, :out_size]
        return out if keep_on_device else trace.fetch(out).numpy()
