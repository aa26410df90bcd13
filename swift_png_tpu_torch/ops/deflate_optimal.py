"""Batched optimal-parse deflate at levels 8–13: the candidate search (K4),
the DP parse (K5), and the pipeline around them.

Counterpart of ``swift_png_tpu/ops/deflate_optimal.py``'s batched path
(``menu_candidates_pallas_batch``, ``optimal_parse_device``,
``_dp_iterated``, ``optimal_pipeline_batch``,
``deflate_device_optimal_batch``).  Each stream gets a *distance menu*
(small constants and pixel/row strides); for every position the exact
match run at each menu distance is scanned densely and the best two kept
(K4).  The parse is a min-cost shortest path over each 1,024-byte chunk
with the reference's quarter-bit ``Depths`` costs (K5), refined over the
level's iterations with an on-device cost refresh, then one histogram
fetch builds the real Huffman trees on the host, the terms are emitted
(K6, :mod:`.deflate_emit`) and scatter-packed into each stream's bits.

Layout: the TPU kernels keep positions chunk-per-lane, ``(T, ·, 1024,
128)``, for the TPU's lane shape only.  The port keeps every per-position
array in flat position order, image ``i`` at ``[i·stride, (i+1)·stride)``
and chunk ``c`` at ``[c·1024, (c+1)·1024)`` (the order of JAX's
``transpose(0, 2, 1).reshape(-1)``), so pack offsets are one per-image
prefix sum.

With the port's native host library (:mod:`.._host.native`), each stream's
menu gains the most frequent distances of a sampled greedy parse and its
cost model a warm start (:func:`_sample_stats`), and the strict size policy
re-encodes natively the images whose device parse loses to a native size
probe (:func:`deflate_device_optimal_batch`).  Without the library, as in
the JAX package, neither happens.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs
its plain PyTorch version (``*_reference``) for a CPU tensor.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels, trace
from .._host import native as _native
from .._host.bits import BitWriter, reverse_bits
from .._host.lz77 import constants as C
from .._host.lz77.deflate import Depths, _write_stored_block, search_parameters
from .._host.lz77.huffman import canonical_codes, lengths_from_frequencies
from .._host.lz77.index import _BitWalker, _flat_lut
from .._kernels import resolve_device
from .deflate import (_emit_tables, _write_block_header_and_tables,
                      append_bits, atoms32_to_bytes, max_term_bits,
                      scatter_pack)
from .deflate_emit import ROWS, emit_terms_batch, pack_emit_table

__all__ = ["default_menu", "batch_layout", "menu_candidates_batch",
           "optimal_parse", "dp_iterated", "emit_input",
           "optimal_pipeline_batch", "deflate_device_optimal_batch"]

NB = 1024        # DP chunk length (bytes)
KCAND = 2        # match edges per position fed to the DP
DMAX_STEP = 8    # menu slots are padded to a multiple of this
INF = 1 << 28
DP_COST_CAP = 1 << 20  # K5 refuses larger table entries (sums < 2^31)
TILE = 128 * NB  # positions per JAX tile; image strides are multiples


# ---------------------------------------------------------------------------
# menus, layout, cost tables (host)
# ---------------------------------------------------------------------------

def default_menu(n: int, bpp: int = 4, pitch: int = 0) -> list[int]:
    """Structural distance menu for filtered image data."""
    menu = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64]
    if bpp > 1:
        menu += [bpp, 2 * bpp, 3 * bpp]
    if pitch:
        menu += [pitch - bpp, pitch, pitch + bpp, 2 * pitch]
    out = []
    for d in menu:
        if 1 <= d <= min(32768, n - 1) and d not in out:
            out.append(d)
    return out


def batch_layout(ns: list[int]):
    """``(stride, Ntot, TPI)`` for a batch of stream lengths: every image
    is padded to a whole number of 128-chunk tiles."""
    CPI = -(-max(ns) // NB)
    TPI = -(-CPI // 128)
    stride = TPI * TILE
    return stride, len(ns) * stride, TPI


def _sample_stats(data: bytes):
    """``(extra menu distances, lit freq, dist freq)`` of a sampled parse.

    The native greedy-pass sampler (``sample_stats``) reads the stream's
    first 64 KB; streams under 4,096 bytes, or a box without the native
    library, get ``([], None, None)``: no extra menu distances, no warm
    start, and the DP runs the level's iterations twice (the reference's
    generic start)."""
    if not _native.available() or len(data) < 4096:
        return [], None, None
    sample = data[: 1 << 16]
    try:
        return _native.sample_stats(sample, 4, 8)
    except _native.NativeError:
        pass
    # the sampler failed: walk the tokens of a native level-4 deflate
    try:
        return _walk_stats(_native.deflate(sample, 4, "ios"), top=8)
    except (_native.NativeError, IndexError, ValueError):
        return [], None, None


def _walk_stats(body: bytes, top: int):
    """Token walk of a sampled stream: (top distances, lit/dist freqs).

    The frequencies warm-start the ``Depths`` cost model (the reference
    seeds it with generic costs and doubles the refinement iterations to
    compensate, ``…Matches.Depths.swift:28-45``; a sampled seed reaches
    the same costs with the level's plain iteration count).
    """
    w = _BitWalker(body)
    w.read(1)
    btype = w.read(2)
    if btype != 2:
        return [], None, None
    hlit = w.read(5) + 257
    hdist = w.read(5) + 1
    hclen = w.read(4) + 4
    ml = np.zeros(19, np.int64)
    for i in range(hclen):
        ml[C.CODELENGTH_ORDER[i]] = w.read(3)
    mlut = _flat_lut(ml, 7)
    lengths: list[int] = []
    while len(lengths) < hlit + hdist:
        e = int(mlut[w.peek(7)])
        ln, sym = e >> 16, e & 0xFFFF
        if ln == 0:
            return [], None, None
        w.pos += ln
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            lengths += [lengths[-1]] * (3 + w.read(2))
        elif sym == 17:
            lengths += [0] * (3 + w.read(3))
        else:
            lengths += [0] * (11 + w.read(7))
    la = np.array(lengths, np.int64)
    lit = np.zeros(288, np.int64)
    lit[:hlit] = la[:hlit]
    dl = np.zeros(32, np.int64)
    dl[:hdist] = la[hlit:]
    litlut = _flat_lut(lit, 15)
    distlut = (_flat_lut(dl, 15) if np.count_nonzero(dl)
               else np.zeros(2, np.int64))
    hist: dict[int, int] = {}
    lit_freq = np.zeros(286, np.int64)
    dist_freq = np.zeros(30, np.int64)
    nbits = len(body) * 8
    while w.pos + 15 < nbits:
        e = int(litlut[w.peek(15)])
        ln, sym = e >> 16, e & 0xFFFF
        if ln == 0:
            break
        w.pos += ln
        if sym < 286:
            lit_freq[sym] += 1
        if sym < 256:
            continue
        if sym == 256:
            break
        dec = sym - 257
        if dec > 28:
            break
        w.read(int(C.RUN_EXTRA[dec]))
        e2 = int(distlut[w.peek(15)])
        dln, dsym = e2 >> 16, e2 & 0xFFFF
        if dln == 0 or dsym > 29:
            break
        w.pos += dln
        dist = int(C.DISTANCE_BASE[dsym]) + w.read(
            int(C.DISTANCE_EXTRA[dsym]))
        dist_freq[dsym] += 1
        hist[dist] = hist.get(dist, 0) + 1
    tops = [d for d, _ in sorted(hist.items(), key=lambda kv: -kv[1])[:top]]
    return tops, lit_freq, dist_freq


def _tables_from_depths(depths: Depths):
    s = depths.storage.astype(np.int32)
    dep_lit = s[:256]
    runcost = s[256:512]                      # index L-3
    ddep = np.zeros(32, np.int32)
    ddep[:30] = s[512:542]
    rdinfo = np.zeros(256, np.int32)
    for L in range(3, 259):
        rd = int(C.RUN_DECADE[L])
        rdinfo[L - 3] = rd | int(C.RUN_BASE[rd]) << 5
    dbase = np.zeros(32, np.int32)
    dbase[:30] = C.DISTANCE_BASE[:30]
    return dep_lit, runcost, ddep, rdinfo, dbase


_RD_OF_L = np.array([int(C.RUN_DECADE[L]) for L in range(3, 259)], np.int32)
_REX_OF_L = np.array([int(C.RUN_EXTRA[_RD_OF_L[i]]) for i in range(256)],
                     np.int32)
_DEX = np.zeros(32, np.int32)
_DEX[:30] = C.DISTANCE_EXTRA[:30]
_RDINFO, _DBASE = _tables_from_depths(Depths())[3:]


def _quarter_bits(freq: torch.Tensor) -> torch.Tensor:
    """``clip(round(-4·log2(max(f, 0.5)/total)), 4, 60)`` in float32."""
    f = freq.to(torch.float32)
    total = f.sum(dim=1, keepdim=True).clamp(min=1.0)
    return torch.round(-4.0 * torch.log2(f.clamp(min=0.5) / total)).clamp(
        4, 60).to(torch.int32)


def _device_depths_update(hist, dep_lit, runcost, ddep):
    """Cost refresh between DP iterations, per image, on the device.

    ``hist``: ``(B, 320)`` symbol histograms; tables ``(B, 256)``,
    ``(B, 256)``, ``(B, 32)`` int32.  Fractional entropy costs
    ``-4·log2(freq/total)`` stand in for tree lengths (the DP needs costs,
    not a code), clipped to [4, 60] quarter bits; symbols that did not
    occur keep their cost.  The final iteration's trees are real ones,
    built on the host.
    """
    dev = hist.device
    with trace.sync():
        rd = torch.as_tensor(_RD_OF_L, device=dev).long()
    q = _quarter_bits(hist[:, :286])
    dep_lit2 = torch.where(hist[:, :256] > 0, q[:, :256], dep_lit)
    qrun = q[:, 257:286][:, rd]
    with trace.sync():
        qrun = qrun + 4 * torch.as_tensor(_REX_OF_L, device=dev)
    runcost2 = torch.where(hist[:, 257 + rd] > 0, qrun, runcost)
    distf = F.pad(hist[:, 288:318], (0, 2))
    dq = _quarter_bits(distf)
    with trace.sync():
        dq = dq + 4 * torch.as_tensor(_DEX, device=dev)
    ddep2 = torch.where(distf > 0, dq, ddep)
    return dep_lit2, runcost2, ddep2


def _decade_of(dist: torch.Tensor) -> torch.Tensor:
    """Distance decade, closed form (``-1`` for distance 0)."""
    dm1 = dist - 1
    bl = torch.zeros_like(dist)
    for t in range(16):
        bl = bl + (dm1 >= (1 << t)).to(dist.dtype)
    hi = (dm1 >> (bl - 2).clamp(min=0)) & 1
    return torch.where(dist <= 4, dm1, 2 * (bl - 1) + hi)


# ---------------------------------------------------------------------------
# K4: candidate search
# ---------------------------------------------------------------------------

def _check_cand(dists2, decades2, data, nvec, dmax, stride):
    B = dists2.shape[0]
    if (dists2.shape != (B, dmax) or decades2.shape != (B, dmax)
            or data.shape != (B * stride,) or nvec.shape != (B,)):
        raise ValueError("menu_candidates_batch: want dists2/decades2 "
                         f"(B, {dmax}), data (B·{stride},), nvec (B,)")
    if stride % TILE or dmax > 32:
        raise ValueError(f"stride must be a multiple of {TILE} and dmax "
                         f"at most 32, got {stride}, {dmax}")


def menu_candidates_batch(dists2, decades2, data, nvec, *, dmax: int,
                          stride: int) -> torch.Tensor:
    """Top-2 menu matches at every position of a batch of streams.

    ``data``: ``(B·stride,)`` uint8, stream ``i`` at ``[i·stride,
    i·stride + nvec[i])``; ``dists2``/``decades2``: ``(B, dmax)`` int32
    per-image menu distances (0 = unused slot) and their decade costs.
    The run at position ``p`` for distance ``d`` counts consecutive
    ``q ≥ p`` with ``q < n``, ``q ≥ d`` and ``data[q] == data[q-d]``, up
    to 258; the score ``run·64 − decade`` (run ≥ 3, ``d > 0``) keeps the
    best two in slot order with strict ``>``.  Returns ``(2, B·stride)``
    int32 ``dist<<9 | run``, or ``1<<9`` where there is none.
    """
    _check_cand(dists2, decades2, data, nvec, dmax, stride)
    if data.device.type == "cpu":
        return menu_candidates_reference(dists2, decades2, data, nvec,
                                         dmax=dmax, stride=stride)
    return menu_candidates_cuda(dists2, decades2, data, nvec, dmax=dmax,
                                stride=stride)


def menu_candidates_cuda(dists2, decades2, data, nvec, *, dmax: int,
                         stride: int) -> torch.Tensor:
    """Launch K4 (``csrc/cand.cu``)."""
    _check_cand(dists2, decades2, data, nvec, dmax, stride)
    for t, name, dt in ((dists2, "dists2", torch.int32),
                        (decades2, "decades2", torch.int32),
                        (nvec, "nvec", torch.int32)):
        _kernels.require(t, name, dt, t.dim())
    _kernels.require(data, "data", torch.uint8, 1)
    out = torch.empty((KCAND, data.shape[0]), dtype=torch.int32,
                      device=data.device)
    _kernels.KERNELS["cand"].launch(
        data.data_ptr(), dists2.data_ptr(), decades2.data_ptr(),
        nvec.data_ptr(), out.data_ptr(), dists2.shape[0], stride, dmax,
        _kernels.stream_of(data))
    return out


def menu_candidates_reference(dists2, decades2, data, nvec, *, dmax: int,
                              stride: int) -> torch.Tensor:
    """Plain PyTorch K4, per image: shifted-equality masks, suffix runs by
    log-doubling, then two argmax picks (the first maximum in slot order,
    as the strict ``>`` running top-2 keeps)."""
    B = dists2.shape[0]
    dev = data.device
    out = torch.full((KCAND, B * stride), 1 << 9, dtype=torch.int32,
                     device=dev)
    pos = torch.arange(stride, device=dev)
    for i in range(B):
        img = data[i * stride:(i + 1) * stride]
        n = int(nvec[i])
        dv = dists2[i].to(torch.int64)
        eq = torch.zeros((dmax, stride), dtype=torch.int16, device=dev)
        for j, d in enumerate(dv.tolist()):
            if 0 < d < stride:
                eq[j, d:] = (img[d:] == img[:-d]).to(torch.int16)
        eq &= (pos < n).to(torch.int16)
        r = eq
        for lv in range(9):                 # r = min(run, 512)
            step = 1 << lv
            nxt = F.pad(r[:, step:], (0, step))
            r = r + torch.where(r == step, nxt, 0)
        r = r.clamp(max=258).to(torch.int32)
        R = torch.where(pos[None] >= dv[:, None],
                        torch.minimum(r, (n - pos).clamp(min=0)[None]),
                        0).to(torch.int32)
        # int32, so a score wraps as the TPU kernel's does
        score = torch.where((R >= 3) & (dv[:, None] > 0),
                            R * 64 - decades2[i][:, None], -1)
        for k in range(KCAND):
            best = torch.argmax(score, dim=0)
            brun = torch.gather(R, 0, best[None])[0]
            bscore = torch.gather(score, 0, best[None])[0]
            bdist = dv.to(torch.int32)[best]
            out[k, i * stride:(i + 1) * stride] = torch.where(
                bscore >= 0, (bdist << 9) | brun, 1 << 9)
            score = score.scatter(0, best[None], -1)
    return out


# ---------------------------------------------------------------------------
# K5: DP parse
# ---------------------------------------------------------------------------

def _check_dp(data, clen, cand, dep_lit, runcost, ddep, tpi):
    B = dep_lit.shape[0]
    Ntot = data.shape[0]
    if (Ntot != B * tpi * TILE or clen.shape != (Ntot // NB,)
            or cand.shape != (KCAND, Ntot) or dep_lit.shape != (B, 256)
            or runcost.shape != (B, 256) or ddep.shape != (B, 32)):
        raise ValueError("optimal_parse: want data (B·tpi·128·1024,), clen "
                         "(chunks,), cand (2, Ntot), dep_lit/runcost (B, "
                         "256), ddep (B, 32)")


def optimal_parse(data, clen, cand, dep_lit, runcost, ddep, *, tpi: int):
    """Min-cost parse of every 1,024-byte chunk.

    ``data`` ``(Ntot,)`` uint8; ``clen`` ``(Ntot/1024,)`` int32 live bytes
    per chunk; ``cand`` ``(2, Ntot)`` from K4; per-image quarter-bit cost
    tables ``dep_lit`` ``(B, 256)``, ``runcost`` ``(B, 256)`` (index
    ``L-3``) and ``ddep`` ``(B, 32)``; ``tpi`` tiles (128 chunks) per
    image.  Forward DP with the literal edge first, then each candidate's
    edges over lengths ``3…min(run, clen-i)``, strict ``<``; the backtrack
    writes each term at its end position.  Returns ``(terms (Ntot,)
    int32, valid (Ntot,) uint8, hist (B, 320) int32)``: packed
    DeflatorTerms, their mask, and the symbol histogram (lit/run symbols
    in rows 0…287, distance decades in rows 288…317).
    """
    _check_dp(data, clen, cand, dep_lit, runcost, ddep, tpi)
    if data.device.type == "cpu":
        return optimal_parse_reference(data, clen, cand, dep_lit, runcost,
                                       ddep, tpi=tpi)
    return optimal_parse_cuda(data, clen, cand, dep_lit, runcost, ddep,
                              tpi=tpi)


def _dp_constants(dev):
    with trace.sync(2):
        return (torch.as_tensor(_RDINFO, device=dev),
                torch.as_tensor(_DBASE, device=dev))


def optimal_parse_cuda(data, clen, cand, dep_lit, runcost, ddep, *,
                       tpi: int):
    """Launch K5 (``csrc/dp_parse.cu``).  Its sums are exact only while no
    int32 cost can wrap, so it refuses a cost table with an entry outside
    ``[0, 2^20)``."""
    _check_dp(data, clen, cand, dep_lit, runcost, ddep, tpi)
    _kernels.require(data, "data", torch.uint8, 1)
    for t, name in ((clen, "clen"), (cand, "cand"), (dep_lit, "dep_lit"),
                    (runcost, "runcost"), (ddep, "ddep")):
        _kernels.require(t, name, torch.int32, t.dim())
    lo, hi = torch.cat([dep_lit.view(-1), runcost.view(-1),
                        ddep.view(-1)]).aminmax()
    with trace.sync(2):
        lo, hi = int(lo), int(hi)
    if lo < 0 or hi >= DP_COST_CAP:
        raise ValueError(f"optimal_parse: cost table entries must lie in "
                         f"[0, {DP_COST_CAP})")
    dev = data.device
    rdinfo, dbase = _dp_constants(dev)
    Ntot = data.shape[0]
    B = dep_lit.shape[0]
    terms = torch.empty(Ntot, dtype=torch.int32, device=dev)
    valid = torch.empty(Ntot, dtype=torch.uint8, device=dev)
    hist = torch.zeros((B, ROWS), dtype=torch.int32, device=dev)
    _kernels.KERNELS["dp_parse"].launch(
        data.data_ptr(), clen.data_ptr(), cand.data_ptr(),
        dep_lit.data_ptr(), runcost.data_ptr(), ddep.data_ptr(),
        rdinfo.data_ptr(), dbase.data_ptr(), terms.data_ptr(),
        valid.data_ptr(), hist.data_ptr(), Ntot // NB, tpi * 128,
        _kernels.stream_of(data))
    return terms, valid, hist


def optimal_parse_reference(data, clen, cand, dep_lit, runcost, ddep, *,
                            tpi: int):
    """Plain PyTorch K5: vectorized over the live chunks, sequential over
    the 1,024 positions (forward) and back (the backtrack)."""
    dev = data.device
    Ntot = data.shape[0]
    B = dep_lit.shape[0]
    terms = torch.zeros(Ntot, dtype=torch.int32, device=dev)
    valid = torch.zeros(Ntot, dtype=torch.uint8, device=dev)
    hist = torch.zeros((B, ROWS), dtype=torch.int32, device=dev)
    idx = torch.nonzero(clen > 0)[:, 0]
    if idx.numel() == 0:
        return terms, valid, hist
    rdinfo, dbase = _dp_constants(dev)
    img = idx // (tpi * 128)
    cl = clen[idx]
    Lc = idx.numel()
    byte = data.view(-1, NB)[idx].to(torch.int64)
    cands = [cand[k].view(-1, NB)[idx] for k in range(KCAND)]
    litc = torch.gather(dep_lit[img], 1, byte)
    rc = runcost[img]
    dtab = ddep[img]
    cost = torch.full((Lc, NB + 1), INF, dtype=torch.int32, device=dev)
    cost[:, 0] = 0
    plen = torch.zeros((Lc, NB + 1), dtype=torch.int32, device=dev)
    pdist = torch.ones((Lc, NB + 1), dtype=torch.int32, device=dev)
    lengths = torch.arange(3, 259, dtype=torch.int32, device=dev)
    for i in range(int(cl.max())):
        ok = i < cl
        ci = cost[:, i]
        lc = ci + litc[:, i]
        bet = ok & (lc < cost[:, i + 1])
        cost[:, i + 1] = torch.where(bet, lc, cost[:, i + 1])
        plen[:, i + 1] = torch.where(bet, 1, plen[:, i + 1])
        pdist[:, i + 1] = torch.where(bet, 0, pdist[:, i + 1])
        nL = min(256, NB - i - 2)
        for cv in cands:
            cv = cv[:, i]
            dist = cv >> 9
            reach = torch.minimum(cv & 0x1FF, cl - i)
            live = ok & (reach >= 3)
            if nL <= 0 or not bool(live.any()):
                continue
            dd = _decade_of(dist)
            dcost = torch.where(
                (dd >= 0) & (dd < 32),
                torch.gather(dtab, 1, dd.clamp(0, 31)[:, None].long())[:, 0],
                0)
            news = (ci + dcost)[:, None] + rc[:, :nL]
            mask = (lengths[None, :nL] <= reach[:, None]) & ok[:, None]
            sl = slice(i + 3, i + 3 + nL)
            olds = cost[:, sl]
            bet = mask & (news < olds)
            cost[:, sl] = torch.where(bet, news, olds)
            plen[:, sl] = torch.where(bet, lengths[None, :nL], plen[:, sl])
            pdist[:, sl] = torch.where(bet, dist[:, None], pdist[:, sl])

    T = torch.zeros((Lc, NB), dtype=torch.int32, device=dev)
    nxt = cl.clone()
    for i in range(int(cl.max()), 0, -1):
        on = (nxt == i) & (i <= cl)
        if not bool(on.any()):
            continue
        ln = plen[:, i]
        dist = pdist[:, i]
        rinfo = rdinfo[(ln - 3).clamp(min=0).long()]
        rd = rinfo & 31
        rbase = (rinfo >> 5) & 0x1FF
        dd = _decade_of(dist)
        dbase_v = torch.where((dd >= 0) & (dd < 32),
                              dbase[dd.clamp(0, 31).long()], 0)
        lit_term = -134217728 + byte[:, i - 1].to(torch.int32)
        match_term = ((dd << 27) | ((dist - dbase_v) << 14)
                      | ((ln - rbase) << 9) | 0x100 | rd)
        T[:, i - 1] = torch.where(on, torch.where(ln == 1, lit_term,
                                                  match_term), 0)
        nxt = torch.where(on, i - ln, nxt)
    V = T != 0                       # a packed term is never 0
    terms.view(-1, NB)[idx] = T
    valid.view(-1, NB)[idx] = V.to(torch.uint8)
    # the histogram of the emitted symbols, per image
    top = (T >> 27) & 31
    low = T & 0xFF
    is_lit = (top == 31) & ((T & 0x100) == 0)
    rows = img[:, None] * ROWS
    sym1 = (rows + torch.where(is_lit, low, 257 + low))[V]
    sym2 = (rows + 288 + top)[V & ~is_lit]
    flat = hist.view(-1)
    for s in (sym1, sym2):
        flat.index_add_(0, s.long(), torch.ones_like(s, dtype=torch.int32))
    return terms, valid, hist


def dp_iterated(data, clen, cand, dep_b, run_b, dde_b, *, tpi: int,
                iters: int):
    """The level's DP iterations with the on-device cost refresh between
    them; returns the last iteration's ``(terms, valid, hist)``."""
    for it in range(iters):
        terms, valid, hist = optimal_parse(data, clen, cand, dep_b, run_b,
                                           dde_b, tpi=tpi)
        if it + 1 < iters:
            dep_b, run_b, dde_b = _device_depths_update(hist, dep_b, run_b,
                                                        dde_b)
    return terms, valid, hist


# ---------------------------------------------------------------------------
# emission and packing
# ---------------------------------------------------------------------------

def _compact_batch(terms, valid, B: int, cap: int):
    """Order-preserving compaction of each image's live terms:
    ``(ctms (B, cap) int32, counts (B,))``."""
    tf = terms.view(B, -1)
    vf = valid.view(B, -1) != 0
    pos = torch.cumsum(vf, dim=1) - 1
    keep = vf & (pos < cap)
    ctms = torch.zeros((B, cap + 1), dtype=torch.int32, device=terms.device)
    ctms.scatter_(1, torch.where(keep, pos, cap), torch.where(keep, tf, 0))
    return ctms[:, :cap].contiguous(), vf.sum(dim=1)


def emit_input(terms, valid, freqs: np.ndarray, TPI: int):
    """K6's input on the pack route the batch's term counts (one lit/run
    symbol per term) pick: ``(route, terms (B·slots,), live (B, slots)
    bool, slots)``.

    Literal-dominated batches (terms ≈ bytes) take the ``"grid"`` route and
    emit the DP's position grid as it stands; match-rich ones take the
    ``"compact"`` route and emit each image's live terms, compacted in
    order into a power-of-two row of at least 512 slots.  (The JAX package
    packs rows under 1,024 slots per image on the host, since its kernel's
    steps do not fit them; K6 takes any multiple of 256, so the port
    compacts those too, with the same atoms.)
    """
    B = freqs.shape[0]
    n_terms_max = max(int(freqs[:, :288].sum(axis=1).max()), 1)
    if n_terms_max > TPI * TILE // 2:
        slots = terms.shape[0] // B
        return "grid", terms, (valid != 0).view(B, slots), slots
    cap = max(512, 1 << (n_terms_max + 8 - 1).bit_length())
    ctms, counts = _compact_batch(terms, valid, B, cap)
    live = torch.arange(cap, device=terms.device)[None] < counts[:, None]
    return "compact", ctms.view(-1), live, cap


def _emit_pack(terms, valid, freqs, tabs, spans: tuple, TPI: int):
    """Emit (K6) on :func:`emit_input`'s route and scatter-pack each
    image's pieces in stream order: ``(atoms (B, natoms), totals (B,))``."""
    _, e_terms, live, slots = emit_input(terms, valid, freqs, TPI)
    B = live.shape[0]
    lo, hi, nb = emit_terms_batch(e_terms, trace.upload(tabs, terms.device),
                                  slots)
    nbv = torch.where(live, nb.view(B, slots), 0)
    offs = torch.cumsum(nbv, dim=1, dtype=torch.int32) - nbv
    return scatter_pack(lo.view(B, slots), hi.view(B, slots), nbv, offs,
                        max(spans), (3 * slots) // 2 + 8)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _batch_inputs(datas: list[bytes], bpp: int, pitch: int, dev,
                  dbuf=None) -> dict:
    """Menus, layout, staged bytes and chunk lengths of one bucket."""
    B = len(datas)
    ns = [len(d) for d in datas]
    stride, Ntot, TPI = batch_layout(ns)
    menus, lit_fs, dist_fs = [], [], []
    for d in datas:
        m = default_menu(len(d), bpp=bpp, pitch=pitch)
        extra, lit_f, dist_f = _sample_stats(d)
        m += [x for x in extra if x not in m]
        menus.append(tuple(sorted(m)))
        lit_fs.append(lit_f)
        dist_fs.append(dist_f)
    dmax = -(-max(max((len(m) for m in menus), default=1), 1)
             // DMAX_STEP) * DMAX_STEP
    dv = np.zeros((B, dmax), np.int32)
    cv = np.zeros((B, dmax), np.int32)
    for i, m in enumerate(menus):
        dv[i, :len(m)] = m
        cv[i, :len(m)] = [int(C.DISTANCE_DECADE[d]) for d in m]
    if dbuf is None:
        buf = np.zeros(Ntot, np.uint8)
        for i, d in enumerate(datas):
            buf[i * stride: i * stride + len(d)] = np.frombuffer(d, np.uint8)
        dbuf = trace.upload(buf, dev)
    if dbuf.shape != (Ntot,):
        raise ValueError(f"dbuf must be ({Ntot},), got {tuple(dbuf.shape)}")
    clen = np.zeros(Ntot // NB, np.int32)
    for i, n in enumerate(ns):
        c = np.arange(-(-n // NB))
        clen[i * TPI * 128 + c] = np.minimum(NB, n - c * NB)
    return dict(B=B, ns=ns, stride=stride, Ntot=Ntot, TPI=TPI, dmax=dmax,
                menus=menus, lit_fs=lit_fs, dist_fs=dist_fs, dbuf=dbuf,
                dists2=trace.upload(dv, dev), decades2=trace.upload(cv, dev),
                nvec=trace.upload(np.asarray(ns, np.int32), dev),
                clen=trace.upload(clen, dev))


def _initial_tables(plan: dict, level: int):
    """Per-image starting cost tables and the DP iteration count."""
    iterations = search_parameters(level)[3]
    rows = ([], [], [])
    all_warm = True
    for lit_f, dist_f in zip(plan["lit_fs"], plan["dist_fs"]):
        depths = Depths()
        if lit_f is not None and int(lit_f.sum()) > 64:
            lit_f = lit_f.copy()
            lit_f[256] += 1
            depths.update(lengths_from_frequencies(lit_f, 15, force=True),
                          lengths_from_frequencies(dist_f, 15, force=False))
        all_warm = all_warm and not depths.generic
        for r, v in zip(rows, _tables_from_depths(depths)[:3]):
            r.append(v)
    dev = plan["dbuf"].device
    tabs = [trace.upload(np.stack(r).astype(np.int32), dev) for r in rows]
    return (*tabs, max(1, iterations * (1 if all_warm else 2)))


def _host_trees(freqs: np.ndarray):
    """Final canonical trees from the fetched ``(B, 320)`` histograms:
    ``(trees, (B, 320) packed emit tables, spans)``."""
    trees, tabs, spans = [], [], []
    for f in freqs:
        freq = f.copy()
        freq[256] += 1
        lit_l = lengths_from_frequencies(freq[:286], 15, force=True)
        dist_l = lengths_from_frequencies(freq[288:318], 15, force=False)
        trees.append((lit_l, dist_l))
        tabs.append(pack_emit_table(*_emit_tables(lit_l, dist_l)))
        spans.append(2 if max_term_bits(lit_l, dist_l, f) <= 33 else 3)
    return trees, np.stack(tabs), tuple(spans)


def optimal_pipeline_batch(datas: list[bytes], level: int = 9,
                           pitch: int = 0, bpp: int = 4, device=None,
                           dbuf=None):
    """Candidates → iterated DP → one histogram fetch → host trees → emit
    and pack, for one bucket of streams with per-image menus and cost
    tables.  Returns ``(atoms_list, totals (B,), trees)`` with the atoms
    and totals still on the device."""
    dev = dbuf.device if dbuf is not None else resolve_device(device)
    with trace.span("deflate.plan"):
        plan = _batch_inputs(datas, bpp, pitch, dev, dbuf)
    with trace.span("deflate.parse"):
        cand = menu_candidates_batch(
            plan["dists2"], plan["decades2"], plan["dbuf"], plan["nvec"],
            dmax=plan["dmax"], stride=plan["stride"])
        dep_b, run_b, dde_b, iters = _initial_tables(plan, level)
        terms, valid, hist = dp_iterated(plan["dbuf"], plan["clen"], cand,
                                         dep_b, run_b, dde_b,
                                         tpi=plan["TPI"], iters=iters)
    with trace.span("deflate.trees"):
        freqs = trace.fetch(hist).numpy().astype(np.int64)  # one fetch
        trees, tabs, spans = _host_trees(freqs)
    with trace.span("deflate.emit"):
        atoms, totals = _emit_pack(terms, valid, freqs, tabs, spans,
                                   plan["TPI"])
    return list(atoms), totals, trees


def _zlib_header(w: BitWriter) -> None:
    w.write_bytes(bytes([0x78, ~((0x78 * 256) % 31) & 31]))


def _stored_stream(data: bytes) -> bytes:
    w = BitWriter()
    _zlib_header(w)
    _write_stored_block(w, data, True)
    w.pad_to_byte()
    return w.drain() + zlib.adler32(data).to_bytes(4, "big")


def _fetch_bodies(atoms_list, totals) -> list[bytes]:
    """One totals fetch and one fetch of every stream's live atoms."""
    tot_h = trace.fetch(totals).numpy()
    sliced = [a[: (int(t) + 31) // 32 + 1] for a, t in zip(atoms_list,
                                                         tot_h)]
    cat = trace.fetch(torch.cat(sliced)).numpy()
    offs = np.cumsum([0] + [s.shape[0] for s in sliced])
    return [(atoms32_to_bytes(cat[offs[j]: offs[j + 1]], int(t)), int(t))
            for j, t in enumerate(tot_h)]


def _zlib_stream(data: bytes, tree, body: bytes, total: int) -> bytes:
    """One single-block zlib stream: header, tables, body, EOB, Adler."""
    lit_l, dist_l = tree
    w = BitWriter()
    _zlib_header(w)
    _write_block_header_and_tables(w, lit_l, dist_l, True)
    append_bits(w, body, total)
    eob = canonical_codes(np.asarray(lit_l, np.int64))[256]
    w.write(reverse_bits(int(eob), int(lit_l[256])), int(lit_l[256]))
    w.pad_to_byte()
    return w.drain() + zlib.adler32(data).to_bytes(4, "big")


_STRICT_FULL_N = 1 << 17      # ≤128 KB: the size probe IS a full native run
_STRICT_WINDOW = 1 << 15      # sampled-window width for larger images
_STRICT_MARGIN = 1.02         # route native when device > est × margin


def _strict_estimate(data: bytes, level: int):
    """Native-parse size probe for the strict size policy.

    Small images are encoded outright (the probe doubles as the
    replacement stream); larger ones estimate bits/byte from three
    scattered windows.
    """
    n = len(data)
    if n <= _STRICT_FULL_N:
        return ("full", _native.deflate(data, level, "zlib"))
    W = _STRICT_WINDOW
    tot_c = tot_n = 0
    for s in (0, (n - W) // 2, n - W):
        w = data[s: s + W]
        tot_c += len(_native.deflate(w, level, "ios"))
        tot_n += len(w)
    return ("bpb", tot_c / tot_n)


def deflate_device_optimal_batch(datas: list[bytes], level: int = 9,
                                 pitch: int = 0, bpp: int = 4, device=None,
                                 dbuf=None,
                                 size_policy: str = "device") -> list[bytes]:
    """Batched one-shot zlib deflate at levels 8–13 (device DP parse).

    Streams under 3 bytes become stored blocks; the rest run in buckets
    of equal power-of-two tile counts, each with one histogram fetch, one
    totals fetch and one fetch of the live atoms.  ``dbuf`` may hold the
    whole batch already staged on the device (``(B·stride,)`` uint8 in
    :func:`batch_layout`); it is used when every stream is in one bucket,
    and names the device when ``device`` is not given.

    ``size_policy="strict"``, with the native library available, holds
    each image to the native parse's size: a native size probe per image
    (:func:`_strict_estimate`) runs on four threads overlapped with the
    device pipeline, and an image whose device stream exceeds the probe's
    estimate by over 2 % is re-encoded natively; the smaller stream ships.
    The device parse still runs for every image.  ``"device"``, or no
    library, always ships the device parse.
    """
    if size_policy not in ("device", "strict"):
        raise ValueError(f"unknown size_policy {size_policy!r}")
    if device is None and dbuf is not None:
        device = dbuf.device
    out: list[bytes | None] = [None] * len(datas)
    small = [i for i, d in enumerate(datas) if len(d) < 3]
    with (trace.span("deflate.optimal"),
          ThreadPoolExecutor(max_workers=4) as pool):
        est_futs = {}
        if size_policy == "strict" and _native.available():
            est_futs = {i: pool.submit(_strict_estimate, d, min(level, 13))
                        for i, d in enumerate(datas) if len(d) >= 3}
        for i in small:
            out[i] = _stored_stream(datas[i])
        # every image of a pipeline call pads to the largest one's tile
        # count, so ragged batches run in power-of-two tile-count buckets
        buckets: dict[int, list[int]] = {}
        for i, d in enumerate(datas):
            if len(d) >= 3:
                tiles = -(-len(d) // TILE)
                buckets.setdefault(tiles.bit_length(), []).append(i)
        for key in sorted(buckets):
            grp = buckets[key]
            sub = [datas[i] for i in grp]
            gbuf = dbuf if (not small and len(buckets) == 1) else None
            atoms_list, totals, trees = optimal_pipeline_batch(
                sub, level=level, pitch=pitch, bpp=bpp, device=device,
                dbuf=gbuf)
            with trace.span("deflate.fetch"):
                bodies = _fetch_bodies(atoms_list, totals)
            with trace.span("deflate.assemble"):
                for j, i in enumerate(grp):
                    out[i] = _zlib_stream(datas[i], trees[j], *bodies[j])
        # strict size policy: each device stream against its native-parse
        # probe; losers re-encode natively (threaded) and the smaller
        # stream ships
        with trace.span("deflate.strict_wait"):
            reroute = []
            for i, fut in est_futs.items():
                kind, est = fut.result()
                if kind == "full":
                    if len(est) < len(out[i]):
                        out[i] = est
                elif len(out[i]) > est * len(datas[i]) * _STRICT_MARGIN:
                    reroute.append(i)
            nstreams = pool.map(
                lambda i: _native.deflate(datas[i], min(level, 13), "zlib"),
                reroute)
            for i, s in zip(reroute, nstreams):
                if len(s) < len(out[i]):
                    out[i] = s
    return out  # type: ignore[return-value]
