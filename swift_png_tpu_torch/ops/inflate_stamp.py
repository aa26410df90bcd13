"""Lockstep DEFLATE token decode + byte stamp (K1) and its plain version.

Counterpart of ``swift_png_tpu/ops/inflate_pallas.py``.  Every OB-byte unit
of every stream decodes its tokens from its own span words with its own
canonical tables, starting at the bit and byte its checkpoint index gives,
and stamps each token's attribute over the unit's output bytes:

* ``-32768`` — byte not covered by any token;
* ``-(sym + 1)`` — a literal byte ``sym``;
* ``dist - 1`` (≥ 0) — a byte copied from ``dist`` bytes back.

It flags 1 for a bad code and 2 for a unit whose tokens stop short of its
owned bytes, and folds the Adler-32 literal partials ``s1 = Σd`` and
``s2 = Σ(ob - b)·d`` over the unit's owned literal bytes.

:func:`decode_stamp` launches the CUDA kernel (``csrc/inflate_stamp.cu``)
for tensors on a CUDA device and runs :func:`decode_stamp_reference` for
tensors on the CPU.

Inputs are unit-major (row ``u`` is unit ``u``): ``spans (U, S)`` int32
span words (little-endian stream bytes), ``meta (U, 3|4)`` int32 — sub-bit,
skip, owned bytes and, with multiblock tables, the boundary-EOB bit jump —,
the batch's table pool, ``pool_t (P, 72)`` and ``pool_s (P, R)`` int32 (one
row per DEFLATE block, :func:`prepare_block_tables`), ``ids (U, 1|2)``
int32, each unit's block and, with multiblock tables, its next block, and
``kbound (U, 2)`` int32, the unit's step budget ``[bound, mode]`` — its
tile's in the TPU kernel (``inflate_checkpoint.tile_budget``):

* mode 0 — at most ``bound`` steps of one token;
* mode 2 — at most ``bound`` steps, where a step that decodes a literal or
  a match also takes the next token when that is a literal;
* mode 1 — an all-literal unit: at most ``8 · ((bound + 3) >> 2)``
  literals, any other code is bad, and the coverage flag is never set.

A valid unit stops when its tokens cover its owned bytes, well inside its
budget; the budget decides only how far a corrupt unit decodes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels, trace

__all__ = ["decode_stamp", "decode_stamp_cuda", "decode_stamp_reference",
           "decode_stamp_units", "prepare_block_tables", "unit_tables",
           "TAB_ROWS", "SENTINEL"]

TAB_ROWS = 72      # packed table rows per block (see prepare_block_tables)
SENTINEL = -32768  # attr value for "byte not covered"


def prepare_block_tables(lit_lengths: np.ndarray, dist_lengths: np.ndarray):
    """Packed per-block decode tables (host, numpy): the function of
    ``inflate_pallas.prepare_block_tables``, vectorized over blocks.

    Takes one block's code lengths, ``(288,)`` and ``(32,)``, or a stack of
    ``P`` blocks, ``(P, 288)`` and ``(P, 32)``.  Returns ``(tabs (72,)
    int32, symtab (128,) int32)`` per block (with a leading ``P`` axis for
    a stack):

    * ``tabs[l]`` (1…15) — literal canonical thresholds ``lim[l] << (15-l)``
      (non-decreasing, so code length = 1 + #{thresholds ≤ window});
      ``tabs[16+l]`` — ``offset[l] - first[l]`` so ``symidx = code + adj``;
      ``tabs[32+l]`` / ``tabs[48+l]`` — the same for the distance tree;
      ``tabs[64+r]`` — distance symbols packed four 8-bit per row (value =
      dsym of the length-sorted entry, 255 = invalid).
    * ``symtab[r]`` — literal symbols packed three 10-bit per row (value =
      sym of the length-sorted entry at ``3r+j``; 1023 = invalid/reserved:
      symbols 286/287 and out-of-range indexes flag as corrupt).
    """
    lit = np.asarray(lit_lengths, np.int64)
    dist = np.asarray(dist_lengths, np.int64)
    single = lit.ndim == 1
    lit, dist = np.atleast_2d(lit), np.atleast_2d(dist)
    P = lit.shape[0]

    def canonical(lengths):
        counts = np.stack([(lengths == l).sum(1) for l in range(16)], 1)
        counts[:, 0] = 0
        first = np.zeros((P, 16), np.int64)
        f = np.zeros(P, np.int64)
        for l in range(1, 16):
            first[:, l] = f
            f = (f + counts[:, l]) << 1
        offset = np.zeros((P, 16), np.int64)
        offset[:, 1:] = np.cumsum(counts, 1)[:, :-1]
        order = np.argsort(np.where(lengths > 0, lengths, 99) * 1024
                           + np.arange(lengths.shape[1]), axis=1,
                           kind="stable")
        return (first[:, 1:], first[:, 1:] + counts[:, 1:], offset[:, 1:],
                order, np.count_nonzero(lengths, 1)[:, None])

    lfirst, llim, loffset, lorder, nlit = canonical(lit)
    dfirst, dlim, doffset, dorder, ndist = canonical(dist)
    shift = 15 - np.arange(1, 16)
    tabs = np.zeros((P, TAB_ROWS), np.int64)
    tabs[:, 1:16] = llim << shift
    tabs[:, 17:32] = loffset - lfirst
    tabs[:, 33:48] = dlim << shift
    tabs[:, 49:64] = doffset - dfirst
    ds = np.where((np.arange(32) < ndist) & (dorder <= 29), dorder, 255)
    tabs[:, 64:72] = (ds[:, 0::4] | ds[:, 1::4] << 8 | ds[:, 2::4] << 16
                      | ds[:, 3::4] << 24)
    lo = np.full((P, 384), 1023, np.int64)
    lo[:, :lorder.shape[1]] = lorder
    syms = np.where((np.arange(384) < nlit) & (lo <= 285), lo, 1023)
    symtab = syms[:, 0::3] | syms[:, 1::3] << 10 | syms[:, 2::3] << 20
    # int32 as the kernel reads them (packed distance rows wrap, as the
    # TPU version's uint32 → int32 view does)
    tabs, symtab = tabs.astype(np.int32), symtab.astype(np.int32)
    return (tabs[0], symtab[0]) if single else (tabs, symtab)


def _layout(spans, meta, pool_t, pool_s, ids, kbound):
    """(U, S, multiblock, R) from the input shapes, checked."""
    U, S = spans.shape
    multiblock = meta.shape[1] == 4
    if meta.shape != (U, 4 if multiblock else 3):
        raise ValueError(f"meta must be (U, 3|4), got {tuple(meta.shape)}")
    if ids.shape != (U, 2 if multiblock else 1):
        raise ValueError(f"ids must be (U, 1|2) matching meta, got "
                         f"{tuple(ids.shape)}")
    if pool_t.dim() != 2 or pool_t.shape[1] != TAB_ROWS:
        raise ValueError(f"pool_t must be (P, {TAB_ROWS}), got "
                         f"{tuple(pool_t.shape)}")
    if (pool_s.dim() != 2 or pool_s.shape[0] != pool_t.shape[0]
            or pool_s.shape[1] == 0):
        raise ValueError(f"pool_s must be (P, R) beside pool_t, got "
                         f"{tuple(pool_s.shape)}")
    if kbound.shape != (U, 2):
        raise ValueError(f"kbound must be (U, 2), got {tuple(kbound.shape)}")
    # the kernel indexes the pool by these ids: none may leave it
    if U:
        with trace.sync(2):
            lo, hi = int(ids.min()), int(ids.max())
        if not 0 <= lo <= hi < pool_t.shape[0]:
            raise ValueError(f"ids must index the pool's {pool_t.shape[0]} "
                             f"blocks")
    return U, S, multiblock, pool_s.shape[1]


def unit_tables(pool_t, pool_s, ids):
    """Each unit's own copy of its tables, ``(tabs (U, 72|144), symtab
    (U, R|2R))``: its block's columns, then its next block's."""
    U = ids.shape[0]
    i = ids.long()
    return pool_t[i].reshape(U, -1), pool_s[i].reshape(U, -1)


def decode_stamp(spans, meta, pool_t, pool_s, ids, kbound, *, ob: int):
    """K1 on the inputs' device.  Returns ``(attr (U, ob) int32, flag (U,)
    int32, s1 (U,) int64, s2 (U,) int64)``."""
    if spans.device.type == "cpu":
        return decode_stamp_reference(spans, meta, pool_t, pool_s, ids,
                                      kbound, ob=ob)
    return decode_stamp_cuda(spans, meta, pool_t, pool_s, ids, kbound, ob=ob)


def decode_stamp_cuda(spans, meta, pool_t, pool_s, ids, kbound, *, ob: int):
    """Launch the K1 CUDA kernel (``csrc/inflate_stamp.cu``)."""
    U, S, multiblock, R = _layout(spans, meta, pool_t, pool_s, ids, kbound)
    for name, t in (("spans", spans), ("meta", meta), ("pool_t", pool_t),
                    ("pool_s", pool_s), ("ids", ids), ("kbound", kbound)):
        _kernels.require(t, name, torch.int32, 2)
    dev = spans.device
    attr = torch.empty((U, ob), dtype=torch.int32, device=dev)
    flag = torch.empty(U, dtype=torch.int32, device=dev)
    s1 = torch.empty(U, dtype=torch.int64, device=dev)
    s2 = torch.empty(U, dtype=torch.int64, device=dev)
    _kernels.KERNELS["decode_stamp"].launch(
        spans.data_ptr(), meta.data_ptr(), pool_t.data_ptr(),
        pool_s.data_ptr(), ids.data_ptr(), kbound.data_ptr(),
        attr.data_ptr(), flag.data_ptr(), s1.data_ptr(), s2.data_ptr(), U, S,
        ob, R, int(multiblock), _kernels.stream_of(spans))
    return attr, flag, s1, s2


def _rev15(x):
    """Bit-reverse the low 15 bits."""
    x = x & 0x7FFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _canon(r15, thr, adj):
    """Canonical decode against per-unit thresholds ``thr (U, 15)`` and
    adjusts ``adj (U, 15)``: returns ``(length (16 = no code), adjust)``."""
    ge = r15[:, None] >= thr
    length = 1 + ge.sum(1)
    a = adj[:, 0] + (ge[:, :14] * (adj[:, 1:] - adj[:, :-1])).sum(1)
    return length, a


def decode_stamp_reference(spans, meta, pool_t, pool_s, ids, kbound, *,
                           ob: int):
    """Plain PyTorch K1: each unit takes its own copy of its tables
    (:func:`unit_tables`) and decodes as :func:`decode_stamp_units`."""
    _layout(spans, meta, pool_t, pool_s, ids, kbound)
    return decode_stamp_units(spans, meta, *unit_tables(pool_t, pool_s, ids),
                              kbound, ob=ob)


def decode_stamp_units(spans, meta, tabs, symtab, kbound, *, ob: int):
    """K1's function on per-unit tables, ``tabs (U, 72|144)`` and ``symtab
    (U, R|2R)``: one token per iteration, vectorized over units.  A token
    either takes a step of the unit's budget or, in mode 2, rides on the
    step before it (a literal after a literal or a match).
    Arithmetic is int64 with the span words masked to 32 bits; the bit
    cursor wraps like the kernel's int32 one."""
    U, S = spans.shape
    multiblock = meta.shape[1] == 4
    R = symtab.shape[1] // 2 if multiblock else symtab.shape[1]
    dev = spans.device
    sp = spans.long() & 0xFFFFFFFF
    m = meta.long()
    tb = tabs.long()
    sy = symtab.long()
    kb = kbound[:, 0].long()
    lit_only = kbound[:, 1] == 1
    pair = kbound[:, 1] == 2
    steps = torch.where(lit_only, 8 * ((kb + 3) >> 2), kb)
    owned = m[:, 2]
    jumpv = m[:, 3] if multiblock else torch.zeros_like(owned)
    # per-unit table columns: [first block, next block]
    cols = [(tb[:, 1:16], tb[:, 17:32], tb[:, 33:48], tb[:, 49:64],
             tb[:, 64:72])]
    if multiblock:
        cols.append(tuple(c for c in (tb[:, 73:88], tb[:, 89:104],
                                      tb[:, 105:120], tb[:, 121:136],
                                      tb[:, 136:144])))

    def word(i):
        ok = (i >= 0) & (i < S)
        w = sp.gather(1, i.clamp(0, S - 1)[:, None])[:, 0]
        return torch.where(ok, w, 0)

    def window(bit):
        wq = bit >> 5
        sub = bit & 31
        hi = torch.where(sub == 0, 0, (word(wq + 1) << (32 - sub))
                         & 0xFFFFFFFF)
        return (word(wq) >> sub) | hi

    def pick(sw, i):
        if not multiblock:
            return cols[0][i]
        return torch.where(sw[:, None], cols[1][i], cols[0][i])

    b = torch.arange(ob, device=dev)
    attr = torch.full((U, ob), SENTINEL, dtype=torch.int32, device=dev)
    bitrel = m[:, 0].clone()
    cur = -m[:, 1]
    flag = torch.zeros(U, dtype=torch.int64, device=dev)
    stopped = torch.zeros(U, dtype=torch.bool, device=dev)
    sw = torch.zeros(U, dtype=torch.bool, device=dev)
    taken = torch.zeros(U, dtype=torch.int64, device=dev)  # steps taken
    free = torch.zeros(U, dtype=torch.bool, device=dev)  # next literal rides
    one = torch.ones((), dtype=torch.int64, device=dev)
    while True:
        live = (cur < owned) & ~stopped
        if not bool(live.any()):
            break
        win = window(bitrel)
        r15 = _rev15(win)
        l, adj = _canon(r15, pick(sw, 0), pick(sw, 1))
        lbad = l > 15
        ls = l.clamp(max=15)
        code = r15 >> (15 - ls)
        symidx = (code + adj).clamp(0, 3 * R - 1)
        q3 = symidx // 3 + torch.where(sw, R, 0)
        r3 = symidx % 3
        sym = (sy.gather(1, q3[:, None])[:, 0] >> (10 * r3)) & 1023
        dec = (sym - 257).clamp(0, 28)
        e_run = torch.where((dec < 4) | (dec == 28), 0, (dec >> 2) - 1)
        rbase = torch.where(dec < 4, dec + 3,
                            torch.where(dec == 28, 258,
                                        ((4 + (dec & 3)) << e_run) + 3))
        run = rbase + ((win >> ls) & ((one << e_run) - 1))
        is_lit = ~lbad & (sym < 256)
        is_eob = ~lbad & (sym == 256)
        is_runtok = ~lbad & (sym >= 257) & (sym <= 285)

        win2 = window(bitrel + ls + e_run)
        r15d = _rev15(win2)
        dl, dadj = _canon(r15d, pick(sw, 2), pick(sw, 3))
        dbad = dl > 15
        dls = dl.clamp(max=15)
        didx = ((r15d >> (15 - dls)) + dadj).clamp(0, 31)
        wd = pick(sw, 4).gather(1, (didx >> 2)[:, None])[:, 0]
        dsym = (wd >> ((didx & 3) << 3)) & 255
        ds = dsym.clamp(max=29)
        e_d = torch.where(ds < 4, 0, (ds >> 1) - 1)
        dbase = torch.where(ds < 4, ds + 1, ((2 + (ds & 1)) << e_d) + 1)
        dist = dbase + ((win2 >> dls) & ((one << e_d) - 1))
        is_match = is_runtok & ~dbad & (dsym <= 29)

        may_jump = is_eob & (jumpv > 0) & ~sw if multiblock else \
            torch.zeros_like(is_eob)
        rides = live & free & is_lit
        spent = live & ~rides & (taken >= steps)
        active = live & ~rides & ~spent
        bad = active & (lbad | (is_eob & ~may_jump)
                        | (~is_lit & ~is_eob & ~is_runtok)
                        | (is_runtok & ~is_match) | (lit_only & ~is_lit))
        go = (active & ~bad) | rides
        tl = torch.where(go & is_lit, 1, torch.where(go & is_match, run, 0))
        aux = torch.where(is_lit, -(sym + 1), dist - 1)
        span = (b >= cur.clamp(min=0)[:, None]) & (b < (cur + tl)[:, None])
        attr = torch.where(span, aux[:, None].to(torch.int32), attr)
        step = torch.where(is_lit, ls, ls + e_run + dls + e_d)
        step = torch.where(may_jump, ls + jumpv, step)
        bitrel = torch.where(go, bitrel + step, bitrel)
        bitrel = ((bitrel + 2 ** 31) % 2 ** 32) - 2 ** 31
        sw = sw | (go & may_jump)
        cur = cur + tl
        flag = flag | torch.where(bad, 1, 0)
        stopped = stopped | bad | spent
        taken = taken + active.long()
        free = pair & active & ~bad & (is_lit | is_match)
    flag = flag | torch.where((cur < owned) & ~lit_only, 2, 0)

    a = attr.long()
    lit = (a < 0) & (a != SENTINEL) & (b < owned[:, None])
    d = torch.where(lit, -a - 1, 0)
    s1 = d.sum(1)
    s2 = ((ob - b) * d).sum(1)
    return attr, flag.to(torch.int32), s1, s2
