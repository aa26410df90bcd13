"""Checkpoint-parallel indexed inflate on the GPU.

Counterpart of ``swift_png_tpu/ops/inflate_checkpoint.py`` for the
literal-heavy branch of its main path (``CheckpointInflator.run`` →
``prepare`` → ``inflate_indexed_pallas``).  A stream's output is split into
``ob``-byte units; the checkpoint index gives each unit the bit and byte
where its first token starts, so every unit of every stream decodes
independently (K1, :mod:`.inflate_stamp`).  The torch tail then places the
literal and stored bytes, checks the flags, resolves the back-references
and combines the Adler-32 checksum.

Layout is unit-major: row ``u`` of every per-unit array is unit ``u`` (unit
``ul`` of stream ``u // Ui``).  The TPU version's lane transposes, tile
padding and per-tile step modes existed for the TPU's lockstep and are not
here: each unit carries its own token bound.

The match-dominated modes (dense pointer collapse, the records kernel,
distance sweeps, the native host tier) are the next slice; every batch
takes this branch, whose expansion is exact for any content.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host.lz77.errors import DecompressionError
from .._kernels import resolve_device
from .._host.lz77.index import GAP_NONE, KIND_STORED, CheckpointIndex
from .inflate_stamp import SENTINEL, decode_stamp, prepare_block_tables

__all__ = ["CheckpointInflator", "inflate_indexed_stamp", "inflate_tail",
           "expand_matches", "adler_from_partials"]

F_BAD = 1
_MOD = 65521


def expand_matches(ptr: torch.Tensor, litv: torch.Tensor) -> torch.Tensor:
    """Resolve LZ77 back-references over the flat output.

    ``ptr[j]`` is ``j`` for a literal (or stored, or flagged) byte and the
    source position ``j - dist`` for a match byte; ``litv`` holds the
    literal values.  Every match points strictly backward, so the pointer
    graph is a forest whose roots are literals: pointer doubling
    (``ptr = ptr[ptr]``) reaches every byte's root in ``log2(depth) + 1``
    rounds, and the output is ``litv[root]``.  This realizes the byte-by-
    byte forward copy of an overlapping match (``dist < len``) exactly,
    and it needs no capacity: there is nothing to overflow, so the TPU
    version's expansion caps and their retry loop have no counterpart.
    """
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    return litv[ptr]


def adler_from_partials(s1u, s2u, mv, ob: int, out_size: int):
    """Adler-32 per stream from per-unit literal partials plus the
    match-byte sums, in int64 (no modular folding is needed: the sums of a
    stream stay far below 2^63).

    ``s1u/s2u``: ``(B, Ui)`` — Σd and Σ(ob - b)·d over each unit's owned
    literal (and stored) bytes.  ``mv``: ``(B, Opad)`` int64 — the value of
    every live match byte, 0 elsewhere.  With ``n = out_size``, Adler's
    ``s2 = n + Σ_p (n - p)·d[p]``; a literal at ``p = ul·ob + b``
    contributes ``(n - (ul+1)·ob)·d + (ob - b)·d``.
    """
    Ui = s1u.shape[1]
    ul = torch.arange(Ui, device=s1u.device)
    coef = out_size - (ul + 1) * ob
    a_lit = s1u.sum(1)
    s2_lit = (coef * s1u + s2u).sum(1)
    p = torch.arange(mv.shape[1], device=mv.device)
    a_cor = mv.sum(1)
    s2_cor = ((out_size - p) * mv).sum(1)
    s1 = (1 + a_lit + a_cor) % _MOD
    s2 = (out_size + s2_lit + s2_cor) % _MOD
    return (s2 << 16) | s1


def inflate_indexed_stamp(prep: dict):
    """Indexed inflate of a prepared batch (:meth:`CheckpointInflator.
    prepare`): K1, then the torch tail.

    Returns ``(out (B, out_size) uint8, flag (U,) int32, adler (B,) int64,
    ovf)``.  ``flag`` is nonzero for a unit with a bad code, short
    coverage, an uncovered live byte, or a match reaching before its
    stream's start.  ``ovf`` is always ``False``: the pointer-doubling
    expansion (:func:`expand_matches`) has no capacity to overflow.
    """
    attr, kflag, s1k, s2k = decode_stamp(
        prep["spans"], prep["meta"], prep["tabs"], prep["symtab"],
        prep["kbound"], ob=prep["ob"])
    return inflate_tail(attr, kflag, s1k, s2k, prep)


def inflate_tail(attr, kflag, s1k, s2k, prep: dict):
    """The non-collapse tail after K1: live mask, stored-unit byte fill,
    flags, back-reference expansion and the Adler-32 combine.  Same
    contract as :func:`inflate_indexed_stamp`."""
    ob, B, Ui = prep["ob"], prep["B"], prep["Ui"]
    out_size = prep["out_size"]
    U = attr.shape[0]
    Opad = Ui * ob
    dev = attr.device
    b = torch.arange(ob, device=dev)
    u = torch.arange(U, device=dev)
    ul = u % Ui
    live = b < (out_size - ul * ob).clamp(max=ob)[:, None]
    ism = attr >= 0                     # match: attr = dist - 1
    is_lit = (attr < 0) & (attr != SENTINEL)
    uncovered = attr == SENTINEL
    litv = torch.where(live & is_lit, -attr - 1, 0).to(torch.uint8)
    s1u, s2u = s1k, s2k

    if prep["has_stored"]:
        # dense byte unpack of each stored unit's span head; the copy
        # source skips every recorded gap (stored headers and stacked flush
        # markers) at its offset, cumulatively over the unit's gaps
        gaps = prep["stored_gap"]
        ng = gaps.shape[0] // 2
        stored = (gaps[0] >= 0)[:, None]
        sb = prep["spans"].view(torch.uint8).reshape(U, -1).long()
        idx = b.expand(U, ob)
        for kg in range(ng):
            off = torch.where(gaps[kg] >= 0, gaps[kg], ob)
            idx = idx + torch.where(b >= off[:, None], gaps[ng + kg][:, None],
                                    0)
        sbytes = sb.gather(1, idx)
        sel = stored & live
        litv = torch.where(sel, sbytes.to(torch.uint8), litv)
        uncovered = uncovered & ~stored
        # stored bytes are literals for the checksum
        d = torch.where(sel, sbytes, 0)
        s1u = s1u + d.sum(1)
        s2u = s2u + ((ob - b) * d).sum(1)

    j = u[:, None] * ob + b
    src = j - (attr.long() + 1)
    sbase = (u // Ui * Opad)[:, None]
    mlive = live & ism
    flag = kflag | torch.where(((src < sbase) & mlive).any(1), F_BAD, 0)
    flag = flag | torch.where((live & uncovered).any(1), F_BAD, 0)

    ptr = torch.where(mlive & (src >= sbase), src, j).reshape(-1)
    out = expand_matches(ptr, litv.reshape(-1)).reshape(B, Opad)
    mv = torch.where(mlive.reshape(B, Opad), out.long(), 0)
    adler = adler_from_partials(s1u.reshape(B, Ui), s2u.reshape(B, Ui), mv,
                                ob, out_size)
    return (out[:, :out_size].contiguous(), flag.to(torch.int32), adler,
            False)


class CheckpointInflator:
    """Host staging + device inflate for a batch of indexed streams.

    ``device``: where the batch decodes — ``cuda`` unless the caller names
    another (``"cpu"`` runs the plain PyTorch versions).  With no device
    named and no GPU present, construction raises.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def prepare(self, bodies: list[bytes],
                indexes: list[CheckpointIndex]) -> dict:
        """Slice per-unit spans and tables to the unit-major device layout.

        Returns a dict of tensors on the device: ``spans (U, S)`` int32
        words, ``meta (U, 3|4)`` int32 (sub-bit, skip, owned bytes — 0 for
        stored units, which the tail fills —, and with multiblock tables
        the boundary-EOB bit jump), ``tabs (U, 72|144)`` and ``symtab
        (U, R|2R)`` int32 per-unit tables (the unit's block, then its next
        block), ``kbound (U,)`` int32 token bounds and, where any unit is
        stored, ``stored_gap (2·NG, U)`` int32 (rows ``0…NG``: gap
        offsets, ``-1`` in row 0 for token units and ``ob`` for absent
        gaps; rows ``NG…2·NG``: gap widths); plus the batch's scalars.
        """
        out_size = indexes[0].out_size
        ob = indexes[0].ob
        for ix in indexes:
            if ix.out_size != out_size or ix.ob != ob:
                raise ValueError("a batch needs one out_size and one ob")
        Ui = (out_size + ob - 1) // ob
        B = len(bodies)
        U = B * Ui
        multiblock = any(ix.multiblock for ix in indexes)
        has_stored = any(ix.unit_kind.any() for ix in indexes)
        # v5 multi-gap stored chains: per-unit total skipped bytes bound the
        # span; the gap table has one (off, len) row pair per gap rank
        n_gaps = 1
        gmax = 5
        for ix in indexes:
            gmax = max(gmax, int(ix.gap_len.max()))
            if ix.extra_gaps:
                n_gaps = max(n_gaps,
                             1 + max(len(v) for v in ix.extra_gaps.values()))
                for uu, ex in ix.extra_gaps.items():
                    gmax = max(gmax, int(ix.gap_len[uu])
                               + sum(ln for _, ln in ex))
        span_bytes = max(ix.max_span_bytes() for ix in indexes)
        if has_stored:
            span_bytes = max(span_bytes, ob + 9 + gmax)
        S = -(-((span_bytes + 3) // 4) // 8) * 8
        # every body followed by S·4 zero bytes (a window past the body's
        # end reads zeros); the units' windows are cut on the device
        offs = np.cumsum([0] + [len(b) + S * 4 for b in bodies])
        buf = np.zeros(int(offs[-1]), np.uint8)
        starts = np.zeros(U, np.int64)
        meta = np.zeros((U, 4 if multiblock else 3), np.int32)
        kbound = np.zeros(U, np.int32)
        sgap = np.full((n_gaps, U), -1, np.int32)
        sgap[1:] = ob          # rank-2+ gaps: ob = "never" when absent
        sglen = np.zeros((n_gaps, U), np.int32)
        tab_a = np.zeros(U, np.int64)   # per-unit ids into the table pool
        tab_b = np.zeros(U, np.int64)
        pool_lit, pool_dist = [], []
        for i, (body, ix) in enumerate(zip(bodies, indexes)):
            sb = (ix.bit_pos >> 3).astype(np.int64)
            # the index comes from the file: a unit entry past its body or
            # a block id past its tables would make the device gathers
            # read out of bounds
            if sb.size and (sb.max() > len(body)
                            or ix.unit_block.min() < 0
                            or ix.unit_block.max() >= ix.n_blocks):
                raise DecompressionError.invalid_huffman_table()
            base = i * Ui
            rows = slice(base, base + Ui)
            buf[offs[i]: offs[i] + len(body)] = np.frombuffer(body, np.uint8)
            starts[rows] = offs[i] + sb
            meta[rows, 0] = (ix.bit_pos
                             - (sb << 3).astype(np.uint64)).astype(np.int32)
            meta[rows, 1] = ix.skip
            st = ix.unit_kind == KIND_STORED
            ow = np.minimum(ob, out_size - np.arange(Ui) * ob)
            meta[rows, 2] = np.where(st, 0, ow)
            if multiblock:
                meta[rows, 3] = ix.eob_jump.astype(np.int32)
            kbound[rows] = ix.n_tokens
            sgap[0, rows] = np.where(
                st, np.where(ix.gap_off == GAP_NONE, ob,
                             ix.gap_off.astype(np.int32)), -1)
            sglen[0, rows] = np.where(st & (ix.gap_off != GAP_NONE),
                                      ix.gap_len.astype(np.int32), 0)
            if ix.extra_gaps:
                for uu, ex in ix.extra_gaps.items():
                    for kg, (goff, glen) in enumerate(ex, start=1):
                        sgap[kg, base + uu] = goff
                        sglen[kg, base + uu] = glen
            p0 = len(pool_lit)
            for bnum in range(ix.n_blocks):
                pool_lit.append(ix.lit_lengths[bnum])
                pool_dist.append(ix.dist_lengths[bnum])
            tab_a[rows] = p0 + ix.unit_block
            tab_b[rows] = p0 + np.minimum(ix.unit_block + 1, ix.n_blocks - 1)
        pool_lit = np.stack(pool_lit)
        tabs_all, sym_all = prepare_block_tables(pool_lit,
                                                 np.stack(pool_dist))
        # trim the packed literal-symbol rows to the populated range: a
        # structurally valid decode lands at symidx < nlit
        rows3 = -(-int(np.count_nonzero(pool_lit, 1).max()) // 3)
        R = max(8, -(-rows3 // 8) * 8)
        dev = self.device
        spans = torch.from_numpy(buf).to(dev).unfold(0, S * 4, 1)[
            torch.from_numpy(starts).to(dev)]
        pool_t = torch.from_numpy(tabs_all).to(dev)
        pool_s = torch.from_numpy(np.ascontiguousarray(sym_all[:, :R])).to(dev)
        ids_a = torch.from_numpy(tab_a).to(dev)
        tabs, symtab = pool_t[ids_a], pool_s[ids_a]
        if multiblock:
            ids_b = torch.from_numpy(tab_b).to(dev)
            tabs = torch.cat([tabs, pool_t[ids_b]], dim=1)
            symtab = torch.cat([symtab, pool_s[ids_b]], dim=1)
        return dict(
            out_size=out_size, ob=ob, B=B, Ui=Ui, S=S,
            multiblock=multiblock, has_stored=has_stored,
            spans=spans.view(torch.int32),
            meta=torch.from_numpy(meta).to(dev),
            tabs=tabs.contiguous(), symtab=symtab.contiguous(),
            kbound=torch.from_numpy(kbound).to(dev),
            stored_gap=(torch.from_numpy(np.concatenate([sgap, sglen]))
                        .to(dev) if has_stored else None))

    def run(self, bodies: list[bytes], indexes: list[CheckpointIndex]):
        """Inflate a batch of same-size indexed streams on the device.

        Returns ``(out (B, out_size) uint8 tensor on the device, adler (B,)
        uint32 numpy)``.  Raises :class:`DecompressionError` when any unit
        flags.  The Adler-32 is returned for the caller to hold against the
        stream trailers, as the JAX version's is.
        """
        prep = self.prepare(bodies, indexes)
        out, flag, adler, _ = inflate_indexed_stamp(prep)
        if int(flag.max()) != 0:
            raise DecompressionError.invalid_huffman_table()
        return out, adler.cpu().numpy().astype(np.uint32)
