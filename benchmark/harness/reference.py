"""The plain reference that decides ``correct``: numpy and Python's ``zlib``
only, nothing of the program.

Decode cells: the program's pixels against the pixels the benchmark made
(PNG is lossless, so a right decode of the benchmark's files is exactly the
source).  Encode cells: every file is read here from its bytes: signature,
chunk order and CRCs, IHDR, the zlib stream (its Adler-32 checked by
``zlib``), each inflated row against the PNG filter that its type byte names
applied to the source pixels, and the ``spIx`` checkpoint chunk, parsed here
and used: sampled units are decoded token by token from their checkpoint
with the chunk's own code tables, and every byte they give is held against
the inflated stream.
"""

from __future__ import annotations

import zlib

import numpy as np

from .corpus import SIGNATURE, filter_candidates

# RFC 1951 3.2.5: length and distance bases and extra bits
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
             4, 4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
              9, 10, 10, 11, 11, 12, 12, 13, 13)


def mismatched_bytes(got, want: np.ndarray) -> int:
    """Bytes of ``got`` that differ from ``want``; every byte when the shape
    or type differs."""
    got = np.asarray(got)
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def chunks(data: bytes):
    """``[(type, payload)]`` of a PNG, or ``None`` when the signature, a
    length or a CRC is wrong or bytes follow IEND."""
    if data[:8] != SIGNATURE:
        return None
    out, o = [], 8
    while o + 12 <= len(data):
        n = int.from_bytes(data[o:o + 4], "big")
        kind = data[o + 4:o + 8]
        body = data[o + 8:o + 8 + n]
        crc = data[o + 8 + n:o + 12 + n]
        if len(body) != n or len(crc) != 4:
            return None
        if zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            return None
        out.append((kind, body))
        o += 12 + n
        if kind == b"IEND":
            return out if o == len(data) else None
    return None


def parse_spix(data: bytes) -> dict:
    """The fields of an ``spIx`` payload, versions 4 and 5: header, per-block
    code lengths and per-unit records.  Raises ``ValueError`` when the
    payload is malformed."""
    if len(data) < 27 or data[0] not in (4, 5):
        raise ValueError("spIx: unsupported version")
    ob = int.from_bytes(data[1:5], "big")
    out_size = int.from_bytes(data[5:13], "big")
    end_bit = int.from_bytes(data[13:21], "big")
    units = int.from_bytes(data[21:25], "big")
    nb = int.from_bytes(data[25:27], "big")
    o = 27
    if len(data) < o + nb * 320 + units * 21:
        raise ValueError("spIx: short payload")
    lit = [np.frombuffer(data[o + 320 * b:o + 320 * b + 288], np.uint8)
           for b in range(nb)]
    dist = [np.frombuffer(data[o + 320 * b + 288:o + 320 * (b + 1)], np.uint8)
            for b in range(nb)]
    o += 320 * nb
    rec = np.frombuffer(data[o:o + 21 * units], np.uint8).reshape(units, 21)
    rec = rec.astype(np.int64)

    def field(a, n):
        v = np.zeros(units, np.int64)
        for k in range(n):
            v = (v << 8) | rec[:, a + k]
        return v

    return dict(ob=ob, out_size=out_size, end_bit=end_bit, units=units,
                lit=lit, dist=dist, bit_pos=np.cumsum(field(0, 4)),
                skip=field(4, 2), n_tokens=field(6, 2), block=field(8, 2),
                kind=rec[:, 10], eob_jump=field(11, 4))


def code_table(lengths: np.ndarray) -> list:
    """A 2**15-entry lookup of a canonical Huffman code (RFC 1951 3.2.2) for
    bits read least significant first: ``(symbol, length)`` per 15-bit
    window, ``None`` where no code matches."""
    lengths = [int(v) for v in lengths]
    table: list = [None] * (1 << 15)
    count = [0] * 16
    for n in lengths:
        if n:
            count[n] += 1
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    for sym, n in enumerate(lengths):
        if not n:
            continue
        c = nxt[n]
        nxt[n] += 1
        rev = int(format(c, f"0{n}b")[::-1], 2)
        for hi in range(0, 1 << 15, 1 << n):
            table[rev | hi] = (sym, n)
    return table


def _bits(body: bytes, pos: int, n: int) -> int:
    byte = pos >> 3
    w = int.from_bytes(body[byte:byte + 5], "little")
    return (w >> (pos & 7)) & ((1 << n) - 1)


def unit_matches(body: bytes, out: bytes, ix: dict, u: int, tables) -> bool:
    """Whether unit ``u``'s checkpoint decodes to the stream's bytes: from
    ``bit_pos[u]``, ``n_tokens[u]`` tokens under the unit's block tables
    (switching to the next block's after a boundary end-of-block, by
    ``eob_jump[u]`` bits), starting ``skip[u]`` bytes before the unit,
    give exactly ``out`` there and cover every byte the unit owns."""
    ob, size = ix["ob"], ix["out_size"]
    start = u * ob
    end = min(start + ob, size)
    p = start - int(ix["skip"][u])
    pos = int(ix["bit_pos"][u])
    block = int(ix["block"][u])
    if p < 0 or block >= len(tables):
        return False
    lit, dist = tables[block]
    for _ in range(int(ix["n_tokens"][u])):
        hit = lit[_bits(body, pos, 15)]
        if hit is None:
            return False
        sym, n = hit
        pos += n
        if sym < 256:
            if p >= size or out[p] != sym:
                return False
            p += 1
        elif sym == 256:
            jump = int(ix["eob_jump"][u])
            if not jump or block + 1 >= len(tables):
                return False
            pos += jump
            block += 1
            lit, dist = tables[block]
        else:
            k = sym - 257
            if k >= 29:
                return False
            ln = LEN_BASE[k] + _bits(body, pos, LEN_EXTRA[k])
            pos += LEN_EXTRA[k]
            hit = dist[_bits(body, pos, 15)]
            if hit is None or hit[0] >= 30:
                return False
            dsym, n = hit
            pos += n
            d = DIST_BASE[dsym] + _bits(body, pos, DIST_EXTRA[dsym])
            pos += DIST_EXTRA[dsym]
            if d > p or p + ln > size:
                return False
            # byte k of the copy is out[p - d + k], overlapping or not
            if out[p:p + ln] != out[p - d:p - d + ln]:
                return False
            p += ln
    return p >= end


def check_files(files: list[bytes], pixels: np.ndarray, rng,
                spix_units: int = 0, cands: np.ndarray | None = None) -> dict:
    """Judge encoded PNG ``files`` against the source ``pixels`` ``(B, H, W,
    4)`` uint8.  Returns counts: ``file_errors`` (files that do not read
    as an 8-bit RGBA non-interlaced PNG of the source's size with a good
    zlib stream), ``rows_wrong`` (inflated rows that are not the source row
    under the filter their type byte names), and with ``spix_units`` > 0,
    ``spix_errors`` (files without a well-formed ``spIx`` chunk for their
    stream) and ``spix_units_wrong`` of ``spix_units_checked`` (the first
    and last unit and ``spix_units`` more drawn by ``rng``, per file).
    ``cands`` may pass :func:`filter_candidates` of the source, computed
    once for many batches."""
    B, H, W, _ = pixels.shape
    pitch = 4 * W
    if cands is None:
        cands = filter_candidates(pixels.reshape(B, H, pitch), 4)
    res = dict(file_errors=0, rows_wrong=0)
    if spix_units:
        res.update(spix_errors=0, spix_units_wrong=0, spix_units_checked=0)
    if len(files) != B:
        res["file_errors"] += abs(B - len(files))
    for b, data in enumerate(files[:B]):
        parts = chunks(data) if isinstance(data, bytes) else None
        if not parts or parts[0][0] != b"IHDR" or parts[-1][0] != b"IEND":
            res["file_errors"] += 1
            res["rows_wrong"] += H
            continue
        hdr = parts[0][1]
        stream = b"".join(p for k, p in parts if k == b"IDAT")
        try:
            raw = zlib.decompress(stream)
        except zlib.error:
            raw = b""
        critical = {k for k, _ in parts if not k[0] & 0x20}
        if (hdr != (W.to_bytes(4, "big") + H.to_bytes(4, "big")
                    + bytes([8, 6, 0, 0, 0]))
                or len(raw) != H * (1 + pitch)
                or not critical <= {b"IHDR", b"IDAT", b"IEND"}):
            res["file_errors"] += 1
            res["rows_wrong"] += H
            continue
        rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + pitch)
        ft = rows[:, 0].astype(np.int64)
        ok = ft < 5
        want = cands[np.minimum(ft, 4), b, np.arange(H)]
        ok &= (rows[:, 1:] == want).all(1)
        res["rows_wrong"] += int(H - ok.sum())
        if spix_units:
            spix = [p for k, p in parts if k == b"spIx"]
            try:
                ix = parse_spix(spix[0]) if len(spix) == 1 else None
            except ValueError:
                ix = None
            body = stream[2:-4]
            U = -(-len(raw) // ix["ob"]) if ix and ix["ob"] else -1
            if (ix is None or ix["ob"] % 64 or ix["out_size"] != len(raw)
                    or ix["units"] != U or not ix["lit"]
                    or (np.diff(ix["bit_pos"]) < 0).any()
                    or int(ix["bit_pos"][-1]) >= 8 * len(body)
                    or ix["end_bit"] > 8 * len(body)):
                res["spix_errors"] += 1
                continue
            tables = [(code_table(lt), code_table(dt))
                      for lt, dt in zip(ix["lit"], ix["dist"])]
            pick = {0, U - 1}
            pick.update(int(u) for u in rng.choice(
                U, min(spix_units, U), replace=False))
            for u in sorted(pick):
                if ix["kind"][u] != 0:
                    # stored units copy bytes; the level-9 writer makes none
                    res["spix_errors"] += 1
                    continue
                res["spix_units_checked"] += 1
                if not unit_matches(body, raw, ix, u, tables):
                    res["spix_units_wrong"] += 1
    return res


def unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """Plain PNG unfilter of ``(H, 1 + pitch)`` filtered rows, a pixel at a
    time (slow; for tests at small sizes)."""
    H, p1 = filtered.shape
    out = np.zeros((H, p1 - 1), np.int64)
    for y in range(H):
        t = int(filtered[y, 0])
        for x in range(p1 - 1):
            a = out[y, x - bpp] if x >= bpp else 0
            b = out[y - 1, x] if y else 0
            c = out[y - 1, x - bpp] if y and x >= bpp else 0
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) >> 1
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, x] = (int(filtered[y, x + 1]) + pred) & 255
    return out.astype(np.uint8)
