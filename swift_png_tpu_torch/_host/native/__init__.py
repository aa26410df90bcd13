"""The port's native host tier: ctypes bindings over ``libspt_native.so``.

A copy of ``swift_png_tpu/native/`` (the same C++ sources in ``src/``, the
same bindings and the same ABI handshake) that the port builds and loads on
its own, so the two packages never share a library.  The C++ engine serves
the host work that is sequential by nature: the checkpoint-index walk
(``build_index``), one-shot and threaded inflate (the decode host tier of
``CheckpointInflator.run``), one-shot deflate (levels <= 7 and the strict
size policy of the encoder), the encoder's sampled menu statistics, and
checksums.

The library builds at first use with ``g++`` into the package's
``_build/`` directory, or ahead of time with ``python -m
swift_png_tpu_torch._host.native.build``.  :func:`available` is false when
it cannot be built or loaded (:func:`last_error` then says why); callers
read it through this module, so a test can switch the tier off by
monkeypatching it.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libspt_native.so")

_lib = None
_load_failed = False
_last_error = ""
_LOCK = threading.Lock()

_ERRORS = {
    -1: "invalid_block_type", -2: "invalid_parity", -3: "invalid_table",
    -4: "invalid_codelengths", -5: "invalid_distance", -6: "output_overflow",
    -7: "truncated", -8: "invalid_header", -9: "invalid_checksum",
    -10: "invalid_argument",
}

_FORMATS = {"zlib": 0, "ios": 1, "raw": 1, "gzip": 2}


_ABI_VERSION = 6


def _abi_version(lib) -> int:
    try:
        fn = lib.spt_abi_version
    except AttributeError:
        return -1  # pre-handshake build
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return int(fn())


def last_error() -> str:
    """Why the library could not be built or loaded ("" when it loaded or
    was not tried yet)."""
    return _last_error


def _fail(why: str):
    global _load_failed, _last_error
    _load_failed = True
    _last_error = why
    return None


def _load():
    if _lib is not None:
        return _lib
    with _LOCK:
        return _load_locked()


def _load_locked():
    global _lib
    from . import build as _build

    if _lib is not None:
        return _lib
    if _load_failed:  # decide the fallback once, not per call
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            _build.build(verbose=False)
        except (OSError, RuntimeError) as e:
            return _fail(f"build failed: {e}")
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        return _fail(f"load failed: {e}")
    # ABI handshake: a stale cached .so called through a newer argument
    # layout corrupts memory silently — rebuild once on mismatch
    if _abi_version(lib) != _ABI_VERSION:
        try:
            _build.build(verbose=False)
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, RuntimeError) as e:
            return _fail(f"rebuild after an ABI mismatch failed: {e}")
        if _abi_version(lib) != _ABI_VERSION:
            return _fail(f"ABI version {_abi_version(lib)} after a rebuild, "
                         f"want {_ABI_VERSION}")
    lib.spt_crc32.restype = ctypes.c_uint32
    lib.spt_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_uint32]
    lib.spt_adler32.restype = ctypes.c_uint32
    lib.spt_adler32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_uint32]
    lib.spt_inflate.restype = ctypes.c_longlong
    lib.spt_inflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_int]
    lib.spt_deflate.restype = ctypes.c_longlong
    lib.spt_deflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_int, ctypes.c_int]
    lib.spt_deflate_blocks.restype = ctypes.c_longlong
    lib.spt_deflate_blocks.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_void_p, ctypes.c_size_t,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_long]
    lib.spt_deflate_blocks_w.restype = ctypes.c_longlong
    lib.spt_deflate_blocks_w.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_long, ctypes.c_int]
    lib.spt_sample_stats.restype = ctypes.c_longlong
    lib.spt_sample_stats.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.spt_defilter.restype = ctypes.c_int
    lib.spt_defilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int]
    lib.spt_build_index.restype = ctypes.c_longlong
    lib.spt_build_index.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_uint64, ctypes.c_uint32,
                                    ctypes.c_uint32,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.spt_filter_select.restype = ctypes.c_int
    lib.spt_filter_select.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeError(RuntimeError):
    def __init__(self, code: int):
        super().__init__(_ERRORS.get(code, f"native error {code}"))
        self.code = code


def inflate(data: bytes, out_size: int, format: str = "zlib") -> bytes:
    """One-shot native inflate of a complete stream of known output size."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty(out_size, np.uint8)
    n = lib.spt_inflate(data, len(data), out.ctypes.data, out_size,
                        _FORMATS[format])
    if n < 0:
        raise NativeError(n)
    if n != out_size:
        raise NativeError(-6)
    return out.tobytes()


def sample_stats(data: bytes, level: int = 4, top: int = 8):
    """Greedy-parse sample statistics for the device optimal parse.

    Returns ``(top_distances list[int], lit_freq (286,) int64,
    dist_freq (30,) int64)`` — the distance-menu seeds and the ``Depths``
    warm-start frequencies, computed by one native greedy pass (the
    Python-side sampled-stream token walk cost ~30 ms per image).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    tops = np.zeros(top, np.int32)
    lit = np.zeros(286, np.int64)
    dist = np.zeros(30, np.int64)
    k = lib.spt_sample_stats(data, len(data), level, tops.ctypes.data,
                             top, lit.ctypes.data, dist.ctypes.data)
    if k < 0:
        raise NativeError(k)
    return [int(d) for d in tops[:k]], lit, dist


def deflate(data: bytes, level: int = 9, format: str = "zlib",
            block_terms: int = 0, exponent: int = 15) -> bytes:
    """One-shot native deflate.

    ``block_terms`` caps tokens per dynamic block (0 → default 16384);
    larger blocks favor the device decode path (fewer sequential block
    rounds) at a tiny ratio cost from less adaptive trees.  ``exponent``
    (8…15) bounds match distances to ``1 << exponent`` and is declared in
    the zlib header, matching the reference
    (``LZ77.DeflatorBuffers.swift:22-23``).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cap = len(data) + (len(data) >> 2) + 4096
    out = np.empty(cap, np.uint8)
    n = lib.spt_deflate_blocks_w(data, len(data), out.ctypes.data, cap,
                                 level, _FORMATS[format], block_terms,
                                 exponent)
    if n < 0:
        raise NativeError(n)
    return out[:n].tobytes()


def crc32(data: bytes, state: int = 0) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib.spt_crc32(data, len(data), state)


def adler32(data: bytes, state: int = 1) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib.spt_adler32(data, len(data), state)


def defilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """In-place defilter of ``(H, 1+pitch)`` uint8 scanlines; returns the
    ``(H, pitch)`` data view."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rows = np.ascontiguousarray(rows, np.uint8)
    H, pitch1 = rows.shape
    lib.spt_defilter(rows.ctypes.data, H, pitch1 - 1, bpp)
    return rows[:, 1:]


def filter_select(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Filter ``(H, pitch)`` raw scanlines → ``(H, 1+pitch)``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rows = np.ascontiguousarray(rows, np.uint8)
    H, pitch = rows.shape
    out = np.empty((H, pitch + 1), np.uint8)
    lib.spt_filter_select(rows.ctypes.data, H, pitch, bpp, out.ctypes.data)
    return out


def inflate_batch(datas: list[bytes], out_sizes, format: str = "zlib",
                  threads: int = 0) -> list[bytes]:
    """Decode independent streams on parallel native threads."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not hasattr(lib, "_batch_ready"):
        lib.spt_inflate_batch.restype = ctypes.c_int
        lib.spt_inflate_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib._batch_ready = True
    count = len(datas)
    if isinstance(out_sizes, int):
        out_sizes = [out_sizes] * count
    outs = [np.empty(sz, np.uint8) for sz in out_sizes]
    srcs = (ctypes.c_char_p * count)(*datas)
    srclens = (ctypes.c_size_t * count)(*[len(d) for d in datas])
    dsts = (ctypes.c_void_p * count)(*[o.ctypes.data for o in outs])
    caps = (ctypes.c_size_t * count)(*out_sizes)
    results = (ctypes.c_longlong * count)()
    lib.spt_inflate_batch(srcs, srclens, dsts, caps, results, count,
                          _FORMATS[format], threads)
    decoded = []
    for i in range(count):
        if results[i] < 0:
            raise NativeError(results[i])
        if results[i] != out_sizes[i]:
            raise NativeError(-6)
        decoded.append(outs[i].tobytes())
    return decoded


def defilter_batch(rows: np.ndarray, bpp: int, threads: int = 0) -> np.ndarray:
    """In-place parallel defilter of ``(B, H, 1+pitch)`` uint8 batches."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not hasattr(lib, "_dfb_ready"):
        lib.spt_defilter_batch.restype = ctypes.c_int
        lib.spt_defilter_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib._dfb_ready = True
    rows = np.ascontiguousarray(rows, np.uint8)
    B, H, pitch1 = rows.shape
    lib.spt_defilter_batch(rows.ctypes.data, B, H, pitch1 - 1, bpp, threads)
    return rows[:, :, 1:]


MAX_INDEX_BLOCKS = 4096


def build_index(body: bytes, out_size: int, ob: int = 256):
    """Native checkpoint-index walk (``lz77/index.py`` fast path, v4).

    Returns ``(bit_pos, skip, n_tokens, unit_block, unit_kind, eob_jump,
    gap_off, gap_len, pair_steps, lit_lengths (NB, 288), dist_lengths
    (NB, 32), end_bit, match_bytes, match_segs)`` or ``None`` when the
    stream is
    outside the fast path (token/stored-mixed units, >1 boundary per
    unit, > ``MAX_INDEX_BLOCKS`` blocks, record-range overflow); raises
    :class:`NativeError` on malformed streams.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    U = (out_size + ob - 1) // ob
    if U == 0:
        return None
    bit_pos = np.zeros(U, np.uint64)
    skip = np.zeros(U, np.uint32)
    n_tokens = np.zeros(U, np.uint32)
    unit_block = np.zeros(U, np.uint32)
    unit_kind = np.zeros(U, np.uint8)
    eob_jump = np.zeros(U, np.uint32)
    gap_off = np.zeros(U, np.uint32)
    gap_len = np.zeros(U, np.uint32)
    pair_steps = np.zeros(U, np.uint32)
    lit = np.zeros((MAX_INDEX_BLOCKS, 288), np.uint8)
    dist = np.zeros((MAX_INDEX_BLOCKS, 32), np.uint8)
    info = np.zeros(4, np.uint64)
    r = lib.spt_build_index(body, len(body), out_size, ob,
                            MAX_INDEX_BLOCKS,
                            bit_pos.ctypes.data, skip.ctypes.data,
                            n_tokens.ctypes.data, unit_block.ctypes.data,
                            unit_kind.ctypes.data, eob_jump.ctypes.data,
                            gap_off.ctypes.data, gap_len.ctypes.data,
                            pair_steps.ctypes.data,
                            lit.ctypes.data,
                            dist.ctypes.data, info.ctypes.data)
    if r < 0:
        raise NativeError(int(r))
    if r == 0:
        return None
    if r == 2:
        # multi-gap stored chain: outside the native walker's v4 record
        # shape but INSIDE the v5 host walker's — caller retries there
        return "host-retry"
    nb = max(int(info[3]), 1)
    return (bit_pos, skip, n_tokens, unit_block.astype(np.int32),
            unit_kind, eob_jump, gap_off.astype(np.uint16),
            gap_len.astype(np.uint16), pair_steps,
            lit[:nb].copy(), dist[:nb].copy(),
            int(info[0]), int(info[1]), int(info[2]))
