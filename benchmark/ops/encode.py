"""``BatchCodec(device).encode(pixels, **call)``: batch encode of host
``(B, H, W, 4)`` uint8 arrays to PNG files.  Judged file by file by the
reference: container, CRCs, the zlib stream, every row against the source
under the filter it names, and the ``spIx`` chunk decoded at sampled
units."""

from __future__ import annotations

from harness.corpus import filter_candidates
from harness.reference import check_files

INPUT = "pixels"


def prepare(pixels, files, traffic, device):
    return pixels, {}


def entry(device, traffic):
    from swift_png_tpu_torch import BatchCodec
    codec = BatchCodec(device=device)
    call = traffic.get("call", {})
    return lambda pixels: codec.encode(pixels, **call)


def finish(result) -> None:
    """The files are host bytes: the call has waited for the device."""


def warm(once) -> dict:
    once()
    return {"route": "device optimal parse"}


def out_bytes(result) -> int:
    return sum(len(f) for f in result)


def to_host(result):
    return result


def check(kept, pixels, traffic, rng) -> dict:
    """Sums over the kept calls of :func:`check_files`'s counts (the
    number of units checked is reported, not limited)."""
    B, H, W, _ = pixels.shape
    cands = filter_candidates(pixels.reshape(B, H, 4 * W), 4)
    total: dict = {}
    units = traffic.get("spix_units_per_file", 0)
    for files in kept:
        for k, v in check_files(files, pixels, rng, units, cands).items():
            total[k] = total.get(k, 0) + v
    checked = total.pop("spix_units_checked", None)
    if units and not checked:
        total["spix_errors"] = total.get("spix_errors", 0) + 1
    return total
