"""``BatchCodec(device).decode(files, **call)``: batch decode of ordinary
PNGs (any writer, no ``spIx`` chunk) through the general inflate.  Judged
pixel by pixel against the source images."""

from __future__ import annotations

# to_host is this entry's own hook, as the harness calls it
from harness.common import decoded_check, png_facts, synchronize, to_host

INPUT = "files"


def prepare(pixels, files, traffic, device):
    """The files as the configuration's writer made them."""
    return files, png_facts(files)


def entry(device, traffic):
    from swift_png_tpu_torch import BatchCodec
    codec = BatchCodec(device=device)
    call = traffic.get("call", {})
    return lambda files: codec.decode(files, **call)


def finish(result) -> None:
    synchronize(result)


def warm(once) -> dict:
    """One call; the host ms of its first and its median later
    ``InflateFused.inflate`` call, and the fused inflate's blocks and
    retries on the batch's last stream."""
    import statistics
    import time

    from swift_png_tpu_torch.ops.inflate_fused import InflateFused
    from swift_png_tpu_torch.parallel import batch
    orig, ms = InflateFused.inflate, []

    def timed(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return orig(self, *args, **kwargs)
        finally:
            ms.append(1e3 * (time.perf_counter() - t))
    InflateFused.inflate = timed
    try:
        once()
    finally:
        InflateFused.inflate = orig
    eng = next(iter(batch._FUSED.values()), None)
    return {"route": "fused inflate",
            "warm_inflate_ms": {"first": ms[0],
                                "median_later": statistics.median(ms[1:])}
            if len(ms) > 1 else None,
            "last_stream": dict(eng.last_run) if eng else None}


def out_bytes(result) -> int:
    return 0


def check(kept, pixels, traffic, rng) -> dict:
    return decoded_check(kept, pixels)
