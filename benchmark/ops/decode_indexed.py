"""``decode_indexed(files, device=device)``: batch decode of PNGs that carry
an ``spIx`` checkpoint chunk, through the checkpoint-parallel inflate.  The
chunk is added in set-up (not timed) by the port's ``build_index`` over each
file's zlib stream, at the traffic's ``spix_ob``, and written before IEND as
the port's writer places it.  Judged pixel by pixel against the source
images."""

from __future__ import annotations

# to_host is this entry's own hook, as the harness calls it
from harness.common import decoded_check, png_facts, synchronize, to_host
from harness.corpus import png_chunk
from harness.reference import chunks

INPUT = "files"


def with_index(data: bytes, ob: int) -> bytes:
    from swift_png_tpu_torch.lz77.index import build_index
    parts = chunks(data)
    stream = b"".join(p for k, p in parts if k == b"IDAT")
    hdr = parts[0][1]
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    raw_size = h * (1 + 4 * w)
    ix = build_index(stream[2:-4], raw_size, ob)
    if ix is None:
        raise ValueError("stream outside the indexed path")
    return data[:-12] + png_chunk(b"spIx", ix.serialize()) + data[-12:]


def prepare(pixels, files, traffic, device):
    ob = traffic["spix_ob"]
    files = [with_index(f, ob) for f in files]
    return files, png_facts(files)


def entry(device, traffic):
    from swift_png_tpu_torch import decode_indexed

    def call(files):
        out = decode_indexed(files, device=device)
        if out is None:
            raise ValueError("decode_indexed refused the batch")
        return out
    return call


def finish(result) -> None:
    synchronize(result)


def warm(once) -> dict:
    """One call, with the tier and tail mode that ``CheckpointInflator.run``
    took (``last_plan``)."""
    from swift_png_tpu_torch.ops.inflate_checkpoint import CheckpointInflator
    seen = []
    orig = CheckpointInflator.run

    def run(self, *args, **kwargs):
        seen.append(self)
        return orig(self, *args, **kwargs)
    CheckpointInflator.run = run
    try:
        once()
    finally:
        CheckpointInflator.run = orig
    plan = seen[0].last_plan if seen else None
    return {"route": "checkpoint inflate", "plan": plan}


def out_bytes(result) -> int:
    return 0


def check(kept, pixels, traffic, rng) -> dict:
    return decoded_check(kept, pixels)
