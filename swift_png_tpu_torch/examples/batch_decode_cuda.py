"""Batched device decode over a mesh (the CUDA path): bucket a mixed
corpus, shard image-data-parallel over a ``torch.distributed`` mesh, and
decode each bucket with the fused inflate and K3 on the card.

Run: ``python -m swift_png_tpu_torch.examples.batch_decode_cuda a.png …``
(NCCL on ``cuda``; in a process that has joined no job, ``global_mesh()``
sets up a one-process group).
"""

import sys

from swift_png_tpu_torch.parallel.corpus import CorpusDecoder
from swift_png_tpu_torch.parallel.distributed import global_mesh, shutdown


def main(paths: list[str], device=None) -> list:
    """Decode ``paths``; return their pixels in order.  ``device``:
    ``cuda`` unless the caller names ``"cpu"``, which runs the mesh on
    gloo and the kernels' plain versions."""
    datas = [open(p, "rb").read() for p in paths]
    mesh = global_mesh(backend="gloo" if device == "cpu" else None)
    results = CorpusDecoder(mesh=mesh, batch_size=8).decode(datas)
    for p, pixels in zip(paths, results):
        print(p, pixels.shape, pixels.dtype)
    return results


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    finally:
        shutdown()
