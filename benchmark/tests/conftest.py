"""Tests of the benchmark's harness, on the CPU (``python -m pytest
benchmark/tests``).  The test that needs a card is marked ``cuda`` and
decides inside a fixture whether one is there."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402

# a small cell: the tests shrink every configuration and batch to this
SMALL = {"config": {"width": 24, "height": 12}, "traffic": {"batch": 4}}


@pytest.fixture
def spec():
    from harness.spec import Spec
    return Spec(ROOT)


def small(workload: str) -> dict:
    """Overrides that shrink ``workload`` for a CPU run; the general
    decode's profile starts at the third of four calls."""
    ov = {k: dict(v) for k, v in SMALL.items()}
    if workload.endswith("decode_png"):
        ov["traffic"]["profile"] = {"span": "inflate_fused",
                                    "skip_calls": 2}
    return ov
