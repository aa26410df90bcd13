"""The check that decides ``correct``: sound runs pass it, and the control
and each fault a cell can have fail it.  Every run here drives the whole
harness on the CPU at a small size (the port's plain PyTorch versions),
with the card's look skipped."""

import numpy as np
import pytest

from conftest import small
from control import control_checks
from harness import reference
from harness.cell import run_cell

DECODE = ["photo512_rgba8.decode_png", "photo512_rgba8.decode_indexed"]
ENCODE = ["photo512_rgba8.encode_l9"]
SEED = 2**31 + 101


def run(spec, workload, traced=False, seed=SEED):
    return run_cell(spec, workload, seed, 0.2, traced, device="cpu",
                    overrides=small(workload), log=lambda **kw: None)


@pytest.mark.parametrize("workload", DECODE + ENCODE)
def test_sound_run_is_correct(spec, workload):
    r = run(spec, workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", DECODE + ENCODE)
@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**33 + 1])
def test_control_is_not_correct(spec, workload, seed):
    checks = control_checks(spec, workload, seed, small(workload))
    assert any(v > 0 for v in checks.values())


def broken(kind):
    """A device stage's output broken as ``kind`` says."""
    def fault(out):
        out = out.clone()
        b = out.shape[0]
        if kind == "altered":
            out.view(-1)[5] ^= 1
        elif kind == "half":
            out[b // 2:] = out[:b - b // 2]
        elif kind == "unchanged":
            out.zero_()
        return out
    return fault


FAULTS = ["altered", "half", "unchanged"]


@pytest.mark.parametrize("workload", DECODE)
@pytest.mark.parametrize("kind", FAULTS)
def test_decode_fault_is_not_correct(spec, monkeypatch, workload, kind):
    from swift_png_tpu_torch.parallel import batch
    orig, fault = batch.decode_stage, broken(kind)
    monkeypatch.setattr(batch, "decode_stage",
                        lambda *a, **k: fault(orig(*a, **k)))
    r = run(spec, workload)
    assert not r["correct"]
    assert r["checks"]["pixel_bytes_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", ENCODE)
@pytest.mark.parametrize("kind", FAULTS)
def test_encode_fault_is_not_correct(spec, monkeypatch, workload, kind):
    from swift_png_tpu_torch.parallel import batch
    orig, fault = batch.filter_batch, broken(kind)
    monkeypatch.setattr(batch, "filter_batch",
                        lambda *a, **k: fault(orig(*a, **k)))
    r = run(spec, workload)
    assert not r["correct"]
    assert r["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("shift", [1, 8, -3])
def test_encode_index_fault_is_not_correct(spec, monkeypatch, shift):
    from swift_png_tpu_torch.parallel import batch
    orig = batch.build_index

    def moved(*a, **k):
        ix = orig(*a, **k)
        ix.bit_pos = ix.bit_pos + np.uint64(shift) if shift > 0 else \
            ix.bit_pos - np.uint64(-shift)
        return ix
    monkeypatch.setattr(batch, "build_index", moved)
    r = run(spec, ENCODE[0])
    assert not r["correct"]
    assert (r["checks"]["spix_units_wrong"]["value"]
            + r["checks"]["spix_errors"]["value"]) > 0


def test_failed_calls_are_not_correct(spec, monkeypatch):
    """Calls of the window that raise (the warm call went through)."""
    from swift_png_tpu_torch.parallel import batch
    orig, calls = batch.decode_stage, []

    def boom(*a, **k):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return orig(*a, **k)
    monkeypatch.setattr(batch, "decode_stage", boom)
    r = run(spec, DECODE[1])
    assert not r["correct"] and r["failed"] == r["attempted"] > 0


def test_unit_check_reads_a_real_stream():
    """The reference's checkpoint decoder against an index of a zlib
    stream made here, and against the same index moved by one bit."""
    from swift_png_tpu_torch.lz77.index import build_index
    rng = np.random.default_rng(4)
    raw = bytes(rng.integers(0, 8, 5000, dtype=np.uint8)) * 3
    stream = __import__("zlib").compress(raw, 9)
    ix = reference.parse_spix(build_index(stream[2:-4], len(raw),
                                          256).serialize())
    tables = [(reference.code_table(a), reference.code_table(b))
              for a, b in zip(ix["lit"], ix["dist"])]
    body = stream[2:-4]
    assert all(reference.unit_matches(body, raw, ix, u, tables)
               for u in range(ix["units"]))
    ix["bit_pos"] = ix["bit_pos"] + 1
    assert not any(reference.unit_matches(body, raw, ix, u, tables)
                   for u in range(1, ix["units"]))
