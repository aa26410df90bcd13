"""sync_wait_pct (``.decode``, ``.decode_png``, ``.encode``): the share of
the window calls' root spans that the host spent blocked on the card (the
port's ``sync`` spans), in %."""

from harness.program_spans import calls, roots


def read(run):
    per = calls(run)
    if not per or not roots(per):
        return None
    total = sum(r.duration_ns for r in roots(per))
    waited = sum(s.duration_ns for c in per for s in c if s.name == "sync")
    return 100.0 * waited / total if total else None
