"""entry_self_ms (``.decode``, ``.decode_png``, ``.encode``): host ms a
window call spent in the entry's root span and in none of its children:
the entry's own host work that no stage span covers."""

from harness.program_spans import root_self_ms


def read(run):
    return root_self_ms(run)
