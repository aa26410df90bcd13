"""host_syncs_per_image (``.decode``, ``.decode_png``, ``.encode``): times
the host blocked on the card (fetches, comparisons and scalar reads of
device tensors, blocking uploads; the port's ``syncs`` counter) in the
window's calls, over the images those calls took (the root spans'
``images``)."""

from harness.program_spans import calls, counter


def read(run):
    per = calls(run)
    if not per:
        return None
    images = counter(per, "images")
    return counter(per, "syncs") / images if images else None
