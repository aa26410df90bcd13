"""The benchmark of the PyTorch and CUDA port, ``swift_png_tpu_torch``.

One run drives one cell (a configuration under a traffic mix, both named in
``BENCHMARK.json``) for a fixed window and prints one JSON line.  What
belongs to one configuration, traffic mix, entry or metric sits in a file of
its own under ``benchmark/`` and is found by name:

* ``configs/<config>.json``: the image corpus (shape, content recipe,
  writer settings);
* ``content/<recipe>.py``: a content recipe, ``image(seed, index, height,
  width)``;
* ``traffic/<traffic>.json``: the mix (entry, batch, call arguments, what
  the traced run profiles, how many batches the check reads);
* ``ops/<op>.py``: an entry of the port and how its answers are judged;
* ``metrics/<metric>.py``: a reader, ``read(run)``, and the spans it needs.

Nothing here imports ``jax``, ``jaxlib`` or ``swift_png_tpu``;
``reference.py`` imports nothing of ``swift_png_tpu_torch`` either.
"""
