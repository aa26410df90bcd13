"""lex_ms (``lex_ms.decode``, ``lex_ms.decode_png``): host ms a batch in
container lexing, the port's ``lex_png`` (general decode, once per file)
and ``parse_indexed`` (indexed decode, once per batch) as
``parallel.batch`` calls them."""

SPANS = {"lex": ["swift_png_tpu_torch.parallel.batch:lex_png",
                 "swift_png_tpu_torch.parallel.batch:parse_indexed"]}


def read(run):
    return run.span_ms_per_batch("lex")
