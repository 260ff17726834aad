"""stop_sync_ms: host time blocked in the early-stop loop's sync (the
program's ``decode.stop_check`` span, ``bool(done.all())`` each step);
mean per batch over the window's batches before the profiler starts."""

from benchmark import program_spans


def read(r):
    recs = program_spans.window(r)
    return None if recs is None else 1e3 * program_spans.mean(recs, "decode.stop_check")
