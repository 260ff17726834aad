"""encode_issue_ms: host time inside the program's ``encode`` span (the
body of ``infer.single.encode_images``: issuing kernel 1 and the
encoder); mean per batch over the window's batches before the profiler
starts. Read beside ``encode_ms``, the encode's device time: near it, the
encoder is bound by its host issue."""

from benchmark import program_spans


def read(r):
    recs = program_spans.window(r)
    return None if recs is None else 1e3 * program_spans.mean(recs, "encode")
