"""stop_syncs: the early-stop host syncs the program counted
(``stop_checks``: one per decode step run under early stop); mean per
batch over the window's batches before the profiler starts."""

from benchmark import program_spans


def read(r):
    recs = program_spans.window(r)
    return None if recs is None else sum(rec.counts["stop_checks"] for rec in recs) / len(recs)
