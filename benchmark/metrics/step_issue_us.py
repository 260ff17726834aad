"""step_issue_us: host time per decode step spent issuing it: the
program's ``decode`` span less its ``decode.stop_check`` (the early-stop
host sync), over the decode steps run; over the window's batches before
the profiler starts. Under early stop, the card waits this long after
each sync."""

from benchmark import program_spans


def read(r):
    recs = program_spans.window(r)
    steps = sum(rec.counts["steps"] for rec in recs) if recs else 0
    if not steps:
        return None
    issue = sum(rec.spans.get("decode", 0.0) - rec.spans.get("decode.stop_check", 0.0)
                for rec in recs)
    return 1e6 * issue / steps
