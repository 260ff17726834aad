"""The program's own records of the window's batches, for the per-layer
metrics that read its spans and counters (``p4fr_tpu_torch/utils/
tracing.py``: one record per call of ``infer.single.decode_images``).

``window(r)`` takes the records made while no profiler recorded, in call
order, and keeps the last ``len(r.spans)``: the batches before the
profiled sub-window that ``encode_ms`` and ``decode_step_ms`` read. It
gives None where the program keeps no records (a program without
``utils/tracing.py``) or where the records' decode steps differ from the
kernel-6 launches the harness counted for those batches.
"""


def window(r):
    try:
        from p4fr_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not r.spans:
        return None
    recs = [rec for rec in tracing.records() if not rec.profiled][-len(r.spans):]
    if len(recs) != len(r.spans) or any(
            rec.counts["steps"] != s["steps"] for rec, s in zip(recs, r.spans)):
        return None
    return recs


def mean(recs, span: str) -> float:
    """Host seconds in ``span``, mean per record."""
    return sum(rec.spans.get(span, 0.0) for rec in recs) / len(recs)
