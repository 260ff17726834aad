"""Per-layer metric readers, one module per metric, found by its name in
``BENCHMARK.json`` up to the first dot (``feed_ms.early_stop`` is read by
``feed_ms.py``). Each defines ``read(readings)`` (a
``harness.Readings``) and returns the metric's value, or None where the
run gave it nothing to read."""
