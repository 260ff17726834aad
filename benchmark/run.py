"""Run one cell of the benchmark of ``p4fr_tpu_torch`` once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is the result as one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown``
(``--trace 1``) and, last, ``checks``: each number compared for
``correct`` with its limit, which also end standard error. Exits non-zero
without a result when no card (or too few) is visible, or when the JAX
side (``jax``, ``jaxlib``, ``flax``, ``optax``, ``p4fr_tpu``) has been
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    started = harness.process_start()
    import torch

    spec = harness.load_spec(args.workload)
    chips = next(w["chips"] for w in harness.load_json(ROOT, "BENCHMARK.json")["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", started)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the JAX side was loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    line = {
        "correct": result["correct"],
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in result["metrics"].items()},
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   **result["device"]},
    }
    if result["breakdown"] is not None:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": finite(v), "limit": lim}
                      for k, (v, lim) in result["checks"].items()}
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
