"""Read the numbers that ``correct`` compares, over many seeds in one
process: the program's, the fp8 control's and, with ``--faults``, the
program's with each planted fault (``faults.py``).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... [--faults]

For each seed it builds the cell's program with that seed's weights and
traffic, serves the first cycle of the pool through the timed path (no
window: the check compares only batches of that cycle), and prints one
JSON line of readings. The limits in ``workloads/<cell>.json`` are set
from these lines. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(spec, seed: int, device: str, control: bool) -> dict:
    """One seed's numbers, as ``harness.run`` judges them, over the first
    cycle of the pool."""
    import torch

    from benchmark import harness

    cell = harness.setup(spec, seed, device)
    program, traffic = cell.program, cell.traffic
    served, pool_batches = [], []
    with harness.Catcher(program.single, set(cell.sample), False) as catcher:
        for i in range(max(cell.sample) + 1):
            catcher.index = i
            b = traffic.batch(i)
            x = torch.from_numpy(traffic.images[traffic.image_set(i)]).to(program.device)
            served.append(program.serve(x, cell.stops[b], traffic.max_steps).cpu().numpy())
            pool_batches.append(b)
        kept = harness.kept_rows(catcher, cell.sample)
    cell.program = program = catcher = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return harness.judge(spec, cell, kept, served, pool_batches, device, control)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--faults", action="store_true")
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "fault": None,
                **readings(spec, seed, "cuda", control=True)}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if args.faults:
            for name, fault in faults.FAULTS.items():
                with fault():
                    line = {"workload": args.workload, "seed": seed, "fault": name,
                            **readings(spec, seed, "cuda", control=False)}
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
