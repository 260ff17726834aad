"""Tiny configurations and cells for the CPU tests: the two networks at a
few channels and a 32x64 or 32x32 input, and a cell spec around them."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

STAGES = [[1, 3, 1, 1, 24, 24, False, True], [1, 3, 2, 4, 24, 32, False, True],
          [2, 3, 2, 4, 32, 48, True, False]]
EFFSATRN = {
    "network": "EfficientSATRN", "dtype": "float32", "input_size": {"height": 32, "width": 64},
    "SATRN": {"encoder": {"hidden_dim": 32, "filter_dim": 32, "layer_num": 1, "head_num": 4,
                          "backbone_stages": STAGES},
              "decoder": {"src_dim": 32, "hidden_dim": 32, "filter_dim": 64, "layer_num": 2,
                          "head_num": 1}},
    "data": {"rgb": 3}, "dropout_rate": 0.0, "tpu": {"reference_parity": True},
}
SWINTRN = {
    "network": "SWIN", "dtype": "float32", "input_size": {"height": 32, "width": 32},
    "SATRN": {"encoder": {"hidden_dim": 64, "filter_dim": 64, "layer_num": 1, "head_num": 4},
              "decoder": {"src_dim": 32, "hidden_dim": 64, "filter_dim": 64, "layer_num": 2,
                          "head_num": 2}},
    "SWIN": {"embed_dim": 16, "depths": [2, 2], "num_heads": [2, 4], "window": 4},
    "data": {"rgb": 3}, "dropout_rate": 0.0, "tpu": {"reference_parity": True},
}
STEPS = 24


def traffic(name: str) -> dict:
    """A committed traffic mix cut to ``STEPS`` steps."""
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    t["max_steps"] = STEPS
    if "clip" in t:
        t.update(clip=[3, STEPS], median=6)
    return t


def spec(config=EFFSATRN, traffic_name="lenlog35", batch=8, pool=16, limits=None):
    from benchmark import harness

    with open(os.path.join(BENCH, "workloads", "effsatrn.fused.lenlog35.b256.json")) as f:
        committed = json.load(f)
    work = dict(committed, batch=batch, pool=pool,
                check={"batches": 2, "rows": 4}, limits=limits or committed["limits"])
    units = {"images_per_s": "images/s", "latency_p95_ms": "ms", "setup_s": "s"}
    return harness.Spec("tiny", work, copy.deepcopy(config), traffic(traffic_name),
                        list(units), [], units)
