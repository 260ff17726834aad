"""``--data_parallel`` reads each rank's rows only, on the CPU:

- ``DataLoader(shard=(i, n))`` loads the i-th of n equal slices of every
  batch (padding included) and keeps the whole batch's ``count`` and
  ``file_path``;
- ``run_inference`` and ``run_ensemble`` with ``data_parallel=True`` on a
  world of 2 gloo ranks write the ``output.csv`` of the run without it,
  every rank holds every row's prediction, rank 1 writes nothing, and each
  rank's dataset reads only the images of its slices;
- ``dryrun.spawn`` reports a rank that dies without a result at once.

The module imports only the port at its top: the spawned ranks import it.
"""

import os

import numpy as np
import pytest
import torch

from p4fr_tpu_torch.data.loader import DataLoader
from p4fr_tpu_torch.parallel.dryrun import LITE_TINY, spawn

BATCH, MAX_SEQUENCE, N_IMAGES = 4, 6, 5


class Names:
    """An eval dataset of ``n`` items that records which it was asked for."""

    def __init__(self, n):
        self.data = [{"file_path": f"img_{i}.png"} for i in range(n)]
        self.read = []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        self.read.append(i)
        return {"path": str(i), "file_path": self.data[i]["file_path"],
                "truth": {"text": "", "encoded": [i]},
                "image": np.full((2, 3, 1), i, np.uint8)}


def test_loader_shard_reads_its_slice_and_names_the_batch():
    whole = list(DataLoader(Names(7), BATCH, max_label_len=3))
    parts = []
    for index in range(2):
        dataset = Names(7)
        parts.append(list(DataLoader(dataset, BATCH, max_label_len=3,
                                     shard=(index, 2))))
        # rows 0-3, then 4-6 and one copy of row 6 as padding
        assert dataset.read == [[0, 1, 4, 5], [2, 3, 6, 6]][index]
    for b, want in enumerate(whole):
        got = [p[b] for p in parts]
        np.testing.assert_array_equal(np.concatenate([g["image"] for g in got]),
                                      want["image"])
        for g in got:
            assert g["count"] == want["count"] and g["file_path"] == want["file_path"]
    with pytest.raises(ValueError, match="equal slices"):
        DataLoader(Names(7), BATCH, shard=(0, 3))
    with pytest.raises(ValueError, match="equal slices"):
        DataLoader(Names(7), BATCH, shuffle=True, drop_last=True, shard=(0, 2))


def die(rank, world):
    os._exit(3)  # no result, no traceback: a crash


def test_a_rank_that_dies_is_reported_at_once():
    """``spawn`` reports a rank that exits without a result when it sees
    the exit, not at its timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0\] of 1 exited with code\(s\) \[3\]"):
        spawn(1, die, timeout=300)
    assert time.monotonic() - t0 < 120


def rank_inference(rank, world, pths, inp, out):
    """One gloo rank: the single model, then the ensemble, with
    ``data_parallel`` -> (their rows, the file names its datasets read)."""
    from p4fr_tpu_torch.data.dataset import LoadEvalDataset
    from p4fr_tpu_torch.infer.ensemble import run_ensemble
    from p4fr_tpu_torch.infer.single import run_inference

    read = []
    get = LoadEvalDataset.__getitem__

    def spy(self, i):
        read.append(self.data[i]["file_path"])
        return get(self, i)

    LoadEvalDataset.__getitem__ = spy
    kw = dict(batch_size=BATCH, max_sequence=MAX_SEQUENCE, data_parallel=True,
              device="cpu")
    single = run_inference(pths[0], inp, os.path.join(out, f"single{rank}"), **kw)
    ensemble = run_ensemble(pths, inp, os.path.join(out, f"ensemble{rank}"), **kw)
    return single, ensemble, read


def test_two_gloo_ranks_read_their_rows_and_write_the_plain_output(tmp_path):
    from helpers import make_synth_dataset
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.infer.ensemble import run_ensemble
    from p4fr_tpu_torch.infer.single import run_inference
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    make_synth_dataset(str(tmp_path), n=N_IMAGES, folds=1)
    names = sorted(os.listdir(tmp_path / "images"))
    inp = tmp_path / "input.txt"
    inp.write_text("".join(n + "\t\n" for n in names))
    vocab = Vocab.from_files([TOKENS_PATH])
    pths = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        model = get_network("LiteSATRN", LITE_TINY, vocab)
        pths.append(save_checkpoint(str(tmp_path / f"m{seed}.pth"), model,
                                    network="LiteSATRN", configs=LITE_TINY, vocab=vocab))
    ranks = spawn(2, rank_inference, pths, str(inp), str(tmp_path / "ranks"))
    kw = dict(batch_size=BATCH, max_sequence=MAX_SEQUENCE, device="cpu")
    want = {"single": run_inference(pths[0], str(inp), str(tmp_path / "single"), **kw),
            "ensemble": run_ensemble(pths, str(inp), str(tmp_path / "ensemble"), **kw)}
    for kind, column in (("single", 0), ("ensemble", 1)):
        plain = (tmp_path / kind / "output.csv").read_text()
        assert len(plain.splitlines()) == N_IMAGES
        assert (tmp_path / "ranks" / f"{kind}0" / "output.csv").read_text() == plain
        assert not (tmp_path / "ranks" / f"{kind}1").exists()
        for r in ranks:
            assert r[column] == want[kind]
    # batches [0-3] and [4 + 3 pads]: rank 0 reads rows 0, 1, 4, 4, rank 1
    # rows 2, 3 and the pads, once for the single model, once per member
    for rank, rows in enumerate(([0, 1, 4, 4], [2, 3, 4, 4])):
        assert sorted(ranks[rank][2]) == sorted([names[i] for i in rows] * 3)
