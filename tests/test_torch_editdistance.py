"""The port's C++ edit distance (``p4fr_tpu_torch/native``), on the CPU,
against its plain version and the JAX package.

- The library builds from the repository's source at first use, into
  ``build/p4fr_tpu_torch/`` under a name that hashes the source and flags.
- ``edit_distance`` and ``edit_distance_batch`` equal, exactly, the port's
  NumPy dynamic programme (``utils/metrics.py::edit_distance``) and the JAX
  package's ``p4fr_tpu.native`` on seeded random token sequences (short
  alphabets, so that matches occur; lengths 0 to 40) and on empty ones.
- ``word_error_rate`` equals JAX's on seeded batches of strings from the
  vocabulary with the reference's trailing space, and on an empty batch.
- A build that fails raises with the compiler's output: no fallback.
"""

import os

import numpy as np
import pytest

from p4fr_tpu import native as jax_native
from p4fr_tpu.utils import metrics as jax_metrics
from p4fr_tpu_torch import native
from p4fr_tpu_torch.utils import metrics


def random_pairs(seed, n=200, max_len=40):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        alphabet = int(rng.integers(1, 6))
        a = [f"t{x}" for x in rng.integers(0, alphabet, int(rng.integers(0, max_len + 1)))]
        b = [f"t{x}" for x in rng.integers(0, alphabet, int(rng.integers(0, max_len + 1)))]
        pairs.append((a, b))
    return pairs + [([], []), (["x"], []), ([], ["y", "z"])]


def test_library_builds_from_the_source():
    lib = native.library()
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libp4fr_editdistance_")
    with open(native.SOURCE) as f:
        assert "p4fr_edit_distance_batch" in f.read()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distances_equal_numpy_and_jax(seed):
    pairs = random_pairs(seed)
    plain = [metrics.edit_distance(a, b) for a, b in pairs]
    assert [native.edit_distance(a, b) for a, b in pairs] == plain
    assert native.edit_distance_batch(pairs).tolist() == plain
    assert [jax_native.edit_distance(a, b) for a, b in pairs] == plain
    assert jax_native.edit_distance_batch(pairs).tolist() == plain
    assert native.edit_distance_batch([]).tolist() == []


@pytest.mark.parametrize("seed", [0, 1])
def test_word_error_rate_equals_jax(tokens_path, seed):
    from p4fr_tpu_torch.data.vocab import Vocab

    tokens = list(Vocab.from_files([tokens_path]).token_to_id)
    rng = np.random.default_rng(seed)

    def sentence():
        n = int(rng.integers(0, 30))
        return "".join(f"{tokens[i]} " for i in rng.integers(3, len(tokens), n))

    out = [sentence() for _ in range(64)]
    gt = [sentence() for _ in range(64)]
    gt[:8] = out[:8]
    assert metrics.word_error_rate(out, gt) == jax_metrics.word_error_rate(out, gt)
    plain = float(np.mean([metrics.edit_distance(o.split(" "), g.split(" "))
                           / max(len(o.split(" ")), len(g.split(" ")))
                           for o, g in zip(out, gt)]))
    assert metrics.word_error_rate(out, gt) == plain
    assert metrics.word_error_rate([], []) == jax_metrics.word_error_rate([], []) == 0.0


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="error"):
        native._build(str(tmp_path / "lib.so"))
    assert not (tmp_path / "lib.so").exists()
