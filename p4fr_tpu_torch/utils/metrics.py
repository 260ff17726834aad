"""Host-side evaluation metrics, port of ``p4fr_tpu/utils/metrics.py``.

- ``word_error_rate``: batch mean of the token edit distance over
  max(len), on ``split(" ")`` token lists. The strings from
  ``data.vocab.id_to_string`` carry the reference's trailing space, so a
  non-empty sequence gains a trailing empty token that adds one to the
  denominator, as in the reference.
- ``sentence_acc``: exact string match rate.
- ``symbol_accuracy``: (correct, total) symbol counts against the
  non-padded targets.
- ``final_metric``: 0.9 * sentence_acc + 0.1 * (1 - WER), the competition
  score the trainers gate their best checkpoint on.

``word_error_rate`` scores through the C++ edit distance
(``p4fr_tpu_torch/native``, the JAX package's helper, built at first use);
``edit_distance`` here is its plain version, the JAX package's NumPy
dynamic programme, which the tests hold the library against.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from p4fr_tpu_torch.native import edit_distance_batch, intern_ids


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences, a row at a time:
    deletion and substitution elementwise, the insertion chain
    row[j] = min(row[j-1] + 1, tmp[j]) in closed form as
    j + min(i, min_{k<=j}(tmp[k] - k))."""
    a, b = intern_ids(a, b)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return n + m
    ar = np.arange(m + 1, dtype=np.int64)
    prev = ar.copy()
    for i in range(1, n + 1):
        tmp = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        c = np.minimum.accumulate(np.concatenate(([np.int64(i)], tmp - ar[1:])))
        prev = c + ar
    return int(prev[m])


def final_metric(sentence_acc: float, word_error_rate: float) -> float:
    return 0.9 * sentence_acc + 0.1 * (1 - word_error_rate)


def word_error_rate(predicted_outputs: Sequence[str],
                    ground_truths: Sequence[str]) -> float:
    """Mean normalized token edit distance over the batch."""
    pairs, lengths = [], []
    for output, truth in zip(predicted_outputs, ground_truths):
        out_tokens, gt_tokens = output.split(" "), truth.split(" ")
        pairs.append((out_tokens, gt_tokens))
        lengths.append(max(len(out_tokens), len(gt_tokens)))
    if not pairs:
        return 0.0
    distances = edit_distance_batch(pairs)
    return float(np.mean(distances / np.asarray(lengths, dtype=np.float64)))


def sentence_acc(predicted_outputs: Sequence[str],
                 ground_truths: Sequence[str]) -> float:
    """Exact-match rate over the batch."""
    if len(predicted_outputs) == 0:
        return 0.0
    correct = sum(1 for o, g in zip(predicted_outputs, ground_truths) if o == g)
    return correct / len(predicted_outputs)


def symbol_accuracy(sequences: np.ndarray, expected: np.ndarray,
                    pad_value: int = -1) -> tuple:
    """(correct, total): elementwise equality against ``expected``, whose
    padded slots hold ``pad_value``, over its non-padded count."""
    correct = int(np.sum(sequences == expected))
    total = int(np.sum(expected != pad_value))
    return correct, total
