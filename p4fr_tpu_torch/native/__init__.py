"""The C++ edit distance (``editdistance.cpp``, the JAX package's
``p4fr_tpu/native/``), loaded with ``ctypes``.

The library is built at first use in a process with ``g++ -O3 -std=c++17
-shared -fPIC`` into ``build/p4fr_tpu_torch/`` at the repository root,
named by a hash of the source, and never at import time. There is no
fallback: a failed build raises with the compiler's output. The NumPy
dynamic programme in ``utils/metrics.py`` is the plain version the tests
hold it against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Sequence

import numpy as np

from p4fr_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "editdistance.cpp")
CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]

_lib = None
_lock = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)


def _build(so: str) -> None:
    """Compile the library to ``so`` (through a file of this process's own,
    renamed into place, so that processes building at once do not clash)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXXFLAGS, "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"the edit distance needs g++ to build {SOURCE}") from exc
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The loaded library, built first where it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            with open(SOURCE, "rb") as f:
                digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode()).hexdigest()
            so = os.path.join(BUILD_DIR, f"libp4fr_editdistance_{digest[:16]}.so")
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.p4fr_edit_distance.restype = ctypes.c_int64
            lib.p4fr_edit_distance.argtypes = [_I64P, ctypes.c_int64, _I64P, ctypes.c_int64]
            lib.p4fr_edit_distance_batch.restype = None
            lib.p4fr_edit_distance_batch.argtypes = [_I64P, _I64P, _I64P, _I64P,
                                                     ctypes.c_int64, _I64P]
            _lib = lib
    return _lib


def intern_ids(*seqs: Sequence) -> List[np.ndarray]:
    """Tokens -> contiguous int64 ids shared by the sequences."""
    table = {}
    return [np.array([table.setdefault(tok, len(table)) for tok in seq], dtype=np.int64)
            for seq in seqs]


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    ids_a, ids_b = intern_ids(a, b)
    return int(library().p4fr_edit_distance(_ptr(ids_a), len(ids_a), _ptr(ids_b),
                                            len(ids_b)))


def edit_distance_batch(pairs: Sequence) -> np.ndarray:
    """Distances of a batch of (seq_a, seq_b) pairs, int64 [len(pairs)], in
    one call."""
    lib = library()
    out = np.zeros(len(pairs), dtype=np.int64)
    if not pairs:
        return out
    ids = [intern_ids(a, b) for a, b in pairs]
    a_flat = np.concatenate([ia for ia, _ in ids])
    b_flat = np.concatenate([ib for _, ib in ids])
    a_lens = np.array([len(ia) for ia, _ in ids], dtype=np.int64)
    b_lens = np.array([len(ib) for _, ib in ids], dtype=np.int64)
    lib.p4fr_edit_distance_batch(_ptr(a_flat), _ptr(a_lens), _ptr(b_flat), _ptr(b_lens),
                                 len(pairs), _ptr(out))
    return out
