"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library lands in ``build/p4fr_tpu_torch/`` at the repository
root, named by a hash of the sources, and is built on first use in a
process, never at import time.

Each kernel's C entry point returns ``cudaGetLastError()``; ``check``
raises on a non-zero code. ``LAUNCHES`` counts, per kernel wrapper, the
times it launched its kernel on the card (a CPU tensor takes the plain
twin and counts nothing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "p4fr_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

LAUNCHES = {"standardize": 0, "mbconv": 0, "decoder_layer": 0, "beam_gather": 0,
            "fused_greedy_step": 0, "swin_attention": 0}

_lib = None
_lock = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures: name -> argtypes (restype is int = cudaError_t)
_SIGNATURES = {
    # (in u8, out, scale_shift f32[2C], n_bytes, channels, out_bf16, stream)
    "p4fr_standardize": [P, P, P, ctypes.c_longlong, I, I, P],
    # (x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b, h2 f32, partial f32,
    #  B, H, W, Cin, Cmid, bf16, stream)
    "p4fr_mbconv_expand_dw": [P] * 9 + [I] * 6 + [P],
    # (H, W) -> spatial tiles per image of expand_dw (not a CUDA error code)
    "p4fr_mbconv_tiles": [I, I],
    # (partial, se_rw, se_rb, se_ew, se_eb, gate f32, B, tiles, S, Cmid,
    #  rd, bf16, stream)
    "p4fr_mbconv_se": [P] * 6 + [I] * 6 + [P],
    # (h2, gate|null, pwl_w, pwl_s, pwl_b, x|null, out, B, S, Cmid, Cout,
    #  bf16, stream)
    "p4fr_mbconv_project": [P] * 7 + [I] * 5 + [P],
    # (x, cache, src_kv, out, 18 weight pointers, B, H, heads, F, S, L,
    #  pos, cache_outputs, bf16, stream)
    "p4fr_decoder_layer": [P] * 22 + [I] * 9 + [P],
    # (cache, parent i64, rows, group, row_vecs, prefix_vecs, stream)
    "p4fr_beam_gather": [P, P, ctypes.c_longlong, I, ctypes.c_longlong,
                         ctypes.c_longlong, P],
    # (token i32, caches, cross, mstate i32, the 20 FusedDecodeParams
    #  tensors, tok_out, mstate_out, logits f32, B, H, heads, F, S, L, NL,
    #  Vp, pos, cache_outputs, use_manager, sos, eos, lbrace, rbrace,
    #  vocab, bf16, stream)
    "p4fr_fused_greedy_step": [P] * 27 + [I] * 17 + [P],
    # (qkv, bias f32, mask f32|null, out, N, n, C, heads, nW, scale, bf16,
    #  stream)
    "p4fr_window_attention": [P] * 4 + [I] * 5 + [F, I, P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _compile(srcs, so: str) -> None:
    """One nvcc per ``.cu``, all at once, then one link into ``so``."""
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}"
    objs, procs = [], []
    try:
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = f"{tmp}.{os.path.basename(src)}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                              f"{err[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so",
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(f"{tmp}.so", so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def library() -> ctypes.CDLL:
    """The loaded kernel library; compiles it on the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = hashlib.sha256()
        for path in srcs:
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode() + f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libp4fr_kernels_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            _compile(srcs, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
