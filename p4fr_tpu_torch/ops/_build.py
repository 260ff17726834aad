"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library lands in ``build/p4fr_tpu_torch/`` at the repository
root, named by a hash of the sources, and is built on first use in a
process, never at import time. Each object is kept under ``obj/`` beside
it, named by a hash of its ``.cu``, the ``csrc/`` headers it includes and
the flags, so a build recompiles only the sources an edit reaches (and a
copy of the tree given those objects, as ``tolerance_study.py`` gives its
planted copies, only the sources its edit reaches).

Each kernel's C entry point returns ``cudaGetLastError()``; ``check``
raises on a non-zero code. ``LAUNCHES`` counts, per kernel wrapper, the
times it launched its kernel on the card (a CPU tensor takes the plain
twin and counts nothing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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

LAUNCHES = {"standardize": 0, "mbconv": 0, "mbconv_band": 0, "mbconv_tiled": 0,
            "decoder_layer": 0,
            "beam_gather": 0,
            "fused_greedy_step": 0, "swin_attention": 0, "decoder_layer_v1": 0,
            "decoder_stack_v3": 0, "decoder_layer_int8": 0,
            "decoder_layer_int8_cache": 0}

_lib = None
_lock = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures: name -> argtypes (restype is int = cudaError_t)
_SIGNATURES = {
    # (in u8, out, scale_shift f32[2C], n_bytes, channels, out_bf16, stream)
    "p4fr_standardize": [P, P, P, ctypes.c_longlong, I, I, P],
    # kernel 2, launch A: (x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b, se_rw|null,
    #  se_rb, se_ew, se_eb, g2, B, H, W, Cin, Cmid, rd, C, width, warp rows,
    #  clusters, bf16, trace, stream)
    "p4fr_mbconv_expand_gate": [P] * 12 + [I] * 12 + [P],
    # launch B: (g2, pwl_w, pwl_s, pwl_b, x|null, out, M, Cmid, Cout, bf16,
    #  trace, stream)
    "p4fr_mbconv_project_cluster": [P] * 6 + [I] * 5 + [P],
    # (H, W, Cin, width, C, rd, warp rows, bf16) -> launch A's shared
    # memory bytes (not a CUDA error code)
    "p4fr_mbconv_cluster_smem": [I] * 8,
    # (H, W, Cin, width, C, rd, warp rows, bf16, clusters i32 out, regs i32
    #  out, local bytes i32 out): launch A's resident clusters of C
    "p4fr_mbconv_cluster_query": [I] * 8 + [P] * 3,
    # launch A's band form: (x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b,
    #  se_rw|null, se_rb, se_ew, se_eb, g2, scratch f32, B, H, W, Cin, Cmid,
    #  rd, C, width, warp rows, m-tiles, bands, clusters, bf16, trace, stream)
    "p4fr_mbconv_band_expand_gate": [P] * 13 + [I] * 14 + [P],
    # (H, W, Cin, width, C, rd, warp rows, m-tiles, bands, bf16) -> the band
    # form's shared memory bytes (0: it does not fit; not a CUDA error code)
    "p4fr_mbconv_band_smem": [I] * 10,
    # (H, W, Cin, width, C, rd, warp rows, m-tiles, bands, bf16, clusters
    #  i32 out, regs i32 out, local bytes i32 out): the band form's resident
    #  clusters of C
    "p4fr_mbconv_band_query": [I] * 10 + [P] * 3,
    # (host u64 [16, 8] out): the traced launches' phase timeline
    "p4fr_mbconv_trace": [P],
    # the tiled form (csrc/mbconv_tiled.cu): (x, pw_w, pw_s, pw_b, dw_w,
    #  dw_s, dw_b, h2 f32, partial f32, B, H, W, Cin, Cmid, bf16, stream)
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
    #  pos, cache_outputs, cluster, bf16, stream)
    "p4fr_decoder_layer": [P] * 22 + [I] * 10 + [P],
    # (x, cache, src_kv i8, src_scale f32, out, 18 weight pointers, B, H,
    #  heads, F, S, L, pos, cache_outputs, cluster, bf16, stream)
    "p4fr_decoder_layer_int8": [P] * 23 + [I] * 10 + [P],
    # (x, cache i8, cache_scale f32, src_kv i8, src_scale f32, out, 18
    #  weight pointers, B, H, heads, F, S, L, pos, cache_outputs, cluster,
    #  bf16, stream)
    "p4fr_decoder_layer_int8_cache": [P] * 24 + [I] * 10 + [P],
    # (form, bf16, head width, H, F, cluster, clusters i32 out, regs i32
    #  out, local bytes i32 out): kernel 3's instance and its resident
    #  clusters of that size
    "p4fr_decoder_layer_query": [I] * 6 + [P] * 3,
    # kernel 8: p4fr_decoder_layer's arguments
    "p4fr_decoder_layer_v1": [P] * 22 + [I] * 10 + [P],
    # (bf16, head width, H, F, n_pos = max(L, S), cluster, clusters i32 out,
    #  regs i32 out, local bytes i32 out): kernel 8's instance and its
    #  resident clusters of that size
    "p4fr_decoder_layer_v1_query": [I] * 6 + [P] * 3,
    # (x, caches, src_kv, out, the 15 stacked weights, B, H, heads, F, S, L,
    #  NL, pos, cache_outputs, cluster, bf16, stream)
    "p4fr_decoder_stack_v3": [P] * 19 + [I] * 11 + [P],
    # (bf16, head width, H, F, cluster, clusters i32 out, regs i32 out,
    #  local bytes i32 out): kernel 7's instance and its resident clusters
    #  of that size
    "p4fr_decoder_stack_v3_query": [I] * 5 + [P] * 3,
    # (cache, parent i64, rows, group, row_vecs, prefix_vecs, stream)
    "p4fr_beam_gather": [P, P, ctypes.c_longlong, I, ctypes.c_longlong,
                         ctypes.c_longlong, P],
    # (token i32, caches, cross, mstate i32, the 20 FusedDecodeParams
    #  tensors, tok_out, mstate_out, logits f32, B, H, heads, F, S, L, NL,
    #  Vp, pos, cache_outputs, use_manager, sos, eos, lbrace, rbrace,
    #  vocab, cluster, bf16, stream)
    "p4fr_fused_greedy_step": [P] * 27 + [I] * 18 + [P],
    # (bf16, head width, H, F, Vp, cluster, clusters i32 out, regs i32 out,
    #  local bytes i32 out): kernel 6's instance and its resident clusters
    #  of that size
    "p4fr_fused_greedy_query": [I] * 6 + [P] * 3,
    # (qkv, bias f32, mask f32|null, out, N, n, C, heads, nW, scale, bf16,
    #  stream)
    "p4fr_window_attention": [P] * 4 + [I] * 5 + [F, I, P],
    # (n, bf16, regs i32 out, local bytes i32 out): the compiled instance's
    # registers and local memory a thread
    "p4fr_window_attention_attrs": [I, I, P, P],
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


_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def _object_path(src: str) -> str:
    """Where ``src``'s object is kept: named by a hash of the flags, the
    source and every ``csrc/`` header it includes, directly or not."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [src], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        digest.update(os.path.basename(path).encode() + text)
        todo += [os.path.join(CSRC, name) for name in
                 _INCLUDE.findall(text.decode()) if os.path.exists(os.path.join(CSRC, name))]
    name = os.path.basename(src)
    return os.path.join(BUILD_DIR, "obj", f"{name}.{digest.hexdigest()[:16]}.o")


def _compile(srcs, so: str) -> None:
    """One nvcc per ``.cu`` whose object is not kept yet, all at once, then
    one link of every object into ``so``."""
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}"
    objs = [_object_path(src) for src in srcs if src.endswith(".cu")]
    os.makedirs(os.path.dirname(objs[0]), exist_ok=True)
    procs = []
    try:
        for src, obj in zip((s for s in srcs if s.endswith(".cu")), objs):
            if not os.path.exists(obj):
                procs.append((src, obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", f"{obj}.{os.getpid()}", src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, obj, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                              f"{err[-4000:]}")
            else:
                os.replace(f"{obj}.{os.getpid()}", obj)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so",
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(f"{tmp}.so", so)
    finally:
        for _, obj, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(f"{obj}.{os.getpid()}"):
                os.remove(f"{obj}.{os.getpid()}")


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


def refuse_grad(what: str, plain: str, *tensors) -> None:
    """Raise where a kernel would drop gradients: grad mode is on and a
    tensor it reads requires grad. The kernels have no backward, and their
    outputs are fresh tensors without a ``grad_fn``; ``plain`` names the
    differentiable route to take instead."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{what}: an input requires grad and the kernel has no "
                         f"backward; {plain}")
