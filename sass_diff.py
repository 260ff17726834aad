#!/usr/bin/env python3
"""Whether kernels compile to the same machine code in two checkouts.

    python3 sass_diff.py --parent DIR decoder_layer.cu fused_decode.cu ...

Compiles each named file of ``p4fr_tpu_torch/csrc/`` in this checkout and
in ``DIR`` (another checkout) to a cubin with the library's own flags
(``_build.NVCC_FLAGS``, all at once), disassembles both with ``cuobjdump
-sass`` and compares each kernel's instructions, without their addresses,
their encodings and the names of the functions (nvcc names an anonymous
namespace after its file, so names differ between trees). Prints one
``SASS`` line a kernel: identical, with its count of instructions, or the
first instruction that differs; the exit code is 1 if any kernel differs
or is missing on one side. Needs the CUDA toolkit (nvcc, cuobjdump), not
a card.
"""

import argparse
import os
import re
import subprocess
import sys

from p4fr_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGS = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def kernels(sass: str) -> dict:
    """{kernel name, anonymous namespace left out: [instruction, ...]}"""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub("_ANON_", m.group(1))
            out[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            text = re.sub(r"/\*.*?\*/", "", line).strip().rstrip(";").strip()
            out[name].append(ANON.sub("_ANON_", text))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="the other checkout")
    parser.add_argument("sources", nargs="+", help="files of p4fr_tpu_torch/csrc/")
    args = parser.parse_args(argv)
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out_dir = os.path.join(ROOT, "build", "sass_diff")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for label, tree in (("parent", os.path.abspath(args.parent)), ("this", ROOT)):
        for src in args.sources:
            cubin = os.path.join(out_dir, f"{label}.{src}.cubin")
            jobs[label, src] = (cubin, subprocess.Popen(
                [nvcc, *FLAGS, "-cubin", "-o", cubin,
                 os.path.join(tree, "p4fr_tpu_torch", "csrc", src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (label, src), (_, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -cubin {label} {src} failed:\n{log[-4000:]}")
    differ = 0
    for src in args.sources:
        sides = [kernels(subprocess.run([cuobjdump, "-sass", jobs[label, src][0]],
                                        check=True, capture_output=True, text=True).stdout)
                 for label in ("parent", "this")]
        for name in sorted(set(sides[0]) | set(sides[1])):
            a, b = (side.get(name) for side in sides)
            if a is None or b is None:
                differ += 1
                print(f"SASS {src} {name}: only in {'this' if a is None else 'parent'}")
            elif a == b:
                print(f"SASS {src} {name}: identical ({len(a)} instructions)")
            else:
                differ += 1
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                print(f"SASS {src} {name}: differs ({len(a)} vs {len(b)} instructions; "
                      f"first at {i}: {a[i] if i < len(a) else '-'!r} vs "
                      f"{b[i] if i < len(b) else '-'!r})")
    print(f"SASS {differ} kernel(s) differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
