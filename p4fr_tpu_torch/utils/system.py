"""System and device telemetry, port of ``p4fr_tpu/utils/system.py``.

The reference's GPU and RAM status prints (reference: utils/utils.py:98-130)
on the port's devices, and a ``torch.profiler`` trace context for
performance work that writes a Chrome trace (the JAX package's writes an
xprof trace), which holds the program's spans (``utils/tracing.py``).
"""

from __future__ import annotations

import contextlib
import os
from datetime import datetime
from typing import Iterator

import torch


def get_timestamp() -> str:
    return datetime.now().strftime("%m%d-%H%M%S")


def print_device_status() -> None:
    """Device memory per CUDA card (analog of print_gpu_status): what the
    caching allocator holds and the card's free and total memory."""
    print("[+] Device Status")
    if not torch.cuda.is_available():
        print("  no CUDA card is visible")
        return
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        in_use = stats.get("allocated_bytes.all.current", 0) / 2 ** 30
        reserved = stats.get("reserved_bytes.all.current", 0) / 2 ** 30
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}: {in_use:.2f} GiB allocated, "
              f"{reserved:.2f} GiB reserved, {(total - free) / 2 ** 30:.2f} / "
              f"{total / 2 ** 30:.2f} GiB in use on the card")


def print_ram_status() -> None:
    """Host RSS (analog of print_ram_status)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    kb = int(line.split()[1])
                    print(f"[+] Memory Status\n Usage: {kb / 1024:10.5f} MB")
                    return
    except OSError:
        pass
    print("[+] Memory Status unavailable")


def print_system_envs() -> None:
    """Device/CPU inventory (analog of print_system_envs)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(
        "[+] System environments\n",
        f"The number of devices : {cards} (cuda)\n",
        f"The number of cpus : {os.cpu_count()}\n",
    )


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block, the host's ops and, where a
    card is visible, its kernels; written as a Chrome trace to
    ``{log_dir}/trace.json`` (chrome://tracing or Perfetto) when the block
    ends. Yields the profiler (``key_averages()`` after the block)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

