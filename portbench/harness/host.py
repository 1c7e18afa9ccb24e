"""The host side of a run: the conditions it is fixed to, and the counters
that explain a slow one.

`fix` acts before torch is imported, on this process only: the thread
counts of OpenMP, MKL and OpenBLAS (and torch's, once imported), the CPU
affinity (a fixed number of the cores local to the card, from sysfs), and
cache directories inside the checkout.  `Window` reads, over the measured
window, the process's CPU seconds against wall seconds, its voluntary and
involuntary context switches, the garbage collector's passes and seconds,
and at the window's two ends a probe of the core's speed (the least and
the median of 8 timings of a fixed piece of pure-Python work) and the
card's clocks, power draw and power limit from nvidia-smi (reading only).  Nothing here changes the machine.
"""

from __future__ import annotations

import gc
import os
import resource
import statistics
import subprocess
import time

# The levers the noise study kept (PERF.md, the noise study): one thread,
# CORES cores, the collector frozen after set-up.  Every run applies them.
THREADS = 1
CORES = 4
SMI_FIELDS = "name,power.limit,power.draw,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu,pci.bus_id"


def smi() -> dict:
    """One reading of the first card by nvidia-smi, or {} without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        ).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    values = [v.strip() for v in out[0].split(",")]
    return dict(zip(SMI_FIELDS.split(","), values))


def local_cpus(bus_id: str) -> list:
    """The cores sysfs lists as local to the card at `bus_id`, or []."""
    if not bus_id:
        return []
    parts = bus_id.lower().split(":")
    name = ":".join([parts[0][-4:]] + parts[1:]) if len(parts) == 3 else bus_id.lower()
    try:
        with open(f"/sys/bus/pci/devices/{name}/local_cpulist") as f:
            text = f.read().strip()
    except OSError:
        return []
    cpus = []
    for item in text.split(","):
        lo, _, hi = item.partition("-")
        cpus += list(range(int(lo), int(hi or lo) + 1))
    return cpus


def fix(root: str) -> dict:
    """Fix this process's threads and cores before torch is imported;
    returns the conditions as they were set."""
    cache = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    allowed = sorted(os.sched_getaffinity(0))
    conditions = {"cpus_allowed": len(allowed), "all_cpus": allowed, "threads": THREADS}
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    start = smi()
    local = local_cpus(start.get("pci.bus_id", ""))
    conditions["card_local_cpus"] = len(local)
    os.sched_setaffinity(0, ([c for c in local if c in allowed] or allowed)[:CORES])
    conditions["affinity"] = sorted(os.sched_getaffinity(0))
    conditions["smi"] = start
    return conditions


def fix_torch(conditions: dict) -> None:
    """The thread counts torch keeps itself, once it is imported."""
    import torch

    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)
    conditions["torch_threads"] = torch.get_num_threads()


def settle() -> None:
    """The end of set-up: collect, and move what set-up made out of the
    collector's reach."""
    gc.collect()
    gc.freeze()


def cpu_probe_ms(repeats: int = 8) -> list:
    """The least and the median of `repeats` timings, in ms, of a fixed
    piece of pure-Python work, 64 exponentiations mod 2^255 - 19 (the kind
    of work the host half of a decode does): the least reads this core's
    speed at the moment, the median with what interrupts it."""
    p = 2**255 - 19
    times = []
    for _ in range(repeats):
        x = 3
        t0 = time.perf_counter()
        for i in range(64):
            x = pow(x + i, (p - 5) // 8, p)
        times.append((time.perf_counter() - t0) * 1e3)
    return [min(times), statistics.median(times)]


class Window:
    """Counters over the measured window (enter at its start, exit at its end)."""

    def __init__(self):
        self.passes = [0, 0, 0]
        self.gc_s = 0.0
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.passes[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        self.smi_start = smi()
        self.probe_start = cpu_probe_ms()
        gc.callbacks.append(self._gc)
        self.rusage = resource.getrusage(resource.RUSAGE_SELF)
        self.wall = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.wall
        end = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.remove(self._gc)
        self.smi_end = smi()
        self.counters = {
            "cpu_probe_ms": [self.probe_start, cpu_probe_ms()],
            "wall_s": wall,
            "cpu_s": (end.ru_utime - self.rusage.ru_utime) + (end.ru_stime - self.rusage.ru_stime),
            "user_s": end.ru_utime - self.rusage.ru_utime,
            "system_s": end.ru_stime - self.rusage.ru_stime,
            "voluntary_switches": end.ru_nvcsw - self.rusage.ru_nvcsw,
            "involuntary_switches": end.ru_nivcsw - self.rusage.ru_nivcsw,
            "gc_passes": list(self.passes),
            "gc_s": self.gc_s,
            "smi_start": self.smi_start,
            "smi_end": self.smi_end,
        }
        return False
