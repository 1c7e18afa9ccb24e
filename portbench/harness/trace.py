"""The traced run's reduction: `torch.profiler` events to the card's busy
time over the window, the device operations that took most of it, and the
longest idle gaps by what the host was doing (the innermost harness span,
`portbench.<name>`, around the gap's middle)."""

from __future__ import annotations

import re

WINDOW = "portbench.window"


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


def events(prof):
    """(device intervals [(start, end, name)], host spans [(start, end, name)])
    in nanoseconds from the profiler's kineto events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.name().startswith("portbench."):  # a harness span, or its image on the device's timeline
            if e.device_type() != DeviceType.CUDA:
                host.append((start, start + dur, e.name()))
        elif e.device_type() == DeviceType.CUDA:
            device.append((start, start + dur, e.name()))
    return device, host


def merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def reduce(device, host) -> dict:
    """busy_s and window_s over the harness's window span, the ten device
    operations with the most time, the ten longest idle gaps by span."""
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0]
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = merge([(s, e) for s, e, _ in clipped])
    by_name = {}
    for s, e, n in clipped:
        by_name[n] = by_name.get(n, 0) + (e - s)
    spans = [(s, e, n) for s, e, n in host if n != WINDOW]
    gaps, last = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > last:
            mid = (last + s) // 2
            around = [(e2 - s2, n) for s2, e2, n in spans if s2 <= mid <= e2]
            gaps.append((s - last, min(around)[1] if around else WINDOW))
        last = max(last, e)
    gaps.sort(reverse=True)
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": [[clean(n), t / 1e9] for n, t in sorted(by_name.items(), key=lambda p: -p[1])[:10]],
        "idle_gaps": [[n, t / 1e9] for t, n in gaps[:10]],
        "device_events": len(clipped),
    }
