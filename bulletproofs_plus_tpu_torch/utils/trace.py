"""Spans and timers inside the port, off unless a caller turns them on.

    from bulletproofs_plus_tpu_torch.utils import trace
    trace.reset(); trace.enable()
    ...  # verify or prove
    trace.disable(); totals = trace.snapshot()

Off (the default) a site costs a read of the module's flag and a branch:
`span()` hands back one shared no-op object, and a `timed` function calls
through to the function it wraps; nothing is allocated and no clock is read.

On, a span records its name, its start and end (`time.perf_counter_ns`),
its parent (the span open on the same thread) and a request id, (the entry
call's number, the batch's index in that call), so that one batch's stages
can be picked out of the pipelined stream's interleaving.  Records go into
a list of CAPACITY entries; past it only `dropped` grows, while the totals
stay whole.  Each span also opens `torch.profiler.record_function("bppt." +
name)`, so under a profiler it lies on the same clock as the card's events.
A span never synchronises the card, never reads a tensor and never moves a
launch or a fetch.  A timer (`timed`) is for primitives called once an
item: on, it keeps a count and nanoseconds a name, and nothing else.

Launches are counted where they have always been, in
`native.cuda.launches`; `snapshot()` reports their change since `reset()`.

The port's spans: `verify.dispatch` (a batch's host half up to its
launches), its child `verify.host_replay` (the Fiat-Shamir replay on the
host), `verify.wait` (the host blocked on a fetch), `verify.continue` (what
runs after a fetch: weights, packing and launches, or the verdict's
checks); `prove` (a `prove_batch_with_rng` call), its children
`prove.arg_checks`, `prove.transcript`, `prove.dispatch`, `prove.readback`
and `prove.assemble`.  Its timers: `ristretto.decompress`,
`statement.init`, `transcript.init`, `pedersen.commit` (a commitment) and
`pedersen.tables` (a base's fixed-base table built).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
from time import perf_counter_ns

CAPACITY = 1 << 16

_on = False
_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans; .call: its entry call's number
_record_function = None
_records: list = []  # (seq, name, start_ns, end_ns, parent seq or -1, call, batch)
_spans: dict = {}  # name -> [count, total ns, self ns]
_timers: dict = {}  # name -> [count, ns]
_dropped = 0
_calls = itertools.count(1)
_seq = itertools.count()
_launch_base: collections.Counter = collections.Counter()
_NOOP = contextlib.nullcontext()


def enable() -> None:
    global _on, _record_function
    from torch.autograd.profiler import record_function

    _record_function = record_function
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget every record and total; launches count from here."""
    global _dropped, _calls, _launch_base
    from ..native import cuda

    with _lock:
        _records.clear()
        _spans.clear()
        _timers.clear()
        _dropped = 0
        _calls = itertools.count(1)
        _launch_base = collections.Counter(cuda.launches)


def new_call() -> None:
    """Number an entry call of the calling thread: the first half of the
    request id of every span it opens from here."""
    if _on:
        _local.call = next(_calls)


class _Span:
    __slots__ = ("name", "batch", "call", "seq", "parent", "child_ns", "start", "_range")

    def __init__(self, name: str, batch):
        self.name, self.batch = name, batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        if self.batch is None:
            self.batch = self.parent.batch if self.parent is not None else 0
        self.call = getattr(_local, "call", 0)
        self.seq = next(_seq)
        self.child_ns = 0
        stack.append(self)
        self._range = _record_function("bppt." + self.name)
        self._range.__enter__()
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = perf_counter_ns()
        self._range.__exit__(None, None, None)
        _local.stack.pop()
        took = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += took
        with _lock:
            totals = _spans.get(self.name)
            if totals is None:
                totals = _spans[self.name] = [0, 0, 0]
            totals[0] += 1
            totals[1] += took
            totals[2] += took - self.child_ns
            if len(_records) < CAPACITY:
                _records.append((self.seq, self.name, self.start, end, -1 if parent is None else parent.seq,
                                 self.call, self.batch))
            else:
                _dropped += 1
        return False


def span(name: str, batch=None):
    """A context manager around a stage.  `batch` is the batch's index in
    the entry call; left out, the parent span's (0 without a parent)."""
    return _Span(name, batch) if _on else _NOOP


def timed(name: str):
    """Decorate a per-item primitive: on, each call adds to `name`'s count
    and nanoseconds."""

    def wrap(fn):
        @functools.wraps(fn)
        def timed_fn(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            t0 = perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                took = perf_counter_ns() - t0
                with _lock:
                    totals = _timers.get(name)
                    if totals is None:
                        totals = _timers[name] = [0, 0]
                    totals[0] += 1
                    totals[1] += took

        return timed_fn

    return wrap


def records() -> list:
    """The spans recorded since `reset()`, in the order they closed, as
    dicts: name, start_ns, end_ns, seq, parent (its seq, -1 for none) and
    request (call, batch)."""
    with _lock:
        return [{"name": name, "start_ns": start, "end_ns": end, "seq": seq, "parent": parent,
                 "request": (call, batch)} for seq, name, start, end, parent, call, batch in _records]


def snapshot() -> dict:
    """Totals since `reset()`: for each span name its count, total and self
    seconds (the total less what its child spans cover); for each timer its
    count and seconds; launches by wrapper name; spans past CAPACITY."""
    from ..native import cuda

    with _lock:
        return {
            "spans": {name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9} for name, (c, t, s) in _spans.items()},
            "timers": {name: {"count": c, "s": t / 1e9} for name, (c, t) in _timers.items()},
            "launches": dict(collections.Counter(cuda.launches) - _launch_base),
            "dropped": _dropped,
        }
