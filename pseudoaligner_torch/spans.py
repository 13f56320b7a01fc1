"""The program's own spans and counters: one registry per process.

    from pseudoaligner_torch import spans

    with spans.span("pa.serve_init.table"):
        ...                                   # timed on the host
    with spans.device_span("pa.serve_init.unpack", device):
        launch(...)                           # timed on the card
    spans.count("pa.pinned_bytes", t.nbytes)
    launch(..., spans.device_counter("pa.seed.probes", device))
    spans.snapshot()  # {"spans": {name: {"count", "total_s", "self_s"}},
                      #  "counters": {name: n}, "records": [...]}
    spans.reset()

A span times its block with `time.perf_counter_ns` and adds to its name's
count, total and self time; self time is the total less what the child
spans entered inside it on the same thread cover.  It also keeps a record
(name, start ns, end ns, parent name) in a ring of the last RING records.
The table and the ring are process-wide and locked, so spans entered on
worker threads (emit_fastq's render worker, the re-map pool) lose no
count; the parent stack is per thread.  Nothing is written out: a reader
asks for `snapshot()`.

While a torch.profiler session is active a span is also a
`record_function` of its name, so the exported Chrome trace shows it as a
`user_annotation` on the clock of the kernels and copies.  With no
profiler running that costs one flag check.

A device span records two CUDA events around work enqueued on a CUDA
device's current stream; `snapshot()` reads their elapsed time, so the
span adds no synchronise.  A device counter is an int64 [1] tensor on a
device that kernels add to; `snapshot()` reads it into the counter of its
name after synchronising its device, so the kernels that count add no
synchronise either.

Names start with "pa.".
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch
from torch.autograd import _profiler_enabled

RING = 65536  # span records kept, oldest dropped first

_lock = threading.Lock()
_stats: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
_counters: dict[str, int] = {}
_records: deque = deque(maxlen=RING)  # (name, start ns, end ns, parent)
_pending: list = []  # (name, start event, end event) of device spans
_device_counters: dict = {}  # (name, torch.device) -> int64 [1] tensor
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _add(name: str, total_ns: int, self_ns: int) -> None:
    s = _stats.get(name)
    if s is None:
        s = _stats[name] = [0, 0, 0]
    s[0] += 1
    s[1] += total_ns
    s[2] += self_ns


class span:
    """Context manager: time the block as the span `name`."""

    __slots__ = ("name", "stack", "parent", "child_ns", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = self.stack = _stack()
        self.parent = st[-1] if st else None
        st.append(self)
        self.child_ns = 0
        self.annotation = None
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.stack.pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        with _lock:
            _add(self.name, dur, dur - self.child_ns)
            _records.append((self.name, self.t0, t1,
                             None if parent is None else parent.name))
        return False


class device_span:
    """Context manager: the device time of the work the block enqueues on
    the current stream of `device`, a CUDA device, as the span `name`."""

    __slots__ = ("name", "device", "start")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        with _lock:
            _pending.append((self.name, self.start, end))
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def device_counter(name: str, device) -> torch.Tensor:
    """The int64 [1] tensor on `device` that kernels add the counter `name`
    to, zero when first asked for (after import or `reset()`).  It is
    zeroed on the device's current stream, ahead of the kernels the caller
    enqueues there, so asking adds no synchronise."""
    key = (name, torch.device(device))
    t = _device_counters.get(key)
    if t is None:
        with _lock:
            t = _device_counters.get(key)
            if t is None:
                t = torch.zeros(1, dtype=torch.int64, device=key[1])
                _device_counters[key] = t
    return t


def _synchronize(devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def snapshot() -> dict:
    """The registry as plain data: each span's count, total_s and self_s,
    each counter (device counters added in), and the ring's records.
    Waits for the device spans' end events and folds their times in, and
    synchronises the devices that hold device counters."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
        on_device = list(_device_counters.items())
    done = []
    for name, start, end in pending:
        end.synchronize()
        done.append((name, round(start.elapsed_time(end) * 1e6)))
    _synchronize({dev for (_, dev), _t in on_device})
    counted = [(name, int(t.sum())) for (name, _dev), t in on_device]
    with _lock:
        for name, ns in done:
            _add(name, ns, ns)
        counters = dict(_counters)
        for name, n in counted:
            counters[name] = counters.get(name, 0) + n
        return {
            "spans": {n: {"count": c, "total_s": t * 1e-9,
                          "self_s": s * 1e-9}
                      for n, (c, t, s) in _stats.items()},
            "counters": counters,
            "records": list(_records),
        }


def reset() -> None:
    """Forget every span, counter, record, pending device span and device
    counter (once the devices holding device counters are idle)."""
    with _lock:
        devices = {dev for (_, dev) in _device_counters}
    _synchronize(devices)
    with _lock:
        _stats.clear()
        _counters.clear()
        _records.clear()
        _pending.clear()
        _device_counters.clear()
