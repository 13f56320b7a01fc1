"""torch.profiler over the window, reduced to what the per-layer metrics
and the breakdown read: device intervals by name, copies with their
bytes, the window's bounds, and the host annotations.

The trace is exported as Chrome JSON under TMPDIR (or the checkout's
cache when none is set), read once and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


@dataclass
class Trace:
    window: tuple = (0.0, 0.0)  # us
    device: list = field(default_factory=list)  # (name, cat, ts, dur, args)
    host: list = field(default_factory=list)  # (name, ts, dur) annotations

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def in_window(self):
        a, b = self.window
        return [e for e in self.device if e[2] >= a and e[2] + e[3] <= b]

    def busy_intervals(self):
        """Merged device-busy intervals clipped to the window (us)."""
        a, b = self.window
        iv = sorted((max(e[2], a), min(e[2] + e[3], b)) for e in self.device
                    if e[2] + e[3] > a and e[2] < b)
        out = []
        for s, t in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-6

    def kernel_durations(self, needle: str) -> list:
        """Seconds of each kernel launch in the window whose name holds
        `needle`."""
        return [e[3] * 1e-6 for e in self.in_window()
                if e[1] == "kernel" and needle in e[0]]

    def copies(self, kind: str) -> list:
        """(bytes, seconds) of each copy of `kind` ("HtoD", "DtoH") in the
        window; bytes None where the trace gives none."""
        out = []
        for e in self.in_window():
            if e[1] == "gpu_memcpy" and kind in e[0]:
                nb = e[4].get("bytes")
                out.append((None if nb is None else int(nb), e[3] * 1e-6))
        return out

    def device_ops(self, top: int = 10) -> list:
        tot: dict = {}
        for e in self.in_window():
            tot[e[0]] = tot.get(e[0], 0.0) + e[3] * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device work in the window, each named
        by the host annotation that covers most of it."""
        a, b = self.window
        busy = self.busy_intervals()
        edges = [a] + [x for iv in busy for x in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, t in gaps[:top]:
            best, cover = "none", 0.0
            for name, hs, hd in self.host:
                c = min(t, hs + hd) - max(s, hs)
                if c > cover:
                    best, cover = name, c
            out.append([best, (t - s) * 1e-6])
        return out


def read_chrome(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            tr.device.append((name, cat, ts, dur, e.get("args", {})))
        elif cat == "user_annotation":
            if name == WINDOW:
                tr.window = (ts, ts + dur)
            else:
                tr.host.append((name, ts, dur))
    return tr


@contextmanager
def profiled(enabled: bool, scratch_dir: str):
    """Profile the block when enabled; yields a holder whose `.trace` is
    the reduced Trace once the block has ended."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        yield holder
    tmp_root = os.environ.get("TMPDIR") or scratch_dir
    os.makedirs(tmp_root, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmp_root)
    os.close(fd)
    try:
        torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        holder.trace = read_chrome(path)
    finally:
        os.remove(path)
