"""The timed path: the mapping step on the aligner's resident index, fed
from a ring of pinned batches with `in_flight` batches dispatched ahead.
The step is `map_kernel.map_batch` (K6, K1, K2) on base codes or
`map_kernel.map_batch_packed` (K1, K2) on 2-bit packed reads, as the
traffic's `link` says.

Per batch on a GPU: the reads and lengths are copied to the card on a
copy stream without blocking (the hand-off a pipeline makes); the compute
stream waits for that copy and calls the step (no synchronise); an output
stream waits for the step and copies `ec_distinct`,
`coverage` and `mapped` into pinned host buffers without blocking, then
records the batch's event.  A batch is done when its event has completed.
On the CPU (the tests) the same calls run in order.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

OUTPUTS = ("ec_distinct", "coverage", "mapped")


@contextmanager
def collector_paused():
    """No collector pass inside: a full pass over the process's objects
    stalls the host for milliseconds, and the card with it."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


@dataclass
class Pending:
    slot: int  # ring slot of the codes
    j: int  # in-flight buffer
    t_handoff: float


@dataclass
class Tally:
    """What the window saw, batch by batch."""

    done: int = 0  # batches whose outputs reached the host in the window
    latencies: list = field(default_factory=list)  # s, hand-off to done
    dispatch_s: float = 0.0  # host time inside map_batch, window batches
    dispatched: int = 0
    kept: list = field(default_factory=list)  # (slot, {output: rows})


class Pipeline:
    def __init__(self, meta, idx, ring_reads, ring_lens, in_flight: int,
                 device: torch.device, sample_rows: np.ndarray,
                 map_batch, annotate=None):
        self.meta, self.idx = meta, idx
        self.codes, self.lens = ring_reads, ring_lens
        self.F = in_flight
        self.dev = device
        self.rows = sample_rows
        self.map_batch = map_batch
        self.cuda = device.type == "cuda"
        self.annotate = annotate or (lambda name: nullcontext())
        B = ring_reads[0].shape[0]
        DC = meta.distinct_cap
        ec_dt = torch.int16 if meta.ec_out_16 else torch.int32
        cov_dt = torch.uint8 if meta.cov_out_8 else torch.int32
        pin = self.cuda
        self.d_codes = [torch.empty_like(ring_reads[0], device=device)
                        for _ in range(self.F)]
        self.d_lens = [torch.empty(B, dtype=torch.int32, device=device)
                       for _ in range(self.F)]
        self.h_out = [{"ec_distinct": torch.empty((B, DC), dtype=ec_dt,
                                                  pin_memory=pin),
                       "coverage": torch.empty(B, dtype=cov_dt,
                                               pin_memory=pin),
                       "mapped": torch.empty(B, dtype=torch.bool,
                                             pin_memory=pin)}
                      for _ in range(self.F)]
        # numpy views: keeping the judged rows runs no torch CPU op (whose
        # thread pool wakes up) between a batch's wait and the next hand-off
        self.h_np = [{n: t.numpy() for n, t in out.items()}
                     for out in self.h_out]
        if self.cuda:
            self.copy_s = torch.cuda.Stream(device)
            self.comp_s = torch.cuda.Stream(device)
            self.out_s = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(self.F)]
            self.computed = [torch.cuda.Event() for _ in range(self.F)]
            self.done_ev = [torch.cuda.Event() for _ in range(self.F)]

    def dispatch(self, i: int, tally: Tally | None) -> Pending:
        slot, j = i % len(self.codes), i % self.F
        t_hand = time.perf_counter()
        if not self.cuda:
            self.d_codes[j].copy_(self.codes[slot])
            self.d_lens[j].copy_(self.lens[slot])
            t0 = time.perf_counter()
            res = self.map_batch(self.meta, self.idx, self.d_codes[j],
                                 self.d_lens[j])
            if tally is not None:
                tally.dispatch_s += time.perf_counter() - t0
            for name in OUTPUTS:
                self.h_out[j][name].copy_(getattr(res, name))
            return Pending(slot, j, t_hand)
        with self.annotate("portbench.handoff"), torch.cuda.stream(
                self.copy_s):
            self.d_codes[j].copy_(self.codes[slot], non_blocking=True)
            self.d_lens[j].copy_(self.lens[slot], non_blocking=True)
            self.copied[j].record(self.copy_s)
        self.comp_s.wait_event(self.copied[j])
        with self.annotate("portbench.map_batch"), torch.cuda.stream(
                self.comp_s):
            t0 = time.perf_counter()
            res = self.map_batch(self.meta, self.idx, self.d_codes[j],
                                 self.d_lens[j])
            if tally is not None:
                tally.dispatch_s += time.perf_counter() - t0
            self.computed[j].record(self.comp_s)
        self.out_s.wait_event(self.computed[j])
        with self.annotate("portbench.fetch"), torch.cuda.stream(self.out_s):
            for name in OUTPUTS:
                t = getattr(res, name)
                t.record_stream(self.out_s)
                self.h_out[j][name].copy_(t, non_blocking=True)
            self.done_ev[j].record(self.out_s)
        return Pending(slot, j, t_hand)

    def wait(self, p: Pending) -> float:
        if self.cuda:
            with self.annotate("portbench.wait"):
                self.done_ev[p.j].synchronize()
        return time.perf_counter()

    def keep(self, p: Pending, tally: Tally) -> None:
        """Keep the judged rows of a finished batch's outputs."""
        out = self.h_np[p.j]
        tally.kept.append((p.slot, {n: out[n][self.rows] for n in OUTPUTS}))

    def run(self, seconds: float, tally: Tally, start: int = 0,
            count: int | None = None) -> int:
        """Dispatch with F batches ahead for `seconds` (or `count` batches);
        batches done inside go into the tally, the rest are drained and
        kept (judged, not counted).  Returns the next batch number."""
        pending: deque = deque()
        i = start
        t_end = time.perf_counter() + seconds
        closed = False
        while True:
            if len(pending) == self.F or closed:
                if not pending:
                    break
                p = pending.popleft()
                t = self.wait(p)
                if not closed and t > t_end:
                    closed = True
                if not closed:
                    tally.done += 1
                    tally.latencies.append(t - p.t_handoff)
                self.keep(p, tally)
                continue
            if count is not None and i - start >= count:
                closed = True
                continue
            if time.perf_counter() > t_end:
                closed = True
                continue
            pending.append(self.dispatch(i, tally))
            tally.dispatched += 1
            i += 1
        return i
