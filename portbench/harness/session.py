"""One run of a cell: set-up, the window, the traced reading, the
judgement against the plain reference.  Device-agnostic, so the tests
drive it on the CPU (the port's plain passes) at a tiny size."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from . import traffic as traffic_mod
from .build import CACHE_DIR, Built
from .step import Pipeline, Tally, collector_paused
from .trace import WINDOW, profiled
from .work import probe_positions, seed_work, walk_work

# the launch counters each batch must move, by what crosses the link
COUNTED = {"codes_u8": ("pack_reads_u8_cuda", "seed_tables_cuda", "walk_cuda"),
           "packed_2bit": ("seed_tables_cuda", "walk_cuda")}
HIT_SAMPLE = 65536  # reads of each ring slot whose probes K1's count looks up


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    seconds: float
    batch_reads: int
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    index_device_bytes: int | None = None
    tally: Tally = field(default_factory=Tally)
    trace: object = None
    work: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    judged: int = 0
    failed_batches: int = 0
    flagged: float = 0.0  # share of judged answers flagged -2 or -3
    setup_steps: list = field(default_factory=list)  # (step, seconds)
    ring: list = field(default_factory=list)  # judged rows of each slot
    shape: object = None  # reference.walk.Shape of the serving meta
    hit_share: float | None = None  # of K1's probes, sampled for its work
    judge_s: float = 0.0  # the reference's judgement, after the window


def _launches(names):
    from pseudoaligner_torch.ops import kernels

    return {n: getattr(kernels, n).launches for n in names}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def _span(spans: dict, name: str, device):
    t = time.perf_counter()
    yield
    _sync(device)
    spans[name] = time.perf_counter() - t


def _annotate(enabled: bool):
    if not enabled:
        return lambda name: nullcontext()
    from torch.profiler import record_function

    return record_function


def _ring(cell, flat, seed: int, dev, map_batch, spans: dict):
    """The traffic ring, made on `dev`: (codes [B, L] uint8 per slot, what
    crosses the link per slot, lens per slot, judged rows, the step, its
    counters).  For a packed link the aligner's own host pack packs each
    slot, timed as the span `host_pack`."""
    from pseudoaligner_torch.ops import map_kernel

    tr = cell.traffic
    B, L = int(tr["batch_reads"]), int(tr["read_len"])
    R = int(tr["ring_batches"])
    pin = dev.type == "cuda"
    codes = [torch.empty((B, L), dtype=torch.uint8, pin_memory=pin)
             for _ in range(R)]
    lens = [torch.full((B,), L, dtype=torch.int32) for _ in range(R)]
    lens = [t.pin_memory() for t in lens] if pin else lens
    rows = traffic_mod.fill_ring(flat, tr, seed, codes, dev, cell.bench_dir)
    link = tr.get("link", "codes_u8")
    if link not in traffic_mod.LINKS:
        raise ValueError(f"link {link!r}: expected one of {traffic_mod.LINKS}")
    if link == "codes_u8":
        return codes, codes, lens, rows, map_batch or map_kernel.map_batch, \
            COUNTED[link]
    reads = []
    t = time.perf_counter()
    for c in codes:
        reads.append(torch.from_numpy(
            map_kernel.pack_reads_host(c.numpy()).view(np.int32)))
    spans["host_pack"] = (time.perf_counter() - t) / R
    reads = [r.pin_memory() for r in reads] if pin else reads
    return codes, reads, lens, rows, map_batch or map_kernel.map_batch_packed, \
        COUNTED[link]


def shape_of(meta):
    """The reference's walk shape of a `map_kernel.MapMeta`: its caps,
    mismatch budget, left-extension gate and seed rule."""
    from reference.walk import Shape

    return Shape(dc=meta.distinct_cap, wcap=meta.max_walk_iters,
                 lcap=meta.max_left_iters, max_nodes=meta.max_nodes,
                 allowed=meta.allowed_mismatches,
                 left_fraction=meta.left_extend_fraction,
                 lazy=meta.lazy_seeds)


def _judge(run: Run, g, kept, R: int) -> None:
    """Hold every kept output against the reference's answers."""
    from reference.answers import answers, wrong

    ref = [answers(g, run.ring[s], run.shape) for s in range(R)]
    n_wrong = n_flag = 0
    for slot, out in kept:
        bad = wrong(ref[slot], out["ec_distinct"], out["coverage"],
                    out["mapped"])
        n_wrong += int(bad.sum())
        run.failed_batches += int(bad.any())
        n_flag += int((out["ec_distinct"][:, -1] < -1).sum())
        run.judged += len(bad)
    run.checks["wrong_answers"] = (n_wrong, 0)
    run.checks["batches_unanswered"] = (run.tally.dispatched - len(kept), 0)
    run.flagged = n_flag / max(run.judged, 1)


def _seed_work(cfg: dict, shape, g, codes, B: int, L: int):
    """(K1's least work per launch, the hit share): its probes, with the
    share of hits looked up in the reference graph for HIT_SAMPLE reads
    of each slot."""
    from reference.graph import kmer_values

    k = int(cfg["k"])
    stride = 3 if shape.lazy else 1
    share = []
    for c in codes:
        v = kmer_values(c.numpy()[:HIT_SAMPLE], k)[:, ::stride]
        share.append(float(g.contains(v.reshape((-1,) + v.shape[2:])).mean()))
    hit_share = float(np.mean(share))
    probes = B * probe_positions(L, k, shape.lazy)
    return seed_work(B, L, k, cfg["seed_index"], shape.lazy, probes,
                     probes * hit_share), hit_share


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, cache_dir: str = CACHE_DIR,
             map_batch=None) -> Run:
    """Run `cell` once.  `map_batch` replaces the step (the fault tests
    break it); the default is pseudoaligner_torch.ops.map_kernel's."""
    from pseudoaligner_torch.cli import serving_config
    from pseudoaligner_torch.models.aligner import Pseudoaligner

    dev = torch.device(device)
    marks = [("start", time.time())]  # set-up's steps, for the log
    cfg_file, tr = cell.config, cell.traffic
    B, L = int(tr["batch_reads"]), int(tr["read_len"])
    R, F = int(tr["ring_batches"]), int(tr["in_flight"])
    run = Run(seconds=seconds, batch_reads=B)
    built = Built(cfg_file, cache_dir)
    flat = built.flat()
    built.ensure_index()
    marks.append(("cache", time.time()))

    # the ring first: what it takes on the card is freed before the
    # program's peak is counted
    codes, reads, lens, rows, step, counted = _ring(
        cell, flat, seed, dev, map_batch, run.spans)
    run.ring = [c.numpy()[rows].copy() for c in codes]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("traffic", time.time()))

    with _span(run.spans, "index_load", dev):
        image = built.index()
    cfg = serving_config(int(cfg_file["k"]), B, L,
                         seed_index=cfg_file["seed_index"])
    with _span(run.spans, "serve_init", dev):
        aligner = Pseudoaligner(image, cfg, device=device)
    meta = aligner.meta
    run.shape = shape_of(meta)
    run.index_device_bytes = aligner.dev.nbytes()
    marks.append(("aligner", time.time()))

    pipe = Pipeline(meta, aligner.dev, reads, lens, F, dev, rows, step,
                    _annotate(trace))
    nxt = pipe.run(float("inf"), Tally(), count=R + F)  # every slot, warm
    _sync(dev)
    before = _launches(counted) if dev.type == "cuda" else None
    marks.append(("warm", time.time()))
    run.setup_s = time.time() - t_process

    with profiled(trace, cache_dir) as holder:
        with collector_paused(), _annotate(trace)(WINDOW):
            pipe.run(seconds, run.tally, start=nxt)
        _sync(dev)
    run.trace = holder.trace
    run.setup_steps = [(name, t - prev) for (name, t), (_, prev) in zip(
        marks, [("process", t_process)] + marks[:-1])]
    if before is not None:
        after = _launches(counted)
        run.checks["missing_launches"] = (sum(
            abs(after[n] - before[n] - run.tally.dispatched)
            for n in counted), 0)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    if trace:  # K2's work from the outputs' visits and coverage
        visits = cov = 0
        for s in range(R):
            res = step(meta, aligner.dev, reads[s].to(dev), lens[s].to(dev))
            visits += int(res.n_nodes.to(torch.int64).sum())
            cov += int(res.coverage.to(torch.int64).sum())
        run.work["walk"] = walk_work(
            B, L, meta.distinct_cap, 2 if meta.ec_out_16 else 4,
            1 if meta.cov_out_8 else 4, visits / R, cov / R)

    del pipe, aligner, image
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the plain reference, once the program's state is freed
    t = time.perf_counter()
    g = built.refgraph()
    _judge(run, g, run.tally.kept, R)
    run.judge_s = time.perf_counter() - t
    if trace:
        run.work["seed"], run.hit_share = _seed_work(cfg_file, run.shape, g,
                                                     codes, B, L)
    return run
