#!/usr/bin/env python3
"""Drive the PyTorch port's single-end `map` path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--novel-bases 27000000] [--batches 16]

Phases (every number printed is for the card named on the first line):

1. builds the CUDA kernels (csrc/*.cu) with nvcc;
2. makes a GENCODE-order synthetic transcriptome from --seed (gene
   families of 500-4000 random bases with 1-3 isoforms cut by internal
   deletions, --novel-bases of novel sequence), writes it as a FASTA with
   GENCODE headers, builds the k=20 index with the port's CLI (`index`)
   and writes batches x 65,536 reads of length 60 as FASTQ (a third exact
   windows, a third with one SNP, a third reversed);
3. holds the seed kernel (K1) and the walk kernel (K2) equal, tolerance 0,
   to their plain PyTorch versions on the card, on every batch in the
   serving shape and on the first in the uncapped full-output (exact
   re-map) shape, and times both: device time from a torch.profiler
   trace, and the span of back-to-back wrapper calls by CUDA events;
4. maps every batch through the device step alone (flagged -2/-3 share),
   times the serving emit loop (reads/s without set-up), then traces it
   once more for the device's busy share and its time per batch in copies
   and kernels;
5. zeroes the kernels' launch counters and runs the port's CLI,
   `map -i IDX reads.fq --batch-size 65536 --max-read-len 60 --device
   cuda`, end to end into a file; both kernels must have launched and
   every read must have a record;
6. recomputes 2,000 records spread over the file with the scalar golden
   oracle (pseudoaligner_torch.golden, numpy, independent of batches and
   kernels) and requires equal bytes.

The script imports only the port, torch and numpy.  The line before the
last is a JSON summary of the kernels; the last line is {"ok": true,
"device": {...}}.  Any failure raises: non-zero exit and no "ok" line,
also when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
READ_LEN = 60
BATCH = 65536
N_GOLDEN = 2000


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def scale_seqs(total_novel_bases: int, seed: int):
    """GENCODE-order synthetic transcriptome: gene families whose isoforms
    share long stretches, accumulating ~total_novel_bases of novel
    sequence (about that many distinct k-mers).  The recipe of bench.py's
    scale row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seqs, names, gene_map = [], [], {}
    novel = 0
    g = 0
    while novel < total_novel_bases:
        base = rng.integers(
            0, 4, size=int(rng.integers(500, 4000))).astype(np.uint8)
        novel += len(base)
        for i in range(int(rng.integers(1, 4))):
            if i == 0:
                s = base
            else:
                a = int(rng.integers(0, len(base) // 2))
                b = int(rng.integers(a + 50, min(len(base), a + 500)))
                s = np.concatenate([base[:a], base[b:]])
            if len(s) < 20:
                continue
            name = f"tx{g}_{i}"
            seqs.append(s)
            names.append(name)
            gene_map[name] = f"gene{g}"
        g += 1
    return seqs, names, gene_map


def recipe_reads(seqs, n_reads: int, read_len: int, seed: int):
    """bench.py's read recipe: windows within one transcript; the first
    third exact, the middle third with one SNP, the last third reversed
    (not complemented: negative controls)."""
    import numpy as np

    flat = np.concatenate(seqs)
    bases, counts = [], []
    base = 0
    for s in seqs:
        if len(s) >= read_len:
            bases.append(base)
            counts.append(len(s) - read_len + 1)
        base += len(s)
    bases = np.asarray(bases, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    rng = np.random.default_rng(seed)
    cum = np.cumsum(counts)
    pick = rng.integers(0, cum[-1], size=n_reads)
    tx = np.searchsorted(cum, pick, side="right")
    starts = bases[tx] + pick - (cum[tx] - counts[tx])
    reads = flat[starts[:, None] + np.arange(read_len)[None, :]].astype(
        np.uint8)
    third = n_reads // 3
    pos = rng.integers(0, read_len, size=third)
    rows = np.arange(third, 2 * third)
    reads[rows, pos] = (reads[rows, pos]
                        + rng.integers(1, 4, size=third)) % 4
    reads[2 * third:] = reads[2 * third:, ::-1]
    return reads


def write_fasta(path: str, seqs, names, gene_map) -> None:
    """GENCODE-style headers (nine '|' fields: transcript, gene, ...), as
    `index` reads them."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for s, name in zip(seqs, names):
            f.write(b">%s|%s|-|-|-|-|%d|protein_coding|\n%s\n" % (
                name.encode(), gene_map[name].encode(), len(s),
                acgt[s].tobytes()))


def write_fastq(path: str, reads) -> None:
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n, L = reads.shape
    seq = acgt[reads].tobytes()
    qual = b"I" * L
    with open(path, "wb") as f:
        for c0 in range(0, n, BATCH):
            f.write(b"".join(
                b"@r%d\n%s\n+\n%s\n" % (i, seq[i * L:(i + 1) * L], qual)
                for i in range(c0, min(n, c0 + BATCH))))


def span_ms(fn, reps: int) -> float:
    """Milliseconds per call of `reps` back-to-back calls after a warm-up
    call, between CUDA events: the device's time plus whatever host work
    between launches it waits for."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn):
    """Run fn() under torch.profiler; its device activities (kernels,
    copies, sets) as (name, start_us, end_us), sorted by start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == dev),
                  key=lambda x: x[1])


def device_ms(fn, reps: int, kernel: str | None = None) -> float | None:
    """Device milliseconds per call over `reps` calls after a warm-up call,
    from a trace: the summed durations of the kernel named `kernel`, or of
    every device activity when `kernel` is None.  None when the trace holds
    no such activity."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    us = [e - s for n, s, e in device_events(calls)
          if kernel is None or kernel in n]
    return sum(us) / 1000 / reps if us else None


def busy_us(events) -> float:
    """Microseconds in which at least one device activity ran."""
    total, cur_s, cur_e = 0.0, None, None
    for _n, s, e in events:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def max_abs_diff(a, b) -> int:
    """Exact comparison of two tensors: dtype and shape must agree; returns
    the largest absolute difference (0 when equal)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare_results(kernel, plain, what: str) -> int:
    worst = 0
    for f in kernel._fields:
        d = max_abs_diff(getattr(kernel, f), getattr(plain, f))
        if d:
            raise AssertionError(f"{what}: field {f} differs by up to {d}")
        worst = max(worst, d)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--novel-bases", type=int, default=27_000_000)
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args(argv)
    t_start = time.time()

    say(card_line())  # name, power limit: every number below is for it
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import dataclasses

    import numpy as np

    from pseudoaligner_torch import cli
    from pseudoaligner_torch.golden import golden_oracle, golden_record
    from pseudoaligner_torch.models.aligner import Pseudoaligner
    from pseudoaligner_torch.ops import kernels
    from pseudoaligner_torch.ops.map_kernel import (
        pack_reads_host,
        seed_tables,
        walk,
    )

    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. kernels ----
    t = time.time()
    so = kernels.build()
    say(f"kernels built in {time.time() - t:.2f} s: {os.path.basename(so)}")

    # ---- 2. data ----
    work = os.path.join(HERE, ".smoke")
    os.makedirs(work, exist_ok=True)
    fa_path = os.path.join(work, "transcripts.fa")
    idx_path = os.path.join(work, "index.bin")
    fq_path = os.path.join(work, "reads.fq")
    out_path = os.path.join(work, "map.out")
    t = time.time()
    seqs, names, gmap = scale_seqs(args.novel_bases, args.seed)
    write_fasta(fa_path, seqs, names, gmap)
    rc = cli.main(["index", "-i", idx_path, fa_path,
                   "-n", str(os.cpu_count())])
    if rc != 0:
        raise AssertionError(f"index CLI returned {rc}")
    image = cli.open_index(idx_path)
    say(f"index: {len(seqs)} transcripts, {image.mphf.n_keys} k-mers, "
        f"{image.n_nodes} nodes, {image.n_ecs} classes, written and built "
        f"in {time.time() - t:.1f} s")
    n_reads = args.batches * BATCH
    t = time.time()
    reads = recipe_reads(seqs, n_reads, READ_LEN, args.seed + 3)
    write_fastq(fq_path, reads)
    say(f"reads: {n_reads} x {READ_LEN} written in {time.time() - t:.1f} s")
    del seqs

    # ---- 3. kernels vs plain on the card ----
    cfg = cli.serving_config(20, BATCH, READ_LEN)
    t = time.time()
    al = Pseudoaligner(image, cfg, device="cuda")
    torch.cuda.synchronize()
    say(f"serve init (device index build + upload) {time.time() - t:.1f} s; "
        f"index device bytes {al.dev.nbytes()}")
    meta, idx = al.meta, al.dev
    lens_np = np.full(BATCH, READ_LEN, dtype=np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    packed = [torch.from_numpy(pack_reads_host(
        reads[b * BATCH:(b + 1) * BATCH]).view(np.int32)).to(dev)
        for b in range(args.batches)]

    # every batch in the serving shape, the first also in the uncapped
    # full-output shape of the exact re-map
    err_seed = err_walk = 0
    nh3 = []
    for b, pk in enumerate(packed):
        nh3.append(kernels.seed_tables_cuda(meta, idx, pk, lens))
        nh3_p = seed_tables(meta, idx, pk, lens)
        err_seed = max(err_seed, max_abs_diff(nh3[b], nh3_p))
        if err_seed:
            raise AssertionError(f"seed kernel differs by up to {err_seed} "
                                 f"on batch {b}")
        err_walk = max(err_walk, compare_results(
            kernels.walk_cuda(meta, idx, pk, lens, nh3[b]),
            walk(meta, idx, pk, lens, nh3_p), f"walk kernel, batch {b}"))
    meta_full = dataclasses.replace(
        meta, distinct_cap=0, max_walk_iters=0, max_left_iters=0,
        max_nodes=max(meta.max_nodes, 2 * meta.read_len))
    full_k = kernels.walk_cuda(meta_full, idx, packed[0], lens, nh3[0])
    err_walk = max(err_walk, compare_results(
        full_k, walk(meta_full, idx, packed[0], lens, nh3[0]),
        "walk kernel (full output)"))
    torch.cuda.synchronize()
    say(f"kernel == plain, tolerance 0: seed and walk (serving shape) on "
        f"all {args.batches} batches of {BATCH} reads; walk full output "
        f"(nodes {tuple(full_k.nodes.shape)}) on batch 0")

    def rotating(f):
        """f(batch index) over the batches in turn: each call meets a new
        batch, so its cuckoo buckets and node rows are not L2-resident
        from the call before."""
        calls = [0]

        def call():
            calls[0] += 1
            return f(calls[0] % args.batches)
        return call

    n_b = args.batches
    # (name, call, reps, kernel symbol): each kernel against its plain
    # version, both in the serving shape and in the full-output shape
    timed = [
        ("seed", lambda b: kernels.seed_tables_cuda(meta, idx, packed[b], lens),
         n_b, "seed_kernel"),
        ("seed_plain", lambda b: seed_tables(meta, idx, packed[b], lens),
         4, None),
        ("walk", lambda b: kernels.walk_cuda(meta, idx, packed[b], lens,
                                             nh3[b]), n_b, "walk_kernel"),
        ("walk_plain", lambda b: walk(meta, idx, packed[b], lens, nh3[b]),
         4, None),
        ("walk_full", lambda b: kernels.walk_cuda(
            meta_full, idx, packed[b], lens, nh3[b]), n_b, "walk_kernel"),
        ("walk_full_plain", lambda b: walk(
            meta_full, idx, packed[b], lens, nh3[b]), 2, None),
    ]
    ms = {}
    for name, f, reps, sym in timed:
        span = span_ms(rotating(f), reps)
        dev_ms = device_ms(rotating(f), reps, sym)
        what = f"kernel {sym}" if sym else "all device activity"
        say(f"ms per {BATCH}-read batch, {name}: device {dev_ms} ({what}, "
            f"traced), span {span} (back-to-back calls, CUDA events)")
        # the trace's device time where it saw any, else the span
        ms[name] = span if dev_ms is None else dev_ms
    del packed, nh3, full_k

    # ---- 4. device step alone, then the serving loop ----
    flagged = {-2: 0, -3: 0}
    torch.cuda.synchronize()
    t = time.time()
    for b in range(args.batches):
        res = al.map_batch_device(reads[b * BATCH:(b + 1) * BATCH], lens_np)
        last = res.ec_distinct[:, -1].cpu().numpy()
        for v in flagged:
            flagged[v] += int((last == v).sum())
    dt = time.time() - t
    say(f"device step (pack, H2D, K1, K2, D2H, synchronised per batch) over "
        f"{n_reads} reads: {n_reads / dt:.0f} reads/s; flagged -2: "
        f"{flagged[-2]} ({flagged[-2] / n_reads:.6f}), -3: {flagged[-3]} "
        f"({flagged[-3] / n_reads:.6f})")
    with open(os.devnull, "wb") as sink:
        al.emit_fastq(fq_path, sink)  # warm the host caches
        torch.cuda.synchronize()
        al.phase_times = {}
        t = time.time()
        n_emit, _ = al.emit_fastq(fq_path, sink)
        dt = time.time() - t
        if n_emit != n_reads:
            raise AssertionError(f"emitted {n_emit} of {n_reads} reads")
        say(f"serving emit loop (FASTQ parse to records, no set-up): "
            f"{n_reads / dt:.0f} reads/s, {dt * 1000 / n_b:.2f} ms per "
            "batch; host phases, ms per batch: " + ", ".join(
                f"{k} {v * 1000 / n_b:.2f}"
                for k, v in sorted(al.phase_times.items())))
        # the same loop once more under the profiler: where the device's
        # time goes, and how much of the loop it is idle
        wall = []

        def traced_loop():
            t0 = time.time()
            al.emit_fastq(fq_path, sink)
            torch.cuda.synchronize()
            wall.append(time.time() - t0)

        events = device_events(traced_loop)
    per = {"H2D": 0.0, "K1": 0.0, "K2": 0.0, "D2H": 0.0, "other": 0.0}
    for name, s0, e0 in events:
        cat = ("H2D" if name.startswith("Memcpy HtoD") else
               "D2H" if name.startswith("Memcpy DtoH") else
               "K1" if "seed_kernel" in name else
               "K2" if "walk_kernel" in name else "other")
        per[cat] += e0 - s0
    busy = busy_us(events) / 1e6
    say(f"serving loop traced: wall {wall[0]:.4f} s, device busy "
        f"{busy:.6f} s ({100 * busy / wall[0]:.3f}%, idle "
        f"{100 - 100 * busy / wall[0]:.3f}%); device ms per batch: " +
        ", ".join(f"{k} {v / 1000 / n_b:.4f}" for k, v in per.items()))
    al.close()
    del al, idx

    # ---- 5. the main path: the port's CLI ----
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    real_stdout = sys.stdout
    t = time.time()
    with open(out_path, "wb") as f:
        sys.stdout = io.TextIOWrapper(f, write_through=True)
        try:
            rc = cli.main(["map", "-i", idx_path, fq_path, "--batch-size",
                           str(BATCH), "--max-read-len", str(READ_LEN),
                           "--device", "cuda"])
        finally:
            sys.stdout.flush()
            sys.stdout.detach()
            sys.stdout = real_stdout
    dt = time.time() - t
    launches = {"seed": kernels.seed_tables_cuda.launches,
                "walk": kernels.walk_cuda.launches}
    if rc != 0:
        raise AssertionError(f"map CLI returned {rc}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    with open(out_path, "rb") as f:
        lines = f.read().splitlines()
    if len(lines) != n_reads:
        raise AssertionError(f"{len(lines)} records for {n_reads} reads")
    say(f"map CLI end to end (index load, device index, upload, map, emit):"
        f" {dt:.2f} s, {n_reads / dt:.0f} reads/s; launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes")

    # ---- 6. independent check: the scalar golden oracle ----
    oracle = golden_oracle(image)
    t = time.time()
    sample = np.unique(np.linspace(0, n_reads - 1, N_GOLDEN).astype(np.int64))
    for i in sample:
        want = golden_record(oracle, f"r{i}", reads[i], cfg).encode()
        if lines[i] != want:
            raise AssertionError(f"record {i}: {lines[i]!r} != {want!r}")
    say(f"golden oracle: {len(sample)} sampled records byte-identical "
        f"({time.time() - t:.1f} s)")

    kernels_line = {"kernels": [
        {"name": "seed_tables", "route": "cuda",
         "source": "pseudoaligner_torch/csrc/seed.cu",
         "replaces": "pseudoaligner_tpu/ops/map_kernel.py:520",
         "launches": launches["seed"], "max_abs_err": err_seed,
         "ms": ms["seed"], "plain_ms": ms["seed_plain"]},
        {"name": "walk", "route": "cuda",
         "source": "pseudoaligner_torch/csrc/walk.cu",
         "replaces": "pseudoaligner_tpu/ops/map_kernel.py:719",
         "launches": launches["walk"], "max_abs_err": err_walk,
         "ms": ms["walk"], "plain_ms": ms["walk_plain"]},
    ]}
    say(f"total {time.time() - t_start:.1f} s")
    say(json.dumps(kernels_line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
