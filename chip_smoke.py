#!/usr/bin/env python3
"""Drive the PyTorch port's single-end `map` path once on one NVIDIA GPU,
under each of its seed indexes, and its `batch_stats`.

    python3 chip_smoke.py [--seed 0] [--novel-bases 27000000] [--batches 16]

Phases (every number printed is for the card named on the first line):

1. builds the CUDA kernels (csrc/*.cu, one nvcc per source, in parallel)
   and prints ptxas's register and spill report;
2. makes a GENCODE-order synthetic transcriptome from --seed (gene
   families of 500-4000 random bases with 1-3 isoforms cut by internal
   deletions, --novel-bases of novel sequence), writes it as a FASTA with
   GENCODE headers, builds the k=20 index with the port's CLI (`index`)
   and writes batches x 65,536 reads of length 60 as FASTQ (a third exact
   windows, a third with one SNP, a third reversed);
3. cuckoo seed index: holds the seed kernel (K1) and the walk kernel (K2)
   equal, tolerance 0, to their plain PyTorch versions on the card, on
   every batch in the serving shape and on the first in the uncapped
   full-output (exact re-map) shape, and times both: device time from a
   torch.profiler trace (where the trace misses launches, CUDA events
   around each call with the device held busy while the host prepares
   it), and the span of back-to-back wrapper calls by CUDA events;
4. maps every batch through the device step alone (flagged -2/-3 share),
   times the serving emit loop (reads/s without set-up), then traces it
   once more for the device's busy share and its time per batch in copies
   and kernels;
5. bucket1 and MPHF seed indexes on the same index image: device bytes and
   serve-init time; K1 under each and K2 in the bucket1 serving shape
   (lazy seeds) on 4 batches spread over the file, K2 in the MPHF uncapped
   full-output shape on the middle one, and the stats kernel (K3) against
   `batch_stats`' plain version on the last one (its reversed reads give
   MPHF false positives), all tolerance 0 and timed as in phase 3; the
   serving loop of phase 4 once per index;
6. the main paths, each with the launch counters set to 0 just before it
   and read just after: the port's CLI `map -i IDX reads.fq --batch-size
   65536 --max-read-len 60 --device cuda` under `--seed-index cuckoo`,
   `bucket1` and `mphf` (the bucket1 and MPHF outputs must be
   byte-identical to the cuckoo one, every read must have a record, K1 and
   K2 must have launched), then `batch_stats` over every batch (K3 must
   have launched);
7. recomputes 2,000 records spread over the cuckoo output with the scalar
   golden oracle (pseudoaligner_torch.golden, numpy, independent of
   batches and kernels) and requires equal bytes.

Each kernel's bound is the least time the card could take for the work of
this run's data: the bytes the function must move (inputs it needs read
once, outputs written once) over 3.35 TB/s, against its 32-bit integer
operations over 67 T/s (the H100 SXM's peak memory rate and its peak rate
outside the tensor cores), whichever is larger.

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
MODE_BATCHES = 4  # batches compared in the bucket1 / MPHF serving shape
CUCKOO_BYTES = 546_199_872  # cuckoo serving index at the default arguments
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM 32-bit peak outside the tensor cores


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


def device_ms(fn, reps: int, kernel: str | None = None):
    """(device milliseconds per call, activities seen) over `reps` calls
    after a warm-up call, from a trace: the summed durations of the kernel
    named `kernel`, or of every device activity when `kernel` is None.
    None when the trace holds no such activity."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    us = [e - s for n, s, e in device_events(calls)
          if kernel is None or kernel in n]
    return (sum(us) / 1000 / reps if us else None), len(us)


def held_ms(fn, reps: int) -> float:
    """Milliseconds per call between CUDA events recorded right around each
    call while the device is held busy (torch.cuda._sleep) during the
    host's preparation of the call, so that the events bracket the call's
    device work and not the wrapper's host time."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)  # ~1 ms: outlasts the host work
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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


# ---------------------------------------------------------------------------
# work counts for the bounds: what this run's data needs each function to
# read and compute (a probe that hits in the first cuckoo bucket never reads
# the second; an MPHF probe reads one bit word per level tried)
# ---------------------------------------------------------------------------


def _probed_words(meta, packed, lens, eager: bool):
    """[n, W] k-mer words of the positions K1 (or K3 when eager) probes."""
    import torch

    from pseudoaligner_torch.ops.kmers import all_kmers
    from pseudoaligner_torch.ops.map_kernel import unpack_reads

    kmers = all_kmers(unpack_reads(packed, meta.read_len), meta.k)
    pos = torch.arange(meta.n_positions, device=packed.device)
    valid = pos[None, :] <= lens.to(torch.int64)[:, None] - meta.k
    if meta.lazy_seeds and not eager:
        valid &= pos[None, :] % 3 == 0
    return kmers[valid]


def _mphf_work(meta, idx, words):
    """(bytes, ops) of MPHF probes plus the verify: a bit word per level
    tried, then the rank word and the stored key where a level's bit is
    set, and the node and offset where the key verifies."""
    import torch

    from pseudoaligner_torch.ops.hashing import MASK32, hash_kmer
    from pseudoaligner_torch.ops.mphf_lookup import probe_and_verify

    m, W = meta.mphf, meta.kmer_words
    tried = torch.zeros(words.shape[0], dtype=torch.int64,
                        device=words.device)
    done = torch.zeros_like(tried, dtype=torch.bool)
    for lv in range(len(m.seeds)):
        tried += ~done
        h = hash_kmer(words, m.seeds[lv]) & m.masks[lv]
        word = idx.mphf_bits[m.word_offsets[lv] + (h >> 5)].to(
            torch.int64) & MASK32
        done |= ((word >> (h & 31)) & 1) == 1
    slot, ok = probe_and_verify(words, idx.mphf_bits, idx.mphf_ranks, m,
                                idx.kmer_keys)
    found = slot >= 0
    nbytes = (4 * tried.sum() + (4 + 4 * W) * found.sum() + 8 * ok.sum())
    ops = (9 * W + 6) * tried.sum() + W * found.sum()
    return int(nbytes), int(ops)


def _probe_work(meta, idx, words):
    """(bytes, ops) of this run's probes of the serving seed index."""
    import torch

    from pseudoaligner_torch.index.cuckoo import B1_SLOTS, EMPTY, H1_SEED
    from pseudoaligner_torch.ops.hashing import hash_kmer
    from pseudoaligner_torch.ops.map_kernel import seed_probe

    W, n = meta.kmer_words, words.shape[0]
    if meta.seed_index == "mphf":
        return _mphf_work(meta, idx, words)
    keys = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    if meta.seed_index == "cuckoo":
        hit = seed_probe(meta, idx, words)[0] >= 0
        rows = idx.cuckoo[hash_kmer(words, H1_SEED) & meta.cuckoo_mask]
        in1 = (rows.view(n, 4, W) == keys[:, None, :]).all(-1).any(-1)
        nbytes = 16 * W * (n + (~in1).sum()) + 8 * hit.sum()
        ops = (9 * W + 4 * W) * (n + (~in1).sum())
        return int(nbytes), int(ops)
    rows = idx.cuckoo[hash_kmer(words, meta.bucket_seed)
                      & meta.cuckoo_mask].view(n, B1_SLOTS, W + 2)
    used = rows[:, :, W] != EMPTY - 2**32  # EMPTY's int32 bit pattern
    match = (rows[:, :, :W] == keys[:, None, :]).all(-1) & used
    # slots read: up to the match, or every occupied slot on a miss
    first = torch.where(match.any(-1), match.int().argmax(-1) + 1,
                        used.sum(-1))
    slots = int(first.sum())
    return 4 * (W + 2) * slots, 9 * W * n + W * slots


def bound(works) -> tuple[float, str]:
    """(least milliseconds per call, what bounds it) for the mean of the
    calls' counted (bytes, operations)."""
    nbytes = sum(w[0] for w in works) / len(works)
    ops = sum(w[1] for w in works) / len(works)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seed_work(meta, idx, packed, lens):
    """K1: packed reads and lens in, nh3 out, plus the probes' reads."""
    B, P, k = packed.shape[0], meta.n_positions, meta.k
    pb, po = _probe_work(meta, idx, _probed_words(meta, packed, lens, False))
    nbytes = packed.numel() * 4 + B * 4 + B * P * 12 + pb
    return nbytes, po + 3 * k * B * P


def walk_work(packed, res):
    """K2: the reads, nh3's row 0, a 48-byte node row per visit, the pool
    bases compared (2 bits each, about the coverage) and the outputs.  The
    lazy seeks' probes and re-seed lookups are left out (a lower bound)."""
    B = packed.shape[0]
    visits = int(res.n_nodes.to("cpu").long().sum())
    cov = int(res.coverage.to("cpu").long().sum())
    out = sum(getattr(res, f).numel() * getattr(res, f).element_size()
              for f in res._fields)
    nbytes = packed.numel() * 4 + B * 4 + B * 12 + 48 * visits + cov // 4
    return nbytes + out, 6 * cov + 20 * visits


def stats_work(meta, idx, packed, lens):
    """K3: the reads, every valid position's MPHF probe and verify reads,
    three counters out."""
    B, P, k = packed.shape[0], meta.n_positions, meta.k
    pb, po = _mphf_work(meta, idx, _probed_words(meta, packed, lens, True))
    return packed.numel() * 4 + B * 4 + pb + 24, po + 3 * k * B * P


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--novel-bases", type=int, default=27_000_000)
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args(argv)
    defaults = vars(args) == vars(ap.parse_args([]))
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
    from pseudoaligner_torch.ops.stats import batch_stats, stats_counts

    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. kernels ----
    t = time.time()
    so = kernels.build()
    say(f"kernels built in {time.time() - t:.2f} s: {os.path.basename(so)}")
    for line in kernels.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")

    # ---- 2. data ----
    work = os.path.join(HERE, ".smoke")
    os.makedirs(work, exist_ok=True)
    fa_path = os.path.join(work, "transcripts.fa")
    idx_path = os.path.join(work, "index.bin")
    fq_path = os.path.join(work, "reads.fq")
    t = time.time()
    seqs, names, gmap = scale_seqs(args.novel_bases, args.seed)
    write_fasta(fa_path, seqs, names, gmap)
    rc = cli.main(["index", "-i", idx_path, fa_path,
                   "-n", str(os.cpu_count())])
    if rc != 0:
        raise AssertionError(f"index CLI returned {rc}")
    image = cli.open_index(idx_path)
    say(f"index: {len(seqs)} transcripts, {image.mphf.n_keys} k-mers, "
        f"{image.n_nodes} nodes, {image.n_ecs} classes, "
        f"{image.mphf.n_levels} MPHF levels, written and built in "
        f"{time.time() - t:.1f} s")
    n_reads = args.batches * BATCH
    n_b = args.batches
    t = time.time()
    reads = recipe_reads(seqs, n_reads, READ_LEN, args.seed + 3)
    write_fastq(fq_path, reads)
    say(f"reads: {n_reads} x {READ_LEN} written in {time.time() - t:.1f} s")
    del seqs
    lens_np = np.full(BATCH, READ_LEN, dtype=np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    packed = [torch.from_numpy(pack_reads_host(
        reads[b * BATCH:(b + 1) * BATCH]).view(np.int32)).to(dev)
        for b in range(n_b)]

    def serve_init(mode: str):
        cfg = cli.serving_config(20, BATCH, READ_LEN, seed_index=mode)
        t = time.time()
        al = Pseudoaligner(image, cfg, device="cuda")
        torch.cuda.synchronize()
        say(f"[{mode}] serve init (device index build + upload) "
            f"{time.time() - t:.1f} s; index device bytes {al.dev.nbytes()}")
        return cfg, al

    def full_shape(meta):
        return dataclasses.replace(
            meta, distinct_cap=0, max_walk_iters=0, max_left_iters=0,
            max_nodes=max(meta.max_nodes, 2 * meta.read_len))

    def rotating(f, n=n_b):
        """f(batch index) over the first n batches in turn: each call
        meets a new batch, so its buckets and node rows are not
        L2-resident from the call before (when n > 1)."""
        calls = [0]

        def call():
            calls[0] += 1
            return f(calls[0] % n)
        return call

    ms = {}

    def time_pair(name, f, reps, sym, n=n_b):
        span = span_ms(rotating(f, n), reps)
        dev_ms, seen = device_ms(rotating(f, n), reps, sym)
        held = held_ms(rotating(f, n), reps)
        what = (f"kernel {sym}, {seen} launches seen of {reps}" if sym
                else f"all device activity, {seen} activities")
        say(f"ms per {BATCH}-read batch, {name}: device {dev_ms} ({what}, "
            f"traced), held {held} (CUDA events around each call, device "
            f"held busy meanwhile), span {span} (back-to-back calls, CUDA "
            "events)")
        # the trace's device time where it saw every launch, else the
        # held-event time
        ms[name] = dev_ms if dev_ms is not None and (
            sym is None or seen == reps) else held

    def serving_report(al, mode: str):
        """Phase 4 for one engine: the device step alone, the serving emit
        loop, and the loop once more under the profiler."""
        flagged = {-2: 0, -3: 0}
        torch.cuda.synchronize()
        t = time.time()
        for b in range(n_b):
            res = al.map_batch_device(reads[b * BATCH:(b + 1) * BATCH],
                                      lens_np)
            last = res.ec_distinct[:, -1].cpu().numpy()
            for v in flagged:
                flagged[v] += int((last == v).sum())
        dt = time.time() - t
        say(f"[{mode}] device step (pack, H2D, K1, K2, D2H, synchronised per "
            f"batch) over {n_reads} reads: {n_reads / dt:.0f} reads/s; "
            f"flagged -2: {flagged[-2]} ({flagged[-2] / n_reads:.6f}), -3: "
            f"{flagged[-3]} ({flagged[-3] / n_reads:.6f})")
        with open(os.devnull, "wb") as sink:
            al.emit_fastq(fq_path, sink)  # warm the host caches
            torch.cuda.synchronize()
            al.phase_times = {}
            t = time.time()
            n_emit, _ = al.emit_fastq(fq_path, sink)
            dt = time.time() - t
            if n_emit != n_reads:
                raise AssertionError(f"emitted {n_emit} of {n_reads} reads")
            say(f"[{mode}] serving emit loop (FASTQ parse to records, no "
                f"set-up): {n_reads / dt:.0f} reads/s, {dt * 1000 / n_b:.2f}"
                " ms per batch; host phases, ms per batch: " + ", ".join(
                    f"{k} {v * 1000 / n_b:.2f}"
                    for k, v in sorted(al.phase_times.items())))
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
        say(f"[{mode}] serving loop traced: wall {wall[0]:.4f} s, device "
            f"busy {busy:.6f} s ({100 * busy / wall[0]:.3f}%, idle "
            f"{100 - 100 * busy / wall[0]:.3f}%); device ms per batch: " +
            ", ".join(f"{k} {v / 1000 / n_b:.4f}" for k, v in per.items()))

    # ---- 3. cuckoo: kernels vs plain on the card ----
    cfg, al = serve_init("cuckoo")
    if defaults and al.dev.nbytes() != CUCKOO_BYTES:
        raise AssertionError(f"cuckoo serving index {al.dev.nbytes()} B, "
                             f"expected {CUCKOO_BYTES}")
    meta, idx = al.meta, al.dev
    # every batch in the serving shape, the first also in the uncapped
    # full-output shape of the exact re-map
    err = {"seed": 0, "walk": 0}
    nh3 = []
    for b, pk in enumerate(packed):
        nh3.append(kernels.seed_tables_cuda(meta, idx, pk, lens))
        nh3_p = seed_tables(meta, idx, pk, lens)
        err["seed"] = max(err["seed"], max_abs_diff(nh3[b], nh3_p))
        if err["seed"]:
            raise AssertionError(f"seed kernel differs by up to "
                                 f"{err['seed']} on batch {b}")
        err["walk"] = max(err["walk"], compare_results(
            kernels.walk_cuda(meta, idx, pk, lens, nh3[b]),
            walk(meta, idx, pk, lens, nh3_p), f"walk kernel, batch {b}"))
    meta_full = full_shape(meta)
    full_k = kernels.walk_cuda(meta_full, idx, packed[0], lens, nh3[0])
    err["walk"] = max(err["walk"], compare_results(
        full_k, walk(meta_full, idx, packed[0], lens, nh3[0]),
        "walk kernel (full output)"))
    torch.cuda.synchronize()
    say(f"[cuckoo] kernel == plain, tolerance 0: seed and walk (serving "
        f"shape) on all {n_b} batches of {BATCH} reads; walk full output "
        f"(nodes {tuple(full_k.nodes.shape)}) on batch 0")
    # the bounds of the work the timed calls below do, batch by batch
    bounds = {
        "seed": bound([seed_work(meta, idx, pk, lens) for pk in packed]),
        "walk": bound([walk_work(pk, kernels.walk_cuda(
            meta, idx, pk, lens, nh3[b])) for b, pk in enumerate(packed)])}
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
    for name, f, reps, sym in timed:
        time_pair(name, f, reps, sym)
    del nh3, full_k

    # ---- 4. cuckoo: device step alone, then the serving loop ----
    serving_report(al, "cuckoo")
    al.close()
    del al, idx

    # ---- 5. bucket1 and MPHF seed indexes ----
    # batches spread over the file: exact, one-SNP and reversed reads
    sel = sorted({int(x) for x in np.linspace(0, n_b - 1, MODE_BATCHES)})
    mid, last = sel[len(sel) // 2], sel[-1]
    for mode in ("bucket1", "mphf"):
        _cfg, al = serve_init(mode)
        meta, idx = al.meta, al.dev
        sk, wk = f"seed_{mode}", f"walk_{mode}"
        err[sk] = err[wk] = 0
        nh3 = {}
        for b in sel:
            nh3[b] = kernels.seed_tables_cuda(meta, idx, packed[b], lens)
            nh3_p = seed_tables(meta, idx, packed[b], lens)
            err[sk] = max(err[sk], max_abs_diff(nh3[b], nh3_p))
            if err[sk]:
                raise AssertionError(f"{mode} seed kernel differs by up to "
                                     f"{err[sk]} on batch {b}")
            if mode == "bucket1":
                err[wk] = max(err[wk], compare_results(
                    kernels.walk_cuda(meta, idx, packed[b], lens, nh3[b]),
                    walk(meta, idx, packed[b], lens, nh3_p),
                    f"{mode} walk kernel, batch {b}"))
        bounds[sk] = bound([seed_work(meta, idx, packed[b], lens)
                            for b in sel])
        time_pair(sk, lambda i: kernels.seed_tables_cuda(
            meta, idx, packed[sel[i]], lens), n_b, "seed_kernel", len(sel))
        time_pair(f"{sk}_plain", lambda i: seed_tables(
            meta, idx, packed[sel[i]], lens), 2, None, len(sel))
        if mode == "bucket1":
            # the serving shape with lazy seeds: off-grid re-seeds probe
            # bucket1 rows inside the walk
            wmeta, wsel = meta, sel
            what = f"serving shape, lazy seeds, batches {sel}"
        else:
            wmeta, wsel = full_shape(meta), [mid]
            got = kernels.walk_cuda(wmeta, idx, packed[mid], lens, nh3[mid])
            err[wk] = compare_results(
                got, walk(wmeta, idx, packed[mid], lens, nh3[mid]),
                f"{mode} walk kernel (full output)")
            what = (f"uncapped full output (nodes {tuple(got.nodes.shape)}),"
                    f" batch {mid}")
        bounds[wk] = bound([walk_work(packed[b], kernels.walk_cuda(
            wmeta, idx, packed[b], lens, nh3[b])) for b in wsel])
        time_pair(wk, lambda i: kernels.walk_cuda(
            wmeta, idx, packed[wsel[i]], lens, nh3[wsel[i]]), n_b,
            "walk_kernel", len(wsel))
        time_pair(f"{wk}_plain", lambda i: walk(
            wmeta, idx, packed[wsel[i]], lens, nh3[wsel[i]]), 2, None,
            len(wsel))
        if mode == "mphf":
            # K3 on the MPHF serving upload, which carries the MPHF arrays;
            # the last batch's reversed reads are aliens to the index
            got = kernels.stats_cuda(meta, idx, packed[last], lens)
            err["stats"] = max_abs_diff(
                got, stats_counts(meta, idx, packed[last], lens))
            if err["stats"] or got[2] <= 0:
                raise AssertionError(f"stats kernel {got.tolist()}: differs "
                                     "or no false positives")
            say(f"[mphf] stats kernel == plain, tolerance 0, batch {last}: "
                f"positions, hits, false positives {got.tolist()}")
            bounds["stats"] = bound([stats_work(meta, idx, packed[last],
                                                lens)])
            time_pair("stats", lambda i: kernels.stats_cuda(
                meta, idx, packed[last], lens), n_b, "stats_kernel", 1)
            time_pair("stats_plain", lambda i: stats_counts(
                meta, idx, packed[last], lens), 2, None, 1)
        torch.cuda.synchronize()
        say(f"[{mode}] kernel == plain, tolerance 0: seed on batches {sel}; "
            f"walk, {what}")
        del nh3
        serving_report(al, mode)
        al.close()
        del al, idx

    # ---- 6. the main paths: the CLI under each seed index, batch_stats ----
    launches, outs = {}, {}
    for mode in ("cuckoo", "bucket1", "mphf"):
        out_path = os.path.join(work, f"map_{mode}.out")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        real_stdout = sys.stdout
        t = time.time()
        with open(out_path, "wb") as f:
            sys.stdout = io.TextIOWrapper(f, write_through=True)
            try:
                rc = cli.main(["map", "-i", idx_path, fq_path, "--batch-size",
                               str(BATCH), "--max-read-len", str(READ_LEN),
                               "--device", "cuda", "--seed-index", mode])
            finally:
                sys.stdout.flush()
                sys.stdout.detach()
                sys.stdout = real_stdout
        dt = time.time() - t
        launches[mode] = {"seed": kernels.seed_tables_cuda.launches,
                          "walk": kernels.walk_cuda.launches,
                          "stats": kernels.stats_cuda.launches}
        if rc != 0:
            raise AssertionError(f"map CLI ({mode}) returned {rc}")
        if min(launches[mode]["seed"], launches[mode]["walk"]) < 1:
            raise AssertionError(f"a kernel never launched on the main path "
                                 f"({mode}): {launches[mode]}")
        with open(out_path, "rb") as f:
            outs[mode] = f.read()
        n_lines = outs[mode].count(b"\n")
        if n_lines != n_reads:
            raise AssertionError(f"{mode}: {n_lines} records for {n_reads} "
                                 "reads")
        if outs[mode] != outs["cuckoo"]:
            raise AssertionError(f"map --seed-index {mode} output differs "
                                 "from the cuckoo output")
        say(f"[{mode}] map CLI end to end (index load, device index, upload,"
            f" map, emit): {dt:.2f} s, {n_reads / dt:.0f} reads/s; launches "
            f"{launches[mode]}; peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes"
            + ("" if mode == "cuckoo" else
               "; output byte-identical to the cuckoo run"))
    cfg_m = cli.serving_config(20, BATCH, READ_LEN, seed_index="mphf")
    al = Pseudoaligner(image, cfg_m, device="cuda")
    kernels.reset_launch_counts()
    t = time.time()
    st = [batch_stats(al.meta, al.dev, pk, lens) for pk in packed]
    dt = time.time() - t
    launches["stats"] = {"stats": kernels.stats_cuda.launches}
    if launches["stats"]["stats"] < 1:
        raise AssertionError("the stats kernel never launched")
    n_pos = sum(s.n_positions for s in st)
    n_hit = sum(s.n_seed_hits for s in st)
    n_fp = sum(s.n_probe_false_positives for s in st)
    if n_pos != n_reads * (READ_LEN - 20 + 1) or not (
            0 < n_hit < n_pos and n_fp > 0):
        raise AssertionError(f"implausible batch stats: {n_pos} positions, "
                             f"{n_hit} hits, {n_fp} false positives")
    say(f"[mphf] batch_stats over {n_b} batches: {dt:.3f} s; launches "
        f"{launches['stats']}; hit rate {n_hit / n_pos:.6f}, "
        f"false-positive rate {n_fp / n_pos:.6f}")
    al.close()
    del al

    # ---- 7. independent check: the scalar golden oracle ----
    lines = outs["cuckoo"].splitlines()
    oracle = golden_oracle(image)
    t = time.time()
    sample = np.unique(np.linspace(0, n_reads - 1, N_GOLDEN).astype(np.int64))
    for i in sample:
        want = golden_record(oracle, f"r{i}", reads[i], cfg).encode()
        if lines[i] != want:
            raise AssertionError(f"record {i}: {lines[i]!r} != {want!r}")
    say(f"golden oracle: {len(sample)} sampled records byte-identical "
        f"({time.time() - t:.1f} s)")

    def entry(name, key, source, replaces, mode, which):
        b_ms, b_by = bounds[key]
        return {"name": name, "route": "cuda",
                "source": f"pseudoaligner_torch/csrc/{source}",
                "replaces": f"pseudoaligner_tpu/{replaces}",
                "launches": launches[mode][which], "max_abs_err": err[key],
                "ms": ms[key], "plain_ms": ms[f"{key}_plain"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    kernels_line = {"kernels": [
        entry("seed_tables[cuckoo]", "seed", "seed.cu",
              "ops/map_kernel.py:520", "cuckoo", "seed"),
        entry("seed_tables[bucket1]", "seed_bucket1", "seed.cu",
              "ops/map_kernel.py:482", "bucket1", "seed"),
        entry("seed_tables[mphf]", "seed_mphf", "seed.cu",
              "ops/mphf_lookup.py:88", "mphf", "seed"),
        entry("walk[cuckoo]", "walk", "walk.cu", "ops/map_kernel.py:719",
              "cuckoo", "walk"),
        entry("walk[bucket1, lazy seek]", "walk_bucket1", "walk.cu",
              "ops/map_kernel.py:1000", "bucket1", "walk"),
        entry("walk[mphf] (full-output shape)", "walk_mphf", "walk.cu",
              "ops/map_kernel.py:719", "mphf", "walk"),
        entry("stats", "stats", "stats.cu", "ops/stats.py:39", "stats",
              "stats"),
    ]}
    say(f"total {time.time() - t_start:.1f} s")
    say(json.dumps(kernels_line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
