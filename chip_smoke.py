#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: single-end
`map` under each of its seed indexes, `batch_stats`, the bit-packed index
upload, paired-end `map`, single-cell `count`, the bitset EC path, the
multi-device layer on one card, and the graph-sharded walk.

    python3 chip_smoke.py [--seed 0] [--novel-bases 27000000] [--batches 16]
                          [--bitset-novel-bases 12000000]

Phases (every number printed is for the card named on the first line):

1. builds the CUDA kernels (csrc/*.cu, one nvcc per source, in parallel)
   and prints ptxas's register and spill report; no kernel may have a
   stack frame or a spill;
2. makes a GENCODE-order synthetic transcriptome from --seed (gene
   families of 500-4000 random bases with 1-3 isoforms cut by internal
   deletions, --novel-bases of novel sequence), writes it as a FASTA with
   GENCODE headers, builds the k=20 index with the port's CLI (`index`)
   and writes batches x 65,536 reads of length 60 as FASTQ (a third exact
   windows, a third with one SNP, a third reversed);
3. cuckoo seed index: holds the seed kernel (K1) and the walk kernel (K2)
   equal, tolerance 0, to their plain PyTorch versions on the card, on
   every batch in the serving shape and on the first in the uncapped
   full-output (exact re-map) shape, and times both by two methods, held
   (CUDA events around each call with the device held busy while the
   host prepares it: every timed row has it, and the kernels line's `ms`
   is it) and traced (torch.profiler device time, with the launches the
   trace saw), and the span of back-to-back wrapper calls by CUDA events;
   K2's bound in both shapes; `map_kernel.map_batch` on int32 code tensors
   of 4 batches (K6's int32 entry packs them on the card) gives every
   MapResult field of the host-packed batches;
4. maps every batch through the device step alone (flagged -2/-3 share),
   times the serving emit loop (reads/s without set-up), then traces it
   once more for the device's busy share and its time per batch in copies
   and kernels;
5. bucket1 and MPHF seed indexes on the same index image: device bytes
   (each upload's bytes are its arrays' bytes) and serve-init time; K1
   under each and K2 in the bucket1 serving shape (lazy seeds) on 4
   batches spread over the file, K2 in the MPHF uncapped full-output shape
   on the middle one, and the stats kernel (K3) against
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
   batches and kernels) and requires equal bytes;
8. the bit-packed upload of the cuckoo tables (which the phase-6 cuckoo
   CLI's serve init took by the default gate: K5 must have launched there):
   the unpack kernel (K5) equal, tolerance 0, to its plain version on this
   index's packed arrays, and both equal to the plain upload's arrays;
   bytes on the link and upload time, packed against plain, in turns; K5
   timed as in phase 3;
9. paired-end `map`: batches x 32,768 pairs by bench.py's synth_pairs
   recipe (mates are windows of one transcript, a one-SNP middle third,
   mate 2 of the last third reversed) through the CLI `map -i IDX r1.fq
   r2.fq --batch-size 65536` (pairs/s, launches), the paired serving loop
   traced for the device's busy share, and 2,000 sampled pairs recomputed
   by the golden oracle and the pair rule (equal bytes);
10. single-cell `count`: batches x 65,536 read pairs by bench.py's
   synth_count_inputs recipe (400 zipf-skewed cells, 16-base barcodes
   with 2% one-base errors, 12-base UMIs) through the CLI `count`
   (pairs/s, launches); on the first 4 batches the batched path's counts
   must equal the record path's (distinct_cap = 0);
11. the bitset EC path on a second index of --bitset-novel-bases novel
   bases (at most 16,384 transcripts, so meta.tx_words > 0): the bitset
   intersection kernel (K4) equal, tolerance 0, to its plain version on 4
   batches in the full-output shape and timed; then `count_single_cell`
   and `map_fastq` through a distinct_cap = 0 aligner, each of which must
   launch K4, and 2,000 sampled `map_fastq` records equal to the golden
   oracle's;
12. the multi-device layer on this one card, with a real NCCL process group
   of one process: (a) the read pack (K6, its uint8 and int32 entries,
   each also equal to the host pack), the routing (K7, route and
   unscatter, at 1, 2, 4 and 8 shards), the shard-local MPHF probe (K8)
   and K1's next_hit entry equal, tolerance 0, to their plain versions on
   --batches' first 4 batches (next_hit also to K1's table over the whole
   MPHF; K8 also on a buffer, three quarters zero padding, of a small
   lookup whose keys hold the all-zero poly-A k-mer), and timed; the
   lookup bytes per shard (S = 1 here, S = 4 in (c)) are the separate
   arrays' bytes; the kpart link's code bytes per batch (uint8, one byte
   a base) and the host's ms to ship them, against int32 codes and against
   the native host pack, beside K6 and a one-thread kernel's time; (b) the
   k-mer-partitioned serving aligner over the NCCL group emits every
   batch of the file, byte-identical to phase 6's cuckoo CLI output (K6's
   uint8 entry, K7, K8, next_hit and K2 must have launched, K6's int32
   entry not);
   (c) four loopback shards on the card give the replicated engine's
   MapResults on 4 batches; (d) the data-parallel ShardedAligner on the
   bitset index: its counts (the transcript-count kernel K9, all_reduce)
   equal a host recount of K4's bitsets, K9 equal to its plain version;
   (e) map_fastq_multihost at world size 1: its part file equals phase
   11's map_fastq records and its merged counts their counts, and the
   count merge's all_reduce of one [n_tx] int32 vector is timed; (f) the
   dry run `dryrun_multichip(1)` (its k-mer-partitioned step
   graph-sharded);
13. the graph-sharded walk (`KmerPartitionedAligner(..., shard_graph=True)`:
   node rows and pool in S node blocks, a routed fetch per graph access):
   (a) S = 1 over the NCCL group, the serving emit of every batch,
   byte-identical to phase 6's cuckoo CLI output (K6's uint8 entry, K7,
   K8, next_hit, the walk steps K10 and the owner-side fetch K11 must have
   launched, K6's int32 entry not),
   its rate beside phase 12's and its fetches, all_to_alls and liveness
   syncs per batch; K10 and K11 timed on one recorded walk of the middle
   batch, held launch by launch (each launch of the replayed walk between
   its own pair of events, summed per walk, so the gaps between its
   dependent launches stay out), with the breakdown by entry and by fetch
   width and a one-thread kernel's time by the same method (what any
   launch costs); (b) four loopback shards on 4 batches spread over the file
   (exact, one-SNP and reversed reads): every MapResult field equal to
   the replicated engine's (K2), and every K10 and K11 launch equal to
   its plain step on copies of the same inputs, tolerance 0; graph bytes
   per shard; (c) the full-output shape on phase 11's bitset index, four
   loopback shards, 4 batches: every field, ec_bits (K4's entry from the
   pushed class ids) and the counts equal the data-parallel
   ShardedAligner's (K4 from node ids, K9); K4's class-id entry equal to
   its plain version and timed.

Each kernel's bound is the least time the card could take for the work of
this run's data: the bytes the function must move (inputs it needs read
once, outputs written once) over 3.35 TB/s, against its 32-bit integer
operations over 67 T/s (the H100 SXM's peak memory rate and its peak rate
outside the tensor cores), whichever is larger.

The script imports only the port, torch and numpy.  The line before the
last is a JSON summary of the kernels (each with held_ms and traced_ms,
the launches the trace saw of those timed, and plain_traced_ms; `ms` and
`plain_ms` are the held times; `launches_on` names the run `launches`
counts); the last line is {"ok": true,
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
# a kpart shard's lookup at the default arguments, S = 1 and S = 4
LOOKUP_BYTES = {1: 459_450_424, 4: 114_898_008}
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


def _windows(seqs, read_len: int):
    """(concatenated bases, start of each transcript that holds a read,
    read start positions in it)."""
    import numpy as np

    flat = np.concatenate(seqs)
    bases, counts = [], []
    base = 0
    for s in seqs:
        if len(s) >= read_len:
            bases.append(base)
            counts.append(len(s) - read_len + 1)
        base += len(s)
    return (flat, np.asarray(bases, dtype=np.int64),
            np.asarray(counts, dtype=np.int64))


def recipe_reads(seqs, n_reads: int, read_len: int, seed: int):
    """bench.py's read recipe: windows within one transcript; the first
    third exact, the middle third with one SNP, the last third reversed
    (not complemented: negative controls)."""
    import numpy as np

    flat, bases, counts = _windows(seqs, read_len)
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


def pair_reads(seqs, n_pairs: int, read_len: int, seed: int):
    """bench.py's synth_pairs recipe: both mates are windows of the same
    transcript; the middle third of the pairs has one SNP on each mate,
    and mate 2 of the last third is reversed.  (mate1, mate2) codes."""
    import numpy as np

    flat, bases, counts = _windows(seqs, read_len)
    rng = np.random.default_rng(seed)
    tx = rng.integers(0, len(bases), size=n_pairs)
    off1 = rng.integers(0, counts[tx])
    off2 = rng.integers(0, counts[tx])
    win = np.arange(read_len)[None, :]
    r1 = flat[(bases[tx] + off1)[:, None] + win].astype(np.uint8)
    r2 = flat[(bases[tx] + off2)[:, None] + win].astype(np.uint8)
    third = n_pairs // 3
    for r in (r1, r2):
        pos = rng.integers(0, read_len, size=third)
        rows = np.arange(third, 2 * third)
        r[rows, pos] = (r[rows, pos] + rng.integers(1, 4, size=third)) % 4
    r2[2 * third:] = r2[2 * third:, ::-1]
    return r1, r2


def count_reads(seqs, n_pairs: int, read_len: int, seed: int,
                n_cells: int = 400, bc_error_rate: float = 0.02):
    """bench.py's synth_count_inputs recipe: R1 is a 16-base barcode from a
    pool of n_cells with zipf-skewed abundance (bc_error_rate of them with
    one base changed) and a 12-base UMI; R2 is cDNA by recipe_reads.
    (R1, R2) codes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 4, size=(n_cells, 16))
    w = 1.0 / np.arange(1, n_cells + 1)
    bcs = cells[rng.choice(n_cells, size=n_pairs, p=w / w.sum())]
    n_err = int(n_pairs * bc_error_rate)
    rows = rng.choice(n_pairs, size=n_err, replace=False)
    pos = rng.integers(0, 16, size=n_err)
    bcs[rows, pos] = (bcs[rows, pos] + rng.integers(1, 4, size=n_err)) % 4
    umis = rng.integers(0, 4, size=(n_pairs, 12))
    r1 = np.concatenate([bcs, umis], axis=1).astype(np.uint8)
    return r1, recipe_reads(seqs, n_pairs, read_len, seed + 1)


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


def local_memory(log: str) -> dict:
    """ptxas -v's report -> {function: (stack frame, spill stores, spill
    loads) bytes}."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = tuple(int(x) for x in m.groups())
            fn = None
    return out


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


def held_each_ms(fns, reps: int) -> list[float]:
    """Milliseconds per call of each of fns, called in order `reps` times
    after a warm-up round, between CUDA events recorded right around each
    call while the device is held busy (torch.cuda._sleep) during the
    host's preparation of the call, so that the events bracket the call's
    device work and not the wrapper's host time."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    pairs = [[] for _ in fns]
    for _ in range(reps):
        for fn, got in zip(fns, pairs):
            torch.cuda._sleep(2_000_000)  # ~1 ms: outlasts the host work
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            got.append((start, end))
    torch.cuda.synchronize()
    return [sum(a.elapsed_time(b) for a, b in got) / reps for got in pairs]


def held_ms(fn, reps: int) -> float:
    """held_each_ms of one function."""
    return held_each_ms([fn], reps)[0]


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


def ecbits_work(meta, idx, res, classes=None):
    """K4: each mapped read's first min(n_nodes, max_nodes) node ids and
    their class ids (or, from `classes`, the class ids alone), each class
    row the batch needs once, mapped and n_nodes in, B x TW words out; one
    AND per word of each distinct class of a read."""
    import torch

    B, M = res.nodes.shape
    TW = meta.tx_words
    n = res.n_nodes.long().clamp(max=M)
    used = ((torch.arange(M, device=n.device)[None, :] < n[:, None])
            & (res.nodes >= 0) & res.mapped[:, None])
    if classes is None:
        ec = idx.node_row[res.nodes.clamp(min=0).long(), 3].long()
    else:
        ec = classes.long()
    ec = torch.where(used, ec, -1)
    srt = ec.sort(dim=1).values
    distinct = (srt >= 0) & torch.cat(
        [torch.ones_like(srt[:, :1], dtype=torch.bool),
         srt[:, 1:] != srt[:, :-1]], dim=1)
    n_used, n_rows = int(used.sum()), int(ec[used].unique().numel())
    per_id = 8 if classes is None else 4
    nbytes = per_id * n_used + 4 * TW * n_rows + 5 * B + 4 * B * TW
    return nbytes, int(distinct.sum()) * TW


def unpack_work(args, cfg):
    """K5: the packed arrays in, each slot's (node, offset) pair and, with
    packed keys, its W key words out; a dozen integer operations per slot
    and three per packed high key byte."""
    nbytes = sum(a.nbytes for a in args.values())
    nbytes += 8 * cfg.S + (4 * cfg.W * cfg.S if cfg.pack_keys else 0)
    hb = cfg.PB - 4 if cfg.pack_keys else 0
    return nbytes, cfg.S * (12 + 3 * hb)


def pack_work(codes):
    """K6: the [B, L] codes in at their width (one byte a base for the
    uint8 entry, four for the int32 one), the packed words out; a shift
    and an OR per code."""
    B, L = codes.shape
    return (codes.element_size() * B * L + 4 * B * ((L + 15) // 16),
            2 * B * L)


def route_work(packed, lens, k, read_len, n_shards, cap):
    """K7, route then unscatter: the packed reads and lens in, every slot
    of the send buffers (padding included) and the dropped flags out; the
    returned pairs and their sources in, the [B, P] seed tables out.
    Rolling the k-mers costs 3 operations per base of each position (as in
    K1), hashing (9W + 2) per valid one."""
    B = packed.shape[0]
    P = read_len - k + 1
    W = (2 * k + 31) // 32
    slots = n_shards * cap
    valid = int((lens.long() - k + 1).clamp(min=0, max=P).sum())
    nbytes = (packed.numel() * 4 + B * 4 + slots * 4 * (W + 1) + B + 4
              + slots * 12 + B * P * 8)
    return nbytes, 3 * k * B * P + (9 * W + 2) * valid


def mphf_dynamic_work(queries, shard, n_levels):
    """K8: every query slot read and its result written, plus the shard's
    probe and verify reads counted as in _mphf_work, with the shard's level
    table, over the distinct queries: the zero-key padding of the send
    buffers reads the same few words again and again, and an input byte
    counts once."""
    from types import SimpleNamespace

    import torch

    from pseudoaligner_torch.ops.mphf_lookup import MphfMeta

    m = MphfMeta(*(tuple(int(x) & 0xFFFFFFFF for x in t[:n_levels].tolist())
                   for t in (shard.seeds, shard.masks, shard.word_offsets,
                             shard.key_offsets)))
    nbytes, ops = _mphf_work(
        SimpleNamespace(mphf=m, kmer_words=queries.shape[1]),
        SimpleNamespace(mphf_bits=shard.bits, mphf_ranks=shard.ranks,
                        kmer_keys=shard.keys), torch.unique(queries, dim=0))
    return nbytes + queries.numel() * 4 + queries.shape[0] * 8, ops


def next_hit_work(seed_node):
    """K1's next_hit entry: the [B, P] seed tables and lens in, nh3 out;
    a few compares and selects per position."""
    B, P = seed_node.shape
    return B * P * 8 + B * 4 + B * P * 12, 4 * B * P


def tx_counts_work(bits, n_tx):
    """K9: the [B, TW] bitsets in, the counts out; a shift-and-mask and an
    add per bit."""
    B, TW = bits.shape
    return B * TW * 4 + n_tx * 4, 64 * B * TW


def gwalk_work(meta, kmeta, name, args, before, result=None):
    """One K10 step call, from the walk state `before` it and after it
    (args' st): every lane reads its activity flag and writes its S
    request slots; an active lane also reads its fetched row (48 B) and
    window words, its read's words and state, and writes state and a
    push; init writes the state, the push buffer and both requests;
    finish reads state and buffer and writes the outputs.  Operations: 20
    per active lane and 6 per base matched (a lower bound of the compare)."""
    from pseudoaligner_torch.parallel import graph_walk as gw

    S, M = kmeta.n_shards, meta.max_nodes
    ww, nw = gw.window_words(meta), (meta.read_len + 15) // 16
    B = before.shape[0]
    if name == "init":
        return B * (16 + 4 * gw.NSTATE + 8 * M + 16 * S), 20 * B
    if name == "finish":
        out = sum(getattr(result, f).numel() * getattr(result, f)
                  .element_size() for f in result._fields)
        return B * (4 * gw.NSTATE + 8 * M) + out, 20 * B
    st = args[{"left_a": 4, "left_b": 3, "forward": 6}[name]]
    cov = int((st[:, gw.COV] - before[:, gw.COV]).clamp(min=0).sum())
    if name == "left_a":
        n = int((before[:, gw.L_ACT] != 0).sum())
        return (B * (8 + 8 * S) + n * (28 + 4 * (12 + ww) + 4 * nw),
                20 * n + 6 * cov)
    if name == "left_b":
        n = int((before[:, gw.FOLLOW] >= 0).sum())
        return B * (12 + 8 * S) + n * (48 + 8 + 12), 20 * n
    n = int((before[:, gw.F_ACT] != 0).sum())
    return (B * (12 + 8 * S) + n * (4 * (12 + ww) + 4 * nw + 72),
            20 * n + 6 * cov)


def gfetch_work(recv, ww):
    """K11, one serve call: every request slot read and its response
    written; a valid request's 48-byte row and (ww + 1) pool words read;
    a few operations per word."""
    valid = int((recv[..., 0] >= 0).sum())
    slots = recv.shape[0] * recv.shape[1]
    nbytes = (slots * 8 + slots * (12 + ww) * 4
              + valid * (48 + (4 * (ww + 1) if ww else 0)))
    return nbytes, valid * (12 + 3 * ww)


def lookup_bytes(lookups, S: int, defaults: bool) -> int:
    """A kpart shard's lookup bytes (every shard's are equal): each storage
    once, equal to the separate arrays' bytes (K8's paired words and
    16-byte records at k = 20), and at the default arguments
    LOOKUP_BYTES[S]."""
    got = {lk.nbytes() for lk in lookups}
    arrays = {sum(a.numel() * a.element_size() for a in lk)
              for lk in lookups}
    if len(got) != 1 or got != arrays or (defaults
                                          and got != {LOOKUP_BYTES[S]}):
        raise AssertionError(f"lookup bytes per shard {got}, arrays "
                             f"{arrays}, expected {LOOKUP_BYTES[S]} at S={S}")
    return got.pop()


def host_counts(records, n_tx):
    """Per-transcript counts of reference-style records (the class list
    between the last '[' and the ']' after it)."""
    import numpy as np

    ids = []
    for rec in records:
        inner = rec.rsplit(b"[", 1)[1].split(b"]", 1)[0]
        if inner:
            ids.extend(int(x) for x in inner.split(b", "))
    return np.bincount(np.asarray(ids, dtype=np.int64),
                       minlength=n_tx).astype(np.int32)


def run_cli(argv, out_path):
    """The port's CLI with its standard output sent to out_path;
    (return code, seconds)."""
    from pseudoaligner_torch import cli

    real_stdout = sys.stdout
    t = time.time()
    with open(out_path, "wb") as f:
        sys.stdout = io.TextIOWrapper(f, write_through=True)
        try:
            rc = cli.main(argv)
        finally:
            sys.stdout.flush()
            sys.stdout.detach()
            sys.stdout = real_stdout
    return rc, time.time() - t


def traced(run):
    """(wall seconds, device activities) of run() under the profiler."""
    import torch

    wall = []

    def timed():
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall.append(time.time() - t0)

    events = device_events(timed)
    return wall[0], events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--novel-bases", type=int, default=27_000_000)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--bitset-novel-bases", type=int, default=12_000_000,
                    help="novel bases of phase 11's index, whose transcript "
                         "count must stay within bitset_tx_threshold")
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

    from pseudoaligner_torch import cli, spans
    from pseudoaligner_torch.config import AlignerConfig
    from pseudoaligner_torch.golden import (
        golden_oracle,
        golden_pair_record,
        golden_record,
    )
    from pseudoaligner_torch.models.aligner import Pseudoaligner
    from pseudoaligner_torch.ops import kernels
    from pseudoaligner_torch.ops.map_kernel import (
        device_index_from_image,
        ec_bitset_intersect,
        ec_bitset_intersect_classes,
        lens_link_dtype,
        map_batch,
        map_batch_packed,
        pack_reads_host,
        pack_serving_args,
        packed_tensors,
        seed_tables,
        unpack_index,
        upload,
        walk,
    )
    from pseudoaligner_torch.ops.stats import batch_stats, stats_counts
    from pseudoaligner_torch.singlecell import count_single_cell

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
    # every kernel's state stays in registers and shared memory (a build
    # reused from an earlier run has no report)
    local = local_memory(kernels.build_log)
    if any(sum(v) for v in local.values()):
        raise AssertionError(f"local memory (stack, spill stores, spill "
                             f"loads) in the kernels: {local}")
    say(f"ptxas: no stack frame or spill in the {len(local)} kernels")

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
    lens_np = np.full(BATCH, READ_LEN, dtype=np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    packed = [torch.from_numpy(pack_reads_host(
        reads[b * BATCH:(b + 1) * BATCH]).view(np.int32)).to(dev)
        for b in range(n_b)]

    def serve_init(mode: str):
        cfg = cli.serving_config(20, BATCH, READ_LEN, seed_index=mode)
        spans.reset()
        t = time.time()
        al = Pseudoaligner(image, cfg, device="cuda")
        torch.cuda.synchronize()
        split = spans.snapshot()["spans"]
        # each storage once (the MPHF's paired bit and rank words) is the
        # arrays' bytes: the paired layout adds none
        arrays = sum(getattr(al.dev, f.name).numel() * 4
                     for f in dataclasses.fields(al.dev))
        if al.dev.nbytes() != arrays:
            raise AssertionError(f"[{mode}] upload {al.dev.nbytes()} B, its "
                                 f"arrays {arrays} B")
        say(f"[{mode}] serve init (device index build + upload) "
            f"{time.time() - t:.1f} s; index device bytes {al.dev.nbytes()}"
            "; spans, s (self s): " + ", ".join(
                f"{k} {v['total_s']:.3f} ({v['self_s']:.3f})"
                for k, v in sorted(split.items())))
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

    ms, traced_ms = {}, {}

    def time_pair(name, f, reps, sym, n=n_b, per_call=1, each=None):
        """Time f over rotating batches by both methods: ms[name] is the
        held-event time, which every row has, so rows compare by one
        method; traced_ms[name] is the trace's device time with the
        launches of `sym` it saw and the per_call * reps it should have
        (a trace of a short window may drop launches).  With `each`, the
        calls f makes one by one, the held time is theirs, each timed
        alone and summed: the gaps between f's launches stay out of it.
        Returns the held time of each of `each`."""
        span = span_ms(rotating(f, n), reps)
        dev_ms, seen = device_ms(rotating(f, n), reps, sym)
        if each is None:
            per = [held_ms(rotating(f, n), reps)]
            how = "CUDA events around each call"
        else:
            per = held_each_ms(each, reps)
            how = f"CUDA events around each of its {len(each)} calls, summed"
        held = sum(per)
        what = (f"kernel {sym}, {seen} launches seen of {reps * per_call}"
                if sym else f"all device activity, {seen} activities")
        say(f"ms per {BATCH}-read batch, {name}: device {dev_ms} ({what}, "
            f"traced), held {held} ({how}, device held busy meanwhile), "
            f"span {span} (back-to-back calls, CUDA events)")
        ms[name] = held
        traced_ms[name] = (dev_ms, seen, reps * per_call if sym else None)
        return per

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
            spans.reset()
            t = time.time()
            n_emit, _ = al.emit_fastq(fq_path, sink)
            dt = time.time() - t
            if n_emit != n_reads:
                raise AssertionError(f"emitted {n_emit} of {n_reads} reads")
            snap = spans.snapshot()
            say(f"[{mode}] serving emit loop (FASTQ parse to records, no "
                f"set-up): {n_reads / dt:.0f} reads/s, {dt * 1000 / n_b:.2f}"
                " ms per batch; spans, ms per batch: " + ", ".join(
                    f"{k} {v['total_s'] * 1000 / n_b:.2f}"
                    for k, v in sorted(snap["spans"].items()))
                + "; per batch: " + ", ".join(
                    f"{k} {snap['counters'].get(k, 0) / n_b:.1f}"
                    for k in ("pa.pinned_allocs", "pa.pinned_bytes")))
            wall, events = traced(lambda: al.emit_fastq(fq_path, sink))
        per = {"H2D": 0.0, "K1": 0.0, "K2": 0.0, "D2H": 0.0, "other": 0.0}
        for name, s0, e0 in events:
            cat = ("H2D" if name.startswith("Memcpy HtoD") else
                   "D2H" if name.startswith("Memcpy DtoH") else
                   "K1" if "seed_kernel" in name else
                   "K2" if "walk_kernel" in name else "other")
            per[cat] += e0 - s0
        busy = busy_us(events) / 1e6
        say(f"[{mode}] serving loop traced: wall {wall:.4f} s, device "
            f"busy {busy:.6f} s ({100 * busy / wall:.3f}%, idle "
            f"{100 - 100 * busy / wall:.3f}%); device ms per batch: " +
            ", ".join(f"{k} {v / 1000 / n_b:.4f}" for k, v in per.items()))

    def launch_counts():
        return {"seed": kernels.seed_tables_cuda.launches,
                "walk": kernels.walk_cuda.launches,
                "stats": kernels.stats_cuda.launches,
                "ec_bits": kernels.ec_bits_cuda.launches,
                "unpack": kernels.unpack_index_cuda.launches,
                "pack": kernels.pack_reads_u8_cuda.launches,
                "pack_i32": kernels.pack_reads_i32_cuda.launches,
                "route": kernels.route_cuda.launches,
                "unscatter": kernels.unscatter_cuda.launches,
                "mphf_dynamic": kernels.mphf_dynamic_cuda.launches,
                "next_hit": kernels.next_hit_cuda.launches,
                "tx_counts": kernels.tx_counts_cuda.launches,
                "ec_bits_classes": kernels.ec_bits_classes_cuda.launches,
                "gwalk": sum(f.launches for f in kernels.GWALK_WRAPPERS),
                "gfetch": kernels.gfetch_cuda.launches}

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
    err["walk_full"] = compare_results(
        full_k, walk(meta_full, idx, packed[0], lens, nh3[0]),
        "walk kernel (full output)")
    torch.cuda.synchronize()
    say(f"[cuckoo] kernel == plain, tolerance 0: seed and walk (serving "
        f"shape) on all {n_b} batches of {BATCH} reads; walk full output "
        f"(nodes {tuple(full_k.nodes.shape)}) on batch 0")
    # the tensor entry on int32 codes: K6's int32 entry packs them on the
    # card, then K1 and K2 as on the host-packed batches
    kernels.reset_launch_counts()
    for b in range(min(MODE_BATCHES, n_b)):
        c32 = torch.from_numpy(reads[b * BATCH:(b + 1) * BATCH].astype(
            np.int32)).to(dev)
        compare_results(map_batch(meta, idx, c32, lens),
                        map_batch_packed(meta, idx, packed[b], lens),
                        f"map_batch on int32 codes, batch {b}")
    torch.cuda.synchronize()
    tensor_launches = launch_counts()
    if tensor_launches["pack_i32"] < 1 or tensor_launches["pack"]:
        raise AssertionError(f"map_batch on int32 codes: launches "
                             f"{tensor_launches}")
    say(f"[cuckoo] map_kernel.map_batch on int32 code tensors == "
        f"map_batch_packed on the host-packed batches, every MapResult "
        f"field; launches {tensor_launches}")
    # the bounds of the work the timed calls below do, batch by batch
    bounds = {
        "seed": bound([seed_work(meta, idx, pk, lens) for pk in packed]),
        "walk": bound([walk_work(pk, kernels.walk_cuda(
            meta, idx, pk, lens, nh3[b])) for b, pk in enumerate(packed)]),
        "walk_full": bound([walk_work(pk, kernels.walk_cuda(
            meta_full, idx, pk, lens, nh3[b]))
            for b, pk in enumerate(packed)])}
    say(f"[cuckoo] walk bound ms per batch: serving {bounds['walk'][0]} "
        f"({bounds['walk'][1]}), full output {bounds['walk_full'][0]} "
        f"({bounds['walk_full'][1]})")
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
    launches, outs = {"tensor": tensor_launches}, {}
    for mode in ("cuckoo", "bucket1", "mphf"):
        out_path = os.path.join(work, f"map_{mode}.out")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, dt = run_cli(["map", "-i", idx_path, fq_path, "--batch-size",
                          str(BATCH), "--max-read-len", str(READ_LEN),
                          "--device", "cuda", "--seed-index", mode], out_path)
        launches[mode] = launch_counts()
        if rc != 0:
            raise AssertionError(f"map CLI ({mode}) returned {rc}")
        # the cuckoo tables pass the default gate of the packed upload
        need = ("seed", "walk") + (("unpack",) if mode == "cuckoo"
                                   and defaults else ())
        if min(launches[mode][k] for k in need) < 1:
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
    launches["stats"] = launch_counts()
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

    # ---- 8. the bit-packed upload of the cuckoo tables (K5) ----
    cfg = cli.serving_config(20, BATCH, READ_LEN)
    dev_np, meta = device_index_from_image(image, cfg)
    t = time.time()
    pargs, pcfg = pack_serving_args(dev_np, meta)
    t_pack = time.time() - t
    ptens = packed_tensors(pargs, dev)
    k5 = kernels.unpack_index_cuda(ptens, pcfg)
    p5 = unpack_index(ptens, pcfg)
    plain = upload(dev_np, dev, serving=meta, pack=False)
    err["unpack"] = max(max_abs_diff(a, b) for a, b in zip(k5, p5))
    for a, b in zip(k5, (plain.cuckoo, plain.cuckoo_vals)):
        if err["unpack"] or max_abs_diff(a, b):
            raise AssertionError("unpack kernel, plain unpack and plain "
                                 "upload disagree")
    torch.cuda.synchronize()
    link_plain = (np.asarray(dev_np.cuckoo).nbytes
                  + np.asarray(dev_np.cuckoo_vals).nbytes)
    link_packed = sum(a.nbytes for a in pargs.values())
    say(f"[packed upload] unpack kernel == plain unpack == plain upload, "
        f"tolerance 0, over {pcfg.S} slots (node_bits {pcfg.node_bits}, "
        f"off_bits {pcfg.off_bits}, keys packed {pcfg.pack_keys}); cuckoo "
        f"bytes on the link: packed {link_packed}, plain {link_plain} "
        f"({link_packed / link_plain:.4f}); host pack {t_pack:.3f} s")
    del k5, p5, plain
    up_s, up_bytes = {True: [], False: []}, set()
    for pack in (False, True, True, False):  # in turns
        torch.cuda.synchronize()
        t = time.time()
        up = upload(dev_np, dev, serving=meta, pack=pack)
        torch.cuda.synchronize()
        up_s[pack].append(time.time() - t)
        up_bytes.add(up.nbytes())
        del up
    if len(up_bytes) != 1:
        raise AssertionError(f"packed and plain device bytes {up_bytes}")
    say(f"[packed upload] upload (host pack, H2D, unpack) in turns plain, "
        f"packed, packed, plain: packed {up_s[True]} s, plain {up_s[False]}"
        f" s")
    bounds["unpack"] = bound([unpack_work(pargs, pcfg)])
    time_pair("unpack", lambda i: kernels.unpack_index_cuda(ptens, pcfg),
              n_b, "unpack_index_kernel", 1)
    time_pair("unpack_plain", lambda i: unpack_index(ptens, pcfg), 2, None,
              1)
    del ptens, pargs, dev_np

    # ---- 9. paired-end map ----
    n_pairs = n_reads // 2
    p_paths = [os.path.join(work, f"pairs_{m}.fq") for m in (1, 2)]
    t = time.time()
    mates = pair_reads(seqs, n_pairs, READ_LEN, args.seed + 5)
    for path, m in zip(p_paths, mates):
        write_fastq(path, m)
    say(f"pairs: {n_pairs} x 2 x {READ_LEN} written in {time.time() - t:.1f}"
        " s")
    kernels.reset_launch_counts()
    pout = os.path.join(work, "map_paired.out")
    rc, dt = run_cli(["map", "-i", idx_path, *p_paths, "--batch-size",
                      str(BATCH), "--max-read-len", str(READ_LEN),
                      "--device", "cuda"], pout)
    launches["paired"] = launch_counts()
    if rc != 0 or min(launches["paired"][k] for k in ("seed", "walk")) < 1:
        raise AssertionError(f"paired map CLI returned {rc}, launches "
                             f"{launches['paired']}")
    with open(pout, "rb") as f:
        plines = f.read().splitlines()
    if len(plines) != n_pairs:
        raise AssertionError(f"{len(plines)} paired records for {n_pairs}")
    say(f"[paired] map CLI end to end: {dt:.2f} s, {n_pairs / dt:.0f} "
        f"pairs/s; launches {launches['paired']}")
    al = Pseudoaligner(image, cfg, device="cuda")
    with open(os.devnull, "wb") as sink:
        al.emit_fastq_paired(*p_paths, sink)  # warm the host caches
        t = time.time()
        al.emit_fastq_paired(*p_paths, sink)
        dt = time.time() - t
        wall, events = traced(lambda: al.emit_fastq_paired(*p_paths, sink))
        busy = busy_us(events) / 1e6
    al.close()
    del al
    say(f"[paired] serving loop (no set-up): {n_pairs / dt:.0f} pairs/s, "
        f"{dt * 1000 / n_b:.2f} ms per 32,768-pair batch; traced: wall "
        f"{wall:.4f} s, device busy {busy:.6f} s ({100 * busy / wall:.3f}%)")
    t = time.time()
    psample = np.unique(np.linspace(0, n_pairs - 1, N_GOLDEN).astype(
        np.int64))
    for i in psample:
        want = golden_pair_record(oracle, f"r{i}", mates[0][i], mates[1][i],
                                  cfg).encode()
        if plines[i] != want:
            raise AssertionError(f"pair {i}: {plines[i]!r} != {want!r}")
    say(f"[paired] golden oracle: {len(psample)} sampled pairs "
        f"byte-identical ({time.time() - t:.1f} s)")
    del mates, plines

    # ---- 10. single-cell count ----
    c_paths = [os.path.join(work, f"count_{m}.fq") for m in (1, 2)]
    c4_paths = [os.path.join(work, f"count4_{m}.fq") for m in (1, 2)]
    t = time.time()
    creads = count_reads(seqs, n_reads, READ_LEN, args.seed + 7)
    for path, path4, r in zip(c_paths, c4_paths, creads):
        write_fastq(path, r)
        write_fastq(path4, r[:MODE_BATCHES * BATCH])
    del creads, seqs
    say(f"count inputs: {n_reads} R1/R2 pairs written in "
        f"{time.time() - t:.1f} s")
    kernels.reset_launch_counts()
    cdir = os.path.join(work, "count_out")
    rc, dt = run_cli(["count", "-i", idx_path, *c_paths, "-o", cdir,
                      "--batch-size", str(BATCH), "--max-read-len",
                      str(READ_LEN), "--device", "cuda"],
                     os.path.join(work, "count.out"))
    launches["count"] = launch_counts()
    if rc != 0 or min(launches["count"][k] for k in ("seed", "walk")) < 1:
        raise AssertionError(f"count CLI returned {rc}, launches "
                             f"{launches['count']}")
    with open(os.path.join(cdir, "matrix.mtx")) as f:
        mtx_head = f.read(4096).splitlines()[2]
    say(f"[count] count CLI end to end: {dt:.2f} s, {n_reads / dt:.0f} "
        f"pairs/s; launches {launches['count']}; matrix cells x classes x "
        f"entries {mtx_head}")
    summary = {}
    for path, ccfg in (("batched", cfg), ("records", AlignerConfig(
            k=20, batch_size=BATCH, max_read_len=READ_LEN, distinct_cap=0))):
        al = Pseudoaligner(image, ccfg, device="cuda")
        t = time.time()
        c = count_single_cell(al, *c4_paths)
        dt = time.time() - t
        al.close()
        summary[path] = (c.cells, c.classes, c.entry_counts(),
                         c.entry_counts("directional"), c.n_reads,
                         c.n_mapped, c.n_corrected)
        say(f"[count] {path} path over {MODE_BATCHES} batches: {dt:.2f} s; "
            f"{len(c.cells)} cells, {len(c.classes)} classes, {c.n_mapped} "
            f"of {c.n_reads} mapped, {c.n_corrected} barcodes folded")
    if summary["batched"] != summary["records"]:
        raise AssertionError("count: batched and record paths disagree")
    say("[count] batched == records: cells, classes, both entry_counts")

    # ---- 11. the bitset EC path (K4) on a second index ----
    fa12 = os.path.join(work, "transcripts_bitset.fa")
    idx12_path = os.path.join(work, "index_bitset.bin")
    fq12 = os.path.join(work, "reads_bitset.fq")
    b12_paths = [os.path.join(work, f"count_bitset_{m}.fq") for m in (1, 2)]
    t = time.time()
    seqs12, names12, gmap12 = scale_seqs(args.bitset_novel_bases, args.seed)
    write_fasta(fa12, seqs12, names12, gmap12)
    if cli.main(["index", "-i", idx12_path, fa12, "-n",
                 str(os.cpu_count())]) != 0:
        raise AssertionError("index CLI failed (bitset index)")
    image12 = cli.open_index(idx12_path)
    n12 = MODE_BATCHES * BATCH
    reads12 = recipe_reads(seqs12, n12, READ_LEN, args.seed + 9)
    write_fastq(fq12, reads12)
    for path, r in zip(b12_paths, count_reads(seqs12, n12, READ_LEN,
                                              args.seed + 11)):
        write_fastq(path, r)
    del seqs12
    cfg12 = AlignerConfig(k=20, batch_size=BATCH, max_read_len=READ_LEN,
                          distinct_cap=0)
    al = Pseudoaligner(image12, cfg12, device="cuda")
    meta12, idx12 = al.meta, al.dev
    n_tx = len(image12.tx_names)
    if meta12.tx_words != (n_tx + 31) // 32 or meta12.tx_words < 1:
        raise AssertionError(f"{n_tx} transcripts, tx_words "
                             f"{meta12.tx_words}: the bitset path is off")
    say(f"[bitset] index: {n_tx} transcripts, {image12.n_ecs} classes, "
        f"{image12.mphf.n_keys} k-mers, TW {meta12.tx_words}, ec_bits "
        f"{idx12.ec_bits.numel() * 4} bytes; built with its reads in "
        f"{time.time() - t:.1f} s")
    packed12 = [torch.from_numpy(pack_reads_host(
        reads12[b * BATCH:(b + 1) * BATCH]).view(np.int32)).to(dev)
        for b in range(MODE_BATCHES)]
    walks = []
    err["ec_bits"] = 0
    for pk in packed12:
        nh3 = kernels.seed_tables_cuda(meta12, idx12, pk, lens)
        w = kernels.walk_cuda(meta12, idx12, pk, lens, nh3)
        err["ec_bits"] = max(err["ec_bits"], max_abs_diff(
            kernels.ec_bits_cuda(meta12, idx12, w.nodes, w.n_nodes,
                                 w.mapped),
            ec_bitset_intersect(meta12, idx12, w.nodes, w.n_nodes,
                                w.mapped)))
        if err["ec_bits"]:
            raise AssertionError(f"bitset kernel differs by up to "
                                 f"{err['ec_bits']}")
        walks.append(w)
    torch.cuda.synchronize()
    say(f"[bitset] bitset kernel == plain, tolerance 0, on {MODE_BATCHES} "
        f"batches of {BATCH} reads (nodes {tuple(walks[0].nodes.shape)})")
    bounds["ec_bits"] = bound([ecbits_work(meta12, idx12, w) for w in walks])
    time_pair("ec_bits", lambda i: kernels.ec_bits_cuda(
        meta12, idx12, walks[i].nodes, walks[i].n_nodes, walks[i].mapped),
        n_b, "ec_bits_kernel", MODE_BATCHES)
    time_pair("ec_bits_plain", lambda i: ec_bitset_intersect(
        meta12, idx12, walks[i].nodes, walks[i].n_nodes, walks[i].mapped),
        2, None, MODE_BATCHES)
    del walks, packed12
    kernels.reset_launch_counts()
    t = time.time()
    c12 = count_single_cell(al, *b12_paths)
    dt = time.time() - t
    on_count = launch_counts()
    kernels.reset_launch_counts()
    t2 = time.time()
    recs = [r.format_reference_style().encode() for r in al.map_fastq(fq12)]
    dt2 = time.time() - t2
    on_map = launch_counts()
    al.close()
    del al
    launches["bitset"] = {k: on_count[k] + on_map[k] for k in on_count}
    if min(on_count["ec_bits"], on_map["ec_bits"]) < 1 or len(recs) != n12:
        raise AssertionError(f"bitset record paths: launches {on_count}, "
                             f"{on_map}; {len(recs)} records of {n12}")
    say(f"[bitset] count_single_cell (record path) over {n12} pairs: "
        f"{dt:.2f} s, {n12 / dt:.0f} pairs/s, {len(c12.cells)} cells, "
        f"{len(c12.classes)} classes; launches {on_count}")
    say(f"[bitset] map_fastq (record path) over {n12} reads: {dt2:.2f} s, "
        f"{n12 / dt2:.0f} reads/s; launches {on_map}")
    oracle12 = golden_oracle(image12)
    t = time.time()
    sample12 = np.unique(np.linspace(0, n12 - 1, N_GOLDEN).astype(np.int64))
    for i in sample12:
        want = golden_record(oracle12, f"r{i}", reads12[i], cfg12).encode()
        if recs[i] != want:
            raise AssertionError(f"bitset record {i}: {recs[i]!r} != "
                                 f"{want!r}")
    say(f"[bitset] golden oracle: {len(sample12)} sampled map_fastq records "
        f"byte-identical ({time.time() - t:.1f} s)")

    # ---- 12. multi-device on one card ----
    import socket

    import torch.distributed as dist

    from pseudoaligner_torch.ops.map_kernel import (
        next_hit_table,
        pack_reads_device,
    )
    from pseudoaligner_torch.ops.mphf_lookup import dynamic_verified_lookup
    from pseudoaligner_torch.parallel import sharded_index as si
    from pseudoaligner_torch.parallel.comm import DistExchange
    from pseudoaligner_torch.parallel.dryrun import dryrun_multichip
    from pseudoaligner_torch.parallel.mesh import (
        ShardedAligner,
        make_mesh,
        tx_compat_counts,
    )
    from pseudoaligner_torch.parallel.multihost import map_fastq_multihost

    # a real NCCL process group of one process on this card
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        nccl_port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{nccl_port}",
                            world_size=1, rank=0)
    mesh1 = make_mesh(1)
    if not isinstance(mesh1, DistExchange) or mesh1.device != dev:
        raise AssertionError(f"expected the NCCL group's mesh, got {mesh1}")
    say(f"[multi] NCCL group: backend {dist.get_backend()}, world size "
        f"{dist.get_world_size()}, device {mesh1.device}")
    cfg_s = cli.serving_config(20, BATCH, READ_LEN)
    t = time.time()
    kp = si.KmerPartitionedAligner(image, cfg_s, mesh1)
    torch.cuda.synchronize()
    km = kp.kmeta
    lk_bytes = lookup_bytes(kp.lookups, 1, defaults)
    say(f"[multi] kpart S=1 set-up (sharded lookup build, graph and lookup "
        f"upload) {time.time() - t:.1f} s: {km.n_levels} levels, cap "
        f"{km.cap} per destination, lookup bytes per shard {lk_bytes}, "
        f"graph bytes {kp.dev.nbytes()}")

    # (a) the new kernels against their plain versions, tolerance 0; K6's
    # two entries on the same codes at one byte a base (as they cross the
    # kpart link) and at four, each also against the host pack
    rows = [np.ascontiguousarray(reads[b * BATCH:(b + 1) * BATCH],
                                 dtype=np.uint8) for b in range(MODE_BATCHES)]
    codes = {"pack": [torch.from_numpy(r).to(dev) for r in rows],
             "pack_i32": [torch.from_numpy(r.astype(np.int32)).to(dev)
                          for r in rows]}
    pack_entry = {"pack": kernels.pack_reads_u8_cuda,
                  "pack_i32": kernels.pack_reads_i32_cuda}
    for key, cs in codes.items():
        err[key] = 0
        for b, c in enumerate(cs):
            got = pack_entry[key](c)
            err[key] = max(err[key], max_abs_diff(got, pack_reads_device(c)),
                           max_abs_diff(got, packed[b]))
        if err[key]:
            raise AssertionError(f"{key} kernel differs by up to {err[key]}")
    # the kpart link: the codes map_batch ships per batch, and the host's
    # time to ship them (narrow, pin, start the copy) against the int32
    # codes the path shipped before and against packing on the host
    ldt = lens_link_dtype(READ_LEN)
    link_bytes, link_ms = [], {"uint8": 0.0, "int32": 0.0, "host pack": 0.0}
    for r in rows:
        for how in link_ms:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if how == "uint8":
                cs, _ = kp.link_batch(r, lens_np)
            elif how == "int32":
                cs, _ = si.shard_batch(np.asarray(r).astype(np.int32),
                                       np.asarray(lens_np).astype(ldt), mesh1)
            else:
                pack_reads_host(r)
            link_ms[how] += (time.perf_counter() - t) * 1000 / len(rows)
            if how == "uint8":
                link_bytes.append(sum(c.numel() * c.element_size()
                                      for c in cs))
                if [c.dtype for c in cs] != [torch.uint8]:
                    raise AssertionError(f"kpart link codes {cs}")
    if link_bytes != [BATCH * READ_LEN] * len(rows):
        raise AssertionError(f"kpart link bytes per batch {link_bytes}")
    err["route"] = 0
    P_ = READ_LEN - 20 + 1
    for S in (1, 2, 4, 8):
        # shard 0's rows of a batch, at the aligner's capacity for S shards
        b_loc = BATCH // S
        cap = (max(64, int(4.0 * b_loc * P_ / S)) + 7) // 8 * 8
        for b in range(MODE_BATCHES if S == 1 else 1):
            pk, ln = packed[b][:b_loc], lens[:b_loc]
            got = kernels.route_cuda(pk, ln, 20, READ_LEN, S, cap)
            want = si.route_queries(pk, ln, 20, READ_LEN, S, cap)
            # any returned pairs do for the unscatter: the first key words
            # and the sources themselves
            back = torch.stack([got[0][:, :, 0], got[1]], -1).reshape(-1, 2)
            src = got[1].reshape(-1)
            err["route"] = max([err["route"]] + [
                max_abs_diff(x, y) for x, y in zip(got, want)] + [
                max_abs_diff(x, y) for x, y in zip(
                    kernels.unscatter_cuda(back, src, b_loc, P_),
                    si.unscatter_seeds(back, src, b_loc, P_))])
            if err["route"]:
                raise AssertionError(f"route kernels differ at S={S}, batch "
                                     f"{b} by up to {err['route']}")
    say(f"[multi] pack kernel, uint8 and int32 entries, == plain == host pack"
        f" on {MODE_BATCHES} batches; route and unscatter kernels == plain "
        f"at S = 1 ({MODE_BATCHES} batches), 2, 4, 8 (shard 0's rows), "
        "tolerance 0")
    shard = kp.lookups[0]
    # K1 probing the whole MPHF gives the table the routed seeds must give
    mcfg = dataclasses.replace(cfg_s, seed_index="mphf")
    mdev_np, mmeta = device_index_from_image(image, mcfg)
    mdev = upload(mdev_np, dev, serving=mmeta)
    del mdev_np
    rq, srcs, seeds_k = [], [], []
    err["mphf_dynamic"] = err["next_hit"] = 0
    for b in range(MODE_BATCHES):
        q, src, _over, _drop = kernels.route_cuda(packed[b], lens, 20,
                                                  READ_LEN, 1, km.cap)
        q = q.reshape(km.cap, -1)
        res = kernels.mphf_dynamic_cuda(q, shard, km.n_levels)
        err["mphf_dynamic"] = max(err["mphf_dynamic"], max_abs_diff(
            res, dynamic_verified_lookup(q, shard, km.n_levels)))
        node, off = kernels.unscatter_cuda(res, src.reshape(-1), BATCH, P_)
        nh = kernels.next_hit_cuda(node, off, lens, 20)
        err["next_hit"] = max(
            err["next_hit"],
            max_abs_diff(nh, next_hit_table(node, off, lens, 20, P_)),
            max_abs_diff(nh, kernels.seed_tables_cuda(mmeta, mdev,
                                                      packed[b], lens)))
        if err["mphf_dynamic"] or err["next_hit"]:
            raise AssertionError(f"mphf_dynamic {err['mphf_dynamic']}, "
                                 f"next_hit {err['next_hit']} on batch {b}")
        rq.append(q)
        srcs.append(src.reshape(-1))
        seeds_k.append((node, off))
    del mdev
    # the send buffers' padding is the all-zero query, which K8 probes once
    # per block: where poly-A is not a key (this index) and, on a small
    # lookup of a transcript set with a poly-A run, where it is
    from pseudoaligner_torch.index.builder import build_index

    rng = np.random.default_rng(args.seed + 5)
    pa_seqs = [rng.integers(0, 4, 2000).astype(np.uint8) for _ in range(50)]
    pa_seqs.append(np.zeros(300, np.uint8))
    pa_names = [f"pa{i}" for i in range(len(pa_seqs))]
    pa_image = build_index(pa_seqs, pa_names, {n: "g" for n in pa_names},
                           k=20)
    polya = [bool(np.all(im.kmer_keys == 0, axis=1).any())
             for im in (image, pa_image)]
    if polya != [False, True]:
        raise AssertionError(f"poly-A a key of (index, small set): {polya}")
    pa_np, pa_levels = si.build_sharded_lookup(pa_image, 1)
    pa_shard = si.upload_lookup(pa_np, 0, dev)
    pa_keys = pa_image.kmer_keys[rng.permutation(len(pa_image.kmer_keys))]
    pa_q = np.zeros((4 * len(pa_keys), pa_keys.shape[1]), np.uint32)
    pa_q[:len(pa_keys)] = pa_keys
    pa_q = torch.from_numpy(pa_q.view(np.int32)).to(dev)
    pa_res = kernels.mphf_dynamic_cuda(pa_q, pa_shard, pa_levels)
    err["mphf_dynamic"] = max(err["mphf_dynamic"], max_abs_diff(
        pa_res, dynamic_verified_lookup(pa_q, pa_shard, pa_levels)))
    if err["mphf_dynamic"] or not bool((pa_res[len(pa_keys):, 0] >= 0).all()):
        raise AssertionError(f"mphf_dynamic on the poly-A buffer: differs by "
                             f"{err['mphf_dynamic']} or padding missed")
    del pa_shard, pa_q, pa_res
    torch.cuda.synchronize()
    say(f"[multi] mphf_dynamic kernel == plain over {km.cap} queries per "
        f"batch ({MODE_BATCHES} batches, S = 1; poly-A not a key) and over "
        f"{4 * len(pa_keys)} queries, three quarters zero padding, of a "
        f"{len(pa_keys)}-key lookup whose keys hold poly-A; next_hit kernel "
        "== plain == K1's table over the whole MPHF; tolerance 0")
    bounds["pack"] = bound([pack_work(c) for c in codes["pack"]])
    bounds["pack_i32"] = bound([pack_work(c) for c in codes["pack_i32"]])
    bounds["route"] = bound([route_work(packed[b], lens, 20, READ_LEN, 1,
                                        km.cap) for b in range(MODE_BATCHES)])
    bounds["mphf_dynamic"] = bound([mphf_dynamic_work(q, shard, km.n_levels)
                                    for q in rq])
    bounds["next_hit"] = bound([next_hit_work(n) for n, _ in seeds_k])
    backs = [kernels.mphf_dynamic_cuda(q, shard, km.n_levels) for q in rq]
    for key, sym in (("pack", "pack_u8_kernel"),
                     ("pack_i32", "pack_i32_kernel")):
        time_pair(key, lambda i, k=key: pack_entry[k](codes[k][i]), n_b, sym,
                  MODE_BATCHES)
        time_pair(f"{key}_plain", lambda i, k=key: pack_reads_device(
            codes[k][i]), 4, None, MODE_BATCHES)
    floor = held_ms(lambda: torch.cuda._sleep(1), n_b)
    say(f"[multi] kpart link per {BATCH}-read batch: codes {link_bytes[0]} B "
        f"(uint8; {4 * link_bytes[0]} B as int32); host ms per batch to ship "
        f"them (narrow, pin, start the copy): uint8 {link_ms['uint8']}, "
        f"int32 {link_ms['int32']}; the native host pack (pack_reads_host) "
        f"{link_ms['host pack']} ms per batch, against K6 uint8 "
        f"{ms['pack']} held (bound {bounds['pack'][0]}, int32 entry "
        f"{ms['pack_i32']}, bound {bounds['pack_i32'][0]}; a one-thread "
        f"kernel holds {floor} by the same method)")
    time_pair("route_only", lambda i: kernels.route_cuda(
        packed[i], lens, 20, READ_LEN, 1, km.cap), n_b, None, MODE_BATCHES)
    time_pair("unscatter", lambda i: kernels.unscatter_cuda(
        backs[i], srcs[i], BATCH, P_), n_b, None, MODE_BATCHES)
    time_pair("route_only_plain", lambda i: si.route_queries(
        packed[i], lens, 20, READ_LEN, 1, km.cap), 2, None, MODE_BATCHES)
    time_pair("unscatter_plain", lambda i: si.unscatter_seeds(
        backs[i], srcs[i], BATCH, P_), 2, None, MODE_BATCHES)
    for key in ("route", "route_plain"):  # route and unscatter together
        a, u = f"route_only{key[5:]}", f"unscatter{key[5:]}"
        ms[key] = ms[a] + ms[u]
        (ta, na, _), (tu, nu, _) = traced_ms[a], traced_ms[u]
        traced_ms[key] = (ta + tu if ta is not None and tu is not None
                          else None, na + nu, None)
    time_pair("mphf_dynamic", lambda i: kernels.mphf_dynamic_cuda(
        rq[i], shard, km.n_levels), n_b, "mphf_dynamic_kernel", MODE_BATCHES)
    time_pair("mphf_dynamic_plain", lambda i: dynamic_verified_lookup(
        rq[i], shard, km.n_levels), 2, None, MODE_BATCHES)
    time_pair("next_hit", lambda i: kernels.next_hit_cuda(
        *seeds_k[i], lens, 20), n_b, "next_hit_kernel", MODE_BATCHES)
    time_pair("next_hit_plain", lambda i: next_hit_table(
        *seeds_k[i], lens, 20, P_), 2, None, MODE_BATCHES)
    del codes, rq, srcs, seeds_k, backs

    # (b) the kpart serving aligner through the NCCL group: every batch of
    # the file, bytes equal to the phase-6 cuckoo CLI output
    srv = kp.serving_aligner()
    with open(os.devnull, "wb") as sink:  # warm the host caches
        srv.emit_fastq(fq_path, sink)
    kernels.reset_launch_counts()
    buf = io.BytesIO()
    torch.cuda.synchronize()
    t = time.time()
    n_emit, _ = srv.emit_fastq(fq_path, buf)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches["kpart"] = launch_counts()
    need = ("pack", "route", "unscatter", "mphf_dynamic", "next_hit", "walk")
    # the codes crossed the link as uint8: K6's uint8 entry packed them
    if min(launches["kpart"][k] for k in need) < 1 or launches["kpart"][
            "pack_i32"]:
        raise AssertionError(f"a kernel never launched on the kpart path: "
                             f"{launches['kpart']}")
    if n_emit != n_reads or buf.getvalue() != outs["cuckoo"]:
        raise AssertionError("kpart serving emit differs from the cuckoo CLI "
                             "output")
    say(f"[multi] kpart serving emit (S=1, NCCL) over {n_reads} reads: "
        f"{dt:.2f} s, {n_reads / dt:.0f} reads/s; byte-identical to the "
        f"phase-6 cuckoo CLI output; launches {launches['kpart']}")
    kpart_rate, rep_graph_bytes = n_reads / dt, kp.dev.nbytes()
    srv.close()
    del srv, kp, buf

    # (c) four loopback shards on this card: MapResults == the replicated
    # engine's (same config, lazy seeds off as kpart forces)
    cfg_eager = dataclasses.replace(cfg_s, lazy_seeds=False)
    t = time.time()
    kp4 = si.KmerPartitionedAligner(image, cfg_eager,
                                    make_mesh(4, loopback=True))
    torch.cuda.synchronize()
    say(f"[multi] kpart S=4 (loopback) set-up {time.time() - t:.1f} s: cap "
        f"{kp4.kmeta.cap}, lookup bytes per shard "
        f"{lookup_bytes(kp4.lookups, 4, defaults)}")
    base = Pseudoaligner(image, cfg_eager, device="cuda")
    for b in range(MODE_BATCHES):
        rows = reads[b * BATCH:(b + 1) * BATCH]
        got, _ = kp4.map_batch(rows, lens_np)
        compare_results(got, base.map_batch_device(rows, lens_np),
                        f"kpart S=4, batch {b}")
    torch.cuda.synchronize()
    base.close()
    del kp4, base
    say(f"[multi] kpart S=4 loopback == replicated engine, every MapResult "
        f"field, on {MODE_BATCHES} batches")

    # (d) the data-parallel engine on the bitset index through the NCCL
    # group: counts (K9, all_reduce) == a host recount of K4's bitsets
    sa = ShardedAligner(image12, cfg12, mesh1)
    kernels.reset_launch_counts()
    dp_res = []
    for b in range(MODE_BATCHES):
        res, counts = sa.map_batch(reads12[b * BATCH:(b + 1) * BATCH],
                                   lens_np)
        bits = res.ec_bits.view(torch.int32).cpu().numpy()
        want = np.unpackbits(bits.view(np.uint8), axis=1,
                             bitorder="little")[:, :n_tx].sum(0)
        if not np.array_equal(counts.cpu().numpy(), want.astype(np.int32)):
            raise AssertionError(f"ShardedAligner counts differ on batch {b}")
        dp_res.append(res.ec_bits.view(torch.int32))
    launches["sharded"] = launch_counts()
    if min(launches["sharded"][k] for k in ("seed", "walk", "ec_bits",
                                             "tx_counts")) < 1:
        raise AssertionError(f"a kernel never launched on the data-parallel "
                             f"path: {launches['sharded']}")
    err["tx_counts"] = max(max_abs_diff(kernels.tx_counts_cuda(x, n_tx),
                                        tx_compat_counts(x, n_tx))
                           for x in dp_res)
    if err["tx_counts"]:
        raise AssertionError("tx_counts kernel differs from its plain version")
    say(f"[multi] ShardedAligner (NCCL, bitset index) counts == host recount "
        f"of the bitsets on {MODE_BATCHES} batches; tx_counts kernel == plain,"
        f" tolerance 0; launches {launches['sharded']}")
    bounds["tx_counts"] = bound([tx_counts_work(x, n_tx) for x in dp_res])
    time_pair("tx_counts", lambda i: kernels.tx_counts_cuda(dp_res[i], n_tx),
              n_b, "tx_counts_kernel", MODE_BATCHES)
    time_pair("tx_counts_plain", lambda i: tx_compat_counts(dp_res[i], n_tx),
              2, None, MODE_BATCHES)
    # the count merge's exchange (row 17, a library call): all_reduce of
    # one [n_tx] int32 vector over the NCCL group
    one_counts = kernels.tx_counts_cuda(dp_res[0], n_tx)
    time_pair("all_reduce", lambda i: mesh1.all_reduce([one_counts]), n_b,
              None, 1)
    del sa, dp_res, one_counts

    # (e) the multi-host map at world size 1: part file == the record path's
    # records, merged counts == their counts
    mdir = os.path.join(work, "multihost")
    t = time.time()
    merged = map_fastq_multihost(image12, cli.serving_config(
        20, BATCH, READ_LEN), fq12, mdir)
    dt = time.time() - t
    with open(os.path.join(mdir, "part-0.txt"), "rb") as f:
        part = f.read()
    if part != b"".join(r + b"\n" for r in recs):
        raise AssertionError("map_fastq_multihost part differs from the "
                             "map_fastq records")
    if not np.array_equal(merged, host_counts(recs, n_tx)):
        raise AssertionError("map_fastq_multihost merged counts differ")
    say(f"[multi] map_fastq_multihost (NCCL, world 1) over {n12} reads: "
        f"{dt:.2f} s; part file == map_fastq records, merged counts == their "
        f"counts ({int(merged.sum())} in all)")

    # (f) the dry run
    dry = dryrun_multichip(1)
    if not dry.get("kpart_graph_sharded"):
        raise AssertionError(f"the dry run's kpart step is not graph-sharded:"
                             f" {dry}")
    say(f"[multi] dryrun_multichip(1): {dry}")

    # ---- 13. the graph-sharded walk ----
    from pseudoaligner_torch.parallel import graph_walk as gw

    def graph_bytes(kpx):
        """Per shard: (its node-row and pool block, the replicated rest:
        class bitsets and the placeholders), bytes."""
        return [(sum(t_.numel() * 4 for t_ in g), kpx.dev.nbytes())
                for g in kpx.graphs]

    # (a) S = 1 over the NCCL group: the serving emit of every batch
    t = time.time()
    kpg = si.KmerPartitionedAligner(image, cfg_s, mesh1, shard_graph=True)
    torch.cuda.synchronize()
    say(f"[graph] kpart S=1 graph-sharded set-up {time.time() - t:.1f} s: "
        f"node block {kpg.kmeta.node_block} of {image.n_nodes} nodes, graph "
        f"bytes on the shard (node-row and pool block, replicated rest) "
        f"{graph_bytes(kpg)[0]} (replicated-graph kpart: "
        f"{rep_graph_bytes})")
    srv = kpg.serving_aligner()
    with open(os.devnull, "wb") as sink:  # warm the host caches
        srv.emit_fastq(fq_path, sink)
    kernels.reset_launch_counts()
    kpg.walk_stats.clear()
    buf = io.BytesIO()
    torch.cuda.synchronize()
    t = time.time()
    n_emit, _ = srv.emit_fastq(fq_path, buf)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches["graph"] = launch_counts()
    need = ("pack", "route", "unscatter", "mphf_dynamic", "next_hit", "gwalk",
            "gfetch")
    if min(launches["graph"][k] for k in need) < 1 or launches["graph"][
            "pack_i32"]:
        raise AssertionError(f"a kernel never launched on the graph-sharded "
                             f"path: {launches['graph']}")
    if n_emit != n_reads or buf.getvalue() != outs["cuckoo"]:
        raise AssertionError("graph-sharded serving emit differs from the "
                             "cuckoo CLI output")
    ws = dict(kpg.walk_stats)
    per = {k: ws[k] / ws["walks"] for k in ws if k != "walks"}
    say(f"[graph] graph-sharded kpart serving emit (S=1, NCCL) over "
        f"{n_reads} reads: {dt:.2f} s, {n_reads / dt:.0f} reads/s "
        f"(replicated-graph kpart, phase 12: {kpart_rate:.0f}); "
        f"byte-identical to the phase-6 cuckoo CLI output; per batch "
        f"({ws['walks']} walks): {per}; launches {launches['graph']}")
    srv.close()
    del srv, buf

    # K10 and K11 timed on one recorded walk of the middle batch (one-SNP
    # reads: the left loop runs): init resets the state, so replaying the
    # recorded calls repeats the same walk
    calls = []

    def recording(steps):
        def rec(name):
            f = getattr(steps, name)

            def call(*a):
                calls.append((name, a))
                return f(*a)
            return call
        return gw.Steps(*(rec(n) for n in gw.Steps._fields))

    kpg.walk_steps = recording(gw.kernel_steps())
    kpg.map_batch(reads[mid * BATCH:(mid + 1) * BATCH], lens_np)
    kpg.walk_steps = None
    ks, meta_g = gw.kernel_steps(), kpg.meta
    walk_works, fetch_works = [], []
    st_at = {"init": 4, "left_a": 4, "left_b": 3, "forward": 6, "finish": 2}
    for name, a in calls:
        if name == "serve":
            fetch_works.append(gfetch_work(a[2], a[5]))
            continue
        before = a[st_at[name]].clone()
        out = getattr(ks, name)(*a)
        walk_works.append(gwalk_work(meta_g, kpg.kmeta, name, a, before,
                                     out))
    n_walk = len(walk_works)
    n_fetch = len(fetch_works)
    bounds["gwalk"] = bound([tuple(sum(w[i] for w in walk_works)
                                   for i in (0, 1))])
    bounds["gfetch"] = bound([tuple(sum(w[i] for w in fetch_works)
                                    for i in (0, 1))])

    def replayed(steps, which):
        """The recorded calls of K10's steps (which = "walk") or K11's
        serves, in order, each as a function of no arguments: the walk's
        replay repeats the recorded walk, and every serve is a pure
        function of its recorded requests."""
        serve = which == "serve"
        return [(lambda f=getattr(steps, name), a=a: f(*a))
                for name, a in calls if (name == "serve") == serve]

    def replay(steps, which):
        fns = replayed(steps, which)

        def run(_i):
            for fn in fns:
                fn()
        return run

    # held: each launch under its own event pair, summed per walk
    walk_names = [n for n, _ in calls if n != "serve"]
    serve_kind = ["window" if a[5] else "rows" for n, a in calls
                  if n == "serve"]
    per_launch = {}
    for key, steps, reps in (("", ks, n_b), ("_plain", gw.PLAIN_STEPS, 2)):
        per_launch["gwalk" + key] = time_pair(
            "gwalk" + key, replay(steps, "walk"), reps,
            "gwalk_" if not key else None, 1, per_call=n_walk,
            each=replayed(steps, "walk"))
        per_launch["gfetch" + key] = time_pair(
            "gfetch" + key, replay(steps, "serve"), reps,
            "gfetch_" if not key else None, 1, per_call=n_fetch,
            each=replayed(steps, "serve"))
    for key in ("gwalk", "gwalk_plain"):
        say(f"[graph] {key} held ms by launch: " + ", ".join(
            f"{n} {t}" for n, t in zip(walk_names, per_launch[key])))
    for key in ("gfetch", "gfetch_plain"):
        by = {k: [t for kind, t in zip(serve_kind, per_launch[key])
                  if kind == k] for k in ("window", "rows")}
        say(f"[graph] {key} held ms by launch: " + ", ".join(
            f"{kind} {t}" for kind, t in zip(serve_kind, per_launch[key]))
            + "; " + ", ".join(f"{k} {len(v)} launches, {sum(v)} in all"
                               for k, v in by.items()))
    # what one launch costs by this method whatever it does
    floor = held_ms(lambda: torch.cuda._sleep(1), n_b)
    say(f"[graph] one serving walk of batch {mid}: {n_walk} K10 launches "
        f"({', '.join(walk_names)}), {n_fetch} K11 launches; held ms per "
        f"walk, each launch timed alone: K10 {ms['gwalk']} (bound "
        f"{bounds['gwalk']}), K11 {ms['gfetch']} (bound {bounds['gfetch']});"
        f" a one-thread kernel holds {floor} per launch")
    del calls, kpg

    # (b) four loopback shards on the batches spread over the file (exact,
    # one-SNP and reversed reads): every field == the replicated engine's,
    # every K10 and K11 launch == its plain step on copies of its inputs
    t = time.time()
    kp4g = si.KmerPartitionedAligner(image, cfg_eager,
                                     make_mesh(4, loopback=True),
                                     shard_graph=True)
    torch.cuda.synchronize()
    say(f"[graph] kpart S=4 (loopback) graph-sharded set-up "
        f"{time.time() - t:.1f} s: node block {kp4g.kmeta.node_block}, "
        f"graph bytes per shard (block, replicated rest) "
        f"{graph_bytes(kp4g)} (replicated-graph kpart: "
        f"{rep_graph_bytes})")
    step_err = {}
    kp4g.walk_steps = gw.paired_steps(gw.kernel_steps(), gw.PLAIN_STEPS,
                                      step_err)
    base = Pseudoaligner(image, cfg_eager, device="cuda")
    for b in sel:
        rows = reads[b * BATCH:(b + 1) * BATCH]
        got, _ = kp4g.map_batch(rows, lens_np)
        compare_results(got, base.map_batch_device(rows, lens_np),
                        f"graph-sharded kpart S=4, batch {b}")
    torch.cuda.synchronize()
    if set(step_err) != set(gw.Steps._fields) or any(step_err.values()):
        raise AssertionError(f"K10/K11 differ from their plain steps: "
                             f"{step_err}")
    err["gwalk"] = max(v for k, v in step_err.items() if k != "serve")
    err["gfetch"] = step_err["serve"]
    say(f"[graph] kpart S=4 loopback graph-sharded == replicated engine, "
        f"every MapResult field, on batches {sel}; every K10 and "
        f"K11 launch == its plain step, tolerance 0 ({step_err}); walk "
        f"{kp4g.walk_stats}")
    base.close()
    del kp4g, base

    # (c) the full-output shape on the bitset index: ec_bits from the
    # pushed class ids (never the placeholder node_row) and the counts ==
    # the data-parallel engine's (K4 from node ids, K9), whose uncapped
    # walk keeps 2 * read_len nodes
    cfg12e = dataclasses.replace(cfg12, lazy_seeds=False,
                                 max_nodes=2 * READ_LEN)
    t = time.time()
    kpb = si.KmerPartitionedAligner(image12, cfg12e,
                                    make_mesh(4, loopback=True),
                                    shard_graph=True)
    torch.cuda.synchronize()
    say(f"[graph] bitset index, kpart S=4 (loopback) graph-sharded set-up "
        f"{time.time() - t:.1f} s, graph bytes per shard {graph_bytes(kpb)}")
    sa = ShardedAligner(image12, cfg12e, mesh1)
    kernels.reset_launch_counts()
    cls_res = []
    for b in range(MODE_BATCHES):
        rows = reads12[b * BATCH:(b + 1) * BATCH]
        got, counts = kpb.map_batch(rows, lens_np)
        want, want_counts = sa.map_batch(rows, lens_np)
        compare_results(got, want, f"graph-sharded full output, batch {b}")
        if max_abs_diff(counts, want_counts):
            raise AssertionError(f"graph-sharded counts differ on batch {b}")
        cls_res.append(got)
    torch.cuda.synchronize()
    launches["graph_full"] = launch_counts()
    if min(launches["graph_full"][k] for k in ("gwalk", "gfetch",
                                                "ec_bits_classes")) < 1:
        raise AssertionError(f"a kernel never launched on the graph-sharded "
                             f"full output: {launches['graph_full']}")
    say(f"[graph] full output (bitset index, S=4 loopback): every field, "
        f"ec_bits and counts == ShardedAligner's on {MODE_BATCHES} batches; "
        f"walk {kpb.walk_stats}; launches {launches['graph_full']}")
    # K4's class-id entry against its plain version on the pushed classes
    # (each visited node's class, from the data-parallel engine's rows)
    mb, ib = kpb.meta, kpb.dev
    cls = [torch.where(r.nodes >= 0, sa.dev.node_row[
        r.nodes.clamp(min=0).long(), 3], -1) for r in cls_res]
    err["ec_bits_classes"] = max(max_abs_diff(
        kernels.ec_bits_classes_cuda(mb, ib, c, r.n_nodes, r.mapped),
        ec_bitset_intersect_classes(mb, ib, c, r.n_nodes, r.mapped))
        for c, r in zip(cls, cls_res))
    if err["ec_bits_classes"]:
        raise AssertionError("ec_bits (classes) kernel differs from its "
                             "plain version")
    bounds["ec_bits_classes"] = bound([ecbits_work(mb, ib, r, c)
                                       for c, r in zip(cls, cls_res)])
    time_pair("ec_bits_classes", lambda i: kernels.ec_bits_classes_cuda(
        mb, ib, cls[i], cls_res[i].n_nodes, cls_res[i].mapped), n_b,
        "ec_bits_kernel", MODE_BATCHES)
    time_pair("ec_bits_classes_plain", lambda i: ec_bitset_intersect_classes(
        mb, ib, cls[i], cls_res[i].n_nodes, cls_res[i].mapped), 2, None,
        MODE_BATCHES)
    del kpb, sa, cls_res, cls
    dist.destroy_process_group()

    # the run whose count each entry's `launches` is (launches[mode]); the
    # map CLIs run the serving shape, the bitset index's paths full output
    runs = {"cuckoo": "map CLI, cuckoo index",
            "bucket1": "map CLI, bucket1 index",
            "mphf": "map CLI, mphf index", "stats": "batch_stats",
            "bitset": "count_single_cell and map_fastq on the bitset index",
            "kpart": "kpart serving emit, S = 1",
            "tensor": "map_kernel.map_batch on int32 code tensors, cuckoo, "
                      f"{min(MODE_BATCHES, n_b)} batches",
            "sharded": "ShardedAligner.map_batch, bitset index",
            "graph": "graph-sharded kpart serving emit, S = 1",
            "graph_full": "graph-sharded full output, S = 4 loopback"}

    def entry(name, key, source, replaces, mode, which):
        b_ms, b_by = bounds[key]
        t_ms, seen, of = traced_ms[key]
        return {"name": name, "route": "cuda",
                "source": f"pseudoaligner_torch/csrc/{source}",
                "replaces": f"pseudoaligner_tpu/{replaces}",
                "launches": launches[mode][which], "launches_on": runs[mode],
                "max_abs_err": err[key],
                "ms": ms[key], "plain_ms": ms[f"{key}_plain"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "held_ms": ms[key], "traced_ms": t_ms,
                "traced_launches_seen": seen, "traced_launches_timed": of,
                "plain_traced_ms": traced_ms[f"{key}_plain"][0]}

    kernels_line = {"kernels": [
        entry("seed_tables[cuckoo]", "seed", "seed.cu",
              "ops/map_kernel.py:520", "cuckoo", "seed"),
        entry("seed_tables[bucket1]", "seed_bucket1", "seed.cu",
              "ops/map_kernel.py:482", "bucket1", "seed"),
        entry("seed_tables[mphf]", "seed_mphf", "seed.cu",
              "ops/mphf_lookup.py:88", "mphf", "seed"),
        entry("walk[cuckoo]", "walk", "walk.cu", "ops/map_kernel.py:719",
              "cuckoo", "walk"),
        entry("walk[cuckoo] (full-output shape)", "walk_full", "walk.cu",
              "ops/map_kernel.py:719", "bitset", "walk"),
        entry("walk[bucket1, lazy seek]", "walk_bucket1", "walk.cu",
              "ops/map_kernel.py:1000", "bucket1", "walk"),
        entry("walk[mphf] (full-output shape)", "walk_mphf", "walk.cu",
              "ops/map_kernel.py:719", "mphf", "walk"),
        entry("stats", "stats", "stats.cu", "ops/stats.py:39", "stats",
              "stats"),
        entry("ec_bits", "ec_bits", "ecbits.cu", "ops/map_kernel.py:1180",
              "bitset", "ec_bits"),
        entry("unpack_index", "unpack", "unpack.cu",
              "ops/map_kernel.py:1504", "cuckoo", "unpack"),
        entry("pack_reads", "pack", "pack.cu", "ops/map_kernel.py:704",
              "kpart", "pack"),
        entry("pack_reads[int32]", "pack_i32", "pack.cu",
              "ops/map_kernel.py:704", "tensor", "pack_i32"),
        entry("route", "route", "route.cu", "parallel/sharded_index.py:262",
              "kpart", "route"),
        entry("mphf_dynamic", "mphf_dynamic", "mphfdyn.cu",
              "ops/mphf_lookup.py:58", "kpart", "mphf_dynamic"),
        entry("tx_counts", "tx_counts", "txcounts.cu", "parallel/mesh.py:57",
              "sharded", "tx_counts"),
        entry("next_hit", "next_hit", "seed.cu", "ops/map_kernel.py:583",
              "kpart", "next_hit"),
        entry("gwalk (one walk's steps)", "gwalk", "gwalk.cu",
              "ops/map_kernel.py:762", "graph", "gwalk"),
        entry("gfetch (one walk's fetches)", "gfetch", "gfetch.cu",
              "parallel/sharded_index.py:151", "graph", "gfetch"),
        entry("ec_bits[classes]", "ec_bits_classes", "ecbits.cu",
              "ops/map_kernel.py:1186", "graph_full", "ec_bits_classes"),
    ]}
    say(f"total {time.time() - t_start:.1f} s")
    say(json.dumps(kernels_line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
