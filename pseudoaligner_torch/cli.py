"""Command-line interface of the PyTorch port: `index`, `map` (single-end
and paired-end), `count`, and the host-only `mappability`, `idxstats` and
`inspect`.

Same flags, stdout and output files as `pseudoaligner_tpu.cli` (`map`
writes one record per read, or per pair, in the reference's debug format
`(flag, "read_id", [eq, class], coverage)`; `count` writes barcodes.tsv,
ec.tsv and matrix.mtx; `mappability` writes tx_mappability.tsv), plus
`--device {cuda,cpu}` on `map` and `count`.  `map --seed-index` takes all
three seed indexes (cuckoo, bucket1, mphf).

    python -m pseudoaligner_torch index -i IDX transcripts.fa
    python -m pseudoaligner_torch map -i IDX reads.fq --device cuda > out
    python -m pseudoaligner_torch map -i IDX r1.fq r2.fq > pairs.out
    python -m pseudoaligner_torch map -i IDX reads.fq --seed-index mphf
    python -m pseudoaligner_torch count -i IDX R1.fq R2.fq -o DIR
    python -m pseudoaligner_torch mappability -i IDX -o DIR
    python -m pseudoaligner_torch idxstats -i IDX > stats.tsv
    python -m pseudoaligner_torch inspect -i IDX
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from . import __version__
from .config import AlignerConfig

log = logging.getLogger("pseudoaligner_torch")

USAGE_KMER_SUPPORTED = (20, 64)


def _rust_f32_str(v: float) -> str:
    """Rust `{}` Display for f32 (shortest roundtrip, positional)."""
    f = np.float32(v)
    if np.isnan(f):
        return "NaN"
    return np.format_float_positional(f, unique=True, trim="-")


def make_ticker(stream=None, every: int = 1_000_000):
    """Reference-style stderr progress ticker for the fast emit paths
    (src/pseudoaligner.rs:497-504): prints `\\rDone Mapping N reads w/
    Rate: X` at every N = multiple of `every`.  The fast paths advance in
    whole batches, so the printed N is the crossed multiple and the rate
    is computed at the batch boundary (the record path computes it at the
    exact millionth record — same shape, batch-granular rate)."""

    state = [every]

    def tick(n_reads: int, n_mapped: int) -> None:
        s = stream if stream is not None else sys.stderr
        while n_reads >= state[0]:
            frac = (np.float32(n_mapped) * np.float32(100.0)
                    / np.float32(n_reads))
            s.write(
                f"\rDone Mapping {state[0]} reads w/ Rate: {_rust_f32_str(frac)}"
            )
            s.flush()
            state[0] += every

    return tick


def _check_k(k: int) -> bool:
    if k not in USAGE_KMER_SUPPORTED:
        # reference prints and exits 0 (src/bin/pseudoaligner.rs:89-95)
        print(f"Kmer size = {k} is not supported. Set kmer size to 20 or 64")
        return False
    return True


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pseudoaligner-torch",
        description="De-bruijn-mapping (PyTorch + CUDA)",
    )
    p.add_argument("-v", "--version", action="version",
                   version=f"pseudoaligner_torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda: the CUDA kernels; cpu: the plain "
                             "PyTorch passes [default: cuda]")

    def common(sp):
        sp.add_argument("-k", "--kmer-size", type=int, default=20,
                        help="Kmer size to use - only 20 or 64 currently "
                             "supported [default: 20]")
        sp.add_argument("-n", "--num-threads", type=int, default=2,
                        help="Number of worker threads [default: 2]")
        sp.add_argument("-i", "--index", required=True, dest="index")

    sp = sub.add_parser("index", help="build index from a transcriptome FASTA")
    common(sp)
    sp.add_argument("ref_fasta")

    sp = sub.add_parser("map", help="map reads from a FASTQ against an index")
    common(sp)
    sp.add_argument("reads_fastq")
    sp.add_argument("reads_fastq2", nargs="?", default=None,
                    help="optional mate FASTQ — paired-end EC intersection")
    sp.add_argument("--batch-size", type=int, default=32768)
    sp.add_argument("--max-read-len", type=int, default=160)
    sp.add_argument("-o", "--outdir", default=None)
    sp.add_argument("--tcc", action="store_true",
                    help="also write kallisto-style output.ec/output.tsv "
                         "TCC files to the output directory")
    sp.add_argument("--seed-index", choices=["cuckoo", "bucket1", "mphf"],
                    default="cuckoo",
                    help="seed structure: cuckoo (two 4-slot buckets), "
                         "bucket1 (one 16-slot bucket) or mphf "
                         "(memory-lean BBHash with a stored-key verify)")
    sp.add_argument("--skip-reads", type=int, default=0,
                    help="resume: skip the first N reads (append records "
                         "for the remainder)")
    sp.add_argument("--progress-file", default=None,
                    help="write the running emitted-read count here after "
                         "every batch (for restartable streaming)")
    device_flag(sp)

    sp = sub.add_parser(
        "count",
        help="10x single-cell counting: R1 barcode/UMI + R2 cDNA -> "
             "per-cell TCC matrix (alevin-style)",
    )
    common(sp)
    sp.add_argument("r1_fastq")
    sp.add_argument("r2_fastq")
    sp.add_argument("-o", "--outdir", default=None)
    sp.add_argument("--bc-len", type=int, default=16)
    sp.add_argument("--umi-len", type=int, default=12)
    sp.add_argument("--whitelist", default=None,
                    help="known-barcode list (one per line, .gz ok): exact "
                         "matches accepted, unique 1-Hamming corrections "
                         "applied, others dropped")
    sp.add_argument("--umi-dedup", choices=("exact", "directional"),
                    default="exact",
                    help="molecule counting: exact distinct UMIs, or "
                         "UMI-tools directional clustering")
    sp.add_argument("--no-bc-correct", action="store_true",
                    help="without a whitelist, skip the knee-call + "
                         "1-Hamming barcode folding (take barcodes at "
                         "face value)")
    sp.add_argument("--call-cells", action="store_true",
                    help="knee-point cell calling: also write cells.tsv "
                         "with the called barcodes (rank order)")
    sp.add_argument("--batch-size", type=int, default=32768)
    sp.add_argument("--max-read-len", type=int, default=160)
    device_flag(sp)

    sp = sub.add_parser("mappability", help="per-transcript mappability report")
    common(sp)
    sp.add_argument("-o", "--outdir", default=None)

    sp = sub.add_parser("idxstats", help="dump per-node stats")
    common(sp)

    sp = sub.add_parser("inspect", help="print index summary")
    common(sp)
    return p


def open_index(path: str):
    """The IndexImage that `index` saved at `path`."""
    from .serde import load_index

    return load_index(path)


def serving_config(k: int, batch_size: int, max_read_len: int,
                   seed_index: str = "cuckoo") -> AlignerConfig:
    """The AlignerConfig `map` and `count` serve with, the reference CLI's
    serving shape: compact EC output at distinct_cap=3 with
    read-length-proportional walk caps and a matching node buffer.  Reads
    the caps cut off take the exact host re-map (-3 channel), so per-read
    output is byte-identical to the uncapped full shape."""
    wcap = max(3, max_read_len // 20)
    lcap = 2
    return AlignerConfig(
        k=k,
        batch_size=batch_size,
        max_read_len=max_read_len,
        seed_index=seed_index,
        distinct_cap=3,
        max_walk_iters=wcap,
        max_left_iters=lcap,
        max_nodes=wcap + lcap + 2,
    )


def cmd_index(args) -> int:
    from .index.builder import build_index
    from .io.fasta import read_transcripts
    from .serde import save_index

    log.info("Building index from fasta")
    seqs, tx_names, tx_gene_map = read_transcripts(args.ref_fasta)
    index = build_index(seqs, tx_names, tx_gene_map, k=args.kmer_size,
                        n_threads=args.num_threads)
    log.info("Finished building index!")
    save_index(index, args.index)
    log.info("Finished writing index!")
    return 0


def _write_progress(path: str, n: int) -> None:
    """Crash-safe resume count: the records it counts are flushed first,
    then the count is replaced atomically."""
    sys.stdout.flush()
    sys.stdout.buffer.flush()
    tmp = path + ".tmp"
    with open(tmp, "w") as pf:
        pf.write(str(n))
    os.replace(tmp, path)


def cmd_map(args, outdir: str) -> int:
    from .models.aligner import Pseudoaligner

    log.info("Reading index from disk")
    image = open_index(args.index)
    if image.k != args.kmer_size:
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    if args.reads_fastq2 and args.skip_reads:
        print("--skip-reads is not supported in paired mode")
        return 1
    log.info("Mapping reads from fastq on %s", args.device)
    aligner = Pseudoaligner(
        image, serving_config(image.k, args.batch_size, args.max_read_len,
                              args.seed_index),
        device=args.device)
    tcc = None
    if args.tcc:
        from .tcc import TccCounter

        tcc = TccCounter()
    try:
        if args.reads_fastq2 and tcc is None:
            # paired serving fast path: native signature-indirect emitter,
            # fragment ECs intersected per distinct pair group in C++
            n_pairs = aligner.emit_fastq_paired(
                args.reads_fastq, args.reads_fastq2, sys.stdout.buffer,
                progress_cb=(
                    (lambda n: _write_progress(args.progress_file, n))
                    if args.progress_file else None),
                ticker=make_ticker(),
            )
            sys.stdout.buffer.flush()
            sys.stderr.write("\n")
            log.info("Done Mapping Reads (%d pairs)", n_pairs)
            return 0
        if args.reads_fastq2:
            _write_records(aligner.map_fastq_paired(
                args.reads_fastq, args.reads_fastq2), args, tcc)
        else:
            def progress(n):
                if args.progress_file:
                    _write_progress(args.progress_file, args.skip_reads + n)

            n_reads, n_flagged = aligner.emit_fastq(
                args.reads_fastq, sys.stdout.buffer,
                skip_reads=args.skip_reads, tcc=tcc, progress_cb=progress,
                ticker=make_ticker(),
            )
            sys.stdout.buffer.flush()
            sys.stderr.write("\n")
            log.info("Done Mapping Reads (%d reads, %d flagged)", n_reads,
                     n_flagged)
    finally:
        aligner.close()
    if tcc is not None:
        ec_path, tsv_path = tcc.write(outdir)
        log.info("TCC written: %s, %s (%d classes, %d/%d reads mapped)",
                 ec_path, tsv_path, len(tcc.counts), tcc.n_mapped,
                 tcc.n_reads)
    return 0


def _write_records(records, args, tcc) -> None:
    """The record path (paired `map --tcc`): one record per line, the TCC
    counts, the progress file every batch_size records and at the end, and
    the reference's stderr ticker."""
    read_counter = mapped_read_counter = 0
    ticker = make_ticker()
    emitted = args.skip_reads
    progress_every = max(1, args.batch_size)
    for rec in records:
        sys.stdout.write(rec.format_reference_style() + "\n")
        if tcc is not None:
            tcc.add(rec.eq_class, mapped=rec.coverage > 0)
        emitted += 1
        if args.progress_file and emitted % progress_every == 0:
            _write_progress(args.progress_file, emitted)
        if rec.flag:
            mapped_read_counter += 1
        read_counter += 1
        ticker(read_counter, mapped_read_counter)
    if args.progress_file:
        _write_progress(args.progress_file, emitted)
    sys.stdout.flush()
    sys.stderr.write("\n")
    log.info("Done Mapping Reads")


def cmd_count(args, outdir: str) -> int:
    from .models.aligner import Pseudoaligner
    from .singlecell import Chemistry, Whitelist, count_single_cell

    log.info("Reading index from disk")
    image = open_index(args.index)
    if image.k != args.kmer_size:
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    aligner = Pseudoaligner(
        image, serving_config(image.k, args.batch_size, args.max_read_len),
        device=args.device)
    chem = Chemistry(bc_len=args.bc_len, umi_len=args.umi_len)
    wl = Whitelist.load(args.whitelist, args.bc_len) if args.whitelist else None
    try:
        counts = count_single_cell(
            aligner, args.r1_fastq, args.r2_fastq, chem, whitelist=wl,
            bc_correct=not args.no_bc_correct, umi_dedup=args.umi_dedup,
        )
    finally:
        aligner.close()
    counts.write(outdir, umi_dedup=args.umi_dedup)
    if args.call_cells:
        called = counts.call_cells(args.umi_dedup)
        with open(os.path.join(outdir, "cells.tsv"), "w") as f:
            for bc in called:
                f.write(bc + "\n")
        log.info("cell calling: %d of %d barcodes called", len(called),
                 len(counts.cells))
    log.info(
        "count: %d reads, %d mapped, %d cells, %d classes, %d bad R1, "
        "%d corrected, %d dropped barcodes",
        counts.n_reads, counts.n_mapped, len(counts.cells),
        len(counts.classes), counts.n_bad_r1, counts.n_corrected,
        counts.n_bad_barcode,
    )
    return 0


def cmd_mappability(args, outdir: str) -> int:
    from .mappability import write_mappability_tsv

    log.info("Reading index from disk")
    image = open_index(args.index)
    if image.k != args.kmer_size:
        # the k-mismatch contract of map and count
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    log.info("Finished reading index!")
    log.info("Analyzing de Bruijn graph")
    log.info("%d transcripts total", image.n_tx)
    write_mappability_tsv(image, outdir)
    return 0


def cmd_idxstats(args) -> int:
    image = open_index(args.index)
    lens = np.diff(image.ec_offsets.astype(np.int64))
    out = sys.stdout
    for n in range(image.n_nodes):
        out.write(f"{n}\t{int(image.node_len[n])}\t"
                  f"{int(lens[image.node_ec[n]])}\n")
    return 0


def cmd_inspect(args) -> int:
    for key, val in open_index(args.index).stats().items():
        print(f"{key}\t{val}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("PSEUDOALIGNER_LOG", "INFO").upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    outdir = getattr(args, "outdir", None) or os.getcwd()
    os.makedirs(outdir, exist_ok=True)
    if not _check_k(args.kmer_size):
        return 0
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "count":
        return cmd_count(args, outdir)
    if args.cmd == "mappability":
        return cmd_mappability(args, outdir)
    if args.cmd == "idxstats":
        return cmd_idxstats(args)
    if args.cmd == "inspect":
        return cmd_inspect(args)
    return cmd_map(args, outdir)


if __name__ == "__main__":
    sys.exit(main())
