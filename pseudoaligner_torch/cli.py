"""Command-line interface of the PyTorch port: `index` and single-end `map`.

Same flags and stdout as `pseudoaligner_tpu.cli` for these two commands
(`map` writes one record per read in the reference's debug format
`(flag, "read_id", [eq, class], coverage)`), plus `--device {cuda,cpu}`.
Paired-end `map`, `count`, `mappability`, `idxstats`, `inspect` and the
mphf/bucket1 seed indexes are not ported yet and raise NotImplementedError.

    python -m pseudoaligner_torch index -i IDX transcripts.fa
    python -m pseudoaligner_torch map -i IDX reads.fq --device cuda > out
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from pseudoaligner_tpu.cli import _check_k, _serving_config, make_ticker

from . import __version__

log = logging.getLogger("pseudoaligner_torch")

NOT_PORTED = ("count", "mappability", "idxstats", "inspect")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pseudoaligner-torch",
        description="De-bruijn-mapping (PyTorch + CUDA)",
    )
    p.add_argument("-v", "--version", action="version",
                   version=f"pseudoaligner_torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

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
                    help="mate FASTQ (paired-end: not ported yet)")
    sp.add_argument("--batch-size", type=int, default=32768)
    sp.add_argument("--max-read-len", type=int, default=160)
    sp.add_argument("-o", "--outdir", default=None)
    sp.add_argument("--tcc", action="store_true",
                    help="also write kallisto-style output.ec/output.tsv "
                         "TCC files to the output directory")
    sp.add_argument("--seed-index", choices=["cuckoo", "bucket1", "mphf"],
                    default="cuckoo",
                    help="seed structure (only cuckoo is ported)")
    sp.add_argument("--skip-reads", type=int, default=0,
                    help="resume: skip the first N reads (append records "
                         "for the remainder)")
    sp.add_argument("--progress-file", default=None,
                    help="write the running emitted-read count here after "
                         "every batch (for restartable streaming)")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the CUDA kernels; cpu: the plain PyTorch "
                         "passes [default: cuda]")
    for name in NOT_PORTED:
        sub.add_parser(name, help="not ported yet")
    return p


def open_index(path: str):
    """The IndexImage that `index` saved at `path`."""
    from pseudoaligner_tpu.serde import load_index

    return load_index(path)


def serving_config(k: int, batch_size: int, max_read_len: int,
                   seed_index: str = "cuckoo"):
    """The AlignerConfig `map` serves with: compact output at
    distinct_cap=3 and read-length-proportional walk caps (the reference
    CLI's serving shape; reads the caps cut off re-map exactly on the
    host)."""
    return _serving_config(k, argparse.Namespace(
        batch_size=batch_size, max_read_len=max_read_len,
        seed_index=seed_index))


def cmd_index(args) -> int:
    from pseudoaligner_tpu.index.builder import build_index
    from pseudoaligner_tpu.io.fasta import read_transcripts
    from pseudoaligner_tpu.serde import save_index

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
    sys.stdout.buffer.flush()
    tmp = path + ".tmp"
    with open(tmp, "w") as pf:
        pf.write(str(n))
    os.replace(tmp, path)


def cmd_map(args, outdir: str) -> int:
    from .models.aligner import Pseudoaligner

    if args.reads_fastq2:
        raise NotImplementedError("paired-end map is not ported yet")
    log.info("Reading index from disk")
    image = open_index(args.index)
    if image.k != args.kmer_size:
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    log.info("Mapping reads from fastq on %s", args.device)
    aligner = Pseudoaligner(
        image, serving_config(image.k, args.batch_size, args.max_read_len,
                              args.seed_index),
        device=args.device)
    tcc = None
    if args.tcc:
        from pseudoaligner_tpu.tcc import TccCounter

        tcc = TccCounter()

    def progress(n):
        if args.progress_file:
            _write_progress(args.progress_file, args.skip_reads + n)

    try:
        n_reads, n_flagged = aligner.emit_fastq(
            args.reads_fastq, sys.stdout.buffer, skip_reads=args.skip_reads,
            tcc=tcc, progress_cb=progress, ticker=make_ticker(),
        )
        sys.stdout.buffer.flush()
    finally:
        aligner.close()
    sys.stderr.write("\n")
    if tcc is not None:
        ec_path, tsv_path = tcc.write(outdir)
        log.info("TCC written: %s, %s (%d classes, %d/%d reads mapped)",
                 ec_path, tsv_path, len(tcc.counts), tcc.n_mapped,
                 tcc.n_reads)
    log.info("Done Mapping Reads (%d reads, %d flagged)", n_reads, n_flagged)
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("PSEUDOALIGNER_LOG", "INFO").upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    if args.cmd in NOT_PORTED:
        raise NotImplementedError(f"`{args.cmd}` is not ported yet")
    if args.cmd == "map" and args.seed_index != "cuckoo":
        raise NotImplementedError(
            f"--seed-index {args.seed_index} is not ported yet")
    outdir = getattr(args, "outdir", None) or os.getcwd()
    os.makedirs(outdir, exist_ok=True)
    if not _check_k(args.kmer_size):
        return 0
    if args.cmd == "index":
        return cmd_index(args)
    return cmd_map(args, outdir)


if __name__ == "__main__":
    sys.exit(main())
