"""PyTorch port vs the JAX reference: the serving surface and the CLI.

Emitted map records and TCC files must be byte-identical, at the
reference's default config (left_compact on: its -3 lanes re-map exactly
on the host, so records agree although MapResults need not)."""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.models.aligner import Pseudoaligner as RefAligner
from pseudoaligner_tpu.serde import save_index
from pseudoaligner_torch.golden import golden_oracle, golden_record
from pseudoaligner_torch.models.aligner import Pseudoaligner

from .torch_helpers import (
    _fuzz_reads,
    build,
    family_transcripts,
    write_fastq,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPICE = ['"', "\\", "\t", "\x01", "\x1b", "\x7f", "'", "́", " ",
         "​", "é", "λ", "漢"]


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """Family-structured index; FASTQ of fuzz reads (short, exact-k, SNP
    bursts, poly-A, random), long reads past max_read_len and adversarial
    ids."""
    rng = np.random.default_rng(515)
    seqs, names, gmap = family_transcripts(rng)
    image = build(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=600, L=72)
    for i in range(12):  # long reads: segmented into windows
        s = seqs[int(rng.integers(len(seqs)))]
        ln = int(rng.integers(150, len(s)))
        st = int(rng.integers(0, len(s) - ln + 1))
        reads.insert(int(rng.integers(len(reads))), (f"long{i}",
                                                      s[st : st + ln]))
    for i in range(0, len(reads), 7):  # adversarial ids
        rid, w = reads[i]
        for _ in range(int(rng.integers(1, 4))):
            rid += SPICE[int(rng.integers(len(SPICE)))]
        reads[i] = (rid, w)
    d = tmp_path_factory.mktemp("serving")
    fq = str(d / "reads.fq")
    write_fastq(fq, reads)
    idx = str(d / "index.bin")
    save_index(image, idx)
    return image, fq, idx, len(reads)


CONFIGS = {
    "default": dict(),
    "serving": dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
                    max_nodes=7),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emit_fastq_matches_reference(workload, name):
    image, fq, _, n_reads = workload
    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=96,
                        **CONFIGS[name])
    want = io.BytesIO()
    ref_n, ref_fl = RefAligner(image, cfg).emit_fastq(fq, want)
    got = io.BytesIO()
    al = Pseudoaligner(image, cfg, device="cpu")
    try:
        n, fl = al.emit_fastq(fq, got)
    finally:
        al.close()
    assert (n, fl) == (ref_n, ref_fl) and n == n_reads
    assert got.getvalue() == want.getvalue()
    # the long reads really went through the record path
    assert b'"long' in got.getvalue()


def test_device_remap_fallback_matches_reference(workload):
    """Without the native host mapper, flagged reads re-map on the device
    in the uncapped full-output shape; records stay identical."""
    image, fq, _, n_reads = workload
    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=96,
                        **CONFIGS["serving"])
    want = io.BytesIO()
    RefAligner(image, cfg).emit_fastq(fq, want)
    al = Pseudoaligner(image, cfg, device="cpu")
    al._host_mapper = lambda: None
    got = io.BytesIO()
    n, _ = al.emit_fastq(fq, got)
    assert n == n_reads and got.getvalue() == want.getvalue()
    assert al._remap_meta.distinct_cap == 0  # the fallback really ran
    assert al._remap_meta.max_nodes == 2 * cfg.max_read_len


def test_map_step_seam_matches_reference(workload):
    """An external engine plugged under the serving surface (map_step and
    its meta): records stay identical, also where flagged reads re-map on
    the device, for which the surface then builds its own index."""
    image, fq, _, n_reads = workload
    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=96,
                        **CONFIGS["serving"])
    want = io.BytesIO()
    RefAligner(image, cfg).emit_fastq(fq, want)
    engine = Pseudoaligner(image, cfg, device="cpu")
    calls = []

    def step(codes, lens):
        calls.append(len(lens))
        return engine.map_batch_device(codes, lens)

    with pytest.raises(ValueError, match="meta"):
        Pseudoaligner(image, cfg, device="cpu", map_step=step)
    with pytest.raises(ValueError, match="map_step"):
        Pseudoaligner(image, cfg, device="cpu", meta=engine.meta)
    al = Pseudoaligner(image, cfg, device="cpu", map_step=step,
                       meta=engine.meta)
    al._host_mapper = lambda: None
    got = io.BytesIO()
    n, _ = al.emit_fastq(fq, got)
    assert n == n_reads and got.getvalue() == want.getvalue()
    assert calls and not hasattr(al, "dev")
    # the device re-map ran on an index of the surface's own
    assert al._remap_meta.distinct_cap == 0
    assert al._remap_dev is not engine.dev


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emit_batch_matches_reference(workload, tmp_path, name):
    """emit_batch, the synchronous emit_prepare + emit_finish, gives the
    reference's bytes and TCC counts batch by batch."""
    from pseudoaligner_tpu.io.fastq import FastqReader as RefReader
    from pseudoaligner_tpu.tcc import TccCounter as RefTcc
    from pseudoaligner_torch.io.fastq import FastqReader
    from pseudoaligner_torch.tcc import TccCounter

    image, fq, _, _ = workload
    seqs = family_transcripts(np.random.default_rng(515))[0]  # the index's
    short = str(tmp_path / "short.fq")  # no read past max_read_len
    write_fastq(short, _fuzz_reads(np.random.default_rng(77), seqs, k=20,
                                   n=300, L=72))
    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=96,
                        **dict(CONFIGS[name], distinct_cap=3))
    ref, al = RefAligner(image, cfg), Pseudoaligner(image, cfg, device="cpu")
    want_tcc, got_tcc = RefTcc(), TccCounter()
    n = 0
    try:
        for rb, pb in zip(RefReader(short, batch_size=128, max_len=96),
                          FastqReader(short, batch_size=128, max_len=96)):
            want = ref.emit_batch(ref.map_batch_device(rb.codes, rb.lens),
                                  rb, want_tcc)
            got = al.emit_batch(al.map_batch_device(pb.codes, pb.lens), pb,
                                got_tcc)
            assert got == want and got.count(b"\n") == pb.n_reads
            n += pb.n_reads
    finally:
        al.close()
    assert n == 300
    assert (got_tcc.classes, got_tcc.counts, got_tcc.n_reads,
            got_tcc.n_mapped) == (want_tcc.classes, want_tcc.counts,
                                  want_tcc.n_reads, want_tcc.n_mapped)
    assert got_tcc.n_mapped > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_golden_records_match_emit(workload, name):
    """The scalar oracle's records (the check chip_smoke.py makes on the
    card) equal the emitted ones for every read that fits a batch."""
    image, fq, _, n_reads = workload
    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=96,
                        **CONFIGS[name])
    al = Pseudoaligner(image, cfg, device="cpu")
    buf = io.BytesIO()
    al.emit_fastq(fq, buf)
    lines = buf.getvalue().split(b"\n")[:-1]
    ids = [r.read_id for r in al.map_fastq(fq)]
    with open(fq, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    assert len(lines) == len(ids) == len(seqs) == n_reads
    oracle = golden_oracle(image)
    to_codes = bytes.maketrans(b"ACGT", b"\x00\x01\x02\x03")
    checked = 0
    for line, rid, seq in zip(lines, ids, seqs):
        if len(seq) > cfg.max_read_len:
            continue  # long reads map as merged windows
        codes = np.frombuffer(seq.translate(to_codes), dtype=np.uint8)
        assert golden_record(oracle, rid, codes, cfg).encode() == line, rid
        checked += 1
    assert checked == n_reads - 12


def test_map_fastq_records_match_reference(workload):
    """The record path (map_fastq) at the full-output shape."""
    image, fq, _, n_reads = workload
    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=96,
                        distinct_cap=0, max_nodes=64)
    want = [r.format_reference_style() for r in
            RefAligner(image, cfg).map_fastq(fq, skip_reads=5)]
    got = [r.format_reference_style() for r in
           Pseudoaligner(image, cfg, device="cpu").map_fastq(fq, skip_reads=5)]
    assert got == want and len(got) == n_reads - 5


def _run_cli(main, argv, capsysbinary):
    rc = main(argv)
    out = capsysbinary.readouterr().out
    return rc, out


@pytest.mark.parametrize("extra", [[], ["--skip-reads", "37"], ["--tcc"]])
def test_cli_map_matches_reference(workload, tmp_path, capsysbinary, extra):
    from pseudoaligner_torch import cli as port_cli
    from pseudoaligner_tpu import cli as ref_cli

    _, fq, idx, n_reads = workload
    base = ["map", "-i", idx, fq, "--batch-size", "256",
            "--max-read-len", "96"]
    dirs = {}
    outs = {}
    for tag, main, more in (("ref", ref_cli.main, []),
                            ("port", port_cli.main, ["--device", "cpu"])):
        dirs[tag] = str(tmp_path / tag)
        rc, outs[tag] = _run_cli(
            main, base + extra + more + ["-o", dirs[tag]], capsysbinary)
        assert rc == 0, tag
    assert outs["port"] == outs["ref"]
    skip = int(extra[1]) if extra[:1] == ["--skip-reads"] else 0
    assert outs["port"].count(b"\n") == n_reads - skip
    if "--tcc" in extra:
        for f in ("output.ec", "output.tsv"):
            with open(os.path.join(dirs["ref"], f), "rb") as a, \
                    open(os.path.join(dirs["port"], f), "rb") as b:
                assert b.read() == a.read(), f


def test_cli_progress_file(workload, tmp_path, capsysbinary):
    from pseudoaligner_torch import cli as port_cli

    _, fq, idx, n_reads = workload
    prog = str(tmp_path / "progress")
    rc, out = _run_cli(port_cli.main, [
        "map", "-i", idx, fq, "--batch-size", "256", "--max-read-len", "96",
        "--device", "cpu", "--skip-reads", "10", "--progress-file", prog,
    ], capsysbinary)
    assert rc == 0
    with open(prog) as f:
        assert int(f.read()) == n_reads
    assert out.count(b"\n") == n_reads - 10


def test_port_runs_without_jax(workload):
    """The port never imports jax: with jax made unimportable (as on a
    machine without it), it still maps on the CPU, and no jax module is
    loaded afterwards."""
    _, fq, idx, n_reads = workload
    code = textwrap.dedent(f"""
        import sys

        class _NoJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is not installed here")

        sys.meta_path.insert(0, _NoJax())
        import io
        from pseudoaligner_torch import cli, golden
        from pseudoaligner_torch.config import AlignerConfig
        from pseudoaligner_torch.models.aligner import Pseudoaligner
        from pseudoaligner_torch.ops import kernels, map_kernel, stats
        from pseudoaligner_torch.serde import load_index

        al = Pseudoaligner(load_index({idx!r}),
                           AlignerConfig(k=20, batch_size=256,
                                         max_read_len=96),
                           device="cpu")
        buf = io.BytesIO()
        n, _ = al.emit_fastq({fq!r}, buf)
        assert n == {n_reads}, n
        jax_mods = [m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib")]
        assert not jax_mods, jax_mods
        print("OK", n)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == f"OK {n_reads}"


def test_device_cuda_without_cuda_raises(workload):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pseudoaligner_torch import cli as port_cli

    image, fq, idx, _ = workload
    with pytest.raises(RuntimeError, match="cuda"):
        Pseudoaligner(image, AlignerConfig(k=20), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(["map", "-i", idx, fq, "--device", "cuda"])


def test_not_ported_paths_raise(workload, tmp_path, capsysbinary):
    """Every subcommand is ported now: the host-only ones run on the
    workload's index (their bytes against the JAX CLI's are
    tests/test_torch_cli_host.py's) and, like the JAX CLI, refuse to run
    without an index."""
    from pseudoaligner_torch import cli as port_cli

    _, _, idx, _ = workload
    for cmd in ("mappability", "idxstats", "inspect"):
        more = ["-o", str(tmp_path)] if cmd == "mappability" else []
        rc, out = _run_cli(port_cli.main, [cmd, "-i", idx] + more,
                           capsysbinary)
        assert rc == 0, cmd
        assert out or os.path.exists(tmp_path / "tx_mappability.tsv"), cmd
        with pytest.raises(SystemExit):
            port_cli.main([cmd])
