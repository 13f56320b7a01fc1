"""The port's own host layers: it runs with pseudoaligner_tpu and jax made
unimportable, and its copies of the reference's framework-free modules
(index build, MPHF, serde, FASTQ reader, native host mapper, golden
oracle) give the reference's results on the same inputs."""

import dataclasses
import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from pseudoaligner_torch import golden as port_golden
from pseudoaligner_torch import serde as port_serde
from pseudoaligner_torch.index import builder as port_builder
from pseudoaligner_torch.io.fastq import FastqReader as PortReader
from pseudoaligner_torch.ops.map_kernel import image_from_reference
from pseudoaligner_torch.ops.native import HostMapper as PortHostMapper
from pseudoaligner_tpu import golden as ref_golden
from pseudoaligner_tpu import serde as ref_serde
from pseudoaligner_tpu.index import builder as ref_builder
from pseudoaligner_tpu.io.fastq import FastqReader as RefReader
from pseudoaligner_tpu.ops.native import HostMapper as RefHostMapper

from .torch_helpers import (
    _fuzz_reads,
    family_transcripts,
    polyt_transcripts,
    write_fastq,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ARRAYS = ("node_start", "node_len", "node_exts", "node_ec", "seq_pool",
                "l_edge", "r_edge", "ec_offsets", "ec_txs", "kmer_node",
                "kmer_offset", "kmer_keys")
MPHF_FIELDS = ("seeds", "masks", "word_offsets", "key_offsets", "bits",
               "ranks")


def test_port_runs_without_the_reference(tmp_path):
    """In a process where pseudoaligner_tpu and jax cannot be imported,
    chip_smoke and the port import, and the port's CLI builds an index,
    maps on the CPU under the cuckoo and MPHF seed indexes, maps pairs
    (checked against the golden pair rule) and counts cells, on
    chip_smoke's own recipes."""
    code = textwrap.dedent(f"""
        import io, sys

        class _Blocked:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "pseudoaligner_tpu"):
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, _Blocked())
        import numpy as np
        import torch
        import chip_smoke
        from pseudoaligner_torch import cli, golden
        from pseudoaligner_torch.config import AlignerConfig
        from pseudoaligner_torch.ops import kernels, map_kernel, stats

        d = {str(tmp_path)!r}
        seqs, names, gmap = chip_smoke.scale_seqs(30000, seed=5)
        chip_smoke.write_fasta(d + "/tx.fa", seqs, names, gmap)
        reads = chip_smoke.recipe_reads(seqs, 500, 60, seed=6)
        chip_smoke.write_fastq(d + "/r.fq", reads)
        assert cli.main(["index", "-i", d + "/idx.bin", d + "/tx.fa"]) == 0
        outs = []
        for more in ([], ["--seed-index", "mphf"]):
            buf = io.BytesIO()
            real, sys.stdout = sys.stdout, io.TextIOWrapper(buf)
            try:
                rc = cli.main(["map", "-i", d + "/idx.bin", d + "/r.fq",
                               "--batch-size", "128", "--max-read-len", "60",
                               "--device", "cpu"] + more)
            finally:
                sys.stdout.flush()
                sys.stdout.detach()
                sys.stdout = real
            assert rc == 0, rc
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and outs[0].count(b"\\n") == 500
        assert outs[0].count(b"[]") < 400, outs[0][:300]

        # paired map and count, on chip_smoke's recipes and CLI runner
        idx = d + "/idx.bin"
        mates = chip_smoke.pair_reads(seqs, 300, 60, seed=7)
        for m, r in zip((1, 2), mates):
            chip_smoke.write_fastq(d + f"/p{{m}}.fq", r)
        rc, _ = chip_smoke.run_cli(
            ["map", "-i", idx, d + "/p1.fq", d + "/p2.fq", "--batch-size",
             "128", "--max-read-len", "60", "--device", "cpu"],
            d + "/pairs.out")
        assert rc == 0, rc
        with open(d + "/pairs.out", "rb") as f:
            lines = f.read().splitlines()
        assert len(lines) == 300
        image = cli.open_index(idx)
        oracle = golden.golden_oracle(image)
        cfg = cli.serving_config(20, 128, 60)
        for i in range(0, 300, 7):
            assert lines[i] == golden.golden_pair_record(
                oracle, f"r{{i}}", mates[0][i], mates[1][i], cfg).encode()
        for m, r in zip((1, 2), chip_smoke.count_reads(seqs, 400, 60, seed=8,
                                                       n_cells=20)):
            chip_smoke.write_fastq(d + f"/c{{m}}.fq", r)
        rc, _ = chip_smoke.run_cli(
            ["count", "-i", idx, d + "/c1.fq", d + "/c2.fq", "-o",
             d + "/cnt", "--batch-size", "128", "--max-read-len", "60",
             "--device", "cpu"], d + "/count.out")
        assert rc == 0, rc
        with open(d + "/cnt/matrix.mtx") as f:
            n_cells, n_cls, n_entries = map(int, f.read().split("\\n")[2]
                                            .split())
        assert n_cells > 0 and n_cls > 0 and n_entries > 0

        # chip_smoke's bounds of the bitset and unpack kernels
        full = AlignerConfig(k=20, batch_size=128, max_read_len=60,
                             distinct_cap=0)
        dev, meta = map_kernel.device_index_from_image(image, full)
        assert meta.tx_words > 0
        idx_t = map_kernel.upload(dev, "cpu", serving=meta)
        res = map_kernel.map_batch_packed(
            meta, idx_t,
            torch.from_numpy(map_kernel.pack_reads_host(reads[:128])
                             .view(np.int32)),
            torch.full((128,), 60, dtype=torch.int32))
        nbytes, ops = chip_smoke.ecbits_work(meta, idx_t, res)
        assert nbytes > 4 * 128 * meta.tx_words and ops > 0
        dev, meta = map_kernel.device_index_from_image(
            image, cli.serving_config(20, 128, 60))
        pargs, pcfg = map_kernel.pack_serving_args(dev, meta)
        assert chip_smoke.unpack_work(pargs, pcfg) == (27 * pcfg.S,
                                                       15 * pcfg.S)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pseudoaligner_tpu")]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"


@pytest.fixture(scope="module", params=[20, 64])
def images(request):
    """The same transcripts indexed by both packages."""
    k = request.param
    rng = np.random.default_rng(1200 + k)
    seqs, names, gmap = polyt_transcripts(rng)
    seqs2, names2, gmap2 = family_transcripts(rng, n_genes=2, n_iso=4)
    seqs, names, gmap = seqs + seqs2, names + names2, {**gmap, **gmap2}
    ref = ref_builder.build_index(seqs, names, gmap, k=k)
    port = port_builder.build_index(seqs, names, gmap, k=k)
    reads = _fuzz_reads(rng, seqs, k=k, n=200, L=k + 60)
    return k, ref, port, reads


def _assert_images_equal(a, b):
    assert a.k == b.k
    for f in IMAGE_ARRAYS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.mphf.n_keys == b.mphf.n_keys
    for f in MPHF_FIELDS:
        x, y = getattr(a.mphf, f), getattr(b.mphf, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert list(a.tx_names) == list(b.tx_names)
    assert dict(a.tx_gene_mapping) == dict(b.tx_gene_mapping)


def test_build_index_matches_reference(images):
    _, ref, port, _ = images
    _assert_images_equal(ref, port)
    # and the carried-across image is the same index too
    _assert_images_equal(ref, image_from_reference(ref))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_saved_index_loads_in_the_other_package(images, tmp_path, direction):
    _, ref, port, _ = images
    path = str(tmp_path / "idx.bin")
    if direction == "ref_to_port":
        ref_serde.save_index(ref, path)
        loaded = port_serde.load_index(path)
    else:
        port_serde.save_index(port, path)
        loaded = ref_serde.load_index(path)
    _assert_images_equal(ref, loaded)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_fastq_reader_matches_reference(images, tmp_path, gz, native):
    """Batches of both readers: codes, lens, ids, long-read windows."""
    k, _, _, reads = images
    reads = reads + [("long", np.tile(reads[0][1], 4))]
    path = str(tmp_path / "r.fq")
    write_fastq(path, reads)
    if gz:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            g.write(f.read())
        path += ".gz"

    def batches(cls):
        out = []
        for b in cls(path, 32, k + 40, segment_long=True,
                     window_overlap=k - 1, use_native=native):
            out.append((np.array(b.codes), np.array(b.lens), list(b.ids),
                        np.array(b.group), np.array(b.offset)))
        return out

    want, got = batches(RefReader), batches(PortReader)
    assert len(want) == len(got) > 1
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            if isinstance(x, list):
                assert x == y
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y)


def test_host_mapper_matches_reference(images):
    k, ref, port, reads = images
    L = k + 60
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for j, (_, w) in enumerate(reads):
        codes[j, : len(w)] = w[:L]
        lens[j] = min(len(w), L)
    want = RefHostMapper(ref).map_reads(codes, lens, 2, 0.2)
    got = PortHostMapper(port).map_reads(codes, lens, 2, 0.2)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (want[3] > 0).any()


def test_golden_aligner_matches_reference(images):
    """The port's golden.py is the oracle itself (a copy, not a wrapper):
    records equal the reference oracle's, eager and lazy."""
    _, ref, port, reads = images
    assert port_golden.GoldenAligner.__module__ == port_golden.__name__
    r_eager = ref_golden.GoldenAligner(ref)
    p_eager = port_golden.GoldenAligner(port)
    p_lazy = port_golden.GoldenAligner(port, lazy=True)
    mapped = 0
    for _, w in reads:
        want = r_eager.map_read_with_mismatch(w, 2)
        assert p_eager.map_read_with_mismatch(w, 2) == want
        assert p_lazy.map_read_with_mismatch(w, 2) == want
        mapped += want is not None
    assert mapped > 0
    a, b = [1, 4, 6, 9, 12], [0, 4, 9, 10, 12, 13]
    assert port_golden.intersect(a, b) == ref_golden.intersect(a, b)


def test_config_copy_matches_reference():
    from pseudoaligner_torch.config import AlignerConfig as PortConfig
    from pseudoaligner_tpu.config import AlignerConfig as RefConfig

    assert ([(f.name, f.default) for f in dataclasses.fields(PortConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(RefConfig)])
