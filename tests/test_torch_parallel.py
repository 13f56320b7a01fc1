"""PyTorch port vs the JAX reference: the data-parallel mesh, the device
read pack, transcript counts and the multi-process count merge.

The reference runs on its virtual 8-device CPU mesh; the port on a
loopback mesh of S shards on the CPU, and in one test in two OS processes
joined by torch.distributed over gloo.  Equal with tolerance 0, dtypes and
shapes included."""

import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_tpu.parallel.mesh import (
    ShardedAligner as RefSharded,
    make_mesh as ref_make_mesh,
    tx_compat_counts as ref_tx_counts,
)
from pseudoaligner_tpu.parallel.multihost import (
    map_fastq_multihost as ref_multihost,
)
from pseudoaligner_tpu.serde import save_index
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.models import aligner as port_aligner
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.parallel import multihost
from pseudoaligner_torch.parallel.dryrun import dryrun_multichip
from pseudoaligner_torch.parallel.mesh import (
    ShardedAligner,
    make_mesh,
    tx_compat_counts,
)
from pseudoaligner_torch.parallel.sharded_index import KmerPartitionedAligner

from .torch_helpers import (
    _fuzz_reads,
    assert_results_equal,
    build,
    family_transcripts,
    image_from_reference,
    port_index,
    write_fastq,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 64, 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Isoform families, a batch of fuzz reads (short ones and empty rows
    included) and a FASTQ of 128 reads: (reference image, port image,
    codes, lens, fastq path, index path)."""
    rng = np.random.default_rng(5150)
    seqs, names, gmap = family_transcripts(rng, n_genes=4, n_iso=5)
    image = build(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=B - 3, L=L)
    codes = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for j, (_, c) in enumerate(reads):
        if j % 7 == 0:
            c = c[:30]
        codes[j, : len(c)] = c
        lens[j] = len(c)
    d = tmp_path_factory.mktemp("parallel")
    fq = str(d / "reads.fq")
    write_fastq(fq, _fuzz_reads(rng, seqs, k=20, n=128, L=60))
    idx = str(d / "index.bin")
    save_index(image, idx)
    return image, image_from_reference(image), codes, lens, fq, idx


@pytest.mark.parametrize("L_,dtype,hi", [
    # int32 codes 0-3 keep the bare width as their ID
    *(pytest.param(L_, np.int32, 4, id=str(L_)) for L_ in (16, 37, 64, 101)),
    # uint8, the k-mer-partitioned link's width, and codes up to 255: the
    # pack does not mask them to two bits, so high bits bleed into the
    # next bases' places as in the reference
    *(pytest.param(L_, dt, hi, id=f"{np.dtype(dt).name}-0_{hi - 1}-{L_}")
      for dt, hi in ((np.uint8, 4), (np.uint8, 256), (np.int32, 256))
      for L_ in (16, 37, 60, 64, 101)),
])
def test_pack_reads_device_matches_reference(L_, dtype, hi):
    codes = np.random.default_rng(L_).integers(0, hi, (9, L_)).astype(dtype)
    want = np.asarray(ref_mk.pack_reads_device(
        jnp.asarray(codes.astype(np.int32))))
    got = mk.pack_reads_device(torch.from_numpy(codes))
    assert got.dtype == torch.int32 and want.dtype == np.uint32
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    if hi > 4:
        assert not np.array_equal(want, ref_mk.pack_reads_device(
            jnp.asarray(codes.astype(np.int32) & 3)))


@pytest.mark.parametrize("n_tx,TW,B", [
    pytest.param(1, 1, 50, id="1"),
    pytest.param(31, 1, 50, id="31"),
    pytest.param(32, 1, 50, id="32"),
    pytest.param(70, 3, 50, id="70"),
    # K9's shapes: the bitset cell's TW 337 with n_tx no multiple of 32;
    # batches past a thread's 2^8 and a block's 2^13 counts
    pytest.param(10766, 337, 50, id="10766-TW337"),
    pytest.param(10771, 337, 2**8 + 1, id="10771-TW337-B257"),
    pytest.param(341, 11, 2**13 + 1, id="341-TW11-B8193"),
])
def test_tx_compat_counts_matches_reference(n_tx, TW, B):
    rng = np.random.default_rng(n_tx)
    bits = rng.integers(0, 2**32, (B, TW), dtype=np.uint64).astype(np.uint32)
    bits[::4] = 0
    bits[1::4, 0] = 2**32 - 1  # word 0 set in a quarter of the rows or more
    want = np.asarray(ref_tx_counts(ref_mk.MapResult(
        *[None] * 5, ec_bits=jnp.asarray(bits), ec_distinct=None), n_tx))
    got = tx_compat_counts(torch.from_numpy(bits.view(np.int32))
                           .view(torch.uint32), n_tx)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


def test_lens_link_dtype_matches_reference():
    for n in (60, 255, 256, 65535, 65536):
        assert mk.lens_link_dtype(n) == ref_mk.lens_link_dtype(n)


def test_map_batch_from_codes_matches_reference(data):
    """map_batch (codes packed on the device) and map_batch_with_seeds
    (from the reference's next-hit table) against the reference's."""
    image, _, codes, lens = data[:4]
    cfg = AlignerConfig(k=20, batch_size=B, max_read_len=L, max_nodes=64,
                        distinct_cap=0, lazy_seeds=False, pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    dev = ref_mk.DeviceIndex(*map(jnp.asarray, dev_np))
    want = ref_mk.map_batch(meta, dev, jnp.asarray(codes, jnp.int32),
                            jnp.asarray(lens))
    pdev, pmeta = port_index(dev_np, meta)
    c, n = torch.from_numpy(codes.astype(np.int32)), torch.from_numpy(lens)
    assert_results_equal(want, mk.map_batch(pmeta, pdev, c, n), "map_batch")
    nh3 = mk.seed_tables(pmeta, pdev, mk.pack_reads_device(c), n)
    want2 = ref_mk.map_batch_with_seeds(meta, dev, jnp.asarray(codes),
                                        jnp.asarray(lens),
                                        jnp.asarray(nh3.numpy()))
    assert_results_equal(want2, mk.map_batch_with_seeds(pmeta, pdev, c, n,
                                                        nh3), "with_seeds")


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_aligner_matches_reference(data, S):
    """Every MapResult field of the full-output, bitset shape and the
    counts summed over the mesh."""
    image, pimage, codes, lens = data[:4]
    kw = dict(k=20, batch_size=B, max_read_len=L, max_nodes=64,
              distinct_cap=0)
    want, want_counts = RefSharded(image, AlignerConfig(**kw),
                                   ref_make_mesh(S)).map_batch(codes, lens)
    sa = ShardedAligner(pimage, PortConfig(**kw),
                        make_mesh(S, loopback=True, device="cpu"))
    got, counts = sa.map_batch(codes, lens)
    assert sa.meta.max_nodes == 2 * L  # the uncapped walk's full buffer
    assert_results_equal(want, got, f"sharded S={S}")
    want_counts = np.asarray(want_counts)
    assert counts.dtype == torch.int32 and counts.shape == want_counts.shape
    assert np.array_equal(counts.numpy(), want_counts)
    assert want_counts.sum() > 0


def test_sharded_aligner_needs_bitsets_and_meshes_exist(data, monkeypatch):
    _, pimage, codes, lens = data[:4]
    with pytest.raises(ValueError, match="bitset"):
        ShardedAligner(pimage, PortConfig(k=20, batch_size=B, max_read_len=L,
                                          bitset_tx_threshold=4),
                       make_mesh(2, loopback=True, device="cpu"))
    with pytest.raises(ValueError, match="requested 2 devices"):
        make_mesh(2, device="cpu")  # no process group: one process
    sa = ShardedAligner(pimage, PortConfig(k=20, batch_size=B,
                                           max_read_len=L),
                        make_mesh(4, loopback=True, device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        sa.map_batch(codes[:6], lens[:6])
    monkeypatch.delenv("PA_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("PA_AUTO_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="cannot infer"):
        multihost.init_from_env(device="cpu")


@pytest.mark.parametrize("native", [True, False])
def test_map_fastq_multihost_matches_reference(data, tmp_path, monkeypatch,
                                               native):
    """One process of a stride of two and a whole run: part files and
    merged counts equal the reference's, through the native emitter and
    through the record path of a host without the toolchain."""
    image, pimage, _, _, fq, _ = data
    if not native:
        from pseudoaligner_torch.io import native as port_native

        def no_toolchain():
            raise OSError("no toolchain")

        monkeypatch.setattr(port_native, "_load_emit", no_toolchain)
    kw = dict(k=20, batch_size=16, max_read_len=64, max_nodes=64)
    for p, H in ((1, 2), (0, 1)):
        want = ref_multihost(image, AlignerConfig(**kw), fq,
                             str(tmp_path / f"ref{p}{H}"), process_index=p,
                             process_count=H)
        got = multihost.map_fastq_multihost(
            pimage, PortConfig(**kw), fq, str(tmp_path / f"port{p}{H}"),
            process_index=p, process_count=H, device="cpu")
        assert got.dtype == np.int32 and np.array_equal(got, want)
        with open(tmp_path / f"ref{p}{H}" / f"part-{p}.txt", "rb") as f:
            ref_part = f.read()
        with open(tmp_path / f"port{p}{H}" / f"part-{p}.txt", "rb") as f:
            assert f.read() == ref_part
    assert ref_part.count(b"\n") == 128 and want.sum() > 0


def test_map_fastq_multihost_resumes_after_a_crash(data, tmp_path,
                                                   monkeypatch):
    """A run that dies mid-stream after some batches were checkpointed,
    then a resumed run: part file and counts equal an uninterrupted run's
    byte for byte."""
    _, pimage, _, _, fq, _ = data
    cfg = PortConfig(k=20, batch_size=8, max_read_len=64, max_nodes=64)
    want = multihost.map_fastq_multihost(pimage, cfg, fq,
                                         str(tmp_path / "ref"), device="cpu")
    calls = [0]
    real = port_aligner.Pseudoaligner.emit_finish

    def dies(self, st):
        calls[0] += 1
        if calls[0] > 10:
            raise KeyboardInterrupt("crash")
        return real(self, st)

    monkeypatch.setattr(port_aligner.Pseudoaligner, "emit_finish", dies)
    crash = str(tmp_path / "crash")
    with pytest.raises(KeyboardInterrupt):
        multihost.map_fastq_multihost(pimage, cfg, fq, crash, resume=True,
                                      device="cpu")
    done = int(np.load(os.path.join(crash, "part-0.txt.progress"))["batches"])
    assert 1 <= done < 16
    monkeypatch.setattr(port_aligner.Pseudoaligner, "emit_finish", real)
    got = multihost.map_fastq_multihost(pimage, cfg, fq, crash, resume=True,
                                        device="cpu")
    assert np.array_equal(got, want)
    with open(tmp_path / "ref" / "part-0.txt", "rb") as f:
        ref_part = f.read()
    with open(os.path.join(crash, "part-0.txt"), "rb") as f:
        assert f.read() == ref_part


_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from pseudoaligner_torch.config import AlignerConfig
    from pseudoaligner_torch.parallel.mesh import make_mesh
    from pseudoaligner_torch.parallel.multihost import (
        init_from_env, map_fastq_multihost)
    from pseudoaligner_torch.parallel.sharded_index import (
        KmerPartitionedAligner)
    from pseudoaligner_torch.serde import load_index

    pid, n = init_from_env(device="cpu")
    assert n == 2, n
    out = {out!r}
    image = load_index({index!r})
    cfg = AlignerConfig(k=20, batch_size=16, max_read_len=64, max_nodes=64)
    merged = map_fastq_multihost(image, cfg, {fastq!r}, out, device="cpu")
    np.save(os.path.join(out, f"counts-{{pid}}.npy"), merged)
    data = np.load({reads!r})
    for tag, sg in (("kpart", False), ("kpartg", True)):
        kp = KmerPartitionedAligner(
            image, AlignerConfig(**{kw!r}), make_mesh(2, device="cpu"),
            shard_graph=sg)
        res, counts = kp.map_batch(data["codes"], data["lens"])
        assert res.mapped.shape[0] == data["codes"].shape[0] // 2
        full = kp.gather(res)
        fields = {{f: (t.view(torch.int32) if t.dtype == torch.uint32 else t)
                  .numpy() for f, t in zip(full._fields, full)}}
        np.savez(os.path.join(out, f"{{tag}}-{{pid}}.npz"),
                 counts=counts.numpy(), **fields)
    torch.distributed.destroy_process_group()
    print("child", pid, "ok")
""")


def test_two_processes_over_gloo(data, tmp_path):
    """Two OS processes joined by torch.distributed (gloo): the multi-host
    map's merged counts equal a one-process run's in both, the part files
    hold every read once, and the k-mer-partitioned step across the two
    processes (its all_to_all and all_reduce over gloo), with the graph
    replicated and with it sharded (the routed walk's fetches and
    liveness over gloo), gives every field and the counts of the loopback
    mesh's run."""
    image, pimage, codes, lens, fq, idx = data
    reads = str(tmp_path / "reads.npz")
    np.savez(reads, codes=codes, lens=lens)
    out = str(tmp_path / "out")
    os.makedirs(out)
    kw = dict(k=20, batch_size=B, max_read_len=L, max_nodes=64,
              distinct_cap=0, lazy_seeds=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    code = _CHILD.format(repo=REPO, out=out, index=idx, fastq=fq,
                         reads=reads, kw=kw)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=dict(env, PA_COORDINATOR=f"127.0.0.1:{port}",
                 PA_NUM_PROCESSES="2", PA_PROCESS_ID=str(pid)))
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    cfg = PortConfig(k=20, batch_size=16, max_read_len=64, max_nodes=64)
    want = multihost.map_fastq_multihost(pimage, cfg, fq,
                                         str(tmp_path / "one"), device="cpu")
    lines = []
    for pid in range(2):
        assert np.array_equal(np.load(os.path.join(out, f"counts-{pid}.npy")),
                              want)
        with open(os.path.join(out, f"part-{pid}.txt"), "rb") as f:
            lines += f.read().splitlines()
    with open(tmp_path / "one" / "part-0.txt", "rb") as f:
        assert sorted(lines) == sorted(f.read().splitlines())

    kp = KmerPartitionedAligner(pimage, PortConfig(**kw),
                                make_mesh(2, loopback=True, device="cpu"))
    ref, ref_counts = kp.map_batch(codes, lens)
    for name in (f"{tag}-{pid}" for tag in ("kpart", "kpartg")
                 for pid in range(2)):
        got = np.load(os.path.join(out, f"{name}.npz"))
        assert np.array_equal(got["counts"], ref_counts.numpy())
        for f, t in zip(ref._fields, ref):
            t = t.view(torch.int32) if t.dtype == torch.uint32 else t
            assert got[f].dtype == t.numpy().dtype, f
            assert np.array_equal(got[f], t.numpy()), f


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_on_a_loopback_mesh(n):
    out = dryrun_multichip(n, loopback=True, device="cpu")
    assert out["mapped"] > 0 and out["kpart_mapped"] == out["mapped"]
    # the reference's dry run runs the k-mer-partitioned step graph-sharded
    assert out["kpart_graph_sharded"]
    assert out["counts_sum"] > 0
