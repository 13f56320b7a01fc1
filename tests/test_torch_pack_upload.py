"""PyTorch port vs the JAX reference: the bit-packed cuckoo upload.

A large cuckoo serving index travels to the device bit-packed (keys in 2k
bits at k <= 32, (node, offset) values in node_bits + off_bits bits) and is
unpacked there into exactly the plain upload's arrays.  The host pack
equals the reference's `_pack_serving_args` on the real slots (the port
drops the TPU's tile padding), and the unpack restores the plain arrays,
all exact."""

import io

import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.models.aligner import Pseudoaligner
from pseudoaligner_torch.ops import map_kernel as mk

from .torch_helpers import (
    _fuzz_reads,
    build,
    family_transcripts,
    polyt_transcripts,
    write_fastq,
)

SERVING = dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
               max_nodes=8)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    seqs, names, gmap = family_transcripts(rng)
    out = {20: (build(seqs, names, gmap, k=20), seqs)}
    seqs, names, gmap = polyt_transcripts(np.random.default_rng(13))
    out[64] = (build(seqs, names, gmap, k=64), seqs)
    return out


def _indexes(image, k):
    """(reference numpy DeviceIndex, its meta, the port's, its meta) of
    the cuckoo serving shape."""
    L = 72 if k == 20 else 96
    ref_dev, ref_meta = ref_mk.device_index_from_image(
        image, AlignerConfig(k=k, max_read_len=L, pool_overlap=False,
                             **SERVING))
    dev, meta = mk.device_index_from_image(
        mk.image_from_reference(image),
        PortConfig(k=k, max_read_len=L, **SERVING))
    return ref_dev, ref_meta, dev, meta


@pytest.mark.parametrize("k", [20, 64])
def test_host_pack_matches_reference(images, k):
    """Keys and values packed at k = 20, values only at k = 64; equal to
    the reference's arrays on the real slots."""
    ref_dev, ref_meta, dev, meta = _indexes(images[k][0], k)
    ref_args, ref_cfg = ref_mk._pack_serving_args(ref_dev, ref_meta)
    args, cfg = mk.pack_serving_args(dev, meta)
    (pack_keys, pack_vals, pack_pool, node_bits, off_bits, W, PB, S_pad,
     _R, _sw) = ref_cfg
    assert pack_vals and not pack_pool
    assert (cfg.pack_keys, cfg.node_bits, cfg.off_bits, cfg.W, cfg.PB) == (
        pack_keys, node_bits, off_bits, W, PB)
    assert cfg.pack_keys == (k == 20)
    S = cfg.S
    assert S == np.asarray(dev.cuckoo).size // W and S_pad >= S
    assert set(args) == set(ref_args) - {"pool_rows"}
    for name, a in args.items():
        b = np.asarray(ref_args[name])
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b[:S] if name != "cuckoo" else b), name


@pytest.mark.parametrize("k", [20, 64])
def test_unpack_rebuilds_the_plain_upload(images, k):
    _, _, dev, meta = _indexes(images[k][0], k)
    args, cfg = mk.pack_serving_args(dev, meta)
    t = mk.packed_tensors(args, "cpu")
    cuckoo, vals = mk.unpack_index(t, cfg)
    plain = mk.upload(dev, "cpu", serving=meta, pack=False)
    for got, want in ((cuckoo, plain.cuckoo), (vals, plain.cuckoo_vals)):
        assert got.dtype == want.dtype == torch.int32
        assert got.shape == want.shape and torch.equal(got, want)
    # empty slots come back as (EMPTY, 0) with the all-ones key
    empty = np.asarray(dev.cuckoo_vals)[0::2] == 0xFFFFFFFF
    assert empty.any() and (vals.view(-1, 2)[torch.from_numpy(empty), 1]
                            == 0).all()
    packed = mk.upload(dev, "cpu", serving=meta, pack=True)
    assert packed.nbytes() == plain.nbytes()
    for f in ("cuckoo", "cuckoo_vals", "node_row", "ec_bits", "pool_rows"):
        assert torch.equal(getattr(packed, f), getattr(plain, f)), f
    # the bytes on the link shrink: 11 per slot at k = 20 (16 plain)
    link = sum(a.nbytes for a in args.values())
    assert link < np.asarray(dev.cuckoo).nbytes + np.asarray(
        dev.cuckoo_vals).nbytes
    if k == 20:
        assert link == 11 * cfg.S


def test_upload_gate(images, monkeypatch):
    """pack=None packs a cuckoo serving index of at least PACK_MIN_BYTES
    and nothing else; pack=True refuses an index it cannot pack."""
    _, _, dev, meta = _indexes(images[20][0], 20)
    calls = []
    real = mk.unpack_index
    monkeypatch.setattr(mk, "unpack_index",
                        lambda *a: calls.append(1) or real(*a))
    mk.upload(dev, "cpu", serving=meta)
    assert not calls  # a small index travels plain
    monkeypatch.setattr(mk, "PACK_MIN_BYTES", 0)
    mk.upload(dev, "cpu", serving=meta)
    assert len(calls) == 1
    mk.upload(dev, "cpu")  # no serving meta: the whole index, plain
    mk.upload(dev, "cpu", serving=meta, pack=False)
    assert len(calls) == 1
    b1_dev, b1_meta = mk.device_index_from_image(
        mk.image_from_reference(images[20][0]),
        PortConfig(k=20, max_read_len=72, seed_index="bucket1", **SERVING))
    mk.upload(b1_dev, "cpu", serving=b1_meta)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="cuckoo"):
        mk.upload(b1_dev, "cpu", serving=b1_meta, pack=True)


@pytest.mark.parametrize("k", [20, 64])
def test_emit_through_packed_upload_is_identical(images, tmp_path, k):
    image, seqs = images[k]
    L = 72 if k == 20 else 96
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, _fuzz_reads(np.random.default_rng(k), seqs, k=k, n=300,
                                L=L))
    cfg = PortConfig(k=k, batch_size=128, max_read_len=L, **SERVING)
    outs = []
    for pack in (False, True):
        al = Pseudoaligner(image, cfg, device="cpu")
        dev_np, _ = mk.device_index_from_image(image, cfg)
        al.dev = mk.upload(dev_np, "cpu", serving=al.meta, pack=pack)
        buf = io.BytesIO()
        try:
            assert al.emit_fastq(fq, buf)[0] == 300
        finally:
            al.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count(b"\n") == 300
