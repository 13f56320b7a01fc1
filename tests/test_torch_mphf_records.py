"""The MPHF's slot records: an upload that keeps the MPHF holds each slot's
key words, node and offset side by side in one [nk, record_words(W)]
tensor (`DeviceIndex.kmer_records`), with kmer_keys, kmer_node and
kmer_offset its column ranges, so K1, K2's lazy seek, K3 and K8 verify a
key and read its values with one load.

Pinned here on the CPU, at every key width W = 1-4: the views hold the
image's arrays; the storage is counted once, the bytes of the separate
arrays at W = 2; `pa.serve_init.mphf_record_bytes` counts the records
(0 for a cuckoo or bucket1 serving upload, which carries the MPHF arrays
empty); separate tensors are refused, not copied; and the plain passes
give the same MapResult on the record views as on separate arrays.

This file imports only the port (no jax, no pseudoaligner_tpu).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pseudoaligner_torch import spans
from pseudoaligner_torch.config import AlignerConfig
from pseudoaligner_torch.index.builder import build_index
from pseudoaligner_torch.ops import kernels
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.parallel import sharded_index as si

# key words W -> (k, L)
SHAPES = {1: (15, 40), 2: (20, 64), 3: (33, 64), 4: (64, 96)}
RECORD_BYTES = "pa.serve_init.mphf_record_bytes"


@pytest.fixture(scope="module", params=sorted(SHAPES),
                ids=lambda W: f"W{W}")
def indexed(request):
    """(W, k, L, index image, transcripts): random transcripts and
    isoforms cut from them by deletions."""
    W = request.param
    k, L = SHAPES[W]
    rng = np.random.default_rng(170 + W)
    seqs = [rng.integers(0, 4, int(rng.integers(150, 400))).astype(np.uint8)
            for _ in range(8)]
    for s in seqs[:4]:
        a = int(rng.integers(40, 100))
        seqs.append(np.concatenate([s[:a], s[a + 30:]]))
    names = [f"t{i}" for i in range(len(seqs))]
    image = build_index(seqs, names, {n: f"g{i % 3}" for i, n in
                                      enumerate(names)}, k=k)
    assert image.kmer_keys.shape[1] == W
    return W, k, L, image, seqs


def _upload(image, k, L, mode, serving):
    cfg = AlignerConfig(k=k, max_read_len=L, seed_index=mode)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    spans.reset()
    up = mk.upload(dev_np, "cpu", serving=meta if serving else None)
    return meta, up, spans.snapshot()["counters"]


@pytest.mark.parametrize("serving", [False, True],
                         ids=["whole", "mphf-serving"])
def test_upload_records_hold_the_image_slots(indexed, serving):
    """The whole upload (batch_stats') and the MPHF serving upload: one
    record tensor whose column ranges are the image's keys, nodes and
    offsets, zero padding after them; nbytes counts its storage once, and
    the counter holds its bytes."""
    W, k, L, image, _ = indexed
    _meta, up, counters = _upload(image, k, L, "mphf", serving)
    nk = image.kmer_keys.shape[0]
    rw = mk.record_words(W)
    assert rw == (4 if W <= 2 else 8)
    rec = up.kmer_records
    assert rec.shape == (nk, rw) and rec.dtype == torch.int32
    assert rec.is_contiguous()
    assert up.kmer_keys.data_ptr() == rec.data_ptr()
    assert up.kmer_node.data_ptr() == rec.data_ptr() + 4 * W
    assert up.kmer_offset.data_ptr() == rec.data_ptr() + 4 * (W + 1)
    assert np.array_equal(up.kmer_keys.numpy().view(np.uint32),
                          image.kmer_keys)
    assert np.array_equal(up.kmer_node.numpy(),
                          image.kmer_node.astype(np.int32))
    assert np.array_equal(up.kmer_offset.numpy(),
                          image.kmer_offset.astype(np.int32))
    assert not rec[:, W + 2:].any()
    rest = sum(getattr(up, f.name).numel() * 4
               for f in dataclasses.fields(mk.DeviceIndex)
               if f.name not in mk.RECORD_ARRAYS)
    assert up.nbytes() == rest + nk * rw * 4
    if W == 2:  # a record is the 16 bytes of the separate arrays
        assert nk * rw * 4 == (image.kmer_keys.nbytes
                               + 4 * len(image.kmer_node)
                               + 4 * len(image.kmer_offset))
    assert counters[RECORD_BYTES] == nk * rw * 4
    assert counters["pa.serve_init.h2d_bytes"] == up.nbytes()


@pytest.mark.parametrize("mode", ["cuckoo", "bucket1"])
def test_other_serving_uploads_carry_no_records(indexed, mode):
    """A cuckoo or bucket1 serving upload carries the MPHF arrays empty,
    as before; its records are empty and the counter reads 0."""
    W, k, L, image, _ = indexed
    meta, up, counters = _upload(image, k, L, mode, True)
    for name in mk.MPHF_ARRAYS:
        assert getattr(up, name).shape[0] == 0, name
    assert up.kmer_keys.shape == (0, W)
    assert up.kmer_records.shape == (0, mk.record_words(W))
    assert counters[RECORD_BYTES] == 0
    with pytest.raises(ValueError, match="MPHF arrays"):
        kernels._check_mphf(meta, up, torch.device("cpu"))


def _separate(up):
    """The upload with its slot arrays as separate contiguous tensors."""
    return dataclasses.replace(
        up, kmer_keys=up.kmer_keys.contiguous(),
        kmer_node=up.kmer_node.clone(), kmer_offset=up.kmer_offset.clone())


def _record_cases():
    """(name, thunk that must raise ValueError) on a W = 1 and a W = 3
    record upload."""
    cases = []
    for W in (1, 3):
        n = 5
        keys = np.arange(n * W, dtype=np.uint32).reshape(n, W)
        rec = mk.record_upload(keys, (np.arange(n, dtype=np.int32),
                                      np.arange(n, 2 * n, dtype=np.int32)),
                               "cpu")
        k, node, off = rec[:, :W], rec[:, W], rec[:, W + 1]
        cases += [
            (f"W{W}-separate", lambda k=k, node=node, off=off: mk.records(
                k.contiguous(), node.clone(), off.clone())),
            (f"W{W}-order", lambda k=k, node=node, off=off: mk.records(
                k, off, node)),
            (f"W{W}-other-storage", lambda k=k, node=node, off=off:
             mk.records(k, node, off.clone())),
        ]
    packed = torch.zeros((4, 3), dtype=torch.int32)  # W = 1, rows of 3
    cases.append(("rows-of-3", lambda: mk.records(
        packed[:, :1], packed[:, 1], packed[:, 2])))
    return cases


CASES = _record_cases()


@pytest.mark.parametrize("thunk", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_records_refuse_separate_tensors(thunk):
    """The kernels' view of the records exists only over one storage, in
    the record layout: separate tensors, values out of order and rows of
    another width are refused, not copied."""
    with pytest.raises(ValueError, match="record"):
        thunk()


def test_record_layout_checks_on_uploads(indexed):
    """kmer_records and the wrappers' MPHF check refuse an index whose
    slot arrays are separate tensors; a K8 shard's records come from the
    same helpers, keys and values its column ranges."""
    W, k, L, image, _ = indexed
    meta, up, _ = _upload(image, k, L, "mphf", True)
    dev = torch.device("cpu")
    kernels._check_mphf(meta, up, dev)
    sep = _separate(up)
    with pytest.raises(ValueError, match="record"):
        sep.kmer_records
    with pytest.raises(ValueError, match="record"):
        kernels._check_mphf(meta, sep, dev)
    lookup, _ = si.build_sharded_lookup(image, 2)
    shard = si.upload_lookup(lookup, 1, "cpu")
    assert shard.records.shape == (lookup.keys.shape[1], mk.record_words(W))
    assert shard.keys.data_ptr() == shard.records.data_ptr()
    bad = shard._replace(values=shard.values.clone())
    with pytest.raises(ValueError, match="record"):
        bad.records


def _reads(rng, seqs, L, k, n=120):
    """Exact, SNP-bearing, reversed and random windows, and reads shorter
    than k: (packed [n, ceil(L/16)] int32, lens [n] int32)."""
    codes = np.zeros((n, L), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        s = seqs[int(rng.integers(len(seqs)))]
        m = min(len(s), int(rng.integers(k - 3, L + 1)))
        st = int(rng.integers(0, len(s) - m + 1))
        w = s[st:st + m].copy()
        if i % 4 == 1:
            w[int(rng.integers(m))] ^= 1
        elif i % 4 == 2:
            w = w[::-1].copy()
        elif i % 4 == 3:
            w = rng.integers(0, 4, m).astype(np.uint8)
        codes[i, :m] = w
        lens[i] = m
    packed = torch.from_numpy(mk.pack_reads_host(codes).view(np.int32))
    return packed, torch.from_numpy(lens)


@pytest.mark.parametrize("shape", ["serving", "full"])
def test_plain_map_on_records_equals_separate_arrays(indexed, shape):
    """The plain passes under the MPHF read the record views: the same
    next-hit table and every MapResult field as on separate arrays, and
    some probes hit."""
    W, k, L, image, seqs = indexed
    kw = (dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
               max_nodes=7) if shape == "serving"
          else dict(distinct_cap=0, max_nodes=2 * L))
    cfg = AlignerConfig(k=k, max_read_len=L, seed_index="mphf", **kw)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    up = mk.upload(dev_np, "cpu", serving=meta)
    sep = _separate(up)
    packed, lens = _reads(np.random.default_rng(W), seqs, L, k)
    nh3 = mk.seed_tables(meta, up, packed, lens)
    assert torch.equal(nh3, mk.seed_tables(meta, sep, packed, lens))
    assert (nh3[..., 1] >= 0).any()
    got = mk.map_batch_packed(meta, up, packed, lens)
    want = mk.map_batch_packed(meta, sep, packed, lens)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.mapped.any()
