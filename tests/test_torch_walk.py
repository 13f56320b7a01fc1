"""PyTorch port vs the JAX reference: the whole mapping step
(`map_batch_packed`: seed pass + walk + output encoding), every MapResult
field and dtype, exact.

The reference runs with left_compact=0.0: its lane-compacted left loop
flags lanes beyond the compacted buffer -3, which a per-read walk has no
counterpart for (tests/test_torch_serving.py holds the emitted records
equal at the default left_compact instead)."""

import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.models.aligner import _MAP_STEP_JIT
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_torch.ops import map_kernel as mk

from .torch_helpers import (
    _fuzz_reads,
    assert_results_equal,
    build,
    family_transcripts,
    make_batch,
    polyt_transcripts,
    port_index,
)

SERVING = dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
               max_nodes=7)
CONFIGS = {
    # the CLI's serving shape at L = 64 (cli.serving_config)
    "serving": (20, 64, SERVING),
    "serving_L128": (20, 128, dict(SERVING, max_walk_iters=6, max_nodes=10)),
    "overflow_dc2": (20, 64, dict(distinct_cap=2, max_walk_iters=0,
                                  max_left_iters=0, max_nodes=64)),
    "compact_uncapped": (20, 64, dict(distinct_cap=12, max_walk_iters=0,
                                      max_left_iters=0, max_nodes=64)),
    # the exact re-map fallback's shape
    "full_uncapped": (20, 64, dict(distinct_cap=0, max_nodes=128,
                                   bitset_tx_threshold=0)),
    "full_eager_seeds": (20, 64, dict(distinct_cap=0, max_nodes=128,
                                      bitset_tx_threshold=0,
                                      lazy_seeds=False)),
    "mismatch0": (20, 64, dict(SERVING, allowed_mismatches=0)),
    "mismatch3": (20, 64, dict(SERVING, allowed_mismatches=3)),
    "k64_L96": (64, 96, dict(distinct_cap=3, max_walk_iters=4,
                             max_left_iters=2, max_nodes=8)),
}


@pytest.fixture(scope="module")
def data():
    out = {}
    rng = np.random.default_rng(2024)
    seqs, names, gmap = family_transcripts(rng)
    out[20] = (build(seqs, names, gmap, k=20),
               _fuzz_reads(rng, seqs, k=20, n=320, L=60)
               + _fuzz_reads(rng, seqs, k=20, n=64, L=120))
    rng = np.random.default_rng(4096)
    seqs, names, gmap = polyt_transcripts(rng)
    seqs2, _, _ = family_transcripts(rng, n_genes=2, n_iso=4)
    seqs += seqs2
    names += [f"f{i}" for i in range(len(seqs2))]
    gmap.update({f"f{i}": "FG" for i in range(len(seqs2))})
    out[64] = (build(seqs, names, gmap, k=64),
               _fuzz_reads(rng, seqs, k=64, n=240, L=90)
               + [("polyT", np.full(90, 3, np.uint8))])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_map_batch_packed_matches_reference(data, name):
    k, L, kw = CONFIGS[name]
    image, reads = data[k]
    reads = [(rid, w[:L]) for rid, w in reads]
    cfg = AlignerConfig(k=k, batch_size=len(reads), max_read_len=L,
                        left_compact=0.0, pool_overlap=False, **kw)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = make_batch(reads, len(reads) + 11, L)  # padding rows
    packed = ref_mk.pack_reads_host(codes)
    ref = _MAP_STEP_JIT(meta, dev_np, packed, lens)
    idx, pmeta = port_index(dev_np, meta)
    got = mk.map_batch_packed(pmeta, idx,
                              torch.from_numpy(packed.view(np.int32)),
                              torch.from_numpy(lens))
    assert_results_equal(ref, got, name)
    mapped = np.asarray(ref.mapped)
    assert mapped.any() and not mapped[len(reads):].any()
    # the data exercises both re-map markers
    marker = {"serving": -3, "overflow_dc2": -2}.get(name)
    if marker is not None:
        assert (np.asarray(ref.ec_distinct)[:, -1] == marker).any()


def test_plain_walk_lens_dtype_and_empty_batch(data):
    """A batch of only padding rows maps to nothing (every read shorter
    than k comes out unmapped)."""
    image, _ = data[20]
    cfg = AlignerConfig(k=20, max_read_len=64, pool_overlap=False, **SERVING)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    idx = mk.upload(dev_np, "cpu")
    codes = np.ones((5, 64), np.uint8)
    lens = np.array([0, 1, 19, 0, 0], np.int32)
    res = mk.map_batch_packed(
        meta, idx,
        torch.from_numpy(mk.pack_reads_host(codes).view(np.int32)),
        torch.from_numpy(lens))
    assert not res.mapped.any()
    assert (res.ec_distinct == -1).all() and (res.coverage == 0).all()
