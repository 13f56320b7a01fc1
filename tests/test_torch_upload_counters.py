"""The upload's byte counters for the cuckoo table, pinned on the CPU:
`pa.serve_init.packed_bytes` (the bit-packed arrays K5 decodes: the
values, and the keys at W = 2) and `pa.serve_init.plain_key_bytes` (the
key rows that cross as they are: at W = 4 under the packed upload, every
row when unpacked), at k = 20 and 64, packed and unpacked, cuckoo and
MPHF; `pa.serve_init.h2d_bytes` counts what crossed, as before.

This file imports only the port (no jax, no pseudoaligner_tpu).
"""

import numpy as np
import pytest

from pseudoaligner_torch import spans
from pseudoaligner_torch.config import AlignerConfig
from pseudoaligner_torch.index.builder import build_index
from pseudoaligner_torch.ops import map_kernel as mk

# k -> (key words W, read length)
SHAPES = {20: (2, 64), 64: (4, 150)}
PACKED, PLAIN, H2D = ("pa.serve_init.packed_bytes",
                      "pa.serve_init.plain_key_bytes",
                      "pa.serve_init.h2d_bytes")


@pytest.fixture(scope="module", params=sorted(SHAPES), ids=lambda k: f"k{k}")
def indexed(request):
    """(k, W, L, index image) of random transcripts and isoforms cut from
    them by deletions."""
    k = request.param
    W, L = SHAPES[k]
    rng = np.random.default_rng(190 + k)
    seqs = [rng.integers(0, 4, int(rng.integers(200, 500))).astype(np.uint8)
            for _ in range(10)]
    for s in seqs[:5]:
        a = int(rng.integers(70, 120))
        seqs.append(np.concatenate([s[:a], s[a + 40:]]))
    names = [f"t{i}" for i in range(len(seqs))]
    image = build_index(seqs, names, {n: f"g{i % 4}" for i, n in
                                      enumerate(names)}, k=k)
    assert image.kmer_keys.shape[1] == W
    return k, W, L, image


def _upload(image, k, L, mode, pack):
    dev_np, meta = mk.device_index_from_image(
        image, AlignerConfig(k=k, max_read_len=L, seed_index=mode))
    spans.reset()
    up = mk.upload(dev_np, "cpu", serving=meta, pack=pack)
    counters = spans.snapshot()["counters"]
    spans.reset()
    return dev_np, meta, up, counters


def test_packed_cuckoo_upload(indexed):
    """Packed: at k = 20 keys and values ride packed and no key row
    crosses plain; at k = 64 only the values are packed, and every 4-word
    key row crosses as it is."""
    k, W, L, image = indexed
    dev_np, meta, up, c = _upload(image, k, L, "cuckoo", True)
    args, cfg = mk.pack_serving_args(dev_np, meta)
    S = cfg.S
    rows = np.asarray(dev_np.cuckoo)
    assert rows.shape == (S // 4, 4 * W)
    assert cfg.pack_keys == (k == 20)
    values = S * (4 + 2)  # vals_lo uint32 and vals_hi uint16 a slot
    if k == 20:
        keys = S * 4 + S * (cfg.PB - 4)  # keys_lo and keys_hi
        assert c[PACKED] == values + keys
        assert c[PLAIN] == 0
    else:
        assert "keys_lo" not in args and "keys_hi" not in args
        assert c[PACKED] == values
        assert c[PLAIN] == rows.nbytes == S * 16
    # what crossed: every other array as it is, the packed arrays, and the
    # key rows at k = 64 (which the unpack hands on as they came)
    rest = up.nbytes() - up.cuckoo.nbytes - up.cuckoo_vals.nbytes
    assert c[H2D] == rest + c[PACKED] + c[PLAIN]


def test_unpacked_cuckoo_upload(indexed):
    """Not packed: every key row crosses plain, nothing is packed, and
    the copies are the uploaded index's bytes."""
    k, W, L, image = indexed
    dev_np, _meta, up, c = _upload(image, k, L, "cuckoo", False)
    assert c[PACKED] == 0
    assert c[PLAIN] == np.asarray(dev_np.cuckoo).nbytes == up.cuckoo.nbytes
    assert c[PLAIN] == up.cuckoo.shape[0] * 4 * W * 4
    assert c[H2D] == up.nbytes()


@pytest.mark.parametrize("mode", ["mphf", "bucket1"])
def test_no_cuckoo_table_no_cuckoo_bytes(indexed, mode):
    """MPHF (a one-row dummy table) and bucket1 (rows of key, node and
    offset, no value array): both counters read 0, and the copies are the
    uploaded index's bytes."""
    k, _W, L, image = indexed
    _dev, _meta, up, c = _upload(image, k, L, mode, False)
    assert c[PACKED] == 0 and c[PLAIN] == 0
    assert c[H2D] == up.nbytes()


def test_the_default_gate_counts_plain_keys_below_it(indexed):
    """The serving default (pack=None) packs nothing at these sizes, under
    map_kernel.PACK_MIN_BYTES: the key rows cross plain at either k."""
    k, _W, L, image = indexed
    dev_np, _meta, up, c = _upload(image, k, L, "cuckoo", None)
    assert np.asarray(dev_np.cuckoo).nbytes + np.asarray(
        dev_np.cuckoo_vals).nbytes < mk.PACK_MIN_BYTES
    assert c[PACKED] == 0 and c[PLAIN] == up.cuckoo.nbytes > 0
    assert c[H2D] == up.nbytes()


def test_counters_add_up_over_uploads(indexed):
    """Counters accumulate: two uploads count twice, as the h2d bytes do."""
    k, _W, L, image = indexed
    dev_np, meta = mk.device_index_from_image(
        image, AlignerConfig(k=k, max_read_len=L))
    spans.reset()
    for _ in range(2):
        up = mk.upload(dev_np, "cpu", serving=meta, pack=True)
    c = spans.snapshot()["counters"]
    spans.reset()
    _d, _m, _u, once = _upload(image, k, L, "cuckoo", True)
    assert c[PACKED] == 2 * once[PACKED] and c[PLAIN] == 2 * once[PLAIN]
    assert c[H2D] == 2 * once[H2D]
    assert up.cuckoo.shape[0] > 0
