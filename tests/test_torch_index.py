"""PyTorch port vs the JAX reference: device-index build and upload."""

import dataclasses

import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_torch.ops import map_kernel as mk

from .torch_helpers import _random_transcripts, build, polyt_transcripts

ARRAYS = ("pool_rows", "node_row", "cuckoo", "cuckoo_vals", "mphf_bits",
          "mphf_ranks", "kmer_keys", "kmer_node", "kmer_offset", "ec_bits")


@pytest.fixture(scope="module", params=["k20", "k64_polyT"])
def image_and_config(request):
    if request.param == "k20":
        rng = np.random.default_rng(20)
        image = build(*_random_transcripts(rng, n=16), k=20)
        cfg = AlignerConfig(k=20, max_read_len=64, pool_overlap=False)
    else:
        rng = np.random.default_rng(64)
        image = build(*polyt_transcripts(rng), k=64)
        cfg = AlignerConfig(k=64, max_read_len=96, pool_overlap=False)
    return image, cfg


def test_device_index_matches_reference(image_and_config):
    image, cfg = image_and_config
    ref_dev, ref_meta = ref_mk.device_index_from_image(image, cfg)
    dev, meta = mk.device_index_from_image(image, cfg)
    for name in ARRAYS:
        a, b = getattr(ref_dev, name), getattr(dev, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for f in dataclasses.fields(mk.MapMeta):
        assert getattr(meta, f.name) == getattr(ref_meta, f.name), f.name
    if image.k == 64:
        assert meta.ones_node >= 0  # the poly-T 64-mer really relocated


def test_from_jax_device_index_round_trip(image_and_config):
    image, cfg = image_and_config
    ref_dev, ref_meta = ref_mk.device_index_from_image(image, cfg)
    dev, meta = mk.from_jax_device_index(ref_dev, ref_meta)
    own_dev, own_meta = mk.device_index_from_image(image, cfg)
    assert meta == own_meta
    up = mk.upload(dev, "cpu")
    for name in ARRAYS:
        t = getattr(up, name)
        assert t.dtype == torch.int32 and t.device.type == "cpu", name
        # the upload carries uint32 words as their int32 bit patterns
        back = t.numpy().view(getattr(own_dev, name).dtype)
        assert np.array_equal(back, getattr(own_dev, name)), name
    assert up.nbytes() == sum(getattr(own_dev, n).nbytes for n in ARRAYS)


def test_from_jax_rejects_overlapped_pool():
    rng = np.random.default_rng(7)
    image = build(*_random_transcripts(rng, n=6), k=20)
    cfg = AlignerConfig(k=20, max_read_len=64, pool_overlap=True)
    ref_dev, ref_meta = ref_mk.device_index_from_image(image, cfg)
    assert ref_meta.pool_stride > 0
    with pytest.raises(ValueError):
        mk.from_jax_device_index(ref_dev, ref_meta)
    with pytest.raises(ValueError, match="seed_index"):
        mk.device_index_from_image(
            image, dataclasses.replace(cfg, seed_index="cuckoo3"))
