"""PyTorch port vs the JAX reference: the owner side of the graph-sharded
walk's routed fetch.

`graph_walk.serve_fetch`, the plain version of K11 (csrc/gfetch.cu),
against what the reference's `_routed_fetch_factory` computes between its
two all_to_alls: the owner's gather of the node row from its block and
`_extract_pool_window_rows` over its pool slice.  Requests cover every
node of each shard's block, with deltas over the node's real window
range (the left fetch's pko - (L-1) and the forward fetch's koff + k) and
ones that put the window start below 0 (clamped to 0), at S = 1, 2 and 4,
for the rows-only and the windowed fetch, at read lengths whose reference
pools have overlapping rows (L = 64) and aligned ones (L = 96).  Slots with
node < 0 are answered with zeros.  Tolerance 0."""

import types

import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.ops.map_kernel import (
    _extract_pool_window_rows,
    device_index_from_image,
)
from pseudoaligner_tpu.parallel.sharded_index import (
    build_sharded_graph as ref_build_graph,
)
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.parallel import graph_walk as gw
from pseudoaligner_torch.parallel import sharded_index as si

from .torch_helpers import build, family_transcripts, image_from_reference


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(8080)
    seqs, names, gmap = family_transcripts(rng, n_genes=3, n_iso=4)
    return build(seqs, names, gmap, k=20)


def _requests(image, S, nb, L, k):
    """[S, b, 2] int32 requests of every node of every block: each node
    with the deltas at the ends and the middle of its left and forward
    windows, one that puts the window start below 0, and a -1 slot per
    node; rows spread over the S senders."""
    reqs = []
    for n in range(image.n_nodes):
        ln = int(image.node_len[n])
        start = int(image.node_start[n])
        for d in (-(L - 1), (ln - 1) // 2 - (L - 1), ln - 1 - (L - 1), k,
                  (k + ln) // 2, ln, -(start + 300)):
            reqs.append((n, d))
        reqs.append((-1, 0))
    a = np.asarray(reqs, dtype=np.int32)
    b = -(-len(a) // S)
    out = np.full((S * b, 2), (-1, 0), dtype=np.int32)
    out[:len(a)] = a
    return out.reshape(S, b, 2)


def _reference(meta, graph, me, nb, recv, want_win):
    """The reference's owner side: the row of clip(node - me*Nb, 0, Nb-1)
    and the window of cmp_words words from max(row[0] + delta, 0)."""
    import jax.numpy as jnp

    rn = recv[..., 0].reshape(-1)
    rd = recv[..., 1].reshape(-1)
    rows = np.asarray(graph.node_rows[me])
    nrow = rows[np.clip(rn - me * nb, 0, rows.shape[0] - 1)]
    if not want_win:
        return nrow, None
    q = np.clip(nrow[:, 0].astype(np.int64) + rd, 0, None).astype(np.int32)
    win = _extract_pool_window_rows(meta, jnp.asarray(graph.pools[me]),
                                    jnp.asarray(q))
    return nrow, np.asarray(win)


@pytest.mark.parametrize("L", [64, 96])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("windowed", [False, True], ids=["rows", "window"])
def test_serve_fetch_matches_reference(image, S, L, windowed):
    cfg = dict(k=20, batch_size=64, max_read_len=L, distinct_cap=0,
               max_nodes=64, lazy_seeds=False)
    _, meta = device_index_from_image(image, AlignerConfig(**cfg))
    pimage = image_from_reference(image)
    _, pmeta = mk.device_index_from_image(pimage, PortConfig(**cfg))
    ref_graph, nb = ref_build_graph(image, meta, S)
    graph, pnb = si.build_sharded_graph(pimage, pmeta, S)
    assert pnb == nb
    ww = gw.window_words(pmeta) if windowed else 0
    assert ww < meta.cmp_words
    kmeta = types.SimpleNamespace(n_shards=S, node_block=nb)
    recv = _requests(image, S, nb, L, pmeta.k)
    none = recv[..., 0].reshape(-1) < 0
    served = 0
    for me in range(S):
        g = si.upload_graph(graph, me, "cpu")
        got = gw.serve_fetch(kmeta, me, torch.from_numpy(recv), g.node_rows,
                             g.pools, ww)
        assert got.dtype == torch.int32 and got.shape == (*recv.shape[:2],
                                                          12 + ww)
        got = got.reshape(-1, 12 + ww).numpy()
        assert not got[none].any()
        # the slots of this block's nodes (every other node is clipped into
        # the block, as in the reference)
        n = recv[..., 0].reshape(-1)
        mine = ~none & (np.minimum(n // nb, S - 1) == me)
        served += int(mine.sum())
        nrow, win = _reference(meta, ref_graph, me, nb, recv, windowed)
        assert np.array_equal(got[~none, :12], nrow[~none])
        if windowed:
            assert np.array_equal(got[~none, 12:],
                                  win[~none, :ww].view(np.int32))
    assert served == int((~none).sum())
