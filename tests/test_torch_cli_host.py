"""PyTorch port vs the JAX reference: the host-only subcommands.

`mappability` (tx_mappability.tsv), `idxstats` and `inspect` (stdout) of
the port's CLI on a synthetic index, byte for byte against the JAX CLI's
on the same file, at k = 20 and k = 64; and `mappability`'s exit 1 on a
k mismatch.  The module functions behind them (analyze_graph,
rust_f64_str) equal the reference's too."""

import math
import os

import numpy as np
import pytest

from pseudoaligner_torch import cli as port_cli
from pseudoaligner_torch import mappability as port_map
from pseudoaligner_tpu import cli as ref_cli
from pseudoaligner_tpu import mappability as ref_map
from pseudoaligner_tpu import serde as ref_serde

from .torch_helpers import build, family_transcripts, polyt_transcripts


@pytest.fixture(scope="module", params=[20, 64])
def index_file(request, tmp_path_factory):
    """(k, path, image) of a saved index: random transcripts, a poly-T one
    and isoform families (multi-transcript, multi-gene classes)."""
    k = request.param
    rng = np.random.default_rng(3100 + k)
    seqs, names, gmap = polyt_transcripts(rng)
    seqs2, names2, gmap2 = family_transcripts(rng, n_genes=3, n_iso=4)
    image = build(seqs + seqs2, names + names2, {**gmap, **gmap2}, k=k)
    path = str(tmp_path_factory.mktemp(f"idx{k}") / "idx.bin")
    ref_serde.save_index(image, path)
    return k, path, image


def _run(main, argv, capsysbinary):
    rc = main(argv)
    return rc, capsysbinary.readouterr().out


@pytest.mark.parametrize("cmd", ["mappability", "idxstats", "inspect"])
def test_host_subcommand_matches_reference(index_file, cmd, tmp_path,
                                           capsysbinary):
    k, path, image = index_file
    outs, files = {}, {}
    for tag, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = str(tmp_path / tag)
        argv = [cmd, "-i", path, "-k", str(k)]
        if cmd == "mappability":
            argv += ["-o", d]
        rc, outs[tag] = _run(main, argv, capsysbinary)
        assert rc == 0, tag
        if cmd == "mappability":
            with open(os.path.join(d, "tx_mappability.tsv"), "rb") as f:
                files[tag] = f.read()
    assert outs["port"] == outs["ref"]
    if cmd == "mappability":
        assert files["port"] == files["ref"]
        assert files["port"].count(b"\n") == image.n_tx + 1
    elif cmd == "idxstats":
        assert outs["port"].count(b"\n") == image.n_nodes
    else:
        assert outs["port"].startswith(f"k\t{k}\n".encode())


def test_mappability_k_mismatch_exits_1(index_file, tmp_path, capsysbinary):
    k, path, _ = index_file
    other = 64 if k == 20 else 20
    got = {}
    for tag, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = str(tmp_path / tag)
        got[tag] = _run(main, ["mappability", "-i", path, "-k", str(other),
                               "-o", d], capsysbinary)
        assert not os.path.exists(os.path.join(d, "tx_mappability.tsv"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1
    assert got["port"][1] == (f"Index was built with k={k}, not "
                              f"k={other}\n").encode()


def test_analyze_graph_matches_reference(index_file):
    _, _, image = index_file
    want = ref_map.analyze_graph(image)
    got = port_map.analyze_graph(image)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want[0].sum() > 0


@pytest.mark.parametrize("v", [0.0, 1.0, 0.5, 1 / 3, 2 / 3, 1e-7, 1.5e-12,
                               123456789.0, 1e22, -2.5e-5, math.nan,
                               math.inf, -math.inf])
def test_rust_f64_str_matches_reference(v):
    assert port_map.rust_f64_str(v) == ref_map.rust_f64_str(v)
