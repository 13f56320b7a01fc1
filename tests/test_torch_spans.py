"""The port's span and counter registry (pseudoaligner_torch/spans.py), the
spans the program opens where its work happens, and the benchmark's
readers of them (portbench/metrics/), all on the CPU."""

import importlib.util
import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from pseudoaligner_torch import spans
from pseudoaligner_torch.config import AlignerConfig
from pseudoaligner_torch.index.builder import build_index
from pseudoaligner_torch.models.aligner import Pseudoaligner
from pseudoaligner_torch.ops import map_kernel as mk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
               max_nodes=8)
L = 72


@pytest.fixture(autouse=True)
def clean_registry():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def tiny():
    """A tiny index (random transcripts with a shared stretch, so reads
    cross class boundaries) and 150 reads of L bases from it."""
    rng = np.random.default_rng(1616)
    shared = rng.integers(0, 4, 120).astype(np.uint8)
    seqs = [np.concatenate([rng.integers(0, 4, int(rng.integers(150, 300))),
                            shared, rng.integers(0, 4, 100)]).astype(np.uint8)
            for _ in range(8)]
    names = [f"t{i}" for i in range(len(seqs))]
    image = build_index(seqs, names, {n: f"g{i // 2}"
                                      for i, n in enumerate(names)}, k=20)
    reads = []
    for i in range(150):
        s = seqs[int(rng.integers(len(seqs)))]
        st = int(rng.integers(0, len(s) - L))
        w = s[st:st + L].copy()
        if i % 5 == 0:
            w[int(rng.integers(L))] ^= 1
        reads.append((f"r{i}", w))
    return image, reads


def _write_fastq(path, reads):
    with open(path, "wb") as f:
        for rid, w in reads:
            s = "".join("ACGT"[b] for b in w)
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n".encode())


def _spans():
    return spans.snapshot()["spans"]


def test_count_total_and_nested_self():
    for _ in range(3):
        with spans.span("pa.t.outer"):
            with spans.span("pa.t.inner"):
                sum(range(20000))
            with spans.span("pa.t.inner"):
                sum(range(20000))
            sum(range(20000))
    spans.count("pa.t.n")
    spans.count("pa.t.n", 4)
    snap = spans.snapshot()
    out, inner = snap["spans"]["pa.t.outer"], snap["spans"]["pa.t.inner"]
    assert (out["count"], inner["count"]) == (3, 6)
    assert inner["self_s"] == inner["total_s"] > 0
    assert out["self_s"] > 0
    assert out["self_s"] == pytest.approx(
        out["total_s"] - inner["total_s"], abs=1e-9)
    assert snap["counters"] == {"pa.t.n": 5}
    recs = snap["records"]
    assert len(recs) == 9
    assert all(parent == "pa.t.outer" for name, _a, _b, parent in recs
               if name == "pa.t.inner")
    assert all(parent is None and a <= b for name, a, b, parent in recs
               if name == "pa.t.outer")


def test_a_raising_block_is_still_timed():
    with pytest.raises(ValueError):
        with spans.span("pa.t.raise"):
            raise ValueError("boom")
    assert _spans()["pa.t.raise"]["count"] == 1
    with spans.span("pa.t.after"):
        pass
    assert spans.snapshot()["records"][-1][3] is None  # the stack unwound


def test_ring_keeps_the_newest_records():
    for i in range(spans.RING + 5):
        with spans.span("pa.t.ring"):
            pass
    snap = spans.snapshot()
    assert snap["spans"]["pa.t.ring"]["count"] == spans.RING + 5
    recs = snap["records"]
    assert len(recs) == spans.RING
    assert recs[-1][1] >= recs[0][2]


def test_reset_forgets_everything():
    with spans.span("pa.t.x"):
        spans.count("pa.t.c")
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counters": {}, "records": []}


@pytest.mark.parametrize("n_threads", [4, (os.cpu_count() or 1) + 1])
def test_threads_lose_no_count(n_threads):
    """Spans and counters from many threads at once, the interpreter
    switching threads as often as it can: every one is counted, and each
    thread's spans nest only under its own."""
    per = 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        go = threading.Barrier(n_threads)

        def work(i):
            go.wait(timeout=10)
            for _ in range(per):
                with spans.span(f"pa.t.thread{i}"):
                    with spans.span("pa.t.shared"):
                        spans.count("pa.t.n")

        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = spans.snapshot()
    assert snap["spans"]["pa.t.shared"]["count"] == n_threads * per
    assert snap["counters"]["pa.t.n"] == n_threads * per
    for i in range(n_threads):
        own = snap["spans"][f"pa.t.thread{i}"]
        assert own["count"] == per
        assert own["self_s"] >= 0
    assert {p for n, _a, _b, p in snap["records"]
            if n == "pa.t.shared"} == {f"pa.t.thread{i}"
                                       for i in range(n_threads)}


def test_span_is_a_user_annotation_under_the_profiler(tmp_path):
    """Inside a torch.profiler session a span is a user_annotation of its
    name in the Chrome trace, around the ops it covers."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("pa.t.annotated"):
            (x * 3).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == "pa.t.annotated"]
    assert len(ann) == 1
    a0, a1 = ann[0]["ts"], ann[0]["ts"] + ann[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("name") == "aten::mul"]
    assert ops and all(a0 <= e["ts"] and e["ts"] + e["dur"] <= a1
                       for e in ops)
    assert _spans()["pa.t.annotated"]["count"] == 1


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    for _ in range(10):
        with spans.span("pa.t.quiet"):
            pass
    assert entered == []
    assert _spans()["pa.t.quiet"]["count"] == 10


def test_serve_init_spans(tiny):
    """A CPU cuckoo aligner records its set-up's parts once each; the
    copies' bytes are the uploaded index's; a packed upload adds the pack
    and the unpack."""
    image, _ = tiny
    cfg = AlignerConfig(k=20, max_read_len=L, **SERVING)
    al = Pseudoaligner(image, cfg, device="cpu")
    snap = spans.snapshot()
    s = snap["spans"]
    for name in ("pa.serve_init", "pa.serve_init.table",
                 "pa.serve_init.arrays", "pa.serve_init.h2d"):
        assert s[name]["count"] == 1, name
    assert "pa.serve_init.pack" not in s  # below the packed upload's gate
    assert "pa.serve_init.unpack" not in s
    assert snap["counters"]["pa.serve_init.h2d_bytes"] == al.dev.nbytes()
    parent = {n: p for n, _a, _b, p in snap["records"]}
    assert parent["pa.serve_init.table"] == "pa.serve_init.arrays"
    assert parent["pa.serve_init.arrays"] == "pa.serve_init"
    assert parent["pa.serve_init.h2d"] == "pa.serve_init"
    assert s["pa.serve_init"]["self_s"] == pytest.approx(
        s["pa.serve_init"]["total_s"] - s["pa.serve_init.arrays"]["total_s"]
        - s["pa.serve_init.h2d"]["total_s"], abs=1e-9)

    spans.reset()
    mk.upload(*mk.device_index_from_image(image, cfg)[:1], "cpu",
              serving=al.meta, pack=True)
    s = _spans()
    for name in ("pa.serve_init.pack", "pa.serve_init.unpack",
                 "pa.serve_init.h2d"):
        assert s[name]["count"] == 1, name


def test_mphf_builds_no_table(tiny):
    image, _ = tiny
    Pseudoaligner(image, AlignerConfig(k=20, max_read_len=L,
                                       seed_index="mphf", **SERVING),
                  device="cpu")
    s = _spans()
    assert "pa.serve_init.table" not in s
    assert s["pa.serve_init.arrays"]["count"] == 1


def test_one_step_span_per_batch(tiny):
    """map_batch and map_batch_packed open one `pa.step` each; map_batch's
    own call of the packed step opens no second."""
    image, reads = tiny
    cfg = AlignerConfig(k=20, max_read_len=L, **SERVING)
    al = Pseudoaligner(image, cfg, device="cpu")
    codes = torch.from_numpy(np.stack([w for _, w in reads[:16]]))
    lens = torch.full((16,), L, dtype=torch.int32)
    spans.reset()
    mk.map_batch(al.meta, al.dev, codes, lens)
    assert _spans()["pa.step"]["count"] == 1
    packed = torch.from_numpy(mk.pack_reads_host(codes.numpy()).view(np.int32))
    assert _spans()["pa.host_pack"]["count"] == 1
    mk.map_batch_packed(al.meta, al.dev, packed, lens)
    assert _spans()["pa.step"]["count"] == 2


RECORD_PATH = ("pa.prep.fetch", "pa.prep.remap_dispatch", "pa.prep.group",
               "pa.prep.siglists", "pa.fin.remap_collect", "pa.fin.patch",
               "pa.fin.emit", "pa.step", "pa.host_pack")


def test_emit_fastq_records_the_record_path(tiny, tmp_path):
    """Each batch of a CPU emit_fastq passes every phase once, on the main
    thread or the render worker; the CPU pins nothing."""
    image, reads = tiny
    fq = tmp_path / "r.fq"
    _write_fastq(fq, reads)
    cfg = AlignerConfig(k=20, max_read_len=L, batch_size=32, **SERVING)
    al = Pseudoaligner(image, cfg, device="cpu")
    spans.reset()
    n, _ = al.emit_fastq(str(fq), io.BytesIO())
    assert n == len(reads)
    snap = spans.snapshot()
    batches = -(-len(reads) // 32)
    for name in RECORD_PATH:
        assert snap["spans"][name]["count"] == batches, name
    assert "pa.pinned_allocs" not in snap["counters"]


def test_emit_fastq_paired_records_its_phases(tiny, tmp_path):
    image, reads = tiny
    r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    _write_fastq(r1, reads[:100])
    _write_fastq(r2, reads[50:150])
    cfg = AlignerConfig(k=20, max_read_len=L, batch_size=64, **SERVING)
    al = Pseudoaligner(image, cfg, device="cpu")
    spans.reset()
    assert al.emit_fastq_paired(str(r1), str(r2), io.BytesIO()) == 100
    s = _spans()
    batches = -(-100 // 32)
    for name in ("pa.pcombine", "pa.pfin.remap_collect", "pa.pfin.group",
                 "pa.pfin.intersect", "pa.pfin.overrides", "pa.pfin.emit",
                 "pa.step"):
        assert s[name]["count"] == batches, name
    assert s["pa.pread"]["count"] == batches + 1  # and the end of input


def _reader(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "span_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# metric -> (its span, read as "total_s" or "self_s")
READERS = {
    "serve_init_s.table": ("pa.serve_init.table", "total_s"),
    "serve_init_s.arrays": ("pa.serve_init.arrays", "self_s"),
    "serve_init_s.pack": ("pa.serve_init.pack", "total_s"),
    "serve_init_s.h2d": ("pa.serve_init.h2d", "total_s"),
    "serve_init_s.unpack": ("pa.serve_init.unpack", "total_s"),
    "serve_init_s.other": ("pa.serve_init", "self_s"),
    "kernel_load_s": ("pa.kernels.load", "total_s"),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_metric_reader(metric):
    """None while its span is absent; then the registry's value (a child
    span inside makes self and total differ)."""
    read = _reader(metric)
    name, field = READERS[metric]
    assert read(None) is None
    with spans.span(name):
        with spans.span("pa.t.child"):
            sum(range(20000))
    got = read(None)
    want = _spans()[name][field]
    assert got == want and got > 0
    if field == "self_s":
        assert got < _spans()[name]["total_s"]


def test_metrics_are_declared():
    """Each reader has its BENCHMARK.json entry: a program span that moves
    setup_s, in the cells that run its code."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        by_name = {m["name"]: m for m in json.load(f)["per_layer"]}
    for metric in READERS:
        m = by_name[metric]
        assert (m["source"], m["moves"], m["better"], m["unit"]) == (
            "program_span", "setup_s", "lower", "s"), metric
        assert "step-se75.mphf" in m["workloads"] or metric in (
            "serve_init_s.table", "serve_init_s.pack", "serve_init_s.unpack")
        assert "step-se75.cuckoo" in m["workloads"]


@pytest.mark.gpu
def test_spans_on_the_card(tiny, tmp_path):
    """On a CUDA device: K5's device span of a packed upload, and one
    `pa.step` annotation a batch in the profiler's trace, on the clock of
    the kernels each batch launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    image, reads = tiny
    cfg = AlignerConfig(k=20, max_read_len=L, **SERVING)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    idx = mk.upload(dev_np, "cuda", serving=meta, pack=True)
    unpack = _spans()["pa.serve_init.unpack"]
    assert unpack["count"] == 1 and unpack["total_s"] > 0
    codes = torch.from_numpy(np.stack([w for _, w in reads[:64]])).cuda()
    lens = torch.full((64,), L, dtype=torch.int32, device="cuda")
    mk.map_batch(meta, idx, codes, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            mk.map_batch(meta, idx, codes, lens)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    steps = sorted(e["ts"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "pa.step")
    seeds = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                   and "seed_kernel" in e.get("name", ""))
    assert len(steps) == 3 and len(seeds) == 3
    assert all(a <= b for a, b in zip(steps, seeds))
