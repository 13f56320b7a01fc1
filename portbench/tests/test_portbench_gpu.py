"""On the card (marked gpu; skipped without one): the tiny cell through
the CUDA kernels is correct, and its traced run reads every per-layer
metric.  Run: python -m pytest -m gpu portbench/tests -q"""

import os
import time

import pytest

from harness import manifest
from harness.session import run_cell

import run as entry


@pytest.mark.gpu
@pytest.mark.parametrize("seed_index", ["cuckoo", "mphf"])
def test_tiny_cell_on_the_card(tmp_path, seed_index):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from conftest import make_bench

    root = str(tmp_path)
    man = make_bench(root, seed_index)
    cell = manifest.cell("tiny.cell", man, os.path.join(root, "portbench"))
    readers = {m.name: manifest.reader(m.name, cell.bench_dir)
               for m in cell.end_to_end + cell.per_layer}
    for trace in (False, True):
        r = run_cell(cell, 2**31 + 11, 1.0, trace, "cuda", time.time(),
                     cache_dir=root)
        line = entry.result_line(cell, r, trace, "gpu", readers)
        assert line["correct"] is True, line["checks"]
        want = cell.per_layer if trace else cell.end_to_end
        assert set(line["metrics"]) == {m.name for m in want}
