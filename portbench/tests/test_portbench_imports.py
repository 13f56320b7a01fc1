"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
pseudoaligner_tpu (the part before the first dot compared whole, since
pseudoaligner_torch begins with the JAX package's name); and the reference
loads nothing of pseudoaligner_torch."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "pseudoaligner_tpu"}

RUN = r"""
import sys, time
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
import conftest, run
from harness import manifest
from harness.session import run_cell
man = conftest.make_bench({tmp!r})
cell = manifest.cell("tiny.cell", man, {tmp!r} + "/portbench")
r = run_cell(cell, 9, 0.2, False, "cpu", time.time(), cache_dir={tmp!r})
assert r.checks["wrong_answers"][0] == 0
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.banned_modules())
"""

REF = r"""
import sys
sys.path[:0] = [{bench!r}]
import numpy as np
from reference.graph import RefGraph
from reference.walk import Shape
from reference.answers import answers
rng = np.random.default_rng(0)
tx = rng.integers(0, 4, 3000).astype(np.uint8)
g = RefGraph.build(tx, np.array([0, 3000]), 20)
a = answers(g, tx[None, 100:175], Shape(3, 3, 2, 7))
assert a.mapped.all()
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_names(code, tmp_path):
    src = code.format(bench=BENCH, tests=os.path.join(BENCH, "tests"),
                      root=ROOT, tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_run_loads_no_jax(tmp_path):
    lines = _top_names(RUN, tmp_path)
    loaded = set(eval(lines[-2]))
    assert "pseudoaligner_torch" in loaded
    assert not loaded & BANNED
    assert lines[-1] == "[]"


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    loaded = set(eval(_top_names(REF, tmp_path)[-1]))
    assert not loaded & (BANNED | {"pseudoaligner_torch", "torch"})


def test_no_source_under_portbench_imports_jax():
    for d, _, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(d, name)) as f:
                tree = ast.parse(f.read())
            mods = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods.add(node.module.split(".")[0])
            assert not mods & BANNED, (name, mods & BANNED)
            if os.path.basename(d) == "reference":
                assert "pseudoaligner_torch" not in mods, name
