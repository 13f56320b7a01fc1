"""What a configuration builds once per checkout, kept under .cache/:
the transcriptome (from its fixed seed), the index image (the port's own
builder and serde, the route of `cli.cmd_index`) and the reference graph.
All three are keyed by a digest of the recipe and k, so configurations
that share a transcriptome share them.  Each is written under a
temporary name and moved into place, so a run that is cut leaves no half
file behind.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

from . import transcriptome
from .manifest import BENCH_DIR

CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


@contextmanager
def _said(what: str):
    t = time.perf_counter()
    yield
    print(f"portbench: built {what} in {time.perf_counter() - t:.1f} s",
          file=sys.stderr, flush=True)


class Built:
    def __init__(self, config: dict, cache_dir: str = CACHE_DIR):
        self.k = int(config["k"])
        # the counts are the configuration's own keys, so `reduced` can
        # name them; the rest of the recipe is its `transcriptome` group
        self.recipe = dict(config["transcriptome"], genes=int(config["genes"]),
                           transcripts=int(config["transcripts"]))
        self.dir = os.path.join(cache_dir,
                                transcriptome.digest(self.recipe, self.k))
        os.makedirs(self.dir, exist_ok=True)

    @property
    def flat_path(self) -> str:
        return os.path.join(self.dir, "transcripts.npz")

    @property
    def index_path(self) -> str:
        return os.path.join(self.dir, "index.bin")

    @property
    def ref_path(self) -> str:
        return os.path.join(self.dir, "refgraph")

    def flat(self) -> transcriptome.Flat:
        if not os.path.exists(self.flat_path):
            with _said("the transcriptome"):
                seqs, _, _ = transcriptome.make(self.recipe)
                transcriptome.Flat.of(seqs).save(self.flat_path)
        return transcriptome.Flat.load(self.flat_path)

    def ensure_index(self) -> None:
        """Build and save the port's index image if it is not cached."""
        from pseudoaligner_torch.serde import save_index

        if not os.path.exists(self.index_path):
            from pseudoaligner_torch.index.builder import build_index

            with _said("the index image"):
                seqs, names, gene_map = transcriptome.make(self.recipe)
                image = build_index(seqs, names, gene_map, k=self.k)
                tmp = f"{self.index_path}.tmp{os.getpid()}"
                save_index(image, tmp)
                os.replace(tmp, self.index_path)

    def index(self):
        """The port's IndexImage, loaded from the cache."""
        from pseudoaligner_torch.serde import load_index

        self.ensure_index()
        return load_index(self.index_path)

    def refgraph(self):
        """The reference's graph (built from the transcripts on first use)."""
        from reference.graph import RefGraph

        if not os.path.exists(self.ref_path):
            f = self.flat()
            with _said("the reference graph"):
                RefGraph.build(f.bases, f.starts, self.k).save(self.ref_path)
        return RefGraph.load(self.ref_path)
