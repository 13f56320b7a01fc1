"""The multi-device dry run: one data-parallel step and one
k-mer-partitioned step over an n-shard mesh, on a tiny synthetic
transcriptome.

Port of the reference's `dryrun_multichip` (`__graft_entry__.py`):

    python -m pseudoaligner_torch.parallel.dryrun N [--loopback] [--device cpu]

runs over the torch.distributed group when one is initialised (its size
must be N), otherwise over N loopback shards in this process with
--loopback, otherwise over this one process (N = 1).
"""

from __future__ import annotations

import argparse

import numpy as np


def tiny_workload(n_tx=16, tx_len=300, B=64, L=64, seed=0):
    """Deterministic synthetic transcriptome and reads (no files):
    (seqs, names, gene_map, reads [B, L] int32, lens [B] int32)."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, size=tx_len).astype(np.uint8)
            for _ in range(n_tx)]
    names = [f"tx{i}" for i in range(n_tx)]
    gene_map = {n: f"g{i % 4}" for i, n in enumerate(names)}
    reads = np.zeros((B, L), dtype=np.int32)
    lens = np.full(B, 60, dtype=np.int32)
    for b in range(B):
        src = seqs[b % n_tx]
        start = int(rng.integers(0, tx_len - 60))
        reads[b, :60] = src[start : start + 60]
    return seqs, names, gene_map, reads, lens


def dryrun_multichip(n_devices: int, loopback: bool = False,
                     device="cuda") -> dict:
    """Map one batch with ShardedAligner and with the fully sharded
    KmerPartitionedAligner (k-mer lookup and graph both partitioned,
    shard_graph=True, as the reference's dry run runs it) over an
    n_devices mesh; both must map the same reads, and some.  Returns the
    mapped and count totals."""
    from ..config import AlignerConfig
    from ..index.builder import build_index
    from .mesh import ShardedAligner, make_mesh
    from .sharded_index import KmerPartitionedAligner

    # the batch must divide the mesh: round up to a multiple of n_devices
    B = -(-max(64, n_devices * 8) // n_devices) * n_devices
    seqs, names, gene_map, reads, lens = tiny_workload(B=B)
    image = build_index(seqs, names, gene_map, k=20)
    cfg = AlignerConfig(k=20, batch_size=B, max_read_len=reads.shape[1],
                        max_nodes=64)
    mesh = make_mesh(n_devices, loopback=loopback, device=device)
    dp = ShardedAligner(image, cfg, mesh)
    res, counts = dp.map_batch(reads, lens)
    mapped = dp.gather(res).mapped.cpu().numpy()
    if not mapped.sum() > 0:
        raise AssertionError("dry run mapped no reads")
    out = {"devices": n_devices, "batch": B, "mapped": int(mapped.sum()),
           "counts_sum": int(counts.sum())}
    print(f"dryrun_multichip: {n_devices} devices, batch {B}, "
          f"{out['mapped']} mapped, counts_sum={out['counts_sum']}")
    if n_devices & (n_devices - 1) == 0:
        kp = KmerPartitionedAligner(image, cfg, mesh, shard_graph=True)
        res2, _ = kp.map_batch(reads, lens)
        mapped2 = kp.gather(res2).mapped.cpu().numpy()
        if not np.array_equal(mapped2, mapped):
            raise AssertionError("kpart and data-parallel mapped different "
                                 "reads")
        out["kpart_mapped"] = int(mapped2.sum())
        out["kpart_graph_sharded"] = kp.kmeta.node_block > 0
        print(f"dryrun_multichip(kpart+graph-sharded): {n_devices} shards, "
              f"{out['kpart_mapped']} mapped")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--loopback", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.loopback, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
