"""Data-parallel mapping over a mesh of shards.

Port of `pseudoaligner_tpu/parallel/mesh.py`: the batch is split into
equal row blocks, one per shard; the index (the read-only "model") is
replicated; each shard maps its rows in the uncapped full-output shape
with the bitset EC intersection, counts per-transcript compatibility
(`tx_compat_counts`, csrc/txcounts.cu K9 on a GPU) and the counts are
summed over the mesh (the reference's psum, here the exchange's
all_reduce).

A mesh is an exchange (parallel/comm.py): `make_mesh` returns the
`torch.distributed` group's (one shard per process) or, when the caller
asks for it, a loopback of S shards in one process.  Unlike the
reference's single-controller call, each process maps only its own shards'
rows; `ShardedAligner.gather` collects every shard's rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import AlignerConfig
from ..ops.map_kernel import (
    DeviceIndex,
    MapMeta,
    MapResult,
    device_index_from_image,
    map_batch_packed,
    pack_reads_host,
    upload,
)
from .comm import DistExchange, LoopbackExchange, gather_rows


def make_mesh(n_devices: int | None = None, loopback: bool = False,
              device="cuda"):
    """The mesh of the `torch.distributed` group (one shard per process,
    each on its own card under NCCL), or with `loopback` n_devices shards
    in this process on `device`.  Without a process group the mesh is this
    one process.  Raises when n_devices differs from the processes there
    are: a smaller mesh would run (say) 4-way while the caller measures
    "8-way" scaling."""
    if loopback:
        return LoopbackExchange(1 if n_devices is None else n_devices, device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != have:
        raise ValueError(
            f"requested {n_devices} devices, {have} available (one per "
            "process of the torch.distributed group; loopback=True holds "
            "several shards in one process)")
    if dist.is_initialized():
        return DistExchange()
    return LoopbackExchange(1, device)


def tx_compat_counts(ec_bits: torch.Tensor, n_tx: int) -> torch.Tensor:
    """Plain PyTorch per-transcript compatibility counts from EC bitsets
    [B, TW] (uint32, or their int32 bit patterns): counts[t] = the number
    of reads whose class contains transcript t, int32 [n_tx]."""
    bits = ec_bits.view(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    # an arithmetic shift of the int32 pattern keeps bit t at bit 0
    unpacked = (bits[:, :, None] >> shifts) & 1
    per_tx = unpacked.reshape(bits.shape[0], -1)[:, :n_tx]
    return per_tx.sum(dim=0).to(torch.int32)


def count_transcripts(ec_bits: torch.Tensor, n_tx: int) -> torch.Tensor:
    """tx_compat_counts on the card (K9) for a CUDA tensor, the plain
    version for a CPU one."""
    if ec_bits.is_cuda:
        from ..ops.kernels import tx_counts_cuda

        return tx_counts_cuda(ec_bits.view(torch.int32), n_tx)
    return tx_compat_counts(ec_bits, n_tx)


def make_sharded_step(meta: MapMeta, mesh, n_tx: int):
    """The data-parallel step: fn(idx, packed, lens) -> (results, counts),
    where packed and lens hold one tensor per local shard (shard_batch),
    results is one MapResult per local shard and counts [n_tx] int32 the
    sum over every shard of the mesh."""

    def step(idx: DeviceIndex, packed: list, lens: list):
        results = [map_batch_packed(meta, idx, p, n)
                   for p, n in zip(packed, lens)]
        counts = mesh.all_reduce([count_transcripts(r.ec_bits, n_tx)
                                  for r in results])
        return results, counts

    return step


def replicate_index(dev: DeviceIndex, mesh, serving: MapMeta | None = None):
    """Upload the index to the mesh's device: every shard of this process
    reads the one copy, and every process holds its own."""
    return upload(dev, mesh.device, serving=serving)


def shard_batch(rows: np.ndarray, lens: np.ndarray, mesh):
    """This process's shards' row blocks of a global batch, as tensors on
    the mesh's device: ([rows of each local shard], [lens of each]).
    uint32 rows ride as their int32 bit patterns."""
    B = rows.shape[0]
    if B % mesh.size:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")
    b = B // mesh.size
    if rows.dtype == np.uint32:
        rows = rows.view(np.int32)
    pin = mesh.device.type == "cuda"

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pin:
            t = t.pin_memory()
        return t.to(mesh.device, non_blocking=pin)

    return ([put(rows[r * b:(r + 1) * b]) for r in mesh.ranks],
            [put(lens[r * b:(r + 1) * b]) for r in mesh.ranks])


def concat_results(results: list[MapResult]) -> MapResult:
    """One MapResult of the local shards' rows, in shard order."""
    if len(results) == 1:
        return results[0]
    return MapResult(*(torch.cat(fs) for fs in zip(*results)))


def gather_result(mesh, res: MapResult) -> MapResult:
    """Every shard's rows of a result whose rows are this process's
    shards' (a no-op when this process holds every shard)."""
    if len(mesh.ranks) == mesh.size:
        return res
    return MapResult(*(gather_rows(mesh, [f]) for f in res))


class ShardedAligner:
    """Data-parallel mapping engine over a mesh (index replicated)."""

    def __init__(self, image, config: AlignerConfig, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        dev, meta = device_index_from_image(image, config)
        # the counts consume EC bitsets, which exist only in the uncapped
        # full-output shape (its -3 re-map channel only exists in the
        # compact output); the uncapped walk needs the full node buffer
        # (2 * read_len), or visits of fragmented reads would be cut
        meta = dataclasses.replace(
            meta, distinct_cap=0, max_walk_iters=0, max_left_iters=0,
            max_nodes=max(meta.max_nodes, 2 * meta.read_len),
        )
        if meta.tx_words == 0:
            # ec_bits would be [B, 0] and every count silently empty
            raise ValueError(
                f"ShardedAligner's bitset TCC path needs n_tx "
                f"({len(image.tx_names)}) <= "
                f"config.bitset_tx_threshold ({config.bitset_tx_threshold})"
            )
        self.meta = meta
        self.config = config
        self.n_tx = len(image.tx_names)
        self.dev = replicate_index(dev, self.mesh, serving=meta)
        self._step = make_sharded_step(meta, self.mesh, self.n_tx)

    def map_batch(self, reads: np.ndarray, lens: np.ndarray):
        """Map a global [B, L] batch of base codes (every process passes
        the same batch) -> (MapResult of this process's shards' rows,
        counts [n_tx] int32 summed over the mesh)."""
        packed = pack_reads_host(np.asarray(reads, dtype=np.uint8))
        pk, ln = shard_batch(packed, np.asarray(lens, dtype=np.int32),
                             self.mesh)
        results, counts = self._step(self.dev, pk, ln)
        return concat_results(results), counts

    def gather(self, res: MapResult) -> MapResult:
        """Every shard's rows of a map_batch result (for tests)."""
        return gather_result(self.mesh, res)
