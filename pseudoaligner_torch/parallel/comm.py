"""The exchange behind every collective of the multi-device layer.

The reference's collectives are XLA's over a device mesh: `all_to_all`
with equal splits (`all_to_all(x, axis, 0, 0, tiled=True)`: block s goes
to shard s, what arrives is stacked by source) and `psum`.  Here an
exchange holds one or more shards of a mesh of `size` shards and offers
those collectives over them.  Each takes and returns one tensor per shard
this process holds (`ranks`, in order); a step runs its per-shard work for
each of them between collectives.

- `DistExchange`: one shard per process over `torch.distributed`, NCCL
  between CUDA devices and gloo between CPU processes.
- `LoopbackExchange`: S shards in one process on one device, the
  counterpart of the reference's virtual device mesh
  (`--xla_force_host_platform_device_count`).  It runs only where a caller
  names it: tests, the dry run and chip_smoke.py.

Words travel as int32 bit patterns: gloo refuses torch.uint32, so the
port's uint32 words ride as int32 throughout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# a gather carries MapResult fields as int32 (gloo takes none of bool,
# uint32 or int16): uint32 as its bit pattern, narrower types widened


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return t if t.dtype in (torch.int32, torch.int64) else t.to(torch.int32)


def _from_wire(t: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return t.view(dtype)
    return t if t.dtype == dtype else t.to(dtype)


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' for the plain PyTorch path")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class LoopbackExchange:
    """`size` shards in this process, all on `device`."""

    def __init__(self, size: int, device="cuda"):
        if size < 1:
            raise ValueError(f"size {size} < 1")
        self.size = size
        self.ranks = tuple(range(size))
        self.device = _resolve(device)

    def all_to_all(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """xs[s] is shard s's [S, ...] send buffer; shard r receives
        [xs[0][r], ..., xs[S-1][r]]."""
        return [torch.stack([x[r] for x in xs]) for r in self.ranks]

    def all_reduce(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The sum over all shards (the same for each)."""
        total = xs[0].clone()
        for x in xs[1:]:
            total += x
        return total

    def all_gather(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """[S, ...]: every shard's tensor, by shard."""
        return torch.stack(xs)


class DistExchange:
    """This process's one shard of the `torch.distributed` group: the
    group's size is the mesh's.  The device is this process's current CUDA
    device under NCCL and the CPU under gloo."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised "
                               "(parallel.multihost.init_from_env)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        backend = dist.get_backend(group)
        self.device = (_resolve("cuda") if backend == "nccl"
                       else torch.device("cpu"))

    def all_to_all(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        (x,) = xs
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return [out]

    def all_reduce(self, xs: list[torch.Tensor]) -> torch.Tensor:
        (x,) = xs
        total = x.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total

    def all_gather(self, xs: list[torch.Tensor]) -> torch.Tensor:
        (x,) = xs
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.stack(parts)


def gather_rows(mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """Every shard's rows, in shard order: [S * b, ...] from each local
    shard's [b, ...] (bool, uint8, int16 and uint32 ride as int32)."""
    dtype = xs[0].dtype
    got = mesh.all_gather([_to_wire(x) for x in xs])
    rows = got.shape[0] * got.shape[1]
    return _from_wire(got.reshape((rows,) + tuple(got.shape[2:])), dtype)
