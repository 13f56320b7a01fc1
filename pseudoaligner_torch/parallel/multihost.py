"""Multi-process execution: torch.distributed set-up and the global count
merge.

Port of `pseudoaligner_tpu/parallel/multihost.py`.  Serving scales out as
per-process data parallelism: every process (one per card) holds the full
index, streams its own slice of the input FASTQ, maps locally, and the
per-transcript count vectors are summed over all processes at the end: one
all_reduce per file, NCCL between cards, gloo between CPU processes.

A process's slice is a batch stride: process p maps batches p, p+H,
p+2H, ... of the stream, deterministic with no coordination beyond the
process count.  Records go to one part file per process (part-<p>.txt);
the merged counts are identical in every process.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from .comm import _resolve
from .mesh import make_mesh


def init_from_env(device="cuda") -> tuple[int, int]:
    """Join the torch.distributed group of PA_COORDINATOR (host:port of
    process 0), PA_NUM_PROCESSES and PA_PROCESS_ID; a no-op when
    PA_NUM_PROCESSES is absent or 1.  NCCL with `device` "cuda", each
    process on card PA_PROCESS_ID modulo the host's card count; gloo with
    "cpu".  Returns (process_index, process_count)."""
    nproc = int(os.environ.get("PA_NUM_PROCESSES", "1"))
    if nproc > 1:
        rank = int(os.environ["PA_PROCESS_ID"])
        device = torch.device(device)
        if device.type == "cuda":
            _resolve(device)  # raises without a card
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{os.environ['PA_COORDINATOR']}",
            world_size=nproc, rank=rank)
    elif os.environ.get("PA_AUTO_DISTRIBUTED"):
        # jax.distributed.initialize() infers a TPU pod's processes; torch
        # has no counterpart that infers a cluster
        raise RuntimeError(
            "PA_AUTO_DISTRIBUTED: torch.distributed cannot infer the "
            "cluster; set PA_COORDINATOR, PA_NUM_PROCESSES and "
            "PA_PROCESS_ID")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(device="cuda"):
    """The mesh of every process: the torch.distributed group's, or, with
    no group, this one process on `device`."""
    return make_mesh(device=device)


def make_count_merge(mesh, n_tx: int):
    """The global sum of per-process count vectors: run(local_counts) ->
    [n_tx] int32 numpy, identical in every process.

    int32 on purpose, as in the reference: 2**31 reads per transcript per
    run is the declared ceiling; callers needing more sum numpy int64 on
    the host."""

    def run(local_counts: np.ndarray) -> np.ndarray:
        local = torch.from_numpy(np.asarray(local_counts, dtype=np.int32))
        local = local.to(mesh.device)
        # this process's vector rides on its first shard, zeros on the rest
        parts = [local] + [torch.zeros_like(local) for _ in mesh.ranks[1:]]
        return mesh.all_reduce(parts).cpu().numpy()

    return run


def shard_batches(batches, process_index: int, process_count: int):
    """Deterministic per-process batch stride: process p takes batches
    p, p+H, ... (generator passthrough)."""
    for i, b in enumerate(batches):
        if i % process_count == process_index:
            yield b


def map_fastq_multihost(
    image,
    config,
    fastq_path: str,
    outdir: str,
    process_index: int | None = None,
    process_count: int | None = None,
    resume: bool = False,
    device="cuda",
):
    """Per-process streaming map of a FASTQ slice, then the global count
    merge.

    Every process runs this with the same arguments after init_from_env();
    process p writes the records of its batches to `part-<p>.txt` in outdir
    and every process returns the same merged per-transcript counts.

    Crash containment: after each batch's records are flushed,
    `part-<p>.txt.progress` is atomically replaced with (batches done,
    byte offset, running counts) in one file.  With `resume=True` a
    restarted run truncates the part file to the last durable offset,
    reloads the counts, skips the finished batches and continues; the
    outputs are byte-identical to an uninterrupted run's."""
    from ..io.fastq import FastqReader
    from ..models.aligner import Pseudoaligner
    from ..ops.map_kernel import NATIVE_ERRORS

    in_group = dist.is_initialized()
    p = (dist.get_rank() if in_group else 0) if process_index is None \
        else process_index
    H = (dist.get_world_size() if in_group else 1) if process_count is None \
        else process_count

    aligner = Pseudoaligner(image, config, device=device)
    reader = FastqReader(
        fastq_path, batch_size=config.batch_size, max_len=config.max_read_len
    )
    os.makedirs(outdir, exist_ok=True)
    n_tx = len(image.tx_names)
    local_counts = np.zeros(n_tx, dtype=np.int64)
    part_path = os.path.join(outdir, f"part-{p}.txt")
    prog_path = part_path + ".progress"
    done_batches = 0
    if resume and os.path.exists(prog_path):
        try:
            # ONE file: (batches, offset, counts) land together or not at
            # all, so a crash cannot count a batch the offset excludes
            ckpt = np.load(prog_path)
            done_batches = int(ckpt["batches"])
            byte_off = int(ckpt["offset"])
            local_counts = ckpt["counts"].astype(np.int64)
            with open(part_path, "r+b") as f:  # drop any torn tail
                f.truncate(byte_off)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            done_batches = 0
            local_counts = np.zeros(n_tx, dtype=np.int64)

    try:
        from ..io import native as _native

        # the import always succeeds (a ctypes wrapper): build the
        # libraries now, so a host without a toolchain takes the record
        # path below instead of failing mid-serve
        _native._load()
        _native._load_emit()
        have_native = True
    except NATIVE_ERRORS:
        have_native = False

    try:
        with open(part_path, "ab" if done_batches else "wb") as out:
            skip = done_batches  # done_batches advances as batches finish

            def strided():
                for i, batch in enumerate(shard_batches(reader, p, H)):
                    if i < skip:
                        continue  # written durably before the crash
                    yield batch

            def checkpoint():
                # records first, then the (batches, offset, counts) file
                out.flush()
                tmp = prog_path + ".tmp.npz"
                np.savez(tmp, batches=done_batches, offset=out.tell(),
                         counts=local_counts)
                os.replace(tmp, prog_path)

            if have_native and aligner.meta.distinct_cap > 0:
                # the serving path: native emitter and DepthPipeline;
                # count_cb fires at each batch's ordered finish, after its
                # records reached `out`
                def count_cb(_n, deltas):
                    nonlocal done_batches
                    for ids, w in deltas:
                        np.add.at(local_counts,
                                  np.asarray(ids, dtype=np.int64),
                                  np.asarray(w, dtype=np.int64))
                    done_batches += 1
                    checkpoint()

                aligner.emit_fastq(fastq_path, out, batch_iter=strided(),
                                   count_cb=count_cb)
            else:
                # no toolchain: per-record formatting, pipeline_depth map
                # steps in flight
                from ..pipeline import DepthPipeline

                def write_records(item, _nxt):
                    nonlocal done_batches
                    res, b = item
                    for rec in aligner.records_from_result(res, b):
                        out.write(rec.format_reference_style().encode()
                                  + b"\n")
                        for t in rec.eq_class:
                            local_counts[t] += 1
                    done_batches += 1
                    checkpoint()

                pipe = DepthPipeline(config.pipeline_depth, write_records)
                for batch in strided():
                    res = aligner.map_batch_device(batch.codes, batch.lens)
                    pipe.push((res, batch))
                pipe.close()
    finally:
        reader.close()
        aligner.close()

    return make_count_merge(global_mesh(device), n_tx)(local_counts)
