"""Build, bind and launch the CUDA kernels (csrc/seed.cu, csrc/walk.cu).

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, at first use, into pseudoaligner_torch/_build/ under a
name keyed by a hash of the sources; ctypes loads it.  Nothing is built
or loaded at import, so CPU-only hosts import this module freely.

Each wrapper checks its tensors, allocates every output and scratch
buffer with torch.empty, launches on torch.cuda.current_stream() without
synchronising, raises if the launch was refused, and adds one to its
`launches` counter.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .map_kernel import DeviceIndex, MapMeta, MapResult

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# the int64 launch-parameter vector, in the order of pa::params_from
PARAM_NAMES = ("B", "nw", "L", "k", "lazy", "cuckoo_mask", "ones_node",
               "ones_off", "allowed", "max_nodes", "lcap", "wcap", "dc",
               "ec16", "cov8")
MAX_DISTINCT_CAP = 64  # walk.cu's per-thread slot array

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> str:
    """Compile the kernels' library if it is not built yet; returns its
    path.  Raises with nvcc's output on failure."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    deps = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in srcs + deps:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    so = os.path.join(_BUILD, f"libpa_kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *srcs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.pa_seed_tables.restype = _I
            lib.pa_seed_tables.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P]
            lib.pa_walk.restype = _I
            lib.pa_walk.argtypes = [_P, ctypes.c_float, _I] + [_P] * 15
            lib.pa_error_string.restype = ctypes.c_char_p
            lib.pa_error_string.argtypes = [_I]
            _lib = lib
    return _lib


def _check(name, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(meta: MapMeta, idx: DeviceIndex, packed, lens):
    if not packed.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors")
    dev = packed.device
    if meta.n_positions < 1:
        raise ValueError(f"batch width {meta.read_len} below k={meta.k}")
    B = packed.shape[0]
    W = meta.kmer_words
    _check("packed", packed, torch.int32, (B, (meta.read_len + 15) // 16), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    _check("node_row", idx.node_row, torch.int32,
           (idx.node_row.shape[0], 12), dev)
    _check("pool_rows", idx.pool_rows, torch.int32,
           (idx.pool_rows.shape[0], 8), dev)
    nb = idx.cuckoo.shape[0]
    _check("cuckoo", idx.cuckoo, torch.int32, (nb, 4 * W), dev)
    _check("cuckoo_vals", idx.cuckoo_vals, torch.int32, (nb * 8,), dev)
    return B, dev


def _params(meta: MapMeta, B: int) -> torch.Tensor:
    v = dict(B=B, nw=(meta.read_len + 15) // 16, L=meta.read_len, k=meta.k,
             lazy=int(meta.lazy_seeds), cuckoo_mask=meta.cuckoo_mask,
             ones_node=meta.ones_node, ones_off=meta.ones_off,
             allowed=meta.allowed_mismatches, max_nodes=meta.max_nodes,
             lcap=meta.max_left_iters, wcap=meta.max_walk_iters,
             dc=meta.distinct_cap, ec16=int(meta.ec_out_16),
             cov8=int(meta.cov_out_8))
    return torch.tensor([v[n] for n in PARAM_NAMES], dtype=torch.int64)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.pa_error_string(rc).decode()} ({rc})")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def seed_tables_cuda(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
    """K1: packed [B, ceil(L/16)] int32 reads, lens [B] int32 ->
    nh3 [B, P, 3] int32 (see csrc/seed.cu)."""
    B, dev = _check_inputs(meta, idx, packed, lens)
    lib = _load()
    nh3 = torch.empty((B, meta.n_positions, 3), dtype=torch.int32,
                      device=dev)
    params = _params(meta, B)
    rc = lib.pa_seed_tables(
        params.data_ptr(), dev.index, packed.data_ptr(), lens.data_ptr(),
        idx.cuckoo.data_ptr(), idx.cuckoo_vals.data_ptr(), nh3.data_ptr(),
        _stream(dev))
    _raise_on(lib, rc, "seed kernel")
    seed_tables_cuda.launches += 1
    return nh3


seed_tables_cuda.launches = 0


def walk_cuda(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
              lens: torch.Tensor, nh3: torch.Tensor) -> MapResult:
    """K2: the walk and output encoding -> MapResult (see csrc/walk.cu)."""
    DC, M = meta.distinct_cap, meta.max_nodes
    if DC > MAX_DISTINCT_CAP or M < 1:
        raise ValueError(f"distinct_cap {DC} > {MAX_DISTINCT_CAP} or "
                         f"max_nodes {M} < 1")
    B, dev = _check_inputs(meta, idx, packed, lens)
    _check("nh3", nh3, torch.int32, (B, meta.n_positions, 3), dev)
    lib = _load()
    buf = torch.empty((B, M, 2), dtype=torch.int32, device=dev)
    mapped = torch.empty(B, dtype=torch.bool, device=dev)
    mismatches = torch.empty(B, dtype=torch.int32, device=dev)
    n_nodes = torch.empty(B, dtype=torch.int32, device=dev)
    if DC > 0:
        coverage = torch.empty(
            B, dtype=torch.uint8 if meta.cov_out_8 else torch.int32,
            device=dev)
        ec_distinct = torch.empty(
            (B, DC), dtype=torch.int16 if meta.ec_out_16 else torch.int32,
            device=dev)
        nodes = torch.empty((B, 0), dtype=torch.int32, device=dev)
    else:
        coverage = torch.empty(B, dtype=torch.int32, device=dev)
        ec_distinct = torch.empty((B, 0), dtype=torch.int32, device=dev)
        nodes = torch.empty((B, M), dtype=torch.int32, device=dev)
    params = _params(meta, B)
    rc = lib.pa_walk(
        params.data_ptr(), meta.left_extend_fraction, dev.index,
        packed.data_ptr(), lens.data_ptr(), nh3.data_ptr(),
        idx.pool_rows.data_ptr(), idx.node_row.data_ptr(),
        idx.cuckoo.data_ptr(), idx.cuckoo_vals.data_ptr(), buf.data_ptr(),
        mapped.data_ptr(), coverage.data_ptr(), mismatches.data_ptr(),
        n_nodes.data_ptr(), ec_distinct.data_ptr(), nodes.data_ptr(),
        _stream(dev))
    _raise_on(lib, rc, "walk kernel")
    walk_cuda.launches += 1
    return MapResult(
        mapped=mapped, coverage=coverage, mismatches=mismatches, nodes=nodes,
        n_nodes=n_nodes,
        ec_bits=torch.empty((B, 0), dtype=torch.uint32, device=dev),
        ec_distinct=ec_distinct)


walk_cuda.launches = 0


def reset_launch_counts() -> None:
    seed_tables_cuda.launches = 0
    walk_cuda.launches = 0
