"""Index serialization: versioned flat binary container.

Equivalent of the reference's bincode whole-index (de)serialization
(`write_obj`/`read_obj`, src/utils.rs:22-43), decoupling `index` from
`map`/`mappability`/`idxstats` runs.  Unlike bincode, the format is
versioned and mmap-friendly: a JSON header describing 64-byte-aligned raw
array blobs, so `load_index(..., mmap=True)` maps the arrays and
`jax.device_put` streams them straight to HBM.

The graph sequence pool is stored 2-bit packed (4 bases/byte) and unpacked
to one-byte codes at load; everything else is stored as the in-memory
dtypes of IndexImage.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import dna
from .index.image import IndexImage
from .index.mphf import Mphf

MAGIC = b"PATPU-IDX\x00"
VERSION = 1
ALIGN = 64


def _arrays_of(image: IndexImage) -> dict[str, np.ndarray]:
    return {
        "node_start": image.node_start,
        "node_len": image.node_len,
        "node_exts": image.node_exts,
        "node_ec": image.node_ec,
        "seq_pool_packed": dna.pack_codes_2bit(image.seq_pool),
        "l_edge": image.l_edge,
        "r_edge": image.r_edge,
        "ec_offsets": image.ec_offsets,
        "ec_txs": image.ec_txs,
        "mphf_seeds": image.mphf.seeds,
        "mphf_masks": image.mphf.masks,
        "mphf_word_offsets": image.mphf.word_offsets,
        "mphf_key_offsets": image.mphf.key_offsets,
        "mphf_bits": image.mphf.bits,
        "mphf_ranks": image.mphf.ranks,
        "kmer_node": image.kmer_node,
        "kmer_offset": image.kmer_offset,
        "kmer_keys": image.kmer_keys,
    }


def save_index(image: IndexImage, path: str) -> None:
    arrays = _arrays_of(image)
    meta = {
        "version": VERSION,
        "k": image.k,
        "n_kmers": int(image.mphf.n_keys),
        "pool_bases": int(image.seq_pool.shape[0]),
        "tx_names": image.tx_names,
        "tx_gene_mapping": image.tx_gene_mapping,
        "arrays": {},
    }
    # layout pass
    blobs = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        pad = (-offset) % ALIGN
        offset += pad
        meta["arrays"][name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": arr.nbytes,
        }
        blobs.append((pad, arr))
        offset += arr.nbytes

    header_json = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(header_json)).tobytes())
        f.write(header_json)
        data_start = f.tell()
        pad0 = (-data_start) % ALIGN
        f.write(b"\x00" * pad0)
        base = f.tell()
        for pad, arr in blobs:
            f.write(b"\x00" * pad)
            # zero-copy write: tobytes() materialized a transient full
            # copy of every blob (hundreds of MB at scale — review r5);
            # the arrays are already C-contiguous from the layout pass
            f.write(memoryview(arr).cast("B"))
        assert f.tell() - base == offset


def load_index(path: str, mmap: bool = True) -> IndexImage:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a pseudoaligner_tpu index")
        (hlen,) = np.frombuffer(f.read(8), dtype=np.uint64)
        meta = json.loads(f.read(int(hlen)).decode())
        if meta["version"] != VERSION:
            raise ValueError(f"unsupported index version {meta['version']}")
        data_start = f.tell()
        base = data_start + ((-data_start) % ALIGN)

    if mmap:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        buf = np.fromfile(path, dtype=np.uint8)

    def arr(name):
        d = meta["arrays"][name]
        start = base + d["offset"]
        raw = buf[start : start + d["nbytes"]]
        return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"])

    mphf = Mphf(
        n_keys=meta["n_kmers"],
        seeds=arr("mphf_seeds"),
        masks=arr("mphf_masks"),
        word_offsets=arr("mphf_word_offsets"),
        key_offsets=arr("mphf_key_offsets"),
        bits=arr("mphf_bits"),
        ranks=arr("mphf_ranks"),
    )
    image = IndexImage(
        k=meta["k"],
        node_start=arr("node_start"),
        node_len=arr("node_len"),
        node_exts=arr("node_exts"),
        node_ec=arr("node_ec"),
        seq_pool=dna.unpack_codes_2bit(arr("seq_pool_packed"), meta["pool_bases"]),
        l_edge=arr("l_edge"),
        r_edge=arr("r_edge"),
        ec_offsets=arr("ec_offsets"),
        ec_txs=arr("ec_txs"),
        mphf=mphf,
        kmer_node=arr("kmer_node"),
        kmer_offset=arr("kmer_offset"),
        kmer_keys=arr("kmer_keys"),
        tx_names=list(meta["tx_names"]),
        tx_gene_mapping=dict(meta["tx_gene_mapping"]),
    )
    # identity for the derived-artifact cache (device-image arrays are
    # disk-cached beside the index, keyed on this; ops/map_kernel.py)
    try:
        st = os.stat(path)
        image.source_ident = (os.path.abspath(path), st.st_size,
                              st.st_mtime_ns)
    except OSError:
        pass
    return image
