"""The index image: flat SoA arrays — the host<->device contract.

TPU-native equivalent of the serialized `Pseudoaligner` struct
(reference: src/pseudoaligner.rs:26-33 — `dbg`, `eq_classes`, `dbg_index`,
`tx_names`, `tx_gene_mapping`).  The pointer-rich debruijn graph +
boomphf hashmap become flat arrays laid out for HBM-resident gathers:

- graph nodes as SoA (`node_start/node_len/node_exts/node_ec`), sequences
  concatenated in one base pool;
- dense 4-wide edge tables (`l_edge`/`r_edge`, -1 = absent) replacing the
  reference's exts-indexed edge vectors (src/pseudoaligner.rs:181-199,
  264-283 [dep]);
- equivalence classes in CSR form (`ec_offsets` + `ec_txs`, each class
  sorted ascending) replacing `Vec<Vec<u32>>`;
- the MPHF as flat bitvector/rank arrays plus slot-ordered values
  (`kmer_node`/`kmer_offset`) and slot-ordered packed keys (`kmer_keys`)
  for single-gather probe verification (the reference verifies via the
  graph instead: src/pseudoaligner.rs:99-107).

Exts bit layout: bits 0..3 = right extensions by base code, bits 4..7 =
left extensions (equivalent information to debruijn's `Exts` [dep]).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mphf import Mphf


@dataclass
class IndexImage:
    k: int

    # --- graph ---
    node_start: np.ndarray  # [N] uint32 — offset into seq_pool
    node_len: np.ndarray  # [N] uint32 — sequence length in bases
    node_exts: np.ndarray  # [N] uint8
    node_ec: np.ndarray  # [N] uint32
    seq_pool: np.ndarray  # [total_bases] uint8 base codes
    l_edge: np.ndarray  # [N, 4] int32 — neighbor node id or -1
    r_edge: np.ndarray  # [N, 4] int32

    # --- equivalence classes (CSR) ---
    ec_offsets: np.ndarray  # [M+1] uint32
    ec_txs: np.ndarray  # [sum |EC|] uint32, sorted within each class

    # --- k-mer index ---
    mphf: Mphf
    kmer_node: np.ndarray  # [n_kmers] uint32 — slot -> node id
    kmer_offset: np.ndarray  # [n_kmers] uint32 — slot -> offset in node
    kmer_keys: np.ndarray  # [n_kmers, W] uint32 — slot -> packed kmer words

    # --- names ---
    tx_names: list[str]
    tx_gene_mapping: dict[str, str]

    @property
    def n_nodes(self) -> int:
        return len(self.node_start)

    @property
    def n_ecs(self) -> int:
        return len(self.ec_offsets) - 1

    @property
    def n_tx(self) -> int:
        return len(self.tx_names)

    @property
    def n_kmers(self) -> int:
        return self.mphf.n_keys

    def ec_list(self, ec_id: int) -> np.ndarray:
        return self.ec_txs[self.ec_offsets[ec_id] : self.ec_offsets[ec_id + 1]]

    def node_seq(self, node_id: int) -> np.ndarray:
        s = self.node_start[node_id]
        return self.seq_pool[s : s + self.node_len[node_id]]

    def stats(self) -> dict:
        return {
            "k": self.k,
            "n_tx": self.n_tx,
            "n_nodes": self.n_nodes,
            "n_kmers": self.n_kmers,
            "n_eq_classes": self.n_ecs,
            "total_bases": int(self.seq_pool.shape[0]),
            "mphf_levels": self.mphf.n_levels,
        }
