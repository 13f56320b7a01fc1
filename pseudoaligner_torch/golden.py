"""Golden scalar reference implementation of the mapping semantics.

A line-by-line semantic mirror of the reference's read-mapping inner loop
(reference: src/pseudoaligner.rs:64-418), operating on the flat IndexImage.
This is the oracle the vectorized TPU engine is tested against — it is NOT
the production path.

Semantics reproduced exactly, including the quirks:

- stride-3 seed scan (src/pseudoaligner.rs:91-114) with exact-match
  verification (the MPHF probe + verify there collapses to an exact dict
  lookup here);
- left extension gate `kmer_pos >= (0.2 * L) as usize`
  (src/pseudoaligner.rs:77,126) and the off-by-one comparison frame when
  the seed hits node offset 0 (`prev_kmer_offset = 0`, :129);
- per-extension-segment mismatch budget (seen_snp resets per node segment,
  :149,235) while `mismatch_count` accumulates globally;
- mismatching bases count toward `read_coverage` (:168-169,253-254), and
  the base that exceeds the budget counts toward `mismatch_count` but not
  coverage (:156-170);
- coverage arithmetic: +k on node entry (:215-216), -(k-1) on right-edge
  follow (:282-283);
- re-seeding continues the stride-3 scan from the current kmer_pos
  (:287-299).

`golden_record` renders the oracle's answer as the record `map` prints for
that read, so a sample of a run's output can be held byte for byte against
it (chip_smoke.py does so on the GPU).  Reads longer than
`config.max_read_len` are mapped by `map` as merged windows; the oracle
maps them whole, so hold only reads that fit a batch.
"""

from __future__ import annotations

import numpy as np

from .config import DEFAULT_ALLOWED_MISMATCHES, LEFT_EXTEND_FRACTION
from .dna import kmer_to_pyint, pack_kmers
from .index.image import IndexImage


class _MphfBackedMap:
    """Lazy exact kmer map: per-lookup MPHF probe + key verification —
    skips the up-front dict build (used by the serving host fallback,
    where only a handful of lookups ever happen)."""

    def __init__(self, image: IndexImage):
        self._image = image
        self._k = image.k

    def get(self, key: int):
        from .dna import pyint_to_kmer

        img = self._image
        kw = pyint_to_kmer(key, self._k)
        slot = img.mphf.lookup(kw[None, :])[0]
        if slot < 0 or not np.array_equal(img.kmer_keys[slot], kw):
            return None
        return int(img.kmer_node[slot]), int(img.kmer_offset[slot])


class GoldenAligner:
    """Scalar oracle aligner over an IndexImage.

    lazy=True skips the up-front exact-map build and probes the MPHF per
    lookup instead (same results; right tradeoff when only a few reads
    will be mapped)."""

    def __init__(self, image: IndexImage, lazy: bool = False):
        self.image = image
        self.k = image.k
        if lazy:
            self._kmer_map = _MphfBackedMap(image)
        else:
            # exact kmer -> (node, offset) map (MPHF probe + verification is
            # semantically an exact lookup; see module docstring)
            self._kmer_map: dict[int, tuple[int, int]] = {}
            keys = image.kmer_keys
            for slot in range(len(keys)):
                self._kmer_map[kmer_to_pyint(keys[slot])] = (
                    int(image.kmer_node[slot]),
                    int(image.kmer_offset[slot]),
                )

    # -- graph accessors ---------------------------------------------------

    def _ref_base(self, node: int, pos: int) -> int:
        return int(self.image.seq_pool[int(self.image.node_start[node]) + pos])

    def _node_len(self, node: int) -> int:
        return int(self.image.node_len[node])

    def _has_ext(self, node: int, left: bool, base: int) -> bool:
        e = int(self.image.node_exts[node])
        bit = (4 + base) if left else base
        return (e >> bit) & 1 == 1

    def _edge(self, node: int, left: bool, base: int) -> int:
        t = self.image.l_edge if left else self.image.r_edge
        return int(t[node, base])

    # -- mapping -----------------------------------------------------------

    def map_read_to_nodes_with_mismatch(
        self, read: np.ndarray, allowed_mismatches: int
    ) -> tuple[int, int, list[int]] | None:
        """Returns (read_coverage, mismatch_count, nodes) or None.

        Mirror of src/pseudoaligner.rs:64-319.
        """
        k = self.k
        L = len(read)
        if L < k:
            return None
        cov = 0
        mm = 0
        nodes: list[int] = []
        left_extend_threshold = int(LEFT_EXTEND_FRACTION * L)
        last_kmer_pos = L - k

        kmers = pack_kmers(read, k)

        def find_kmer_match(pos: int):
            # stride-3 scan, src/pseudoaligner.rs:91-114
            while pos <= last_kmer_pos:
                hit = self._kmer_map.get(kmer_to_pyint(kmers[pos]))
                if hit is not None:
                    return pos, hit
                pos += 3
            return pos, None

        kmer_pos, hit = find_kmer_match(0)
        node_id, kmer_offset = hit if hit is not None else (None, None)

        # left extension, src/pseudoaligner.rs:124-205
        if node_id is not None and kmer_pos >= left_extend_threshold:
            last_pos = kmer_pos - 1
            prev_node_id = node_id
            prev_kmer_offset = kmer_offset - 1 if kmer_offset > 0 else 0
            while True:
                node = prev_node_id
                skipped_read = last_pos + 1
                skipped_ref = prev_kmer_offset + 1
                max_matchable_pos = min(skipped_read, skipped_ref)

                premature_break = False
                matched_bases = 0
                seen_snp = 0
                for idx in range(max_matchable_pos):
                    ref_pos = prev_kmer_offset - idx
                    read_offset = last_pos - idx
                    if self._ref_base(node, ref_pos) != int(read[read_offset]):
                        mm += 1
                        seen_snp += 1
                        if seen_snp > allowed_mismatches:
                            premature_break = True
                            break
                    matched_bases += 1
                    cov += 1

                if last_pos + 1 - matched_bases == 0 or premature_break:
                    break
                last_pos -= matched_bases

                next_base = int(read[last_pos])
                if self._has_ext(node, True, next_base):
                    prev_node_id = self._edge(node, True, next_base)
                    prev_kmer_offset = self._node_len(prev_node_id) - k
                    nodes.append(prev_node_id)
                else:
                    break

        # forward search, src/pseudoaligner.rs:208-302
        if kmer_pos <= last_kmer_pos and node_id is not None:
            while True:
                node = node_id
                kmer_pos += k
                cov += k
                nodes.append(node)

                remaining_read = L - kmer_pos
                ref_length = self._node_len(node)
                ref_offset = kmer_offset + k
                informative_ref = ref_length - ref_offset
                max_matchable_pos = min(remaining_read, informative_ref)

                premature_break = False
                matched_bases = 0
                seen_snp = 0
                for idx in range(max_matchable_pos):
                    ref_pos = ref_offset + idx
                    read_offset = kmer_pos + idx
                    if self._ref_base(node, ref_pos) != int(read[read_offset]):
                        mm += 1
                        seen_snp += 1
                        if seen_snp > allowed_mismatches:
                            premature_break = True
                            break
                    matched_bases += 1
                    cov += 1

                kmer_pos += matched_bases
                if kmer_pos >= L:
                    break

                next_base = int(read[kmer_pos])
                if not premature_break and self._has_ext(node, False, next_base):
                    node_id = self._edge(node, False, next_base)
                    kmer_offset = 0
                    kmer_pos -= k - 1
                    cov -= k - 1
                else:
                    if kmer_pos > last_kmer_pos:
                        break
                    kmer_pos, hit = find_kmer_match(kmer_pos)
                    if hit is None:
                        break
                    node_id, kmer_offset = hit

        if not nodes:
            assert cov == 0, (cov, nodes)
            return None
        return cov, mm, nodes

    def nodes_to_eq_class(self, nodes: list[int]) -> list[int]:
        """Mirror of src/pseudoaligner.rs:323-356."""
        if not nodes:
            return []
        img = self.image
        nodes = sorted(
            nodes,
            key=lambda n: int(
                img.ec_offsets[img.node_ec[n] + 1] - img.ec_offsets[img.node_ec[n]]
            ),
        )
        eq_class = list(img.ec_list(int(img.node_ec[nodes[0]])))
        for n in nodes[1:]:
            eq_class = intersect(eq_class, list(img.ec_list(int(img.node_ec[n]))))
        return [int(x) for x in eq_class]

    def map_read_with_mismatch(
        self, read: np.ndarray, allowed_mismatches: int
    ) -> tuple[list[int], int, int] | None:
        r = self.map_read_to_nodes_with_mismatch(read, allowed_mismatches)
        if r is None:
            return None
        cov, mm, nodes = r
        return self.nodes_to_eq_class(nodes), cov, mm

    def map_read(self, read: np.ndarray) -> tuple[list[int], int] | None:
        """Mirror of src/pseudoaligner.rs:381-384."""
        r = self.map_read_with_mismatch(read, DEFAULT_ALLOWED_MISMATCHES)
        if r is None:
            return None
        eq_class, cov, _mm = r
        return eq_class, cov


def intersect(v1: list, v2: list) -> list:
    """Sorted-set intersection (mirror of src/pseudoaligner.rs:389-418)."""
    if not v1:
        return v1
    if not v2:
        return []
    out = []
    idx2 = 0
    for x in v1:
        lo, hi = idx2, len(v2)
        while lo < hi:
            mid = (lo + hi) // 2
            if v2[mid] < x:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(v2) and v2[lo] == x:
            out.append(x)
            idx2 = lo + 1
        else:
            idx2 = lo
    return out


def golden_oracle(image: IndexImage) -> GoldenAligner:
    """The oracle over `image`, probing the index per k-mer (no up-front
    k-mer map: the right trade when a sample of reads is checked)."""
    return GoldenAligner(image, lazy=True)


def golden_record(oracle: GoldenAligner, read_id: str, codes: np.ndarray,
                  config) -> str:
    """The line `map` prints for one read of base codes 0-3, by the
    oracle, under the reference's flag rule (`config` is an
    AlignerConfig)."""
    from .models.aligner import ReadRecord

    r = oracle.map_read_with_mismatch(
        np.asarray(codes, dtype=np.uint8), config.allowed_mismatches)
    eq, cov = ([], 0) if r is None else (r[0], r[1])
    flag = cov >= config.read_coverage_threshold and not eq
    return ReadRecord(flag, read_id, eq, cov).format_reference_style()


def golden_pair_record(oracle: GoldenAligner, read_id: str, codes1,
                       codes2, config) -> str:
    """The line paired `map` prints for one pair, by the oracle: each mate
    mapped alone, their classes intersected when both have coverage, else
    the covered mate's class; coverage summed (the rule of
    `Pseudoaligner.map_fastq_paired`)."""
    from .models.aligner import ReadRecord

    mates = []
    for codes in (codes1, codes2):
        r = oracle.map_read_with_mismatch(
            np.asarray(codes, dtype=np.uint8), config.allowed_mismatches)
        mates.append(([], 0) if r is None else (list(r[0]), r[1]))
    (eq1, cov1), (eq2, cov2) = mates
    if cov1 and cov2:
        eq = intersect(eq1, eq2)
    else:
        eq = eq1 if cov1 else eq2 if cov2 else []
    cov = cov1 + cov2
    flag = cov >= config.read_coverage_threshold and not eq
    return ReadRecord(flag, read_id, eq, cov).format_reference_style()
