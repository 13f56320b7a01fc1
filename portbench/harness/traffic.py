"""The general read generator: a traffic file's parameters -> a ring of
batches of base codes, made from `--seed` on the run's device.

A traffic file gives `read_len`, `batch_reads`, `in_flight`,
`ring_batches`, `sample_reads`, and the library's shares, each from the
source the file cites:

- `unmapped_share`: reads of random bases, from nowhere in the
  transcriptome;
- `antisense_share`: of the other reads, those of the transcript's other
  strand (reverse-complemented; the index is stranded, so they miss);
- `error_rate`: substitutions per base, at (read, position) drawn
  uniformly over the batch's bases without repeats, each to one of the
  other three bases;
- `expression`: `{"law": "zipf", "exponent": s, "seed": n}`: transcript
  t's abundance is rank(t) ** -s, the ranks a permutation drawn from the
  file's own `seed`, so every `--seed` samples the same profile.  A read's
  transcript is drawn in proportion to its abundance times its windows,
  its start uniformly among them.

Every batch holds the same number of reads of each kind and of
substitutions (each rounded), in an order drawn from `--seed`, so every
seed gives the same work in another order.

A mix that needs other code names a module under traffic/ in
`generator`; that module's `make(source, traffic, gen, out)` fills the
[batch_reads, read_len] uint8 tensor `out` from a `Source` (the
transcriptome on the device) with the torch generator `gen`.

`link` says what crosses the link to the card: `codes_u8`, the base codes
at one byte a base (the step packs them on the card, K6); or
`packed_2bit`, the reads packed on the host in set-up by the aligner's
own host pack, `map_kernel.pack_reads_host` (its hand-off in
`Pseudoaligner._step`).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from .manifest import BENCH_DIR

LINKS = ("codes_u8", "packed_2bit")


def counts(traffic: dict) -> dict:
    """Reads of each kind and substitutions in one batch."""
    B, L = int(traffic["batch_reads"]), int(traffic["read_len"])
    unmapped = round(B * float(traffic["unmapped_share"]))
    antisense = round((B - unmapped) * float(traffic["antisense_share"]))
    return {"sense": B - unmapped - antisense, "antisense": antisense,
            "unmapped": unmapped,
            "substitutions": round(B * L * float(traffic["error_rate"]))}


def read_weights(starts: np.ndarray, L: int, expression: dict) -> np.ndarray:
    """[n_tx] float64: each transcript's share of the reads, abundance
    times windows (a transcript shorter than a read holds none)."""
    if expression.get("law") != "zipf":
        raise ValueError(f"expression law {expression.get('law')!r}: "
                         "expected 'zipf'")
    n = len(starts) - 1
    rank = np.empty(n, np.float64)
    rank[np.random.default_rng(int(expression["seed"])).permutation(n)] = (
        np.arange(1, n + 1))
    lens = np.diff(starts)
    windows = np.where(lens >= L, lens - L + 1, 0)
    w = rank ** -float(expression["exponent"]) * windows
    return w / w.sum()


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


class Source:
    """The transcriptome on the device, with the traffic's read weights."""

    def __init__(self, flat, traffic: dict, device):
        L = int(traffic["read_len"])
        w = read_weights(flat.starts, L, traffic["expression"])
        self.cum = torch.from_numpy(np.cumsum(w)).to(device)
        lens = np.diff(flat.starts)
        self.windows = torch.from_numpy(
            np.where(lens >= L, lens - L + 1, 0)).to(device)
        self.starts = torch.from_numpy(flat.starts[:-1]).to(device)
        self.bases = torch.from_numpy(flat.bases).to(device)

    def draw(self, n: int, g: torch.Generator):
        """(transcript, start within it) of `n` reads, by the weights."""
        dev = self.cum.device
        u = torch.rand(n, dtype=torch.float64, generator=g, device=dev)
        tx = torch.searchsorted(self.cum, u * self.cum[-1], right=True)
        tx = tx.clamp_max(len(self.cum) - 1)
        off = (torch.rand(n, dtype=torch.float64, generator=g, device=dev)
               * self.windows[tx]).to(torch.int64)
        return tx, off

    def reads(self, n: int, L: int, g: torch.Generator) -> torch.Tensor:
        """[n, L] windows drawn by the read weights."""
        tx, off = self.draw(n, g)
        return self.bases.unfold(0, L, 1)[self.starts[tx] + off]


def fill_batch(src: Source, traffic: dict, g: torch.Generator,
               out: torch.Tensor, bench_dir: str = BENCH_DIR) -> None:
    """Fill `out` [batch_reads, read_len] uint8 with one batch."""
    gen = traffic.get("generator", "windows")
    if gen != "windows":
        path = os.path.join(bench_dir, "traffic", gen + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_traffic_" + gen, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.make(src, traffic, g, out)
        return
    B, L = out.shape
    dev = src.cum.device
    c = counts(traffic)
    mapped = src.reads(c["sense"] + c["antisense"], L, g)
    anti = mapped[c["sense"]:]
    mapped[c["sense"]:] = 3 - anti.flip(1)
    foreign = torch.randint(0, 4, (c["unmapped"], L), dtype=torch.uint8,
                            generator=g, device=dev)
    batch = torch.cat([mapped, foreign])
    batch = batch[torch.randperm(B, generator=g, device=dev)]
    flat = batch.view(-1)
    at = torch.randperm(B * L, generator=g, device=dev)[:c["substitutions"]]
    shift = torch.randint(1, 4, (len(at),), dtype=torch.uint8, generator=g,
                          device=dev)
    flat[at] = (flat[at] + shift) % 4
    out.copy_(batch)


def sample_rows(traffic: dict, rng) -> np.ndarray:
    """The sorted rows of each batch whose answers are judged."""
    B = int(traffic["batch_reads"])
    n = min(int(traffic["sample_reads"]), B)
    return np.sort(rng.choice(B, size=n, replace=False))


def fill_ring(flat, traffic: dict, seed: int, outs: list, device,
              bench_dir: str = BENCH_DIR) -> np.ndarray:
    """Fill each host batch of the ring in turn on `device`, then draw the
    judged rows: a run and the control with one seed see the same reads."""
    src = Source(flat, traffic, device)
    g = generator(seed, device)
    for out in outs:
        fill_batch(src, traffic, g, out, bench_dir)
    del src
    return sample_rows(traffic, np.random.default_rng(seed))
