"""The control of a cell's correctness check, at the cell's own size.

    python3 portbench/control.py --workload CELL --seeds N [N ...]

For each seed: the traffic ring and judged rows a run with that seed
makes, the plain reference's answers, and the answers of the control --
the same reference with the configuration's per-segment mismatch budget
(2) taken to 0, an exact-match walk -- put in the program's place and
judged as a run judges the program.  The traffic is made on the card
when there is one, as a run makes it, so the reads are a run's.  Prints per seed the answers judged
and how many the control gets wrong (the upper reading of
`wrong_answers`), then a JSON line.  Needs no card; the benchmark's own
runs never run it.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from harness import manifest, traffic
    from harness.build import Built
    from harness.session import shape_of
    from pseudoaligner_torch.cli import serving_config
    from pseudoaligner_torch.ops.map_kernel import device_index_from_image
    from reference.answers import answers, control_outputs, wrong

    cell = manifest.cell(args.workload)
    tr, cfg = cell.traffic, cell.config
    B, L = int(tr["batch_reads"]), int(tr["read_len"])
    R = int(tr["ring_batches"])
    built = Built(cfg)
    flat = built.flat()
    g = built.refgraph()
    sc = serving_config(int(cfg["k"]), B, L, seed_index=cfg["seed_index"])
    shape = shape_of(device_index_from_image(built.index(), sc)[1])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = {}
    for seed in args.seeds:
        t = time.perf_counter()
        slots = [torch.empty((B, L), dtype=torch.uint8) for _ in range(R)]
        rows = traffic.fill_ring(flat, tr, seed, slots, device,
                                 cell.bench_dir)
        judged = bad = 0
        for s in slots:
            reads = s.numpy()[rows]
            ref = answers(g, reads, shape)
            ctl = answers(g, reads, shape, allowed=0)
            bad += int(wrong(ref, *control_outputs(ctl)).sum())
            judged += len(reads)
        out[seed] = {"judged": judged, "control_wrong": bad}
        print(f"seed {seed}: control wrong_answers {bad} of {judged} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload, "seeds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
