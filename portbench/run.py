"""The benchmark of pseudoaligner_torch's device mapping step.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json on the card it is started on: loads (or,
in a checkout's first run, builds) the configuration's transcriptome,
index image and reference graph under portbench/.cache/, sets up the
aligner, makes the traffic ring from --seed, warms the cell's shapes,
then drives map_kernel.map_batch for S seconds with the traffic's
in_flight batches ahead.  --trace 1 profiles the window and reports the
per-layer metrics; --trace 0 the end-to-end ones.  Every run judges the
sampled answers of every batch against the plain reference
(portbench/reference/) and prints, last on stdout, one JSON line.

Exits non-zero without a result when CUDA is missing or has fewer cards
than the cell asks for, or when jax, jaxlib, flax or pseudoaligner_tpu was
loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

BANNED = ("jax", "jaxlib", "flax", "pseudoaligner_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def result_line(cell, run, trace: bool, device_kind: str, readers) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = readers[m.name](run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {
        "correct": all(v <= lim for v, lim in run.checks.values()),
        "attempted": run.tally.dispatched,
        "failed": run.failed_batches + run.checks["batches_unanswered"][0],
        "metrics": metrics,
        "device": device,
    }
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"

    import torch

    from harness import manifest
    from harness.session import run_cell

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    readers = {m.name: manifest.reader(m.name)
               for m in cell.end_to_end + cell.per_layer}
    trace = bool(args.trace)
    run = run_cell(cell, args.seed, args.seconds, trace, "cuda", T_PROCESS)
    found = banned_modules()
    if found:
        print(f"loaded in the result's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, run, trace, torch.cuda.get_device_name(0),
                       readers)
    print(f"card: {card_line()}; peaks 3.35 TB/s, 67 T int32 op/s "
          f"(data sheet, 700 W)", file=sys.stderr)
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"host peak RSS {rss:.2f} GiB", file=sys.stderr)
    print(f"answers judged {run.judged}, flagged -2/-3 "
          f"{100 * run.flagged:.4f}%; batches done in the window "
          f"{run.tally.done} of {run.tally.dispatched} dispatched; "
          f"setup_s {run.setup_s:.3f} (" + ", ".join(
              f"{n} {t:.3f}" for n, t in run.setup_steps) + ")",
          file=sys.stderr)
    print(f"reference graph loaded and answers judged in {run.judge_s:.2f} s",
          file=sys.stderr)
    if run.hit_share is not None:
        print(f"K1 hit share {100 * run.hit_share:.4f}% (sampled probes of "
              "each ring slot, looked up in the reference graph)",
              file=sys.stderr)
    if run.tally.latencies:
        import numpy as np

        q = np.percentile(np.asarray(run.tally.latencies) * 1e3,
                          [50, 95, 99, 100])
        print("batch latency ms q50 {:.3f} q95 {:.3f} q99 {:.3f} max {:.3f}"
              .format(*q), file=sys.stderr)
    for n, (v, lim) in run.checks.items():
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
