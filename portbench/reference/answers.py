"""The reference's answers for a set of reads, and the judge that holds
the serving step's outputs against them.

Nothing here reads what the program made: the graph comes from the
transcripts (graph.RefGraph), the reads from the traffic.  The program's
outputs are only judged.
"""

from __future__ import annotations

import numpy as np

from .graph import RefGraph
from .walk import FLAG_CAPPED, Shape, expected, walk_read


class Answers:
    """Per read: capped, mapped, coverage and class slots ([n, dc])."""

    def __init__(self, capped, mapped, cov, slots):
        self.capped = capped
        self.mapped = mapped
        self.cov = cov
        self.slots = slots


def answers(g: RefGraph, reads: np.ndarray, shape: Shape,
            allowed: int | None = None) -> Answers:
    """The answers due for `reads` ([n, L] codes); `allowed` overrides the
    per-segment mismatch budget (the control breaks it)."""
    n = len(reads)
    capped = np.zeros(n, bool)
    mapped = np.zeros(n, bool)
    cov = np.zeros(n, np.int64)
    slots = np.zeros((n, shape.dc), np.int64)
    budget = shape.allowed if allowed is None else allowed
    for i in range(n):
        w = walk_read(g, reads[i], budget, shape.left_fraction, shape.lazy)
        capped[i], mapped[i], cov[i], slots[i] = expected(w, shape)
    return Answers(capped, mapped, cov, slots)


def wrong(ref: Answers, ec, cov, mapped) -> np.ndarray:
    """Which outputs (ec [n, dc], cov [n], mapped [n]) say something else
    than the reference: a read a cap cut must carry -3 in its last slot;
    any other read must match in every slot, its coverage and whether it
    mapped."""
    ec = np.asarray(ec, np.int64)
    cov = np.asarray(cov, np.int64)
    mapped = np.asarray(mapped, bool)
    bad_capped = ec[:, -1] != FLAG_CAPPED
    bad_other = ((ec != ref.slots).any(axis=1) | (cov != ref.cov)
                 | (mapped != ref.mapped))
    return np.where(ref.capped, bad_capped, bad_other)


def control_outputs(ctl: Answers):
    """The control's answers in the program's output form: reads its own
    walk would cap carry -3, as the program's would."""
    ec = ctl.slots.copy()
    ec[ctl.capped, -1] = FLAG_CAPPED
    return ec, ctl.cov, ctl.mapped
