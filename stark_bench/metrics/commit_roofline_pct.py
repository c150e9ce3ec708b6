"""commit_roofline_pct: the summed frozen bounds of the kernel-wrapper
calls in the commit phases over those phases' device time, in the profiled
proofs (``readings.roofline_pct``)."""

from stark_bench.readings import roofline_pct

LAYER = "commit"
UNIT = "%"
MOVES = "prove_s"
PHASES = ("trace_lde", "trace_commit", "quotient_commit")


def read(rec):
    return roofline_pct(rec, PHASES)
