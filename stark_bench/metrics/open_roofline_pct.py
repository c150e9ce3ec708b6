"""open_roofline_pct: the summed frozen bounds of the kernel-wrapper
calls in the open phases over those phases' device time, in the profiled
proofs (``readings.roofline_pct``)."""

from stark_bench.readings import roofline_pct

LAYER = "open"
UNIT = "%"
MOVES = "prove_s"
PHASES = ("open",)


def read(rec):
    return roofline_pct(rec, PHASES)
