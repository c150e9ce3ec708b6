"""quotient_roofline_pct: the summed frozen bounds of the kernel-wrapper
calls in the quotient phases over those phases' device time, in the profiled
proofs (``readings.roofline_pct``)."""

from stark_bench.readings import roofline_pct

LAYER = "quotient"
UNIT = "%"
MOVES = "prove_s"
PHASES = ("quotient",)


def read(rec):
    return roofline_pct(rec, PHASES)
