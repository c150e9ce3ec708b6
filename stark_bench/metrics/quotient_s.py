"""quotient_s: mean seconds a traced proof spends in the prover's
``quotient`` phase, the quotient over the disjoint coset."""

from stark_bench.readings import phase_seconds

LAYER = "quotient"
UNIT = "s"
MOVES = "prove_s"
PHASES = ("quotient",)


def read(rec):
    return phase_seconds(rec, PHASES)
