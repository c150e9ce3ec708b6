"""open_s: mean seconds a traced proof spends in the prover's ``open``
phase: the openings at zeta, FRI, the grind and the query openings."""

from stark_bench.readings import phase_seconds

LAYER = "open"
UNIT = "s"
MOVES = "prove_s"
PHASES = ("open",)


def read(rec):
    return phase_seconds(rec, PHASES)
