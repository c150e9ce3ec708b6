"""commit_s: mean seconds a traced proof spends in the commit phases, the
prover's own marks: the trace's LDE and randomizer (``trace_lde``), its
hiding commit (``trace_commit``) and the quotient chunks' commit
(``quotient_commit``)."""

from stark_bench.readings import phase_seconds

LAYER = "commit"
UNIT = "s"
MOVES = "prove_s"
PHASES = ("trace_lde", "trace_commit", "quotient_commit")


def read(rec):
    return phase_seconds(rec, PHASES)
