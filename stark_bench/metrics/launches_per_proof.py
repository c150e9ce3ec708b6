"""launches_per_proof: the hand-written kernels' launches (the port's
``KernelInfo`` counters) over the traced window's proofs."""

LAYER = "kernels"
UNIT = "launches"
MOVES = "prove_s"


def read(rec):
    return rec.launches / len(rec.phases) if rec.phases else None
