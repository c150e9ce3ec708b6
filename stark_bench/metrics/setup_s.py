"""setup_s: everything before the window, from the harness's first line:
imports, the witnesses, the kernels' build or load, the warm-up proofs."""

UNIT = "s"


def read(rec):
    return rec.setup_s
