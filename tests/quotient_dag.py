"""A numpy interpreter of the quotient kernel's constraint DAGs
(``tpu_stark_torch/air/quotient_kernel.py``), shared by the CPU tests and
the card's tests; it imports neither jax nor torch."""

import numpy as np

P = 0x78000001
R_INV = pow(1 << 32, P - 2, P)


def _mul(a, b):
    """Montgomery product of uint64 arrays of Monty residues."""
    return (a * b % P) * R_INV % P


def interpret(dag, cur, nxt, sels, pis, alpha) -> np.ndarray:
    """(m, 4) uint32 Monty sum over k of alpha[k] * C_k: the DAG's nodes
    evaluated one by one over the rows.  ``cur``/``nxt``: (m, u) Monty
    panels (``nxt`` holds each row's next row); ``sels``: selector name ->
    (m,); ``pis``: (k,); ``alpha``: (C, 4); all Monty."""
    cur, nxt = np.asarray(cur, dtype=np.uint64), np.asarray(nxt, dtype=np.uint64)
    m = cur.shape[0]
    vals = []
    for n in dag.nodes:
        kind = n[0]
        if kind == "col":
            v = (cur if n[1] == 0 else nxt)[:, n[2]]
        elif kind == "sel":
            v = np.asarray(sels[n[1]], dtype=np.uint64)
        elif kind == "pub":
            v = np.full(m, int(pis[n[1]]), dtype=np.uint64)
        elif kind == "const":
            v = np.full(m, (n[1] << 32) % P, dtype=np.uint64)
        elif kind == "neg":
            v = (P - vals[n[1]]) % P
        elif kind == "add":
            v = (vals[n[1]] + vals[n[2]]) % P
        elif kind == "sub":
            v = (vals[n[1]] + P - vals[n[2]]) % P
        else:
            assert kind == "mul", n
            v = _mul(vals[n[1]], vals[n[2]])
        vals.append(v)
    alpha = np.asarray(alpha, dtype=np.uint64)
    acc = np.zeros((m, 4), dtype=np.uint64)
    for k, r in enumerate(dag.roots):
        for i in range(4):
            acc[:, i] = (acc[:, i] + _mul(alpha[k, i], vals[r])) % P
    return acc.astype(np.uint32)
