"""The application API (counterpart of ``tpu_stark/app/api.py``): the
reference's JNI surface in Python, with its contract strings.

* ``set_backend(name)``      — ``"cuda"`` (default) or ``"cpu"``;
* ``is_cuda_available()``    — the probe, never raises;
* ``run_fib_air_zk()``       — prove + verify round trip; returns
  ``"fib_air zk ok (n=8, x=21)"`` on success, ``"fib_air zk failed: ..."``
  when verification rejects, ``"fib_air zk panicked: ..."`` with the
  traceback when anything raises; never raises, and appends any error
  recorded during the run as ``"\\nbackend error: ..."``;
* ``run_dft_benchmark()``    — the 11-case report (``bench/harness.py``);
* ``run_keccak_air``, ``run_poseidon2_chain`` — BASELINE configs 4 and 3
  at a small height, with the same contract.

Every run builds its config on ``registry.device()``.  Unlike the JAX
package, the ``cuda`` backend on a machine without a card does not prove on
the CPU: the run panics with an error that names CUDA.
"""

from __future__ import annotations

import traceback

from ..air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from ..backend import registry
from ..bench.harness import run_dft_benchmark as _bench
from ..prover.config import create_config
from ..prover.prove import prove
from ..prover.verify import verify


def set_backend(name: str) -> None:
    registry.set_backend(name)


def is_cuda_available() -> bool:
    return registry.is_cuda_available()


def _with_backend_error(result: str) -> str:
    err = registry.take_last_error()
    if err:
        result += f"\nbackend error: {err}"
    return result


def run_fib_air_zk(n: int = 8, hash: str = "keccak") -> str:
    """Prove + verify the Fibonacci AIR with zk, n rows, pis [0, 1, fib(n)]
    (the defaults are the reference's: n = 2^3, x = 21, the Keccak stack;
    ``hash="poseidon2"`` uses the field-native stack)."""
    registry.take_last_error()  # drain stale errors so the append reports only this run's
    try:
        dev = registry.device()
        air = FibonacciAir()
        a, b = 0, 1
        x = fibonacci_value(a, b, n)
        trace = generate_trace_rows(a, b, n)
        pis = [a, b, x]
        proof = prove(create_config(zk=True, hash=hash, device=dev), air, trace, pis)
        ok = verify(create_config(zk=True, hash=hash, device=dev), air, proof, pis)
        if not ok:
            result = "fib_air zk failed: verification rejected the proof"
        else:
            result = f"fib_air zk ok (n={n}, x={x})"
    except Exception as e:  # noqa: BLE001 — panic containment
        result = f"fib_air zk panicked: {e}\n{traceback.format_exc(limit=3)}"
    return _with_backend_error(result)


def run_dft_benchmark() -> str:
    try:
        return _bench()
    except Exception as e:  # noqa: BLE001
        return f"dft benchmark failed: {e}"


def run_keccak_air(log_n: int = 10) -> str:
    """Prove + verify the keccak-f permutation AIR at 2^log_n rows through
    the streamed wide prover (the BASELINE config 4 workload).  Same
    contract as run_fib_air_zk."""
    registry.take_last_error()
    try:
        from ..air.keccak_air import NUM_ROUNDS, KeccakAir, generate_trace
        from ..prover.wide import prove_wide

        dev = registry.device()
        n = 1 << log_n
        trace = generate_trace(num_perms=max(1, n // NUM_ROUNDS), seed=1, device=dev)[:n]
        proof = prove_wide(create_config(zk=False, hash="poseidon2", device=dev), KeccakAir(), trace, [])
        ok = verify(create_config(zk=False, hash="poseidon2", device=dev), KeccakAir(), proof, [])
        result = (
            f"keccak_air ok (rows=2^{log_n}, cols={KeccakAir.width})"
            if ok
            else "keccak_air failed: verification rejected the proof"
        )
    except Exception as e:  # noqa: BLE001
        result = f"keccak_air panicked: {e}\n{traceback.format_exc(limit=3)}"
    return _with_backend_error(result)


def run_poseidon2_chain(log_n: int = 10) -> str:
    """Prove + verify the Poseidon2 hash-chain AIR at 2^log_n rows (the
    BASELINE config 3 workload)."""
    registry.take_last_error()
    try:
        from ..air.poseidon2_air import Poseidon2ChainAir, generate_trace

        dev = registry.device()
        trace, pis = generate_trace(1 << log_n, list(range(16)), device=dev)
        proof = prove(create_config(zk=False, hash="poseidon2", device=dev), Poseidon2ChainAir(), trace, pis)
        ok = verify(create_config(zk=False, hash="poseidon2", device=dev), Poseidon2ChainAir(), proof, pis)
        result = (
            f"poseidon2_chain ok (rows=2^{log_n})"
            if ok
            else "poseidon2_chain failed: verification rejected the proof"
        )
    except Exception as e:  # noqa: BLE001
        result = f"poseidon2_chain panicked: {e}\n{traceback.format_exc(limit=3)}"
    return _with_backend_error(result)


# The reference ships two misspelled exports that forward to setBackend;
# kept for surface parity.
set_bAckend = set_backend
setBAckend = set_backend
