"""The port's Poseidon2 (field-native) stack end to end against the JAX
package's proofs.

* fib_air zk n = 8 in both layouts (full bytes), fib_air non-zk n = 2^10
  (BASELINE config 1) and the Poseidon2 hash chain at n = 8 and 2^6 (the AIR
  of BASELINE config 3), against ``tests/golden/torch_poseidon2_jax_proofs.json``,
  which the JAX prover wrote (SHA-256 and length beside every entry).  The
  tests read the fixture and never run the JAX prover: its cold CPU compile
  of the 493-column chain takes minutes.  Regenerate it with:
      python tests/test_torch_poseidon2_air.py regen
* ``generate_trace`` against JAX's at n = 8 and 16;
* the port's verifier accepts every proof, rejects a wrong final state, and
  rejects a proof made on the other hash stack.
"""

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from tpu_stark_torch.air.poseidon2_air import COLS, Poseidon2ChainAir, generate_trace
from tpu_stark_torch.commit.poseidon2_mmcs import DuplexChallenger, Poseidon2Mmcs
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.prover.verify import verify

JAX_PROOFS = pathlib.Path(__file__).parent / "golden" / "torch_poseidon2_jax_proofs.json"
CHAIN_INIT = list(range(16))  # the initial state app.api.run_poseidon2_chain proves
FULL_BYTES = ("fib_zk_tpu_3", "fib_zk_p3_3")


def _want(key):
    return json.loads(JAX_PROOFS.read_text())[key]


def _fib(log_n, zk, layout="tpu"):
    n = 1 << log_n
    cfg = create_config(zk=zk, hash="poseidon2", zk_rng="smallrng", zk_layout=layout, device="cpu")
    pis = [0, 1, fibonacci_value(0, 1, n)]
    return cfg, FibonacciAir(), pis, prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), pis)


def _chain(log_n):
    cfg = create_config(zk=False, hash="poseidon2", device="cpu")
    trace, pis = generate_trace(1 << log_n, CHAIN_INIT, device="cpu")
    return cfg, Poseidon2ChainAir(), pis, prove(cfg, Poseidon2ChainAir(), trace, pis)


def _check(key, cfg, air, pis, proof):
    want = _want(key)
    blob = serialize_proof(proof)
    if "proof_hex" in want:
        assert blob.hex() == want["proof_hex"]
    assert len(blob) == want["len"]
    assert hashlib.sha256(blob).hexdigest() == want["sha256"]
    assert verify(cfg, air, deserialize_proof(blob), pis)


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_fib_zk_n8_bytes_match_jax(layout):
    _check(f"fib_zk_{layout}_3", *_fib(3, True, layout))


def test_fib_plain_2_10_matches_jax():
    _check("fib_plain_10", *_fib(10, False))


@pytest.mark.parametrize("log_n", [3, 6])
def test_chain_proof_matches_jax(log_n):
    _check(f"chain_{log_n}", *_chain(log_n))


@pytest.mark.parametrize("n", [8, 16])
def test_generate_trace_matches_jax(n):
    from tpu_stark.air.poseidon2_air import generate_trace as j_generate_trace

    init = [int(v) for v in np.random.default_rng(n).integers(0, 0x78000001, size=16)]
    trace, pis = generate_trace(n, init, device="cpu")
    j_trace, j_pis = j_generate_trace(n, init)
    assert trace.shape == (n, COLS) and trace.dtype == np.uint32
    assert np.array_equal(trace, np.asarray(j_trace))
    assert pis == [int(v) for v in j_pis]


def test_chain_verifier_rejects_wrong_final_state():
    cfg, air, pis, proof = _chain(3)
    assert verify(cfg, air, proof, pis)
    bad = list(pis)
    bad[16 + 5] = (bad[16 + 5] + 1) % 0x78000001
    assert not verify(cfg, air, proof, bad)


def test_cross_stack_proofs_rejected():
    air, trace, pis = FibonacciAir(), generate_trace_rows(0, 1, 8), [0, 1, 21]
    cfgs = {h: create_config(zk=False, hash=h, device="cpu") for h in ("keccak", "poseidon2")}
    proofs = {h: prove(cfgs[h], air, trace, pis) for h in cfgs}
    for h in cfgs:
        assert verify(cfgs[h], air, proofs[h], pis)
    assert not verify(cfgs["poseidon2"], air, proofs["keccak"], pis)
    assert not verify(cfgs["keccak"], air, proofs["poseidon2"], pis)


@pytest.mark.parametrize("zk", [False, True])
def test_poseidon2_config_assembles(zk):
    cfg = create_config(zk=zk, hash="poseidon2", zk_rng="smallrng", zk_layout="p3", device="cpu")
    assert isinstance(cfg.pcs.val_mmcs, Poseidon2Mmcs)
    assert isinstance(cfg.pcs.challenge_mmcs, Poseidon2Mmcs)
    assert cfg.pcs.val_mmcs.hiding is zk and not cfg.pcs.challenge_mmcs.hiding
    assert isinstance(cfg.challenger(), DuplexChallenger)


def _regen():
    """Write JAX_PROOFS by running the JAX prover on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_stark.air.fibonacci import FibonacciAir as JFib
    from tpu_stark.air.fibonacci import fibonacci_value as j_fib_value
    from tpu_stark.air.fibonacci import generate_trace_rows as j_trace_rows
    from tpu_stark.air.poseidon2_air import Poseidon2ChainAir as JChain
    from tpu_stark.air.poseidon2_air import generate_trace as j_chain_trace
    from tpu_stark.prover.config import create_config as j_create_config
    from tpu_stark.prover.proof import serialize_proof as j_serialize
    from tpu_stark.prover.prove import prove as j_prove

    def fib(log_n, zk, layout="tpu"):
        n = 1 << log_n
        cfg = j_create_config(zk=zk, backend="cpu", hash="poseidon2", zk_rng="smallrng",
                              zk_layout=layout)
        return j_prove(cfg, JFib(), j_trace_rows(0, 1, n), [0, 1, j_fib_value(0, 1, n)])

    def chain(log_n):
        trace, pis = j_chain_trace(1 << log_n, CHAIN_INIT)
        return j_prove(j_create_config(zk=False, backend="cpu", hash="poseidon2"),
                       JChain(), trace, pis)

    jobs = {
        "fib_zk_tpu_3": lambda: fib(3, True, "tpu"),
        "fib_zk_p3_3": lambda: fib(3, True, "p3"),
        "fib_plain_10": lambda: fib(10, False),
        "chain_3": lambda: chain(3),
        "chain_6": lambda: chain(6),
    }
    out = {}
    for key, job in jobs.items():
        blob = j_serialize(job())
        out[key] = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
        if key in FULL_BYTES:
            out[key]["proof_hex"] = blob.hex()
        print(f"{key}: {len(blob)} B", flush=True)
    JAX_PROOFS.write_text(json.dumps(out, indent=1, sort_keys=True))


if __name__ == "__main__":
    assert sys.argv[1:] == ["regen"], "usage: python tests/test_torch_poseidon2_air.py regen"
    _regen()
