"""The port's zk streamed wide prover end to end against the JAX package's
proofs (the reference's stack: Keccak Merkle trees, zk on, the device rng).

* keccak-air at num_perms = 2 (64 rows, 3,608 columns) under
  ``create_config(zk=True, hash="keccak")`` streamed in 1024-column chunks
  (4 chunks, each with its own randomizer stream), and under
  ``hash="poseidon2"`` in one 4096-column chunk, against
  ``tests/golden/torch_keccak_air_wide_zk_jax_proofs.json`` (SHA-256 and
  length), which the JAX package's ``prove_wide`` wrote on the CPU.  The
  tests read the fixture and never run the JAX prover.  Regenerate it with:
      python tests/test_torch_wide_zk.py regen
* each proof verifies with the port's verifier;
* the prove twin on the reference's stack (``python -m
  tpu_stark_torch.bench.prove keccak-air 6 test 0 keccak zk``) proves and
  verifies in 8 chunks, and its proof is as long as JAX's (a proof's length
  depends on its structure only).
"""

import contextlib
import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from tpu_stark_torch.air.keccak_air import KeccakAir, generate_trace
from tpu_stark_torch.bench import prove as bench_prove
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.prove import get_log_quotient_degree
from tpu_stark_torch.prover.verify import verify
from tpu_stark_torch.prover.wide import prove_wide

JAX_PROOFS = pathlib.Path(__file__).parent / "golden" / "torch_keccak_air_wide_zk_jax_proofs.json"
# name: (hash stack, trace seed, column chunk)
CASES = {"keccak_4chunks": ("keccak", 8, 1024), "poseidon2_1chunk": ("poseidon2", 7, 4096)}
PERMS = 2  # 64 trace rows


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The proves here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(stack):
    return create_config(zk=True, hash=stack, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_zk_wide_proof_matches_jax_and_verifies(name):
    stack, seed, col_chunk = CASES[name]
    want = json.loads(JAX_PROOFS.read_text())[name]
    trace = generate_trace(PERMS, seed=seed, device="cpu")
    assert int(trace.shape[0]) == want["rows"]
    source_chunks = -(-KeccakAir.width // col_chunk)
    assert source_chunks == (4 if stack == "keccak" else 1)
    blob = serialize_proof(prove_wide(_cfg(stack), KeccakAir(), trace, [], col_chunk=col_chunk))
    assert len(blob) == want["len"]
    assert hashlib.sha256(blob).hexdigest() == want["sha256"]
    proof = deserialize_proof(blob)
    assert proof.log_quotient_degree == get_log_quotient_degree(KeccakAir(), 0, True) == 3
    assert verify(_cfg(stack), KeccakAir(), proof, [])


def test_keccak_air_twin_on_the_reference_stack():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench_prove.main(["keccak-air", "6", "test", "0", "keccak", "zk", "--device", "cpu"])
    assert json.loads(buf.getvalue().splitlines()[-1]) == out
    assert out["metric"] == "keccak_air_prove_2^6_test_keccak_zk"
    assert out["proof_bytes"] == json.loads(JAX_PROOFS.read_text())["keccak_4chunks"]["len"]
    a = bench_prove.parser().parse_args(["keccak-air"])
    assert (a.log_n, a.params, a.reps, a.hash, a.mode) == (20, "bench", 1, "poseidon2", "plain")


def _regen():
    """Write JAX_PROOFS by running the JAX package's prove_wide on the CPU."""
    import os
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_stark.air.keccak_air import KeccakAir as JKeccakAir
    from tpu_stark.air.keccak_air import generate_trace as j_generate_trace
    from tpu_stark.prover.config import create_config as j_create_config
    from tpu_stark.prover.proof import serialize_proof as j_serialize
    from tpu_stark.prover.verify import verify as j_verify
    from tpu_stark.prover.wide import prove_wide as j_prove_wide

    out = {}
    for name, (stack, seed, col_chunk) in CASES.items():
        t0 = time.perf_counter()
        trace = j_generate_trace(num_perms=PERMS, seed=seed).astype(np.uint8)
        os.environ["TPU_STARK_WIDE_CHUNK"] = str(col_chunk)
        try:
            proof = j_prove_wide(j_create_config(zk=True, backend="cpu", hash=stack), JKeccakAir(), trace, [])
        finally:
            del os.environ["TPU_STARK_WIDE_CHUNK"]
        assert j_verify(j_create_config(zk=True, backend="cpu", hash=stack), JKeccakAir(), proof, [])
        blob = j_serialize(proof)
        out[name] = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob),
                     "rows": int(trace.shape[0]), "seed": seed, "col_chunk": col_chunk, "hash": stack}
        print(f"{name}: {len(blob)} B ({time.perf_counter() - t0:.1f}s)", flush=True)
    JAX_PROOFS.write_text(json.dumps(out, indent=1, sort_keys=True))


if __name__ == "__main__":
    assert sys.argv[1:] == ["regen"], "usage: python tests/test_torch_wide_zk.py regen"
    _regen()
