"""The port's streamed wide prover on keccak-air (BASELINE config 4's AIR and
FRI parameters: Poseidon2 stack, zk off, blowup 2, 100 queries, 16 PoW
bits) against the JAX package's proofs.

* ``prove_wide`` at num_perms = 2 (64 rows) and 5 (128 rows) against
  ``tests/golden/torch_keccak_air_jax_proofs.json`` (SHA-256 and length),
  which the JAX package's ``prove_wide`` wrote on the CPU.  The tests read
  the fixture and never run the JAX prover.  Regenerate it with:
      python tests/test_torch_keccak_air.py regen
* the wide proof verifies, does not depend on the column-chunk width, and
  equals the port's dense ``prove`` on the same trace;
* a proof of a trace with one flipped bit does not verify.
"""

import functools
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from tpu_stark_torch.air.keccak_air import A_OFF, KeccakAir, generate_trace
from tpu_stark_torch.fri.config import create_benchmark_fri_params, create_test_fri_params
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.prover.verify import verify
from tpu_stark_torch.prover.wide import default_col_chunk, prove_wide

JAX_PROOFS = pathlib.Path(__file__).parent / "golden" / "torch_keccak_air_jax_proofs.json"
FIXTURE_PERMS = (2, 5)  # 64 and 128 trace rows
SEED = 1


def _cfg():
    return create_config(create_benchmark_fri_params(1), zk=False, hash="poseidon2", device="cpu")


@functools.lru_cache(maxsize=None)
def _wide_blob(perms, col_chunk):
    trace = generate_trace(perms, seed=SEED, device="cpu")
    return serialize_proof(prove_wide(_cfg(), KeccakAir(), trace, [], col_chunk=col_chunk))


@pytest.mark.parametrize("perms,col_chunk", [(2, None), (5, 64)])
def test_wide_proof_matches_jax_and_verifies(perms, col_chunk):
    want = json.loads(JAX_PROOFS.read_text())[f"perms_{perms}"]
    rows = want["rows"]
    # the default chunk width at 2 * 64 LDE rows is 512 columns: 8 chunks
    assert -(-KeccakAir.width // (col_chunk or default_col_chunk(2 * rows))) >= 8
    blob = _wide_blob(perms, col_chunk)
    assert len(blob) == want["len"]
    assert hashlib.sha256(blob).hexdigest() == want["sha256"]
    proof = deserialize_proof(blob)
    assert proof.degree_bits == rows.bit_length() - 1
    assert verify(_cfg(), KeccakAir(), proof, [])


def test_wide_proof_equals_dense_proof():
    """At blowup 4, where the dense prover's quotient domain (4n points)
    fits inside the committed LDE (the benchmark's blowup 2 does not)."""
    cfg = lambda: create_config(create_test_fri_params(2), zk=False, hash="poseidon2", device="cpu")  # noqa: E731
    trace = generate_trace(2, seed=SEED, dtype=torch.int32, device="cpu")
    wide = serialize_proof(prove_wide(cfg(), KeccakAir(), trace, [], col_chunk=1024))
    assert serialize_proof(prove(cfg(), KeccakAir(), trace.numpy().view(np.uint32), [])) == wide
    assert verify(cfg(), KeccakAir(), deserialize_proof(wide), [])


def test_wide_proof_of_tampered_trace_rejected():
    trace = generate_trace(2, seed=6, device="cpu")
    trace[10, A_OFF + 123] ^= 1
    proof = prove_wide(_cfg(), KeccakAir(), trace, [], col_chunk=256)
    assert not verify(_cfg(), KeccakAir(), proof, [])


def _regen():
    """Write JAX_PROOFS by running the JAX package's prove_wide on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import time

    from tpu_stark.air.keccak_air import KeccakAir as JKeccakAir
    from tpu_stark.air.keccak_air import generate_trace as j_generate_trace
    from tpu_stark.fri.config import create_benchmark_fri_params as j_bench_fri
    from tpu_stark.prover.config import create_config as j_create_config
    from tpu_stark.prover.proof import serialize_proof as j_serialize
    from tpu_stark.prover.wide import prove_wide as j_prove_wide

    out = {}
    for perms in FIXTURE_PERMS:
        t0 = time.perf_counter()
        trace = j_generate_trace(num_perms=perms, seed=SEED, dtype=np.uint8)
        cfg = j_create_config(j_bench_fri(1), zk=False, backend="cpu", hash="poseidon2")
        blob = j_serialize(j_prove_wide(cfg, JKeccakAir(), trace, []))
        out[f"perms_{perms}"] = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob),
                                 "rows": int(trace.shape[0])}
        print(f"perms={perms} rows={trace.shape[0]}: {len(blob)} B "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    JAX_PROOFS.write_text(json.dumps(out, indent=1, sort_keys=True))


if __name__ == "__main__":
    assert sys.argv[1:] == ["regen"], "usage: python tests/test_torch_keccak_air.py regen"
    _regen()
