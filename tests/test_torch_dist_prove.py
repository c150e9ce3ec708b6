"""The sharded prover end to end (``create_config(mesh=...)``): proofs on
gloo CPU ranks (one torch thread each) byte-identical to the JAX package's
fixtures and to the port's single-device proofs, on both commitment
stacks, verified with the single-device verifier.

* fib zk at 2^10 with the test FRI and the reference's host rng against
  ``tests/golden/torch_fib_zk_jax_proofs.json`` ``tpu_10``, config 2 at
  n = 8 against ``torch_fib_zk_device_jax_proofs.json`` ``"3"``, and the
  Poseidon2 stack against ``torch_poseidon2_jax_proofs.json``
  ``fib_zk_tpu_3``, at 2 ranks;
* fib zk at 2^10 with the host rng against ``tpu_10`` and, in the p3
  layout (random columns drawn for the rank's rows), ``p3_10``, at 4 ranks;
* at JAX's own test size (n = 64, ``tests/test_dist_prove.py``) the port's
  single-device bytes with 2 and 4 ranks in both zk layouts, and on a
  simulated pod of 2 hosts x 2 ranks;
* no rank gathers a matrix of LDE height: the largest all-gather a rank
  receives and the largest matrix it commits whole stay below it.

The ranks run once: four gloo ranks, the 2-rank cases on the subgroup of
ranks 0 and 1.
"""

import functools
import hashlib
import json
import pathlib

import pytest

from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from tpu_stark_torch.dist.dryrun import pod_prove, prove_fib, run_plan, run_ranks
from tpu_stark_torch.fri.config import create_benchmark_fri_params
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.prover.verify import verify

_DIR = pathlib.Path(__file__).parent / "golden"

# name -> (ranks, prove_fib's arguments, (fixture file, key) or None for the
# port's single-device bytes)
PROOFS = {
    "fib_zk_tpu_10": (2, dict(log_n=10, zk_rng="smallrng"), ("torch_fib_zk_jax_proofs.json", "tpu_10")),
    "config2_3": (2, dict(log_n=3, benchmark_fri=True), ("torch_fib_zk_device_jax_proofs.json", "3")),
    "poseidon2_fib_zk_tpu_3": (2, dict(log_n=3, hash="poseidon2", zk_rng="smallrng"),
                               ("torch_poseidon2_jax_proofs.json", "fib_zk_tpu_3")),
    "fib_zk_tpu_10_4ranks": (4, dict(log_n=10, zk_rng="smallrng"), ("torch_fib_zk_jax_proofs.json", "tpu_10")),
    "fib_zk_p3_10_4ranks": (4, dict(log_n=10, zk_rng="smallrng", zk_layout="p3"),
                            ("torch_fib_zk_jax_proofs.json", "p3_10")),
    "n64_tpu_2ranks": (2, dict(log_n=6), None),
    "n64_p3_2ranks": (2, dict(log_n=6, zk_layout="p3"), None),
    "n64_tpu_4ranks": (4, dict(log_n=6), None),
    "n64_p3_4ranks": (4, dict(log_n=6, zk_layout="p3"), None),
    "n64_tpu_pod_2x2": (4, dict(log_n=6, pod=True), None),
}


@pytest.fixture(scope="module")
def proofs():
    """Every rank's result of every proof, by name."""
    plan = []
    for size in (4, 2):
        names = [k for k, (s, _, _) in PROOFS.items() if s == size]
        calls = []
        for k in names:
            kw = dict(PROOFS[k][1])
            fn = pod_prove if kw.pop("pod", False) else prove_fib
            calls.append((functools.partial(fn, **kw), ()))
        plan.append((size, names, calls))
    per_rank = run_ranks(4, run_plan, [(size, calls) for size, _, calls in plan], device="cpu")
    out = {}
    for g, (size, names, _) in enumerate(plan):
        for k, name in enumerate(names):
            out[name] = [per_rank[r][g][k] for r in range(size)]
    return out


def _single_config(kw):
    fri = create_benchmark_fri_params(1) if kw.get("benchmark_fri") else None
    return create_config(fri, zk=True, hash=kw.get("hash", "keccak"), zk_rng=kw.get("zk_rng", "device"),
                         zk_layout=kw.get("zk_layout", "tpu"), device="cpu")


@pytest.mark.parametrize("name", list(PROOFS))
def test_sharded_proof_bytes(proofs, name):
    """Every rank ends with the same proof; it equals the named JAX fixture
    or the port's single-device proof, and the single-device verifier
    accepts it."""
    _size, kw, fixture = PROOFS[name]
    ranks = proofs[name]
    blob = ranks[0]["blob"]
    assert {(r["sha256"], r["len"]) for r in ranks} == {(hashlib.sha256(blob).hexdigest(), len(blob))}
    n = 1 << kw["log_n"]
    pis = [0, 1, fibonacci_value(0, 1, n)]
    cfg = _single_config(kw)
    if fixture is not None:
        want = json.loads((_DIR / fixture[0]).read_text())[fixture[1]]
        if "proof_hex" in want:
            assert blob.hex() == want["proof_hex"]
        assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    else:
        assert blob == serialize_proof(prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), pis))
    assert verify(cfg, FibonacciAir(), deserialize_proof(blob), pis)
    assert {r["transport"] for r in ranks} == {"gloo"}
    assert all(r["sent"]["openings"] > 0 for r in ranks)


@pytest.mark.parametrize("name", list(PROOFS))
def test_no_lde_height_matrix_is_gathered_whole(proofs, name):
    """The largest all-gather a rank receives is at most the committed
    trace's domain (the zk trace of 2n rows, a trace height), and a rank
    commits whole only matrices of fewer than n^2 rows of domain, both
    below the trace's LDE height."""
    size, kw, _ = PROOFS[name]
    log_blowup = 1 if kw.get("benchmark_fri") else 2
    committed = 2 << kw["log_n"]
    for r in proofs[name]:
        assert 0 < r["largest_gather"] <= committed < committed << log_blowup
        assert r["largest_whole_commit"] < (size * size) << log_blowup
