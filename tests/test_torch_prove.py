"""The port's prover end to end against the JAX package's proofs.

* n = 8: the golden transcripts (every challenger event, then the proof
  bytes) of ``tests/golden/fib_air_zk_n8_smallrng{,_p3}.json``;
* n = 2^10, 2^12, 2^14: proof bytes against ``tests/golden/
  torch_fib_zk_jax_proofs.json``, which the JAX prover wrote (full bytes at
  2^10, SHA-256 and length above).  The tests read the fixture and never run
  the JAX prover, whose cold CPU compiles take minutes.  Regenerate it with:
      python tests/test_torch_prove.py regen
* the port's verifier accepts its proofs and rejects tampered ones;
* importing the port never imports jax.
"""

import copy
import hashlib
import json
import pathlib
import subprocess
import sys

import pytest

from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from tpu_stark_torch.challenger.challenger import Challenger
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.prover.verify import verify

_DIR = pathlib.Path(__file__).parent / "golden"
GOLDEN = {
    "tpu": _DIR / "fib_air_zk_n8_smallrng.json",
    "p3": _DIR / "fib_air_zk_n8_smallrng_p3.json",
}
JAX_PROOFS = _DIR / "torch_fib_zk_jax_proofs.json"
FIXTURE_LOGS = (10, 12, 14)
FULL_BYTES_MAX_LOG = 10


def _recording_factory(events):
    class RecordingChallenger(Challenger):
        def observe_u32(self, value):
            events.append(["obs_u32", int(value)])
            super().observe_u32(value)

        def observe_commitment(self, digest):
            events.append(["obs_commit", [int(w) for w in digest]])
            super().observe_commitment(digest)

        def sample_u32(self):
            v = super().sample_u32()
            events.append(["sample_u32", int(v)])
            return v

        def clone(self):
            return Challenger(self.inner.clone())  # grind probes do not record

    return RecordingChallenger


def _prove(log_n, layout, factory=None):
    n = 1 << log_n
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout)
    if factory is not None:
        cfg.challenger_factory = factory
    pis = [0, 1, fibonacci_value(0, 1, n)]
    return cfg, pis, prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), pis)


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_n8_transcript_and_bytes_match_golden(layout):
    fixture = json.loads(GOLDEN[layout].read_text())
    events = []
    _, _, proof = _prove(3, layout, _recording_factory(events))
    assert len(events) == len(fixture["events"])
    for i, (got, want) in enumerate(zip(events, fixture["events"])):
        assert got == want, f"transcript event {i}: {got} != {want}"
    assert serialize_proof(proof).hex() == fixture["proof_hex"]


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_golden_proof_verifies_with_port(layout):
    fixture = json.loads(GOLDEN[layout].read_text())
    proof = deserialize_proof(bytes.fromhex(fixture["proof_hex"]))
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout)
    assert verify(cfg, FibonacciAir(), proof, [0, 1, 21])
    assert serialize_proof(proof).hex() == fixture["proof_hex"]


@pytest.mark.parametrize(
    "log_n",
    # 2^14 takes 10-25 s of CPU per layout; the chip smoke checks it on the card
    [10, 12, pytest.param(14, marks=pytest.mark.slow)],
)
@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_proof_bytes_match_jax(layout, log_n):
    want = json.loads(JAX_PROOFS.read_text())[f"{layout}_{log_n}"]
    cfg, pis, proof = _prove(log_n, layout)
    blob = serialize_proof(proof)
    if "proof_hex" in want:
        assert blob.hex() == want["proof_hex"]
    assert len(blob) == want["len"]
    assert hashlib.sha256(blob).hexdigest() == want["sha256"]
    assert verify(cfg, FibonacciAir(), deserialize_proof(blob), pis)


def _tamper_cases(proof):
    def commit_word(p):
        p.commitments.trace = (p.commitments.trace[0] ^ 1,) + tuple(p.commitments.trace[1:])

    def opened_local(p):
        v = p.opened_values.trace_local[0]
        p.opened_values.trace_local[0] = ((v[0] + 1) % 0x78000001,) + tuple(v[1:])

    def quotient_value(p):
        v = p.opened_values.quotient_chunks[1][2]
        p.opened_values.quotient_chunks[1][2] = tuple(v[:3]) + ((v[3] + 5) % 0x78000001,)

    def final_poly(p):
        f = p.opening_proof.final_poly[0]
        p.opening_proof.final_poly[0] = ((f[0] + 1) % 0x78000001,) + tuple(f[1:])

    def query_row(p):
        row = p.opening_proof.query_proofs[0].input_openings[0].opened_values[0]
        row[0] = (int(row[0]) + 1) % 0x78000001

    def fold_sibling(p):
        step = p.opening_proof.query_proofs[1].commit_phase_openings[2].opening
        d = step.proof[0]
        step.proof[0] = (d[0] ^ (1 << 40),) + tuple(d[1:])

    def random_commit(p):
        p.opening_proof.random_commit = None

    return [commit_word, opened_local, quotient_value, final_poly, query_row,
            fold_sibling, random_commit]


@pytest.mark.parametrize("case", range(7))
def test_verify_rejects_tampered_proof(case):
    cfg, pis, proof = _prove(5, "p3")
    assert verify(cfg, FibonacciAir(), proof, pis)
    bad = copy.deepcopy(proof)
    _tamper_cases(bad)[case](bad)
    assert not verify(cfg, FibonacciAir(), bad, pis)


def test_verify_rejects_wrong_public_value():
    cfg, pis, proof = _prove(4, "tpu")
    assert not verify(cfg, FibonacciAir(), proof, [0, 1, pis[2] + 1])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A4"):
        create_config(zk_rng="device")
    with pytest.raises(NotImplementedError):
        create_config(hash="poseidon2")
    with pytest.raises(NotImplementedError):
        create_config(mesh=object())
    with pytest.raises(NotImplementedError, match="device grind"):
        Challenger().grind(16)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_stark_torch\n"
        "for m in pkgutil.walk_packages(tpu_stark_torch.__path__, 'tpu_stark_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import tpu_stark_torch.prover.prove\n"
        "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')))\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
        check=True,
    )
    assert out.stdout.strip() == "[]"


def _regen():
    """Write JAX_PROOFS by running the JAX prover on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_stark.air.fibonacci import FibonacciAir as JAir
    from tpu_stark.air.fibonacci import fibonacci_value as j_fib_value
    from tpu_stark.air.fibonacci import generate_trace_rows as j_trace_rows
    from tpu_stark.prover.config import create_config as j_create_config
    from tpu_stark.prover.proof import serialize_proof as j_serialize
    from tpu_stark.prover.prove import prove as j_prove

    out = {}
    for log_n in FIXTURE_LOGS:
        n = 1 << log_n
        for layout in ("tpu", "p3"):
            cfg = j_create_config(zk=True, backend="cpu", zk_rng="smallrng", zk_layout=layout)
            pis = [0, 1, j_fib_value(0, 1, n)]
            blob = j_serialize(j_prove(cfg, JAir(), j_trace_rows(0, 1, n), pis))
            entry = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
            if log_n <= FULL_BYTES_MAX_LOG:
                entry["proof_hex"] = blob.hex()
            out[f"{layout}_{log_n}"] = entry
            print(f"n=2^{log_n} {layout}: {len(blob)} B", flush=True)
    JAX_PROOFS.write_text(json.dumps(out, indent=1, sort_keys=True))


if __name__ == "__main__":
    assert sys.argv[1:] == ["regen"], "usage: python tests/test_torch_prove.py regen"
    _regen()
