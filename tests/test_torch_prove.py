"""The port's prover end to end against the JAX package's proofs.

* n = 8: the golden transcripts (every challenger event, then the proof
  bytes) of ``tests/golden/fib_air_zk_n8_smallrng{,_p3}.json``;
* n = 2^10, 2^12, 2^14: proof bytes against ``tests/golden/
  torch_fib_zk_jax_proofs.json``, which the JAX prover wrote (full bytes at
  2^10, SHA-256 and length above).  The tests read the fixture and never run
  the JAX prover, whose cold CPU compiles take minutes.  Regenerate it with:
      python tests/test_torch_prove.py regen
* BASELINE config 2 (``create_config(create_benchmark_fri_params(1),
  zk=True)`` at the defaults: device zk rng, blowup 2, 100 queries, 16 PoW
  bits): proof bytes against ``tests/golden/
  torch_fib_zk_device_jax_proofs.json`` (full bytes at n = 8, SHA-256 and
  length at 2^10 and 2^12), on both NTT routes.  Regenerate it with:
      python tests/test_torch_prove.py regen config2
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
from tpu_stark_torch.compat.device_rng import DeviceRng
from tpu_stark_torch.fri.config import create_benchmark_fri_params
from tpu_stark_torch.ntt import mxu_ntt, radix2
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
CONFIG2_PROOFS = _DIR / "torch_fib_zk_device_jax_proofs.json"
CONFIG2_LOGS = (3, 10, 12)
CONFIG2_FULL_BYTES_MAX_LOG = 3


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
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout, device="cpu")
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
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout, device="cpu")
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


def _config2_blob(log_n, narrow_ntt=None):
    n = 1 << log_n
    cfg = create_config(create_benchmark_fri_params(1), zk=True, device="cpu", narrow_ntt=narrow_ntt)
    pis = [0, 1, fibonacci_value(0, 1, n)]
    return cfg, pis, serialize_proof(prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), pis))


@pytest.mark.parametrize("log_n", CONFIG2_LOGS)
def test_config2_proof_bytes_match_jax(log_n):
    want = json.loads(CONFIG2_PROOFS.read_text())[str(log_n)]
    cfg, pis, blob = _config2_blob(log_n)
    assert cfg.zk_rng == "device" and isinstance(cfg.pcs.rng, DeviceRng)
    assert cfg.pcs.fri.num_queries == 100 and cfg.pcs.fri.proof_of_work_bits == 16
    if "proof_hex" in want:
        assert blob.hex() == want["proof_hex"]
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    proof = deserialize_proof(blob)
    assert len(proof.opening_proof.query_proofs) == 100
    assert verify(cfg, FibonacciAir(), proof, pis)


def test_config2_narrow_route_gives_the_same_bytes(monkeypatch):
    """With the height gate lowered so that every narrow transform of the
    2^10 proof takes the limb-matmul NTT, the bytes are the fixture's."""
    calls = []
    real = mxu_ntt.mod_matmul_axis
    monkeypatch.setattr(mxu_ntt, "mod_matmul_axis", lambda x, w: calls.append(x.shape) or real(x, w))
    monkeypatch.setattr(radix2, "NARROW_MIN_LOG_H", 4)
    want = json.loads(CONFIG2_PROOFS.read_text())["10"]
    cfg, pis, blob = _config2_blob(10, narrow_ntt="mxu")
    assert cfg.pcs.dft.narrow == "mxu" and calls
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    assert verify(cfg, FibonacciAir(), deserialize_proof(blob), pis)


def test_create_config_defaults_equal_jax():
    """Every argument the two ``create_config``s share has the same
    default, and the default config draws from the device rng."""
    import inspect

    from tpu_stark.prover.config import StarkConfig as JStarkConfig
    from tpu_stark.prover.config import create_config as j_create_config
    from tpu_stark_torch.prover.config import StarkConfig

    mine = inspect.signature(create_config).parameters
    theirs = inspect.signature(j_create_config).parameters
    shared = set(mine) & set(theirs)
    assert {"fri_params", "zk", "rng_seed", "hash", "mesh", "zk_rng", "zk_layout"} <= shared
    for name in shared:
        assert mine[name].default == theirs[name].default, name
    for f in ("zk", "rng_seed", "zk_rng"):
        assert StarkConfig.__dataclass_fields__[f].default == JStarkConfig.__dataclass_fields__[f].default
    cfg = create_config(device="cpu")
    assert cfg.zk_rng == "device" and cfg.pcs.dft.narrow is None
    assert isinstance(cfg.pcs.rng, DeviceRng) and isinstance(cfg.pcs.val_mmcs._rng, DeviceRng)


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


def test_entry_points_default_to_the_card():
    """Without a ``device`` argument the port's entry points ask for cuda
    (only the device is inspected: nothing is allocated)."""
    import inspect

    from tpu_stark_torch.air import keccak_air, poseidon2_air
    from tpu_stark_torch.ntt.dft import Dft
    from tpu_stark_torch.prover.config import StarkConfig

    cfg = create_config()  # prove and prove_wide run on cfg.device
    assert cfg.device.type == "cuda" and cfg.pcs.dft.device.type == "cuda"
    assert create_config(hash="poseidon2", zk=False).device.type == "cuda"
    assert Dft().device.type == "cuda"
    assert StarkConfig(pcs=cfg.pcs).device.type == "cuda"
    for fn in (poseidon2_air.generate_trace, keccak_air.generate_trace):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_unported_options_raise():
    """The mesh is not ported and raises; the device rng and the 16-bit
    grind work (on the CPU, through their plain versions)."""
    with pytest.raises(NotImplementedError):
        create_config(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        create_config(hash="poseidon2", mesh=object(), device="cpu")
    for h in ("keccak", "poseidon2"):
        cfg = create_config(hash=h, zk_rng="device", device="cpu")
        salts = cfg.pcs.val_mmcs._rng.sample_babybear_matrix_monty(8, 4)
        assert salts.shape == (8, 4) and salts.device.type == "cpu" and int(salts.max()) < 0x78000001
    ch = Challenger(device="cpu")
    ch.observe_u32(12345)
    probe = ch.clone()
    w = ch.grind(16)
    assert probe.check_witness(16, w)


def test_port_never_imports_jax():
    """Importing every port module, then chip_smoke.py's import block, loads
    neither jax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_stark_torch\n"
        "for m in pkgutil.walk_packages(tpu_stark_torch.__path__, 'tpu_stark_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "chip_smoke.import_port()\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'tpu_stark')))\n"
        "print(sorted(k for k in sys.modules if k.startswith('tpu_stark_torch.')))\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
        check=True,
    )
    foreign, mine = out.stdout.strip().splitlines()
    assert foreign == "[]"
    for m in ("compat.device_rng", "challenger.grind", "ntt.mxu_ntt"):
        assert f"'tpu_stark_torch.{m}'" in mine


def _fixture_entry(blob: bytes, full: bool) -> dict:
    entry = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
    if full:
        entry["proof_hex"] = blob.hex()
    return entry


def _regen(which: str):
    """Write JAX_PROOFS (``fib``) or CONFIG2_PROOFS (``config2``) by running
    the JAX prover on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_stark.air.fibonacci import FibonacciAir as JAir
    from tpu_stark.air.fibonacci import fibonacci_value as j_fib_value
    from tpu_stark.air.fibonacci import generate_trace_rows as j_trace_rows
    from tpu_stark.fri.config import create_benchmark_fri_params as j_bench_fri
    from tpu_stark.prover.config import create_config as j_create_config
    from tpu_stark.prover.proof import serialize_proof as j_serialize
    from tpu_stark.prover.prove import prove as j_prove

    def blob_of(cfg, log_n):
        n = 1 << log_n
        return j_serialize(j_prove(cfg, JAir(), j_trace_rows(0, 1, n), [0, 1, j_fib_value(0, 1, n)]))

    out = {}
    if which == "fib":
        for log_n in FIXTURE_LOGS:
            for layout in ("tpu", "p3"):
                cfg = j_create_config(zk=True, backend="cpu", zk_rng="smallrng", zk_layout=layout)
                blob = blob_of(cfg, log_n)
                out[f"{layout}_{log_n}"] = _fixture_entry(blob, log_n <= FULL_BYTES_MAX_LOG)
                print(f"n=2^{log_n} {layout}: {len(blob)} B", flush=True)
        JAX_PROOFS.write_text(json.dumps(out, indent=1, sort_keys=True))
    else:
        for log_n in CONFIG2_LOGS:
            # BASELINE config 2 at JAX's defaults (zk_rng="device", Keccak, layout "tpu")
            blob = blob_of(j_create_config(j_bench_fri(1), zk=True, backend="cpu"), log_n)
            out[str(log_n)] = _fixture_entry(blob, log_n <= CONFIG2_FULL_BYTES_MAX_LOG)
            print(f"config 2 n=2^{log_n}: {len(blob)} B", flush=True)
        CONFIG2_PROOFS.write_text(json.dumps(out, indent=1, sort_keys=True))


if __name__ == "__main__":
    assert sys.argv[1:] in (["regen"], ["regen", "config2"]), (
        "usage: python tests/test_torch_prove.py regen [config2]")
    _regen("config2" if sys.argv[2:] else "fib")
