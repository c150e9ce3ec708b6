"""The low-memory levers of the port (``tpu_stark_torch/commit/lowmem.py``):
lazy salts drawn row by row, dropped leaf layers rebuilt per query block,
and released codewords recomputed by their readers.  Forced on at small
heights through ``create_config(lowmem_log=)`` (and the number of dropped
layers through ``lowmem.DROP_LAYERS``), they must
change no byte: the trees and openings equal the JAX package's with its
levers forced on (``TPU_STARK_LOWMEM_LOG`` / ``TPU_STARK_LOWMEM_LAYERS``,
read at call time), and the proofs equal the JAX fixtures.  Every
comparison is exact.
"""

import collections
import hashlib
import itertools
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_stark.commit.merkle import MerkleTreeMmcs as JMmcs
from tpu_stark.compat.device_rng import DeviceRng as JDeviceRng
from tpu_stark.compat.smallrng import SmallRng as JRng
from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from tpu_stark_torch.commit import lowmem, pcs
from tpu_stark_torch.commit.merkle import MerkleTreeMmcs
from tpu_stark_torch.commit.poseidon2_mmcs import Poseidon2Mmcs
from tpu_stark_torch.compat.device_rng import DeviceRng, LazyMatrix
from tpu_stark_torch.compat.smallrng import SmallRng
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fri.config import create_benchmark_fri_params
from tpu_stark_torch.ntt import radix2
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.prover.verify import verify

GOLDEN = pathlib.Path(__file__).parent / "golden"
QUERIES = [0, 1, 17, 62, 63, 17]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The proves here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------
def test_settings_default_to_jax_and_read_no_environment(monkeypatch):
    """On the CPU the threshold is the JAX package's 2^24 rows; K is its 3;
    its environment knobs change nothing here."""
    monkeypatch.setenv("TPU_STARK_LOWMEM_LOG", "3")
    monkeypatch.setenv("TPU_STARK_LOWMEM_LAYERS", "1")
    cfg = create_config(device="cpu")
    assert (lowmem.LOWMEM_LOG, lowmem.DROP_LAYERS) == (24, 3)
    assert lowmem.default_log("cpu") == 24
    for obj in (cfg.pcs, cfg.pcs.val_mmcs, cfg.pcs.challenge_mmcs):
        assert obj.lowmem_rows == 1 << 24
    off = create_config(device="cpu", lowmem_log=0)
    assert off.pcs.lowmem_rows == off.pcs.val_mmcs.lowmem_rows == off.pcs.challenge_mmcs.lowmem_rows == 0
    assert lowmem.lowmem_rows(5) == 32 and not lowmem.engaged(0, 1 << 30)
    assert lowmem.engaged(32, 32) and not lowmem.engaged(32, 16)
    with pytest.raises(ValueError):
        create_config(device="cpu", lowmem_log=-1)


@pytest.mark.parametrize("total, log", [
    (16 << 30, 24),  # the chip the JAX package's threshold was set for
    (int(15.75 * 2**30), 24),
    (24 << 30, 25),
    (85_029_158_912, 27),  # an 80 GB card: config 2 proves up to 2^25 without the levers
    (8 << 30, 23),
])
def test_default_threshold_scales_with_card_memory(total, log):
    assert lowmem.scaled_log(total) == log


# ---------------------------------------------------------------------------
# The row gather of a lazy draw
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 4), (1000, 3), (1, 1)])
def test_lazy_rows_equal_materialize(shape):
    m = DeviceRng(7, "salts", "cpu").sample_lazy(*shape)
    full = m.materialize()
    rng = np.random.default_rng(shape[0])
    for idx in ([0], [shape[0] - 1, 0, shape[0] - 1], rng.integers(0, shape[0], 50).tolist()):
        got = m.rows(torch.tensor(idx, dtype=torch.int64))
        assert torch.equal(got, full[torch.tensor(idx)])
    assert m.rows(torch.zeros(0, dtype=torch.int64)).shape == (0, shape[1])


# ---------------------------------------------------------------------------
# The Merkle level: lazy salts and dropped layers against JAX and eager
# ---------------------------------------------------------------------------
def _matrix(h=64, w=5):
    return bb.np_to_monty(np.random.default_rng(7).integers(0, bb.P, size=(h, w), dtype=np.uint32))


def _jax_commit_open(monkeypatch, lowmem_log, layers, rng):
    monkeypatch.setenv("TPU_STARK_LOWMEM_LOG", str(lowmem_log))
    monkeypatch.setenv("TPU_STARK_LOWMEM_LAYERS", str(layers))
    mmcs = JMmcs(hiding=True, rng=rng)
    root, data = mmcs.commit([jnp.asarray(_matrix())])
    return root, data, mmcs.open_batch_many(QUERIES, data)


def _port_commit_open(monkeypatch, lowmem_log, layers, rng):
    monkeypatch.setattr(lowmem, "DROP_LAYERS", layers)
    mmcs = MerkleTreeMmcs(hiding=True, rng=rng, lowmem_log=lowmem_log)
    root, data = mmcs.commit([bb.to_tensor(_matrix(), "cpu")])
    return mmcs, root, data, mmcs.open_batch_many(QUERIES, data)


def _same_openings(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [tuple(p) for p in a.proof] == [tuple(p) for p in b.proof]
        for x, y in zip(a.opened_values, b.opened_values):
            np.testing.assert_array_equal(np.asarray(x, dtype=np.int64), np.asarray(y, dtype=np.int64))
        for x, y in zip(a.opened_salts, b.opened_salts):
            np.testing.assert_array_equal(np.asarray(x, dtype=np.int64), np.asarray(y, dtype=np.int64))


@pytest.mark.parametrize("stream", ["device", "smallrng"])
@pytest.mark.parametrize("layers", [1, 3])
def test_merkle_lowmem_matches_jax_and_eager(monkeypatch, layers, stream):
    """h = 64, w = 5 with the threshold at 2^4: the tree drops ``layers``
    leaf-most layers; the device stream's salts stay a lazy draw (the
    SmallRng tree keeps its salts: only the dropped layers apply)."""
    if stream == "device":
        port_rng, jax_rng = (lambda: DeviceRng(1, "salts", "cpu")), (lambda: JDeviceRng(1, "salts"))
    else:
        port_rng, jax_rng = (lambda: SmallRng.seed_from_u64(7)), (lambda: JRng.seed_from_u64(7))
    mmcs, root, data, openings = _port_commit_open(monkeypatch, 4, layers, port_rng())
    jroot, jdata, jopenings = _jax_commit_open(monkeypatch, 4, layers, jax_rng())
    _, eroot, edata, eopenings = _port_commit_open(monkeypatch, 0, layers, port_rng())
    assert data.dropped_layers == jdata.dropped_layers == layers and edata.dropped_layers == 0
    assert len(data.layers) == 7 - layers and len(edata.layers) == 7
    assert isinstance(data.salts[0], LazyMatrix) == (stream == "device")
    assert isinstance(edata.salts[0], torch.Tensor)
    assert tuple(root) == tuple(jroot) == tuple(eroot)
    _same_openings(openings, jopenings)
    _same_openings(openings, eopenings)
    for i, op in zip(QUERIES, openings):
        assert mmcs.verify_batch(root, [(64, 5)], i, op)


def test_lazy_salt_openings_draw_only_the_blocks(monkeypatch):
    """The openings of a lazy-salt tree never regenerate the whole draw:
    they draw the queries' blocks alone (six queries in four 8-row blocks,
    padded to a power of two: 32 rows)."""
    mmcs = MerkleTreeMmcs(hiding=True, rng=DeviceRng(1, "salts", "cpu"), lowmem_log=4)
    root, data = mmcs.commit([bb.to_tensor(_matrix(), "cpu")])
    drawn = []
    real = LazyMatrix.rows
    monkeypatch.setattr(LazyMatrix, "materialize", lambda self: pytest.fail("the whole salt draw regenerated"))
    monkeypatch.setattr(LazyMatrix, "rows", lambda self, idx: drawn.append(len(idx)) or real(self, idx))
    openings = mmcs.open_batch_many(QUERIES, data)
    assert drawn == [32]
    for i, op in zip(QUERIES, openings):
        assert mmcs.verify_batch(root, [(64, 5)], i, op)


def test_poseidon2_tree_and_streamed_commit_keep_every_layer():
    """As in the JAX package, the Poseidon2 tree's dense commit and the
    streamed commit (``commit_digests``) drop nothing at any height."""
    p2 = Poseidon2Mmcs(hiding=True, rng=DeviceRng(1, "salts", "cpu"), lowmem_log=2)
    _, data = p2.commit([bb.to_tensor(_matrix(), "cpu")])
    assert data.dropped_layers == 0 and isinstance(data.salts[0], torch.Tensor) and len(data.layers) == 7
    keccak = MerkleTreeMmcs(lowmem_log=2)
    mat = bb.to_tensor(_matrix(), "cpu")
    _, data = keccak.commit_digests(mat, keccak.leaf_layer([mat]))
    assert data.dropped_layers == 0 and len(data.layers) == 7


# ---------------------------------------------------------------------------
# Whole proofs with every lever forced on
# ---------------------------------------------------------------------------
class _Census:
    """Notes, during a prove, each Merkle commit's heights and dropped
    layers, the lazy salts kept, the codewords released, and every
    recompute of a released codeword by reader call."""

    def __init__(self, monkeypatch):
        self.trees, self.lazy_salts, self.released = [], 0, 0
        self.recomputes = collections.Counter()  # ((reader, call), matrix id) -> recomputes
        self._reader = None
        real_commit, real_pcs_commit = MerkleTreeMmcs.commit, pcs.TwoAdicFriPcs.commit
        real_codeword = pcs._LazyLde.codeword

        def commit(mmcs, matrices):
            root, data = real_commit(mmcs, matrices)
            self.trees.append(({int(m.shape[0]) for m in data.matrices}, data.dropped_layers))
            self.lazy_salts += sum(isinstance(s, LazyMatrix) for s in data.salts or [])
            return root, data

        def pcs_commit(p, items, _randomize=True):
            root, data = real_pcs_commit(p, items, _randomize)
            self.released += sum(isinstance(m, pcs._LazyLde) for m in data.merkle.matrices)
            return root, data

        def codeword(mats):
            for m in mats:
                self.recomputes[(self._reader, id(m))] += 1
            return real_codeword(mats)

        monkeypatch.setattr(MerkleTreeMmcs, "commit", commit)
        monkeypatch.setattr(pcs.TwoAdicFriPcs, "commit", pcs_commit)
        monkeypatch.setattr(pcs._LazyLde, "codeword", staticmethod(codeword))
        monkeypatch.setattr(pcs.TwoAdicFriPcs, "get_evaluations_on_domain",
                            self._reader_of(pcs.TwoAdicFriPcs.get_evaluations_on_domain, "domain"))
        monkeypatch.setattr(MerkleTreeMmcs, "open_batch_many", self._reader_of(MerkleTreeMmcs.open_batch_many, "open"))
        monkeypatch.setattr(pcs, "_group_operands", self._reader_of(pcs._group_operands, "reduced group"))

    def _reader_of(self, fn, reader):
        calls = itertools.count()

        def wrapped(*args, **kw):
            self._reader = (reader, next(calls))
            try:
                return fn(*args, **kw)
            finally:
                self._reader = None

        return wrapped

    def dropped_as_configured(self, threshold: int, layers: int) -> int:
        """Every tree dropped min(layers, its depth) layers exactly when it
        has one height at or above the threshold (rows; 0 is off); returns
        how many did."""
        for heights, dropped in self.trees:
            h = max(heights)
            want = min(layers, h.bit_length() - 1) if len(heights) == 1 and lowmem.engaged(threshold, h) else 0
            assert dropped == want, (heights, dropped)
        return sum(dropped > 0 for _h, dropped in self.trees)


def _fib_proof(cfg, log_n):
    n = 1 << log_n
    pis = [0, 1, fibonacci_value(0, 1, n)]
    return pis, prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), pis)


def _check_blob(want, cfg, pis, proof):
    blob = serialize_proof(proof)
    if "proof_hex" in want:
        assert blob.hex() == want["proof_hex"]
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    assert verify(cfg, FibonacciAir(), deserialize_proof(blob), pis)


@pytest.mark.parametrize("log_n", [3, 10])
def test_config2_lowmem_proofs_equal_jax_fixture(monkeypatch, log_n):
    """BASELINE config 2 (device rng, benchmark FRI) with the threshold at
    2^2 rows: every tree, salt and codeword takes the lazy path, each
    released codeword is recomputed at most once by each reader, and the
    proof is the JAX package's (n = 8 byte for byte, 2^10 by SHA-256)."""
    want = json.loads((GOLDEN / "torch_fib_zk_device_jax_proofs.json").read_text())[str(log_n)]
    census = _Census(monkeypatch)
    cfg = create_config(create_benchmark_fri_params(1), device="cpu", lowmem_log=2)
    pis, proof = _fib_proof(cfg, log_n)
    _check_blob(want, cfg, pis, proof)
    # the trace, quotient and random trees keep lazy salts (one, two and
    # one matrices); they and every FRI commit-phase tree of 2^2 rows or
    # more drop layers
    assert census.lazy_salts == 4 and census.released == 4
    assert census.dropped_as_configured(4, 3) == 3 + log_n + 1 - 1
    assert census.recomputes and max(census.recomputes.values()) == 1
    per_matrix = collections.Counter(mid for _reader, mid in census.recomputes)
    # the trace: the quotient domain, one group for both opening points, the
    # queries; a quotient chunk and the random codewords: one group, the
    # queries
    assert sorted(per_matrix.values()) == [2, 2, 2, 3]


def test_config2_lowmem_off_is_eager(monkeypatch):
    census = _Census(monkeypatch)
    cfg = create_config(create_benchmark_fri_params(1), device="cpu", lowmem_log=0)
    pis, proof = _fib_proof(cfg, 3)
    want = json.loads((GOLDEN / "torch_fib_zk_device_jax_proofs.json").read_text())["3"]
    _check_blob(want, cfg, pis, proof)
    assert census.dropped_as_configured(0, 3) == 0 and (census.lazy_salts, census.released) == (0, 0)
    assert not census.recomputes


def test_config2_lowmem_on_the_narrow_route(monkeypatch):
    """The recomputes take the limb-matmul route (K5) when the config asks
    for it; the bytes are the fixture's."""
    monkeypatch.setattr(radix2, "NARROW_MIN_LOG_H", 3)
    want = json.loads((GOLDEN / "torch_fib_zk_device_jax_proofs.json").read_text())["3"]
    census = _Census(monkeypatch)
    cfg = create_config(create_benchmark_fri_params(1), device="cpu", lowmem_log=2, narrow_ntt="mxu")
    pis, proof = _fib_proof(cfg, 3)
    _check_blob(want, cfg, pis, proof)
    assert census.released == 4 and census.recomputes


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_smallrng_lowmem_proofs_equal_golden(monkeypatch, layout):
    """The reference-parity SmallRng config keeps its salts (no lazy draw)
    but drops layers and releases codewords: the n = 8 golden bytes."""
    name = "fib_air_zk_n8_smallrng.json" if layout == "tpu" else "fib_air_zk_n8_smallrng_p3.json"
    fixture = json.loads((GOLDEN / name).read_text())
    monkeypatch.setattr(lowmem, "DROP_LAYERS", 2)
    census = _Census(monkeypatch)
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout, device="cpu", lowmem_log=2)
    pis, proof = _fib_proof(cfg, 3)
    assert serialize_proof(proof).hex() == fixture["proof_hex"]
    assert verify(cfg, FibonacciAir(), proof, pis)
    assert census.lazy_salts == 0 and census.released == 4 and census.dropped_as_configured(4, 2) > 0


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_poseidon2_lowmem_proofs_equal_jax(monkeypatch, layout):
    """On the Poseidon2 stack only the released codewords apply; the fib
    zk n = 8 proofs are the JAX package's bytes."""
    want = json.loads((GOLDEN / "torch_poseidon2_jax_proofs.json").read_text())[f"fib_zk_{layout}_3"]
    census = _Census(monkeypatch)
    cfg = create_config(zk=True, hash="poseidon2", zk_rng="smallrng", zk_layout=layout, device="cpu",
                        lowmem_log=2)
    pis, proof = _fib_proof(cfg, 3)
    _check_blob(want, cfg, pis, proof)
    assert census.released == 4 and census.lazy_salts == 0
    assert all(dropped == 0 for _h, dropped in census.trees)
    assert max(census.recomputes.values()) == 1


def test_prove_twin_lowmem_flags(capsys):
    """``--lowmem-log`` reaches the config, and the line reports the
    threshold the run used (the device's default without the flag).
    Forced on at 2^2 rows, the config-2 twin at n = 8 proves, verifies,
    and its proof has the fixture's length."""
    from tpu_stark_torch.bench import prove as bench_prove

    assert bench_prove.parser().parse_args(["fib"]).lowmem_log is None
    out = bench_prove.main(["fib", "3", "keccak", "zk", "0", "bench", "--device", "cpu"])
    assert out["lowmem_log"] == 24
    capsys.readouterr()
    out = bench_prove.main(["fib", "3", "keccak", "zk", "0", "bench", "--device", "cpu", "--lowmem-log", "2"])
    assert out["lowmem_log"] == 2
    want = json.loads((GOLDEN / "torch_fib_zk_device_jax_proofs.json").read_text())["3"]
    assert out["proof_bytes"] == want["len"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


# ---------------------------------------------------------------------------
# Row blocks that bound the transient memory of a 2^26-row commit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sel", [None, [2, 0]])
def test_draw_in_row_blocks_is_the_whole_draw(monkeypatch, sel):
    """A device draw runs in row blocks of at most ``_DRAW_ELEMS`` elements
    (the plain Threefry's int64 temporaries): any block size gives the
    values of one whole draw, all columns or some."""
    from tpu_stark_torch.compat import device_rng

    k = device_rng.fold_in(device_rng.key(7), 3)
    whole = device_rng._monty_at(k, device_rng._flat_index(37, 3, sel, "cpu"))
    for elems in (1, 5, 6, 1 << 24):
        monkeypatch.setattr(device_rng, "_DRAW_ELEMS", elems)
        assert torch.equal(device_rng._sample_monty(k, 37, 3, "cpu", sel), whole)


def test_leaf_layer_in_row_blocks_is_one_hash(monkeypatch):
    """The Keccak leaf layer converts its rows to canonical form in row
    blocks; any block size hashes the same rows."""
    from tpu_stark_torch.commit import merkle
    from tpu_stark_torch.hash import sponge

    mats = [bb.to_tensor(_matrix(37, w), "cpu") for w in (3, 4)]
    want = sponge.hash_field_rows_batched(bb.to_u32(torch.cat(mats, dim=1)))
    for elems in (1, 13, 14, 1 << 25):
        monkeypatch.setattr(merkle, "_CONVERT_ELEMS", elems)
        assert torch.equal(MerkleTreeMmcs.leaf_layer(mats), want)
