"""The streamed wide prove on a mesh (``prove_wide`` with
``create_config(mesh=...)``): proofs on gloo CPU ranks (one torch thread
each) byte-identical to the JAX package's fixtures and to the port's
single-device proofs, verified with the single-device verifier.

* keccak-air at 64 rows under BASELINE config 4's configuration (Poseidon2,
  zk off, benchmark FRI) at 2 and 4 ranks against
  ``tests/golden/torch_keccak_air_jax_proofs.json`` ``perms_2``;
* the zk proofs of ``torch_keccak_air_wide_zk_jax_proofs.json``: the Keccak
  stack in four 1024-column chunks at 4 ranks (two FRI queries: at least two
  ranks own none) and the Poseidon2 stack in one chunk at 2 ranks;
* the JAX package's sharded wide test (``tests/test_dist_prove.py``): the
  four-partition ``SubsetAir`` over 3 permutations in 1024-column chunks,
  against the port's single-device bytes;
* an 8-row trace at 4 ranks, below the height from which the source is
  held in rank blocks (n >= ranks^2): committed whole on every rank;
* no rank gathers a matrix of LDE height, and a ``ShardedWideSource``'s
  blocks, row reads and point values equal the single-device source's,
  each chunk's randomizer drawn n / ranks rows at a time.

The ranks run once: four gloo ranks, the 2-rank cases on the subgroup of
ranks 0 and 1.
"""

import functools
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from tpu_stark_torch.air.keccak_air import KeccakAir, generate_trace
from tpu_stark_torch.dist.dryrun import (
    DRYRUN_PARTITIONS, keccak_subset_air, prove_keccak_air, run_plan, run_ranks, wide_source_blocks,
)
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fri.config import create_benchmark_fri_params
from tpu_stark_torch.fri.domains import TwoAdicCoset
from tpu_stark_torch.ntt.dft import Dft
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
from tpu_stark_torch.prover.verify import verify
from tpu_stark_torch.prover.wide import WideMatrixSource, prove_wide

_DIR = pathlib.Path(__file__).parent / "golden"
_PLAIN = ("torch_keccak_air_jax_proofs.json", "perms_2")
_ZK = "torch_keccak_air_wide_zk_jax_proofs.json"
_ZK_KECCAK = dict(perms=2, seed=8, hash="keccak", zk=True, benchmark_fri=False, col_chunk=1024)
_ZK_P2 = dict(perms=2, seed=7, hash="poseidon2", zk=True, benchmark_fri=False, col_chunk=4096)
_SUBSET = dict(perms=3, seed=12, benchmark_fri=False, col_chunk=1024, partitions=DRYRUN_PARTITIONS)
_SHORT = dict(hash="keccak", zk=True, benchmark_fri=False, col_chunk=1024, trace="short")
SHORT_ROWS = 8  # below 4^2: the source is committed whole on every rank

# name -> (ranks, prove_keccak_air's arguments, (fixture file, key) or None for the
# port's single-device bytes)
PROOFS = {
    "perms_2_2ranks": (2, dict(perms=2), _PLAIN),
    "perms_2_4ranks": (4, dict(perms=2), _PLAIN),
    "keccak_4chunks_4ranks": (4, _ZK_KECCAK, (_ZK, "keccak_4chunks")),
    "poseidon2_1chunk_2ranks": (2, _ZK_P2, (_ZK, "poseidon2_1chunk")),
    "subset_air_4ranks": (4, _SUBSET, None),
    "short_trace_4ranks": (4, _SHORT, None),
}

# (ranks, rows, width, log_blowup, col_chunk, zk seed): ShardedWideSource
# against the single-device source
SOURCES = [(4, 16, 20, 2, 8, 3), (2, 16, 20, 1, 16, None)]
POINTS = [(5, 1, 2, 3), (7, 0, 0, 11)]


def _short_trace() -> np.ndarray:
    return generate_trace(1, seed=3, device="cpu")[:SHORT_ROWS].numpy()


def _source_trace(rows, width, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, size=(rows, width)).astype(np.uint8)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's result of every proof and source check, by name."""
    short = tmp_path_factory.mktemp("dist_wide") / "short.npy"
    np.save(short, _short_trace())
    plan, names = [], []
    for size in (4, 2):
        calls, group = [], []
        for name, (s, kw, _) in PROOFS.items():
            if s == size:
                kw = dict(kw)
                if kw.pop("trace", None):
                    kw["trace_path"] = str(short)
                calls.append((functools.partial(prove_keccak_air, **kw), ()))
                group.append(name)
        for case in SOURCES:
            if case[0] == size:
                _, rows, width, bits, chunk, zk_seed = case
                calls.append((wide_source_blocks, (_source_trace(rows, width), bits, chunk, zk_seed, POINTS)))
                group.append(case)
        plan.append((size, calls))
        names.append(group)
    per_rank = run_ranks(4, run_plan, plan, device="cpu", timeout=240)
    out = {}
    for g, (size, _) in enumerate(plan):
        for k, name in enumerate(names[g]):
            out[name] = [per_rank[r][g][k] for r in range(size)]
    return out


def _cfg(kw, device="cpu"):
    fri = create_benchmark_fri_params(1) if kw.get("benchmark_fri", True) else None
    return create_config(fri, zk=kw.get("zk", False), hash=kw.get("hash", "poseidon2"), device=device)


def _air(kw):
    return KeccakAir() if kw.get("partitions") is None else keccak_subset_air(kw["partitions"])


@pytest.mark.parametrize("name", list(PROOFS))
def test_sharded_wide_proof_bytes(ranks, name):
    """Every rank ends with the same proof; it equals the named JAX fixture
    or the port's single-device ``prove_wide`` proof, and the single-device
    verifier accepts it."""
    _size, kw, fixture = PROOFS[name]
    per_rank = ranks[name]
    blob = per_rank[0]["blob"]
    assert {(r["sha256"], r["len"]) for r in per_rank} == {(hashlib.sha256(blob).hexdigest(), len(blob))}
    air = _air(kw)
    if fixture is not None:
        want = json.loads((_DIR / fixture[0]).read_text())[fixture[1]]
        assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    else:
        torch.set_num_threads(2)
        trace = (torch.from_numpy(_short_trace()) if kw.get("trace")
                 else generate_trace(kw["perms"], seed=kw["seed"], device="cpu"))
        assert blob == serialize_proof(prove_wide(_cfg(kw), air, trace, [], col_chunk=kw["col_chunk"]))
    assert verify(_cfg(kw), air, deserialize_proof(blob), [])
    assert {r["transport"] for r in per_rank} == {"gloo"}
    assert all(r["sent"]["openings"] > 0 for r in per_rank)
    if kw.get("zk") and not kw.get("trace"):  # the rank blocks' randomizer rows travel
        assert sum(r["sent"]["randomizer"] for r in per_rank) > 0
    assert all(("quotient_sums" in r["sent"]) == (len(per_rank) > 1) for r in per_rank)


@pytest.mark.parametrize("name", list(PROOFS))
def test_no_lde_height_matrix_is_gathered_whole(ranks, name):
    """The largest all-gather a rank receives is at most the committed
    trace's height, below its LDE height, and a rank commits whole only
    matrices below n^2 rows of domain (or, under the short trace, the
    source it holds whole)."""
    size, kw, _ = PROOFS[name]
    rows = SHORT_ROWS if kw.get("trace") else 1 << (kw["perms"] * 24 - 1).bit_length()
    committed = rows << int(kw.get("zk", False))
    log_blowup = 1 if kw.get("benchmark_fri", True) else 2
    for r in ranks[name]:
        assert 0 < r["largest_gather"] <= committed < committed << log_blowup
        if kw.get("trace"):
            assert r["largest_whole_commit"] == committed << log_blowup
        else:
            assert r["largest_whole_commit"] < (size * size) << log_blowup


@pytest.mark.parametrize("case", SOURCES, ids=[f"{c[0]}ranks-zk{c[5] is not None}" for c in SOURCES])
def test_sharded_source_blocks_match_single_device(ranks, case):
    """A ``ShardedWideSource``'s LDE blocks are the single-device source's
    rows [row0, row0 + lde_h / ranks), its row reads take block-local
    indices, its point values are the single-device ones, and in zk each
    draw of a chunk's randomizer took n / ranks rows, never the whole
    (n, wc) stream."""
    size, rows, width, bits, chunk, zk_seed = case
    single = WideMatrixSource(torch.from_numpy(_source_trace(rows, width)), Dft("cpu"), bits,
                              TwoAdicCoset(rows.bit_length() - 1, 1), col_chunk=chunk, zk_seed=zk_seed)
    want_blocks = [bb.to_numpy(single.lde_br_chunk(off, wc)) for off, wc in single.chunks()]
    want_evals = [bb.to_numpy(v) for v in single.eval_at_points(POINTS)]
    per_rank = ranks[case]
    block = single.lde_h // size
    for rank, r in enumerate(per_rank):
        assert r["row0"] == rank * block
        for got, want in zip(r["blocks"], want_blocks, strict=True):
            assert np.array_equal(got, want[r["row0"] : r["row0"] + block])
        whole = np.concatenate(want_blocks, axis=1)
        assert np.array_equal(r["rows_1_0"], whole[[r["row0"] + 1, r["row0"]]])
        for got, want in zip(r["evals"], want_evals, strict=True):
            assert np.array_equal(got, want)
        assert r["rand_rows"] == (rows // size if zk_seed is not None else 0)
