"""The port's column-sharded commit, row-sharded quotient, multi-host mesh
and the sharded prover's rejections (``tpu_stark_torch/dist/``).

The commit and quotient follow ``tests/test_dist.py``: the column-sharded
commit's root equals ``MerkleTreeMmcs().commit`` of the single-device LDE
and its row blocks are that LDE's; a ``ShardedPcs.commit`` of several
heights equals the single-device commit; the sharded quotient equals the port's
single-device ``_quotient_values`` (which ``tests/test_torch_wide.py`` and
the proof fixtures hold exact against JAX).  The ranks run once: four gloo
ranks on the CPU, one torch thread each, the 2-rank cases on the subgroup
of ranks 0 and 1.  ``dcn_crossing_stages`` is compared with JAX's.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_stark.dist.multihost import dcn_crossing_stages as j_dcn_crossing_stages
from tpu_stark_torch.air.keccak_air import KeccakAir
from tpu_stark_torch.commit.merkle import MerkleTreeMmcs
from tpu_stark_torch.dist import multihost
from tpu_stark_torch.dist.comm import RowMesh
from tpu_stark_torch.dist.dryrun import column_commit, fib_quotient, multi_height_commit, pod_order, run_plan, run_ranks
from tpu_stark_torch.dist.merkle import ShardedMmcs
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fri.domains import TwoAdicCoset
from tpu_stark_torch.matrix import reverse_matrix_index_bits
from tpu_stark_torch.ntt import radix2
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.wide import prove_wide


def _trace(h, w, seed):
    return bb.np_to_monty(np.random.default_rng(seed).integers(0, bb.P, size=(h, w)).astype(np.uint32))


# (ranks, height, width, log_blowup, seed): tests/test_dist.py's shapes
COMMITS = [(4, 64, 16, 2, 0), (4, 32, 8, 1, 1), (2, 64, 16, 2, 0)]
QUOTIENT_LOG_N = 6
HOSTS = {"interleaved": ["a", "b", "a", "b"], "host-major": ["a", "a", "b", "b"]}


# a multi-height commit: heights 2^4, 2^5, 2^4 (the second 2^4 matrix handed
# over as rank blocks), opened at these LDE rows
MULTI_SHAPES = ((16, 3, False), (32, 2, False), (16, 1, True))
MULTI_QUERIES = [0, 5, 127, 64, 33, 96]


def _multi_evals():
    return [_trace(h, w, 10 + h + w) for h, w, _blk in MULTI_SHAPES]


def _multi_layout(hiding):
    return "p3" if hiding else "tpu"


def _multi_calls():
    blocks = [blk for _h, _w, blk in MULTI_SHAPES]
    return [(multi_height_commit, (_multi_evals(), blocks, MULTI_QUERIES, hiding, _multi_layout(hiding)))
            for hiding in (False, True)]


# where each group's multi-height calls start (after the other calls)
_MULTI_AT = {4: sum(1 for c in COMMITS if c[0] == 4) + 1 + len(HOSTS), 2: sum(1 for c in COMMITS if c[0] == 2) + 1}


@pytest.fixture(scope="module")
def results():
    plan = []
    for size in (4, 2):
        calls = [(column_commit, (_trace(h, w, seed), bits)) for s, h, w, bits, seed in COMMITS if s == size]
        calls.append((fib_quotient, (QUOTIENT_LOG_N,)))
        if size == 4:
            calls += [(pod_order, (hosts,)) for hosts in HOSTS.values()]
        calls += _multi_calls()
        plan.append((size, calls))
    per_rank = run_ranks(4, run_plan, plan, device="cpu")
    return {size: [per_rank[r][g] for r in range(size)] for g, (size, _) in enumerate(plan)}


@pytest.mark.parametrize("case", COMMITS, ids=[f"{c[0]}ranks-{c[1]}x{c[2]}-b{c[3]}" for c in COMMITS])
def test_column_sharded_commit_matches_single_device(results, case):
    size, h, w, bits, seed = case
    k = [c for c in COMMITS if c[0] == size].index(case)
    per_rank = [r[k] for r in results[size]]
    lde_br = reverse_matrix_index_bits(radix2.coset_lde_batch(bb.to_tensor(_trace(h, w, seed), "cpu"), bits,
                                                              bb.GENERATOR))
    want_root, _ = MerkleTreeMmcs(lowmem_log=0).commit([lde_br])
    assert all(root == tuple(want_root) for root, _rows, _step in per_rank)
    np.testing.assert_array_equal(np.concatenate([rows for _root, rows, _step in per_rank]), bb.to_numpy(lde_br))
    # sharded_prove_step: the same root and the sum mod p of every LDE element
    want_sum = int(bb.to_numpy(bb.to_u32(lde_br)).astype(np.int64).sum() % bb.P)
    assert all(step == (tuple(want_root), want_sum) for _root, _rows, step in per_rank)


@pytest.mark.parametrize("size", [2, 4])
def test_sharded_quotient_matches_single_device(results, size):
    k = sum(1 for c in COMMITS if c[0] == size)
    got = [r[k][0] for r in results[size]]
    want = results[size][0][k][1]
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_make_pod_mesh_rejects_a_rank_order_that_is_not_host_major(results):
    k = sum(1 for c in COMMITS if c[0] == 4) + 1
    for r in results[4]:
        bad, good = r[k], r[k + 1]
        assert "not host-major" in bad
        assert good == "host-major"
    with pytest.raises(ValueError, match="not host-major"):
        multihost.check_host_major(["h0", "h1", "h0"])
    multihost.check_host_major(["h0", "h0", "h1", "h1", "h2"])


@pytest.mark.parametrize("log_h,n_hosts,per_host", [(12, 2, 4), (12, 4, 2), (12, 1, 8)])
def test_dcn_crossing_stages_equal_jax(log_h, n_hosts, per_host):
    assert multihost.dcn_crossing_stages(log_h, n_hosts, per_host) == j_dcn_crossing_stages(log_h, n_hosts, per_host)


def _mesh(size=1, rank=0):
    """A mesh object for the checks that raise before any collective."""
    return RowMesh(None, rank, size, torch.device("cpu"), "gloo")


def test_multi_height_commit_on_a_mesh_raises():
    """A commit's blocks must be the rank's blocks of their heights (checked
    before any collective)."""
    mmcs = ShardedMmcs(MerkleTreeMmcs(lowmem_log=0), _mesh(2))
    with pytest.raises(ValueError, match="rank's block"):
        mmcs.commit_blocks([torch.zeros((4, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32)], [8, 8])
    with pytest.raises(ValueError, match="rank's block"):
        mmcs.commit_blocks([torch.zeros((1, 2), dtype=torch.int32)], [1])
    with pytest.raises(ValueError, match="blocks for"):
        mmcs.commit_blocks([torch.zeros((4, 2), dtype=torch.int32)], [8, 4])


@pytest.mark.parametrize("hiding", [False, True], ids=["plain", "hiding"])
@pytest.mark.parametrize("size", [2, 4])
def test_multi_height_commit_on_a_mesh_matches_single_device(results, size, hiding):
    """``ShardedPcs.commit`` of several heights (JAX's ``tpu_stark/dist/
    pcs.py`` accepts them) equals the single-device commit: the root, every
    rank's blocks of the LDEs and coefficients, the domains and widths, and
    the openings.  Hiding: salts and the p3 layout's random columns."""
    got = [r[_MULTI_AT[size] + int(hiding)] for r in results[size]]
    items = [(TwoAdicCoset(int(e.shape[0]).bit_length() - 1), bb.to_tensor(e, "cpu")) for e in _multi_evals()]
    pcs = create_config(zk=hiding, zk_layout=_multi_layout(hiding), device="cpu").pcs
    root, data = pcs.commit(items)
    want = pcs.val_mmcs.open_batch_many(MULTI_QUERIES, data.merkle)
    for r in got:
        assert r["root"] == tuple(root)
        assert r["domains"] == [(d.log_n, d.shift) for d in data.domains] and r["widths"] == data.widths
        for (vals, salts, proof), op in zip(r["openings"], want):
            assert proof == op.proof
            assert all(np.array_equal(a, b) for a, b in zip(vals, op.opened_values))
            assert (salts is None) == (op.opened_salts is None)
            assert salts is None or all(np.array_equal(a, b) for a, b in zip(salts, op.opened_salts))
    for k in range(len(items)):
        np.testing.assert_array_equal(np.concatenate([r["ldes"][k] for r in got]), bb.to_numpy(data.merkle.matrices[k]))
        np.testing.assert_array_equal(np.concatenate([r["r_coeffs"][k] for r in got]), bb.to_numpy(data.r_coeffs[k]))


def test_prove_wide_on_a_mesh_raises():
    """The one restriction of the streamed wide prove on a mesh is the
    single-device one: a hiding streamed commit needs zk_layout='tpu'."""
    cfg = create_config(zk=True, zk_layout="p3", mesh=_mesh(), device="cpu")
    with pytest.raises(ValueError, match="zk_layout='tpu'"):
        prove_wide(cfg, KeccakAir(), torch.zeros((64, KeccakAir.width), dtype=torch.uint8), [])


@pytest.mark.parametrize("hash", ["keccak", "poseidon2"])
def test_mesh_config_refuses_lowmem_and_another_device(hash):
    make = functools.partial(create_config, hash=hash, mesh=_mesh())
    with pytest.raises(ValueError, match="low-memory"):
        make(device="cpu", lowmem_log=24)
    with pytest.raises(ValueError, match="cannot run on a mesh"):
        make(device="cuda")
    cfg = make(device="cpu", lowmem_log=0)
    assert cfg.pcs.mesh is not None and cfg.pcs.lowmem_rows == 0
    assert cfg.pcs.val_mmcs.inner.lowmem_rows == 0 and cfg.pcs.challenge_mmcs.inner.lowmem_rows == 0
    assert cfg.pcs.val_mmcs.hiding and cfg.device == torch.device("cpu")
