"""The port's streamed wide prover (``tpu_stark_torch/prover/wide.py``) and
keccak-air against the JAX package's, on the same inputs made with numpy
from a seed, and against the port's own dense path.  Exact comparison;
the kernels run their plain torch versions here.

* keccak-air: the trace generator, the partitions and their constraint
  counts; every partition runs on a view of only its declared columns;
* K4's plain version and ``P2RowStream`` over ragged column chunks equal
  the one-shot sponge and JAX's carry-state absorb;
* ``commit_wide``'s root equals the dense commit's and JAX's;
* the row-blocked quotient equals the unblocked one and the dense pass;
* the unported options raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_stark.air import keccak_air as jkeccak_air
from tpu_stark.commit import poseidon2_mmcs as jmmcs
from tpu_stark.commit.pcs import TwoAdicFriPcs as JPcs
from tpu_stark.fri.config import create_test_fri_params as j_test_fri
from tpu_stark.ntt.dft import Dft as JDft
from tpu_stark.prover import wide as jwide
from tpu_stark_torch.air import keccak_air
from tpu_stark_torch.air.air import BaseAir, get_symbolic_info
from tpu_stark_torch.commit.merkle import MerkleTreeMmcs
from tpu_stark_torch.commit.pcs import TwoAdicFriPcs
from tpu_stark_torch.commit.poseidon2_mmcs import Poseidon2Mmcs
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fri.config import create_test_fri_params
from tpu_stark_torch.hash import poseidon2_kernel
from tpu_stark_torch.ntt.dft import Dft
from tpu_stark_torch.prover import wide
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.prove import _quotient_values, get_log_quotient_degree


def _monty(seed, shape):
    return bb.np_to_monty(np.random.default_rng(seed).integers(0, bb.P, size=shape, dtype=np.uint32))


def _pcs(log_blowup=2, mmcs=Poseidon2Mmcs):
    return TwoAdicFriPcs(Dft(device="cpu"), create_test_fri_params(log_blowup), mmcs(), mmcs())


# ---------------------------------------------------------------------------
# keccak-air
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_perms", [2, 3])
def test_generate_trace_matches_jax(num_perms):
    want = jkeccak_air.generate_trace(num_perms, seed=num_perms, dtype=np.uint8)
    got = keccak_air.generate_trace(num_perms, seed=num_perms, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    as_u32 = keccak_air.generate_trace(num_perms, seed=num_perms, dtype=torch.int32, device="cpu")
    assert np.array_equal(as_u32.numpy(), jkeccak_air.generate_trace(num_perms, seed=num_perms))


def test_partitions_match_jax():
    got, want = keccak_air.KeccakAir().partitions(), jkeccak_air.KeccakAir().partitions()
    assert len(got) == len(want) == 48
    for p, q in zip(got, want):
        assert p.name == q.name
        assert np.array_equal(p.local_cols, q.local_cols) and np.array_equal(p.next_cols, q.next_cols)


def test_partition_counts_cover_all_constraints():
    air = keccak_air.KeccakAir()
    counts = wide.partition_counts(air, 0)
    assert sum(counts) == get_symbolic_info(air, 0)[0]
    assert counts == jwide.partition_counts(jkeccak_air.KeccakAir(), 0)


def test_partition_columns_are_sufficient():
    """Every partition runs on a sparse view that holds only its declared
    columns: any other column access raises."""
    n = 8
    sel = {k: bb.monty_ones((n,), "cpu") for k in ("is_first_row", "is_last_row", "is_transition")}
    for part in keccak_air.KeccakAir().partitions():
        local = bb.monty_ones((n, len(part.local_cols)), "cpu")
        nxt = bb.monty_ones((n, len(part.next_cols)), "cpu")
        b = wide._PartitionBuilder(local, nxt, part.local_cols, part.next_cols, sel, [])
        part.eval(b)
        assert b.constraint_count > 0
    part = keccak_air.KeccakAir().partitions()[-1]  # trans24
    short = part.local_cols[:-1]
    b = wide._PartitionBuilder(
        bb.monty_ones((n, len(short)), "cpu"), bb.monty_ones((n, len(part.next_cols)), "cpu"),
        short, part.next_cols, sel, [],
    )
    with pytest.raises(KeyError):
        part.eval(b)


# ---------------------------------------------------------------------------
# the carry-state absorb (K4's plain version) and P2RowStream
# ---------------------------------------------------------------------------
CHUNKINGS = [((0, 5), (5, 18), (23, 22)), ((0, 16), (16, 32), (48, 4))]


def test_absorb_rows_plain_matches_one_shot_and_jax():
    mat = _monty(7, (32, 52))
    t = bb.to_tensor(mat, "cpu")
    state = torch.full((32, 16), 12345, dtype=torch.int32)  # overwritten: first
    jstate = jnp.zeros((32, 16), dtype=jnp.uint32)
    for i, (off, wc) in enumerate(CHUNKINGS[1]):
        out = poseidon2_kernel.absorb_rows(state, t[:, off : off + wc], first=(i == 0))
        assert out is state  # updated in place
        jstate = jwide._absorb_chunk(jstate, jnp.asarray(mat[:, off : off + wc]))
    assert torch.equal(state[:, :8], poseidon2_kernel.hash_rows_plain(t))
    assert np.array_equal(bb.to_numpy(state), np.asarray(jstate))


def test_absorb_rows_continues_a_carried_state():
    mat = _monty(8, (16, 24))
    t = bb.to_tensor(mat, "cpu")
    state = bb.to_tensor(_monty(9, (16, 16)), "cpu")
    want = poseidon2_kernel.absorb_rows_plain(state.clone(), t)
    poseidon2_kernel.absorb_rows(state, t[:, :8])
    poseidon2_kernel.absorb_rows(state, t[:, 8:])
    assert torch.equal(state, want)
    with pytest.raises(ValueError):
        poseidon2_kernel.absorb_rows(state, t[:3])


@pytest.mark.parametrize("chunking", CHUNKINGS)
def test_p2_row_stream_matches_one_shot_and_jax(chunking):
    """Rate blocks straddling chunk boundaries ride the pending columns;
    only the row's final block is partial."""
    k = sum(wc for _, wc in chunking)
    mat = _monty(10 + k, (16, k))
    t = bb.to_tensor(mat, "cpu")
    stream = wide.P2RowStream(16, "cpu")
    jstream = jwide.P2RowStream(16)
    for off, wc in chunking:
        stream.absorb_cols(t[:, off : off + wc])
        jstream.absorb_cols(jnp.asarray(mat[:, off : off + wc]))
    got = stream.finalize()
    assert torch.equal(got, poseidon2_kernel.hash_rows_plain(t))
    assert np.array_equal(bb.to_numpy(got), np.asarray(jstream.finalize()))
    # absorbing the same ragged chunks straight, without the carry, is wrong
    state = torch.empty((16, 16), dtype=torch.int32)
    for i, (off, wc) in enumerate(chunking):
        poseidon2_kernel.absorb_rows(state, t[:, off : off + wc], first=(i == 0))
    assert torch.equal(state[:, :8], got) == all(wc % 8 == 0 for _, wc in chunking[:-1])


# ---------------------------------------------------------------------------
# the streamed commit
# ---------------------------------------------------------------------------
def test_streamed_commit_root_matches_dense_and_jax():
    trace = np.random.default_rng(3).integers(0, 2, size=(64, 40), dtype=np.uint32)
    pcs = _pcs()
    domain = pcs.natural_domain_for_degree(64)
    dense_root, dense = pcs.commit([(domain, bb.to_tensor(bb.np_to_monty(trace), "cpu"))])
    src = wide.WideMatrixSource(torch.from_numpy(trace.astype(np.uint8)), pcs.dft, 2, domain, col_chunk=16)
    assert list(src.chunks()) == [(0, 16), (16, 16), (32, 8)]
    root, data = wide.commit_wide(pcs, domain, src)
    assert tuple(root) == tuple(dense_root)
    jpcs = JPcs(JDft(backend="cpu"), j_test_fri(2), jmmcs.Poseidon2Mmcs(), jmmcs.Poseidon2Mmcs())
    jdomain = jpcs.natural_domain_for_degree(64)
    jsrc = jwide.WideMatrixSource(trace.astype(np.uint8), jpcs.dft, 2, jdomain, col_chunk=16)
    jroot, _ = jwide.commit_wide(jpcs, jdomain, jsrc)
    assert tuple(int(v) for v in jroot) == tuple(root)
    # the streamed matrix's rows, coefficients and openings are the dense ones
    rows = torch.tensor([0, 5, 255])
    assert torch.equal(src[rows], dense.merkle.matrices[0][rows])
    assert torch.equal(torch.cat([src.coeff_chunk(o, w) for o, w in src.chunks()], dim=1), dense.r_coeffs[0])
    for a, b in zip(pcs.val_mmcs.open_batch_many([3, 200], data.merkle),
                    pcs.val_mmcs.open_batch_many([3, 200], dense.merkle)):
        assert all(np.array_equal(x, y) for x, y in zip(a.opened_values, b.opened_values))
        assert a.proof == b.proof


def test_streamed_commit_unported_stacks_raise():
    trace = torch.zeros((16, 8), dtype=torch.uint8)
    for pcs in (_pcs(mmcs=MerkleTreeMmcs), TwoAdicFriPcs(
            Dft(device="cpu"), create_test_fri_params(2), Poseidon2Mmcs(hiding=True), Poseidon2Mmcs())):
        domain = pcs.natural_domain_for_degree(16)
        src = wide.WideMatrixSource(trace, pcs.dft, 2, domain)
        with pytest.raises(NotImplementedError):
            wide.commit_wide(pcs, domain, src)


def test_wide_zk_raises():
    pcs = _pcs()
    domain = pcs.natural_domain_for_degree(16)
    with pytest.raises(NotImplementedError, match="item 9"):
        wide.WideMatrixSource(torch.zeros((16, 8), dtype=torch.uint8), pcs.dft, 2, domain, zk_seed=1)
    cfg = create_config(zk=True, hash="poseidon2", device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        wide.prove_wide(cfg, keccak_air.KeccakAir(), torch.zeros((64, keccak_air.COLS), dtype=torch.uint8), [])
    with pytest.raises(ValueError):
        wide.WideMatrixSource(torch.zeros((16, 8), dtype=torch.uint8), pcs.dft, 2, domain, col_chunk=12)


# ---------------------------------------------------------------------------
# the partitioned, row-blocked quotient
# ---------------------------------------------------------------------------
class _SubsetAir(BaseAir):
    """One partition of each shape: next rows equal to local (flags), no
    next rows (theta0, apdef0), next rows disjoint from local (trans1)."""

    width = keccak_air.COLS
    KEEP = ("flags", "theta0", "apdef0", "trans1")

    def partitions(self):
        return [p for p in keccak_air.KeccakAir().partitions() if p.name in self.KEEP]

    def eval(self, b):
        for p in self.partitions():
            p.eval(b)


def test_block_count():
    assert wide.block_count(1 << 20, 768, False, wide.PANEL_BUDGET, wide.MIN_BLOCK_LOG) == 4
    assert wide.block_count(1 << 20, 257, True, wide.PANEL_BUDGET, wide.MIN_BLOCK_LOG) == 4
    assert wide.block_count(1 << 20, 24, True, wide.PANEL_BUDGET, wide.MIN_BLOCK_LOG) == 1
    assert wide.block_count(128, 100, True, 0, 3) == 16
    assert wide.block_count(1 << 20, 100, True, 0, 3) == 32


def test_row_blocked_quotient_matches_unblocked_and_dense():
    air = _SubsetAir()
    trace = keccak_air.generate_trace(3, seed=12, device="cpu")  # 128 rows
    n = int(trace.shape[0])
    pcs = _pcs(log_blowup=1)
    domain = pcs.natural_domain_for_degree(n)
    src = wide.WideMatrixSource(trace, pcs.dft, 1, domain)
    log_qd = get_log_quotient_degree(air, 0, False)
    num_constraints = get_symbolic_info(air, 0)[0]
    apows = bb.to_tensor(_monty(2, (num_constraints, 4)), "cpu")

    def run(budget, min_log):
        return wide.quotient_chunks_streamed(air, src, domain, log_qd, apows, [], budget, min_log)[1]

    base = run(wide.PANEL_BUDGET, wide.MIN_BLOCK_LOG)
    blocked = run(0, 3)  # 16 blocks of 8 rows, next rows across every block edge
    for a, b in zip(base, blocked):
        assert torch.equal(a, b)
    trace_on_q = bb.from_u32(trace.to(torch.int64))
    coeffs = pcs.dft.idft_batch(trace_on_q)
    q_dom = domain.create_disjoint_domain(n << log_qd)
    on_q = pcs.dft.coset_dft_batch(
        torch.cat([coeffs, torch.zeros(((n << log_qd) - n, air.width), dtype=torch.int32)]), q_dom.shift)
    dense = _quotient_values(air, on_q, torch.zeros(0, dtype=torch.int32), apows, domain.log_n, q_dom.log_n)
    for j, chunk in enumerate(base):
        assert torch.equal(chunk, dense[j :: 1 << log_qd])
