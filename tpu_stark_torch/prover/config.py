"""StarkConfig — the type-stack assembly point (counterpart of
``tpu_stark/prover/config.py``): hash stack + MMCS + FRI params + DFT
device + challenger, with the zk (hiding) switch: salted Merkle leaves,
4 random FRI codewords and a randomized trace.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..challenger.challenger import Challenger
from ..commit.merkle import MerkleTreeMmcs
from ..commit.pcs import TwoAdicFriPcs
from ..compat.smallrng import SmallRng
from ..fri.config import FriParameters, create_test_fri_params
from ..ntt.dft import Dft


@dataclasses.dataclass
class StarkConfig:
    pcs: TwoAdicFriPcs
    zk: bool = False
    rng_seed: int = 1  # trace-randomizer stream (zk)
    challenger_factory: type = Challenger
    zk_rng: str = "smallrng"
    device: torch.device = torch.device("cpu")

    def challenger(self):
        return self.challenger_factory()


def make_zk_rng(mode: str, seed: int):
    """``"smallrng"``: the reference-parity host Xoshiro256++ stream."""
    if mode == "smallrng":
        return SmallRng.seed_from_u64(seed)
    if mode == "device":
        raise NotImplementedError(
            "zk_rng='device' (the JAX package's counter-based Threefry stream, "
            "ROADMAP A4) is not ported yet; use zk_rng='smallrng'"
        )
    raise ValueError(f"unknown zk_rng mode {mode!r}")


def create_config(
    fri_params: Optional[FriParameters] = None,
    zk: bool = True,
    rng_seed: int = 1,
    hash: str = "keccak",
    mesh=None,
    zk_rng: str = "smallrng",
    zk_layout: str = "tpu",
    device="cpu",
) -> StarkConfig:
    """Assemble a full config on ``device``.

    ``hash="keccak"`` is the reference's zk stack.  ``zk_layout``: ``"tpu"``
    or ``"p3"`` (random columns appended to every hiding commit).  The
    Poseidon2 stack, the sharded ``mesh`` path and the device zk rng are not
    ported yet and raise."""
    if hash == "poseidon2":
        raise NotImplementedError("hash='poseidon2' (ROADMAP A9) is not ported yet")
    if hash != "keccak":
        raise ValueError(f"unknown hash stack {hash!r}")
    if mesh is not None:
        raise NotImplementedError("the sharded mesh prover (ROADMAP A11) is not ported yet")
    device = torch.device(device)
    fri = fri_params if fri_params is not None else create_test_fri_params(2)
    dft = Dft(device)
    if zk:
        # the salt stream and the codeword stream are independently seeded
        # rngs, as in the reference
        pcs = TwoAdicFriPcs(
            dft,
            fri,
            val_mmcs=MerkleTreeMmcs(hiding=True, rng=make_zk_rng(zk_rng, rng_seed)),
            challenge_mmcs=MerkleTreeMmcs(),
            num_random_codewords=4,
            rng=make_zk_rng(zk_rng, rng_seed),
            zk_layout=zk_layout,
        )
    else:
        pcs = TwoAdicFriPcs(dft, fri, val_mmcs=MerkleTreeMmcs(), challenge_mmcs=MerkleTreeMmcs())
    return StarkConfig(pcs=pcs, zk=zk, rng_seed=rng_seed, zk_rng=zk_rng, device=device)
