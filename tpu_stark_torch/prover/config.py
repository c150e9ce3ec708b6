"""StarkConfig — the type-stack assembly point (counterpart of
``tpu_stark/prover/config.py``): hash stack + MMCS + FRI params + DFT
device + challenger, with the zk (hiding) switch: salted Merkle leaves,
4 random FRI codewords and a randomized trace.  Two hash stacks: Keccak
(the reference's) and Poseidon2 (field-native).  The defaults equal the JAX
package's ``create_config()``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..challenger.challenger import Challenger
from ..commit import lowmem
from ..commit.merkle import MerkleTreeMmcs
from ..commit.poseidon2_mmcs import DuplexChallenger, Poseidon2Mmcs
from ..commit.pcs import TwoAdicFriPcs
from ..compat.device_rng import DeviceRng
from ..compat.smallrng import SmallRng
from ..dist.pcs import ShardedPcs
from ..fri.config import FriParameters, create_test_fri_params
from ..ntt.dft import Dft


@dataclasses.dataclass
class StarkConfig:
    pcs: TwoAdicFriPcs
    zk: bool = False
    rng_seed: int = 1  # trace-randomizer stream (zk)
    challenger_factory: type = Challenger
    zk_rng: str = "device"  # hiding-randomness generator (see make_zk_rng)
    device: torch.device = torch.device("cuda")

    def challenger(self):
        """A fresh Fiat-Shamir transcript; its proof-of-work search runs on
        the config's device."""
        return self.challenger_factory(device=self.device)


def make_zk_rng(mode: str, seed: int, stream: str = "", device="cuda"):
    """``"device"``: the counter-based Threefry stream on ``device``, one
    stream per tag (``"salts"``, ``"codewords"``, ``"trace"``);
    ``"smallrng"``: the reference-parity host Xoshiro256++ stream, which
    ignores the tag (the reference seeds its rngs identically)."""
    if mode == "device":
        return DeviceRng(seed, stream, device)
    if mode == "smallrng":
        return SmallRng.seed_from_u64(seed)
    raise ValueError(f"unknown zk_rng mode {mode!r}")


def create_config(
    fri_params: Optional[FriParameters] = None,
    zk: bool = True,
    *,
    rng_seed: int = 1,
    hash: str = "keccak",
    mesh=None,
    zk_rng: str = "device",
    zk_layout: str = "tpu",
    device="cuda",
    narrow_ntt=None,
    lowmem_log: Optional[int] = None,
) -> StarkConfig:
    """Assemble a full config on ``device`` (the card unless the caller
    passes another device, as the CPU tests do).

    ``hash="keccak"`` is the reference's zk stack: Keccak Merkle trees and
    the byte-level Fiat-Shamir challenger.  ``hash="poseidon2"`` is the
    field-native stack: Poseidon2 Merkle trees and the duplex challenger.
    ``zk_layout``: ``"tpu"`` or ``"p3"`` (random columns appended to every
    hiding commit).  ``zk_rng``: ``"device"`` (the counter-based stream on
    the device, as in the JAX package) or ``"smallrng"`` (the reference's
    host stream).  ``narrow_ntt``: ``None`` (every NTT on K2) or ``"mxu"``
    (tall narrow NTTs on the limb-matmul route, K5; the same proof bytes).
    ``lowmem_log``: the low-memory levers (``commit/lowmem.py``) engage at
    committed heights of 2^lowmem_log rows and above; ``0`` switches them
    off; ``None`` takes ``lowmem.default_log(device)``, the JAX package's
    2^24 scaled by the card's memory (2^24 on the CPU).  The bytes are the
    same either way.
    ``mesh``: a ``dist.comm.RowMesh`` (``make_row_mesh()``): the sharded
    prover (``dist/pcs.py``), whose proofs are the single-device bytes; the
    config runs on the mesh's device (another ``device`` raises), the
    low-memory levers stay off (an explicit ``lowmem_log`` other than 0
    raises), and ``narrow_ntt`` applies to the transforms that every rank
    runs whole (the trace, its randomizer, the final polynomial).

    Every parameter after ``zk`` is keyword-only: the JAX package's third
    positional parameter is ``backend``, which the port does not have, so a
    positional call written for it raises instead of binding another
    parameter."""
    if hash == "keccak":
        mmcs_cls, challenger_factory = MerkleTreeMmcs, Challenger
    elif hash == "poseidon2":
        mmcs_cls, challenger_factory = Poseidon2Mmcs, DuplexChallenger
    else:
        raise ValueError(f"unknown hash stack {hash!r}")
    device = torch.device(device)
    fri = fri_params if fri_params is not None else create_test_fri_params(2)
    if mesh is not None:
        if device.type != mesh.device.type or (device.index is not None and device != mesh.device):
            raise ValueError(f"a config on {device} cannot run on a mesh on {mesh.device}")
        if lowmem_log:
            raise ValueError("the low-memory levers do not engage on a mesh (lowmem_log must be None or 0)")
        device, lowmem_log = mesh.device, 0
        pcs_cls = functools.partial(ShardedPcs, mesh)
    else:
        pcs_cls = TwoAdicFriPcs
    dft = Dft(device, narrow=narrow_ntt)
    if lowmem_log is None:
        lowmem_log = lowmem.default_log(device)
    if zk:
        # the salt stream and the codeword stream are independently seeded
        # rngs, as in the reference; the device stream also separates them
        # by tag
        pcs = pcs_cls(
            dft,
            fri,
            val_mmcs=mmcs_cls(hiding=True, rng=make_zk_rng(zk_rng, rng_seed, "salts", device), lowmem_log=lowmem_log),
            challenge_mmcs=mmcs_cls(lowmem_log=lowmem_log),
            num_random_codewords=4,
            rng=make_zk_rng(zk_rng, rng_seed, "codewords", device),
            zk_layout=zk_layout,
            lowmem_log=lowmem_log,
        )
    else:
        pcs = pcs_cls(dft, fri, val_mmcs=mmcs_cls(lowmem_log=lowmem_log),
                      challenge_mmcs=mmcs_cls(lowmem_log=lowmem_log), lowmem_log=lowmem_log)
    return StarkConfig(
        pcs=pcs, zk=zk, rng_seed=rng_seed, challenger_factory=challenger_factory,
        zk_rng=zk_rng, device=device,
    )
