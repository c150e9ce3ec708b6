"""Batched FRI proof-of-work search (counterpart of
``tpu_stark/challenger/grind.py``).

For every candidate witness w (a canonical u32) it replicates
``Challenger.check_witness`` byte for byte:

* message = the transcript's input buffer || w as 4 little-endian bytes;
* digest  = Keccak-256(message) (original 0x01 padding, rate 136);
* draw k reads digest[28-4k : 32-4k] big-endian, masked to 31 bits, and is
  rejected if >= p; the witness passes when the first accepted draw has its
  low ``bits`` bits zero.

The message's prefix blocks are the same for every candidate, so ``_plan``
absorbs them once on the host; only the tail block(s) holding the witness
bytes are hashed per candidate.  A candidate whose 8 draws all reject
(probability ~6e-10) would need the transcript's chaining and is flagged
``needs_host``; ``device_grind`` re-checks it with ``host_check``.

``verdicts`` launches the grind kernel (``keccak_grind_kernel`` in
``csrc/keccak_sponge.cu``: a candidate a thread at a time, over K1's
Keccak-f, the witness xored into the lanes ``witness_lanes`` names) on a
CUDA device; ``verdicts_plain`` is its plain torch version over
``keccak_f_plain``, which places the witness byte by byte and which the
wrapper runs only for the CPU.  Neither has a Pallas counterpart: the JAX
package runs this search as an XLA program.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import kernels
from ..fields import babybear as bb
from ..hash.keccak import keccak_f
from ..hash.keccak_kernel import keccak_f_plain

RATE_BYTES = 136
RATE_LANES = RATE_BYTES // 8
_MASK31 = (1 << 31) - 1
PASSED, NEEDS_HOST = 1, 2  # verdict flags


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _plan(input_bytes: bytes) -> Tuple[List[int], bytes, int]:
    """(state after the constant prefix blocks as 25 u64, the padded tail
    with zero witness bytes, the witness's byte offset in the tail)."""
    total = len(input_bytes) + 4
    pad = RATE_BYTES - (total % RATE_BYTES)
    padded = bytearray(input_bytes) + bytes(4 + pad)
    padded[total] ^= 0x01
    padded[-1] ^= 0x80
    first_w_block = len(input_bytes) // RATE_BYTES
    state = [0] * 25
    for off in range(0, first_w_block * RATE_BYTES, RATE_BYTES):
        for i in range(RATE_LANES):
            state[i] ^= int.from_bytes(padded[off + 8 * i : off + 8 * i + 8], "little")
        state = keccak_f(state)
    return state, bytes(padded[first_w_block * RATE_BYTES :]), len(input_bytes) - first_w_block * RATE_BYTES


def witness_lanes(w_off: int) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """Where the witness's 4 bytes go, from their offset in the tail (the
    first lies in block 0): (block, lane, shift) of the two lanes they may
    touch, each lane xored with the 64-bit w << shift (shift >= 0) or
    w >> -shift; the second lane is -1 when w lies in one lane."""
    lane, shift = divmod(w_off, 8)
    first = (lane // RATE_LANES, lane % RATE_LANES, 8 * shift)
    if 8 * shift <= 32:
        return first, (0, -1, 0)
    return first, ((lane + 1) // RATE_LANES, (lane + 1) % RATE_LANES, 8 * shift - 64)


def _operands(prefix: List[int], tail: bytes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefix state (25,) and the tail lanes (n_blocks, 17) as int64
    tensors holding the u64 bits."""
    lanes = [int.from_bytes(tail[8 * i : 8 * i + 8], "little") for i in range(len(tail) // 8)]
    pre = torch.tensor([_signed(v) for v in prefix], dtype=torch.int64, device=device)
    tl = torch.tensor([_signed(v) for v in lanes], dtype=torch.int64, device=device)
    return pre, tl.view(-1, RATE_LANES)


def verdicts_plain(start: int, count: int, prefix: torch.Tensor, tail: torch.Tensor,
                   w_off: int, bits: int) -> torch.Tensor:
    """(count,) uint8 flags (PASSED, NEEDS_HOST) of the witnesses
    start .. start+count-1, in plain torch on the operands' device."""
    dev = prefix.device
    ws = torch.arange(start, start + count, dtype=torch.int64, device=dev)
    st = prefix.expand(count, 25).clone()
    for blk in range(int(tail.shape[0])):
        add = tail[blk].expand(count, RATE_LANES).clone()
        for i in range(4):
            p = w_off + i
            if p // RATE_BYTES == blk:
                lane, k = (p % RATE_BYTES) // 8, p % 8
                add[:, lane] ^= ((ws >> (8 * i)) & 0xFF) << (8 * k)
        st[:, :RATE_LANES] ^= add
        st = keccak_f_plain(st)
    # draw k: the big-endian u32 at digest bytes 28-4k.., i.e. the byte-swapped
    # halves of lanes 3, 2, 1, 0, high half first
    chosen = torch.zeros(count, dtype=torch.int64, device=dev)
    taken = torch.zeros(count, dtype=torch.bool, device=dev)
    for lane in (3, 2, 1, 0):
        for shift in (32, 0):
            word = (st[:, lane] >> shift) & 0xFFFFFFFF
            v = (((word & 0xFF) << 24) | ((word & 0xFF00) << 8) | ((word >> 8) & 0xFF00) | (word >> 24)) & _MASK31
            ok = v < bb.P
            chosen = torch.where(~taken & ok, v, chosen)
            taken |= ok
    passed = taken & ((chosen & ((1 << bits) - 1)) == 0)
    return passed.to(torch.uint8) * PASSED + (~taken).to(torch.uint8) * NEEDS_HOST


def _on_card(prefix: torch.Tensor) -> bool:
    """Whether ``verdicts`` given ``prefix`` launches the grind kernel (a
    CUDA tensor) or runs its plain version (the CPU)."""
    if prefix.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grind: unsupported device {prefix.device}")
    return prefix.device.type == "cuda"


def verdicts(start: int, count: int, prefix: torch.Tensor, tail: torch.Tensor,
             w_off: int, bits: int) -> torch.Tensor:
    """``verdicts_plain``'s flags: the grind kernel on a CUDA device, the
    plain version on the CPU."""
    if not _on_card(prefix):
        return verdicts_plain(start, count, prefix, tail, w_off, bits)
    if not (0 <= start and start + count <= 1 << 32 and 0 < bits < 32):
        raise ValueError("grind: witnesses are u32 and bits in 1..31")
    if not (1 <= int(tail.shape[0]) <= 2 and 0 <= w_off < RATE_BYTES):
        raise ValueError("grind: the witness starts in the first of at most two tail blocks")
    prefix, tail = prefix.contiguous(), tail.contiguous()
    out = torch.empty(count, dtype=torch.uint8, device=prefix.device)
    so = kernels.lib()
    kernels.KECCAK_GRIND.launches += 1
    kernels.check(
        so.ts_keccak_grind(
            prefix.data_ptr(), tail.data_ptr(), int(tail.shape[0]), *(v for part in witness_lanes(w_off) for v in part),
            bits, start, count, out.data_ptr(), kernels.stream_handle(prefix.device),
        ),
        "keccak grind",
    )
    return out


def device_grind(input_bytes: bytes, bits: int, chunk: int = 1 << 17,
                 host_check=None, *, device="cuda") -> Optional[int]:
    """Smallest canonical witness passing ``check_witness(bits, w)`` for a
    transcript whose input buffer is ``input_bytes``, searched in chunks on
    ``device`` (keyword-only, so that the JAX package's positional
    ``chunk`` and ``host_check`` keep their places).  ``host_check(w) ->
    bool`` decides the chaining corner; returns None only if the whole field
    is exhausted."""
    prefix, tail, w_off = _plan(input_bytes)
    pre, tl = _operands(prefix, tail, torch.device(device))
    for start in range(0, bb.P, chunk):
        flags = verdicts(start, chunk, pre, tl, w_off, bits)
        hits = torch.nonzero(flags).flatten()
        if hits.numel() == 0:
            continue
        hit_flags = flags[hits].cpu().tolist()
        for idx, f in zip(hits.cpu().tolist(), hit_flags):
            w = start + idx
            if w >= bb.P:
                return None
            if f & NEEDS_HOST:
                if host_check is not None and host_check(w):
                    return w
                continue
            return w
    return None
