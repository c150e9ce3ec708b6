"""Keccak-f[1600] and the hashes built on it, written from the Keccak
reference: the permutation on the host (Python ints) and over the columns
of a (25, N) int64 lane tensor in plain torch; Keccak-256 (padding 0x01,
rate 136 bytes) for the transcript; the Merkle trees' padding-free sponge
(rate 17 u64 words written over the state, a permutation after every chunk,
the first 4 lanes out) over rows of canonical u32 values packed two to a
word, low word first."""

from __future__ import annotations

from typing import List, Sequence

import torch

M64 = (1 << 64) - 1
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14]  # lane x + 5 y
PI_DST = [y + 5 * ((2 * x + 3 * y) % 5) for y in range(5) for x in range(5)]  # where lane x + 5 y moves
RATE_WORDS = 17
ROW_BLOCK = 1 << 22  # rows a hash pass holds at once


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & M64 if r else v


def permute(a: Sequence[int]) -> List[int]:
    a = list(a)
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        a = [a[i] ^ c[(i - 1) % 5] ^ _rotl(c[(i + 1) % 5], 1) for i in range(25)]
        b = [0] * 25
        for i in range(25):
            b[PI_DST[i]] = _rotl(a[i], ROT[i])
        a = [b[i] ^ (~b[i - i % 5 + (i + 1) % 5] & M64 & b[i - i % 5 + (i + 2) % 5]) for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    padded = bytearray(data) + b"\x00" * (136 - len(data) % 136)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    state = [0] * 25
    for off in range(0, len(padded), 136):
        for i in range(17):
            state[i] ^= int.from_bytes(padded[off + 8 * i : off + 8 * i + 8], "little")
        state = permute(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


def sponge_host(words: Sequence[int]) -> List[int]:
    state = [0] * 25
    for off in range(0, len(words), RATE_WORDS):
        for i, v in enumerate(words[off : off + RATE_WORDS]):
            state[i] = v
        state = permute(state)
    return state[:4]


# -- plain torch over (25, N) lanes -------------------------------------------
def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _consts(device) -> dict:
    """The round's index and shift tensors on ``device``."""
    rot = torch.tensor(ROT, dtype=torch.int64, device=device)[:, None]
    src = [0] * 25
    for i, d in enumerate(PI_DST):
        src[d] = i
    row = [i - i % 5 for i in range(25)]
    return dict(
        rot=rot, back=(64 - rot) & 63, low=torch.bitwise_left_shift(torch.ones_like(rot), rot) - 1,
        src=torch.tensor(src, device=device),
        n1=torch.tensor([row[i] + (i + 1) % 5 for i in range(25)], device=device),
        n2=torch.tensor([row[i] + (i + 2) % 5 for i in range(25)], device=device),
        rc=[_signed(v) for v in RC],
    )


def _rotl_t(x: torch.Tensor, r, back, low) -> torch.Tensor:
    """Rotations left of int64 lanes by r; ``back`` = (64 - r) mod 64 and
    ``low`` = 2^r - 1 make the arithmetic right shift a logical one."""
    return (x << r) | ((x >> back) & low)


def permute_t(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over every column of a (25, N) int64 lane tensor."""
    k = _consts(a.device)
    one = torch.ones((), dtype=torch.int64, device=a.device)
    for rc in k["rc"]:
        v = a.view(5, 5, -1)
        c = v[0] ^ v[1] ^ v[2] ^ v[3] ^ v[4]  # (5, N): column parities over y
        d = c.roll(1, 0) ^ _rotl_t(c.roll(-1, 0), one, one * 63, one)
        a = (v ^ d[None]).reshape(25, -1)
        b = _rotl_t(a, k["rot"], k["back"], k["low"])[k["src"]]
        a = b ^ (~b[k["n1"]] & b[k["n2"]])
        a[0] ^= rc
    return a


def sponge_rows(words: torch.Tensor) -> torch.Tensor:
    """The sponge of every row of an (N, k) int64 tensor of u64 words (as
    signed int64 bits): (N, 4) digests, in row blocks of ``ROW_BLOCK``."""
    n, k = (int(s) for s in words.shape)
    out = torch.empty((n, 4), dtype=torch.int64, device=words.device)
    for r0 in range(0, n, ROW_BLOCK):
        blk = words[r0 : r0 + ROW_BLOCK]
        state = torch.zeros((25, int(blk.shape[0])), dtype=torch.int64, device=words.device)
        for off in range(0, k, RATE_WORDS):
            chunk = blk[:, off : off + RATE_WORDS].T
            state[: chunk.shape[0]] = chunk
            state = permute_t(state)
        out[r0 : r0 + ROW_BLOCK] = state[:4].T
    return out


def pack_rows(u32: torch.Tensor) -> torch.Tensor:
    """(N, k) canonical values (int64) as (N, ceil(k / 2)) u64 words: pairs
    low word first, an odd last value alone."""
    if u32.shape[1] % 2:
        u32 = torch.cat([u32, torch.zeros_like(u32[:, :1])], dim=1)
    return u32[:, 0::2] | (u32[:, 1::2] << 32)


def hash_rows(u32: torch.Tensor) -> torch.Tensor:
    return sponge_rows(pack_rows(u32))


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The hash of left || right (two (N, 4) digest tensors)."""
    return sponge_rows(torch.cat([left, right], dim=1))
