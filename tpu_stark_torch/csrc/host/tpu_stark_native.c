/* tpu_stark_torch host helpers (C99, no dependencies): the port's own copy of
 * native/tpu_stark_native.c, built by tpu_stark_torch/compat/native.py.
 *
 * The device path is PyTorch plus the CUDA kernels of csrc/; these are the
 * host tails that are sequential and bit-exactness-critical:
 *
 *  - Xoshiro256++ (rand 0.9 SmallRng, 64-bit) with SplitMix64 seeding —
 *    bulk BabyBear rejection sampling for hiding salts / randomizers
 *    (the python loop is the hiding-commit bottleneck at 2^20 rows).
 *  - Keccak-f[1600] + Keccak-256 (original 0x01 padding) — the Fiat-Shamir
 *    transcript hash and per-query Merkle path verification.
 *
 * Exposed with plain C ABI for ctypes (no pybind11 in this environment).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Xoshiro256++                                                        */
/* ------------------------------------------------------------------ */
static inline uint64_t rotl64(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
}

EXPORT void ts_xoshiro_seed(uint64_t seed, uint64_t state[4]) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
        x += 0x9E3779B97F4A7C15ULL;
        uint64_t z = x;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        state[i] = z ^ (z >> 31);
    }
}

static inline uint64_t xo_next(uint64_t s[4]) {
    uint64_t result = rotl64(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl64(s[3], 45);
    return result;
}

#define BABYBEAR_P 0x78000001u

/* rand's Xoshiro256PlusPlus::next_u32 takes the HIGH word; p3's BabyBear
 * StandardUniform draws next_u32() >> 1 with rejection, value = Monty form. */
EXPORT void ts_xoshiro_fill_babybear(uint64_t state[4], uint32_t *out,
                                     size_t n) {
    for (size_t i = 0; i < n; i++) {
        for (;;) {
            uint32_t v = (uint32_t)(xo_next(state) >> 32) >> 1;
            if (v < BABYBEAR_P) {
                out[i] = v;
                break;
            }
        }
    }
}

EXPORT uint64_t ts_xoshiro_next_u64(uint64_t state[4]) { return xo_next(state); }

/* ------------------------------------------------------------------ */
/* Keccak                                                              */
/* ------------------------------------------------------------------ */
static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

EXPORT void ts_keccakf(uint64_t a[25]) {
    uint64_t b[25], c[5], d[5];
    for (int round = 0; round < 24; round++) {
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) {
                int src = x + 5 * y;
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    ROT[src] ? rotl64(a[src], ROT[src]) : a[src];
            }
        for (int i = 0; i < 25; i++) {
            int y5 = (i / 5) * 5;
            a[i] = b[i] ^ ((~b[y5 + (i + 1) % 5]) & b[y5 + (i + 2) % 5]);
        }
        a[0] ^= RC[round];
    }
}

EXPORT void ts_keccak256(const uint8_t *data, size_t len, uint8_t out[32]) {
    uint64_t state[25];
    memset(state, 0, sizeof(state));
    const size_t rate = 136;
    size_t off = 0;
    while (len - off >= rate) {
        for (size_t i = 0; i < rate / 8; i++) {
            uint64_t w;
            memcpy(&w, data + off + 8 * i, 8);
            state[i] ^= w; /* little-endian host assumed (x86/arm64) */
        }
        ts_keccakf(state);
        off += rate;
    }
    uint8_t block[136];
    memset(block, 0, sizeof(block));
    memcpy(block, data + off, len - off);
    block[len - off] ^= 0x01;
    block[rate - 1] ^= 0x80;
    for (size_t i = 0; i < rate / 8; i++) {
        uint64_t w;
        memcpy(&w, block + 8 * i, 8);
        state[i] ^= w;
    }
    ts_keccakf(state);
    memcpy(out, state, 32);
}

/* Batched u64-item padding-free sponge (rate 17, out 4) for host-side
 * Merkle verification of many openings. */
EXPORT void ts_sponge_u64(const uint64_t *items, size_t n, uint64_t out[4]) {
    uint64_t state[25];
    memset(state, 0, sizeof(state));
    size_t off = 0;
    while (off < n) {
        size_t chunk = n - off < 17 ? n - off : 17;
        for (size_t i = 0; i < chunk; i++) state[i] = items[off + i];
        ts_keccakf(state);
        off += chunk;
    }
    memcpy(out, state, 32);
}

/* ---------------------------------------------------------------------------
 * BabyBear Poseidon2 (width 16) host helpers — the Poseidon2-stack analog of
 * ts_sponge_u64: per-query Merkle path verification at 100 production
 * queries costs tens of thousands of permutations, a multi-second pure-python
 * tail.  Round constants are derived in python (hash/poseidon2.py Grain
 * LFSR) and passed in canonical u32 form, so C stays constant-free and
 * bit-identical to the python oracle by construction.
 * ------------------------------------------------------------------------- */
#define BB_P 0x78000001u

static inline uint32_t bb_add(uint32_t a, uint32_t b) {
    uint32_t s = a + b;
    return s >= BB_P ? s - BB_P : s;
}

static inline uint32_t bb_mul(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) % BB_P);
}

static inline uint32_t bb_sbox(uint32_t x) {
    uint32_t x2 = bb_mul(x, x);
    uint32_t x4 = bb_mul(x2, x2);
    return bb_mul(bb_mul(x4, x2), x);
}

/* M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] via the paper's add chain */
static void bb_m4(uint32_t *b) {
    uint32_t x0 = b[0], x1 = b[1], x2 = b[2], x3 = b[3];
    uint32_t t0 = bb_add(x0, x1);
    uint32_t t1 = bb_add(x2, x3);
    uint32_t t2 = bb_add(bb_add(x1, x1), t1);
    uint32_t t3 = bb_add(bb_add(x3, x3), t0);
    uint32_t t4 = bb_add(bb_add(bb_add(t1, t1), bb_add(t1, t1)), t3);
    uint32_t t5 = bb_add(bb_add(bb_add(t0, t0), bb_add(t0, t0)), t2);
    uint32_t t6 = bb_add(t3, t5);
    uint32_t t7 = bb_add(t2, t4);
    b[0] = t6; b[1] = t5; b[2] = t7; b[3] = t4;
}

static void bb_ext_mds16(uint32_t s[16]) {
    uint32_t sums[4];
    for (int i = 0; i < 16; i += 4) bb_m4(s + i);
    for (int j = 0; j < 4; j++) {
        uint64_t t = (uint64_t)s[j] + s[4 + j] + s[8 + j] + s[12 + j];
        sums[j] = (uint32_t)(t % BB_P);
    }
    for (int i = 0; i < 16; i += 4)
        for (int j = 0; j < 4; j++) s[i + j] = bb_add(s[i + j], sums[j]);
}

/* ext_rc: 8 rounds x 16, row-major; int_rc: n_int; diag: 16.  All canonical. */
EXPORT void ts_p2_permute16(uint32_t s[16], const uint32_t *ext_rc,
                            const uint32_t *int_rc, int n_int,
                            const uint32_t *diag) {
    bb_ext_mds16(s);
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < 16; i++)
            s[i] = bb_sbox(bb_add(s[i], ext_rc[r * 16 + i]));
        bb_ext_mds16(s);
    }
    for (int r = 0; r < n_int; r++) {
        s[0] = bb_sbox(bb_add(s[0], int_rc[r]));
        uint64_t tot = 0;
        for (int i = 0; i < 16; i++) tot += s[i];
        uint32_t t = (uint32_t)(tot % BB_P);
        for (int i = 0; i < 16; i++) s[i] = bb_add(t, bb_mul(diag[i], s[i]));
    }
    for (int r = 4; r < 8; r++) {
        for (int i = 0; i < 16; i++)
            s[i] = bb_sbox(bb_add(s[i], ext_rc[r * 16 + i]));
        bb_ext_mds16(s);
    }
}

/* PaddingFreeSponge<Poseidon2_16, 16, 8, 8>: overwrite-absorb rate-8 chunks */
EXPORT void ts_p2_hash_row(const uint32_t *vals, size_t n,
                           const uint32_t *ext_rc, const uint32_t *int_rc,
                           int n_int, const uint32_t *diag, uint32_t out[8]) {
    uint32_t st[16];
    memset(st, 0, sizeof(st));
    if (n == 0) { memcpy(out, st, 32); return; }
    for (size_t off = 0; off < n; off += 8) {
        size_t k = n - off < 8 ? n - off : 8;
        for (size_t i = 0; i < k; i++) st[i] = vals[off + i] % BB_P;
        ts_p2_permute16(st, ext_rc, int_rc, n_int, diag);
    }
    memcpy(out, st, 32);
}
