"""Grain's index shuffle, in Python — the permutation behind the JAX
package's ``--loader grain`` (``grain.IndexSampler(shuffle=True)``).

Grain's sampler reads, at position ``i`` of an epoch of ``n`` records, the
record ``index_shuffle(i, max_index=n - 1, seed=seed, rounds=4)`` of its
compiled ``index_shuffle`` module (C++, ``grain::random::index_shuffle``).
That function is a Simon block cipher with cycle walking:

- the block is the smallest even number of bits ≥ ``ceil(log2(max_index))``
  (``log2`` of the index as a double), and at least 16; each half is a word
  of half the block;
- the round keys are ``rounds`` words of ``std::seed_seq{seed}.generate``
  (the C++ standard's algorithm, ``seed_seq_generate`` here), two consumed a
  round pair;
- a round updates the upper word ``x ^= (rotl(y, 1) & rotl(y, 8)) ^
  rotl(y, 2) ^ key``, then the lower word the same way from the new ``x``;
- the index is encrypted again while it exceeds ``max_index``.

Grain's pure-Python ``index_shuffle_python.py`` computes another
permutation, which no sampler uses. The block width has one quirk that this
module keeps: where ``max_index`` is an even power of two of at least 2¹⁶
(n = 65,537, 2²⁰ + 1, …), ``max_index`` needs one bit more than the block
holds, so the last position's index loses its top bit and reads the record
of position 0, and one record is never read.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np

MIN_BLOCK_BITS = 16
_M32 = 0xFFFFFFFF


def seed_seq_generate(seeds, n: int) -> Tuple[int, ...]:
    """``std::seed_seq(seeds).generate`` into ``n`` 32-bit words
    ([rand.util.seedseq] of the C++ standard)."""
    out = [0x8B8B8B8B] * n
    if n == 0:
        return ()
    s = len(seeds)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & _M32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + seeds[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _M32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _M32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _M32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return tuple(out)


@lru_cache(maxsize=64)
def round_keys(seed: int, rounds: int) -> Tuple[int, ...]:
    return seed_seq_generate([seed], rounds)


def block_bits(max_index: int) -> int:
    """The cipher's block width for indices in ``[0, max_index]``."""
    bits = math.ceil(math.log2(float(max_index)))
    return max(bits + bits % 2, MIN_BLOCK_BITS)


def _check(index: int, max_index: int, seed: int, rounds: int) -> None:
    """Grain's binding takes unsigned 64-bit indices and unsigned 32-bit
    seed and rounds, and refuses anything else with a ``TypeError``; its
    C++ asserts an even number of at least 4 rounds."""
    for name, v, bits in (("index", index, 64), ("max_index", max_index, 64),
                          ("seed", seed, 32), ("rounds", rounds, 32)):
        if not isinstance(v, (int, np.integer)) or isinstance(v, bool) or not 0 <= v < 1 << bits:
            raise TypeError(f"index_shuffle(): {name}={v!r} is not an unsigned {bits}-bit "
                            "integer")
    if rounds < 4 or rounds % 2:
        raise ValueError(f"index_shuffle(): rounds={rounds} must be even and at least 4")


def _encrypt(x, keys: Tuple[int, ...], half: int):
    """Simon on a block of ``2 * half`` bits; ``x`` a Python int or a numpy
    uint64 array (bits above the block are dropped, as Grain's
    ``std::bitset`` halves drop them)."""
    vector = isinstance(x, np.ndarray)
    mask = np.uint64((1 << half) - 1) if vector else (1 << half) - 1
    sh = (lambda r: np.uint64(r)) if vector else int

    def rotl(z, r):
        return ((z << sh(r)) | (z >> sh(half - r))) & mask

    hi = (x >> sh(half)) & mask
    lo = x & mask
    for i in range(0, len(keys), 2):
        hi ^= (rotl(lo, 1) & rotl(lo, 8)) ^ rotl(lo, 2)
        hi ^= keys[i] & mask
        lo ^= (rotl(hi, 1) & rotl(hi, 8)) ^ rotl(hi, 2)
        lo ^= keys[i + 1] & mask
    return (hi << sh(half)) | lo


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = 4) -> int:
    """The position of ``index`` under Grain's permutation of
    ``[0, max_index]`` keyed by ``seed``: its compiled ``index_shuffle``,
    value for value."""
    _check(index, max_index, seed, rounds)
    if max_index == 0:
        return 0
    keys, half = round_keys(int(seed), int(rounds)), block_bits(max_index) // 2
    x = int(index)
    while True:
        x = _encrypt(x, keys, half)
        if x <= max_index:
            return x


def shuffled_indices(n: int, seed: int, rounds: int = 4) -> np.ndarray:
    """``[index_shuffle(i, n - 1, seed, rounds) for i in range(n)]`` as an
    int64 array, computed for all positions at once."""
    if n <= 0:
        raise ValueError(f"shuffled_indices: n={n} must be positive")
    _check(0, n - 1, seed, rounds)
    if n == 1:
        return np.zeros(1, np.int64)
    bits = block_bits(n - 1)
    keys, half = round_keys(int(seed), int(rounds)), bits // 2
    if bits == MIN_BLOCK_BITS:
        # the 16-bit block may hold thousands of values per index in range:
        # encrypt the whole block once, then walk every cycle by pointer
        # jumping (each pass doubles the stretch of out-of-range values
        # skipped), a few passes where a walk one step a pass takes
        # thousands
        table = _encrypt(np.arange(1 << bits, dtype=np.uint64), keys, half).astype(np.int64)
        starts = np.arange(n) & ((1 << bits) - 1)       # the index's dropped top bit
        nxt, hit = table, table < n
        while not hit[starts].all():
            nxt, hit = np.where(hit, nxt, nxt[nxt]), hit | hit[nxt]
        return nxt[starts]
    x = _encrypt(np.arange(n, dtype=np.uint64), keys, half)
    walk = np.flatnonzero(x > np.uint64(n - 1))
    while walk.size:          # cycle walking: encrypt again until in range
        x[walk] = _encrypt(x[walk], keys, half)
        walk = walk[x[walk] > np.uint64(n - 1)]
    return x.astype(np.int64)
