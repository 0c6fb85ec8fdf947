"""Window-key packing and entropy gating (device ops).

The reference screens with buzhash32 rolling hashes over byte strings
(cmd/muscato_screen/main.go:104-113, 319-323 in the reference).  Here a
rolling hash is unnecessary: windows have a fixed width, so the window
content itself — base-5-packed into an integer — is the key.

  - For WindowWidth <= 13, 5**W < 2**31 and the packed value is an *exact*
    key: equal keys <=> equal windows, no collisions.
  - For wider windows the same Horner recurrence is evaluated with an odd
    32-bit multiplier, giving a polynomial hash mod 2**32.  Collisions are
    possible but harmless: the verify kernel independently requires the
    window region of the read to match the target exactly (the reference's
    sort-merge join on the k-mer string guarantees the same), so a colliding
    pair is rejected there.

The dinucleotide entropy gate reproduces utils.CountDinuc
(/root/reference/utils/entropy.go:5-40): the number of distinct adjacent
code pairs over the 5-letter alphabet; read windows with fewer than
MinDinuc distinct pairs are not seeded (cmd/muscato_window_reads/main.go:116-118
and cmd/muscato_screen/main.go:180-186 apply the same gate on both sides of
the reference's join).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NBASE = 5
EXACT_WIDTH_LIMIT = 13  # 5**13 = 1_220_703_125 < 2**31
HASH_MULT = np.uint32(0x9E3779B1)  # odd => injective per-step mixing
HASH_MULT2 = np.uint32(0x85EBCA77)  # second, decorrelated hash for wide windows


def key_multiplier(width: int) -> np.uint32:
    return np.uint32(NBASE) if width <= EXACT_WIDTH_LIMIT else HASH_MULT


def uses_second_key(width: int) -> bool:
    """Wide windows pair the primary hash with a second 32-bit hash,
    making the probe key effectively 64-bit (ops/search.py)."""
    return width > EXACT_WIDTH_LIMIT


def window_keys_at(
    codes: jnp.ndarray, q1: int, width: int, mult: np.uint32 | None = None
) -> jnp.ndarray:
    """Keys of the width-`width` window starting at column q1 of each row.

    codes: (R, L) uint8/int32.  Returns (R,) uint32.  Rows whose length is
    shorter than q1+width produce garbage keys; callers mask by length.
    """
    if mult is None:
        mult = key_multiplier(width)
    w = codes[:, q1 : q1 + width].astype(jnp.uint32)
    key = jnp.zeros(codes.shape[0], dtype=jnp.uint32)
    for i in range(width):
        key = key * mult + w[:, i]
    return key


def sliding_window_keys(
    tcat: jnp.ndarray, width: int, mult: np.uint32 | None = None
) -> jnp.ndarray:
    """Keys of the window starting at every position of a 1-D code array.

    tcat: (S,) uint8.  Returns (S,) uint32; the last width-1 entries read
    zero-padding and are masked out by validity downstream.
    """
    if mult is None:
        mult = key_multiplier(width)
    s = tcat.shape[0]
    padded = jnp.concatenate([tcat.astype(jnp.uint32), jnp.zeros(width - 1, jnp.uint32)])
    key = jnp.zeros(s, dtype=jnp.uint32)
    for i in range(width):
        key = key * mult + jax.lax.dynamic_slice(padded, (i,), (s,))
    return key


def dinucleotide_counts(codes: jnp.ndarray, q1: int, width: int) -> jnp.ndarray:
    """Distinct adjacent-pair count within each row's [q1, q1+width) window.

    codes: (R, L).  Returns (R,) int32 in [0, 25].
    """
    w = codes[:, q1 : q1 + width].astype(jnp.int32)
    pairs = w[:, :-1] * NBASE + w[:, 1:]  # (R, width-1)
    bins = jnp.arange(NBASE * NBASE, dtype=jnp.int32)
    present = jnp.any(pairs[:, :, None] == bins[None, None, :], axis=1)  # (R, 25)
    return jnp.sum(present, axis=1).astype(jnp.int32)
