"""Full-read pair verification — byte-path reference implementation.

The device replacement for muscato_confirm's all-pairs Hamming check per
k-mer group (cmd/muscato_confirm/main.go:171-250 in the reference): a dense
(pairs x MaxReadLength) mismatch count.  The production kernel is the SWAR
variant in ops/packed.py (bit-identical, fuzz-tested against this one);
this byte-level version is the readable specification.

Semantics reproduced exactly (file:line cites into the reference):

  - a pair survives only if the read's window region equals the target
    window (the reference joins on the k-mer string; here it also subsumes
    hash-collision rejection for wide windows);
  - the site must leave room for the read's left tail: p_local >= q1
    (screen main.go:340-346, jw >= 0; the pos-0 special case at :286-316
    only ever emits q1==0 windows, which p_local >= q1 covers);
  - the gene must not end before the read: srgt_len <= mrgt_len
    (confirm main.go:201-203), where the stored right tail is capped at
    MaxReadLength - q2 past the window (screen main.go:348-351) and — the
    reference's hard-coded quirk — at absolute position 100 - q2 for
    window-offset-0 hits at target position 0 (screen main.go:305);
  - the mismatch budget is int((1 - PMatch) * readlen), computed in float64
    with truncation toward zero (confirm main.go:198), passed in here as a
    per-length lookup table;
  - nmiss counts mismatches over the left tail and the clipped right tail
    (confirm main.go:206-208); the window region contributes zero by the
    equality requirement, so the full-read mismatch count equals it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def verify_pairs_dynq(
    r: jnp.ndarray,  # (P,) int32 read rows (-1 = inactive lane)
    p: jnp.ndarray,  # (P,) int32 global window positions (-1 = inactive)
    codes: jnp.ndarray,  # (R, Lmax) uint8
    lengths: jnp.ndarray,  # (R,) int32
    tcat: jnp.ndarray,  # (S,) uint8
    gene_start: jnp.ndarray,  # (G+1,) int32
    budget: jnp.ndarray,  # (Lmax+1,) int32 mismatch budget per read length
    q1,  # int or traced int32 scalar
    width: int,
    max_read_length: int,
):
    """Verify each (read, site) pair; returns (keep, nx, g, s).

    g = gene index (recovered by binary search over gene_start), s = read
    start within the gene (the reported `pos`, confirm main.go:221-232
    emits mpos - len(mlft)).  q1 may be a traced scalar so one executable
    serves all windows of a run.
    """
    from .packed import gene_of_pos

    q2 = q1 + width
    smax = tcat.shape[0]
    active = (r >= 0) & (p >= 0)
    rc = jnp.clip(r, 0, codes.shape[0] - 1)
    pc = jnp.clip(p, 0, smax - 1)

    g = gene_of_pos(gene_start, pc)
    gstart = gene_start[g]
    glen = gene_start[g + 1] - gstart
    p_local = pc - gstart
    rlen = lengths[rc]

    # Read start within the gene.
    s_local = p_local - q1
    left_ok = s_local >= 0

    # Right-tail length the reference would have stored for this site
    # (screen main.go:305 & :348-351), in gene-local coordinates.
    cap_norm = p_local + width + (max_read_length - q2)
    cap_pos0 = jnp.int32(100 - q2)  # hard-coded reference quirk
    is_pos0 = (p_local == 0) & (q1 == 0)
    cap_abs = jnp.where(is_pos0, cap_pos0, cap_norm)
    mrgt_len = jnp.minimum(glen, cap_abs) - (p_local + width)
    srgt_len = rlen - q2
    fit_ok = srgt_len <= mrgt_len

    # Mismatch counts over the aligned full read.
    cols = jnp.arange(codes.shape[1], dtype=jnp.int32)
    tpos = (pc - q1)[:, None] + cols[None, :]
    tchars = tcat[jnp.clip(tpos, 0, smax - 1)]
    rchars = codes[rc]
    in_read = cols[None, :] < rlen[:, None]
    neq = (tchars != rchars) & in_read
    in_window = (cols >= q1) & (cols < q2)
    win_mm = jnp.sum(neq & in_window[None, :], axis=1)
    nx = jnp.sum(neq, axis=1).astype(jnp.int32)

    keep = (
        active
        & left_ok
        & fit_ok
        & (win_mm == 0)
        & (nx <= budget[jnp.clip(rlen, 0, budget.shape[0] - 1)])
    )
    return keep, nx, g.astype(jnp.int32), s_local.astype(jnp.int32)


verify_pairs = partial(jax.jit, static_argnames=("q1", "width", "max_read_length"))(
    verify_pairs_dynq
)


def mismatch_budget_table(pmatch: float, max_read_length: int) -> np.ndarray:
    """budget[L] = int((1 - pmatch) * L), float64, truncated toward zero —
    bit-identical to Go's int((1-PMatch)*float64(len)) (confirm main.go:198)."""
    ls = np.arange(max_read_length + 1, dtype=np.float64)
    return np.trunc((np.float64(1.0) - np.float64(pmatch)) * ls).astype(np.int32)
