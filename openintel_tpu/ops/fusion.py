"""Rank fusion on device: reciprocal-rank fusion + z-normalised score blend.

RRF fuses ranked id lists from the lexical and dense arms into one ranking:
fused(d) = sum over lists with d at 1-based rank r of 1/(rrf_k + r).

``zblend_fuse_device`` is the score-fusion alternative (the reference's own
fusion ancestry is a weighted, renormalised score blend —
src/domain/engine/speculation_engine.rs:151-176): each arm's top-C scores
are z-normalised per query over its own candidate list, candidates missing
from an arm take that arm's minimum z (the pessimistic fill), and the fused
score is alpha * z_lexical + (1 - alpha) * z_dense. Measured A/B vs RRF on
the quality harness: scripts/fusion_ab.py -> docs/benchmarks.md "Fusion".

Device formulation (all static shapes, one fused program):
- candidates = concat of the input id lists (B, C);
- per-list rank contributions via an equality matmul against the reciprocal
  rank vector (C x K comparisons — tiny);
- duplicates (same doc in several lists) keep their first occurrence, later
  occurrences are masked to -inf;
- final order via ``lax.sort`` with two keys (-fused, doc_id) — deterministic
  ties by ascending doc id, exactly the NumPy reference semantics
  (openintel_tpu/ops/reference.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

RRF_K = 60.0
# Host float, NOT jnp.float32(...): a module-level device scalar would
# initialize jax's backend at import time. Library import must never touch
# a backend.
NEG_INF = float(-jnp.inf)


@partial(jax.jit, static_argnames=("c",))
def mask_compact_ranked(
    ids: jax.Array,  # (B, C) int32 ranked ids, best first; -1 = padding
    keep: jax.Array,  # (B, C) bool; False entries are filtered out
    c: int,
) -> tuple[jax.Array, jax.Array]:
    """Stable-compact the surviving entries of ranked id lists.

    Returns ((B, c) ids — survivors in their original rank order, -1
    padded; (B,) int32 survivor counts). Filtering cannot reorder
    survivors, so the compacted prefix of a filtered ranking IS the
    ranking of the filtered corpus restricted to this candidate pool —
    the exactness basis of oversample-then-compact filtered retrieval
    (docs/specs/filtered-search.md): when survivors >= c, the first c
    entries are exactly the filtered top-c."""
    cw = ids.shape[1]
    pos = jnp.arange(cw, dtype=jnp.int32)[None, :]
    key = jnp.where(keep, pos, cw + pos)  # survivors first, stable
    _, compacted = jax.lax.sort(
        (key, jnp.where(keep, ids, -1)), num_keys=1, dimension=1
    )
    surv = jnp.sum(keep.astype(jnp.int32), axis=1)
    if cw < c:
        compacted = jnp.pad(
            compacted, ((0, 0), (0, c - cw)), constant_values=-1
        )
    return compacted[:, :c], surv


@partial(jax.jit, static_argnames=("c",))
def mask_compact_ranked_vals(
    ids: jax.Array,  # (B, C) int32 ranked ids, best first; -1 = padding
    vals: jax.Array,  # (B, C) scores aligned with ids
    keep: jax.Array,  # (B, C) bool; False entries are filtered out
    c: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """:func:`mask_compact_ranked` carrying the scores through the compact
    (the sharded filtered program merges per-shard survivor lists by score,
    so the compacted prefix must keep (val, id) pairs together). Returns
    ((B, c) vals — -inf padded, (B, c) ids — -1 padded, (B,) survivors)."""
    cw = ids.shape[1]
    pos = jnp.arange(cw, dtype=jnp.int32)[None, :]
    key = jnp.where(keep, pos, cw + pos)  # survivors first, stable
    _, cvals, cids = jax.lax.sort(
        (
            key,
            jnp.where(keep, vals.astype(jnp.float32), NEG_INF),
            jnp.where(keep, ids, -1),
        ),
        num_keys=1,
        dimension=1,
    )
    surv = jnp.sum(keep.astype(jnp.int32), axis=1)
    if cw < c:
        cvals = jnp.pad(cvals, ((0, 0), (0, c - cw)), constant_values=NEG_INF)
        cids = jnp.pad(cids, ((0, 0), (0, c - cw)), constant_values=-1)
    return cvals[:, :c], cids[:, :c], surv


@partial(jax.jit, static_argnames=("k", "rrf_k"))
def rrf_fuse_device(
    ids_a: jax.Array,  # (B, Ka) int32 ranked ids (rank 1 first); -1 = padding
    ids_b: jax.Array,  # (B, Kb) int32
    k: int,
    rrf_k: float = RRF_K,
) -> tuple[jax.Array, jax.Array]:
    """Fuse two ranked lists; returns (fused_vals (B,k), ids (B,k), -1 padded)."""
    cand = jnp.concatenate([ids_a, ids_b], axis=1)  # (B, C)
    b, c = cand.shape

    def contribution(lst: jax.Array) -> jax.Array:
        klist = lst.shape[1]
        recip = 1.0 / (rrf_k + jnp.arange(1, klist + 1, dtype=jnp.float32))
        match = (cand[:, :, None] == lst[:, None, :]) & (lst[:, None, :] >= 0)
        return jnp.sum(match.astype(jnp.float32) * recip[None, None, :], axis=2)

    fused = contribution(ids_a) + contribution(ids_b)  # (B, C)

    # Mask padding and duplicate candidates (keep the first occurrence).
    col = jnp.arange(c, dtype=jnp.int32)
    earlier = col[None, :, None] > col[None, None, :]  # cand i dupes cand j<i
    dup = jnp.any((cand[:, :, None] == cand[:, None, :]) & earlier, axis=2)
    valid = (cand >= 0) & ~dup
    fused = jnp.where(valid, fused, NEG_INF)

    # Deterministic sort: primary key -fused, secondary key doc id (ascending).
    neg, ids_sorted = jax.lax.sort((-fused, cand), num_keys=2, dimension=1)
    fused_sorted = -neg
    if c < k:  # fewer candidates than requested: pad columns to the
        # reference's (B, k) contract instead of returning a short array
        # (a short array crashes run_prepared's reshape downstream)
        fused_sorted = jnp.pad(
            fused_sorted, ((0, 0), (0, k - c)), constant_values=-jnp.inf
        )
        ids_sorted = jnp.pad(
            ids_sorted, ((0, 0), (0, k - c)), constant_values=-1
        )
    vals = fused_sorted[:, :k]
    ids = ids_sorted[:, :k]
    invalid = vals == NEG_INF
    return jnp.where(invalid, 0.0, vals), jnp.where(invalid, -1, ids)


# Lexical weight in the z-blend (dense gets 1 - alpha). 0.7 is the measured
# winner of the alpha sweep (scripts/fusion_ab.py, docs/fusion_ab.json):
# exact-surface R@10/MRR@10 0.840/0.706 (hashing) and 0.845/0.711 (neural)
# vs 0.820/0.606 and 0.838/0.705 for rrf_k=60, with mismatch-set quality
# identical — see docs/benchmarks.md "Fusion".
BLEND_ALPHA = 0.7
_Z_EPS = 1e-6


@partial(jax.jit, static_argnames=("k", "alpha"))
def zblend_fuse_device(
    vals_a: jax.Array,  # (B, Ka) f32 scores aligned with ids_a
    ids_a: jax.Array,  # (B, Ka) int32 ranked ids (rank 1 first); -1 = padding
    vals_b: jax.Array,  # (B, Kb) f32
    ids_b: jax.Array,  # (B, Kb) int32
    k: int,
    alpha: float = BLEND_ALPHA,
) -> tuple[jax.Array, jax.Array]:
    """Z-normalised score blend of two scored candidate lists.

    Per query and per arm: z = (score - mean) / (std + eps) over that arm's
    VALID entries (ids >= 0); a candidate absent from an arm takes the
    arm's minimum z. Fused = alpha * z_a + (1 - alpha) * z_b; final order
    by (-fused, doc_id) — the same deterministic ascending-doc-id tie break
    as :func:`rrf_fuse_device` and the NumPy oracle
    (ops/reference.py::zblend_fuse)."""
    cand = jnp.concatenate([ids_a, ids_b], axis=1)  # (B, C)
    b, c = cand.shape

    def arm_score(vals: jax.Array, ids: jax.Array) -> jax.Array:
        valid = ids >= 0
        vf = vals.astype(jnp.float32)
        n = jnp.maximum(jnp.sum(valid, axis=1, keepdims=True), 1)
        mean = jnp.sum(jnp.where(valid, vf, 0.0), axis=1, keepdims=True) / n
        var = (
            jnp.sum(jnp.where(valid, (vf - mean) ** 2, 0.0), axis=1,
                    keepdims=True)
            / n
        )
        z = (vf - mean) / jnp.sqrt(var + _Z_EPS)
        # pessimistic fill: an arm that never surfaced the candidate votes
        # with its own worst observed z (0 when the arm is empty)
        fill = jnp.min(jnp.where(valid, z, jnp.inf), axis=1)
        fill = jnp.where(jnp.isfinite(fill), fill, 0.0)  # all-padding arm
        # padded entries carry -inf scores, so their z is -inf; zero them
        # BEFORE the masked sum — 0 * (-inf) is NaN under IEEE, and only an
        # XLA select-fold (not guaranteed across backends/interpret mode)
        # keeps the jitted path from poisoning every candidate's score
        z = jnp.where(valid, z, 0.0)
        match = (cand[:, :, None] == ids[:, None, :]) & valid[:, None, :]
        matched = jnp.any(match, axis=2)
        # each candidate matches at most one entry of a (dedup'd) ranked
        # list, so the masked sum IS the matched entry's z
        s = jnp.sum(match.astype(jnp.float32) * z[:, None, :], axis=2)
        return jnp.where(matched, s, fill[:, None])

    fused = alpha * arm_score(vals_a, ids_a) + (1.0 - alpha) * arm_score(
        vals_b, ids_b
    )

    # Mask padding and duplicate candidates (keep the first occurrence) —
    # identical dedup semantics to rrf_fuse_device.
    col = jnp.arange(c, dtype=jnp.int32)
    earlier = col[None, :, None] > col[None, None, :]
    dup = jnp.any((cand[:, :, None] == cand[:, None, :]) & earlier, axis=2)
    valid = (cand >= 0) & ~dup
    fused = jnp.where(valid, fused, NEG_INF)

    neg, ids_sorted = jax.lax.sort((-fused, cand), num_keys=2, dimension=1)
    fused_sorted = -neg
    if c < k:
        fused_sorted = jnp.pad(
            fused_sorted, ((0, 0), (0, k - c)), constant_values=-jnp.inf
        )
        ids_sorted = jnp.pad(
            ids_sorted, ((0, 0), (0, k - c)), constant_values=-1
        )
    vals = fused_sorted[:, :k]
    ids = ids_sorted[:, :k]
    invalid = vals == NEG_INF
    return jnp.where(invalid, 0.0, vals), jnp.where(invalid, -1, ids)
