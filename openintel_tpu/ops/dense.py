"""Dense cosine retrieval in plain XLA.

- :func:`dense_topk_xla` — exact blocked brute force: a ``lax.scan`` over
  corpus blocks with a running top-k carry. Never materialises the full
  (B, N) score matrix. The default dense path below ``AUTO_PRUNE_DOCS``.
- The int8 candidate pass (:func:`int8_topk_xla`) and :func:`exact_rescore`:
  the dense arm at serving scale. The plain version here is the reference
  for the GPU kernel in :mod:`openintel_tpu.ops.pallas.int8_topk`, which
  computes the same per-span top-2 keys without writing the (B, N) int32
  score matrix to device memory; both share :func:`int8_merge_topk`.

Tie-breaking in the exact paths matches the NumPy reference (descending
score, ascending doc id): ``lax.top_k`` prefers the lower index on equal
values, carries are ordered before the current block, and blocks are scanned
in ascending doc order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Host float, NOT jnp.float32(...): a module-level device scalar would
# initialize jax's backend at import time. Library import must never touch
# a backend.
NEG_INF = float(-jnp.inf)


def l2_normalize(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    n = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return x / jnp.maximum(n, eps)


@partial(jax.jit, static_argnames=("k", "block_size", "precision"))
def dense_topk_xla(
    doc_emb: jax.Array,  # (N, D) unit-norm rows (f32 or bf16)
    queries: jax.Array,  # (B, D) unit-norm rows
    k: int,
    block_size: int = 4096,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> tuple[jax.Array, jax.Array]:
    """Blocked brute-force cosine top-k. Returns (vals (B,k), ids (B,k) int32)."""
    n_docs, dim = doc_emb.shape
    b = queries.shape[0]
    k = min(k, n_docs)

    n_pad = (-n_docs) % block_size
    if n_pad:
        doc_emb = jnp.concatenate(
            [doc_emb, jnp.zeros((n_pad, dim), doc_emb.dtype)], axis=0
        )
    n_blocks = doc_emb.shape[0] // block_size
    blocks = doc_emb.reshape(n_blocks, block_size, dim)
    block_starts = jnp.arange(n_blocks, dtype=jnp.int32) * block_size

    init = (
        jnp.full((b, k), NEG_INF, dtype=jnp.float32),
        jnp.full((b, k), -1, dtype=jnp.int32),
    )
    local_ids = jnp.arange(block_size, dtype=jnp.int32)

    def body(carry, xs):
        vals, ids = carry
        emb_block, start = xs
        scores = jax.lax.dot_general(
            queries,
            emb_block,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )  # (B, block)
        gids = start + local_ids
        scores = jnp.where(gids[None, :] < n_docs, scores, NEG_INF)
        ext_vals = jnp.concatenate([vals, scores], axis=1)
        ext_ids = jnp.concatenate(
            [ids, jnp.broadcast_to(gids[None, :], (b, block_size))], axis=1
        )
        new_vals, sel = jax.lax.top_k(ext_vals, k)
        new_ids = jnp.take_along_axis(ext_ids, sel, axis=1)
        return (new_vals, new_ids), None

    (vals, ids), _ = jax.lax.scan(body, init, (blocks, block_starts))
    return vals, ids


@partial(jax.jit, static_argnames=("k", "block_size", "precision"))
def dense_topk_xla_masked(
    doc_emb: jax.Array,  # (N, D) unit-norm rows (f32 or bf16)
    queries: jax.Array,  # (B, D) unit-norm rows
    doc_mask: jax.Array,  # (N,) bool; False docs never rank
    k: int,
    block_size: int = 4096,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> tuple[jax.Array, jax.Array]:
    """Masked brute-force cosine top-k: exact filtered retrieval at any
    selectivity (the starved-query fallback of the filtered hybrid —
    docs/specs/filtered-search.md). Returns (vals (B,k), ids (B,k)) padded
    (0.0, -1) when fewer than k docs survive the mask."""
    n_docs, dim = doc_emb.shape
    b = queries.shape[0]
    k = min(k, n_docs)

    n_pad = (-n_docs) % block_size
    if n_pad:
        doc_emb = jnp.concatenate(
            [doc_emb, jnp.zeros((n_pad, dim), doc_emb.dtype)], axis=0
        )
    mask = jnp.pad(doc_mask.astype(bool), (0, n_pad))
    n_blocks = doc_emb.shape[0] // block_size
    blocks = doc_emb.reshape(n_blocks, block_size, dim)
    mask_blocks = mask.reshape(n_blocks, block_size)
    block_starts = jnp.arange(n_blocks, dtype=jnp.int32) * block_size

    init = (
        jnp.full((b, k), NEG_INF, dtype=jnp.float32),
        jnp.full((b, k), -1, dtype=jnp.int32),
    )
    local_ids = jnp.arange(block_size, dtype=jnp.int32)

    def body(carry, xs):
        vals, ids = carry
        emb_block, mask_block, start = xs
        scores = jax.lax.dot_general(
            queries,
            emb_block,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )  # (B, block)
        gids = start + local_ids
        ok = mask_block[None, :] & (gids[None, :] < n_docs)
        scores = jnp.where(ok, scores, NEG_INF)
        ext_vals = jnp.concatenate([vals, scores], axis=1)
        ext_ids = jnp.concatenate(
            [ids, jnp.broadcast_to(gids[None, :], (b, block_size))], axis=1
        )
        new_vals, sel = jax.lax.top_k(ext_vals, k)
        new_ids = jnp.take_along_axis(ext_ids, sel, axis=1)
        return (new_vals, new_ids), None

    (vals, ids), _ = jax.lax.scan(
        body, init, (blocks, mask_blocks, block_starts)
    )
    pad = vals == NEG_INF
    return jnp.where(pad, 0.0, vals), jnp.where(pad, -1, ids)


@partial(jax.jit, static_argnames=("k", "precision"))
def dense_topk_flat(
    doc_emb: jax.Array,
    queries: jax.Array,
    k: int,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> tuple[jax.Array, jax.Array]:
    """Unblocked variant: materialises (B, N) scores. Only for small corpora
    and as a cross-check oracle."""
    scores = jax.lax.dot_general(
        queries,
        doc_emb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    vals, ids = jax.lax.top_k(scores, min(k, doc_emb.shape[0]))
    return vals, ids.astype(jnp.int32)


# ---------------------------------------------------------------------------
# int8 candidate pass + exact rescore: the dense arm at serving scale.
#
# Queries and corpus rows are quantised to round(127 x), so for unit-norm
# inputs the int8 x int8 -> int32 dot is ~16129 * cosine (|dot| < 32768).
# Docs are laid out in "supers" of SUPER_TILES sub-tiles of LANES
# consecutive docs; a doc's lane is its id mod 128 and its position is its
# sub-tile within the super. Each score packs with its position into one
# int32 key = score * 128 + KEY_BIAS + pos, so keys of one (super, lane)
# are distinct and every key decodes back to its doc id. Padding rows past
# ``n_docs`` get the sentinel key 0 and never displace a real doc.
#
# The pass keeps the top-2 keys per (lane, group of ``group`` supers), ties
# between supers going to the lower super, and returns the top-k keys of
# that (B, 2 * n_groups * 128) buffer. A true candidate is lost only when
# two docs of its lane and group score higher. ``exact_rescore`` then
# re-ranks the candidates in f32 over the stored rows.
# ---------------------------------------------------------------------------

LANES = 128
SUPER_TILES = 128
SUPER_DOCS = SUPER_TILES * LANES  # 16,384 docs per super
KEY_BIAS = 32768 * LANES  # lifts every real key above the 0 sentinel
INT8_SCALE = 127.0 * 127.0  # int dot -> cosine
# Candidate groups the top-k selects from; more groups keep more candidates
# per lane at the price of a wider final top-k.
INT8_MIN_GROUPS = 8
# Keys stay below 2**23, so a key times the group size fits in int32.
INT8_MAX_GROUP = 255


def quantize_int8(emb) -> np.ndarray:
    """round(127 * x), clipped to int8, for unit-norm embeddings (host)."""
    x = np.asarray(emb, np.float32)
    return np.clip(np.rint(127.0 * x), -127, 127).astype(np.int8)


def int8_corpus(emb, n_rows: int | None = None) -> np.ndarray:
    """Quantise (N, D) rows and zero-pad them to ``n_rows`` rows (default:
    the next multiple of SUPER_DOCS). Done once at index load on the host:
    the candidate pass consumes whole supers and must not copy the corpus
    on every query batch."""
    n, dim = np.shape(emb)
    if n_rows is None:
        n_rows = -(-max(n, 1) // SUPER_DOCS) * SUPER_DOCS
    if n_rows % SUPER_DOCS or n_rows < n:
        raise ValueError(f"n_rows {n_rows} must cover {n} docs in whole supers")
    out = np.zeros((n_rows, dim), np.int8)
    out[:n] = quantize_int8(emb)
    return out


def int8_group(n_docs: int, c: int) -> int:
    """Supers per candidate group: at least INT8_MIN_GROUPS groups, at least
    one group per 64 requested candidates (the candidate buffer of
    2 * n_groups * 128 keys stays several times wider than ``c``), and at
    most INT8_MAX_GROUP supers per group."""
    n_super = -(-max(n_docs, 1) // SUPER_DOCS)
    n_groups = max(
        INT8_MIN_GROUPS, -(-c // 64), -(-n_super // INT8_MAX_GROUP)
    )
    return max(1, -(-n_super // n_groups))


@partial(jax.jit, static_argnames=("n_docs",))
def int8_super_top2_xla(
    corpus8: jax.Array, q8: jax.Array, *, n_docs: int
) -> jax.Array:
    """Plain per-super top-2 keys, (B, n_super, 2, 128) int32: one int8
    matmul into a (B, N) int32 score matrix, then two max-reductions over
    each super's sub-tiles. ``corpus8`` is (N, D) int8 in whole supers."""
    s = jax.lax.dot_general(
        q8, corpus8,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    b = s.shape[0]
    n_super = corpus8.shape[0] // SUPER_DOCS
    pos = jnp.arange(SUPER_TILES, dtype=jnp.int32)[:, None]
    key = s.reshape(b, n_super, SUPER_TILES, LANES) * LANES + (KEY_BIAS + pos)
    doc = jnp.arange(n_super * SUPER_DOCS, dtype=jnp.int32)
    key = jnp.where(doc.reshape(n_super, SUPER_TILES, LANES) < n_docs, key, 0)
    k1 = key.max(axis=2)
    k2 = jnp.where(key == k1[:, :, None, :], 0, key).max(axis=2)
    return jnp.stack([k1, k2], axis=2)


def int8_merge_topk(
    keys: jax.Array, *, k: int, n_docs: int, group: int
) -> tuple[jax.Array, jax.Array]:
    """Shared second step of the int8 candidate pass.

    ``keys`` is (B, n_super, C, 128): C candidate keys per (super, lane),
    distinct within it (0 = no candidate). Keeps the top-2 per (lane,
    group of supers) — by key, then lower super — and returns the top-k
    (vals (B, k) f32 cosines at int8 precision, ids (B, k) int32),
    (0.0, -1)-padded where fewer candidates exist. Any split of a super's
    sub-tiles into candidate spans gives the same result."""
    if not 1 <= group <= INT8_MAX_GROUP:
        raise ValueError(f"group {group} outside [1, {INT8_MAX_GROUP}]")
    b, n_super, c, _ = keys.shape
    n_groups = -(-n_super // group)
    keys = jnp.pad(keys, ((0, 0), (0, n_groups * group - n_super), (0, 0), (0, 0)))
    keys = keys.reshape(b, n_groups, group * c, LANES)
    # rank each key by its super inside the group (lower super, higher
    # rank), so one max picks by key and then by the lower super
    rank = group - 1 - jnp.arange(group * c, dtype=jnp.int32) // c
    ck = keys * group + rank[:, None]
    m1 = ck.max(axis=2)
    m2 = jnp.where(ck == m1[:, :, None], -1, ck).max(axis=2)
    cbuf = jnp.concatenate([m1.reshape(b, -1), m2.reshape(b, -1)], axis=1)
    kbuf = cbuf // group
    col = jnp.arange(cbuf.shape[1], dtype=jnp.int32)
    sup = (col // LANES % n_groups) * group + (group - 1 - cbuf % group)
    ids = (sup * SUPER_TILES + (kbuf & (LANES - 1))) * LANES + col % LANES
    valid = (kbuf > 0) & (ids < n_docs)
    kk = min(k, cbuf.shape[1])
    kv, sel = jax.lax.top_k(jnp.where(valid, kbuf, jnp.int32(-(2**31))), kk)
    ids = jnp.take_along_axis(ids, sel, axis=1)
    valid = jnp.take_along_axis(valid, sel, axis=1)
    score = (kv - (kv & (LANES - 1)) - KEY_BIAS) // LANES
    # multiply, not divide: compilers may rewrite a division by a constant
    vals = jnp.where(valid, score.astype(jnp.float32) * (1.0 / INT8_SCALE), 0.0)
    ids = jnp.where(valid, ids, -1)
    if kk < k:  # more requested than the buffer holds: pad the columns
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)))
        ids = jnp.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
    return vals, ids


@partial(jax.jit, static_argnames=("k", "n_docs", "group"))
def int8_topk_xla(
    corpus8: jax.Array,  # (N_pad, D) int8, N_pad a multiple of SUPER_DOCS
    q8: jax.Array,  # (B, D) int8
    *,
    k: int,
    n_docs: int,
    group: int,
) -> tuple[jax.Array, jax.Array]:
    """The int8 candidate pass in plain XLA: the reference for the GPU
    kernel, which must match it bit for bit."""
    return int8_merge_topk(
        int8_super_top2_xla(corpus8, q8, n_docs=n_docs),
        k=k, n_docs=n_docs, group=group,
    )


@partial(jax.jit, static_argnames=("k",))
def exact_rescore(
    doc_emb: jax.Array,  # (N, D) bf16/f32 unit-norm rows
    queries: jax.Array,  # (B, D) f32/bf16 unit-norm
    cand_ids: jax.Array,  # (B, C) int32 candidate ids, -1 padded
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Exact f32 rescoring of a small candidate set: gather the candidates'
    rows (B*C rows — megabytes, not the corpus) and re-rank. Restores exact
    ordering on top of the int8 candidate pass; ties break by ascending doc
    id via a two-key sort, matching the NumPy reference. ``HIGHEST``
    precision keeps the product in true f32 (not TF32) on the GPU."""
    safe = jnp.maximum(cand_ids, 0)
    cand = jnp.take(doc_emb, safe, axis=0)  # (B, C, D)
    scores = jax.lax.dot_general(
        cand.astype(jnp.float32),
        queries.astype(jnp.float32),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (B, C)
    scores = jnp.where(cand_ids >= 0, scores, NEG_INF)
    neg, ids_sorted = jax.lax.sort((-scores, cand_ids), num_keys=2, dimension=1)
    vals = -neg[:, :k]
    ids = ids_sorted[:, :k]
    invalid = vals == NEG_INF
    return jnp.where(invalid, 0.0, vals), jnp.where(invalid, -1, ids)
