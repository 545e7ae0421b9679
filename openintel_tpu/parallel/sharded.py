"""Sharded retrieval: per-shard top-k + all-gather merge.

The corpus shards evenly over the "corpus" mesh axis; query batches shard over
"data". Each device scores only its local documents (dense matmul and/or BM25
reduction), computes a local top-k, converts to global doc ids, and the
k-sized candidate lists all-gather (k << shard size, so the collective moves
bytes-per-query, not the corpus; XLA hands it to NCCL, over NVLink between
the cards of one host). The merge is deterministic: candidates
arrive ordered (shard, local rank) = ascending doc id on ties, and
``lax.top_k`` keeps the first occurrence — so the cross-shard result is
bit-identical to a single-shard run over the whole corpus (SURVEY.md hard
part (d)).

Global BM25 statistics (df, avgdl) are computed with psum collectives at
index-build time so every shard scores against corpus-wide idf.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from openintel_tpu import platform
from openintel_tpu.ops.dense import dense_topk_xla
from openintel_tpu.ops.fusion import (
    BLEND_ALPHA,
    RRF_K,
    rrf_fuse_device,
    zblend_fuse_device,
)
from openintel_tpu.parallel.mesh import CORPUS_AXIS, DATA_AXIS


def _merge_gathered(vals_g: jax.Array, ids_g: jax.Array, k: int):
    """Merge all-gathered per-shard candidates (S, B, k) -> (B, k).

    Shards are concatenated in shard order, so on exactly-equal scores the
    lower shard (= lower global doc id) wins, matching single-shard ranking."""
    s, b, kk = vals_g.shape
    flat_vals = jnp.transpose(vals_g, (1, 0, 2)).reshape(b, s * kk)
    flat_ids = jnp.transpose(ids_g, (1, 0, 2)).reshape(b, s * kk)
    vals, sel = jax.lax.top_k(flat_vals, k)
    ids = jnp.take_along_axis(flat_ids, sel, axis=1)
    return vals, ids


def _local_dense_topk(
    emb_local, q_local, k, kernel, block_size, interpret=False,
    rescore_local=None, q_i8_local=None, candidates=None,
):
    """Per-shard dense arm: the exact scan in ``block_size`` blocks for
    ``kernel="xla"``; for ``kernel="int8"`` THE dense-arm dispatch
    (models.retrievers.dense_arm_topk), so kernel and interpret handling
    cannot drift between the single-device and sharded serving paths.
    ``emb_local`` is then the shard's int8 rows in whole supers, and the
    rescore runs LOCALLY over ``rescore_local`` (ids are shard-local), so
    the all-gathered candidates already carry exact f32 scores."""
    if kernel == "xla":
        return dense_topk_xla(emb_local, q_local, k, block_size)
    from openintel_tpu.models.retrievers import dense_arm_topk

    return dense_arm_topk(
        kernel,
        emb_local,
        q_local,
        k,
        n_docs=emb_local.shape[0],
        interpret=interpret,
        # None -> the single-device default over-fetch; the hybrid program
        # passes candidates=c to match the single-device fused hybrid
        candidates=candidates,
        rescore_op=rescore_local,
        q8=q_i8_local,
    )


def sharded_dense_topk(
    mesh: Mesh,
    doc_emb: jax.Array,  # (N, D) rows; int8 in whole supers for kernel="int8"
    queries: jax.Array,  # (B, D), B divisible by the data axis size
    k: int,
    *,
    block_size: int = 4096,
    kernel: str = "xla",
    rescore: Optional[jax.Array] = None,  # (N, D) rows, kernel="int8"
    queries_i8: Optional[jax.Array] = None,  # (B, D) int8, kernel="int8"
    n_docs_true: Optional[int] = None,  # pre-padding corpus size
) -> tuple[jax.Array, jax.Array]:
    """Dense cosine top-k over a corpus sharded across the mesh.

    ``n_docs_true`` is the PRE-padding corpus size: shard-even padding rows
    (zero embeddings, cosine 0.0) would otherwise outrank real docs with
    negative scores and displace them from the per-shard top-k — the
    single-chip kernels mask these via their own ``n_docs`` argument, and
    the sharded program must match (single-chip parity)."""
    n_docs = doc_emb.shape[0]
    n_shards = mesh.shape[CORPUS_AXIS]
    assert n_docs % n_shards == 0, "pad the corpus to shard evenly"
    shard_size = n_docs // n_shards
    if kernel == "int8":
        assert rescore is not None and queries_i8 is not None
    else:
        # uniform shard_map signature: tiny unused operands
        rescore = jnp.zeros((n_shards, queries.shape[1]), queries.dtype)
        queries_i8 = jnp.zeros(queries.shape, jnp.int8)
    f = _dense_program(
        mesh, shard_size, k, kernel, block_size, platform.interpret(),
        n_docs if n_docs_true is None else n_docs_true,
    )
    return f(doc_emb, queries, rescore, queries_i8)


@functools.lru_cache(maxsize=64)
def _dense_program(
    mesh, shard_size, k, kernel, block_size, interpret, n_docs_true
):
    """Build + JIT the sharded dense program ONCE per static config.

    Serving calls this per query batch; without the cache every call would
    re-trace the shard_map and execute it un-fused (measured ~20x slower
    than the jitted program on the virtual mesh)."""

    def local(emb_local, q_local, rs_local, q8_local):
        vals, ids = _local_dense_topk(
            emb_local, q_local, k, kernel, block_size, interpret,
            rescore_local=rs_local, q_i8_local=q8_local, candidates=None,
        )
        shard = jax.lax.axis_index(CORPUS_AXIS)
        # mask unfilled slots AND shard-even corpus-padding docs (zero
        # rows scoring 0.0 would displace negative-scored real docs)
        valid = (ids >= 0) & (ids + shard * shard_size < n_docs_true)
        gids = jnp.where(valid, ids + shard * shard_size, -1)
        vals = jnp.where(valid, vals, -jnp.inf)
        vals_g = jax.lax.all_gather(vals, CORPUS_AXIS)  # (S, B_local, k)
        ids_g = jax.lax.all_gather(gids, CORPUS_AXIS)
        mvals, mids = _merge_gathered(vals_g, ids_g, k)
        return jnp.where(mids < 0, 0.0, mvals), mids

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
            ),
            out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
            check_vma=False,
        )
    )


def sharded_bm25_topk(
    mesh: Mesh,
    plan_doc_ids: jax.Array,  # (S, B, Pw) per-shard plans, sentinel=shard_size
    plan_weights: jax.Array,  # (S, B, Pw)
    shard_size: int,
    k: int,
    *,
    presorted: bool = False,
    max_run: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """BM25 top-k over sharded postings (host builds per-shard query plans)."""
    f = _bm25_program(mesh, shard_size, k, presorted, max_run)
    return f(plan_doc_ids, plan_weights)


@functools.lru_cache(maxsize=64)
def _bm25_program(mesh, shard_size, k, presorted, max_run):
    """Build + JIT the sharded BM25 program once per static config."""
    from openintel_tpu.ops.bm25 import bm25_topk_device

    def local(ids_local, w_local):
        vals, lids = bm25_topk_device(
            ids_local[0], w_local[0], shard_size, k,
            presorted=presorted, max_run=max_run,
        )
        shard = jax.lax.axis_index(CORPUS_AXIS)
        gids = jnp.where(lids >= 0, lids + shard * shard_size, -1)
        # padded slots carry score 0.0; push them below every real score
        vals = jnp.where(lids >= 0, vals, -jnp.inf)
        vals_g = jax.lax.all_gather(vals, CORPUS_AXIS)
        ids_g = jax.lax.all_gather(gids, CORPUS_AXIS)
        mvals, mids = _merge_gathered(vals_g, ids_g, k)
        pad = mids < 0
        return jnp.where(pad, 0.0, mvals), mids

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(CORPUS_AXIS, DATA_AXIS, None),
                P(CORPUS_AXIS, DATA_AXIS, None),
            ),
            out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
            check_vma=False,
        )
    )


def _fuse_device(fusion, b_vals, b_top, d_vals, d_top, k, rrf_k, alpha):
    """Fuse merged global arm rankings by the configured function — the
    same zblend-default / rrf-alternative contract as the single-chip
    HybridRetriever._fuse_arms (models/retrievers.py)."""
    if fusion == "zblend":
        return zblend_fuse_device(b_vals, b_top, d_vals, d_top, k, alpha)
    return rrf_fuse_device(b_top, d_top, k, rrf_k)


def sharded_hybrid_topk(
    mesh: Mesh,
    doc_emb: jax.Array,  # (N, D) corpus-sharded rows
    queries: jax.Array,  # (B, D) query embeddings
    plan_doc_ids: jax.Array,  # (S, B, Pw) per-shard BM25 plans
    plan_weights: jax.Array,  # (S, B, Pw)
    k: int,
    *,
    candidates_per_arm: Optional[int] = None,
    rrf_k: float = RRF_K,
    fusion: str = "zblend",
    blend_alpha: float = BLEND_ALPHA,
    block_size: int = 4096,
    kernel: str = "xla",
    presorted: bool = False,
    max_run: int = 0,
    rescore: Optional[jax.Array] = None,  # (N, D) rows, kernel="int8"
    queries_i8: Optional[jax.Array] = None,  # (B, D) int8, kernel="int8"
    n_docs_true: Optional[int] = None,  # pre-padding corpus size
    return_arms: bool = False,
) -> tuple[jax.Array, ...]:
    """Full hybrid query step, one device program: per-shard BM25 + dense
    local top-c, all-gather, global merges, fusion, final top-k.

    ``return_arms`` additionally emits the globally-merged per-arm
    rankings the fusion consumed — (fused_vals, fused_ids, bm25_vals,
    bm25_ids, dense_vals, dense_ids) — at zero extra corpus work (they
    exist inside the program either way). The sharded live corpus merges
    them with its delta arms, paying ONE corpus-wide dispatch instead of
    two (parallel/updatable.py)."""
    c = candidates_per_arm or k
    n_docs = doc_emb.shape[0]
    n_shards = mesh.shape[CORPUS_AXIS]
    assert n_docs % n_shards == 0
    shard_size = n_docs // n_shards
    if kernel == "int8":
        assert rescore is not None and queries_i8 is not None
    else:
        rescore = jnp.zeros((n_shards, queries.shape[1]), queries.dtype)
        queries_i8 = jnp.zeros(queries.shape, jnp.int8)
    f = _hybrid_program(
        mesh, shard_size, k, c, float(rrf_k), block_size, kernel,
        presorted, max_run, platform.interpret(),
        n_docs if n_docs_true is None else n_docs_true,
        return_arms, fusion, float(blend_alpha),
    )
    return f(doc_emb, queries, plan_doc_ids, plan_weights, rescore, queries_i8)


@functools.lru_cache(maxsize=64)
def _hybrid_program(
    mesh, shard_size, k, c, rrf_k, block_size, kernel, presorted, max_run,
    interpret, n_docs_true, return_arms=False, fusion="zblend",
    blend_alpha=BLEND_ALPHA,
):
    """Build + JIT the full sharded hybrid program once per static config
    (per-batch re-tracing measured ~20x slower on the virtual mesh)."""
    from openintel_tpu.ops.bm25 import bm25_topk_device

    def local(emb_local, q_local, ids_local, w_local, rs_local, q8_local):
        shard = jax.lax.axis_index(CORPUS_AXIS)
        # dense arm (candidates=c: exactly the single-chip fused hybrid)
        d_vals, d_ids = _local_dense_topk(
            emb_local, q_local, c, kernel, block_size, interpret,
            rescore_local=rs_local, q_i8_local=q8_local, candidates=c,
        )
        # mask unfilled slots AND shard-even corpus-padding docs (zero
        # rows scoring 0.0 would displace negative-scored real docs)
        d_valid = (d_ids >= 0) & (d_ids + shard * shard_size < n_docs_true)
        d_gids = jnp.where(d_valid, d_ids + shard * shard_size, -1)
        d_vals = jnp.where(d_valid, d_vals, -jnp.inf)
        # lexical arm (scatter-free segmented-scan reduction over host-sorted plans)
        b_vals, b_lids = bm25_topk_device(
            ids_local[0], w_local[0], shard_size, c,
            presorted=presorted, max_run=max_run,
        )
        b_gids = jnp.where(b_lids >= 0, b_lids + shard * shard_size, -1)
        b_vals = jnp.where(b_lids >= 0, b_vals, -jnp.inf)
        # all-gather of the c-sized candidate lists, then global merges
        d_vals_g = jax.lax.all_gather(d_vals, CORPUS_AXIS)
        d_ids_g = jax.lax.all_gather(d_gids, CORPUS_AXIS)
        b_vals_g = jax.lax.all_gather(b_vals, CORPUS_AXIS)
        b_ids_g = jax.lax.all_gather(b_gids, CORPUS_AXIS)
        d_mvals, d_top = _merge_gathered(d_vals_g, d_ids_g, c)
        b_mvals, b_top = _merge_gathered(b_vals_g, b_ids_g, c)
        fused = _fuse_device(
            fusion, b_mvals, b_top, d_mvals, d_top, k, rrf_k, blend_alpha
        )
        if not return_arms:
            return fused
        # per-arm padding keeps the single-arm contract: 0.0 at -1 ids
        return (
            *fused,
            jnp.where(b_top < 0, 0.0, b_mvals), b_top,
            jnp.where(d_top < 0, 0.0, d_mvals), d_top,
        )

    n_out = 6 if return_arms else 2
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
                P(CORPUS_AXIS, DATA_AXIS, None),
                P(CORPUS_AXIS, DATA_AXIS, None),
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
            ),
            out_specs=tuple([P(DATA_AXIS, None)] * n_out),
            check_vma=False,
        )
    )


def sharded_hybrid_topk_scan(
    mesh: Mesh,
    doc_emb: jax.Array,
    queries: jax.Array,  # (nb, B, D) sub-batched query embeddings
    plan_doc_ids: jax.Array,  # (nb, S, B, Pw)
    plan_weights: jax.Array,  # (nb, S, B, Pw)
    k: int,
    *,
    candidates_per_arm: Optional[int] = None,
    rrf_k: float = RRF_K,
    fusion: str = "zblend",
    blend_alpha: float = BLEND_ALPHA,
    block_size: int = 4096,
    kernel: str = "xla",
    presorted: bool = False,
    max_run: int = 0,
    rescore: Optional[jax.Array] = None,
    queries_i8: Optional[jax.Array] = None,  # (nb, B, D) int8
    n_docs_true: Optional[int] = None,  # pre-padding corpus size
) -> tuple[jax.Array, jax.Array]:
    """Multi-sub-batch sharded hybrid: ONE device dispatch scans the full
    sharded program over the leading sub-batch axis (the multi-chip
    analogue of ``HybridRetriever.run_prepared`` — large requests pay one
    dispatch round-trip, not one per sub-batch). Returns (nb, B, k)."""
    c = candidates_per_arm or k
    n_docs = doc_emb.shape[0]
    n_shards = mesh.shape[CORPUS_AXIS]
    assert n_docs % n_shards == 0
    shard_size = n_docs // n_shards
    if kernel == "int8":
        assert rescore is not None and queries_i8 is not None
    else:
        rescore = jnp.zeros((n_shards, queries.shape[2]), queries.dtype)
        queries_i8 = jnp.zeros(queries.shape, jnp.int8)
    f = _hybrid_scan_program(
        mesh, shard_size, k, c, float(rrf_k), block_size, kernel,
        presorted, max_run, platform.interpret(),
        n_docs if n_docs_true is None else n_docs_true,
        fusion, float(blend_alpha),
    )
    return f(doc_emb, queries, plan_doc_ids, plan_weights, rescore, queries_i8)


@functools.lru_cache(maxsize=64)
def _hybrid_scan_program(
    mesh, shard_size, k, c, rrf_k, block_size, kernel, presorted, max_run,
    interpret, n_docs_true, fusion="zblend", blend_alpha=BLEND_ALPHA,
):
    """jit(scan(shard_map-hybrid)) — built once per static config."""
    inner = _hybrid_program(
        mesh, shard_size, k, c, rrf_k, block_size, kernel, presorted,
        max_run, interpret, n_docs_true, False, fusion, blend_alpha,
    )

    def run(doc_emb, qbs, pdis, pws, rescore, q8s):
        def body(carry, xs):
            q, di, w, q8 = xs
            vals, ids = inner(doc_emb, q, di, w, rescore, q8)
            return carry, (vals, ids)

        _, (vals, ids) = jax.lax.scan(
            body, jnp.int32(0), (qbs, pdis, pws, q8s)
        )
        return vals, ids

    return jax.jit(run)


def sharded_hybrid_filtered_topk(
    mesh: Mesh,
    doc_emb: jax.Array,
    queries: jax.Array,  # (B, D)
    plan_doc_ids: jax.Array,  # (S, B, Pw) MASK-AWARE per-shard plans
    plan_weights: jax.Array,  # (S, B, Pw)
    doc_mask: jax.Array,  # (G, N_padded) bool, corpus-sharded; padding False
    groups: jax.Array,  # (B,) int32 mask row per query (data-sharded)
    k: int,
    *,
    candidates_per_arm: Optional[int] = None,
    c_fetch: Optional[int] = None,  # per-shard dense over-fetch width
    rrf_k: float = RRF_K,
    fusion: str = "zblend",
    blend_alpha: float = BLEND_ALPHA,
    block_size: int = 4096,
    kernel: str = "xla",
    presorted: bool = False,
    max_run: int = 0,
    rescore: Optional[jax.Array] = None,
    queries_i8: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Filtered sharded hybrid, one device program (the multi-chip analogue
    of ``HybridRetriever._make_fused_filtered`` — docs/specs/filtered-search.md):

    - BM25 arm: the split plans are already mask-aware (masked docs never
      reached them), so the per-shard reduction is unchanged;
    - dense arm: each shard over-fetches ``c_fetch`` unfiltered candidates,
      gathers its LOCAL slice of the query's OWN mask row at the candidate
      ids (flat index ``group * shard_size + local_id``; corpus padding is
      mask-False, which subsumes the padding clamp), and rank-compacts the
      survivors to ``c`` with scores (``mask_compact_ranked_vals``);
    - the compacted per-shard survivor lists all-gather and merge exactly
      like the unfiltered program; per-shard survivor counts all-gather to
      every chip so the HOST can run the starvation check.

    Per-query filters ride as ONE int per query (``groups``) against the
    (G, N) resident mask stack — never a (B, N) operand. Returns (vals
    (B, k), ids (B, k), survivors (S, B) int32). Exact whenever every
    shard's pool holds >= min(c, shard_unmasked[group]) survivors; the
    caller re-runs starved queries through
    :func:`sharded_dense_topk_masked` + the mask-aware BM25 arm."""
    c = candidates_per_arm or k
    cf = c_fetch or c
    n_docs = doc_emb.shape[0]
    n_shards = mesh.shape[CORPUS_AXIS]
    assert n_docs % n_shards == 0
    shard_size = n_docs // n_shards
    if kernel == "int8":
        assert rescore is not None and queries_i8 is not None
    else:
        rescore = jnp.zeros((n_shards, queries.shape[1]), queries.dtype)
        queries_i8 = jnp.zeros(queries.shape, jnp.int8)
    f = _hybrid_filtered_program(
        mesh, shard_size, k, c, cf, float(rrf_k), block_size, kernel,
        presorted, max_run, platform.interpret(), fusion, float(blend_alpha),
    )
    return f(
        doc_emb, queries, groups, plan_doc_ids, plan_weights, rescore,
        queries_i8, doc_mask,
    )


@functools.lru_cache(maxsize=64)
def _hybrid_filtered_program(
    mesh, shard_size, k, c, c_fetch, rrf_k, block_size, kernel, presorted,
    max_run, interpret, fusion="zblend", blend_alpha=BLEND_ALPHA,
):
    from openintel_tpu.ops.bm25 import bm25_topk_device
    from openintel_tpu.ops.fusion import mask_compact_ranked_vals

    def local(emb_local, q_local, g_local, ids_local, w_local, rs_local,
              q8_local, mask_local):
        shard = jax.lax.axis_index(CORPUS_AXIS)
        d_vals, d_ids = _local_dense_topk(
            emb_local, q_local, c_fetch, kernel, block_size, interpret,
            rescore_local=rs_local, q_i8_local=q8_local, candidates=c_fetch,
        )
        # each query row gathers its OWN mask row's local slice: flat index
        # group * shard_size + local_id into the (G, shard_size) slice
        mask_flat = mask_local.reshape(-1)
        flat_ix = g_local[:, None] * shard_size + jnp.maximum(d_ids, 0)
        keep = jnp.take(mask_flat, flat_ix) & (d_ids >= 0)
        cvals, cids, surv = mask_compact_ranked_vals(d_ids, d_vals, keep, c)
        d_gids = jnp.where(cids >= 0, cids + shard * shard_size, -1)
        b_vals, b_lids = bm25_topk_device(
            ids_local[0], w_local[0], shard_size, c,
            presorted=presorted, max_run=max_run,
        )
        b_gids = jnp.where(b_lids >= 0, b_lids + shard * shard_size, -1)
        b_vals = jnp.where(b_lids >= 0, b_vals, -jnp.inf)
        d_vals_g = jax.lax.all_gather(cvals, CORPUS_AXIS)
        d_ids_g = jax.lax.all_gather(d_gids, CORPUS_AXIS)
        b_vals_g = jax.lax.all_gather(b_vals, CORPUS_AXIS)
        b_ids_g = jax.lax.all_gather(b_gids, CORPUS_AXIS)
        d_mvals, d_top = _merge_gathered(d_vals_g, d_ids_g, c)
        b_mvals, b_top = _merge_gathered(b_vals_g, b_ids_g, c)
        vals, ids = _fuse_device(
            fusion, b_mvals, b_top, d_mvals, d_top, k, rrf_k, blend_alpha
        )
        surv_g = jax.lax.all_gather(surv, CORPUS_AXIS)  # (S, B)
        return vals, ids, surv_g

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
                P(DATA_AXIS),
                P(CORPUS_AXIS, DATA_AXIS, None),
                P(CORPUS_AXIS, DATA_AXIS, None),
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
                P(None, CORPUS_AXIS),
            ),
            out_specs=(
                P(DATA_AXIS, None),
                P(DATA_AXIS, None),
                P(None, DATA_AXIS),
            ),
            check_vma=False,
        )
    )


def sharded_dense_topk_masked(
    mesh: Mesh,
    doc_op: jax.Array,  # (N, D) stored-precision rows
    queries: jax.Array,  # (B, D) f32
    doc_mask: jax.Array,  # (N_padded,) bool, corpus-sharded
    k: int,
    *,
    block_size: int = 4096,
) -> tuple[jax.Array, jax.Array]:
    """EXACT masked brute-force dense top-k over the sharded corpus — the
    starved-query fallback arm of the filtered sharded hybrid. Each shard
    scans its full local slice with the mask applied in-block
    (``dense_topk_xla_masked``), then the k-sized survivor lists
    all-gather and merge. For the int8 path pass the rescore rows as
    ``doc_op`` (same stored-doc x f32-query scores as the rescore stage).
    (0.0, -1) padding contract."""
    n_docs = doc_op.shape[0]
    n_shards = mesh.shape[CORPUS_AXIS]
    assert n_docs % n_shards == 0
    f = _dense_masked_program(mesh, n_docs // n_shards, k, block_size)
    return f(doc_op, queries, doc_mask)


@functools.lru_cache(maxsize=64)
def _dense_masked_program(mesh, shard_size, k, block_size):
    from openintel_tpu.ops.dense import dense_topk_xla_masked

    def local(op_local, q_local, mask_local):
        shard = jax.lax.axis_index(CORPUS_AXIS)
        vals, ids = dense_topk_xla_masked(
            op_local, q_local, mask_local, k, block_size
        )
        gids = jnp.where(ids >= 0, ids + shard * shard_size, -1)
        vals = jnp.where(ids >= 0, vals, -jnp.inf)
        vals_g = jax.lax.all_gather(vals, CORPUS_AXIS)
        ids_g = jax.lax.all_gather(gids, CORPUS_AXIS)
        mvals, mids = _merge_gathered(vals_g, ids_g, k)
        pad = mids < 0
        return jnp.where(pad, 0.0, mvals), mids

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(CORPUS_AXIS, None),
                P(DATA_AXIS, None),
                P(CORPUS_AXIS),
            ),
            out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
            check_vma=False,
        )
    )


def global_bm25_stats(mesh: Mesh, local_df: jax.Array, local_len_sum: jax.Array,
                      local_n_docs: jax.Array):
    """psum-reduce per-shard df / doc-length sums into corpus-wide stats
    (used at index-build time so every shard scores with global idf)."""

    def local(df, len_sum, n):
        df_g = jax.lax.psum(df, CORPUS_AXIS)
        len_g = jax.lax.psum(len_sum, CORPUS_AXIS)
        n_g = jax.lax.psum(n, CORPUS_AXIS)
        return df_g, len_g, n_g

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(CORPUS_AXIS, None), P(CORPUS_AXIS), P(CORPUS_AXIS)),
        out_specs=(P(None, None), P(None), P(None)),
        check_vma=False,
    )
    return f(local_df, local_len_sum, local_n_docs)
