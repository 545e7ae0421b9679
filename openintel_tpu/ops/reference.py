"""Pure-NumPy reference scorers — the golden oracle for every device kernel.

Device implementations (XLA and Pallas) are asserted equal to these in tests,
the analogue of the reference's canned-JSON parser-fixture discipline
(SURVEY.md §4). Ranking order is defined here once: descending score, ties
broken by ascending doc id.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from openintel_tpu.index.schema import PostingsIndex

RRF_K = 60.0
BLEND_ALPHA = 0.7  # mirrors ops/fusion.py::BLEND_ALPHA (measured alpha sweep)


def rank_topk(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic top-k: descending score, ties by ascending doc id.

    Accepts (N,) or (B, N); returns (vals, ids) shaped (..., k)."""
    scores = np.asarray(scores)
    single = scores.ndim == 1
    if single:
        scores = scores[None]
    B, N = scores.shape
    k = min(k, N)
    ids = np.empty((B, k), dtype=np.int32)
    vals = np.empty((B, k), dtype=scores.dtype)
    for b in range(B):
        order = np.lexsort((np.arange(N), -scores[b]))[:k]
        ids[b] = order
        vals[b] = scores[b, order]
    if single:
        return vals[0], ids[0]
    return vals, ids


def bm25_scores(
    index: PostingsIndex, query_term_ids: Sequence[int]
) -> np.ndarray:
    """Exact BM25 scores over all docs for one query (term ids, with repeats
    acting as query-tf weights)."""
    scores = np.zeros(index.n_docs, dtype=np.float64)
    qtf: dict[int, int] = {}
    for t in query_term_ids:
        if t > 0:
            qtf[t] = qtf.get(t, 0) + 1
    for t, count in qtf.items():
        ids, impacts = index.postings(t)
        scores[ids] += float(index.idf[t]) * count * impacts.astype(np.float64)
    return scores.astype(np.float32)


def bm25_topk(
    index: PostingsIndex,
    query_term_ids: Sequence[int],
    k: int,
    *,
    doc_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Ranking contract: only docs matching >= 1 query term rank (scores are
    strictly positive); short rankings pad with (0.0, -1).

    ``doc_mask`` (bool (N,)) defines FILTERED search: docs with mask False
    never rank, but scores keep the full-corpus statistics (idf) — the
    filter restricts candidates, it does not re-normalise the index."""
    scores = bm25_scores(index, query_term_ids)
    valid = scores > 0.0
    if doc_mask is not None:
        valid &= np.asarray(doc_mask, dtype=bool)
    masked = np.where(valid, scores, -np.inf)
    vals, ids = rank_topk(masked, k)
    pad = ~np.isfinite(vals)
    return np.where(pad, 0.0, vals), np.where(pad, -1, ids).astype(np.int32)


def cosine_scores(embeddings: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(B, N) cosine scores; both sides are L2-normalised here for safety."""
    e = np.asarray(embeddings, dtype=np.float32)
    q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return q @ e.T


def cosine_topk(
    embeddings: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    doc_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    scores = cosine_scores(embeddings, queries)
    if doc_mask is not None:  # filtered search: masked docs never rank
        scores = np.where(
            np.asarray(doc_mask, dtype=bool)[None, :], scores, -np.inf
        )
    vals, ids = rank_topk(scores, k)
    if doc_mask is not None:  # pad short (over-filtered) rankings
        pad = ~np.isfinite(vals)
        vals = np.where(pad, 0.0, vals).astype(np.float32)
        ids = np.where(pad, -1, ids).astype(np.int32)
    if np.asarray(queries).ndim == 1:  # single query in, single ranking out
        return vals[0], ids[0]
    return vals, ids


def rrf_fuse(
    ids_lists: Sequence[np.ndarray],
    k: int,
    *,
    rrf_k: float = RRF_K,
) -> tuple[np.ndarray, np.ndarray]:
    """Reciprocal-rank fusion of ranked id lists (1-based ranks):
    fused(d) = sum over lists with d at rank r of 1/(rrf_k + r).

    Docs outside every list contribute nothing. Returns (fused_vals, ids) of
    the top-k fused docs, ties by ascending doc id. Input lists are top-k id
    arrays (each (K,) for a single query or (B, K) batched)."""
    lists = [np.asarray(x) for x in ids_lists]
    single = lists[0].ndim == 1
    if single:
        lists = [x[None] for x in lists]
    B = lists[0].shape[0]
    out_ids = []
    out_vals = []
    for b in range(B):
        fused: dict[int, float] = {}
        for lst in lists:
            for r, doc in enumerate(lst[b], start=1):
                doc = int(doc)
                if doc < 0:  # padding from a short ranking
                    continue
                fused[doc] = fused.get(doc, 0.0) + 1.0 / (rrf_k + r)
        docs = np.array(sorted(fused), dtype=np.int64)
        vals = np.array([fused[int(d)] for d in docs], dtype=np.float32)
        order = np.lexsort((docs, -vals))[:k]
        ids = docs[order]
        v = vals[order]
        if len(ids) < k:  # pad with -1 / 0.0 (fewer unique candidates than k)
            ids = np.concatenate([ids, -np.ones(k - len(ids), np.int64)])
            v = np.concatenate([v, np.zeros(k - len(v), np.float32)])
        out_ids.append(ids.astype(np.int32))
        out_vals.append(v)
    ids_arr = np.stack(out_ids)
    vals_arr = np.stack(out_vals)
    if single:
        return vals_arr[0], ids_arr[0]
    return vals_arr, ids_arr


def zblend_fuse(
    vals_a: np.ndarray,
    ids_a: np.ndarray,
    vals_b: np.ndarray,
    ids_b: np.ndarray,
    k: int,
    *,
    alpha: float = BLEND_ALPHA,
) -> tuple[np.ndarray, np.ndarray]:
    """Z-normalised score-blend fusion oracle (mirrors
    ops/fusion.py::zblend_fuse_device): per arm, z-normalise the valid
    (id >= 0) scores; a candidate absent from an arm takes the arm's
    minimum z (0 when the arm is empty); fused = alpha * z_a +
    (1 - alpha) * z_b; ties by ascending doc id. Inputs (K,)/(B, K)."""
    single = np.asarray(ids_a).ndim == 1
    va, ia = np.atleast_2d(vals_a), np.atleast_2d(ids_a)
    vb, ib = np.atleast_2d(vals_b), np.atleast_2d(ids_b)
    out_ids, out_vals = [], []
    for b in range(ia.shape[0]):
        arm_z: list[dict[int, float]] = []
        fills: list[float] = []
        for vals, ids in ((va[b], ia[b]), (vb[b], ib[b])):
            m = ids >= 0
            if m.any():
                v = vals[m].astype(np.float64)
                z = (v - v.mean()) / np.sqrt(v.var() + 1e-6)
                arm_z.append({int(d): float(s) for d, s in zip(ids[m], z)})
                fills.append(float(z.min()))
            else:
                arm_z.append({})
                fills.append(0.0)
        docs = sorted(set(arm_z[0]) | set(arm_z[1]))
        fused = np.array(
            [
                alpha * arm_z[0].get(d, fills[0])
                + (1 - alpha) * arm_z[1].get(d, fills[1])
                for d in docs
            ],
            dtype=np.float32,
        )
        docs_arr = np.array(docs, dtype=np.int64)
        order = np.lexsort((docs_arr, -fused))[:k]
        ids = docs_arr[order]
        v = fused[order]
        if len(ids) < k:
            ids = np.concatenate([ids, -np.ones(k - len(ids), np.int64)])
            v = np.concatenate([v, np.zeros(k - len(v), np.float32)])
        out_ids.append(ids.astype(np.int32))
        out_vals.append(v.astype(np.float32))
    ids_arr, vals_arr = np.stack(out_ids), np.stack(out_vals)
    if single:
        return vals_arr[0], ids_arr[0]
    return vals_arr, ids_arr


def hybrid_topk(
    index: PostingsIndex,
    embeddings: np.ndarray,
    query_term_ids: Sequence[int],
    query_embedding: np.ndarray,
    k: int,
    *,
    candidates_per_arm: int | None = None,
    rrf_k: float = RRF_K,
    fusion: str = "zblend",
    blend_alpha: float = BLEND_ALPHA,
    doc_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Reference hybrid: BM25 top-c + dense top-c -> fuse -> top-k.

    ``fusion`` mirrors HybridRetriever's default (z-normalised score blend
    since the measured A/B; ``"rrf"`` for the rank-only alternative and the
    live-updatable path). With ``doc_mask``, the reference FILTERED hybrid:
    each arm ranks only unmasked docs (full-corpus idf), then fuses — the
    oracle for ``HybridRetriever.search(..., filter_mask=...)``."""
    c = candidates_per_arm or k
    bm_vals, bm_ids = bm25_topk(index, query_term_ids, c, doc_mask=doc_mask)
    dn_vals, dn_ids = cosine_topk(
        embeddings, query_embedding, c, doc_mask=doc_mask
    )
    if fusion == "zblend":
        return zblend_fuse(
            np.asarray(bm_vals, np.float32), bm_ids,
            np.asarray(dn_vals, np.float32), dn_ids,
            k, alpha=blend_alpha,
        )
    return rrf_fuse([bm_ids, dn_ids], k, rrf_k=rrf_k)
