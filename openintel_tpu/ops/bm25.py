"""BM25 device scoring: host query-plan gather -> device sort + segmented scan.

Split of labour (SURVEY.md §7):
- the HOST does the irregular pointer-chasing it is good at: per query term,
  slice the CSR postings (contiguous memcpy) and assemble a padded, static-
  shape "query plan" of (doc_id, weight) pairs where
  weight = idf(term) * qtf * impact  (impact = precomputed saturated tf);
- the DEVICE reduces the plan with fixed-shape vector ops ONLY — no scatter
  (the design answered an accelerator on which XLA scatter serialized;
  whether a scatter or segment sum wins on a GPU is an open ROADMAP item)
  and no dense (B, N) score matrix. Instead:
    1. sort each row's (doc_id, weight) pairs by doc id (``lax.sort``, two
       operands);
    2. per-doc totals via a segmented-sum ``associative_scan`` (the combine
       keeps sums within equal-doc runs, so precision matches sequential
       accumulation — no prefix-difference cancellation);
    3. the score of each doc sits at its run's last position; mask the rest
       and ``top_k`` over the plan width (not the corpus!).

Ranking contract: BM25 rankings contain only docs matching at least one query
term (scores are strictly positive); short rankings pad with id -1 / score 0.
Ties break by ascending doc id (sorted order + top_k's first-occurrence rule).

Plan widths are bucketed to powers of two (min 512) so jit recompiles are
bounded. The tf/idf saturation is fused into the index at build time
(openintel_tpu/index/schema.py), so query time is gather-scale-reduce only.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from openintel_tpu.index.schema import PostingsIndex
from openintel_tpu.ops.tokenizer import tokenize

# Host float, NOT jnp.float32(...): a module-level device scalar would
# initialize jax's backend at import time. Library import must never touch
# a backend.
NEG_INF = float(-jnp.inf)


@dataclass
class QueryPlan:
    """Static-shape batched postings for a query batch."""

    doc_ids: np.ndarray  # (B, P) int32; padding rows point at n_docs (sentinel)
    weights: np.ndarray  # (B, P) float32; padding weight 0
    n_docs: int
    presorted: bool = False  # rows ascending by doc id (host-sorted)
    max_terms: int = 0  # max distinct terms per query = max equal-doc run (0 = unknown)


def _bucket(width: int, minimum: int = 512) -> int:
    """Round a plan width up to the next bucket: powers of two plus their
    1.5x midpoints (512, 768, 1024, 1536, 2048, ...). Device cost is linear
    in the padded width, so pure power-of-two buckets waste up to 2x work
    right above a boundary (the production config's ~4.5k-wide plans were
    paying for 8192); midpoints cap the waste at ~33% while keeping the jit
    cache bounded (2 classes per octave)."""
    p = minimum
    while True:
        if width <= p:
            return p
        if width <= p + p // 2:
            return p + p // 2
        p *= 2


def encode_query(index: PostingsIndex, text: str) -> list[int]:
    """Tokenise query text into term ids over the index vocabulary (unknown
    tokens drop out — they can never score)."""
    get = index.vocab.token_to_id.get
    return [tid for tok in tokenize(text) if (tid := get(tok, 0))]


def build_query_plan(
    index: PostingsIndex,
    queries_term_ids: Sequence[Sequence[int]],
    *,
    max_postings_per_term: int | None = None,
    include_multi_term: bool = True,
    multi_budget: int = 256,
    sort: bool = True,
    use_native: bool = True,
    doc_mask: np.ndarray | None = None,
    n_threads: int = 0,  # native planner threads; 0 = hardware concurrency
) -> QueryPlan:
    """Assemble the padded (doc_id, weight) plan for a batch of queries.

    ``doc_mask`` (bool (n_docs,)) builds a FILTERED plan: masked docs never
    enter it, so the device reduction natively searches the filtered corpus
    (weights keep full-corpus idf — the filter restricts candidates, it does
    not re-normalise the index). Pruning stays EXACT on the filtered corpus:
    each term keeps its top-M *unmasked* impacts (the impact-descending
    permutation walked under the mask — identical (-impact, doc asc)
    tie-breaking as the unfiltered path), and multi-term forcing scores only
    unmasked docs, so the pruned-exactness argument above holds verbatim
    with "corpus" read as "filtered corpus". Filtered pruned plans route
    through the C++ planner too (planner.cpp ``plan_build_masked``, same
    candidate sets — asserted in tests); this NumPy path is the reference
    and the no-toolchain fallback.

    ``max_postings_per_term`` enables impact-ordered pruning: each term
    contributes only its top-M postings by impact (bounds the plan width for
    stop-wordy terms at corpus scale).

    ``include_multi_term`` (with pruning on) additionally forces the top
    ``multi_budget`` docs matching >= 2 distinct query terms — ranked by
    their TRUE BM25 score, computed on the host from the postings overlap —
    into the plan. This makes pruned retrieval EXACT for top-k with
    k <= min(M, multi_budget): a true top-k single-term doc is within the
    top-k impacts of its term (any higher-impact posting outscores it
    outright), and a true top-k multi-term doc is within the top-k
    multi-term docs by true score. Pruning therefore bounds device work
    without a recall cliff; the only cost is a host-side linear pass over
    the query terms' postings (the C++ plan builder's job at scale).

    ``sort`` (default) orders each row by doc id on the HOST — rows are
    concatenations of per-term already-sorted runs, so this is a cheap merge
    for np.sort's adaptive run detection — letting the device skip its
    bitonic ``lax.sort`` entirely (the dominant cost at width >= 4096, and a
    compile-time cliff). The sentinel padding (doc id = n_docs) sorts last by
    construction.

    ``use_native`` routes pruned plans through the C++ builder
    (native/planner.cpp — identical candidate sets, ~20x faster per query)
    when the shared library is built; the NumPy path below is the reference
    implementation and the fallback."""
    if doc_mask is not None:
        doc_mask = np.asarray(doc_mask, dtype=bool)
        if doc_mask.shape != (index.n_docs,):
            raise ValueError(
                f"doc_mask shape {doc_mask.shape} != ({index.n_docs},)"
            )

    def _postings(t: int) -> tuple[np.ndarray, np.ndarray]:
        ids, imp = index.postings(t)
        if doc_mask is None:
            return ids, imp
        keep = doc_mask[ids]
        return ids[keep], imp[keep]

    def _pruned(t: int, m: int) -> tuple[np.ndarray, np.ndarray]:
        if doc_mask is None:
            return index.pruned_postings(t, m)
        # top-m UNMASKED postings by impact: walk the impact-descending
        # permutation under the mask (same tie-breaking as pruned_postings)
        order = index.ensure_impact_order()
        lo = int(index.term_offsets[t])
        hi = int(index.term_offsets[t + 1])
        sel = order[lo:hi]
        sel = sel[doc_mask[index.doc_ids[sel]]][:m]
        return index.doc_ids[sel], index.impact[sel]

    if use_native and sort and max_postings_per_term is not None:
        from openintel_tpu import native

        res = native.native_build_query_plan(
            index,
            queries_term_ids,
            max_postings_per_term,
            multi_budget if include_multi_term else 0,
            n_threads=n_threads,
            doc_mask=doc_mask,
        )
        if res is not None:
            out_ids, out_w, max_terms, max_width = res
            width = _bucket(max(max_width, 1))
            if width <= out_ids.shape[1]:
                out_ids, out_w = out_ids[:, :width], out_w[:, :width]
            else:
                pad = width - out_ids.shape[1]
                out_ids = np.pad(out_ids, ((0, 0), (0, pad)), constant_values=index.n_docs)
                out_w = np.pad(out_w, ((0, 0), (0, pad)))
            return QueryPlan(
                doc_ids=np.ascontiguousarray(out_ids),
                weights=np.ascontiguousarray(out_w),
                n_docs=index.n_docs,
                presorted=True,
                max_terms=max_terms,
            )

    rows_ids: list[np.ndarray] = []
    rows_w: list[np.ndarray] = []
    n_term_slots = index.term_offsets.shape[0] - 1
    max_terms = 1
    for terms in queries_term_ids:
        qtf: dict[int, int] = {}
        for t in terms:
            if 0 < t < n_term_slots:  # drop padding + out-of-vocab ids
                qtf[t] = qtf.get(t, 0) + 1
        max_terms = max(max_terms, len(qtf))
        prune = (
            max_postings_per_term is not None
            and any(index.df[t] > max_postings_per_term for t in qtf)
        )
        multi_docs = None
        if prune and include_multi_term and len(qtf) > 1:
            term_data = {t: _postings(int(t)) for t in qtf}
            alldocs = np.concatenate([term_data[t][0] for t in qtf])
            sd = np.sort(alldocs)
            multi_docs = np.unique(sd[1:][sd[1:] == sd[:-1]])
            if multi_docs.size > multi_budget:
                # exact host scoring of the multi-term docs, keep the top
                # multi_budget by true score (exactness argument above)
                mscores = np.zeros(multi_docs.size, np.float64)
                for t, count in qtf.items():
                    fids, fimp = term_data[t]
                    if fids.size == 0:  # df=0 under a shared cross-shard vocab
                        continue
                    pos = np.minimum(
                        np.searchsorted(fids, multi_docs), fids.size - 1
                    )
                    hit = fids[pos] == multi_docs
                    mscores[hit] += fimp[pos[hit]] * (
                        float(index.idf[t]) * count
                    )
                # ties: score desc then doc asc — matches planner.cpp exactly
                keep = np.lexsort((multi_docs, -mscores))[:multi_budget]
                multi_docs = np.sort(multi_docs[keep])
        parts_ids = []
        parts_w = []
        for t, count in qtf.items():
            if prune:
                ids, impacts = _pruned(int(t), max_postings_per_term)
                if multi_docs is not None and multi_docs.size:
                    fids, fimp = term_data[t]  # fetched during multi scoring
                    forced = np.flatnonzero(
                        np.isin(fids, multi_docs, assume_unique=True)
                    )
                    keep = np.union1d(ids, fids[forced])
                    sel = np.searchsorted(fids, keep)
                    ids, impacts = keep.astype(np.int32), fimp[sel]
            else:
                ids, impacts = _postings(int(t))
            parts_ids.append(ids)
            parts_w.append(impacts * (float(index.idf[t]) * count))
        if parts_ids:
            rows_ids.append(np.concatenate(parts_ids))
            rows_w.append(np.concatenate(parts_w).astype(np.float32))
        else:
            rows_ids.append(np.zeros(0, np.int32))
            rows_w.append(np.zeros(0, np.float32))

    width = _bucket(max((len(r) for r in rows_ids), default=1))
    b = len(rows_ids)
    doc_ids = np.full((b, width), index.n_docs, dtype=np.int32)  # sentinel row
    weights = np.zeros((b, width), dtype=np.float32)
    for i, (ids, w) in enumerate(zip(rows_ids, rows_w)):
        doc_ids[i, : len(ids)] = ids
        weights[i, : len(w)] = w
    if sort:
        order = np.argsort(doc_ids, axis=1, kind="stable")
        doc_ids = np.take_along_axis(doc_ids, order, axis=1)
        weights = np.take_along_axis(weights, order, axis=1)
    return QueryPlan(
        doc_ids=doc_ids,
        weights=weights,
        n_docs=index.n_docs,
        presorted=sort,
        max_terms=max_terms,
    )


def bm25_topk_device(
    doc_ids: jax.Array,  # (B, P) int32 with sentinel n_docs padding
    weights: jax.Array,  # (B, P) f32
    n_docs: int,
    k: int,
    presorted: bool = False,
    max_run: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Scatter-free BM25 top-k: sort by doc id, segmented-sum, reduce.

    ``presorted`` skips the device sort when rows are already ascending by
    doc id (``build_query_plan(..., sort=True)``) — the production path; the
    width-P bitonic sort dominates both run and compile time otherwise.

    ``max_run`` bounds the longest equal-doc run: a doc appears at most once
    per query term, so runs are <= the number of distinct terms
    (``QueryPlan.max_terms``). The Hillis-Steele segmented scan below then
    needs only ceil(log2(max_run)) shift steps (2-3 in practice) instead of
    log2(P) — and unlike ``lax.associative_scan`` (recursive slicing; 4-minute
    compiles and a pathological standalone schedule at P=8192, measured) it
    lowers to a handful of cheap pad/slice/where ops. 0 means unbounded.

    Returns (vals (B, k) f32, ids (B, k) i32); rows with fewer than k matching
    docs pad with (0.0, -1)."""
    # normalise max_run to a power of two BEFORE the jit cache lookup: runs of
    # 5..8 etc. trace to byte-identical programs, so don't compile them apart
    p = int(doc_ids.shape[1])
    run = max_run if 0 < max_run <= p else p
    norm = 1
    while norm < run:
        norm *= 2
    return _bm25_topk_device_jit(
        doc_ids, weights, n_docs, k, presorted, min(norm, p)
    )


@partial(jax.jit, static_argnames=("n_docs", "k", "presorted", "max_run"))
def _bm25_topk_device_jit(doc_ids, weights, n_docs, k, presorted, max_run):
    if presorted:
        d, w = doc_ids, weights
    else:
        d, w = jax.lax.sort((doc_ids, weights), num_keys=1, dimension=1)

    p = d.shape[1]
    run = max_run if 0 < max_run <= p else p
    # Segmented inclusive scan (Hillis-Steele): rows are sorted, so
    # d[i-s] == d[i] implies one run covers [i-s, i]; after the j-th step each
    # element holds the sum of up to 2^(j+1) run elements ending at it.
    seg = w
    shift = 1
    while shift < run:
        d_prev = jnp.pad(d, ((0, 0), (shift, 0)), constant_values=-1)[:, :p]
        s_prev = jnp.pad(seg, ((0, 0), (shift, 0)))[:, :p]
        seg = seg + jnp.where(d_prev == d, s_prev, 0.0)
        shift *= 2
    nxt = jnp.concatenate([d[:, 1:], jnp.full_like(d[:, :1], -2)], axis=1)
    is_last = d != nxt  # last element of each equal-doc run holds the total
    masked = jnp.where(is_last & (d < n_docs) & (seg > 0.0), seg, NEG_INF)
    vals, sel = jax.lax.top_k(masked, min(k, masked.shape[1]))
    ids = jnp.take_along_axis(d, sel, axis=1)
    if k > masked.shape[1]:  # plan narrower than k: pad columns
        padw = k - masked.shape[1]
        vals = jnp.concatenate(
            [vals, jnp.full((vals.shape[0], padw), NEG_INF)], axis=1
        )
        ids = jnp.concatenate([ids, jnp.full((ids.shape[0], padw), 0, ids.dtype)], axis=1)
    pad = vals == NEG_INF
    return jnp.where(pad, 0.0, vals), jnp.where(pad, -1, ids).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_docs",))
def bm25_scores_device(
    doc_ids: jax.Array,  # (B, P) int32 with sentinel n_docs padding
    weights: jax.Array,  # (B, P) f32
    n_docs: int,
) -> jax.Array:
    """Dense (B, N) scores via scatter-add. Exact, but it materialises (B, N)
    scores — use only for small corpora and as a test oracle; the production
    path is :func:`bm25_topk_device`."""
    b = doc_ids.shape[0]
    scores = jnp.zeros((b, n_docs + 1), dtype=jnp.float32)
    scores = scores.at[
        jnp.arange(b, dtype=jnp.int32)[:, None], doc_ids
    ].add(weights, mode="drop")
    return scores[:, :n_docs]


def bm25_topk(
    index: PostingsIndex, queries_term_ids: Sequence[Sequence[int]], k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing batched BM25 top-k (plan on host, reduce on device)."""
    plan = build_query_plan(index, queries_term_ids)
    vals, ids = bm25_topk_device(
        plan.doc_ids,
        plan.weights,
        plan.n_docs,
        k,
        presorted=plan.presorted,
        max_run=plan.max_terms,
    )
    return np.asarray(vals), np.asarray(ids)
