"""Filtered (masked) search: every retrieval surface restricted to a doc
subset must rank EXACTLY the filtered corpus under full-corpus statistics.

Reference parity target: metadata-filtered retrieval as in the reference's
corpus search surface; the oracle is ops/reference.py (bm25_topk /
cosine_topk / hybrid_topk with doc_mask). Design: docs/specs/filtered-search.md
— the BM25 arm filters in the PLAN (masked docs never reach the device), the
dense arm over-fetches unfiltered candidates and rank-compacts the survivors,
and a host-side starvation check re-runs under-filled queries through an
exact masked fallback, so exactness holds at ANY selectivity.
"""

import numpy as np
import pytest

from openintel_tpu.index.build import build_postings_index
from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_queries_from_docs,
    synthetic_token_corpus,
)
from openintel_tpu.models.embedding import HashingEmbedder
from openintel_tpu.models.retrievers import (
    FILTER_FETCH_CAP,
    BM25Retriever,
    DenseRetriever,
    HybridRetriever,
    filtered_fetch_width,
    make_filter_mask,
)
from openintel_tpu.ops import reference as ref
from openintel_tpu.ops.bm25 import encode_query

N, D = 600, 64


@pytest.fixture(scope="module")
def corpus():
    docs = synthetic_token_corpus(N, vocab_size=400, seed=21)
    postings = build_postings_index(docs)
    dense = DenseIndex.from_embeddings(synthetic_embeddings(N, dim=D, seed=22))
    embedder = HashingEmbedder(dim=D)
    return docs, postings, dense, embedder


@pytest.fixture(scope="module")
def queries(corpus):
    return synthetic_queries_from_docs(corpus[0], 6, seed=23)


def _half_mask(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.random(n) < 0.5


# ---------------------------------------------------------------- mask build


def test_make_filter_mask_exclude():
    m = make_filter_mask(10, exclude_ids=[0, 2, 4])
    assert m.dtype == np.bool_ and m.shape == (10,)
    assert not m[[0, 2, 4]].any() and m.sum() == 7


def test_make_filter_mask_include_then_exclude():
    m = make_filter_mask(10, include_ids=[1, 3, 5], exclude_ids=[3])
    assert set(np.flatnonzero(m).tolist()) == {1, 5}


def test_make_filter_mask_out_of_range_raises():
    with pytest.raises(ValueError, match="include_ids out of range"):
        make_filter_mask(10, include_ids=[10])
    with pytest.raises(ValueError, match="exclude_ids out of range"):
        make_filter_mask(10, exclude_ids=[-1])


def test_filter_mask_validation(corpus):
    _, postings, _, _ = corpus
    r = BM25Retriever(postings)
    with pytest.raises(TypeError, match="bool"):
        r.search(["a"], filter_mask=np.ones(N, np.int32))
    with pytest.raises(ValueError, match="shape"):
        r.search(["a"], filter_mask=np.ones(N + 1, bool))


def test_filtered_fetch_width_buckets():
    # power-of-two buckets, >= 2c, selectivity-scaled, capped
    assert filtered_fetch_width(10, 1000, 1000) == 64  # min bucket
    assert filtered_fetch_width(10, 1000, 100) == 128  # c/sel = 100 -> 128
    assert filtered_fetch_width(10, 10_000, 10) == FILTER_FETCH_CAP
    assert filtered_fetch_width(10, 1000, 10) == 1000  # n_docs-clamped
    assert filtered_fetch_width(10, 500, 0) == 10  # degenerate empty mask
    assert filtered_fetch_width(2000, 10_000, 10_000) == FILTER_FETCH_CAP


# ---------------------------------------------------------------- BM25 arm


def test_bm25_filtered_matches_oracle(corpus, queries):
    _, postings, _, _ = corpus
    mask = _half_mask(N)
    r = BM25Retriever(postings)
    res = r.search(queries, k=10, filter_mask=mask)
    for b, q in enumerate(queries):
        rv, ri = ref.bm25_topk(postings, encode_query(postings, q), 10, doc_mask=mask)
        np.testing.assert_array_equal(res.ids[b], ri)
        np.testing.assert_allclose(res.scores[b], rv, rtol=1e-5, atol=1e-6)


def test_bm25_filtered_keeps_full_corpus_idf(corpus, queries):
    """Scores of surviving docs must be IDENTICAL to their unfiltered
    scores — the filter restricts candidates, never re-weights."""
    _, postings, _, _ = corpus
    r = BM25Retriever(postings)
    full = r.search(queries, k=50)
    mask = _half_mask(N)
    filt = r.search(queries, k=10, filter_mask=mask)
    for b in range(len(queries)):
        full_scores = dict(zip(full.ids[b].tolist(), full.scores[b].tolist()))
        for i, s in zip(filt.ids[b], filt.scores[b]):
            if i >= 0 and int(i) in full_scores:
                np.testing.assert_allclose(s, full_scores[int(i)], rtol=1e-6)


# ---------------------------------------------------------------- dense arm


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_dense_filtered_matches_oracle(corpus, queries, kernel):
    """DenseRetriever filtered search is the EXACT masked brute-force path
    for every dense path (int8 routes through its stored rescore rows, so
    the masked result is full precision)."""
    _, _, dense, embedder = corpus
    mask = _half_mask(N)
    r = DenseRetriever(dense, embedder, kernel=kernel)
    res = r.search(queries, k=10, filter_mask=mask)
    emb = np.asarray(dense.embeddings, np.float32)
    q_emb = embedder(list(queries))
    rv, ri = ref.cosine_topk(emb, q_emb, 10, doc_mask=mask)
    np.testing.assert_array_equal(res.ids, ri)
    np.testing.assert_allclose(res.scores, rv, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- hybrid


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_hybrid_filtered_matches_oracle(corpus, queries, kernel):
    """The fused filtered program (over-fetch + rank compaction + mask-aware
    BM25 plan + RRF) equals the oracle filtered hybrid exactly for the
    exact-ranking kernels."""
    _, postings, dense, embedder = corpus
    mask = _half_mask(N)
    h = HybridRetriever(postings, dense, embedder, kernel=kernel)
    res = h.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    emb = np.asarray(dense.embeddings, np.float32)
    q_emb = embedder(list(queries))
    for b, q in enumerate(queries):
        rv, ri = ref.hybrid_topk(
            postings, emb, encode_query(postings, q), q_emb[b],
            10, candidates_per_arm=20, doc_mask=mask,
        )
        np.testing.assert_array_equal(res.ids[b], ri)
        np.testing.assert_allclose(res.scores[b], rv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_hybrid_starvation_fallback_exact(corpus, queries, kernel):
    """Selectivity far below c/c_fetch: the over-fetch pool starves and the
    host re-runs those queries through the exact masked fallback. With 7
    unmasked docs and k=10, every ranking must hold exactly the oracle's."""
    _, postings, dense, embedder = corpus
    keep = [3, 50, 111, 222, 333, 444, 555]
    mask = make_filter_mask(N, include_ids=keep)
    h = HybridRetriever(postings, dense, embedder, kernel=kernel)
    res = h.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    emb = np.asarray(dense.embeddings, np.float32)
    q_emb = embedder(list(queries))
    for b, q in enumerate(queries):
        rv, ri = ref.hybrid_topk(
            postings, emb, encode_query(postings, q), q_emb[b],
            10, candidates_per_arm=20, doc_mask=mask,
        )
        np.testing.assert_array_equal(res.ids[b], ri)
        np.testing.assert_allclose(res.scores[b], rv, rtol=1e-4, atol=1e-5)


def test_hybrid_filtered_multibatch_matches_single(corpus):
    """Filtered search over multiple device sub-batches (scan) + padding
    rows equals the single-batch run — the mask rides every sub-batch."""
    docs, postings, dense, embedder = corpus
    qs = synthetic_queries_from_docs(docs, 13, seed=29)  # 13 % 8 != 0
    mask = _half_mask(N, seed=31)
    big = HybridRetriever(postings, dense, embedder, kernel="xla")
    chunked = HybridRetriever(postings, dense, embedder, kernel="xla", device_batch=8)
    want = big.search(qs, k=10, candidates_per_arm=20, filter_mask=mask)
    got = chunked.search(qs, k=10, candidates_per_arm=20, filter_mask=mask)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_hybrid_empty_mask_returns_padding(corpus, queries):
    """All docs masked out: every ranking is pure padding (-1 / 0.0)."""
    _, postings, dense, embedder = corpus
    mask = np.zeros(N, bool)
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    res = h.search(queries[:2], k=5, filter_mask=mask)
    np.testing.assert_array_equal(res.ids, -np.ones((2, 5), np.int32))
    np.testing.assert_array_equal(res.scores, np.zeros((2, 5), np.float32))


def test_hybrid_unfiltered_path_unchanged(corpus, queries):
    """filter_mask=None must take the original fused program — identical
    results and dtypes to a build that never saw the filtered code path."""
    _, postings, dense, embedder = corpus
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    a = h.search(queries, k=10, candidates_per_arm=20)
    b = h.search(queries, k=10, candidates_per_arm=20, filter_mask=None)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)


# ------------------------------------------- per-query filters (mask groups)
# The strong contract: a grouped batch must equal, per query, a separate
# single-mask search with that query's OWN mask — groups change the program
# shape (one (G, N) operand + one int per query), never the semantics.


def _three_masks(n):
    rng = np.random.default_rng(53)
    return np.stack([rng.random(n) < p for p in (0.5, 0.25, 0.75)])


def _groups_for(b):
    return np.arange(b, dtype=np.int32) % 3


def test_group_masks_validation(corpus):
    _, postings, dense, embedder = corpus
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    masks = _three_masks(N)
    with pytest.raises(ValueError, match="filter_group requires"):
        h.search(["a", "b"], filter_mask=masks[0], filter_group=[0, 0])
    with pytest.raises(ValueError, match="filter_group .*required"):
        h.search(["a", "b"], filter_mask=masks)
    with pytest.raises(ValueError, match="length"):
        h.search(["a", "b"], filter_mask=masks, filter_group=[0])
    with pytest.raises(ValueError, match="out of range"):
        h.search(["a", "b"], filter_mask=masks, filter_group=[0, 3])
    with pytest.raises(ValueError, match="requires filter_mask"):
        h.search(["a", "b"], filter_group=[0, 0])
    with pytest.raises(ValueError, match="!= \\(G >= 1"):
        h.search(["a"], filter_mask=masks[:, : N - 1], filter_group=[0])


def test_grouped_single_row_equals_batch_mask(corpus, queries):
    """(1, N) masks without filter_group == the plain (N,) batch mask."""
    _, postings, dense, embedder = corpus
    mask = _half_mask(N)
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    a = h.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    b = h.search(
        queries, k=10, candidates_per_arm=20, filter_mask=mask[None, :]
    )
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6)


def test_bm25_grouped_matches_per_mask(corpus, queries):
    _, postings, _, _ = corpus
    masks, groups = _three_masks(N), _groups_for(len(queries))
    r = BM25Retriever(postings)
    got = r.search(queries, k=10, filter_mask=masks, filter_group=groups)
    for b, q in enumerate(queries):
        want = r.search([q], k=10, filter_mask=masks[groups[b]])
        np.testing.assert_array_equal(got.ids[b], want.ids[0])
        np.testing.assert_allclose(
            got.scores[b], want.scores[0], rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_dense_grouped_matches_per_mask(corpus, queries, kernel):
    _, _, dense, embedder = corpus
    masks, groups = _three_masks(N), _groups_for(len(queries))
    r = DenseRetriever(dense, embedder, kernel=kernel)
    got = r.search(queries, k=10, filter_mask=masks, filter_group=groups)
    for b, q in enumerate(queries):
        want = r.search([q], k=10, filter_mask=masks[groups[b]])
        np.testing.assert_array_equal(got.ids[b], want.ids[0])
        np.testing.assert_allclose(
            got.scores[b], want.scores[0], rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_hybrid_grouped_matches_per_mask(corpus, queries, kernel):
    """One fused dispatch with 3 mask groups == three single-mask searches
    (each already oracle-exact per the tests above)."""
    _, postings, dense, embedder = corpus
    masks, groups = _three_masks(N), _groups_for(len(queries))
    h = HybridRetriever(postings, dense, embedder, kernel=kernel)
    got = h.search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    for b, q in enumerate(queries):
        want = h.search(
            [q], k=10, candidates_per_arm=20, filter_mask=masks[groups[b]]
        )
        np.testing.assert_array_equal(got.ids[b], want.ids[0])
        np.testing.assert_allclose(
            got.scores[b], want.scores[0], rtol=1e-4, atol=1e-5
        )


def test_hybrid_grouped_mixed_starvation(corpus, queries):
    """Groups with wildly different selectivity in ONE batch: the tiny
    include-list group starves (exact fallback), the half-corpus group
    doesn't — each query still equals its own single-mask search."""
    _, postings, dense, embedder = corpus
    masks = np.stack([
        _half_mask(N),
        make_filter_mask(N, include_ids=[3, 50, 111, 222, 333, 444, 555]),
    ])
    groups = np.arange(len(queries), dtype=np.int32) % 2
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    got = h.search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    for b, q in enumerate(queries):
        want = h.search(
            [q], k=10, candidates_per_arm=20, filter_mask=masks[groups[b]]
        )
        np.testing.assert_array_equal(got.ids[b], want.ids[0])
        np.testing.assert_allclose(
            got.scores[b], want.scores[0], rtol=1e-4, atol=1e-5
        )


def test_hybrid_grouped_multibatch_matches_single(corpus):
    """Grouped filters across several device sub-batches + padding rows
    equal the one-batch run (the group vector chunks with the queries)."""
    docs, postings, dense, embedder = corpus
    qs = synthetic_queries_from_docs(docs, 13, seed=33)  # 13 % 4 != 0
    masks, groups = _three_masks(N), _groups_for(13)
    big = HybridRetriever(postings, dense, embedder, kernel="xla")
    chunked = HybridRetriever(
        postings, dense, embedder, kernel="xla", device_batch=4
    )
    want = big.search(
        qs, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    got = chunked.search(
        qs, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_group_masks_reject_float_groups(corpus):
    """A truncating cast would silently apply the wrong tenant's mask."""
    _, postings, dense, embedder = corpus
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    masks = _three_masks(N)
    with pytest.raises(TypeError, match="integers"):
        h.search(
            ["a", "b"], filter_mask=masks, filter_group=[0.9, 1.2]
        )
