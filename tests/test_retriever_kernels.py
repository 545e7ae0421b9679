"""Single-device HybridRetriever dense-path passthrough: the served config
must be able to run both dense paths — in particular the int8 candidate
pass + exact rescore that bench.py measures (the benchmarked config and the
served config must be the same thing) — and the fused multi-batch device
program must chunk long query lists correctly."""

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
from openintel_tpu.models.retrievers import DenseRetriever, HybridRetriever

N, D = 600, 64


@pytest.fixture(scope="module")
def corpus():
    docs = synthetic_token_corpus(N, vocab_size=400, seed=11)
    postings = build_postings_index(docs)
    dense = DenseIndex.from_embeddings(synthetic_embeddings(N, dim=D, seed=12))
    embedder = HashingEmbedder(dim=D)
    return docs, postings, dense, embedder


def _recall(got, want):
    return np.mean(
        [
            len({i for i in got.ids[b] if i >= 0} & {i for i in want.ids[b] if i >= 0})
            / max((want.ids[b] >= 0).sum(), 1)
            for b in range(got.ids.shape[0])
        ]
    )


def test_kernel_passthrough_int8(corpus):
    """HybridRetriever(kernel="int8") runs the served dense arm (int8
    candidates + exact rescore; interpret mode on CPU hosts) end to end:
    the fused one-dispatch program must equal the same arms composed by
    hand (BM25 + int8 dense + device RRF)."""
    import jax.numpy as jnp

    from openintel_tpu.models.retrievers import BM25Retriever
    from openintel_tpu.ops.fusion import rrf_fuse_device

    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 5, seed=13)
    # fusion="rrf": rank fusion keeps the hand composition exactly
    # order-stable, isolating the KERNEL plumbing under test (z-blend's
    # fused-program parity is covered by test_fusion + the oracle tests)
    got = HybridRetriever(
        postings, dense, embedder, kernel="int8", fusion="rrf"
    ).search(queries, k=10, candidates_per_arm=20)
    lex = BM25Retriever(postings).search(queries, k=20)
    dn = DenseRetriever(dense, embedder, kernel="int8").search(queries, k=20)
    _, ids = rrf_fuse_device(jnp.asarray(lex.ids), jnp.asarray(dn.ids), 10)
    np.testing.assert_array_equal(got.ids, np.asarray(ids))
    assert got.ids.shape == (5, 10)


def test_kernel_property_reports_dense_arm(corpus):
    _, postings, dense, embedder = corpus
    h = HybridRetriever(postings, dense, embedder, kernel="int8")
    assert h.kernel == "int8"
    assert HybridRetriever(postings, dense, embedder).kernel == "xla"  # CPU auto


def test_dense_retriever_auto_default_cpu(corpus):
    _, _, dense, embedder = corpus
    assert DenseRetriever(dense, embedder).kernel == "xla"
    assert DenseRetriever(dense, embedder, kernel="xla").kernel == "xla"
    assert DenseRetriever(dense, embedder, kernel="int8").kernel == "int8"


def test_fused_multibatch_chunks_match_single_batch(corpus):
    """A query list longer than device_batch scans over sub-batches inside
    ONE device program; results must equal the single-batch run."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 23, seed=14)  # 23 % 8 != 0
    big = HybridRetriever(postings, dense, embedder, kernel="xla")
    chunked = HybridRetriever(
        postings, dense, embedder, kernel="xla", device_batch=8
    )
    want = big.search(queries, k=10, candidates_per_arm=20)
    got = chunked.search(queries, k=10, candidates_per_arm=20)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_search_prepared_is_the_search_path(corpus):
    """bench.py drives search_prepared directly; it must equal search()."""
    docs, postings, dense, embedder = corpus
    from openintel_tpu.ops.bm25 import encode_query

    queries = synthetic_queries_from_docs(docs, 4, seed=15)
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    want = h.search(queries, k=10, candidates_per_arm=20)
    term_ids = [encode_query(postings, q) for q in queries]
    emb = embedder(list(queries))
    got = h.search_prepared(term_ids, emb, k=10, candidates_per_arm=20)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)


def test_empty_query_list(corpus):
    _, postings, dense, embedder = corpus
    res = HybridRetriever(postings, dense, embedder).search([], k=7)
    assert res.ids.shape == (0, 7)


def test_rebatch_preserves_results(corpus):
    """rebatch() re-chunks a PreparedBatch without rebuilding the plan;
    results must be identical to the original chunking."""
    docs, postings, dense, embedder = corpus
    from openintel_tpu.ops.bm25 import encode_query

    queries = synthetic_queries_from_docs(docs, 16, seed=16)
    h = HybridRetriever(postings, dense, embedder, kernel="xla", device_batch=16)
    term_ids = [encode_query(postings, q) for q in queries]
    prep = h.prepare(term_ids, embedder(list(queries)), k=10, candidates_per_arm=20)
    want = h.run_prepared(prep)
    got = h.run_prepared(h.rebatch(prep, 4))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)


def test_prepare_empty_batch(corpus):
    _, postings, dense, embedder = corpus
    h = HybridRetriever(postings, dense, embedder, kernel="xla")
    prep = h.prepare([], np.zeros((0, D), np.float32), k=5)
    res = h.run_prepared(prep)
    assert res.ids.shape == (0, 5)


def test_kernel_passthrough_int8_zblend_default_pairing(corpus):
    """The served GPU pairing is kernel=int8 + fusion=zblend (bench.py
    defaults) — cover it against the hand-composed arms fused through the
    device z-blend. Unlike rrf (rank-only), z-blend consumes the dense arm's
    SCORES, so this pins that the int8 path feeds exact-rescored f32
    values into fusion (a regression to pre-rescore quantised scores would
    reorder the blend and fail here while every rrf test stays green)."""
    import jax.numpy as jnp

    from openintel_tpu.models.retrievers import BM25Retriever
    from openintel_tpu.ops.fusion import zblend_fuse_device

    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 5, seed=16)
    got = HybridRetriever(
        postings, dense, embedder, kernel="int8", fusion="zblend"
    ).search(queries, k=10, candidates_per_arm=20)
    lex = BM25Retriever(postings).search(queries, k=20)
    dn = DenseRetriever(dense, embedder, kernel="int8").search(queries, k=20)
    _, ids = zblend_fuse_device(
        jnp.asarray(lex.scores), jnp.asarray(lex.ids),
        jnp.asarray(dn.scores), jnp.asarray(dn.ids), 10,
    )
    np.testing.assert_array_equal(got.ids, np.asarray(ids))
    # and the dense scores the blend consumed are the EXACT f32 cosines of
    # the candidates, not quantised int8 approximations
    emb_q = np.asarray(embedder(list(queries)), np.float32)
    emb_d = np.asarray(dense.embeddings, np.float32)
    for b in range(5):
        for j, doc in enumerate(dn.ids[b]):
            if doc < 0:
                continue
            exact = float(emb_q[b] @ emb_d[doc])
            np.testing.assert_allclose(dn.scores[b, j], exact, rtol=2e-5,
                                       atol=2e-5)
