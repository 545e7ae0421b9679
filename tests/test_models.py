"""Retriever model families: build, search, hybrid recall, checkpoint round-trip."""

import numpy as np

from openintel_tpu.index.checkpoint import (
    load_dense,
    load_postings,
    save_dense,
    save_postings,
)
from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import (
    synthetic_postings_index,
    synthetic_queries_from_docs,
    synthetic_token_corpus,
)
from openintel_tpu.models.embedding import HashingEmbedder
from openintel_tpu.models.retrievers import (
    BM25Retriever,
    DenseRetriever,
    HybridRetriever,
)
from openintel_tpu.ops import reference as ref
from openintel_tpu.ops.bm25 import encode_query

DOCS = synthetic_token_corpus(300, vocab_size=800, seed=11)
QUERIES = synthetic_queries_from_docs(DOCS, 6, seed=12)


def test_hashing_embedder_is_deterministic_and_normalized():
    e1 = HashingEmbedder(dim=64)(["hello world", "hello world", "other text"])
    e2 = HashingEmbedder(dim=64)(["hello world"])
    np.testing.assert_allclose(e1[0], e1[1], atol=0)
    np.testing.assert_allclose(e1[0], e2[0], atol=0)
    np.testing.assert_allclose(np.linalg.norm(e1, axis=1), 1.0, rtol=1e-5)
    assert not np.allclose(e1[0], e1[2])


def test_bm25_retriever_matches_reference():
    r = BM25Retriever.build(DOCS)
    res = r.search(QUERIES, k=5)
    for b, q in enumerate(QUERIES):
        rv, ri = ref.bm25_topk(r.index, encode_query(r.index, q), 5)
        np.testing.assert_array_equal(res.ids[b], ri)
        np.testing.assert_allclose(res.scores[b], rv, rtol=1e-5, atol=1e-6)


def test_dense_retriever_self_retrieval():
    r = DenseRetriever.build(DOCS, dim=64)
    res = r.search(DOCS[:5], k=1)
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(5))


def test_hybrid_matches_reference_composition():
    h = HybridRetriever.build(DOCS, dim=64)
    res = h.search(QUERIES, k=5, candidates_per_arm=10)
    q_emb = h.dense.embedder(QUERIES)
    for b, q in enumerate(QUERIES):
        rv, ri = ref.hybrid_topk(
            h.bm25.index,
            np.asarray(h.dense.index.embeddings, np.float32),
            encode_query(h.bm25.index, q),
            q_emb[b],
            5,
            candidates_per_arm=10,
        )
        np.testing.assert_array_equal(res.ids[b], ri)
        np.testing.assert_allclose(res.scores[b], rv, rtol=1e-4, atol=1e-5)


def test_hybrid_recall_beats_or_matches_single_arms():
    """Hybrid recall@10 on target-doc retrieval: sanity that fusion helps."""
    h = HybridRetriever.build(DOCS, dim=64)
    res = h.search(QUERIES, k=10, candidates_per_arm=20)
    lex = h.bm25.search(QUERIES, k=10)
    # every query was sampled from a source doc; hybrid should keep lexical hits
    hits_h = sum(1 for b in range(len(QUERIES)) if len(set(res.ids[b]) & set(lex.ids[b])))
    assert hits_h == len(QUERIES)


def test_postings_checkpoint_roundtrip(tmp_path):
    r = BM25Retriever.build(DOCS)
    save_postings(r.index, tmp_path / "postings.npz")
    loaded = load_postings(tmp_path / "postings.npz")
    q = encode_query(loaded, QUERIES[0])
    np.testing.assert_allclose(
        ref.bm25_scores(loaded, q), ref.bm25_scores(r.index, q), atol=0
    )
    assert loaded.n_docs == r.index.n_docs
    assert loaded.avgdl == r.index.avgdl
    assert loaded.vocab.token_to_id == r.index.vocab.token_to_id


def test_dense_checkpoint_roundtrip_bf16(tmp_path):
    import jax.numpy as jnp

    emb = HashingEmbedder(dim=32)(DOCS[:50])
    idx = DenseIndex.from_embeddings(emb, dtype=jnp.bfloat16.dtype)
    save_dense(idx, tmp_path / "dense.npz")
    loaded = load_dense(tmp_path / "dense.npz")
    assert loaded.n_docs == 50 and loaded.dim == 32
    np.testing.assert_array_equal(
        np.asarray(loaded.embeddings).view(np.uint16),
        np.asarray(idx.embeddings).view(np.uint16),
    )


def test_synthetic_postings_index_is_consistent():
    idx = synthetic_postings_index(2000, vocab_size=500, seed=3)
    assert idx.n_docs == 2000
    assert idx.term_offsets[-1] == idx.nnz
    # postings sorted ascending per term, ids in range
    for t in (1, 2, 10, 100):
        ids, imp = idx.postings(t)
        assert (np.diff(ids) > 0).all()
        assert ids.max(initial=0) < 2000
        assert (imp > 0).all()
    # scoring works end to end
    vals, ids = ref.bm25_topk(idx, [1, 2, 3], 10)
    assert (vals >= 0).all()


def test_load_dense_rejects_mismatched_matrix(tmp_path):
    """Meta/matrix pairs must validate on load: a stale .emb.npy paired with
    newer meta is rejected, not silently reinterpreted."""
    import numpy as np
    import pytest

    from openintel_tpu.index.checkpoint import load_dense, save_dense
    from openintel_tpu.index.schema import DenseIndex

    idx = DenseIndex.from_embeddings(
        np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    )
    save_dense(idx, tmp_path / "d.npz")
    # overwrite the matrix with a wrong-shape one (simulated stale pair)
    np.save(tmp_path / "d.emb.tmp.npy", np.zeros((10, 8), np.float32))
    (tmp_path / "d.emb.tmp.npy").rename(tmp_path / "d.emb.npy")
    with pytest.raises(ValueError, match="stale/mismatched"):
        load_dense(tmp_path / "d.npz")

    # bf16 meta paired with an f32 matrix: itemsize check
    import ml_dtypes

    idx16 = DenseIndex(
        embeddings=idx.embeddings.astype(ml_dtypes.bfloat16),
        n_docs=20, dim=8,
    )
    save_dense(idx16, tmp_path / "e.npz")
    np.save(tmp_path / "e.emb.tmp.npy", np.zeros((20, 8), np.float32))
    (tmp_path / "e.emb.tmp.npy").rename(tmp_path / "e.emb.npy")
    with pytest.raises(ValueError, match="stale/mismatched"):
        load_dense(tmp_path / "e.npz")


def test_dense_retriever_int8_kernel_matches_xla():
    """kernel="int8" (int8 candidates + exact rescore) must agree with the
    exact XLA path on ids for a well-separated corpus."""
    import numpy as np

    from openintel_tpu.index.schema import DenseIndex
    from openintel_tpu.index.synthetic import (
        synthetic_embeddings,
        synthetic_query_embeddings,
    )
    from openintel_tpu.models.retrievers import DenseRetriever

    emb = synthetic_embeddings(2000, dim=64, seed=30)
    q, _ = synthetic_query_embeddings(emb, 7, seed=31)
    idx = DenseIndex.from_embeddings(emb)
    r8 = DenseRetriever(idx, kernel="int8")
    rx = DenseRetriever(idx, kernel="xla")
    got = r8.search_embeddings(q, k=10)
    want = rx.search_embeddings(q, k=10)
    # candidate pass is approximate; overlap must be near-total and scores
    # exact where ids agree (rescore is exact f32)
    overlap = np.mean([
        len(set(got.ids[i]) & set(want.ids[i])) / 10 for i in range(7)
    ])
    assert overlap >= 0.95, overlap
    match = got.ids == want.ids
    np.testing.assert_allclose(
        got.scores[match], want.scores[match], rtol=1e-5, atol=1e-6
    )


def test_auto_pruning_preserves_topk(monkeypatch):
    """Above the corpus-size threshold, retrievers default to impact-pruned
    plans; results must equal the unpruned ranking (scores exact, boundary
    ties excepted)."""
    import numpy as np

    from openintel_tpu.index.build import build_postings_index
    from openintel_tpu.index.synthetic import (
        synthetic_queries_from_docs,
        synthetic_token_corpus,
    )
    from openintel_tpu.models import retrievers as R

    docs = synthetic_token_corpus(3000, vocab_size=300, seed=88)
    r = R.BM25Retriever(build_postings_index(docs))
    queries = synthetic_queries_from_docs(docs, 8, seed=89)
    want = r.search(queries, k=10)  # 3000 docs < threshold: unpruned
    monkeypatch.setattr(R, "AUTO_PRUNE_DOCS", 100)
    got = r.search(queries, k=10)  # now auto-pruned at M=128
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)
    for b in range(8):
        boundary = want.scores[b, -1]
        tol = 1e-6 + 1e-5 * abs(boundary)
        must = {
            int(i)
            for i, v in zip(want.ids[b], want.scores[b])
            if i >= 0 and v > boundary + tol
        }
        assert must <= {int(i) for i in got.ids[b]}


def test_postings_checkpoint_pair_token_detects_stale_pair(tmp_path):
    """A crash between the vocab-sidecar rename and the npz rename leaves a
    new sidecar beside old arrays; when term counts happen to match, the
    size check alone passes — the pair token must reject it (review
    finding). Legacy flat sidecars (no token) still load."""
    import json
    import shutil

    import pytest

    from openintel_tpu.index.build import build_postings_index
    from openintel_tpu.index.checkpoint import load_postings, save_postings

    # two corpora with the SAME unique-term count but different postings
    a = build_postings_index([f"alpha{i} beta{i}" for i in range(20)])
    b = build_postings_index([f"gamma{i} delta{i}" for i in range(20)])
    save_postings(a, tmp_path / "a.npz")
    save_postings(b, tmp_path / "b.npz")
    assert a.vocab.size == b.vocab.size
    # crash window: b's (new) sidecar beside a's (old) arrays
    shutil.copy(tmp_path / "b.vocab.json", tmp_path / "a.vocab.json")
    with pytest.raises(ValueError, match="pair token"):
        load_postings(tmp_path / "a.npz")

    # legacy flat sidecar still loads (pre-pair-token checkpoints)
    save_postings(a, tmp_path / "c.npz")
    side = json.loads((tmp_path / "c.vocab.json").read_text())
    (tmp_path / "c.vocab.json").write_text(json.dumps(side["token_to_id"]))
    loaded = load_postings(tmp_path / "c.npz")
    assert loaded.vocab.size == a.vocab.size
