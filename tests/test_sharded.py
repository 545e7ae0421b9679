"""Sharded retrieval on a virtual 8-device CPU mesh: cross-shard results must
be bit-identical to single-shard runs (SURVEY.md hard part (d))."""

import jax
import numpy as np
import pytest

from openintel_tpu.index.build import build_postings_index
from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_queries_from_docs,
    synthetic_query_embeddings,
    synthetic_token_corpus,
)
from openintel_tpu.ops import reference as ref
from openintel_tpu.ops.bm25 import build_query_plan, encode_query
from openintel_tpu.parallel.mesh import make_mesh
from openintel_tpu.parallel.retriever import shard_query_plans
from openintel_tpu.parallel.sharded import (
    global_bm25_stats,
    sharded_bm25_topk,
    sharded_dense_topk,
    sharded_hybrid_topk,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

N, D, B, K = 4096, 64, 16, 10


def _dense_fixtures():
    emb = synthetic_embeddings(N, dim=D, seed=0)
    q, _ = synthetic_query_embeddings(emb, B, seed=1)
    return emb, q


def test_sharded_dense_matches_reference():
    emb, q = _dense_fixtures()
    mesh = make_mesh(data=1, corpus=8)
    vals, ids = sharded_dense_topk(mesh, emb, q, K, block_size=256)
    rv, ri = ref.cosine_topk(emb, q, K)
    np.testing.assert_allclose(np.asarray(vals), rv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), ri)


def test_sharded_dense_2x4_mesh_data_parallel_queries():
    emb, q = _dense_fixtures()
    mesh = make_mesh(data=2, corpus=4)
    vals, ids = sharded_dense_topk(mesh, emb, q, K, block_size=256)
    rv, ri = ref.cosine_topk(emb, q, K)
    np.testing.assert_allclose(np.asarray(vals), rv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), ri)


def test_sharded_dense_tiebreak_across_shards():
    # Duplicate the first shard's rows into the last shard: exact score ties
    # across shards must resolve to the lower global doc id.
    emb, _ = _dense_fixtures()
    emb = emb.copy()
    emb[-512:] = emb[:512]
    q = emb[:4]
    mesh = make_mesh(data=1, corpus=8)
    vals, ids = sharded_dense_topk(mesh, emb, q, 2, block_size=256)
    ids = np.asarray(ids)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2, 3])
    np.testing.assert_array_equal(ids[:, 1], [N - 512, N - 511, N - 510, N - 509])


def _sharded_corpus():
    """Build global and per-shard BM25 indexes with a shared vocab + global stats."""
    from openintel_tpu.index.schema import BM25Config
    from openintel_tpu.index.build import bm25_idf, bm25_impact
    import numpy as np

    docs = synthetic_token_corpus(N, vocab_size=3000, seed=2)
    global_idx = build_postings_index(docs)
    shard_size = N // 8
    shard_indexes = []
    for s in range(8):
        sub = docs[s * shard_size : (s + 1) * shard_size]
        idx = build_postings_index(sub, vocab=global_idx.vocab)
        # overwrite local stats with the global ones (what global_bm25_stats
        # computes on device): idf from global df, impacts from global avgdl.
        idx.idf = global_idx.idf
        idx.impact = bm25_impact(
            idx.tf, idx.doc_len[idx.doc_ids], global_idx.avgdl, BM25Config()
        )
        shard_indexes.append(idx)
    return docs, global_idx, shard_indexes, shard_size


def test_sharded_bm25_matches_single_shard():
    docs, global_idx, shard_indexes, shard_size = _sharded_corpus()
    queries = synthetic_queries_from_docs(docs, B, seed=3)
    term_ids = [encode_query(global_idx, q) for q in queries]

    # component-owned per-shard plan assembly (split of the global plan) must
    # carry the same candidates as hand-built per-shard-index plans
    pdi, pw, meta = shard_query_plans(
        global_idx, term_ids, 8, shard_size=shard_size
    )
    plans = [build_query_plan(idx, term_ids) for idx in shard_indexes]
    for s, p in enumerate(plans):
        for b in range(B):
            want = {int(d) for d in p.doc_ids[b] if d < shard_size}
            got = {int(d) for d in pdi[s, b] if d < shard_size}
            assert want == got

    mesh = make_mesh(data=1, corpus=8)
    vals, ids = sharded_bm25_topk(
        mesh, pdi, pw, shard_size, K,
        presorted=meta.presorted, max_run=meta.max_terms,
    )
    from ranking_utils import assert_ranking_close

    for b, tids in enumerate(term_ids):
        rv, ri = ref.bm25_topk(global_idx, tids, K)
        assert_ranking_close(np.asarray(vals)[b], np.asarray(ids)[b], rv, ri)


def test_sharded_hybrid_matches_reference():
    docs, global_idx, shard_indexes, shard_size = _sharded_corpus()
    emb = synthetic_embeddings(N, dim=D, seed=4)
    queries = synthetic_queries_from_docs(docs, B, seed=5)
    term_ids = [encode_query(global_idx, q) for q in queries]
    q_emb, _ = synthetic_query_embeddings(emb, B, seed=6)

    pdi, pw, meta = shard_query_plans(
        global_idx, term_ids, 8, shard_size=shard_size
    )

    mesh = make_mesh(data=1, corpus=8)
    vals, ids = sharded_hybrid_topk(
        mesh, emb, q_emb, pdi, pw, K, candidates_per_arm=2 * K, block_size=256,
        presorted=meta.presorted, max_run=meta.max_terms,
    )
    for b, tids in enumerate(term_ids):
        rv, ri = ref.hybrid_topk(
            global_idx, emb, tids, q_emb[b], K, candidates_per_arm=2 * K
        )
        np.testing.assert_allclose(np.asarray(vals)[b], rv, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(ids)[b], ri)


def test_sharded_hybrid_production_kernel_interpret():
    """The served multi-device program — int8 candidate pass + per-shard
    rescore + presorted bounded-run BM25 — on the virtual mesh
    (interpreter mode). Shards pad to whole supers, as the serving
    component lays them out."""
    from openintel_tpu.ops.dense import SUPER_DOCS, int8_corpus, quantize_int8

    docs, global_idx, shard_indexes, shard_size = _sharded_corpus()
    emb = synthetic_embeddings(N, dim=D, seed=14)
    queries = synthetic_queries_from_docs(docs, B, seed=15)
    term_ids = [encode_query(global_idx, q) for q in queries]
    q_emb, _ = synthetic_query_embeddings(emb, B, seed=16)

    emb_pad = np.zeros((8 * SUPER_DOCS, D), np.float32)
    emb_pad[:N] = emb
    pdi, pw, meta = shard_query_plans(
        global_idx, term_ids, 8, shard_size=SUPER_DOCS
    )

    mesh = make_mesh(data=1, corpus=8)
    vals, ids = sharded_hybrid_topk(
        mesh, int8_corpus(emb_pad), q_emb, pdi, pw, K,
        candidates_per_arm=2 * K, kernel="int8",
        presorted=meta.presorted, max_run=meta.max_terms,
        rescore=emb_pad, queries_i8=quantize_int8(q_emb), n_docs_true=N,
    )
    assert np.asarray(ids).max() < N
    # the int8 candidate pass is approximate; compare by recall
    recs = []
    for b, tids in enumerate(term_ids):
        _, ri = ref.hybrid_topk(
            global_idx, emb, tids, q_emb[b], K, candidates_per_arm=2 * K
        )
        exact = {int(x) for x in ri if x >= 0}
        got = {int(x) for x in np.asarray(ids)[b] if x >= 0}
        if exact:
            recs.append(len(exact & got) / len(exact))
    assert np.mean(recs) >= 0.9, np.mean(recs)


def test_global_stats_psum():
    docs, global_idx, shard_indexes, shard_size = _sharded_corpus()
    mesh = make_mesh(data=1, corpus=8)
    local_df = np.stack([idx.df for idx in shard_indexes])  # (8, V)
    local_len = np.array(
        [idx.doc_len.sum() for idx in shard_indexes], np.float32
    )
    local_n = np.array([idx.n_docs for idx in shard_indexes], np.int32)
    df_g, len_g, n_g = global_bm25_stats(mesh, local_df, local_len, local_n)
    np.testing.assert_array_equal(np.asarray(df_g)[0], global_idx.df)
    assert int(np.asarray(n_g)[0]) == N
    np.testing.assert_allclose(
        float(np.asarray(len_g)[0]) / N, global_idx.avgdl, rtol=1e-6
    )
