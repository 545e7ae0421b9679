"""ShardedHybridRetriever: the servable multi-chip component must load a
saved index, shard it over the virtual mesh, and return results bit-identical
to the single-chip retrievers — including on awkward shapes (corpus not
divisible by shards, batch not divisible by the data axis)."""

import jax
import numpy as np
import pytest

from openintel_tpu.index.build import build_postings_index
from openintel_tpu.index.checkpoint import save_dense, save_postings
from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_queries_from_docs,
    synthetic_token_corpus,
)
from openintel_tpu.models.embedding import HashingEmbedder
from openintel_tpu.models.retrievers import (
    BM25Retriever,
    DenseRetriever,
    HybridRetriever,
)
from openintel_tpu.parallel.retriever import ShardedHybridRetriever

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

N, D = 1000, 64  # deliberately NOT divisible by 8 -> corpus padding path


@pytest.fixture(scope="module")
def corpus():
    docs = synthetic_token_corpus(N, vocab_size=500, seed=2)
    postings = build_postings_index(docs)
    dense = DenseIndex.from_embeddings(synthetic_embeddings(N, dim=D, seed=4))
    embedder = HashingEmbedder(dim=D)
    return docs, postings, dense, embedder


@pytest.fixture(scope="module")
def sharded(corpus):
    _, postings, dense, embedder = corpus
    return ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128,
    )


def test_hybrid_matches_single_chip(corpus, sharded):
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 5, seed=3)  # 5 % data(2) != 0
    got = sharded.search(queries, k=10, candidates_per_arm=20)
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=10, candidates_per_arm=20
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_bm25_mode_matches_single_chip(corpus, sharded):
    docs, postings, _, _ = corpus
    queries = synthetic_queries_from_docs(docs, 6, seed=7)
    got = sharded.search(queries, k=10, mode="bm25")
    want = BM25Retriever(postings).search(queries, k=10)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_dense_mode_matches_single_chip(corpus, sharded):
    docs, _, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 6, seed=8)
    got = sharded.search(queries, k=10, mode="dense")
    want = DenseRetriever(dense, embedder, kernel="xla").search(
        queries, k=10
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_corpus_padding_never_surfaces(corpus, sharded):
    """1000 docs pad to 8 shards; padded ids must never appear in results."""
    docs, *_ = corpus
    queries = synthetic_queries_from_docs(docs, 8, seed=9)
    for mode in ("hybrid", "bm25", "dense"):
        res = sharded.search(queries, k=10, mode=mode)
        assert res.ids.max() < N
        # -1 padding is contiguous at the tail of each row
        for row in res.ids:
            neg = np.flatnonzero(row < 0)
            if neg.size:
                assert (row[neg[0] :] < 0).all()


def test_load_roundtrip(tmp_path, corpus):
    docs, postings, dense, embedder = corpus
    prefix = str(tmp_path / "idx")
    save_postings(postings, f"{prefix}.postings.npz")
    save_dense(dense, f"{prefix}.dense.npz")
    sr = ShardedHybridRetriever.load(
        prefix, embedder, data=1, corpus=8, kernel="xla", block_size=128
    )
    queries = synthetic_queries_from_docs(docs, 4, seed=11)
    got = sr.search(queries, k=5)
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=5, candidates_per_arm=5
    )
    np.testing.assert_array_equal(got.ids, want.ids)


def test_single_device_mesh_degenerates(corpus):
    """The component is mesh-generic: a 1x1 mesh must work (single chip)."""
    docs, postings, dense, embedder = corpus
    sr = ShardedHybridRetriever(
        postings, dense, embedder, data=1, corpus=1, kernel="xla",
        block_size=128,
    )
    queries = synthetic_queries_from_docs(docs, 3, seed=12)
    got = sr.search(queries, k=10, candidates_per_arm=20)
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=10, candidates_per_arm=20
    )
    np.testing.assert_array_equal(got.ids, want.ids)


def test_pruned_plans_stay_exact(corpus):
    """Impact pruning through the sharded component keeps exact top-k
    (the global-plan-split carries the pruning exactness argument over)."""
    docs, postings, dense, embedder = corpus
    sr = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128, max_postings_per_term=64,
    )
    queries = synthetic_queries_from_docs(docs, 6, seed=13)
    got = sr.search(queries, k=10, mode="bm25")
    want = BM25Retriever(postings).search(queries, k=10)
    np.testing.assert_array_equal(got.ids, want.ids)


def test_cli_search_mesh_end_to_end(tmp_path, capsys):
    """query -> report through the public CLI with --mesh (VERDICT item 2)."""
    import json

    from openintel_tpu.cli.main import main

    corpus_file = tmp_path / "corpus.txt"
    corpus_file.write_text(
        "the quick brown fox\n"
        "lazy dogs sleep all day\n"
        "market analysis of tech stocks\n"
        "foxes and dogs living together\n"
    )
    code = main(
        ["index", str(corpus_file), "--out", str(tmp_path / "idx"), "--dim", "64"]
    )
    capsys.readouterr()
    assert code == 0
    code = main(
        [
            "search", "quick fox", "--index", str(tmp_path / "idx"),
            "-k", "2", "--format", "json", "--mesh", "2x4",
        ]
    )
    out = capsys.readouterr().out
    assert code == 0
    doc = json.loads(out)
    assert doc[0]["hits"][0]["doc_id"] == 0
    assert "quick brown fox" in doc[0]["hits"][0]["text"]

    # single-chip result must agree with the mesh-served one
    code = main(
        [
            "search", "quick fox", "--index", str(tmp_path / "idx"),
            "-k", "2", "--format", "json",
        ]
    )
    out_single = capsys.readouterr().out
    assert code == 0
    assert json.loads(out_single)[0]["hits"] == doc[0]["hits"]

    code = main(
        [
            "search", "nonsense", "--index", str(tmp_path / "idx"),
            "--mesh", "bogus",
        ]
    )
    out = capsys.readouterr().out
    assert code == 1 and "error: --mesh" in out


def test_mcp_search_corpus_mesh(tmp_path):
    """search_corpus through the MCP composition root with a mesh."""
    import asyncio

    from openintel_tpu.cli.main import main
    from openintel_tpu.mcp.server import build_server

    corpus_file = tmp_path / "corpus.txt"
    corpus_file.write_text(
        "the quick brown fox\n"
        "lazy dogs sleep all day\n"
        "market analysis of tech stocks\n"
        "foxes and dogs living together\n"
    )
    assert main(
        ["index", str(corpus_file), "--out", str(tmp_path / "idx"), "--dim", "64"]
    ) == 0
    server = build_server(
        offline=True, index=str(tmp_path / "idx"), mesh="2x4"
    )
    assert any(t["name"] == "search_corpus" for t in server.tool_specs)
    out = asyncio.run(
        server.call_tool(
            "search_corpus", {"queries": ["quick fox"], "k": 2, "mode": "hybrid"}
        )
    )
    assert out["results"][0]["hits"][0]["doc_id"] == 0
    for mode in ("bm25", "dense"):
        out = asyncio.run(
            server.call_tool(
                "search_corpus", {"queries": ["lazy dogs"], "k": 2, "mode": mode}
            )
        )
        assert out["results"][0]["hits"], mode


def test_empty_and_mismatch_guards(corpus):
    _, postings, dense, embedder = corpus
    sr = ShardedHybridRetriever(
        postings, dense, embedder, data=1, corpus=8, kernel="xla",
        block_size=128,
    )
    res = sr.search([], k=10)
    assert res.ids.shape == (0, 10)
    small = DenseIndex.from_embeddings(
        synthetic_embeddings(N - 1, dim=D, seed=4)
    )
    with pytest.raises(ValueError, match="disagree"):
        ShardedHybridRetriever(postings, small, embedder, data=1, corpus=8)


def test_int8_kernel_sharded_hybrid_and_dense(corpus):
    """The served int8 path (int8 candidates + per-shard exact rescore)
    through the sharded component: near-exact vs single-chip (the candidate
    pass is approximate by design; rescore restores exact scoring)."""
    docs, postings, dense, embedder = corpus
    sr = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="int8",
    )
    queries = synthetic_queries_from_docs(docs, 5, seed=23)
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=10, candidates_per_arm=20
    )
    got = sr.search(queries, k=10, candidates_per_arm=20)
    rec = np.mean([
        len({i for i in got.ids[b] if i >= 0} & {i for i in want.ids[b] if i >= 0})
        / max((want.ids[b] >= 0).sum(), 1)
        for b in range(5)
    ])
    assert rec >= 0.9, rec
    assert got.ids.max() < N  # corpus padding (1000 -> 65536) never surfaces

    got_d = sr.search(queries, k=10, mode="dense")
    want_d = DenseRetriever(dense, embedder, kernel="xla").search(
        queries, k=10
    )
    rec_d = np.mean([
        len(set(got_d.ids[b]) & set(want_d.ids[b])) / 10 for b in range(5)
    ])
    assert rec_d >= 0.9, rec_d
    # rescored scores are exact where ids agree
    m = got_d.ids == want_d.ids
    np.testing.assert_allclose(
        got_d.scores[m], want_d.scores[m], rtol=1e-4, atol=1e-5
    )


def test_cli_mesh_plus_rerank_compose(tmp_path, capsys):
    """--mesh and --rerank compose: the cross-encoder second stage runs
    host-side over the mesh-merged candidates (closing the round-1 README
    gap 'reranker not part of the sharded path')."""
    import json

    from openintel_tpu.cli.main import main

    corpus_file = tmp_path / "corpus.txt"
    corpus_file.write_text(
        "the quick brown fox\n"
        "lazy dogs sleep all day\n"
        "market analysis of tech stocks\n"
        "foxes and dogs living together\n"
    )
    assert main(
        [
            "train", str(corpus_file), "--out", str(tmp_path / "ck"),
            "--steps", "2", "--dim", "32", "--depth", "1", "--heads", "2",
            "--batch-size", "4", "--reranker",
        ]
    ) == 0
    capsys.readouterr()
    assert main(
        ["index", str(corpus_file), "--out", str(tmp_path / "idx"), "--dim", "64"]
    ) == 0
    capsys.readouterr()
    code = main(
        [
            "search", "quick fox", "--index", str(tmp_path / "idx"),
            "-k", "2", "--format", "json", "--mesh", "2x4",
            "--rerank", str(tmp_path / "ck"),
        ]
    )
    out = capsys.readouterr().out
    assert code == 0
    doc = json.loads(out)
    hits = doc[0]["hits"]
    assert hits and all(0 <= h["doc_id"] < 4 for h in hits)


def test_scan_path_matches_per_batch(corpus):
    """Requests beyond device_batch queries run the scanned one-dispatch
    sharded program; results must be identical to the single-dispatch
    path on the same queries."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 11, seed=31)  # 11 % 2 != 0
    big = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128, device_batch=256,
    )
    small = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128, device_batch=4,
    )
    want = big.search(queries, k=10, candidates_per_arm=20)
    got = small.search(queries, k=10, candidates_per_arm=20)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_explicit_int8_kernel_auto_interprets_on_cpu(corpus):
    """kernel='int8' on a CPU host runs the kernel in interpret mode, as
    the platform module decides, instead of failing to lower it."""
    from openintel_tpu import platform

    docs, postings, dense, embedder = corpus
    sr = ShardedHybridRetriever(
        postings, dense, embedder, data=1, corpus=4, kernel="int8"
    )
    assert platform.interpret() is True
    res = sr.search(synthetic_queries_from_docs(docs, 3, seed=41), k=5)
    assert res.ids.shape == (3, 5)


def test_scan_path_int8_interpret(corpus):
    """The scanned one-dispatch sharded program composed with the
    int8 kernel (interpret mode): shapes/ids sane and
    consistent with the per-batch int8 path."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 9, seed=51)
    per_batch = ShardedHybridRetriever(
        postings, dense, embedder, data=1, corpus=4, kernel="int8",
        device_batch=256,
    )
    scanned = ShardedHybridRetriever(
        postings, dense, embedder, data=1, corpus=4, kernel="int8",
        device_batch=4,
    )
    want = per_batch.search(queries, k=8, candidates_per_arm=16)
    got = scanned.search(queries, k=8, candidates_per_arm=16)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


# ------------------------- filtered (masked) search -------------------------
# The strong contract (docs/specs/filtered-search.md): the sharded filtered
# surface is bit-identical to the single-chip filtered surface, which the
# single-chip suite proves equal to the host oracle.


def _mask_half(seed=41):
    rng = np.random.default_rng(seed)
    return rng.random(N) < 0.5


def test_filtered_hybrid_matches_single_chip(corpus, sharded):
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 5, seed=43)
    mask = _mask_half()
    got = sharded.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=10, candidates_per_arm=20, filter_mask=mask
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_filtered_bm25_mode_matches_single_chip(corpus, sharded):
    docs, postings, _, _ = corpus
    queries = synthetic_queries_from_docs(docs, 4, seed=44)
    mask = _mask_half(45)
    got = sharded.search(queries, k=10, mode="bm25", filter_mask=mask)
    want = BM25Retriever(postings).search(queries, k=10, filter_mask=mask)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_filtered_dense_mode_matches_single_chip(corpus, sharded):
    docs, _, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 4, seed=46)
    mask = _mask_half(47)
    got = sharded.search(queries, k=10, mode="dense", filter_mask=mask)
    want = DenseRetriever(dense, embedder, kernel="xla").search(
        queries, k=10, filter_mask=mask
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)


def test_filtered_starvation_fallback_sharded(corpus, sharded):
    """7 unmasked docs spread across shards: every shard's pool starves,
    the exact masked fallback runs, and the result still equals the
    single-chip filtered surface exactly."""
    from openintel_tpu.models.retrievers import make_filter_mask

    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 5, seed=48)
    keep = [3, 130, 260, 390, 520, 650, 999]
    mask = make_filter_mask(N, include_ids=keep)
    got = sharded.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=10, candidates_per_arm=20, filter_mask=mask
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    assert set(got.ids[got.ids >= 0].ravel().tolist()) <= set(keep)


def test_filtered_multibatch_chunks_match(corpus):
    """Filtered hybrid over several device sub-batches (bounded dispatch
    loop) equals one big batch."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 11, seed=49)
    mask = _mask_half(50)
    big = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128,
    )
    small = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128, device_batch=4,
    )
    want = big.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    got = small.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_filtered_int8_sharded_no_leaks(corpus):
    """Quantised kernel on the filtered sharded path (interpret mode):
    masked docs never surface, unmasked ranking is non-empty, and the
    starvation fallback keeps tiny include-lists exact."""
    from openintel_tpu.models.retrievers import make_filter_mask

    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 4, seed=51)
    r = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="int8",
        block_size=128,
    )
    mask = _mask_half(52)
    res = r.search(queries, k=10, candidates_per_arm=20, filter_mask=mask)
    kept = res.ids[res.ids >= 0]
    assert kept.size and np.all(mask[kept])

    keep = [10, 200, 500, 800]
    m2 = make_filter_mask(N, include_ids=keep)
    res2 = r.search(queries, k=10, filter_mask=m2)
    for row in res2.ids:
        assert set(row[row >= 0].tolist()) == set(keep)


# ----------------------------- per-query filters (mask groups), sharded
# Contract: the sharded grouped surface is bit-identical to the single-chip
# grouped surface (itself proven per-query equal to single-mask searches in
# tests/test_filtered_search.py). The (G, N) mask stack shards with the
# corpus; each query carries one mask row index.


def _group_masks(seed=61):
    from openintel_tpu.models.retrievers import make_filter_mask

    rng = np.random.default_rng(seed)
    return np.stack([
        rng.random(N) < 0.5,
        rng.random(N) < 0.25,
        make_filter_mask(N, include_ids=[3, 130, 260, 390, 520, 650, 999]),
    ])


def test_grouped_hybrid_matches_single_chip(corpus, sharded):
    """Mixed selectivity in one batch — including a 7-doc group that
    starves every shard (exact per-group fallback)."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 7, seed=62)
    masks = _group_masks()
    groups = np.arange(7, dtype=np.int32) % 3
    got = sharded.search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    want = HybridRetriever(postings, dense, embedder, kernel="xla").search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_grouped_bm25_mode_matches_single_chip(corpus, sharded):
    docs, postings, _, _ = corpus
    queries = synthetic_queries_from_docs(docs, 6, seed=63)
    masks = _group_masks(64)
    groups = np.arange(6, dtype=np.int32) % 3
    got = sharded.search(
        queries, k=10, mode="bm25", filter_mask=masks, filter_group=groups
    )
    want = BM25Retriever(postings).search(
        queries, k=10, filter_mask=masks, filter_group=groups
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_grouped_dense_mode_matches_single_chip(corpus, sharded):
    docs, _, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 6, seed=65)
    masks = _group_masks(66)
    groups = np.arange(6, dtype=np.int32) % 3
    got = sharded.search(
        queries, k=10, mode="dense", filter_mask=masks, filter_group=groups
    )
    want = DenseRetriever(dense, embedder, kernel="xla").search(
        queries, k=10, filter_mask=masks, filter_group=groups
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)


def test_grouped_multibatch_matches_big(corpus):
    """Grouped filters across several bounded sub-batches equal one big
    dispatch (the group vector slices with the query batch)."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 11, seed=67)
    masks = _group_masks(68)[:2]  # skip the starving group here
    groups = np.arange(11, dtype=np.int32) % 2
    big = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128,
    )
    small = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="xla",
        block_size=128, device_batch=4,
    )
    want = big.search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    got = small.search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_grouped_int8_sharded_no_leaks(corpus):
    """Quantised kernel on the grouped sharded path (interpret mode): no
    query ever surfaces a doc its OWN group masked."""
    docs, postings, dense, embedder = corpus
    queries = synthetic_queries_from_docs(docs, 4, seed=69)
    r = ShardedHybridRetriever(
        postings, dense, embedder, data=2, corpus=4, kernel="int8",
        block_size=128,
    )
    masks = _group_masks(70)
    groups = np.array([0, 1, 2, 0], np.int32)
    res = r.search(
        queries, k=10, candidates_per_arm=20,
        filter_mask=masks, filter_group=groups,
    )
    for b in range(4):
        kept = res.ids[b][res.ids[b] >= 0]
        assert kept.size and np.all(masks[groups[b]][kept])


def test_search_with_arms_parity(corpus, sharded):
    """search_with_arms: the fused result equals search(), and each arm
    ranking equals the corresponding single-arm mode — all from ONE
    dispatch (the sharded live corpus's fused hybrid path)."""
    docs, *_ = corpus
    queries = synthetic_queries_from_docs(docs, 5, seed=21)
    fused, (bv, bi), (dv, di) = sharded.search_with_arms(
        queries, k=10, candidates_per_arm=20
    )
    want = sharded.search(queries, k=10, candidates_per_arm=20)
    np.testing.assert_array_equal(fused.ids, want.ids)
    # z-blend fused scores: the arms program is a different HLO, so
    # f32 mean/var reduction order wobbles ~1e-7
    np.testing.assert_allclose(fused.scores, want.scores, rtol=1e-4, atol=1e-5)
    wb = sharded.search(queries, k=20, mode="bm25")
    np.testing.assert_array_equal(bi, wb.ids)
    np.testing.assert_allclose(bv, wb.scores, rtol=1e-5, atol=1e-6)
    wd = sharded.search(queries, k=20, mode="dense")
    np.testing.assert_array_equal(di, wd.ids)
    np.testing.assert_allclose(dv, wd.scores, rtol=1e-5, atol=1e-6)
