"""The int8 candidate pass: the GPU kernel (interpret mode here) against its
plain-XLA reference, bit for bit, and the reference against the NumPy oracle.

The compiled kernel runs on the card through ``python chip_smoke.py``; the
``gpu``-marked test below is its pytest form and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_query_embeddings,
)
from openintel_tpu.ops import reference as ref
from openintel_tpu.ops.dense import (
    LANES,
    SUPER_DOCS,
    exact_rescore,
    int8_corpus,
    int8_group,
    int8_merge_topk,
    int8_super_top2_xla,
    int8_topk_xla,
    quantize_int8,
)
from openintel_tpu.ops.pallas.int8_topk import int8_span_top2, int8_topk


def _recall(ids, ref_ids):
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    return np.mean(
        [
            len(set(map(int, ids[i])) & set(map(int, ref_ids[i]))) / ids.shape[1]
            for i in range(ids.shape[0])
        ]
    )


def _problem(n, b, dim, seed):
    emb = synthetic_embeddings(n, dim=dim, seed=seed)
    q, _ = synthetic_query_embeddings(emb, b, seed=seed + 1)
    return emb, q, jnp.asarray(int8_corpus(emb)), jnp.asarray(quantize_int8(q))


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# Pairwise cover of n_docs x batch x group, with k inside and beyond the
# candidate buffer (2 * n_groups * 128 keys).
@pytest.mark.parametrize(
    "n, b, group, k",
    [
        (1, 1, 1, 10),
        (1, 64, 3, 300),
        (16384, 1, 3, 32),
        (16384, 31, 8, 20),
        (16385, 64, 1, 40),
        (16385, 257, 8, 600),
        (3 * 16384 + 17, 31, 1, 32),
        (3 * 16384 + 17, 257, 3, 700),
        (3 * 16384 + 17, 1, 8, 256),
    ],
)
def test_int8_kernel_matches_reference(n, b, group, k):
    _, _, c8, q8 = _problem(n, b, 64, seed=n % 97 + b)
    got = int8_topk(c8, q8, k=k, n_docs=n, group=group, interpret=True)
    want = int8_topk_xla(c8, q8, k=k, n_docs=n, group=group)
    _assert_same(got, want)
    ids = np.asarray(got[1])
    assert ids.shape == (b, k)
    for row in ids:
        real = row[row >= 0]
        assert len(real) == len(set(real.tolist())), "duplicate candidate"
        assert real.size == 0 or real.max() < n, "padding doc leaked"
    n_super = -(-n // SUPER_DOCS)
    width = 2 * -(-n_super // group) * LANES
    if k > width:  # beyond the buffer: (0.0, -1) padded columns
        assert (ids[:, width:] == -1).all()
        assert (np.asarray(got[0])[:, width:] == 0.0).all()


@pytest.mark.parametrize("span", [2, 16, 128])
def test_int8_kernel_span_does_not_change_result(span):
    """The merge sees every split of a super into spans the same way."""
    n = 2 * 16384 + 5
    _, _, c8, q8 = _problem(n, 9, 32, seed=11)
    keys = int8_span_top2(c8, q8, n_docs=n, interpret=True, span=span)
    assert keys.shape == (9, 3, 2 * 128 // span, LANES)
    got = int8_merge_topk(keys, k=64, n_docs=n, group=2)
    _assert_same(got, int8_topk_xla(c8, q8, k=64, n_docs=n, group=2))


def test_int8_kernel_pads_dim_and_batch():
    """D = 40 (not a multiple of 16) and a batch far from the query tile."""
    n = 700
    _, _, c8, q8 = _problem(n, 5, 40, seed=3)
    got = int8_topk(c8, q8, k=12, n_docs=n, group=1, interpret=True)
    _assert_same(got, int8_topk_xla(c8, q8, k=12, n_docs=n, group=1))


def test_int8_kernel_rejects_partial_super():
    c8 = jnp.zeros((SUPER_DOCS + 128, 32), jnp.int8)
    with pytest.raises(ValueError, match="whole supers"):
        int8_span_top2(c8, c8[:2], n_docs=10, interpret=True)


def test_int8_tie_across_supers_goes_to_lower_super():
    """Three docs with one vector in supers 0, 1 and 2 at the same lane and
    position have equal keys; with all three in one group, the top-2 of
    that (lane, group) must be the two lower supers."""
    n = 3 * SUPER_DOCS
    emb = synthetic_embeddings(n, dim=32, seed=8)
    a = 3 * LANES + 5  # lane 5, position 3
    twins = [a, SUPER_DOCS + a, 2 * SUPER_DOCS + a]
    emb[twins] = emb[a]
    c8 = jnp.asarray(int8_corpus(emb))
    q8 = jnp.asarray(quantize_int8(emb[a : a + 1]))
    got = int8_topk(c8, q8, k=8, n_docs=n, group=4, interpret=True)
    _assert_same(got, int8_topk_xla(c8, q8, k=8, n_docs=n, group=4))
    ids = np.asarray(got[1])[0].tolist()
    assert ids[:2] == twins[:2]
    assert twins[2] not in ids


@pytest.mark.parametrize("n, group", [(600, 1), (40_000, 2), (40_000, 4)])
def test_int8_reference_plus_rescore_matches_oracle(n, group):
    """Plain candidates + exact rescore recover the exact cosine top-10."""
    emb, q, c8, q8 = _problem(n, 7, 64, seed=21)
    _, cids = int8_topk_xla(c8, q8, k=32, n_docs=n, group=group)
    _, rids = exact_rescore(jnp.asarray(emb), jnp.asarray(q), cids, 10)
    _, ref_ids = ref.cosine_topk(emb, q, 10)
    assert _recall(rids, ref_ids) >= 0.99


def test_int8_super_keys_decode_to_scores():
    """Each per-super key is score * 128 + bias + position, and the best
    key of a lane is its best doc's int8 score."""
    n = 300
    emb, q, c8, q8 = _problem(n, 2, 32, seed=5)
    keys = np.asarray(int8_super_top2_xla(c8, q8, n_docs=n))
    s = quantize_int8(q).astype(np.int64) @ quantize_int8(emb).astype(np.int64).T
    for lane in (0, 7, 127):
        members = np.arange(lane, n, LANES)
        best = members[np.argmax(s[0, members])]
        key = int(keys[0, 0, 0, lane])
        assert key & 127 == best // LANES
        assert (key - (key & 127) - 32768 * LANES) // LANES == s[0, best]


def test_int8_group_bounds():
    assert int8_group(1, 32) == 1
    assert int8_group(1_250_000, 32) == 10  # 77 supers in 8 groups
    assert int8_group(1_250_000, 1024) == 5  # one group per 64 candidates
    assert int8_group(60_000_000, 32) <= 255  # int32 packing bound


def test_exact_rescore_handles_padding_ids():
    emb = synthetic_embeddings(100, dim=16, seed=20)
    q, _ = synthetic_query_embeddings(emb, 2, seed=21)
    cand = jnp.asarray([[3, 7, -1, -1], [50, -1, -1, -1]], jnp.int32)
    vals, ids = exact_rescore(jnp.asarray(emb), jnp.asarray(q), cand, 3)
    ids = np.asarray(ids)
    assert set(ids[0]) <= {3, 7, -1}
    assert ids[0][2] == -1 and ids[1][1] == -1


def test_hybrid_int8_serves_k_beyond_capacity():
    """The served surface end-to-end: an int8 HybridRetriever on a
    one-super corpus must answer k/candidates_per_arm beyond the
    candidate buffer."""
    from openintel_tpu.models.retrievers import HybridRetriever

    texts = [f"alpha beta doc{i} gamma{i % 7}" for i in range(600)]
    r = HybridRetriever.build(texts, kernel="int8", dim=64)
    res = r.search(["alpha gamma3"], k=150, candidates_per_arm=300)
    assert res.ids.shape == (1, 150)
    real = res.ids[0][res.ids[0] >= 0]
    assert len(real) == len(set(real))
    assert (real < 600).all()


def test_grouped_kernel_matches_per_super_and_oracle():
    """Candidate pass + rescore recovers the exact top-k at every group
    size, including a tail group (n_super not divisible by group), and the
    super tracking decodes ids correctly across supers."""
    n = 40_000  # pads to 3 supers: group=2 exercises the short tail group
    emb, q, c8, q8 = _problem(n, 7, 64, seed=21)
    _, ref_ids = ref.cosine_topk(emb, q, 10)
    for group in (1, 2, 4):
        _, cids = int8_topk(c8, q8, k=32, n_docs=n, group=group, interpret=True)
        got = np.asarray(cids)
        assert got.max() < n and np.all((got >= 0) | (got == -1))
        _, rids = exact_rescore(jnp.asarray(emb), jnp.asarray(q), cids, 10)
        rec = np.mean(np.asarray(rids) == ref_ids)
        assert rec >= 0.99, (group, rec)


def test_grouped_kernel_clamps_k_beyond_capacity():
    """k beyond 2*ceil(n_super/group)*128 clamps and -1-pads."""
    n = 20_000  # 2 supers; group=2 -> 1 group -> capacity 256
    _, _, c8, q8 = _problem(n, 3, 32, seed=23)
    vals, ids = int8_topk(c8, q8, k=300, n_docs=n, group=2, interpret=True)
    assert ids.shape == (3, 300)
    got = np.asarray(ids)
    assert np.all(got[:, 256:] == -1)
    real = got[:, :256]
    assert np.all((real == -1) | ((real >= 0) & (real < n)))


@pytest.mark.gpu
def test_int8_kernel_compiled_matches_reference():
    """The compiled kernel on the card, bit for bit against the reference."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU form")
    n = 3 * 16384 + 17
    _, _, c8, q8 = _problem(n, 257, 384, seed=1)
    got = int8_topk(c8, q8, k=32, n_docs=n, group=1, interpret=False)
    _assert_same(got, int8_topk_xla(c8, q8, k=32, n_docs=n, group=1))
