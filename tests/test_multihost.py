"""Two-process jax.distributed demonstration (hermetic, CPU).

SURVEY.md §2.7/§5 "distributed backend": the sharded retrieval programs must
run unchanged when the 8-device mesh spans OS process boundaries — the
multi-controller regime real multi-host GPU clusters serve in. This launches two
child processes (4 virtual CPU devices each) that join one process group via
``parallel.distributed.initialize_distributed`` (the CLI ``--coordinator``
entry), build the same index, and serve hybrid/bm25/dense/filtered searches
through ``ShardedHybridRetriever`` over the cross-process mesh. Both ranks
must agree bit-for-bit AND equal the single-process oracle retrievers.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_CHILD = Path(__file__).parent / "multihost_child.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # ``python tests/multihost_child.py`` puts tests/ (not the repo root) on
    # the child's sys.path — export the root so the package imports without
    # relying on an installed dist or an ambient PYTHONPATH.
    root = str(Path(__file__).resolve().parent.parent)
    prior = env.get("PYTHONPATH")
    env["PYTHONPATH"] = root if not prior else root + os.pathsep + prior
    return env


@pytest.fixture(scope="module")
def rank_results():
    port = _free_port()
    env = _child_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(_CHILD), str(rank), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for rank in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank child failed:\n{err[-4000:]}"
        line = next(
            ln for ln in out.splitlines() if ln.startswith("RESULT ")
        )
        outs.append(json.loads(line[len("RESULT "):]))
    return outs


def test_ranks_agree_bitwise(rank_results):
    r0, r1 = rank_results
    assert r0.keys() == r1.keys() == {"hybrid", "bm25", "dense", "filtered"}
    for key in r0:
        np.testing.assert_array_equal(
            np.asarray(r0[key][0]), np.asarray(r1[key][0]), err_msg=key
        )
        np.testing.assert_array_equal(
            np.asarray(r0[key][1]), np.asarray(r1[key][1]), err_msg=key
        )


def test_matches_single_process_oracle(rank_results):
    from openintel_tpu.index.build import build_postings_index
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

    n, d = 300, 32
    docs = synthetic_token_corpus(n, vocab_size=200, seed=11)
    postings = build_postings_index(docs)
    dense = DenseIndex.from_embeddings(synthetic_embeddings(n, dim=d, seed=12))
    embedder = HashingEmbedder(dim=d)
    queries = synthetic_queries_from_docs(docs, 5, seed=13)
    got = rank_results[0]

    hybrid = HybridRetriever(postings, dense, embedder, kernel="xla")
    want = hybrid.search(queries, k=8, candidates_per_arm=16)
    np.testing.assert_array_equal(np.asarray(got["hybrid"][0]), want.ids)
    np.testing.assert_allclose(
        np.asarray(got["hybrid"][1]), want.scores, rtol=1e-5, atol=1e-6
    )

    want = BM25Retriever(postings).search(queries, k=8)
    np.testing.assert_array_equal(np.asarray(got["bm25"][0]), want.ids)
    np.testing.assert_allclose(
        np.asarray(got["bm25"][1]), want.scores, rtol=1e-5, atol=1e-6
    )

    want = DenseRetriever(dense, embedder, kernel="xla").search(
        queries, k=8
    )
    np.testing.assert_array_equal(np.asarray(got["dense"][0]), want.ids)
    np.testing.assert_allclose(
        np.asarray(got["dense"][1]), want.scores, rtol=1e-5, atol=1e-6
    )

    mask = np.zeros(n, dtype=bool)
    mask[::2] = True
    want = hybrid.search(
        queries, k=8, candidates_per_arm=16, filter_mask=mask
    )
    np.testing.assert_array_equal(np.asarray(got["filtered"][0]), want.ids)
    np.testing.assert_allclose(
        np.asarray(got["filtered"][1]), want.scores, rtol=1e-5, atol=1e-6
    )
    # and the filter held: every returned doc id is unmasked (even)
    ids = np.asarray(got["filtered"][0])
    assert ((ids % 2 == 0) | (ids == -1)).all()
