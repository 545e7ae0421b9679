"""Child process for the two-process ``jax.distributed`` demonstration.

Launched (twice) by tests/test_multihost.py with 4 local CPU devices each:
the pair forms one 8-device global mesh over two OS processes, exercising
the REAL multi-controller path — ``jax.distributed.initialize`` via
``parallel.distributed.initialize_distributed`` (the same entry the CLI's
``--coordinator`` flag routes through), cross-process ``device_put`` of the
corpus shards, and Gloo-backed collectives inside the sharded programs.

Each process runs the identical SPMD host program (the multi-host serving
discipline documented in parallel/distributed.py) and prints its results as
one ``RESULT {json}`` line; the parent asserts both processes agree AND
equal the single-process oracle retrievers. Not a pytest file — no test_
prefix, executed via subprocess only.
"""

import json
import pathlib
import sys

# Run as ``python tests/multihost_child.py`` — script dir (tests/) is on
# sys.path but the repo root is not; add it so the package resolves even
# when the parent's PYTHONPATH doesn't propagate.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    process_id = int(sys.argv[1])
    port = sys.argv[2]

    import jax

    # jax.config wins over the env var once jax is imported
    jax.config.update("jax_platforms", "cpu")

    from openintel_tpu.parallel.distributed import initialize_distributed

    assert initialize_distributed(
        f"localhost:{port}", num_processes=2, process_id=process_id
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, jax.devices()
    assert len(jax.local_devices()) == 4, jax.local_devices()

    import numpy as np

    from openintel_tpu.index.build import build_postings_index
    from openintel_tpu.index.schema import DenseIndex
    from openintel_tpu.index.synthetic import (
        synthetic_embeddings,
        synthetic_queries_from_docs,
        synthetic_token_corpus,
    )
    from openintel_tpu.models.embedding import HashingEmbedder
    from openintel_tpu.parallel.retriever import ShardedHybridRetriever

    # deterministic corpus — both processes build the identical index, as
    # two real hosts would load the same checkpoint prefix
    n, d = 300, 32
    docs = synthetic_token_corpus(n, vocab_size=200, seed=11)
    postings = build_postings_index(docs)
    dense = DenseIndex.from_embeddings(
        synthetic_embeddings(n, dim=d, seed=12)
    )
    embedder = HashingEmbedder(dim=d)

    # corpus=8 puts the corpus axis ACROSS the process boundary: the
    # hybrid program's all-gather of per-shard candidates rides the
    # cross-process (cross-host-analogue) channel, not just local devices
    r = ShardedHybridRetriever(
        postings, dense, embedder, data=1, corpus=8, kernel="xla",
        block_size=64,
    )
    queries = synthetic_queries_from_docs(docs, 5, seed=13)

    out = {}
    res = r.search(queries, k=8, candidates_per_arm=16)
    out["hybrid"] = [res.ids.tolist(), res.scores.tolist()]
    res = r.search(queries, k=8, mode="bm25")
    out["bm25"] = [res.ids.tolist(), res.scores.tolist()]
    res = r.search(queries, k=8, mode="dense")
    out["dense"] = [res.ids.tolist(), res.scores.tolist()]
    mask = np.zeros(n, dtype=bool)
    mask[::2] = True
    res = r.search(queries, k=8, candidates_per_arm=16, filter_mask=mask)
    out["filtered"] = [res.ids.tolist(), res.scores.tolist()]

    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
