"""Smoke test of the served retrieval path on NVIDIA GPUs.

    python chip_smoke.py           # one card: phases 1-5 below
    python chip_smoke.py --four    # four cards: the sharded path only

One card, at the served per-card deployment (1.25M docs x 384-d, rows
stored in bf16, query batch 256, k=10, 32 candidates per arm; the corpus
is generated from ``--seed``):

1. device      — a GPU must be JAX's backend; prints its kind and
                 ``nvidia-smi``'s name and power limit. The native C++
                 tier (tokenizer, postings, query planner) is built from
                 its committed sources, as the served path uses it.
2. candidates  — the int8 candidate pass, compiled for the card, against
                 its plain-XLA reference: ids and values bit-identical;
                 median times of both.
3. rescore     — ``exact_rescore`` against a NumPy float64 oracle over the
                 same bf16 rows: |delta cosine| <= 1e-5.
4. served      — ``HybridRetriever`` with the platform's default dense path
                 (the int8 pass) answers 2 x 256 queries; recall@10 against
                 the exact fused oracle (``ops/reference.py``) >= 0.95.
5. entry       — ``openintel index`` on a generated 200k-doc text corpus,
                 then MCP ``search_corpus`` calls, all in this process (one
                 process holds the card).

Four cards (``--four``): 5M docs sharded over a 1 x 4 ("data", "corpus")
mesh by ``ShardedHybridRetriever``, compared with one-card
``HybridRetriever`` over the same docs: recall@10 of both against the
oracle, overlap of their ids, and the shards' placement on 4 devices.

Each phase prints one line; a failing phase raises, so the script exits
non-zero. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from openintel_tpu import platform

DIM, BATCH, K, C_ARM = 384, 256, 10, 32
ONE_CARD_DOCS, FOUR_CARD_DOCS, ENTRY_DOCS = 1_250_000, 5_000_000, 200_000
VOCAB = 30_000


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit for every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().replace("\n", " | ")


def median_ms(fn, reps: int = 20) -> float:
    import jax

    jax.block_until_ready(fn())  # warm-up (compiles)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def make_corpus(n_docs: int, seed: int):
    """Postings and a bf16-stored dense index of unit-norm rows, generated
    from ``seed``."""
    import ml_dtypes

    from openintel_tpu.index.schema import DenseIndex
    from openintel_tpu.index.synthetic import synthetic_postings_index

    postings = synthetic_postings_index(n_docs, vocab_size=VOCAB, seed=seed)
    postings.ensure_impact_order()
    rng = np.random.default_rng(seed + 1)
    emb = rng.standard_normal((n_docs, DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    dense = DenseIndex.from_embeddings(emb, dtype=ml_dtypes.bfloat16)
    return postings, dense


def make_queries(postings, dense, n: int, seed: int):
    """(query texts, their term ids, f32 embeddings near random docs):
    4 mid-frequency terms each, as the benchmark draws them."""
    from openintel_tpu.ops.bm25 import encode_query

    rng = np.random.default_rng(seed)
    ranks = np.exp(rng.uniform(np.log(50), np.log(VOCAB - 1), size=(n, 4)))
    token = {tid: tok for tok, tid in postings.vocab.token_to_id.items()}
    texts = [" ".join(token[int(r) + 1] for r in row) for row in ranks]
    term_ids = [encode_query(postings, t) for t in texts]
    rows = np.asarray(dense.embeddings, np.float32)
    targets = rng.integers(0, rows.shape[0], size=n)
    q = rows[targets] + 0.6 * rng.standard_normal((n, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return texts, term_ids, q


def bm25_topc(postings, term_ids):
    """``ops.reference.bm25_topk`` over the docs that match a term: the
    same exact scores and ranking, without ranking the whole corpus."""
    from openintel_tpu.ops import reference as ref

    scores = ref.bm25_scores(postings, term_ids)
    hit = np.flatnonzero(scores > 0.0)
    vals, pos = ref.rank_topk(scores[hit], C_ARM)
    pad = C_ARM - len(pos)
    return (
        np.pad(vals, (0, pad)).astype(np.float32),
        np.pad(hit[pos], (0, pad), constant_values=-1).astype(np.int32),
    )


def fused_recall(retriever, postings, dense_rows_dev, term_ids, q, got_ids):
    """Recall@10 of ``got_ids`` against the exact fused oracle: exact BM25
    top-c and exact dense top-c over the stored rows (f32 accumulation),
    fused with the retriever's own fusion (the benchmark's protocol)."""
    import jax.numpy as jnp

    from openintel_tpu.ops import reference as ref
    from openintel_tpu.ops.dense import dense_topk_xla

    dn_vals, dn_ids = dense_topk_xla(
        dense_rows_dev, jnp.asarray(q, jnp.float32), C_ARM
    )
    dn_vals, dn_ids = np.asarray(dn_vals), np.asarray(dn_ids)
    recalls = []
    for i, tids in enumerate(term_ids):
        bm_vals, bm_ids = bm25_topc(postings, tids)
        if retriever.fusion == "zblend":
            _, want = ref.zblend_fuse(
                bm_vals, bm_ids, dn_vals[i], dn_ids[i], K,
                alpha=retriever.blend_alpha,
            )
        else:
            _, want = ref.rrf_fuse([bm_ids, dn_ids[i]], K)
        want = {int(d) for d in want if d >= 0}
        got = {int(d) for d in got_ids[i] if d >= 0}
        recalls.append(len(want & got) / len(want))
    return float(np.mean(recalls)), float(np.min(recalls))


def phase_candidates(dense, q, card: str):
    """Phase 2: the compiled int8 pass vs its plain reference."""
    import jax.numpy as jnp

    from openintel_tpu.ops.dense import (
        int8_corpus,
        int8_group,
        int8_topk_xla,
        quantize_int8,
    )
    from openintel_tpu.ops.pallas.int8_topk import int8_topk

    n = dense.n_docs
    c8 = jnp.asarray(int8_corpus(np.asarray(dense.embeddings)))
    q8 = jnp.asarray(quantize_int8(q))
    kw = dict(k=C_ARM, n_docs=n, group=int8_group(n, C_ARM))
    kernel = lambda: int8_topk(c8, q8, interpret=platform.interpret(), **kw)  # noqa: E731
    plain = lambda: int8_topk_xla(c8, q8, **kw)  # noqa: E731
    got, want = kernel(), plain()
    for name, a, b in (("ids", got[1], want[1]), ("vals", got[0], want[0])):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"candidate {name} differ from the reference")
    ms_kernel, ms_plain = median_ms(kernel), median_ms(plain)
    say(
        "candidates",
        f"{n:,} docs x {DIM}, batch {q.shape[0]}, c={C_ARM}, group "
        f"{kw['group']}: kernel == plain reference bit for bit (ids, vals); "
        f"median kernel {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms on {card}",
    )
    return got[1]


def phase_rescore(dense, q, cand_ids):
    """Phase 3: exact_rescore vs a float64 oracle over the same bf16 rows."""
    import jax.numpy as jnp

    from openintel_tpu.ops.dense import exact_rescore

    rows = np.asarray(dense.embeddings)
    vals, ids = exact_rescore(
        jnp.asarray(rows), jnp.asarray(q, jnp.float32), cand_ids, K
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    if (ids < 0).any():
        raise AssertionError("rescore returned padding ids")
    oracle = np.einsum(
        "bkd,bd->bk", rows[ids].astype(np.float64), q.astype(np.float64)
    )
    delta = float(np.abs(vals - oracle).max())
    if delta > 1e-5:
        raise AssertionError(f"rescore |delta cosine| {delta:.3g} > 1e-5")
    say("rescore", f"exact_rescore vs float64 oracle: max |delta| {delta:.3g} <= 1e-5")


def phase_served(postings, dense, texts, term_ids, q):
    """Phase 4: the served HybridRetriever with its default dense path."""
    import jax.numpy as jnp

    from openintel_tpu.models.retrievers import HybridRetriever

    retriever = HybridRetriever(postings, dense, device_batch=BATCH)
    want_kernel = platform.default_kernel(dense.n_docs)
    if retriever.kernel != want_kernel or want_kernel != "int8":
        raise AssertionError(
            f"served kernel {retriever.kernel!r}, platform default "
            f"{want_kernel!r}; expected 'int8'"
        )

    def search():
        return retriever.search(
            texts, k=K, query_embeddings=q, candidates_per_arm=C_ARM
        )

    res = search()  # compiles
    t0 = time.perf_counter()
    res = search()
    wall = time.perf_counter() - t0
    if res.ids.shape != (len(texts), K) or not np.isfinite(res.scores).all():
        raise AssertionError(f"bad result shape {res.ids.shape} or values")
    rows_dev = jnp.asarray(np.asarray(dense.embeddings)).astype(jnp.float32)
    mean, low = fused_recall(retriever, postings, rows_dev, term_ids, q, res.ids)
    if mean < 0.95:
        raise AssertionError(f"served recall@10 {mean:.4f} < 0.95")
    say(
        "served",
        f"HybridRetriever(kernel={retriever.kernel}, fusion "
        f"{retriever.fusion}) on {len(texts)} queries ({wall:.3f} s warm, "
        f"text in to ids out): recall@10 vs exact fused oracle mean "
        f"{mean:.4f}, min {low:.4f}",
    )


def phase_entry(seed: int):
    """Phase 5: `openintel index` then MCP search_corpus, in-process."""
    from openintel_tpu.cli.main import main as cli
    from openintel_tpu.index.synthetic import synthetic_token_corpus
    from openintel_tpu.mcp.server import build_server

    docs = synthetic_token_corpus(ENTRY_DOCS, vocab_size=VOCAB, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(docs) + "\n")
        prefix = os.path.join(tmp, "idx")
        t0 = time.perf_counter()
        if cli(["index", corpus, "--out", prefix]) != 0:
            raise AssertionError("openintel index failed")
        build_s = time.perf_counter() - t0
        server = build_server(offline=True, index=prefix)
        kernel = server.retriever.kernel
        if kernel != "int8":
            raise AssertionError(f"MCP serves kernel {kernel!r}, not int8")
        picks = np.random.default_rng(seed).integers(0, ENTRY_DOCS, size=4)
        resp = asyncio.run(server.handle({
            "jsonrpc": "2.0", "id": 1, "method": "tools/call",
            "params": {
                "name": "search_corpus",
                "arguments": {"queries": [docs[i] for i in picks], "k": 5},
            },
        }))
    if resp["result"]["isError"]:
        raise AssertionError(resp["result"]["content"][0]["text"])
    results = json.loads(resp["result"]["content"][0]["text"])["results"]
    tops = [r["hits"][0]["doc_id"] for r in results]
    if tops != [int(i) for i in picks]:
        raise AssertionError(f"search_corpus top hits {tops} != {picks.tolist()}")
    say(
        "entry",
        f"openintel index: {ENTRY_DOCS:,} docs in {build_s:.1f} s; MCP "
        f"search_corpus ({kernel}) ranked each of {len(picks)} documents "
        "first for its own text",
    )


def run_one_card(n_docs: int, seed: int, card: str) -> None:
    postings, dense = make_corpus(n_docs, seed)
    texts, term_ids, q = make_queries(postings, dense, 2 * BATCH, seed + 2)
    cand_ids = phase_candidates(dense, q[:BATCH], card)
    phase_rescore(dense, q[:BATCH], cand_ids)
    phase_served(postings, dense, texts, term_ids, q)
    phase_entry(seed + 3)


def run_four_cards(n_docs: int, seed: int) -> None:
    """The sharded path on a 1 x 4 mesh against one-card serving."""
    import jax
    import jax.numpy as jnp

    from openintel_tpu.models.retrievers import HybridRetriever
    from openintel_tpu.parallel.retriever import ShardedHybridRetriever

    postings, dense = make_corpus(n_docs, seed)
    texts, term_ids, q = make_queries(postings, dense, BATCH, seed + 2)
    sharded = ShardedHybridRetriever(postings, dense, data=1, corpus=4)
    for name, arr in (("int8 rows", sharded._emb), ("rescore rows", sharded._rescore)):
        devices = {s.device for s in arr.addressable_shards}
        if len(devices) != 4:
            raise AssertionError(f"{name} sit on {len(devices)} device(s), not 4")
    single = HybridRetriever(postings, dense, device_batch=BATCH)
    if sharded.kernel != "int8" or single.kernel != "int8":
        raise AssertionError(f"kernels {sharded.kernel!r} / {single.kernel!r}")
    kw = dict(k=K, query_embeddings=q, candidates_per_arm=C_ARM)
    got4 = sharded.search(texts, **kw)
    got1 = single.search(texts, **kw)
    rows_dev = jnp.asarray(np.asarray(dense.embeddings)).astype(jnp.float32)
    mean4, low4 = fused_recall(sharded, postings, rows_dev, term_ids, q, got4.ids)
    mean1, low1 = fused_recall(single, postings, rows_dev, term_ids, q, got1.ids)
    overlap = float(np.mean([
        len(set(a.tolist()) & set(b.tolist())) / K
        for a, b in zip(got4.ids, got1.ids)
    ]))
    say(
        "four",
        f"{n_docs:,} docs on a 1x4 mesh ({sharded.shard_size:,} rows per "
        f"card on 4 devices of {len(jax.devices())}): recall@10 vs exact "
        f"fused oracle, sharded mean {mean4:.4f} min {low4:.4f}, one card "
        f"mean {mean1:.4f} min {low1:.4f}; id overlap sharded vs one card "
        f"{overlap:.4f}",
    )
    if min(mean4, mean1) < 0.95:
        raise AssertionError("recall@10 below 0.95")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX's backend is {jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 1
    platform.enable_compile_cache()
    devices = jax.devices()
    if platform.interpret():
        raise AssertionError("kernels would run in interpret mode on the GPU")
    card = card_line()
    say("device", f"{devices[0].device_kind} x {len(devices)}; nvidia-smi: {card}")
    from openintel_tpu import native

    t0 = time.perf_counter()
    native.build()
    if native._load() is None:
        raise AssertionError("the native C++ library does not load")
    say("native", f"C++ tokenizer/postings/planner built and loaded "
        f"({time.perf_counter() - t0:.1f} s)")
    if args.four:
        if len(devices) < 4:
            raise AssertionError(f"--four needs 4 GPUs, found {len(devices)}")
        run_four_cards(FOUR_CARD_DOCS, args.seed)
    else:
        run_one_card(ONE_CARD_DOCS, args.seed, card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
