"""Encoder-quality experiment: neural vs hashing at 100k docs.

Round-3 verdict item 7 ("make the neural encoder earn its place") and
item 8 (reranker uplift): train the compact transformer encoder on a
100k-doc synthetic corpus with a two-surface vocabulary
(index/synthetic.py::synthetic_synonym_corpus), then measure
recall@10 / MRR@10 for every retriever arm on two query distributions:

- exact:    queries reuse document-surface tokens (token overlap exists);
- mismatch: every query token uses the synonym surface that never occurs
            in ANY document (token overlap is zero by construction).

Also trains the cross-encoder reranker on the same corpus and measures
its MRR uplift over the first-stage hybrid ranking on the exact set.

Writes results to docs/encoder_quality.json and prints markdown table
rows for docs/benchmarks.md. Resumable: the encoder checkpoint lands in
--ckpt-dir, and re-running skips completed training steps
(models/train.py resume contract).

Usage (hermetic CPU, ~60-90 min single-core at full scale):
    JAX_PLATFORMS=cpu python scripts/encoder_quality.py \
        [--n-docs 100000] [--steps 4000] [--ckpt-dir /tmp/encq]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)  # allow `python scripts/<name>.py` from anywhere


import argparse
import json
import os
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--n-concepts", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--rerank-steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192,
                    help="encoder hash-vocabulary size (the r4 default 8192 "
                    "collides ~20%% of a 4000-surface vocabulary; 32768 "
                    "cuts that to ~6%%)")
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--ckpt-dir", default="/tmp/encoder_quality_ckpt")
    ap.add_argument("--out", default=None, help="results JSON path")
    ap.add_argument(
        "--family", choices=("synonym", "template"), default="synonym",
        help="mismatch generator family: 1:1 synonym surfaces, or the "
        "compositional two-token template phrases "
        "(index/synthetic.py::synthetic_template_corpus)",
    )
    ap.add_argument(
        "--platform", choices=("cpu", "native"), default="cpu",
        help="'cpu' pins the hermetic CPU platform (default); 'native' "
        "keeps the environment's backend (a GPU where available — "
        "training and corpus embedding run ~orders faster there)",
    )
    ap.add_argument(
        "--rerank-only",
        action="store_true",
        help="skip the 6-arm retrieval tables (keep the existing JSON's) "
        "and re-measure only the reranker uplift — the cheap iteration "
        "loop for reranker-training changes",
    )
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import numpy as np  # noqa: F401  (report arithmetic below)

    from openintel_tpu.index.synthetic import (
        synthetic_synonym_corpus,
        synthetic_template_corpus,
    )
    from openintel_tpu.models.encoder import EncoderConfig, NeuralEmbedder
    from openintel_tpu.models.eval import (
        evaluate_corpus,
        evaluate_retriever,
        synthetic_qrels,
    )
    from openintel_tpu.models.train import train_encoder

    t0 = time.time()

    def log(msg: str) -> None:
        print(f"[{time.time() - t0:7.1f}s] {msg}", flush=True)

    gen = (
        synthetic_synonym_corpus
        if args.family == "synonym"
        else synthetic_template_corpus
    )
    docs, syn = gen(args.n_docs, n_concepts=args.n_concepts, seed=41)
    log(
        f"corpus: {len(docs)} docs, {args.n_concepts} concepts "
        f"({args.family} family)"
    )

    cfg = EncoderConfig(
        vocab_size=args.vocab, dim=args.dim, depth=args.depth,
        heads=args.heads, max_len=32,
    )
    res = train_encoder(
        docs, cfg, steps=args.steps, batch_size=args.batch, lr=args.lr,
        seed=42, synonym_map=syn, flip_p=0.5,
        ckpt_dir=args.ckpt_dir, ckpt_every=200,
        log=lambda m: log(f"train {m}"),
    )
    log(
        f"encoder trained to step {res.step}"
        + (f", loss {res.losses[-1]:.3f}" if res.losses else " (resumed)")
    )
    emb = NeuralEmbedder(cfg, params=res.params)

    results: dict = {
        "config": {
            k: getattr(args, k)
            for k in (
                "n_docs", "n_concepts", "steps", "batch", "lr", "dim",
                "depth", "heads", "vocab", "family",
            )
        },
        "encoder_step": res.step,
        "tables": {},
    }
    default_name = (
        "encoder_quality.json"
        if args.family == "synonym"
        else f"encoder_quality_{args.family}.json"
    )
    out_path = Path(
        args.out or Path(__file__).parent.parent / "docs" / default_name
    )
    if args.rerank_only and out_path.exists():
        results["tables"] = json.loads(out_path.read_text()).get(
            "tables", {}
        )
        log("rerank-only: retrieval tables carried from existing JSON")
    for dist, flip in (() if args.rerank_only else (
        ("exact", 0.0), ("mismatch", 1.0))):
        qrels = synthetic_qrels(
            docs, args.queries, seed=43, terms_per_query=4,
            synonym_map=syn, flip_p=flip,
        )
        rows = {}
        for label, embedder in (("hashing", None), ("neural", emb)):
            for r in evaluate_corpus(
                docs, qrels, k=10, modes=("bm25", "dense", "hybrid"),
                embedder=embedder, dim=args.dim, kernel="xla",
            ):
                rows[f"{label}-{r.mode}"] = {
                    "recall@10": round(r.recall_at_k, 4),
                    "mrr@10": round(r.mrr_at_k, 4),
                }
                log(
                    f"{dist:8s} {label}-{r.mode:6s}: "
                    f"R@10={r.recall_at_k:.3f} MRR={r.mrr_at_k:.3f}"
                )
        results["tables"][dist] = rows

    # ---- reranker uplift (exact set: first stage has signal to reorder)
    from openintel_tpu.models.reranker import train_reranker
    from openintel_tpu.models.retrievers import HybridRetriever

    rr, rr_losses = train_reranker(
        docs, cfg, steps=args.rerank_steps, k=4, batch_queries=8,
        lr=args.lr, seed=44, synonym_map=syn, flip_p=0.5,
        init_trunk=jax.tree_util.tree_map(lambda a: a.copy(), res.params),
    )
    log(f"reranker trained: loss {rr_losses[0]:.3f} -> {rr_losses[-1]:.3f}")

    from openintel_tpu.models.reranker import RerankedRetriever

    qrels = synthetic_qrels(docs, args.queries, seed=43, terms_per_query=4)
    first = HybridRetriever.build(docs, dim=args.dim, kernel="xla")
    two_stage = RerankedRetriever(rr, first, docs)
    base = evaluate_retriever(first, qrels, k=10, mode="hybrid")
    rer = evaluate_retriever(two_stage, qrels, k=10, mode="hybrid")
    results["rerank_uplift_exact"] = {
        "first_stage_mrr@10": round(base.mrr_at_k, 4),
        "reranked_mrr@10": round(rer.mrr_at_k, 4),
        "first_stage_recall@10": round(base.recall_at_k, 4),
        "reranked_recall@10": round(rer.recall_at_k, 4),
    }
    log(
        f"rerank uplift (exact): MRR {base.mrr_at_k:.3f} -> "
        f"{rer.mrr_at_k:.3f}, R@10 {base.recall_at_k:.3f} -> "
        f"{rer.recall_at_k:.3f}"
    )

    out_path.write_text(json.dumps(results, indent=2))
    log(f"wrote {out_path}")

    # markdown rows for docs/benchmarks.md
    print("\n| query set | retriever | recall@10 | MRR@10 |")
    print("|---|---|---|---|")
    for dist, rows in results["tables"].items():
        for name, m in rows.items():
            print(
                f"| {dist} | {name} | {m['recall@10']:.3f} "
                f"| {m['mrr@10']:.3f} |"
            )


if __name__ == "__main__":
    sys.exit(main())
