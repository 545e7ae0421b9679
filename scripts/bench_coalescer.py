"""Coalescer under real concurrent load.

BASELINE config 4 is b=64 hybrid at 100k QPS; the raw b=64 device rate is
corpus-stream-bound (~0.38x per-query efficiency at 1.25M docs), and the
production mitigation is the ``BatchCoalescer``: concurrent 64-query
callers fuse into full 256-query waves before dispatch. This measures
that mitigation on the device: N threads each looping 64-query searches against
the coalescer-wrapped served retriever (exactly the MCP composition,
mcp/server.py::build_server), reporting

- ``served_b64_concurrent_qps``: aggregate completed queries/sec across
  callers (what a deployment of b=64 clients actually gets), and
- ``raw_b64_qps``: the unfused single-caller rate for contrast.

Env mirrors bench.py (BENCH_DOCS, BENCH_DENSE); writes one JSON line. On a
CPU host it degrades to a tiny corpus and flags backend=cpu like bench.py.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)  # allow `python scripts/<name>.py` from anywhere


import json
import os
import sys
import threading
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    from openintel_tpu import platform

    platform.enable_compile_cache()
    backend = platform.name()
    on_gpu = backend == "gpu"
    n_docs = int(os.environ.get("BENCH_DOCS", 0)) or (
        1_250_000 if on_gpu else 20_000
    )
    dim = 384
    vocab_size = 30_000 if on_gpu else 3_000
    dense_mode = os.environ.get("BENCH_DENSE") or platform.default_kernel(n_docs)
    k, c_arm = 10, 32
    caller_b = 64
    n_callers = int(os.environ.get("BENCH_CALLERS", 8))
    seconds = float(os.environ.get("BENCH_SECONDS", 20))

    from openintel_tpu.index.schema import DenseIndex
    from openintel_tpu.index.synthetic import synthetic_postings_index
    from openintel_tpu.models.retrievers import HybridRetriever
    from openintel_tpu.serving import BatchCoalescer

    t0 = time.time()
    index = synthetic_postings_index(n_docs, vocab_size=vocab_size, seed=0)
    index.ensure_impact_order()
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((n_docs, dim), dtype=np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    store_dtype = np.float32
    if on_gpu:
        import ml_dtypes

        store_dtype = ml_dtypes.bfloat16
    retriever = HybridRetriever(
        index,
        DenseIndex.from_embeddings(emb, dtype=store_dtype),
        kernel=dense_mode,
        device_batch=256,
    )
    log(f"corpus + retriever ready ({time.time() - t0:.0f}s, {backend})")

    # bench-style queries; each caller cycles its own slice
    total_q = caller_b * max(n_callers, 4) * 4
    ranks = np.exp(
        rng.uniform(np.log(50), np.log(vocab_size - 1), size=(total_q, 4))
    ).astype(np.int64)
    id_to_term = {}
    for tok, tid in index.vocab.token_to_id.items():
        id_to_term[tid] = tok
    queries = [
        " ".join(id_to_term.get(int(r) + 1, "t1") for r in row)
        for row in ranks
    ]

    # the served composition: coalescer wrapping the hybrid search
    def search_fn(qs, k=10, **fkw):
        return retriever.search(qs, k=k, candidates_per_arm=c_arm, **fkw)

    co = BatchCoalescer(search_fn, max_batch=256, max_wait_ms=2.0)

    # warm the compile caches (both the 256 wave and the raw 64 shape)
    co.search(queries[:256], k=k)
    search_fn(queries[:caller_b], k=k)

    # raw single-caller b=64 rate for contrast
    reps = 6
    best = float("inf")
    for _ in range(reps):
        s = time.time()
        search_fn(queries[:caller_b], k=k)
        best = min(best, time.time() - s)
    raw_b64 = caller_b / best
    log(f"raw b=64 single caller: {raw_b64:,.0f} QPS")

    # concurrent callers against the coalescer
    stop = time.time() + seconds
    done = [0] * n_callers
    errors: list = []

    def caller(i: int) -> None:
        lo = (i * caller_b * 4) % max(len(queries) - caller_b, 1)
        while time.time() < stop:
            try:
                res = co.search(
                    queries[lo : lo + caller_b], k=k
                )
                assert res.ids.shape == (caller_b, k)
                done[i] += caller_b
            except Exception as e:  # noqa: BLE001 - surfaced in the artifact
                errors.append(repr(e))
                return
            lo = (lo + caller_b) % max(len(queries) - caller_b, 1)

    s = time.time()
    threads = [
        threading.Thread(target=caller, args=(i,)) for i in range(n_callers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - s
    served = sum(done) / wall
    log(
        f"{n_callers} x b={caller_b} callers for {wall:.1f}s: "
        f"{sum(done)} queries, {served:,.0f} QPS served; "
        f"{co.batches_run} fused waves "
        f"({co.queries_run / max(co.batches_run, 1):.0f} q/wave)"
    )
    print(
        json.dumps(
            {
                "metric": f"coalesced_b64_qps_{n_docs/1e6:.2f}M_docs",
                "served_b64_concurrent_qps": round(served, 1),
                "raw_b64_qps": round(raw_b64, 1),
                "fused_waves": co.batches_run,
                "queries_per_wave": round(
                    co.queries_run / max(co.batches_run, 1), 1
                ),
                "n_callers": n_callers,
                "vs_baseline": round(served / 100_000.0, 4),
                "errors": errors[:3],
                "backend": backend,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
