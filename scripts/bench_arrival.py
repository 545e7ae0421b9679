"""Arrival-rate curves: per-request dispatch vs the BatchCoalescer.

Small-batch serving has two possible answers: a kernel that makes a b=64
wave cost ~1/4 of a b=256 wave, or a measured decision note proving the
coalescer already dominates every realistic arrival rate. The kernel route
is closed by physics on this corpus: the
dense arm streams the whole corpus per wave, so a b=64 wave's floor is the
corpus stream itself (serving.py module docstring; docs/kernels.md) — the
only way to amortise the stream is to put more queries on the SAME wave,
which is exactly what the coalescer does across callers. This experiment
measures the remaining question: what does coalescing COST at low load
(where there is nobody to share with) and WIN at high load, as a function
of offered arrival rate?

Method (open loop — the honest queueing methodology):

- Requests of ``--request-b`` queries arrive at Poisson times with offered
  rate lambda (requests/s); a dispatcher thread submits each at its
  scheduled arrival to a wide thread pool. Nobody waits for the previous
  request: if the serving path can't keep up, queueing delay lands in the
  measured latency instead of silently throttling the load (closed-loop
  callers — scripts/bench_coalescer.py — cannot show saturation).
- Two serving modes over the SAME retriever: ``direct`` calls
  ``retriever.search`` per request (the no-coalescing server);
  ``coalesced`` routes through ``BatchCoalescer(max_batch, max_wait_ms)``.
- Per request: latency = completion - scheduled arrival (includes any
  queueing). Per (mode, rate) point: achieved request throughput, latency
  p50/p95/p99, and a ``saturated`` flag (achieved < 95% of offered, or the
  in-flight cap tripped — the point where an open-loop queue diverges).

The sweep anchors on the measured direct capacity (1 / single-request
latency): fractions below 1.0 are the regime where direct serving is
feasible at all; fractions above it are only servable by sharing waves.
The decision note in docs/benchmarks.md reads the resulting curves.

Env mirrors bench.py (BENCH_DOCS, BENCH_DENSE); on a CPU host it degrades
to a tiny corpus and stamps backend=cpu. Writes docs/arrival_curves.json
(or --out) and prints the markdown rows.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)  # allow `python scripts/<name>.py` from anywhere

import argparse
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# In-flight request cap: an open-loop run past saturation grows its queue
# without bound; once this many requests are outstanding the point is
# conclusively saturated and further arrivals only stretch the drain.
MAX_INFLIGHT = 128


def run_point(
    submit_fn,
    queries_pool: list[list[str]],
    *,
    offered_rps: float,
    duration_s: float,
    k: int,
    rng: np.random.Generator,
) -> dict:
    """One (mode, rate) measurement: Poisson arrivals at ``offered_rps``
    requests/s for ``duration_s``, open loop. Returns the point dict."""
    pool = ThreadPoolExecutor(max_workers=MAX_INFLIGHT)
    latencies: list[float] = []
    lat_lock = threading.Lock()
    errors: list[str] = []
    inflight = 0
    inflight_lock = threading.Lock()
    capped = False

    def serve(qs: list[str], scheduled: float) -> None:
        nonlocal inflight
        try:
            submit_fn(qs, k)
            done = time.monotonic()
            with lat_lock:
                latencies.append(done - scheduled)
        except Exception as e:  # noqa: BLE001 — surfaced in the artifact
            with lat_lock:
                errors.append(repr(e))
        finally:
            with inflight_lock:
                inflight -= 1

    t0 = time.monotonic()
    next_at = t0
    submitted = 0
    futures = []
    while True:
        next_at += float(rng.exponential(1.0 / offered_rps))
        if next_at - t0 > duration_s:
            break
        now = time.monotonic()
        if next_at > now:
            time.sleep(next_at - now)
        with inflight_lock:
            if inflight >= MAX_INFLIGHT:
                # conclusively saturated: stop offering, drain what's queued
                capped = True
                break
            inflight += 1
        qs = queries_pool[submitted % len(queries_pool)]
        futures.append(pool.submit(serve, qs, next_at))
        submitted += 1
    wait(futures, timeout=120.0)
    pool.shutdown(wait=False)
    wall = time.monotonic() - t0
    n = len(latencies)
    lats = np.sort(np.asarray(latencies)) if n else np.zeros(1)
    achieved_rps = n / wall if wall > 0 else 0.0
    return {
        "offered_rps": round(offered_rps, 2),
        "achieved_rps": round(achieved_rps, 2),
        "submitted": submitted,
        "completed": n,
        "p50_ms": round(float(lats[int(0.50 * (len(lats) - 1))]) * 1e3, 1),
        "p95_ms": round(float(lats[int(0.95 * (len(lats) - 1))]) * 1e3, 1),
        "p99_ms": round(float(lats[int(0.99 * (len(lats) - 1))]) * 1e3, 1),
        "saturated": bool(
            capped or (submitted and n < 0.95 * submitted)
        ),
        "inflight_capped": capped,
        "errors": errors[:3],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--request-b", type=int, default=64,
                    help="queries per request (BASELINE config 4 shape)")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds per sweep point (default 8 GPU / 3 CPU)")
    ap.add_argument("--fractions", default="0.3,0.6,0.9,1.3,2.0,3.0",
                    help="offered rate as fractions of measured direct "
                    "capacity")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--out", default=None, help="results JSON path")
    args = ap.parse_args()

    from openintel_tpu import platform

    platform.enable_compile_cache()
    backend = platform.name()
    on_gpu = backend == "gpu"
    n_docs = int(_os.environ.get("BENCH_DOCS", 0)) or (
        1_250_000 if on_gpu else 20_000
    )
    dim = 384
    vocab_size = 30_000 if on_gpu else 3_000
    dense_mode = _os.environ.get("BENCH_DENSE") or platform.default_kernel(n_docs)
    k, c_arm = 10, 32
    duration = args.duration or (8.0 if on_gpu else 3.0)

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
    # same storage mapping + BENCH_STORE knob as bench.py — the two benches
    # must measure the same precision for the "same" config
    from openintel_tpu.index.schema import dense_store_dtype

    store = _os.environ.get("BENCH_STORE", "bf16" if on_gpu else "f32")
    store_dtype = dense_store_dtype(store)
    retriever = HybridRetriever(
        index,
        DenseIndex.from_embeddings(emb, dtype=store_dtype),
        kernel=dense_mode,
        device_batch=args.max_batch,
    )
    log(f"corpus + retriever ready ({time.time() - t0:.0f}s, {backend})")

    # query pool: bench-style Zipf-ish term draws, one request = b queries
    b = args.request_b
    n_requests_pool = 64
    ranks = np.exp(
        rng.uniform(
            np.log(50), np.log(vocab_size - 1), size=(n_requests_pool * b, 4)
        )
    ).astype(np.int64)
    id_to_term = {tid: tok for tok, tid in index.vocab.token_to_id.items()}
    all_q = [
        " ".join(id_to_term.get(int(r) + 1, "t1") for r in row)
        for row in ranks
    ]
    pool_q = [all_q[i * b : (i + 1) * b] for i in range(n_requests_pool)]

    def direct(qs: list[str], k: int = 10, **fkw):
        return retriever.search(qs, k=k, candidates_per_arm=c_arm, **fkw)

    co = BatchCoalescer(
        direct, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms
    )

    # Warm every jit bucket the sweep can hit: requests are a fixed b
    # queries, so coalesced waves come in multiples of b up to max_batch
    # (prepare sub-batches at min(device_batch, wave) — each wave size is
    # its own compile bucket). An unwarmed bucket would bill a compile to
    # one unlucky arrival and poison that point's tail percentiles.
    for wave in range(b, args.max_batch + 1, b):
        direct(all_q[:wave], k)
    log(f"warmed {args.max_batch // b} wave-size buckets")

    # capacity anchors: direct = 1 / single-request latency
    reps, best = 5, float("inf")
    for _ in range(reps):
        s = time.monotonic()
        direct(pool_q[0], k)
        best = min(best, time.monotonic() - s)
    direct_cap_rps = 1.0 / best
    s = time.monotonic()
    co.search(all_q[: args.max_batch], k=k)
    full_wave_s = time.monotonic() - s
    coalesced_cap_rps = (args.max_batch / b) / full_wave_s
    log(
        f"capacity anchors: direct {direct_cap_rps:.1f} req/s "
        f"({direct_cap_rps * b:,.0f} QPS), full-wave "
        f"{coalesced_cap_rps:.1f} req/s ({coalesced_cap_rps * b:,.0f} QPS)"
    )

    fractions = [float(f) for f in args.fractions.split(",")]
    curves: dict = {"direct": [], "coalesced": []}
    for frac in fractions:
        offered = frac * direct_cap_rps
        for mode, fn in (
            ("direct", lambda qs, kk: direct(qs, kk)),
            ("coalesced", lambda qs, kk: co.search(qs, k=kk)),
        ):
            pt = run_point(
                fn, pool_q, offered_rps=offered, duration_s=duration,
                k=k, rng=np.random.default_rng(7),
            )
            pt["fraction_of_direct_cap"] = frac
            curves[mode].append(pt)
            log(
                f"{mode:9s} f={frac:<4} offered {offered:6.1f} req/s: "
                f"achieved {pt['achieved_rps']:6.1f}, "
                f"p50/p95 {pt['p50_ms']:.0f}/{pt['p95_ms']:.0f} ms"
                f"{'  SATURATED' if pt['saturated'] else ''}"
            )

    results = {
        "config": {
            "n_docs": n_docs, "dim": dim, "request_b": b,
            "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
            "duration_s": duration, "kernel": dense_mode,
        },
        "backend": backend,
        "direct_capacity_rps": round(direct_cap_rps, 2),
        "direct_capacity_qps": round(direct_cap_rps * b, 1),
        "coalesced_capacity_rps": round(coalesced_cap_rps, 2),
        "coalesced_capacity_qps": round(coalesced_cap_rps * b, 1),
        "curves": curves,
    }
    from pathlib import Path

    out_path = Path(
        args.out
        or Path(__file__).parent.parent / "docs" / "arrival_curves.json"
    )
    out_path.write_text(json.dumps(results, indent=2))
    log(f"wrote {out_path}")

    # markdown rows for docs/benchmarks.md
    print(
        "| offered (xdirect cap) | direct achieved req/s | direct p50/p95"
        " ms | coalesced achieved req/s | coalesced p50/p95 ms |"
    )
    print("|---|---|---|---|---|")
    for d, c in zip(curves["direct"], curves["coalesced"]):
        dsat = " (sat)" if d["saturated"] else ""
        csat = " (sat)" if c["saturated"] else ""
        print(
            f"| {d['fraction_of_direct_cap']}x | {d['achieved_rps']}{dsat}"
            f" | {d['p50_ms']}/{d['p95_ms']} | {c['achieved_rps']}{csat}"
            f" | {c['p50_ms']}/{c['p95_ms']} |"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
