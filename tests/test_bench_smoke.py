"""bench.py is a driver-scored artifact: it must run hermetically on CPU
and print exactly one valid JSON line with the contracted fields."""

import json
import os
import subprocess
import sys
from pathlib import Path


def test_bench_emits_contracted_json():
    repo = Path(__file__).resolve().parent.parent
    env = dict(
        os.environ,
        BENCH_DOCS="2000",
        JAX_PLATFORMS="cpu",
    )
    code = (
        "import os;"
        "os.environ['JAX_PLATFORMS']='cpu';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        f"import sys; sys.path.insert(0, {str(repo)!r});"
        "import bench; bench.main()"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=repo,
        env=env,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [ln for ln in res.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, lines  # exactly ONE JSON line on stdout
    doc = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "value_net_rtt",
                "dispatch_rtt_ms", "recall_at_10_vs_exact",
                "recall_at_10_min", "recall_sample_queries",
                "served_surface", "bm25_arm_rtt_bound",
                # round-5 contract: every headline claim in the one artifact
                "pipelined_end_to_end_qps", "sequential_waved_qps",
                "planner_threads_ms_per_query", "latency_ms",
                "served_b64_concurrent_qps", "coalescer_caller_latency_ms",
                "index_build_docs_per_s_core", "qps_10M_docs_single_chip",
                "bench_wall_s"):
        assert key in doc, key
    for pct in ("p50", "p95", "p99"):
        assert pct in doc["latency_ms"]["b1"]
        assert pct in doc["coalescer_caller_latency_ms"]
    assert doc["unit"] == "queries/sec/chip"
    assert doc["value"] > 0
    # the headline is RAW wall clock through the served surface — it can
    # only be <= the net-of-RTT figure
    assert doc["value"] <= doc["value_net_rtt"] + 1e-6
    assert doc["served_surface"] == "HybridRetriever.run_prepared"
    assert 0.9 <= doc["recall_at_10_vs_exact"] <= 1.0
