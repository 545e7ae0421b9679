"""Measure the sharded hybrid program's structural overhead (round-2
verdict item 6) on the hermetic 8-device virtual CPU mesh.

This host has ONE physical core (os.cpu_count() == 1), so the 8 virtual
devices execute serially: the mesh cannot show a speedup, but it CAN show
the *structural* cost of the sharded program — per-shard all-gathers of the
(vals, ids) candidate lists, the S-times-wider deterministic merges, RRF
over the gathered pool, and per-shard plan padding — relative to the
single-device program doing the identical total scoring work.

Three measurements over the SAME 262k-doc corpus, batch 64, c=32:
  1. single-device fused hybrid (HybridRetriever.run_prepared)
  2. 8-shard sharded hybrid (sharded_hybrid_topk, jitted program)
  3. a pure matmul+all_gather shard_map probe (isolates shard_map itself)

`overhead_ratio` = t_sharded / t_single. The matmul probe's ratio (~0.8-1x)
shows shard_map adds nothing by itself; the hybrid delta is the merge/fusion
structure. Across real devices the all-gathered bytes (S*B*c*8 per arm per
batch — ids int32 + scores f32) are a few hundred kilobytes, so the
structural term measured here is expected to dominate the sharding cost.

Results are recorded in docs/benchmarks.md ("Sharded overhead").

Usage: python scripts/bench_sharded_overhead.py   (forces its own platform)
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)  # allow `python scripts/<name>.py` from anywhere


import json
import os
import re
import sys
import time

_FLAG = "--xla_force_host_platform_device_count"


def _force_cpu(n: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = re.sub(rf"{_FLAG}=\d+", "", os.environ.get("XLA_FLAGS", ""))
    os.environ["XLA_FLAGS"] = f"{flags} {_FLAG}={n}".strip()


def main() -> int:
    n_shards = 8
    _force_cpu(n_shards)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < n_shards:
        print(json.dumps({"error": "needs an 8-device CPU platform"}))
        return 1

    from openintel_tpu.index.schema import DenseIndex
    from openintel_tpu.index.synthetic import synthetic_postings_index
    from openintel_tpu.models.retrievers import HybridRetriever
    from openintel_tpu.parallel.mesh import make_mesh
    from openintel_tpu.parallel.retriever import shard_query_plans
    from openintel_tpu.parallel.sharded import sharded_hybrid_topk

    n_total = int(os.environ.get("OVH_DOCS", 0)) or n_shards * 32_768
    dim, batch, k, c, vocab, reps = 128, 64, 10, 32, 3000, 6
    rng = np.random.default_rng(0)

    idx = synthetic_postings_index(n_total, vocab_size=vocab, seed=2)
    idx.ensure_impact_order()
    emb = rng.standard_normal((n_total, dim), dtype=np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    term_ids = [list(rng.integers(1, vocab, size=4)) for _ in range(batch)]
    q = rng.standard_normal((batch, dim)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)

    def best_of(fn):
        fn()  # compile/warm
        return min(
            (lambda s: (fn(), time.time() - s)[1])(time.time())
            for _ in range(reps)
        )

    # 1. single-device fused hybrid over the whole corpus
    r1 = HybridRetriever(
        idx, DenseIndex.from_embeddings(emb), kernel="xla",
        device_batch=batch,
    )
    prep = r1.prepare(term_ids, q, k=k, candidates_per_arm=c)
    t_single = best_of(lambda: r1.run_prepared(prep))

    # 2. 8-shard sharded hybrid over the same corpus
    mesh = make_mesh(data=1, corpus=n_shards)
    pdi, pw, meta = shard_query_plans(
        idx, term_ids, n_shards, max_postings_per_term=128
    )
    emb_dev = jax.device_put(jnp.asarray(emb))
    qd, pdid, pwd = jnp.asarray(q), jnp.asarray(pdi), jnp.asarray(pw)

    def run_sharded():
        v, _ = sharded_hybrid_topk(
            mesh, emb_dev, qd, pdid, pwd, k, candidates_per_arm=c,
            presorted=meta.presorted, max_run=meta.max_terms,
            block_size=4096,
        )
        v.block_until_ready()

    t_sharded = best_of(run_sharded)

    # 3. pure matmul + all_gather probe: does shard_map itself cost anything?
    A = jnp.asarray(emb)
    Q = jnp.asarray(q)
    f1 = jax.jit(lambda a, qq: (qq @ a.T).max(axis=1))
    t_mm1 = best_of(lambda: f1(A, Q).block_until_ready())
    mesh1 = Mesh(np.array(jax.devices()[:n_shards]), ("c",))
    As = jax.device_put(A, NamedSharding(mesh1, P("c", None)))

    def probe_local(a, qq):
        return jax.lax.all_gather((qq @ a.T).max(axis=1), "c")

    f8 = jax.jit(
        jax.shard_map(
            probe_local, mesh=mesh1,
            in_specs=(P("c", None), P(None, None)),
            out_specs=P("c", None),
        )
    )
    t_mm8 = best_of(lambda: f8(As, Q).block_until_ready())

    gather_bytes = n_shards * batch * c * 8  # per arm per batch
    print(
        json.dumps(
            {
                "metric": "sharded_hybrid_structural_overhead",
                "platform": (
                    f"cpu-virtual-{n_shards}dev on {os.cpu_count()} core(s) "
                    "(serialized: structure, not ICI wire)"
                ),
                "n_docs": n_total,
                "batch": batch,
                "candidates_per_arm": c,
                "t_single_1dev_ms": round(t_single * 1e3, 1),
                "t_sharded_8dev_ms": round(t_sharded * 1e3, 1),
                "overhead_ratio": round(t_sharded / t_single, 3),
                "matmul_probe_ratio": round(t_mm8 / t_mm1, 3),
                "allgather_bytes_per_batch_per_arm": gather_bytes,
                "allgather_bytes_per_query_per_arm": gather_bytes // batch,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
