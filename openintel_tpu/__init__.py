"""openintel-tpu — a social-sentiment × market-action speculation framework with a
device-resident hybrid retrieval engine.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of Kloudy-Sky/openintel
(reference: a hexagonal Rust CLI + MCP server), re-architected around one
compiled device program per query batch:

- the scoring core (reference ``src/adapters/analyzer/lexicon.rs``) generalises to a
  device-resident hybrid retrieval engine: BM25 postings scoring, dense cosine top-k,
  and reciprocal-rank fusion (``openintel_tpu.ops``, ``openintel_tpu.models``);
- the fusion engine (reference ``src/domain/engine/speculation_engine.rs``) is a pure,
  clock-injected core with a vectorised jittable batch path (``openintel_tpu.domain``);
- the corpus shards over a ``jax.sharding.Mesh`` with per-shard top-k and an
  all-gather merge (``openintel_tpu.parallel``);
- the host shell (ingest adapters, credentials, CLI, MCP server) mirrors the
  reference's graceful-degradation semantics (``openintel_tpu.sources``,
  ``openintel_tpu.cli``, ``openintel_tpu.mcp``).
"""

__version__ = "0.4.0"

from openintel_tpu.errors import (  # noqa: F401
    AnalyzerMismatch,
    DomainError,
    InvalidPostText,
    InvalidTicker,
    MarketTickerMismatch,
    NoData,
    SourceFailure,
)


def __getattr__(name):  # lazy convenience exports (avoid importing jax early)
    if name in ("BM25Retriever", "DenseRetriever", "HybridRetriever"):
        from openintel_tpu.models import retrievers

        return getattr(retrievers, name)
    if name == "CrossEncoderReranker":
        from openintel_tpu.models.reranker import CrossEncoderReranker

        return CrossEncoderReranker
    if name == "ShardedHybridRetriever":
        from openintel_tpu.parallel.retriever import ShardedHybridRetriever

        return ShardedHybridRetriever
    if name == "UpdatableHybridRetriever":
        from openintel_tpu.models.updatable import UpdatableHybridRetriever

        return UpdatableHybridRetriever
    if name == "BatchCoalescer":
        from openintel_tpu.serving import BatchCoalescer

        return BatchCoalescer
    raise AttributeError(f"module 'openintel_tpu' has no attribute {name!r}")
