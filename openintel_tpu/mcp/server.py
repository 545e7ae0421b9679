"""MCP server over stdio: hand-rolled JSON-RPC 2.0 implementing the Model
Context Protocol (initialize / tools/list / tools/call / ping), exposing the
six tools of the reference server (src/mcp/server.rs:39-148) with the same
agent-facing descriptions (incl. the x_pulse cost-confirmation instruction).

Composition root semantics mirror the reference (src/mcp/server.rs:171-192):
credentials from env->keychain, social sources wired iff fully configured,
Yahoo market source, optional X pulse feed; --offline swaps in the
deterministic fixtures (and is the only mode that works without egress).
"""

from __future__ import annotations

import asyncio
import json
import sys
from typing import Any, Optional, Sequence

from openintel_tpu import __version__
from openintel_tpu.domain.ports import (
    BarSource,
    InfluencerFeed,
    MarketDataSource,
    SocialDataSource,
)
from openintel_tpu.mcp import tools

PROTOCOL_VERSION = "2024-11-05"

_SOURCE_FLAGS = {
    "enable_reddit": {
        "type": "boolean",
        "description": "Enable the Reddit source (if no source flags are set, all are enabled).",
    },
    "enable_bluesky": {
        "type": "boolean",
        "description": "Enable the Bluesky source (if no source flags are set, all are enabled).",
    },
    "no_market": {
        "type": "boolean",
        "description": "Skip the market snapshot (social-only report).",
    },
    "limit": {
        "type": "integer",
        "description": "Posts to fetch per source (default 50).",
    },
}

TOOL_SPECS: list[dict[str, Any]] = [
    {
        "name": "list_sources",
        "description": (
            "List the social and market data sources OpenIntel can analyze. "
            "Read-only metadata."
        ),
        "inputSchema": {"type": "object", "properties": {}, "required": []},
    },
    {
        "name": "analyze_ticker",
        "description": (
            "Analyze one ticker: fuse social sentiment with market action into a "
            "speculation report (net sentiment, speculation index, crowding, "
            "alignment = confirming/diverging/quiet). Read-only — does not trade."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "ticker": {"type": "string", "description": 'Ticker symbol, e.g. "AAPL".'},
                **_SOURCE_FLAGS,
            },
            "required": ["ticker"],
        },
    },
    {
        "name": "scan_watchlist",
        "description": (
            "Analyze a watchlist of tickers concurrently. Returns one entry per "
            "ticker (report or error); one bad ticker does not fail the batch. "
            "Read-only — does not trade."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "tickers": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "Ticker symbols to analyze concurrently.",
                },
                **_SOURCE_FLAGS,
            },
            "required": ["tickers"],
        },
    },
    {
        "name": "compare_tickers",
        "description": (
            "Compare tickers and rank them by a chosen signal: rank_by ∈ "
            "{crowding (default), speculation_index, net_sentiment, divergence}. "
            "Read-only — does not trade."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "tickers": {"type": "array", "items": {"type": "string"}},
                "rank_by": {
                    "type": "string",
                    "enum": list(tools.RANK_BY),
                    "description": "Ranking signal (default crowding).",
                },
                **_SOURCE_FLAGS,
            },
            "required": ["tickers"],
        },
    },
    {
        "name": "x_pulse",
        "description": (
            "Fetch recent posts about a ticker from specific high-impact X accounts "
            "(paid API: ~$0.005 per post read). Before calling: research which accounts "
            "actually matter for this ticker — CEO/founder, major institutional holders "
            "or activist funds, respected sector journalists, and market-moving macro "
            "figures — then propose the account list and estimated max cost "
            "(max(limit, 10) × $0.005 — X bills a minimum of 10 reads) to the user "
            "and get their confirmation. Also propose company-language keywords "
            '(e.g. "Tesla" for TSLA) — these accounts rarely write cashtags, so '
            "symbol-only matching misses their posts. Omit `accounts` only if the "
            "user asks for the default macro list. Returned posts are catalyst "
            "events — reason about them directly; do not treat them as a sentiment "
            "sample. Read-only — does not trade."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "ticker": {"type": "string", "description": 'Ticker symbol, e.g. "NVDA".'},
                "accounts": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "X handles to listen to (no @). Curate per ticker.",
                },
                "keywords": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "Company-language search terms; multi-word phrases OK.",
                },
                "hours_back": {
                    "type": "integer",
                    "description": "Lookback window in hours (default 24, max 167).",
                },
                "limit": {
                    "type": "integer",
                    "description": (
                        "Max posts to read — each read costs ~$0.005 (default 20, "
                        "max 100). X bills a minimum of 10 reads per call."
                    ),
                },
            },
            "required": ["ticker"],
        },
    },
    {
        "name": "risk_frame",
        "description": (
            "Deterministic risk calculator: given a ticker, a per-trade risk budget in "
            "USD, and a direction, returns an ATR(14)-based stop level, the whole-share "
            "size that caps a stop-out at the budget, max loss, and 1R/2R/3R reference "
            "levels. It does NOT recommend trades — combine it with analyze_ticker / "
            "x_pulse, present the numbers to the user, and get their explicit approval "
            "before any execution step. Read-only — does not trade."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "ticker": {"type": "string"},
                "budget_usd": {
                    "type": "number",
                    "description": "Per-trade risk budget in USD — the most a stop-out may lose.",
                },
                "direction": {"type": "string", "enum": ["long", "short"]},
                "stop_multiple": {
                    "type": "number",
                    "description": "Stop distance in ATR multiples (default 2.0, clamped 0.5-5).",
                },
                "entry": {"type": "number", "description": "Entry price override (default: last close)."},
            },
            "required": ["ticker", "budget_usd"],
        },
    },
]

SEARCH_TOOL_SPEC: dict[str, Any] = {
    "name": "search_corpus",
    "description": (
        "Hybrid retrieval (BM25 + dense cosine, fused on the device) "
        "over the corpus this server was started with. Returns ranked doc ids, "
        "scores, and text snippets. Read-only."
    ),
    "inputSchema": {
        "type": "object",
        "properties": {
            "queries": {
                "type": "array",
                "items": {"type": "string"},
                "description": "One or more search queries (batched on device).",
            },
            "k": {"type": "integer", "description": "Results per query (default 10)."},
            "mode": {
                "type": "string",
                "enum": ["hybrid", "bm25", "dense"],
                "description": "Scoring arm (default hybrid).",
            },
            "include_ids": {
                "type": "array",
                "items": {"type": "integer"},
                "description": (
                    "Filtered search: only rank these doc ids "
                    "(exact at any selectivity; scores keep full-corpus "
                    "statistics)."
                ),
            },
            "exclude_ids": {
                "type": "array",
                "items": {"type": "integer"},
                "description": (
                    "Filtered search: never rank these doc ids (e.g. "
                    "already-seen results; composes with include_ids)."
                ),
            },
            "filters": {
                "type": "array",
                "items": {
                    "type": ["object", "null"],
                    "properties": {
                        "include_ids": {
                            "type": "array", "items": {"type": "integer"}
                        },
                        "exclude_ids": {
                            "type": "array", "items": {"type": "integer"}
                        },
                    },
                },
                "description": (
                    "PER-QUERY filters: one entry per query (aligned with "
                    "`queries`; null = that query searches the whole "
                    "corpus). Identical entries share one device mask, so "
                    "a batch over a few tenants costs a few masks. "
                    "Mutually exclusive with the call-wide "
                    "include_ids/exclude_ids."
                ),
            },
        },
        "required": ["queries"],
    },
}

INDEX_TOOL_SPEC: dict[str, Any] = {
    "name": "index_documents",
    "description": (
        "Add documents to the served corpus (searchable immediately, no "
        "rebuild — incremental delta segment). Returns the new docs' "
        "stable ids. Only available when the server was started with "
        "--updatable."
    ),
    "inputSchema": {
        "type": "object",
        "properties": {
            "texts": {
                "type": "array",
                "items": {"type": "string"},
                "description": "Document texts to index (batch your adds).",
            },
        },
        "required": ["texts"],
    },
}

DELETE_TOOL_SPEC: dict[str, Any] = {
    "name": "delete_documents",
    "description": (
        "Delete documents from the served corpus by id (tombstoned "
        "immediately — they stop surfacing in search_corpus at once). "
        "Only available when the server was started with --updatable."
    ),
    "inputSchema": {
        "type": "object",
        "properties": {
            "ids": {
                "type": "array",
                "items": {"type": "integer"},
                "description": "Doc ids to delete (idempotent).",
            },
        },
        "required": ["ids"],
    },
}

COMPACT_TOOL_SPEC: dict[str, Any] = {
    "name": "compact_corpus",
    "description": (
        "Fold the corpus's delta segment and tombstones into one fresh "
        "segment with true statistics (doc ids are RENUMBERED densely when "
        "deletes existed — re-fetch any ids you cached). Optionally "
        "persists the compacted index to the server's own --index prefix. "
        "Only available with --updatable."
    ),
    "inputSchema": {
        "type": "object",
        "properties": {
            "save": {
                "type": "boolean",
                "description": (
                    "Also write the compacted index back to the --index "
                    "prefix on disk (survives restarts)."
                ),
            },
        },
        "required": [],
    },
}

STATS_TOOL_SPEC: dict[str, Any] = {
    "name": "server_stats",
    "description": (
        "Serving statistics for search_corpus: device batches run, queries "
        "served, and the batch-coalescer configuration (concurrent hybrid "
        "searches fuse into one device batch). Read-only."
    ),
    "inputSchema": {"type": "object", "properties": {}, "required": []},
}

SERVER_INSTRUCTIONS = (
    "OpenIntel — fuses social sentiment with market action into a speculation "
    "report (crowding, divergence, sentiment). READ-ONLY: it never places trades."
)


class OpenIntelServer:
    """Tool dispatch over injected ports; transport-free (testable)."""

    def __init__(
        self,
        social: Sequence[SocialDataSource],
        market: Optional[MarketDataSource],
        bars: Optional[BarSource] = None,
        pulse_feed: Optional[InfluencerFeed] = None,
        retriever=None,  # HybridRetriever over an indexed corpus (optional)
        docs: Optional[Sequence[str]] = None,
        reranker=None,  # CrossEncoderReranker second stage (optional)
        coalescer=None,  # BatchCoalescer over the hybrid search (optional)
        index_prefix: Optional[str] = None,  # compact_corpus save target
        encoder_dir: Optional[str] = None,  # for the saved index's meta
    ):
        self.social = list(social)
        self.market = market
        self.bars = bars
        self.pulse_feed = pulse_feed
        self.retriever = retriever
        self.docs = list(docs) if docs is not None else None
        self.reranker = reranker
        self.coalescer = coalescer
        self.index_prefix = index_prefix
        self.encoder_dir = encoder_dir
        # search_corpus calls in flight (id -> monotonic start); event-loop
        # mutated only, read by server_stats' hang detector
        self._inflight: dict[int, float] = {}

    def oldest_inflight_s(self):
        """Seconds the longest-running in-flight search_corpus call has
        been out, or None when idle (server-level analogue of
        BatchCoalescer.oldest_inflight_s for coalescer-less servers)."""
        import time

        if not self._inflight:
            return None
        return time.monotonic() - min(self._inflight.values())

    @property
    def tool_specs(self) -> list[dict[str, Any]]:
        specs = list(TOOL_SPECS)
        if self.retriever is not None:
            specs.append(SEARCH_TOOL_SPEC)
            if hasattr(self.retriever, "add_documents"):  # --updatable
                specs.append(INDEX_TOOL_SPEC)
                specs.append(DELETE_TOOL_SPEC)
                specs.append(COMPACT_TOOL_SPEC)
            specs.append(STATS_TOOL_SPEC)
        return specs

    async def call_tool(self, name: str, args: dict[str, Any]) -> dict[str, Any]:
        if name == "search_corpus":
            if self.retriever is None:
                raise RuntimeError(
                    "no corpus indexed — start the server with --index PREFIX"
                )
            # Run the (blocking) device search in a worker thread so
            # concurrent tools/call requests actually overlap — that
            # concurrency is what feeds the batch coalescer. Track the
            # call in _inflight so server_stats' oldest_inflight_s hang
            # detector (docs/specs/serving-resilience.md) covers servers
            # WITHOUT a coalescer (e.g. --updatable) too.
            import time

            token = object()
            self._inflight[id(token)] = time.monotonic()
            try:
                return await asyncio.to_thread(
                    tools.run_search_corpus,
                    args, self.retriever, self.docs, self.reranker,
                    self.coalescer,
                )
            finally:
                self._inflight.pop(id(token), None)
        if name in ("index_documents", "delete_documents", "compact_corpus"):
            if self.retriever is None or not hasattr(
                self.retriever, "add_documents"
            ):
                raise RuntimeError(
                    "corpus updates need --index PREFIX --updatable"
                )
            if name == "compact_corpus":
                # worker thread: the fold + device re-staging are blocking
                return await asyncio.to_thread(
                    tools.run_compact_corpus, args, self.retriever,
                    self.docs, self.index_prefix, self.encoder_dir,
                )
            if name == "index_documents":
                # worker thread: embedding + delta rebuild are blocking
                return await asyncio.to_thread(
                    tools.run_index_documents, args, self.retriever, self.docs
                )
            # delete also leaves the event loop: it takes the update lock,
            # which an in-flight add may hold for seconds — blocking HERE
            # would stall every response behind it
            return await asyncio.to_thread(
                tools.run_delete_documents, args, self.retriever
            )
        if name == "server_stats":
            if self.retriever is None:
                raise RuntimeError(
                    "no corpus indexed — start the server with --index PREFIX"
                )
            return tools.run_server_stats(
                self.retriever, self.coalescer,
                inflight_s=self.oldest_inflight_s(),
            )
        if name == "list_sources":
            return tools.run_list_sources(self.social, self.market)
        if name == "analyze_ticker":
            return await tools.run_analyze(args, self.social, self.market)
        if name == "scan_watchlist":
            return await tools.run_scan(args, self.social, self.market)
        if name == "compare_tickers":
            return await tools.run_compare(args, self.social, self.market)
        if name == "x_pulse":
            if self.pulse_feed is None:
                raise RuntimeError(
                    "x is not configured — set OPENINTEL_X_BEARER or run "
                    "`openintel setup x`"
                )
            return await tools.run_pulse(args, self.pulse_feed)
        if name == "risk_frame":
            if self.bars is None:
                raise RuntimeError("no bar source configured")
            return await tools.run_risk_frame(args, self.bars)
        raise ValueError(f"unknown tool: {name}")

    async def handle(self, message: dict[str, Any]) -> Optional[dict[str, Any]]:
        """One JSON-RPC message in, one response out (None for notifications)."""
        msg_id = message.get("id")
        method = message.get("method")
        if method is None:
            if msg_id is None:
                return None
            return {  # a request with an id MUST get a response
                "jsonrpc": "2.0",
                "id": msg_id,
                "error": {"code": -32600, "message": "invalid request: no method"},
            }
        if msg_id is None:  # notification (e.g. notifications/initialized)
            return None
        try:
            if method == "initialize":
                result: Any = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {"name": "openintel-tpu", "version": __version__},
                    "instructions": SERVER_INSTRUCTIONS,
                }
            elif method == "ping":
                result = {}
            elif method == "tools/list":
                result = {"tools": self.tool_specs}
            elif method == "tools/call":
                params = message.get("params") or {}
                out = await self.call_tool(
                    params.get("name", ""), params.get("arguments") or {}
                )
                result = {
                    "content": [
                        {"type": "text", "text": json.dumps(out, indent=2)}
                    ],
                    "isError": False,
                }
            else:
                return {
                    "jsonrpc": "2.0",
                    "id": msg_id,
                    "error": {"code": -32601, "message": f"method not found: {method}"},
                }
            return {"jsonrpc": "2.0", "id": msg_id, "result": result}
        except Exception as e:
            if method == "tools/call":
                # Tool-level failures surface as tool results, not RPC errors.
                return {
                    "jsonrpc": "2.0",
                    "id": msg_id,
                    "result": {
                        "content": [{"type": "text", "text": str(e)}],
                        "isError": True,
                    },
                }
            return {
                "jsonrpc": "2.0",
                "id": msg_id,
                "error": {"code": -32603, "message": str(e)},
            }


async def serve_stdio(server: OpenIntelServer) -> None:
    """Blocking stdio loop: one JSON-RPC message per line.

    Requests dispatch CONCURRENTLY — each message spawns a task and
    responses are written as they complete (JSON-RPC ids make out-of-order
    replies safe). Concurrent ``search_corpus`` calls therefore overlap and
    coalesce into fused device batches (``serving.BatchCoalescer``); the
    reference's serving loop gets the same property from tokio+rmcp
    (src/mcp/server.rs:187-190)."""
    loop = asyncio.get_event_loop()
    pending: set[asyncio.Task] = set()

    async def dispatch(message: dict[str, Any]) -> None:
        try:
            response = await server.handle(message)
        except Exception as e:  # noqa: BLE001 — a dead task would leave the
            # caller blocked forever on its id; answer with an RPC error.
            # Notifications (no id) never get a response, even on failure
            # (JSON-RPC 2.0 §4.1) — a strict client treats an id:null error
            # as a broken-request report.
            if not isinstance(message, dict) or "id" not in message:
                return
            response = {
                "jsonrpc": "2.0",
                "id": message.get("id"),
                "error": {"code": -32603, "message": f"internal error: {e}"},
            }
        if response is not None:
            # print() runs without awaits in the event-loop thread, so
            # whole-line writes never interleave across tasks
            print(json.dumps(response), flush=True)

    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        try:
            message = json.loads(line)
        except json.JSONDecodeError as e:
            print(
                json.dumps(
                    {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {"code": -32700, "message": f"parse error: {e}"},
                    }
                ),
                flush=True,
            )
            continue
        if not isinstance(message, dict):  # e.g. a bare number or array
            print(
                json.dumps(
                    {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {
                            "code": -32600,
                            "message": "invalid request: not an object",
                        },
                    }
                ),
                flush=True,
            )
            continue
        task = asyncio.create_task(dispatch(message))
        pending.add(task)
        task.add_done_callback(pending.discard)
    if pending:  # EOF: drain in-flight requests before exiting
        await asyncio.gather(*pending, return_exceptions=True)


def _load_retriever(
    index_prefix: str,
    encoder_dir: Optional[str] = None,
    mesh: Optional[str] = None,
    kernel: Optional[str] = None,
    updatable: bool = False,
):
    from pathlib import Path

    from openintel_tpu.cli.main import check_index_meta
    from openintel_tpu.index.checkpoint import load_dense, load_postings
    from openintel_tpu.models.retrievers import HybridRetriever

    embedder = None
    if encoder_dir:
        from openintel_tpu.models.train import load_embedder

        embedder = load_embedder(encoder_dir)
    err = check_index_meta(index_prefix, encoder_dir, embedder)
    if err:
        raise RuntimeError(err.removeprefix("error: "))
    postings = load_postings(f"{index_prefix}.postings.npz")
    dense = load_dense(f"{index_prefix}.dense.npz")
    docs_path = Path(f"{index_prefix}.docs.txt")
    docs = docs_path.read_text().splitlines() if docs_path.exists() else None
    if mesh:
        from openintel_tpu.parallel.retriever import (
            ShardedHybridRetriever,
            parse_mesh_spec,
        )

        try:
            data, corpus = parse_mesh_spec(mesh)
        except ValueError as e:
            # composition error, not a crash: serve()'s handler reports it
            raise RuntimeError(f"--mesh {mesh}: {e}") from e
        if updatable:
            # the sharded live corpus (parallel/updatable.py): the main
            # segment shards over the mesh, adds ride the delta, deletes
            # tombstone through the filtered program
            from openintel_tpu.parallel.updatable import (
                ShardedUpdatableHybridRetriever,
            )

            return (
                ShardedUpdatableHybridRetriever(
                    postings, dense, embedder, data=data, corpus=corpus,
                    kernel=kernel, doc_store=docs,
                ),
                None,
            )
        return (
            ShardedHybridRetriever(
                postings, dense, embedder, data=data, corpus=corpus,
                kernel=kernel,
            ),
            docs,
        )
    if updatable:
        from openintel_tpu.models.updatable import UpdatableHybridRetriever

        return (
            UpdatableHybridRetriever(
                postings, dense, embedder, kernel=kernel,
                # the retriever's epoch owns the id-aligned snippet store
                # (ids and texts must move together across compactions);
                # None when no .docs.txt sidecar exists (no snippets)
                doc_store=docs,
            ),
            None,
        )
    return HybridRetriever(postings, dense, embedder, kernel=kernel), docs


def build_server(
    offline: bool = False,
    index: Optional[str] = None,
    encoder: Optional[str] = None,
    rerank: Optional[str] = None,
    mesh: Optional[str] = None,
    kernel: Optional[str] = None,
    updatable: bool = False,
    coalesce_max_batch: int = 256,
    coalesce_max_wait_ms: float = 2.0,
) -> OpenIntelServer:
    """Composition root (reference: src/mcp/server.rs:171-192)."""
    retriever, docs = (
        _load_retriever(index, encoder, mesh, kernel, updatable)
        if index
        else (None, None)
    )
    coalescer = None
    if retriever is not None and not updatable:
        # Production serving path: concurrent hybrid searches coalesce into
        # full device batches (the b=64 per-query-efficiency mitigation —
        # docs/benchmarks.md "Batch-64"). Updatable servers skip it: a live
        # corpus's id space moves between waves, and result texts must come
        # from the same epoch as the ids (search_with_docs).
        from openintel_tpu.serving import BatchCoalescer

        def _hybrid_search(queries, k=10, **filter_kw):
            # filter_kw: the coalescer's fused filter_mask/filter_group
            # when a wave carries filtered requests (serving.py)
            return retriever.search(
                queries, k=k, candidates_per_arm=2 * k, **filter_kw
            )

        coalescer = BatchCoalescer(
            _hybrid_search,
            max_batch=coalesce_max_batch,
            max_wait_ms=coalesce_max_wait_ms,
        )
    reranker = None
    if rerank and retriever is not None:
        from openintel_tpu.models.reranker import load_reranker

        reranker = load_reranker(rerank)
    if offline:
        from openintel_tpu.sources.fixtures import MockMarketSource, fixture_social
        from openintel_tpu.sources.yahoo import FixtureBars

        return OpenIntelServer(
            social=fixture_social(),
            market=MockMarketSource(),
            bars=FixtureBars(),
            pulse_feed=None,
            retriever=retriever,
            docs=docs,
            reranker=reranker,
            coalescer=coalescer,
            index_prefix=index,
            encoder_dir=encoder,
        )

    from openintel_tpu.config.secrets import Credentials
    from openintel_tpu.config.store import KeychainStore
    from openintel_tpu.sources import build_social_sources
    from openintel_tpu.sources.x import XPulseSource
    from openintel_tpu.sources.yahoo import YahooMarketSource

    credentials = Credentials.load(KeychainStore())
    social = build_social_sources(credentials)
    market = YahooMarketSource()
    pulse_feed = None
    if credentials.x_bearer:
        try:
            pulse_feed = XPulseSource(credentials.x_bearer)
        except Exception as e:  # pragma: no cover
            print(f"warning: x pulse disabled: {e}", file=sys.stderr)
    return OpenIntelServer(
        social=social, market=market, bars=market, pulse_feed=pulse_feed,
        retriever=retriever, docs=docs, reranker=reranker,
        coalescer=coalescer, index_prefix=index, encoder_dir=encoder,
    )


def serve(
    offline: bool = False,
    index: Optional[str] = None,
    encoder: Optional[str] = None,
    rerank: Optional[str] = None,
    mesh: Optional[str] = None,
    kernel: Optional[str] = None,
    updatable: bool = False,
) -> None:
    asyncio.run(
        serve_stdio(
            build_server(
                offline=offline, index=index, encoder=encoder, rerank=rerank,
                mesh=mesh, kernel=kernel, updatable=updatable,
            )
        )
    )
