"""The analyze use case: concurrent source fan-out -> analyzer -> engine.

Graceful-degradation semantics (reference: src/application/analyze.rs:16-73):
- enabled-but-unwired source -> note;
- per-source fetch failure -> note, never a crash;
- market failure -> note + social-only report;
- all-empty input -> NoData;
- orchestration notes are prepended to engine notes.
"""

from __future__ import annotations

import asyncio
import datetime as dt
from typing import Optional, Sequence

from openintel_tpu.application.request import AnalysisRequest
from openintel_tpu.domain.engine import SpeculationEngine
from openintel_tpu.domain.entities import (
    MarketSnapshot,
    SocialPost,
    SpeculationReport,
    Ticker,
)
from openintel_tpu.domain.ports import MarketDataSource, PostAnalyzer, SocialDataSource
from openintel_tpu.errors import NoData


async def gather_inputs(
    req: AnalysisRequest,
    social_sources: Sequence[SocialDataSource],
    market_source: Optional[MarketDataSource],
    analyzer: Optional[PostAnalyzer] = None,
):
    """The IO half of analyze: fetch + score, no aggregation.

    Returns (ticker, posts, signals, market, orchestration_notes); raises
    NoData when every input is empty. Shared by the scalar path and the
    device-batched scan path (analyze_batch)."""
    ticker = Ticker.parse(req.ticker)

    notes: list[str] = []
    for kind in req.enabled_sources:
        if not any(s.kind == kind for s in social_sources):
            notes.append(f"{kind.value} enabled but not configured")

    enabled = [s for s in social_sources if s.kind in req.enabled_sources]

    async def fetch_one(source: SocialDataSource):
        try:
            return source.kind, await source.fetch(ticker, req.limit), None
        except Exception as e:  # graceful degradation: failure -> note
            return source.kind, None, e

    results = await asyncio.gather(*(fetch_one(s) for s in enabled))

    posts: list[SocialPost] = []
    for kind, fetched, err in results:
        if err is not None:
            notes.append(f"source {kind.value} failed: {err}")
        else:
            posts.extend(fetched)

    market: Optional[MarketSnapshot] = None
    if req.market_enabled and market_source is not None:
        try:
            market = await market_source.snapshot(ticker)
        except Exception as e:
            notes.append(f"market source failed: {e}")

    if not posts and market is None:
        raise NoData()

    if analyzer is None:
        from openintel_tpu.models.lexicon import LexiconAnalyzer

        analyzer = LexiconAnalyzer()
    signals = await analyzer.analyze(posts)
    return ticker, posts, signals, market, notes


async def analyze(
    req: AnalysisRequest,
    social_sources: Sequence[SocialDataSource],
    market_source: Optional[MarketDataSource],
    analyzer: Optional[PostAnalyzer] = None,
    now: Optional[dt.datetime] = None,
) -> SpeculationReport:
    ticker, posts, signals, market, notes = await gather_inputs(
        req, social_sources, market_source, analyzer
    )
    report = SpeculationEngine.aggregate(
        ticker,
        posts,
        signals,
        market,
        now or dt.datetime.now(dt.timezone.utc),
        req.engine,
    )
    report.fusion.notes = notes + report.fusion.notes
    return report


async def analyze_batch(
    reqs: Sequence[AnalysisRequest],
    social_sources: Sequence[SocialDataSource],
    market_source: Optional[MarketDataSource],
    analyzer: Optional[PostAnalyzer] = None,
    now: Optional[dt.datetime] = None,
) -> list:
    """Batched analyze: IO fans out per ticker concurrently, then ALL tickers
    aggregate in ONE device program (engine_batch.aggregate_batch) — the
    batched analogue of the reference's join_all over tickers
    (reference: src/mcp/tools.rs:159-174).

    Returns one entry per request: a SpeculationReport, or the Exception that
    ticker raised (one bad ticker never fails the batch)."""
    from openintel_tpu.domain.engine_batch import (
        aggregate_batch,
        pack_batch,
        reports_from_batch,
    )

    async def one(req: AnalysisRequest):
        try:
            return await gather_inputs(req, social_sources, market_source, analyzer), None
        except Exception as e:
            return None, e

    results = await asyncio.gather(*(one(r) for r in reqs))
    out: list = [e for _, e in results]
    # one aggregate_batch per distinct EngineConfig (it's a static jit arg;
    # scans share a single config in practice, so this is one device call)
    groups: dict = {}
    for i, (g, e) in enumerate(results):
        if e is None:
            groups.setdefault(reqs[i].engine, []).append(i)
    when = now or dt.datetime.now(dt.timezone.utc)
    for cfg, idxs in groups.items():
        inputs = [
            (results[i][0][1], results[i][0][2], results[i][0][3]) for i in idxs
        ]
        tickers = [results[i][0][0] for i in idxs]
        notes = [results[i][0][4] for i in idxs]
        batch_sig, batch_mkt = pack_batch(inputs)
        report_cols = aggregate_batch(batch_sig, batch_mkt, cfg)
        reports = reports_from_batch(
            tickers, inputs, report_cols, when, notes_per_ticker=notes
        )
        for j, i in enumerate(idxs):
            out[i] = reports[j]
    return out
