"""Ports: protocol classes at the host/ingest boundary.

The reference defines five async trait ports so the pure core can be driven by
hermetic fakes (reference: src/domain/ports/*.rs). In this rebuild, ports
exist only at the host boundary — on-device there are no traits, only arrays.

- SocialDataSource {kind, fetch(ticker, limit)} (src/domain/ports/social_data_source.rs:9-12)
- MarketDataSource {name, snapshot} (src/domain/ports/market_data_source.rs:8-11)
- PostAnalyzer {analyze: one signal per post, order-aligned} (src/domain/ports/post_analyzer.rs:8-11)
- BarSource {bars} — separate from MarketDataSource so snapshot consumers stay
  untouched (src/domain/ports/bar_source.rs:7-12)
- InfluencerFeed {pulse} — paid, opt-in-only, returns the billed count
  (src/domain/ports/influencer_feed.rs:10-23)
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from openintel_tpu.domain.entities import (
    MarketSnapshot,
    PulseFetch,
    SocialPost,
    Ticker,
)
from openintel_tpu.domain.values import Bar, PostSignal, SourceKind


@runtime_checkable
class SocialDataSource(Protocol):
    @property
    def kind(self) -> SourceKind: ...

    async def fetch(self, ticker: Ticker, limit: int) -> list[SocialPost]: ...


@runtime_checkable
class MarketDataSource(Protocol):
    @property
    def name(self) -> str: ...

    async def snapshot(self, ticker: Ticker) -> MarketSnapshot: ...


@runtime_checkable
class PostAnalyzer(Protocol):
    async def analyze(self, posts: Sequence[SocialPost]) -> list[PostSignal]: ...


@runtime_checkable
class BarSource(Protocol):
    async def bars(self, ticker: Ticker) -> list[Bar]: ...


@runtime_checkable
class InfluencerFeed(Protocol):
    async def pulse(
        self,
        ticker: Ticker,
        accounts: Sequence[str],
        keywords: Sequence[str],
        hours_back: int,
        limit: int,
    ) -> PulseFetch: ...
