"""Vectorised, jittable batch variant of the SpeculationEngine.

Scores B tickers at once on device — the batched analogue of the reference's
async fan-out over tickers in ``run_scan`` / ``run_compare``
(reference: src/mcp/tools.rs:159-174, :268-275). Semantics are bit-identical to
:class:`openintel_tpu.domain.engine.SpeculationEngine` (asserted by tests that
cross-check against the pure-Python path), but everything is arrays:

- per-post signals arrive as padded ``(B, N)`` arrays with a validity mask;
- market fields arrive as ``(B,)`` arrays with presence masks
  (NaN/absent components renormalise out of the crowding blend exactly like the
  reference's ``Option`` handling, src/domain/engine/speculation_engine.rs:151-176);
- categorical outputs (alignment, confidence) are integer codes.

Alignment codes: 0=confirming_bullish, 1=confirming_bearish, 2=diverging, 3=quiet.
Confidence codes: 0=low, 1=medium, 2=high.
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from openintel_tpu.domain.engine import EngineConfig
from openintel_tpu.domain.values import Alignment, Confidence

ALIGNMENT_CODES: tuple[Alignment, ...] = (
    Alignment.CONFIRMING_BULLISH,
    Alignment.CONFIRMING_BEARISH,
    Alignment.DIVERGING,
    Alignment.QUIET,
)
CONFIDENCE_CODES: tuple[Confidence, ...] = (
    Confidence.LOW,
    Confidence.MEDIUM,
    Confidence.HIGH,
)


@jax.tree_util.register_dataclass
@dataclass
class BatchSignals:
    """Padded per-post analyzer outputs for a batch of B tickers."""

    polarity: jax.Array  # (B, N) f32, clamped to [-1, 1]
    speculative: jax.Array  # (B, N) bool
    valid: jax.Array  # (B, N) bool — padding mask


@jax.tree_util.register_dataclass
@dataclass
class BatchMarket:
    """Market snapshot fields for a batch of B tickers, with presence masks."""

    present: jax.Array  # (B,) bool — snapshot available at all
    last_price: jax.Array  # (B,) f32
    previous_close: jax.Array  # (B,) f32
    volume: jax.Array  # (B,) f32
    avg_volume: jax.Array  # (B,) f32
    iv_rank: jax.Array  # (B,) f32
    iv_present: jax.Array  # (B,) bool


@jax.tree_util.register_dataclass
@dataclass
class BatchReport:
    """Array-of-structs report for B tickers."""

    total_mentions: jax.Array  # (B,) i32
    net_sentiment: jax.Array  # (B,) f32
    bullish: jax.Array  # (B,) i32
    bearish: jax.Array  # (B,) i32
    neutral: jax.Array  # (B,) i32
    speculation_index: jax.Array  # (B,) f32
    pct_change: jax.Array  # (B,) f32 (0 where market absent or prev_close 0)
    rvol: jax.Array  # (B,) f32 (NaN where unavailable)
    crowding: jax.Array  # (B,) f32
    alignment: jax.Array  # (B,) i32 code
    confidence: jax.Array  # (B,) i32 code


@partial(jax.jit, static_argnames=("cfg",))
def aggregate_batch(
    signals: BatchSignals, market: BatchMarket, cfg: EngineConfig
) -> BatchReport:
    """Fuse a batch of ticker signal sets in one device program."""
    valid = signals.valid
    # clamp [-1, 1] AND collapse NaN to 0 — Polarity's exact rule (the pure
    # engine's value object does this in __post_init__; parity is promised)
    pol = jnp.where(
        valid & ~jnp.isnan(signals.polarity),
        jnp.clip(signals.polarity, -1.0, 1.0),
        0.0,
    )
    spec = jnp.logical_and(signals.speculative, valid)

    total = jnp.sum(valid, axis=1).astype(jnp.int32)  # (B,)
    totalf = total.astype(jnp.float32)
    has_posts = total > 0

    polarity_sum = jnp.sum(pol, axis=1)
    net = jnp.where(has_posts, polarity_sum / jnp.maximum(totalf, 1.0), 0.0)

    tau = cfg.bull_bear_threshold
    bullish = jnp.sum(jnp.logical_and(valid, pol > tau), axis=1).astype(jnp.int32)
    bearish = jnp.sum(jnp.logical_and(valid, pol < -tau), axis=1).astype(jnp.int32)
    neutral = total - bullish - bearish
    spec_count = jnp.sum(spec, axis=1).astype(jnp.float32)
    spec_index = jnp.where(has_posts, spec_count / jnp.maximum(totalf, 1.0), 0.0)

    # --- market summary (zero-guards mirror the reference) ---
    prev_ok = market.previous_close != 0.0
    pct_change = jnp.where(
        jnp.logical_and(market.present, prev_ok),
        (market.last_price - market.previous_close)
        / jnp.where(prev_ok, market.previous_close, 1.0)
        * 100.0,
        0.0,
    )
    # the scalar engine guards only avg_volume == 0 (a negative avg still
    # yields an rvol); the where-in-where keeps the division exact for any
    # non-zero denominator while avoiding div-by-zero on masked rows
    rvol_ok = jnp.logical_and(market.present, market.avg_volume != 0.0)
    rvol = jnp.where(
        rvol_ok,
        market.volume / jnp.where(rvol_ok, market.avg_volume, 1.0),
        jnp.nan,
    )

    # --- crowding: renormalised blend over present components ---
    w_spec = jnp.where(has_posts, cfg.crowding_weight_spec, 0.0)
    w_rvol = jnp.where(rvol_ok, cfg.crowding_weight_rvol, 0.0)
    iv_ok = jnp.logical_and(market.present, market.iv_present)
    w_iv = jnp.where(iv_ok, cfg.crowding_weight_iv, 0.0)
    rvol_norm = jnp.clip(jnp.where(rvol_ok, rvol, 0.0) / cfg.rvol_cap, 0.0, 1.0)
    iv_norm = jnp.clip(jnp.where(iv_ok, market.iv_rank, 0.0), 0.0, 1.0)
    weighted = w_spec * spec_index + w_rvol * rvol_norm + w_iv * iv_norm
    weight_sum = w_spec + w_rvol + w_iv
    crowding = jnp.where(
        weight_sum > 0.0,
        jnp.clip(weighted / jnp.maximum(weight_sum, 1e-12), 0.0, 1.0),
        0.0,
    )

    # --- alignment gates ---
    meaningful = jnp.logical_and(
        jnp.abs(net) >= cfg.net_sentiment_threshold,
        jnp.abs(pct_change) >= cfg.price_move_threshold,
    )
    gated = jnp.logical_and(
        market.present,
        jnp.logical_and(total >= cfg.min_sample, meaningful),
    )
    bull_case = jnp.logical_and(net > 0.0, pct_change > 0.0)
    bear_case = jnp.logical_and(net < 0.0, pct_change < 0.0)
    alignment = jnp.where(
        gated,
        jnp.where(bull_case, 0, jnp.where(bear_case, 1, 2)),
        3,
    ).astype(jnp.int32)

    lo = min(cfg.confidence_low, cfg.confidence_high)
    hi = max(cfg.confidence_low, cfg.confidence_high)
    confidence = (
        (total >= lo).astype(jnp.int32) + (total >= hi).astype(jnp.int32)
    )

    return BatchReport(
        total_mentions=total,
        net_sentiment=net,
        bullish=bullish,
        bearish=bearish,
        neutral=neutral,
        speculation_index=spec_index,
        pct_change=pct_change,
        rvol=rvol,
        crowding=crowding,
        alignment=alignment,
        confidence=confidence,
    )


# ---------------------------------------------------------------------------
# Host-side pack / unpack: the production scan path (mcp.tools.run_scan /
# run_compare via application.analyze_batch) packs every ticker's analyzer
# outputs into ONE aggregate_batch device call and reassembles full
# SpeculationReport entities from the columns, with note/field parity to the
# scalar engine (asserted by a randomized cross-check in tests).
# ---------------------------------------------------------------------------


def pack_batch(inputs: Sequence[tuple]) -> tuple["BatchSignals", "BatchMarket"]:
    """Pack [(posts, signals, market_snapshot_or_None), ...] into padded
    device arrays. Post counts pad to the batch max (masked by ``valid``)."""
    b = len(inputs)
    n = max((len(sig) for _, sig, _ in inputs), default=0) or 1
    pol = np.zeros((b, n), np.float32)
    spec = np.zeros((b, n), bool)
    valid = np.zeros((b, n), bool)
    present = np.zeros(b, bool)
    last = np.zeros(b, np.float32)
    prev = np.zeros(b, np.float32)
    vol = np.zeros(b, np.float32)
    avgv = np.zeros(b, np.float32)
    ivr = np.zeros(b, np.float32)
    ivp = np.zeros(b, bool)
    for i, (posts, signals, market) in enumerate(inputs):
        if len(signals) != len(posts):
            from openintel_tpu.errors import AnalyzerMismatch

            raise AnalyzerMismatch(expected=len(posts), got=len(signals))
        m = len(signals)
        if m:
            pol[i, :m] = [s.polarity.value for s in signals]
            spec[i, :m] = [s.speculative for s in signals]
            valid[i, :m] = True
        if market is not None:
            present[i] = True
            last[i] = market.last_price
            prev[i] = market.previous_close
            vol[i] = market.volume
            avgv[i] = market.avg_volume
            if market.iv_rank is not None:
                ivr[i] = market.iv_rank
                ivp[i] = True
    return (
        BatchSignals(
            polarity=jnp.asarray(pol),
            speculative=jnp.asarray(spec),
            valid=jnp.asarray(valid),
        ),
        BatchMarket(
            present=jnp.asarray(present),
            last_price=jnp.asarray(last),
            previous_close=jnp.asarray(prev),
            volume=jnp.asarray(vol),
            avg_volume=jnp.asarray(avgv),
            iv_rank=jnp.asarray(ivr),
            iv_present=jnp.asarray(ivp),
        ),
    )


def reports_from_batch(
    tickers: Sequence,
    inputs: Sequence[tuple],
    batch: "BatchReport",
    now: dt.datetime,
    notes_per_ticker: Optional[Sequence[list]] = None,
) -> list:
    """Assemble SpeculationReport entities from BatchReport columns.

    Mirrors SpeculationEngine.aggregate's assembly exactly, including the
    market-summary / social-only notes and their order; ``notes_per_ticker``
    (orchestration notes) are prepended like analyze() does."""
    from openintel_tpu.domain.entities import (
        FusionSignals,
        MarketSummary,
        SocialSummary,
        SpeculationReport,
    )
    from openintel_tpu.domain.values import Polarity, SpeculationIndex

    cols = {
        k: np.asarray(getattr(batch, k))
        for k in (
            "total_mentions", "net_sentiment", "bullish", "bearish", "neutral",
            "speculation_index", "pct_change", "rvol", "crowding", "alignment",
            "confidence",
        )
    }
    out = []
    for i, (ticker, (posts, _signals, market)) in enumerate(zip(tickers, inputs)):
        notes: list[str] = list(
            notes_per_ticker[i] if notes_per_ticker is not None else []
        )
        by_source: dict[str, int] = {}
        for p in posts:
            by_source[p.source.value] = by_source.get(p.source.value, 0) + 1
        bullish = int(cols["bullish"][i])
        bearish = int(cols["bearish"][i])
        social = SocialSummary(
            total_mentions=int(cols["total_mentions"][i]),
            mentions_by_source=by_source,
            net_sentiment=Polarity(float(cols["net_sentiment"][i])),
            bullish=bullish,
            bearish=bearish,
            neutral=int(cols["neutral"][i]),
            bull_bear_ratio=None if bearish == 0 else bullish / bearish,
            speculation_index=SpeculationIndex(
                float(cols["speculation_index"][i])
            ),
        )
        market_summary = None
        if market is not None:
            if market.previous_close == 0.0:
                notes.append("previous_close is 0; pct_change set to 0")
            if market.avg_volume == 0:
                notes.append("avg_volume is 0; rvol unavailable")
            rvol = float(cols["rvol"][i])
            market_summary = MarketSummary(
                last_price=market.last_price,
                pct_change=float(cols["pct_change"][i]),
                rvol=None if np.isnan(rvol) else rvol,
                realized_vol=market.realized_vol,
                put_call_ratio=market.put_call_ratio,
                iv_rank=market.iv_rank,
            )
        else:
            notes.append("social-only, no price reference")
        out.append(
            SpeculationReport(
                ticker=ticker,
                generated_at=now,
                social=social,
                market=market_summary,
                fusion=FusionSignals(
                    alignment=ALIGNMENT_CODES[int(cols["alignment"][i])],
                    crowding=float(cols["crowding"][i]),
                    notes=notes,
                ),
                social_confidence=CONFIDENCE_CODES[int(cols["confidence"][i])],
            )
        )
    return out
