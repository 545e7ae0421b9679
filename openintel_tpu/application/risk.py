"""The risk use case: fetch bars, default entry to last close, run the pure
frame math (reference: src/application/risk.rs:12-44). ``risk_screen`` is the
batched variant: bars fan out per ticker, ATR(14) computes for the whole
screen in one device call (domain.risk.atr_batch)."""

from __future__ import annotations

import asyncio
import datetime as dt
import math
from typing import Optional, Sequence

from openintel_tpu.domain.entities import Ticker
from openintel_tpu.domain.ports import BarSource
from openintel_tpu.domain.risk import ATR_PERIOD, RiskFrame, frame
from openintel_tpu.errors import SourceFailure

DEFAULT_STOP_MULTIPLE = 2.0


async def risk_frame(
    ticker_raw: str,
    direction: str,
    budget_usd: float,
    stop_multiple: Optional[float],
    entry: Optional[float],
    bars: BarSource,
    now: dt.datetime,
) -> RiskFrame:
    ticker = Ticker.parse(ticker_raw)
    history = await bars.bars(ticker)
    if entry is None:
        if not history:
            raise SourceFailure(name="risk", message="no price history")
        entry = history[-1].close
    return frame(
        ticker.as_str(),
        history,
        direction,
        entry,
        budget_usd,
        stop_multiple if stop_multiple is not None else DEFAULT_STOP_MULTIPLE,
        now,
    )


async def risk_screen(
    tickers: Sequence[str],
    direction: str,
    budget_usd: float,
    stop_multiple: Optional[float],
    bars: BarSource,
    now: dt.datetime,
) -> list:
    """Batch risk screen: one RiskFrame (or the per-ticker Exception) per
    ticker. Bars fetch concurrently; the ATR(14) for every ticker computes in
    ONE device program (atr_batch over front-padded (B, T) bar arrays —
    front padding replicates the first bar, so the trailing ATR window stays
    identical to the scalar path whenever enough real history exists)."""
    import numpy as np

    from openintel_tpu.domain.risk import atr_batch

    async def fetch(t: str):
        try:
            ticker = Ticker.parse(t)
            return ticker, await bars.bars(ticker), None
        except Exception as e:
            return None, None, e

    fetched = await asyncio.gather(*(fetch(t) for t in tickers))
    out: list = [err for _, _, err in fetched]

    # device-batchable tickers: finite history, long enough for the window
    batch_idx = []
    for i, (ticker, history, err) in enumerate(fetched):
        if err is not None:
            continue
        if len(history) < ATR_PERIOD + 1:
            out[i] = SourceFailure(
                name="risk", message=f"not enough history for ATR({ATR_PERIOD})"
            )
            continue
        if any(
            not (
                math.isfinite(b.high)
                and math.isfinite(b.low)
                and math.isfinite(b.close)
            )
            for b in history
        ):
            out[i] = SourceFailure(
                name="risk", message="price history contains invalid values"
            )
            continue
        batch_idx.append(i)

    if batch_idx:
        t_max = max(len(fetched[i][1]) for i in batch_idx)
        b = len(batch_idx)
        high = np.zeros((b, t_max), np.float32)
        low = np.zeros((b, t_max), np.float32)
        close = np.zeros((b, t_max), np.float32)
        for j, i in enumerate(batch_idx):
            hist = fetched[i][1]
            pad = t_max - len(hist)
            rows = [(bar.high, bar.low, bar.close) for bar in hist]
            arr = np.asarray([rows[0]] * pad + rows, np.float32)
            high[j], low[j], close[j] = arr[:, 0], arr[:, 1], arr[:, 2]
        atrs = np.asarray(atr_batch(high, low, close))
        for j, i in enumerate(batch_idx):
            ticker, history, _ = fetched[i]
            try:
                entry = history[-1].close
                out[i] = frame(
                    ticker.as_str(),
                    history,
                    direction,
                    entry,
                    budget_usd,
                    stop_multiple
                    if stop_multiple is not None
                    else DEFAULT_STOP_MULTIPLE,
                    now,
                    atr_value=float(atrs[j]),
                )
            except Exception as e:
                out[i] = e
    return out
