"""Lexicon sentiment analyzer — the degenerate BM25 case, vectorised on device.

Semantics match the reference analyzer exactly
(reference: src/adapters/analyzer/lexicon.rs:9-73): per post, tokenise
(lowercase, split on non-alphanumeric), count exact-token membership in the
BULL / BEAR / JARGON term lists; polarity = (bull - bear) / (bull + bear) or 0;
speculative = any jargon hit.

Device-first design: instead of three per-token list scans, posts encode to a
padded ``(B, L)`` id matrix over a shared vocabulary and score as a single
jitted table-gather + masked reduction — one device program for the whole
batch. The term lists are the seed vocabulary, making sentiment scoring a
binary-idf special case of the BM25 machinery (SURVEY.md §7 step 1).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from openintel_tpu.domain.entities import SocialPost
from openintel_tpu.domain.values import PostSignal
from openintel_tpu.ops.tokenizer import Vocab, encode_padded, tokenize_batch

# Seed sentiment vocabulary (term lists from reference lexicon.rs:9-44).
BULL_TERMS = (
    "moon", "calls", "long", "buy", "bullish", "squeeze", "breakout",
    "rocket", "pump", "rip", "green", "up", "rally", "bull",
)
BEAR_TERMS = (
    "puts", "short", "sell", "bearish", "dump", "crash", "drilling",
    "bagholder", "rug", "red", "down", "tank", "bear",
)
JARGON_TERMS = (
    "calls", "puts", "0dte", "yolo", "leaps", "theta", "gamma", "squeeze",
    "otm", "itm", "strike", "iv", "delta", "vega", "contracts",
)


def _build_lexicon_tables() -> tuple[Vocab, np.ndarray]:
    """Vocab over the union of the three lists plus a (V, 3) flag table
    (columns: bull, bear, jargon). Row 0 is the padding/unknown slot."""
    vocab = Vocab()
    for term in (*BULL_TERMS, *BEAR_TERMS, *JARGON_TERMS):
        vocab.add(term)
    flags = np.zeros((vocab.size, 3), dtype=np.float32)
    for term in BULL_TERMS:
        flags[vocab.token_to_id[term], 0] = 1.0
    for term in BEAR_TERMS:
        flags[vocab.token_to_id[term], 1] = 1.0
    for term in JARGON_TERMS:
        flags[vocab.token_to_id[term], 2] = 1.0
    return vocab, flags


_LEX_VOCAB, _LEX_FLAGS = _build_lexicon_tables()


@partial(jax.jit, static_argnums=())
def score_token_ids(
    token_ids: jax.Array,  # (B, L) int32, PAD_ID = 0 for padding/unknown
    valid: jax.Array,  # (B, L) bool
    flags: jax.Array,  # (V, 3) f32 — bull/bear/jargon membership
) -> tuple[jax.Array, jax.Array]:
    """Batch lexicon scoring: returns (polarity (B,), speculative (B,) bool)."""
    hit = flags[token_ids] * valid[..., None]  # (B, L, 3)
    counts = jnp.sum(hit, axis=1)  # (B, 3)
    bull, bear, jargon = counts[:, 0], counts[:, 1], counts[:, 2]
    denom = bull + bear
    polarity = jnp.where(denom > 0.0, (bull - bear) / jnp.maximum(denom, 1.0), 0.0)
    speculative = jargon > 0.0
    return polarity, speculative


# Below this batch size the kernel-launch/compile overhead dwarfs the math;
# score in NumPy (identical integer-count arithmetic, exact same results).
DEVICE_BATCH_THRESHOLD = 512


def score_token_ids_np(
    token_ids: np.ndarray, valid: np.ndarray, flags: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`score_token_ids` (asserted identical in tests)."""
    hit = flags[token_ids] * valid[..., None]
    counts = hit.sum(axis=1)
    bull, bear, jargon = counts[:, 0], counts[:, 1], counts[:, 2]
    denom = bull + bear
    polarity = np.where(denom > 0.0, (bull - bear) / np.maximum(denom, 1.0), 0.0)
    return polarity, jargon > 0.0


def score_texts(texts: Sequence[str]) -> list[PostSignal]:
    """Tokenise + encode on host; score the batch in one program (device for
    large batches, NumPy for small ones — identical results)."""
    if not texts:
        return []
    tokens = tokenize_batch(texts)
    ids, mask = encode_padded(tokens, _LEX_VOCAB)
    if len(texts) < DEVICE_BATCH_THRESHOLD:
        polarity, speculative = score_token_ids_np(ids, mask, _LEX_FLAGS)
    else:
        out = score_token_ids(ids, mask, _LEX_FLAGS)
        polarity, speculative = np.asarray(out[0]), np.asarray(out[1])
    return [
        PostSignal.of(float(p), bool(s)) for p, s in zip(polarity, speculative)
    ]


class LexiconAnalyzer:
    """PostAnalyzer port implementation (reference: src/domain/ports/post_analyzer.rs:8-11).

    Returns one signal per post, order-aligned with the input."""

    async def analyze(self, posts: Sequence[SocialPost]) -> list[PostSignal]:
        return score_texts([p.text.as_str() for p in posts])
