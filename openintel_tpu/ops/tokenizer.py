"""Tokenisation and vocabulary encoding.

Tokeniser semantics match the reference's analyzer exactly: lowercase the
text, split on any character that is not ASCII-alphanumeric, drop empties
(reference: src/adapters/analyzer/lexicon.rs:53-58). This is the single
tokenisation rule for the whole framework (lexicon scoring, BM25 postings,
query encoding), so lexicon sentiment scoring is the degenerate BM25 case.

A streaming C++ tokeniser (openintel_tpu/native) accelerates index builds;
:func:`tokenize` transparently uses it when the extension is built. Both paths
are asserted identical in tests.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[0-9a-z]+")

# Filled in by openintel_tpu.native when the C++ extension is available.
_native_tokenize_batch = None


def tokenize(text: str) -> list[str]:
    """Lowercase, split on non-ASCII-alphanumeric, drop empties."""
    return _TOKEN_RE.findall(text.lower())


def tokenize_batch(texts: Sequence[str]) -> list[list[str]]:
    """Tokenise many texts; uses the native C++ tokeniser when built."""
    if _native_tokenize_batch is not None:
        return _native_tokenize_batch(list(texts))
    return [tokenize(t) for t in texts]


PAD_ID = 0  # id 0 is reserved padding; real tokens start at 1


@dataclass
class Vocab:
    """Token -> id table. Id 0 is reserved for padding; unknown tokens map to 0
    at encode time (they can never score)."""

    token_to_id: dict[str, int] = field(default_factory=dict)

    @property
    def size(self) -> int:
        """Table size including the padding slot."""
        return len(self.token_to_id) + 1

    def add(self, token: str) -> int:
        tid = self.token_to_id.get(token)
        if tid is None:
            tid = len(self.token_to_id) + 1
            self.token_to_id[token] = tid
        return tid

    @staticmethod
    def build(token_lists: Iterable[Sequence[str]]) -> "Vocab":
        v = Vocab()
        for tokens in token_lists:
            for t in tokens:
                v.add(t)
        return v

    def encode(self, tokens: Sequence[str]) -> list[int]:
        get = self.token_to_id.get
        return [get(t, PAD_ID) for t in tokens]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def encode_padded(
    token_lists: Sequence[Sequence[str]],
    vocab: Vocab,
    *,
    pad_multiple: int = 128,
    max_len: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode token lists into a padded ``(B, L)`` id matrix plus validity mask.

    L is the longest list rounded up to ``pad_multiple`` (a lane-friendly width) so the
    arrays tile cleanly onto vector units. Unknown tokens encode as PAD_ID but stay
    *valid* (they count toward document length, like any un-scorable token).
    """
    ids = [vocab.encode(t) for t in token_lists]
    longest = max((len(i) for i in ids), default=0)
    if max_len is not None:
        longest = min(longest, max_len)
        ids = [i[:max_len] for i in ids]
    width = max(round_up(max(longest, 1), pad_multiple), pad_multiple)
    out = np.zeros((len(ids), width), dtype=np.int32)
    mask = np.zeros((len(ids), width), dtype=bool)
    for r, row in enumerate(ids):
        out[r, : len(row)] = row
        mask[r, : len(row)] = True
    return out, mask
