"""Index schema: CSR postings over terms, dense embedding index, BM25 stats.

Device-first layout decisions:
- postings are term-major CSR (term_offsets / doc_ids / tf), with doc ids
  ascending within each term — deterministic merges and monotonic scatters;
- per-posting *impacts* (the length-normalised saturated tf) are precomputed at
  build time, so query-time work is a pure gather-scale-scatter: contribution =
  idf(t) * qtf * impact(t, d). This fuses the tf/idf saturation into the index,
  the Pallas-side analogue of BASELINE.json's "SpMV with tf/idf saturation
  fused in";
- the dense index stores L2-normalised embeddings so cosine == dot (one matmul), with
  optional bfloat16 storage for HBM footprint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from openintel_tpu.ops.tokenizer import Vocab


@dataclass(frozen=True)
class BM25Config:
    """Okapi BM25 constants. idf = ln(1 + (N - df + 0.5)/(df + 0.5)) (always
    positive, Lucene-style); sat(tf, dl) = tf*(k1+1) / (tf + k1*(1 - b + b*dl/avgdl))."""

    k1: float = 1.2
    b: float = 0.75


@dataclass
class PostingsIndex:
    """Term-major CSR postings with fused impacts.

    ``impact_order`` optionally holds, per term segment, the absolute posting
    indices sorted by (-impact, doc_id) — the impact-ordered view used for
    top-M pruned scoring at scale (the impact-sorted-index technique: common
    query terms contribute only their M highest-impact postings, bounding the
    device plan width while keeping recall@k near-exact)."""

    term_offsets: np.ndarray  # (V+1,) int64 — CSR row pointers per term id
    doc_ids: np.ndarray  # (nnz,) int32 — ascending within each term
    tf: np.ndarray  # (nnz,) float32 — raw term frequencies
    impact: np.ndarray  # (nnz,) float32 — sat(tf, doc_len) precomputed
    df: np.ndarray  # (V,) int32
    idf: np.ndarray  # (V,) float32
    doc_len: np.ndarray  # (N,) float32
    avgdl: float
    n_docs: int
    vocab: Vocab
    config: BM25Config
    impact_order: Optional[np.ndarray] = None  # (nnz,) int64, lazy
    # max_m -> (offsets, doc_ids, impacts): per-term doc-sorted top-M view
    # consumed by the C++ planner's emit phase (pruned_cache); lazy
    _pruned_cache: Optional[dict] = None
    # min_df -> (slots (V,) i32, words (n_big, ceil(N/64)) u64): postings
    # membership bitmaps for high-df terms (bitmap_cache); lazy
    _bitmap_cache: Optional[dict] = None

    @property
    def nnz(self) -> int:
        return int(self.doc_ids.shape[0])

    def postings(self, term_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids, impacts) slice for one term id."""
        lo, hi = int(self.term_offsets[term_id]), int(self.term_offsets[term_id + 1])
        return self.doc_ids[lo:hi], self.impact[lo:hi]

    def ensure_impact_order(self) -> np.ndarray:
        """Build (or return) the per-term impact-descending permutation.

        One global lexsort keyed (term, -impact, doc) — identical to a
        per-term lexsort but without V Python-level sort calls (a 30k-term
        vocab at 1M+ docs stalls the first pruned query for seconds
        otherwise)."""
        if self.impact_order is None:
            if self.nnz == 0:
                self.impact_order = np.zeros(0, dtype=np.int64)
                return self.impact_order
            seg_lens = np.diff(self.term_offsets).astype(np.int64)
            term_of = np.repeat(
                np.arange(seg_lens.shape[0], dtype=np.int64), seg_lens
            )
            self.impact_order = np.lexsort(
                (self.doc_ids, -self.impact, term_of)
            ).astype(np.int64)
        return self.impact_order

    def pruned_postings(
        self, term_id: int, max_m: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids, impacts) of the term's top-``max_m`` postings by impact."""
        order = self.ensure_impact_order()
        lo, hi = int(self.term_offsets[term_id]), int(self.term_offsets[term_id + 1])
        sel = order[lo : min(hi, lo + max_m)]
        return self.doc_ids[sel], self.impact[sel]

    def pruned_cache(
        self, max_m: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every term's top-``max_m``-by-impact postings, doc-ascending, as
        one contiguous CSR triple (offsets (V+1,) i64, doc_ids i32,
        impacts f32).

        The C++ planner's emit phase reads a pruned term's contribution
        straight from these slices (a linear copy) instead of three
        dependent random gathers per posting through ``impact_order`` plus
        a per-term sort — measured ~20% of plan-build cost at bench scale.
        The selected SET per term is identical to :meth:`pruned_postings`
        (same (-impact, doc) tie-breaking); only the emission order differs,
        and plan rows are doc-sorted afterwards either way. Built once per
        distinct ``max_m`` and memoized on the index."""
        if self._pruned_cache is None:
            self._pruned_cache = {}
        hit = self._pruned_cache.get(max_m)
        if hit is not None:
            return hit
        order = self.ensure_impact_order()
        seg = np.diff(self.term_offsets).astype(np.int64)
        take = np.minimum(seg, max_m)
        offs = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(take, dtype=np.int64)]
        )
        if self.nnz and offs[-1] > 0:
            pos_in_seg = np.arange(self.nnz, dtype=np.int64) - np.repeat(
                self.term_offsets[:-1].astype(np.int64), seg
            )
            sel = order[pos_in_seg < np.repeat(take, seg)]
            docs = self.doc_ids[sel]
            imps = self.impact[sel]
            term_of = np.repeat(np.arange(seg.shape[0], dtype=np.int64), take)
            o2 = np.lexsort((docs, term_of))
            docs = np.ascontiguousarray(docs[o2], dtype=np.int32)
            imps = np.ascontiguousarray(imps[o2], dtype=np.float32)
        else:
            docs = np.zeros(0, np.int32)
            imps = np.zeros(0, np.float32)
        out = (offs, docs, imps)
        self._pruned_cache[max_m] = out
        return out

    def bitmap_cache(
        self, min_df: int
    ) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Postings membership bitmaps for every term with df >= ``min_df``:
        (slots (V,) int32 — bitmap row index or -1, words (n_big,
        ceil(N/64)) uint64 little-bit-order).

        Consumed by the C++ planner's multi-term phase: intersecting a pair
        whose larger side has a bitmap costs O(smaller-df) sequential bit
        probes (the smaller list is ascending, so probes stream through the
        row) instead of the O(df_a + df_b) SIMD merge — the merge was 51%
        of plan-assembly cost at bench scale, concentrated in comparable-
        size high-df pairs. Memory is bounded by the df threshold (~46 MB
        at 1.25M docs / min_df 8192). Returns (None, None) when no term
        qualifies. Built once per distinct ``min_df`` and memoized."""
        if self._bitmap_cache is None:
            self._bitmap_cache = {}
        hit = self._bitmap_cache.get(min_df)
        if hit is not None:
            return hit
        df = np.diff(self.term_offsets)
        big = np.flatnonzero(df >= min_df)
        if big.shape[0] == 0 or self.n_docs == 0:
            out = (None, None)
            self._bitmap_cache[min_df] = out
            return out
        stride = (self.n_docs + 63) // 64
        slots = np.full(df.shape[0], -1, np.int32)
        slots[big] = np.arange(big.shape[0], dtype=np.int32)
        words = np.zeros((big.shape[0], stride), np.uint64)
        for s, t in enumerate(big):
            lo, hi = int(self.term_offsets[t]), int(self.term_offsets[t + 1])
            docs = self.doc_ids[lo:hi].astype(np.int64)
            widx = docs >> 6
            bits = np.uint64(1) << (docs & 63).astype(np.uint64)
            # docs ascending & unique -> widx is sorted; OR each equal-word
            # run in one reduceat pass
            starts = np.flatnonzero(np.r_[True, np.diff(widx) != 0])
            words[s, widx[starts]] = np.bitwise_or.reduceat(bits, starts)
        out = (slots, words)
        self._bitmap_cache[min_df] = out
        return out


def dense_store_dtype(name: str) -> np.dtype:
    """Map the user-facing dense storage choice to a numpy dtype.

    ``bf16`` halves index memory/HBM at a measured recall@10 floor of
    ~0.9-vs-f32 on adversarially close neighbors (docs/kernels.md "Storage
    precision"); ``f32`` is the recall-critical deployment switch
    (`openintel index --dense-store f32`). THE single mapping shared by the
    CLI, bench.py's BENCH_STORE control, and tests — so "what does f32 mean"
    cannot drift between surfaces."""
    if name == "f32":
        return np.dtype(np.float32)
    if name == "bf16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    raise ValueError(f"unknown dense store {name!r} (choices: f32, bf16)")


def dense_store_name(dtype) -> str:
    """Inverse of :func:`dense_store_dtype` for checkpoint meta / doctor
    reporting; unknown dtypes report their numpy name verbatim."""
    dt = np.dtype(dtype)
    if dt == np.float32:
        return "f32"
    try:
        import ml_dtypes

        if dt == np.dtype(ml_dtypes.bfloat16):
            return "bf16"
    except ImportError:  # pragma: no cover - ml_dtypes ships with jax
        pass
    return dt.name


@dataclass
class DenseIndex:
    """L2-normalised document embeddings; cosine similarity == dot product."""

    embeddings: np.ndarray  # (N, D) float32 or bfloat16, rows unit-norm
    n_docs: int
    dim: int

    @staticmethod
    def from_embeddings(raw: np.ndarray, *, dtype=np.float32) -> "DenseIndex":
        raw = np.asarray(raw, dtype=np.float32)
        norms = np.linalg.norm(raw, axis=1, keepdims=True)
        normed = raw / np.maximum(norms, 1e-12)
        return DenseIndex(
            embeddings=normed.astype(dtype), n_docs=raw.shape[0], dim=raw.shape[1]
        )
