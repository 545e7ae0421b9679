"""Retriever model families: BM25, dense cosine, and the flagship hybrid.

These are the host-facing handles around the device ops: they own the built
index (HBM-resident arrays), encode queries, and run the jitted score->top-k
programs. The hybrid retriever is the framework's flagship model — BM25 top-c
and dense top-c fused by RRF in one device program per arm
(BASELINE.json north star; SURVEY.md §7 step 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from openintel_tpu import platform
from openintel_tpu.index.schema import BM25Config, DenseIndex, PostingsIndex
from openintel_tpu.index.build import build_postings_index
from openintel_tpu.models.embedding import HashingEmbedder
from openintel_tpu.ops.bm25 import bm25_topk_device, build_query_plan, encode_query
from openintel_tpu.ops.dense import (
    dense_topk_xla,
    dense_topk_xla_masked,
    exact_rescore,
    int8_corpus,
    int8_group,
    quantize_int8,
)
from openintel_tpu.ops.fusion import (
    BLEND_ALPHA,
    RRF_K,
    mask_compact_ranked,
    mask_compact_ranked_vals,
    rrf_fuse_device,
    zblend_fuse_device,
)


@dataclass
class SearchResult:
    """Ranked results for a batch of queries; -1 ids pad short rankings."""

    ids: np.ndarray  # (B, k) int32
    scores: np.ndarray  # (B, k) float32


@dataclass
class PreparedBatch:
    """Device-staged operands for one fused hybrid dispatch
    (``HybridRetriever.prepare`` -> ``run_prepared``)."""

    queries: jax.Array  # (nb, db, D) rescore/emb dtype
    queries_i8: jax.Array  # (nb, db, D) int8 (zeros unless kernel="int8")
    plan_doc_ids: jax.Array  # (nb, db, W) int32
    plan_weights: jax.Array  # (nb, db, W) f32
    n_queries: int  # true query count (before sub-batch padding)
    k: int
    candidates_per_arm: int
    presorted: bool
    max_run: int
    # Filtered search (None/0 = unfiltered; docs/specs/filtered-search.md):
    filter_mask: Optional[jax.Array] = None  # (G, n_docs) bool device masks
    filter_group: Optional[jax.Array] = None  # (nb, db) int32 mask row per query
    group_unmasked: Optional[np.ndarray] = None  # (G,) host popcount per mask
    n_unmasked: int = 0  # min unmasked count over the groups in the batch
    c_fetch: int = 0  # dense-arm over-fetch width (selectivity-scaled)


AUTO_PRUNE_DOCS = 100_000  # corpora above this default to pruned plans

# Filtered search: cap on the dense arm's over-fetch width (the int8
# candidate pass -1-pads a width beyond its candidate buffer). Below ~c/1024
# selectivity the filtered program expects starvation and the exact masked
# fallback takes over — at that selectivity a masked brute-force scan IS
# the right algorithm anyway.
FILTER_FETCH_CAP = 1024


def filtered_fetch_width(c: int, n_docs: int, n_unmasked: int) -> int:
    """Dense-arm over-fetch width for a filtered search: enough UNFILTERED
    candidates that, at the mask's selectivity, >= c survivors are expected
    with a 2x margin (survival of top-ranked docs is hypergeometric around
    selectivity * width). Bucketed to powers of two to bound the jit cache;
    capped at FILTER_FETCH_CAP (beyond it the fallback is cheaper)."""
    if n_unmasked <= 0:
        return min(max(c, 1), n_docs)
    sel = n_unmasked / n_docs
    want = max(2 * c, int(np.ceil(c / sel)))
    width = 64
    while width < want and width < FILTER_FETCH_CAP:
        width *= 2
    return min(max(width, c), FILTER_FETCH_CAP, n_docs)


def _as_doc_mask(filter_mask, n_docs: int) -> np.ndarray:
    """Validate/normalise a user filter into a bool (n_docs,) numpy mask."""
    mask = np.asarray(filter_mask)
    if mask.dtype != np.bool_:
        raise TypeError(f"filter_mask must be bool, got {mask.dtype}")
    if mask.shape != (n_docs,):
        raise ValueError(f"filter_mask shape {mask.shape} != ({n_docs},)")
    return mask


def _as_group_masks(
    filter_mask, filter_group, n_docs: int, b: int
) -> tuple[np.ndarray, np.ndarray]:
    """Normalise per-batch OR per-query filters into ((G, n_docs) bool
    masks, (b,) int32 group-row per query).

    Shapes accepted (docs/specs/filtered-search.md "Per-query filters"):
    - (n_docs,) mask, ``filter_group`` None -> one group, all queries;
    - (G, n_docs) masks + ``filter_group`` of b ints in [0, G) -> query i
      is filtered by mask row ``filter_group[i]`` (the multi-tenant shape:
      a few long-lived masks, a group index per query — never a (B, n_docs)
      operand)."""
    masks = np.asarray(filter_mask)
    if masks.dtype != np.bool_:
        raise TypeError(f"filter_mask must be bool, got {masks.dtype}")
    if masks.ndim == 1:
        if filter_group is not None:
            raise ValueError(
                "filter_group requires a (G, n_docs) filter_mask; got 1-D"
            )
        if masks.shape != (n_docs,):
            raise ValueError(
                f"filter_mask shape {masks.shape} != ({n_docs},)"
            )
        return masks[None, :], np.zeros(b, np.int32)
    if masks.ndim != 2 or masks.shape[1] != n_docs or masks.shape[0] < 1:
        raise ValueError(
            f"filter_mask shape {masks.shape} != (G >= 1, {n_docs})"
        )
    if filter_group is None:
        if masks.shape[0] != 1:
            raise ValueError(
                "filter_group (one int per query) is required when "
                f"filter_mask has {masks.shape[0]} > 1 rows"
            )
        return masks, np.zeros(b, np.int32)
    raw = np.asarray(list(filter_group))
    if not np.issubdtype(raw.dtype, np.integer):
        # a truncating cast would silently apply the WRONG tenant's mask —
        # the exact "filter looks applied when it wasn't" failure this
        # module's validation exists to prevent
        raise TypeError(
            f"filter_group must be integers, got dtype {raw.dtype}"
        )
    groups = raw.astype(np.int32)
    if groups.shape != (b,):
        raise ValueError(
            f"filter_group length {groups.shape} != ({b},) queries"
        )
    if groups.size and (groups.min() < 0 or groups.max() >= masks.shape[0]):
        raise ValueError(
            f"filter_group out of range [0, {masks.shape[0]}): "
            f"[{groups.min()}, {groups.max()}]"
        )
    if masks.shape[0] * n_docs >= 2**31:
        # the device programs gather mask_flat[g * n_docs + id] in int32
        raise ValueError(
            f"{masks.shape[0]} mask rows x {n_docs} docs overflows the "
            "int32 flat mask index; use fewer distinct filter groups"
        )
    return masks, groups


def make_filter_mask(
    n_docs: int,
    *,
    include_ids: Optional[Sequence[int]] = None,
    exclude_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Build a (n_docs,) bool doc mask from id lists: start from all docs
    (or only ``include_ids`` when given), then drop ``exclude_ids``.
    Out-of-range, non-integer, or non-list ids raise — a silent drop or a
    truncating cast (3.7 -> doc 3) would make a filter look applied when
    it wasn't."""

    def _ids(name, value):
        if value is None:
            return None
        try:
            arr = np.asarray(list(value))
        except TypeError:
            raise ValueError(
                f"{name} must be a list of integers, got "
                f"{type(value).__name__}"
            ) from None
        if arr.size and not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"{name} must be integers, got dtype {arr.dtype}"
            )
        arr = arr.astype(np.int64)
        if arr.size and (arr.min() < 0 or arr.max() >= n_docs):
            raise ValueError(
                f"{name} out of range [0, {n_docs}): "
                f"[{arr.min()}, {arr.max()}]"
            )
        return arr

    inc = _ids("include_ids", include_ids)
    exc = _ids("exclude_ids", exclude_ids)
    if inc is not None:
        mask = np.zeros(n_docs, dtype=bool)
        mask[inc] = True
    else:
        mask = np.ones(n_docs, dtype=bool)
    if exc is not None:
        mask[exc] = False
    return mask


def run_per_group(
    groups: np.ndarray, k: int, fn
) -> tuple[np.ndarray, np.ndarray]:
    """Run ``fn(g, rows) -> ((len(rows), k) vals, (len(rows), k) ids)``
    once per DISTINCT mask group and scatter the results back into row
    order — the shared row bookkeeping of every per-group dispatch loop
    (grouped dense search, starvation fallbacks, sharded dense mode)."""
    out_vals = np.empty((groups.shape[0], k), np.float32)
    out_ids = np.empty((groups.shape[0], k), np.int32)
    for g in np.unique(groups):
        rows = np.flatnonzero(groups == g)
        vals, ids = fn(int(g), rows)
        out_vals[rows] = vals
        out_ids[rows] = ids
    return out_vals, out_ids


def grouped_query_plan(
    index,
    term_ids: Sequence[Sequence[int]],
    masks: np.ndarray,  # (G, n_docs) bool
    groups: np.ndarray,  # (B,) int32 mask row per query
    *,
    max_postings_per_term: Optional[int] = None,
    multi_budget: int = 256,
):
    """Mask-aware BM25 plan for a batch whose queries carry per-query
    filters: one :func:`build_query_plan` per DISTINCT mask row over that
    group's query subset (each exact on its own filtered corpus —
    docs/specs/pruned-plan-exactness.md holds per group), reassembled into
    one (B, W) plan at the widest group's bucket width. Sentinel padding
    (doc id = n_docs) keeps rows presorted."""
    from openintel_tpu.ops.bm25 import QueryPlan

    b = len(term_ids)
    per_group = []
    presorted = True
    max_terms = 1
    width = 1
    for g in np.unique(groups):
        rows = np.flatnonzero(groups == g)
        plan = build_query_plan(
            index,
            [term_ids[i] for i in rows],
            max_postings_per_term=max_postings_per_term,
            multi_budget=multi_budget,
            # all-True rows (null filters in a mixed batch) are the
            # UNFILTERED plan — skip the pointless per-posting mask work
            doc_mask=masks[g] if not masks[g].all() else None,
        )
        per_group.append((rows, plan))
        presorted = presorted and plan.presorted
        max_terms = max(max_terms, plan.max_terms)
        width = max(width, plan.doc_ids.shape[1])
    out_ids = np.full((b, width), index.n_docs, np.int32)
    out_w = np.zeros((b, width), np.float32)
    for rows, plan in per_group:
        w = plan.doc_ids.shape[1]
        out_ids[rows, :w] = plan.doc_ids
        out_w[rows, :w] = plan.weights
    return QueryPlan(
        doc_ids=out_ids,
        weights=out_w,
        n_docs=index.n_docs,
        presorted=presorted,
        max_terms=max_terms,
    )


def dense_arm_topk(
    kernel: str,
    emb_op: jax.Array,
    q: jax.Array,
    k: int,
    *,
    n_docs: int,
    interpret: bool,
    candidates: Optional[int] = None,  # int8 candidate count (default 2k>=32)
    rescore_op: Optional[jax.Array] = None,  # (N, D) rows, kernel="int8"
    q8: Optional[jax.Array] = None,  # (B, D) int8 queries, kernel="int8"
) -> tuple[jax.Array, jax.Array]:
    """THE dense-arm dispatch — shared by ``DenseRetriever``, the fused
    hybrid program and the per-shard sharded program, so the kernel and
    its interpret flag cannot drift between the serving paths.
    Jit-traceable. ``kernel="int8"``: the int8 candidate pass (the GPU
    kernel; interpret mode on the CPU) over ``emb_op`` = the padded int8
    rows, then an exact f32 rescore of the candidates over ``rescore_op``.
    ``kernel="xla"``: the exact blocked scan over ``emb_op`` rows."""
    if kernel == "int8":
        from openintel_tpu.ops.pallas.int8_topk import int8_topk

        c = candidates if candidates is not None else min(max(2 * k, 32), n_docs)
        _, cids = int8_topk(
            emb_op, q8, k=c, n_docs=n_docs, group=int8_group(n_docs, c),
            interpret=interpret,
        )
        return exact_rescore(rescore_op, q, cids, k)
    return dense_topk_xla(emb_op, q, k)


def auto_prune_m(n_docs: int, k: int) -> Optional[int]:
    """Default impact-pruning budget for serving: above AUTO_PRUNE_DOCS a
    stop-wordy term would otherwise blow the plan to its full df (device
    cost is linear in plan width). M = max(128, k) keeps pruned top-k exact
    (the argument needs k <= min(M, multi_budget); build_query_plan's
    multi_budget default is 256, raised alongside k below)."""
    return max(128, k) if n_docs > AUTO_PRUNE_DOCS else None


class BM25Retriever:
    """Lexical retrieval over the CSR postings index."""

    def __init__(self, index: PostingsIndex):
        self.index = index

    @classmethod
    def build(cls, texts: Sequence[str], *, config: BM25Config = BM25Config()):
        return cls(build_postings_index(texts, config=config))

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        """``filter_mask`` (bool (n_docs,), or (G, n_docs) with
        ``filter_group`` — one mask row index per query) restricts results
        to unmasked docs — EXACT at any selectivity: the plan itself is
        mask-aware (masked docs never enter it; pruning keeps per-term
        top-M unmasked impacts), so the device reduction natively searches
        the filtered corpus. Scores keep full-corpus idf."""
        term_ids = [encode_query(self.index, q) for q in queries]
        prune_m = auto_prune_m(self.index.n_docs, k)
        if filter_mask is not None:
            masks, groups = _as_group_masks(
                filter_mask, filter_group, self.index.n_docs, len(queries)
            )
            plan = grouped_query_plan(
                self.index, term_ids, masks, groups,
                max_postings_per_term=prune_m,
                multi_budget=max(256, k),
            )
        else:
            if filter_group is not None:
                raise ValueError("filter_group requires filter_mask")
            plan = build_query_plan(
                self.index,
                term_ids,
                max_postings_per_term=prune_m,
                multi_budget=max(256, k),
            )
        vals, ids = bm25_topk_device(
            plan.doc_ids,
            plan.weights,
            plan.n_docs,
            min(k, self.index.n_docs),
            presorted=plan.presorted,
            max_run=plan.max_terms,
        )
        return SearchResult(ids=np.asarray(ids), scores=np.asarray(vals))


class DenseRetriever:
    """Brute-force cosine retrieval over the dense index: the exact XLA
    scan, or the int8 candidate pass + exact rescore (``kernel="int8"``,
    the platform default on a GPU at serving scale — ``platform.py``)."""

    def __init__(
        self,
        index: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        kernel: Optional[str] = None,  # "xla" | "int8" | None = platform default
    ):
        self.index = index
        self.embedder = embedder or HashingEmbedder(dim=index.dim)
        self.kernel = platform.check_kernel(kernel, index.n_docs)
        self._interpret = platform.interpret()
        # All transform work (quantise/pad) happens on the HOST numpy array
        # with exactly ONE device upload per operand: a device-side
        # quantise would briefly hold 2x the corpus in device memory. The
        # int8 path also keeps the stored rows for the exact rescore.
        emb_host = np.asarray(index.embeddings)
        if self.kernel == "int8":
            self._emb_device = jax.device_put(int8_corpus(emb_host))
            self._rescore_emb = jax.device_put(jnp.asarray(emb_host))
        else:
            self._emb_device = jax.device_put(jnp.asarray(emb_host))

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        *,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        dim: int = 384,
        dtype=np.float32,
    ):
        embedder = embedder or HashingEmbedder(dim=dim)
        emb = embedder(list(texts))
        return cls(DenseIndex.from_embeddings(emb, dtype=dtype), embedder)

    def _topk(self, q: jax.Array, k: int):
        k = min(k, self.index.n_docs)
        int8 = self.kernel == "int8"
        q8 = jnp.asarray(quantize_int8(np.asarray(q, np.float32))) if int8 else None
        return dense_arm_topk(
            self.kernel,
            self._emb_device,
            q,
            k,
            n_docs=self.index.n_docs,
            interpret=self._interpret,
            rescore_op=self._rescore_emb if int8 else None,
            q8=q8,
        )

    def _masked_topk(self, q: jax.Array, mask_dev: jax.Array, k: int):
        """EXACT masked dense top-k over the stored rows (for int8, the
        rescore rows: the same stored-dtype-doc x f32-query scores as
        exact_rescore). Brute force — the filtered-search fallback arm, and
        the whole dense arm for DenseRetriever filtered searches."""
        k = min(k, self.index.n_docs)
        rows = self._rescore_emb if self.kernel == "int8" else self._emb_device
        return dense_topk_xla_masked(rows, q, mask_dev, k)

    def search_embeddings(
        self,
        query_emb: np.ndarray,
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        # int8: f32 queries into the exact rescore (bf16-rounding the
        # query shifts near-ties — see HybridRetriever.prepare)
        dtype = jnp.float32 if self.kernel == "int8" else self._emb_device.dtype
        q = jnp.asarray(query_emb, dtype)
        if filter_mask is not None:
            b = q.shape[0]
            masks, groups = _as_group_masks(
                filter_mask, filter_group, self.index.n_docs, b
            )
            if masks.shape[0] == 1:
                vals, ids = self._masked_topk(q, jnp.asarray(masks[0]), k)
                return SearchResult(
                    ids=np.asarray(ids), scores=np.asarray(vals)
                )
            # per-query groups: the dense filtered surface is an exact
            # masked brute-force scan, so one dispatch per DISTINCT mask
            # over that group's query rows is the natural program shape
            def arm(g, rows):
                vals, ids = self._masked_topk(
                    q[rows], jnp.asarray(masks[g]), k
                )
                return np.asarray(vals), np.asarray(ids)

            out_vals, out_ids = run_per_group(
                groups, min(k, self.index.n_docs), arm
            )
            return SearchResult(ids=out_ids, scores=out_vals)
        if filter_group is not None:
            raise ValueError("filter_group requires filter_mask")
        vals, ids = self._topk(q, k)
        return SearchResult(ids=np.asarray(ids), scores=np.asarray(vals))

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        return self.search_embeddings(
            self.embedder(list(queries)), k, filter_mask=filter_mask,
            filter_group=filter_group,
        )


class HybridRetriever:
    """Flagship: BM25 + dense cosine fused with a z-normalised score blend.

    The fusion default is the measured A/B winner (scripts/fusion_ab.py,
    docs/benchmarks.md "Fusion"): ``fusion="zblend"`` with alpha 0.7 beats
    rank-only RRF on exact-surface quality in both embedder regimes and
    ties it on the vocabulary-mismatch set; RRF stays one flag away
    (``fusion="rrf"``) and remains the default on the live updatable path,
    whose cross-segment merge is rank-based (models/updatable.py).

    ``search`` runs ONE device dispatch regardless of query count: the
    query list is chunked into ``device_batch``-query sub-batches and the
    full hybrid step (BM25 segmented-scan reduction + dense candidate
    kernel [+ exact rescore] + RRF) runs under a single jitted
    ``lax.scan`` over the chunks. This is both the serving path and the
    benchmarked path (bench.py drives this exact surface), and it
    amortises the host->device dispatch round-trip across the whole
    request instead of paying it per sub-batch."""

    def __init__(
        self,
        postings: PostingsIndex,
        dense: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        rrf_k: float = RRF_K,
        fusion: str = "zblend",  # "zblend" (measured winner) | "rrf"
        blend_alpha: float = BLEND_ALPHA,
        kernel: Optional[str] = None,  # "xla" | "int8" | None = platform default
        device_batch: int = 256,
    ):
        if fusion not in ("rrf", "zblend"):
            raise ValueError(f"unknown fusion {fusion!r}")
        self.bm25 = BM25Retriever(postings)
        self.dense = DenseRetriever(dense, embedder, kernel=kernel)
        self.rrf_k = rrf_k
        self.fusion = fusion
        self.blend_alpha = blend_alpha
        self.device_batch = max(1, device_batch)
        self._fused = self._make_fused()
        self._fused_filtered = self._make_fused_filtered()

    def _fuse_arms(self, b_vals, b_ids, d_vals, d_ids, k):
        """Fuse the scored arm rankings by the configured function (RRF by
        default; measured A/B in docs/benchmarks.md 'Fusion')."""
        if self.fusion == "zblend":
            return zblend_fuse_device(
                b_vals, b_ids, d_vals, d_ids, k, self.blend_alpha
            )
        return rrf_fuse_device(b_ids, d_ids, k, self.rrf_k)

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        *,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        config: BM25Config = BM25Config(),
        dim: int = 384,
        dtype=np.float32,
        rrf_k: float = RRF_K,
        fusion: str = "zblend",
        blend_alpha: float = BLEND_ALPHA,
        kernel: Optional[str] = None,
        device_batch: int = 256,
    ):
        embedder = embedder or HashingEmbedder(dim=dim)
        postings = build_postings_index(texts, config=config)
        dense = DenseIndex.from_embeddings(embedder(list(texts)), dtype=dtype)
        return cls(
            postings, dense, embedder, rrf_k=rrf_k, fusion=fusion,
            blend_alpha=blend_alpha, kernel=kernel,
            device_batch=device_batch,
        )

    @property
    def n_docs(self) -> int:
        return self.bm25.index.n_docs

    @property
    def kernel(self) -> str:
        """The dense-arm path this instance serves ("xla" or "int8")."""
        return self.dense.kernel

    def _make_fused(self):
        """One jitted program: scan the hybrid step over query sub-batches.

        Closes over the instance's kernel/interpret config; jax's jit cache
        keys the remaining variation (shapes + static ints)."""
        kernel = self.dense.kernel
        interpret = self.dense._interpret
        fuse = self._fuse_arms

        import functools

        @functools.partial(
            jax.jit,
            static_argnames=(
                "k", "c", "n_docs", "presorted", "max_run"
            ),
        )
        def fused(emb_op, rescore_op, qbs, qbs8, dis, ws, *, k, c, n_docs,
                  presorted, max_run):
            def body(carry, xs):
                qb, qb8, di, w = xs
                d_vals, d_ids = dense_arm_topk(
                    kernel, emb_op, qb, c,
                    n_docs=n_docs, interpret=interpret,
                    candidates=c, rescore_op=rescore_op, q8=qb8,
                )
                b_vals, b_ids = bm25_topk_device(
                    di, w, n_docs, c, presorted=presorted, max_run=max_run
                )
                vals, ids = fuse(b_vals, b_ids, d_vals, d_ids, k)
                return carry, (vals, ids)

            _, (vals, ids) = jax.lax.scan(
                body, jnp.int32(0), (qbs, qbs8, dis, ws)
            )
            return vals, ids

        return fused

    def _make_fused_filtered(self):
        """Filtered variant of the fused program (one extra mask operand).

        Per sub-batch: the dense arm over-fetches ``c_fetch`` exact
        candidates, keeps the unmasked ones in rank order
        (ops/fusion.py::mask_compact_ranked — exact filtered top-c whenever
        >= c survive), while the BM25 arm needs NO device mask at all: its
        plan is built mask-aware, so the segmented reduction natively
        searches the filtered corpus. Also emits per-query dense survivor
        counts; the host re-runs starved queries (survivors < min(c,
        n_unmasked)) through the exact masked fallback
        (``_filtered_fallback``), making the surface exact at ANY
        selectivity. See docs/specs/filtered-search.md."""
        kernel = self.dense.kernel
        interpret = self.dense._interpret
        fuse = self._fuse_arms
        score_fusion = self.fusion == "zblend"

        import functools

        @functools.partial(
            jax.jit,
            static_argnames=(
                "k", "c", "c_fetch", "n_docs", "presorted", "max_run",
            ),
        )
        def fused(emb_op, rescore_op, mask_dev, gbs, qbs, qbs8, dis, ws, *,
                  k, c, c_fetch, n_docs, presorted, max_run):
            # (G, n_docs) masks flattened once; each query row gathers its
            # own mask row via flat index g * n_docs + doc_id (per-query
            # filters ride as ONE int per query, never a (B, n_docs) mask)
            mask_flat = mask_dev.reshape(-1)

            def body(carry, xs):
                qb, qb8, gb, di, w = xs
                d_vals, d_ids = dense_arm_topk(
                    kernel, emb_op, qb, c_fetch,
                    n_docs=n_docs, interpret=interpret,
                    candidates=c_fetch, rescore_op=rescore_op, q8=qb8,
                )
                flat_ix = gb[:, None] * n_docs + jnp.maximum(d_ids, 0)
                keep = jnp.take(mask_flat, flat_ix) & (d_ids >= 0)
                if score_fusion:  # carry scores through the compact
                    d_vals_f, d_ids_f, d_surv = mask_compact_ranked_vals(
                        d_ids, d_vals, keep, c
                    )
                else:
                    d_ids_f, d_surv = mask_compact_ranked(d_ids, keep, c)
                    d_vals_f = jnp.zeros_like(d_ids_f, jnp.float32)
                b_vals, b_ids = bm25_topk_device(
                    di, w, n_docs, c, presorted=presorted, max_run=max_run
                )
                vals, ids = fuse(b_vals, b_ids, d_vals_f, d_ids_f, k)
                return carry, (vals, ids, d_surv)

            _, (vals, ids, surv) = jax.lax.scan(
                body, jnp.int32(0), (qbs, qbs8, gbs, dis, ws)
            )
            return vals, ids, surv

        return fused

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        query_embeddings: Optional[np.ndarray] = None,
        candidates_per_arm: Optional[int] = None,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        """``filter_mask`` (bool (n_docs,); build one with
        :func:`make_filter_mask`) restricts results to unmasked docs —
        exact filtered retrieval (each arm ranks the filtered corpus under
        full-corpus statistics, then fuses; docs/specs/filtered-search.md).
        Per-query filters: pass (G, n_docs) masks + ``filter_group`` (one
        mask row index per query — the multi-tenant shape)."""
        b = len(queries)
        if b == 0:
            return SearchResult(
                ids=np.zeros((0, k), np.int32),
                scores=np.zeros((0, k), np.float32),
            )
        term_ids = [encode_query(self.bm25.index, q) for q in queries]
        if query_embeddings is None:
            query_embeddings = self.dense.embedder(list(queries))
        return self.search_prepared(
            term_ids, query_embeddings, k=k,
            candidates_per_arm=candidates_per_arm,
            filter_mask=filter_mask,
            filter_group=filter_group,
        )

    def prepare(
        self,
        term_ids: Sequence[Sequence[int]],
        query_embeddings: np.ndarray,
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        device_batch: Optional[int] = None,
        filter_mask=None,
        filter_group=None,
    ) -> "PreparedBatch":
        """Host-side query preparation: build the (pruned, presorted) BM25
        plan over ALL queries, chunk everything into device sub-batches,
        and stage the device operands. ``run_prepared`` then executes the
        fused program; ``search`` == ``run_prepared(prepare(...))``.
        ``device_batch`` overrides the instance sub-batch size (bench uses
        this to measure small-batch scaling through the same surface).
        ``filter_mask`` stages a filtered batch: the plan is built
        mask-aware and the mask rides along as a device operand; with
        (G, n_docs) masks + ``filter_group`` each query carries its own
        mask row index (per-query filters)."""
        index = self.bm25.index
        n_docs = index.n_docs
        b = len(term_ids)
        c = min(candidates_per_arm or k, n_docs)
        k = min(k, n_docs)
        doc_masks = groups = None
        if filter_mask is not None:
            doc_masks, groups = _as_group_masks(
                filter_mask, filter_group, n_docs, b
            )
        elif filter_group is not None:
            raise ValueError("filter_group requires filter_mask")
        if b == 0:
            dim = self.dense.index.dim
            return PreparedBatch(
                queries=jnp.zeros((0, 1, dim), jnp.float32),
                queries_i8=jnp.zeros((0, 1, 1), jnp.int8),
                plan_doc_ids=jnp.zeros((0, 1, 1), jnp.int32),
                plan_weights=jnp.zeros((0, 1, 1), jnp.float32),
                n_queries=0, k=k, candidates_per_arm=c,
                presorted=True, max_run=1,
            )

        db = min(device_batch or self.device_batch, b)
        pad = (-b) % db
        term_ids = list(term_ids) + [[]] * pad
        if doc_masks is not None:
            # padding rows carry group 0 — their plans are empty and their
            # results are discarded, so the row only needs a VALID mask row
            groups = np.concatenate([groups, np.zeros(pad, np.int32)])
            plan = grouped_query_plan(
                index, term_ids, doc_masks, groups,
                max_postings_per_term=auto_prune_m(n_docs, c),
                multi_budget=max(256, c),
            )
        else:
            plan = build_query_plan(
                index,
                term_ids,
                max_postings_per_term=auto_prune_m(n_docs, c),
                multi_budget=max(256, c),
            )
        nb = (b + pad) // db
        w = plan.doc_ids.shape[1]
        q = np.asarray(query_embeddings, np.float32)
        if pad:
            q = np.concatenate(
                [q, np.zeros((pad, q.shape[1]), np.float32)], axis=0
            )
        dim = q.shape[1]

        dense = self.dense
        if dense.kernel == "int8":
            qbs8 = jnp.asarray(quantize_int8(q).reshape(nb, db, dim))
            # rescore queries stay f32: rounding them to the (bf16) stored
            # dtype shifts near-ties in the exact-rescore ordering at the
            # top-10 boundary. Score definition is bf16(doc) x f32(query),
            # f32 accumulate — identical to the stored-index reference
            # oracle.
            qbs = jnp.asarray(q.reshape(nb, db, dim), jnp.float32)
        else:
            # tiny placeholder, never read by the xla fused body (a
            # full-size zeros array would stage b*dim dead bytes per search)
            qbs8 = jnp.zeros((nb, db, 1), jnp.int8)
            qbs = jnp.asarray(q.reshape(nb, db, dim), dense._emb_device.dtype)
        group_unmasked = (
            doc_masks.sum(axis=1).astype(np.int64)
            if doc_masks is not None
            else None
        )
        # over-fetch width sized for the most selective group ACTUALLY in
        # the batch (only real rows — padding rows never gate the width)
        n_unmasked = (
            int(group_unmasked[np.unique(groups[:b])].min())
            if doc_masks is not None
            else 0
        )
        return PreparedBatch(
            queries=qbs,
            queries_i8=qbs8,
            plan_doc_ids=jnp.asarray(plan.doc_ids.reshape(nb, db, w)),
            plan_weights=jnp.asarray(plan.weights.reshape(nb, db, w)),
            n_queries=b,
            k=k,
            candidates_per_arm=c,
            presorted=plan.presorted,
            max_run=plan.max_terms,
            filter_mask=(
                jnp.asarray(doc_masks) if doc_masks is not None else None
            ),
            filter_group=(
                jnp.asarray(groups.reshape(nb, db))
                if doc_masks is not None
                else None
            ),
            group_unmasked=group_unmasked,
            n_unmasked=n_unmasked,
            c_fetch=(
                filtered_fetch_width(c, n_docs, n_unmasked)
                if doc_masks is not None
                else 0
            ),
        )

    def rebatch(self, prep: "PreparedBatch", device_batch: int) -> "PreparedBatch":
        """Re-chunk a PreparedBatch to a different device sub-batch size
        without rebuilding the (expensive) query plan — the total padded
        query count must divide evenly. bench uses this to measure
        small-batch scaling on the identical plan."""
        nb, db = prep.queries.shape[:2]
        total = nb * db
        assert total % device_batch == 0, (total, device_batch)
        n2 = total // device_batch

        def chunk(a):
            return a.reshape((n2, device_batch) + a.shape[2:])

        return PreparedBatch(
            queries=chunk(prep.queries),
            queries_i8=chunk(prep.queries_i8),
            plan_doc_ids=chunk(prep.plan_doc_ids),
            plan_weights=chunk(prep.plan_weights),
            n_queries=prep.n_queries,
            k=prep.k,
            candidates_per_arm=prep.candidates_per_arm,
            presorted=prep.presorted,
            max_run=prep.max_run,
            filter_mask=prep.filter_mask,
            filter_group=(
                chunk(prep.filter_group)
                if prep.filter_group is not None
                else None
            ),
            group_unmasked=prep.group_unmasked,
            n_unmasked=prep.n_unmasked,
            c_fetch=prep.c_fetch,
        )

    def run_prepared_device(
        self, prep: "PreparedBatch"
    ) -> tuple[jax.Array, jax.Array]:
        """ONE device dispatch: the fused hybrid program over every
        sub-batch in ``prep`` (a jitted ``lax.scan``). Returns DEVICE
        arrays ((nb, db, k) vals, ids) — for pipelined serving that keeps
        results on-device or overlaps the host copy; ``run_prepared``
        wraps this with the copy-back. Filtered batches additionally
        return the dense survivor counts as a third array (consumed by
        ``run_prepared``'s starvation check)."""
        dense = self.dense
        rescore_op = (
            dense._rescore_emb
            if dense.kernel == "int8"
            else jnp.zeros((1, prep.queries.shape[2]), jnp.float32)
        )
        if prep.filter_mask is not None:
            return self._fused_filtered(
                dense._emb_device,
                rescore_op,
                prep.filter_mask,
                prep.filter_group,
                prep.queries,
                prep.queries_i8,
                prep.plan_doc_ids,
                prep.plan_weights,
                k=prep.k,
                c=prep.candidates_per_arm,
                c_fetch=prep.c_fetch,
                n_docs=self.n_docs,
                presorted=prep.presorted,
                max_run=prep.max_run,
            )
        return self._fused(
            dense._emb_device,
            rescore_op,
            prep.queries,
            prep.queries_i8,
            prep.plan_doc_ids,
            prep.plan_weights,
            k=prep.k,
            c=prep.candidates_per_arm,
            n_docs=self.n_docs,
            presorted=prep.presorted,
            max_run=prep.max_run,
        )

    def _filtered_fallback(
        self, prep: "PreparedBatch", rows: np.ndarray
    ) -> SearchResult:
        """EXACT filtered hybrid for the starved queries (flat indices
        ``rows`` into the padded batch): masked brute-force dense arm over
        the resident corpus copy (same stored-doc x f32-query scores as the
        rescore stage) + the already-mask-aware BM25 plan rows + RRF. Runs
        only when the over-fetch pool under-filled (selectivity below
        ~c/c_fetch) — correctness never depends on the over-fetch margin."""
        nb, db = prep.queries.shape[:2]
        dim = prep.queries.shape[2]
        w = prep.plan_doc_ids.shape[2]
        c, k = prep.candidates_per_arm, prep.k
        groups_flat = np.asarray(prep.filter_group).reshape(nb * db)

        # one masked scan per DISTINCT mask row among the starved queries
        # (starvation is rare and group-correlated — a tiny include-list
        # starves every query of its group at once)
        def arm(g, sub):
            sel = rows[sub]
            q = prep.queries.reshape(nb * db, dim)[sel]
            d_vals, d_ids = self.dense._masked_topk(
                q, prep.filter_mask[g], c
            )
            b_vals, b_ids = bm25_topk_device(
                prep.plan_doc_ids.reshape(nb * db, w)[sel],
                prep.plan_weights.reshape(nb * db, w)[sel],
                self.n_docs,
                c,
                presorted=prep.presorted,
                max_run=prep.max_run,
            )
            vals, ids = self._fuse_arms(b_vals, b_ids, d_vals, d_ids, k)
            return np.asarray(vals), np.asarray(ids)

        out_vals, out_ids = run_per_group(groups_flat[rows], k, arm)
        return SearchResult(ids=out_ids, scores=out_vals)

    def run_prepared(self, prep: "PreparedBatch") -> SearchResult:
        """``run_prepared_device`` + host copy-back of the (b, k) result.

        Filtered batches: checks the dense survivor counts and re-runs
        starved queries (pool survivors < min(c, n_unmasked) — possible
        only at selectivity below ~c/c_fetch) through the exact masked
        fallback, so filtered search is exact at ANY selectivity."""
        if prep.n_queries == 0:
            return SearchResult(
                ids=np.zeros((0, prep.k), np.int32),
                scores=np.zeros((0, prep.k), np.float32),
            )
        return self.finalize_prepared(prep, self.run_prepared_device(prep))

    def finalize_prepared(
        self, prep: "PreparedBatch", device_out
    ) -> SearchResult:
        """Copy-back + (filtered) starvation patching for a device result
        already dispatched via ``run_prepared_device``. Split from
        ``run_prepared`` so pipelined serving (serving.PipelinedSearcher)
        can dispatch wave i+1 before blocking on wave i's copy."""
        nb, db = prep.queries.shape[:2]
        b, k = prep.n_queries, prep.k
        if prep.filter_mask is not None:
            vals, ids, surv = device_out
            # np.array (copy): asarray of a device array is read-only and
            # the starved rows get patched in place below
            ids_np = np.array(ids).reshape(nb * db, k)
            vals_np = np.array(vals).reshape(nb * db, k)
            # per-query need: a query's pool is complete iff it kept
            # min(c, its OWN group's unmasked count) survivors
            groups_flat = np.asarray(prep.filter_group).reshape(nb * db)
            need = np.minimum(
                prep.candidates_per_arm,
                prep.group_unmasked[groups_flat[:b]],
            )
            starved = np.flatnonzero(
                np.asarray(surv).reshape(nb * db)[:b] < need
            )
            if starved.size:
                fb = self._filtered_fallback(prep, starved)
                ids_np[starved] = fb.ids
                vals_np[starved] = fb.scores
            return SearchResult(ids=ids_np[:b], scores=vals_np[:b])
        vals, ids = device_out
        return SearchResult(
            ids=np.asarray(ids).reshape(nb * db, k)[:b],
            scores=np.asarray(vals).reshape(nb * db, k)[:b],
        )

    def search_prepared(
        self,
        term_ids: Sequence[Sequence[int]],
        query_embeddings: np.ndarray,
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        """The fused search step on pre-encoded queries (term ids +
        embeddings)."""
        return self.run_prepared(
            self.prepare(
                term_ids, query_embeddings, k=k,
                candidates_per_arm=candidates_per_arm,
                filter_mask=filter_mask,
                filter_group=filter_group,
            )
        )
