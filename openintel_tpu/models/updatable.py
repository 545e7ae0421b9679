"""Incremental index updates: add / delete documents without a rebuild.

The reference is stateless per invocation (no persistence in v1 —
/root/reference/docs/superpowers/specs/2026-06-24-openintel-speculation-cli-design.md);
a production retrieval deployment additionally needs a corpus that MOVES:
new documents become searchable immediately, deletions stop surfacing
immediately, and neither forces re-staging the multi-GB device-resident
index. This module is the classic main + delta + tombstones design
(immutable big segment, small mutable segment, logical deletes), mapped
device-first onto machinery this framework already has:

- **Deletes are tombstones riding the filtered-search engine**
  (docs/specs/filtered-search.md): the alive mask composes (AND) with any
  user ``filter_mask``, the BM25 arm drops dead docs in the (mask-aware,
  C++) plan, and the dense arm over-fetches + rank-compacts with the
  exact masked fallback — deletes cost what a filter costs, nothing is
  re-staged, exactness at any tombstone density.
- **Adds go to a small delta segment** (own postings + dense rows,
  rebuilt per add batch — O(delta), not O(corpus)) whose BM25 impacts
  freeze the base index's ``avgdl`` and whose idf is the COMBINED-corpus
  idf, recomputed per add from df sums alone. The main segment's arrays
  are untouched: idf lives outside the fused impacts, so global statistic
  updates never touch the device-resident corpus (the design reason
  impacts and idf are stored separately).
- **The merge is the sharded merge**: main and delta are searched as two
  unequal shards — per-arm top-c with scores, merged by (score desc,
  doc asc) exactly like the cross-shard merge, then RRF — so the
  combined ranking is IDENTICAL to a from-scratch index over
  main + delta with the same frozen statistics (`merge_postings` builds
  that oracle; asserted in tests/test_updatable.py).

Statistics contract (Lucene-like, documented not hidden): ``avgdl`` stays
the base segment's value and deleted docs keep counting in df/idf until
``compact()``, which folds everything into one fresh segment with true
statistics (and renumbered ids — the returned map says where docs went).
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from openintel_tpu.index.build import bm25_idf, bm25_impact, build_postings_index
from openintel_tpu.index.schema import DenseIndex, PostingsIndex
from openintel_tpu.models.retrievers import (
    DenseRetriever,
    HybridRetriever,
    SearchResult,
    _as_doc_mask,
    auto_prune_m,
    filtered_fetch_width,
)
from openintel_tpu.ops.bm25 import bm25_topk_device, build_query_plan
from openintel_tpu.ops.fusion import RRF_K, rrf_fuse_device
from openintel_tpu.ops.tokenizer import Vocab, tokenize_batch


def _merge_ranked(
    vals_a: np.ndarray, ids_a: np.ndarray,
    vals_b: np.ndarray, ids_b: np.ndarray,
    c: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge two per-arm ranked lists by (score desc, doc asc) — the host
    analogue of the sharded program's cross-shard merge, so incremental
    results are bit-identical to a single combined index. -1 ids are
    padding (score forced to -inf). Returns ((B, c) merged scores with
    0.0 padding — the single-arm retrievers' contract — and (B, c)
    merged ids)."""
    av = np.concatenate([vals_a, vals_b], axis=1).astype(np.float64)
    ai = np.concatenate([ids_a, ids_b], axis=1)
    av = np.where(ai < 0, -np.inf, av)
    order = np.lexsort((ai, -av), axis=1)[:, :c]
    merged = np.take_along_axis(ai, order, axis=1)
    merged_v = np.take_along_axis(av, order, axis=1)
    pad = ~np.isfinite(merged_v)
    return (
        np.where(pad, 0.0, merged_v).astype(np.float32),
        np.where(pad, -1, merged).astype(np.int32),
    )


def extend_vocab(base: Vocab, token_lists) -> Vocab:
    """A COPY of ``base`` extended with any new tokens (new ids appended,
    existing ids unchanged — the delta segment shares the base id space)."""
    v = Vocab(token_to_id=dict(base.token_to_id))
    for tokens in token_lists:
        for t in tokens:
            v.add(t)
    return v


def merge_postings(
    main: PostingsIndex, delta: Optional[PostingsIndex], n_total: int
) -> PostingsIndex:
    """ONE combined CSR index over main + delta with FROZEN statistics
    (main's avgdl baked in both segments' impacts; combined df/idf) —
    what ``UpdatableHybridRetriever.search`` must be indistinguishable
    from, and the first half of ``compact()``. Delta doc ids offset by
    ``main.n_docs``; per-term segments stay doc-ascending because delta
    ids are strictly larger. Pass segments with their LOCAL df (the base
    index, not the combined-idf search view) — dfs are summed here."""
    v_main = main.term_offsets.shape[0] - 1
    v = max(v_main, delta.term_offsets.shape[0] - 1 if delta is not None else 0)
    # Vectorised CSR interleave (no V-length Python loop): per-posting term
    # ids, then ONE stable argsort by term. Within a term the concatenation
    # order (main postings, then delta postings — both doc-ascending, delta
    # ids strictly larger) is already doc-ascending, and stable sort keeps
    # it.
    terms = np.repeat(np.arange(v_main), np.diff(main.term_offsets))
    ids = main.doc_ids
    tf = main.tf
    imp = main.impact
    doc_len = np.zeros(n_total, np.float32)
    doc_len[: main.n_docs] = main.doc_len
    vocab = main.vocab
    if delta is not None:
        v_d = delta.term_offsets.shape[0] - 1
        terms = np.concatenate(
            [terms, np.repeat(np.arange(v_d), np.diff(delta.term_offsets))]
        )
        ids = np.concatenate([ids, delta.doc_ids + main.n_docs])
        tf = np.concatenate([tf, delta.tf])
        imp = np.concatenate([imp, delta.impact])
        doc_len[main.n_docs : main.n_docs + delta.n_docs] = delta.doc_len
        vocab = delta.vocab  # the extended (superset) table
    order = np.argsort(terms, kind="stable")
    df = np.bincount(terms, minlength=v).astype(np.int32)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(df, out=offsets[1:])
    return PostingsIndex(
        term_offsets=offsets,
        doc_ids=ids[order].astype(np.int32),
        tf=tf[order].astype(np.float32),
        impact=imp[order].astype(np.float32),
        df=df,
        idf=bm25_idf(df, n_total),
        doc_len=doc_len,
        avgdl=main.avgdl,  # frozen-statistics contract
        n_docs=n_total,
        vocab=vocab,
        config=main.config,
    )


class _Epoch(NamedTuple):
    """One immutable snapshot of the updatable retriever's mutable state
    (published atomically; see UpdatableHybridRetriever.__init__). The
    BASE retriever lives in the epoch too so ``compact_in_place`` can
    swap the whole segment set in one assignment."""

    base: HybridRetriever  # the main (device-resident) segment
    alive: np.ndarray  # (n_total,) bool — treated immutable once published
    delta_texts: tuple
    delta_tokens: tuple
    delta_emb: np.ndarray  # (n_delta, D) f32
    delta_postings: Optional[PostingsIndex]
    delta_dense: Optional[DenseRetriever]
    main_view: PostingsIndex  # base arrays + combined vocab/df/idf
    # Optional id-aligned document store (snippets). It lives IN the epoch
    # because compaction renumbers ids: a result set and its texts must
    # come from ONE snapshot (search_with_docs) or a concurrent compaction
    # could pair new ids with old texts.
    docs: Optional[tuple] = None

    @property
    def n_main(self) -> int:
        # via main_view (not base.bm25) so the epoch works for ANY main
        # segment — the sharded base has no .bm25 attribute
        return self.main_view.n_docs

    @property
    def n_total(self) -> int:
        return self.n_main + len(self.delta_texts)


class UpdatableHybridRetriever:
    """Hybrid retrieval over a corpus that accepts adds and deletes.

    Same ``search(queries, k, candidates_per_arm, filter_mask)`` results
    as a :class:`HybridRetriever` over the equivalent frozen-statistics
    combined index (``merge_postings`` + concatenated dense rows) —
    asserted exactly in tests — including per-query mask groups
    (``filter_mask`` (G, n_docs) + ``filter_group``, the same surface as
    every other retriever; tombstones AND into every group row).

    Cost model: adds rebuild only the delta segment (O(delta docs));
    deletes flip bits; searches pay one extra small-arm dispatch per arm
    plus a host merge while a delta exists, and the filtered path's
    over-fetch/compaction while tombstones exist. ``compact()`` folds
    everything back into one segment (then a fresh instance serves it).
    """

    def __init__(
        self,
        postings: PostingsIndex,
        dense: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        kernel: Optional[str] = None,
        rrf_k: float = RRF_K,
        device_batch: int = 256,
        doc_store: Optional[Sequence[str]] = None,
    ):
        self.rrf_k = rrf_k
        self._store_dtype = np.asarray(dense.embeddings).dtype
        # ALL mutable state — including the base segment, so compaction
        # can swap it — lives in one immutable snapshot, replaced by a
        # single (GIL-atomic) assignment at the end of each update —
        # concurrent serving threads (the MCP stdio loop runs searches in
        # worker threads) always read one CONSISTENT epoch, never a
        # half-applied add. Updates serialize on _update_lock; searches
        # never take it.
        self._st = _Epoch(
            base=self._new_base(
                postings, dense, embedder,
                kernel=kernel, device_batch=device_batch,
            ),
            alive=np.ones(postings.n_docs, bool),
            delta_texts=(),
            delta_tokens=(),
            delta_emb=np.zeros((0, dense.dim), np.float32),
            delta_postings=None,
            delta_dense=None,
            main_view=postings,
            docs=tuple(doc_store) if doc_store is not None else None,
        )
        if doc_store is not None and len(doc_store) != postings.n_docs:
            raise ValueError(
                f"doc_store length {len(doc_store)} != {postings.n_docs} docs"
            )
        # RLock so callers that must pair an update with their OWN
        # bookkeeping atomically can wrap the update in
        # `with retriever.update_lock:`
        self._update_lock = threading.RLock()

    @property
    def update_lock(self) -> threading.RLock:
        """Serialises updates. Hold it to make an update atomic with
        caller-side state keyed by the returned ids (searches never take
        this lock — they read epochs)."""
        return self._update_lock

    # ------------------------------------------------- main-segment hooks
    #
    # Every place the delta machinery touches the MAIN segment goes
    # through these five hooks, so a subclass can swap the segment type —
    # parallel.updatable.ShardedUpdatableHybridRetriever overrides them to
    # serve the main segment over a device mesh while reusing the whole
    # delta/tombstone/merge/compaction design unchanged.

    def _new_base(
        self, postings: PostingsIndex, dense: DenseIndex, embedder, *,
        kernel: Optional[str], device_batch: int,
    ):
        """Construct (and device-stage) a main-segment retriever.

        Pins ``fusion="rrf"`` regardless of HybridRetriever's (zblend)
        default: the live path's cross-segment merge fuses main+delta
        *rankings* with rrf_fuse_device, and the delta-free fast path
        delegates to this base — both must rank identically across an
        add/delete, which z-blended scores (normalised over different
        candidate pools per segment) would not guarantee."""
        return HybridRetriever(
            postings, dense, embedder, fusion="rrf",
            kernel=kernel, rrf_k=self.rrf_k, device_batch=device_batch,
        )

    def _base_postings(self, st: "_Epoch") -> PostingsIndex:
        """The main segment's OWN postings (local df, original vocab) —
        what delta building and compaction fold against."""
        return st.base.bm25.index

    def _base_dense_index(self, st: "_Epoch") -> DenseIndex:
        """The main segment's stored DenseIndex (checkpoint persistence)."""
        return st.base.dense.index

    @property
    def main_postings(self) -> PostingsIndex:
        """CURRENT epoch's main-segment postings — right after a
        ``compact_in_place`` this IS the whole corpus (what
        ``compact_corpus save=true`` persists), segment-type agnostic."""
        return self._base_postings(self._st)

    @property
    def main_dense(self) -> DenseIndex:
        """CURRENT epoch's main-segment dense index (see main_postings)."""
        return self._base_dense_index(self._st)

    def _embedder(self, st: "_Epoch"):
        return st.base.dense.embedder

    def _base_dense_rows(self, st: "_Epoch") -> np.ndarray:
        """The main segment's dense rows as host f32 (compaction input)."""
        return np.asarray(st.base.dense.index.embeddings, np.float32)

    def _main_query_dtype(self, st: "_Epoch"):
        """ONE query dtype for both segments' dense arms — the int8 path
        rescores with f32 queries, and a delta arm rounding its queries
        differently would break cross-segment score comparability at merge
        time (near-ties would order differently than the combined-index
        oracle)."""
        dense_main = st.base.dense
        if dense_main.kernel == "int8":
            return jnp.float32
        return dense_main._emb_device.dtype

    def _main_bm25_ranked(
        self, st: "_Epoch", term_ids, c: int, masks_main, groups,
        prune_m: int, mb: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Ranked BM25 top-c over the main segment through its
        combined-idf view (mask-aware: the C++/grouped planner drops
        masked docs before dispatch)."""
        from openintel_tpu.models.retrievers import grouped_query_plan

        main_view = st.main_view
        if masks_main is None:
            plan = build_query_plan(
                main_view, term_ids,
                max_postings_per_term=prune_m, multi_budget=mb,
            )
        else:
            plan = grouped_query_plan(
                main_view, term_ids, masks_main, groups,
                max_postings_per_term=prune_m, multi_budget=mb,
            )
        bv, bi = bm25_topk_device(
            plan.doc_ids, plan.weights, main_view.n_docs, c,
            presorted=plan.presorted, max_run=plan.max_terms,
        )
        return np.asarray(bv), np.asarray(bi)

    def _main_dense_ranked(
        self, st: "_Epoch", q_np: np.ndarray, q_dev, c: int, masks_main,
        groups, unm_main, n_real: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Ranked dense top-c over the main segment (over-fetch + exact
        masked fallback when filtered)."""
        del q_np  # the single-chip arm consumes the staged device queries
        return self._dense_arm(
            st.base.dense, q_dev, c, masks_main, groups, unm_main, n_real
        )

    def _main_arms_ranked(
        self, st: "_Epoch", term_ids, q_np, q_dev, c: int, masks_main,
        groups, unm_main, n_real: int, prune_m: int, mb: int,
    ):
        """OPTIONAL fused hook: both main arms from one dispatch, as
        (bm25_vals, bm25_ids, dense_vals, dense_ids) — or None to have the
        hybrid path call the two single-arm hooks (this default). The mesh
        subclass answers from ONE sharded program when unfiltered."""
        return None

    def _chunk_size(self, st: "_Epoch", b: int) -> int:
        """Device-batch chunk size for the two-segment search (the mesh
        subclass rounds it to a data-axis multiple)."""
        return min(st.base.device_batch, b)

    def _single_segment_search(
        self, st: "_Epoch", queries, k: int, *, candidates_per_arm,
        mode: str, masks, groups, query_embeddings,
    ) -> SearchResult:
        """Delta-free fast path: delegate to the matching base surface
        (tombstones, if any, arrive via ``masks``)."""
        fkw = (
            {}
            if masks is None
            else {"filter_mask": masks, "filter_group": groups}
        )
        if mode == "bm25":
            return st.base.bm25.search(queries, k=k, **fkw)
        if mode == "dense":
            if query_embeddings is not None:
                # honor caller-supplied embeddings (DenseRetriever's
                # string surface would silently re-embed)
                return st.base.dense.search_embeddings(
                    query_embeddings, k, **fkw
                )
            return st.base.dense.search(queries, k=k, **fkw)
        return st.base.search(
            queries, k=k, candidates_per_arm=candidates_per_arm,
            query_embeddings=query_embeddings, **fkw,
        )

    # ------------------------------------------------------------ state

    @property
    def base(self) -> HybridRetriever:
        """The CURRENT epoch's main-segment retriever (swapped by
        ``compact_in_place``)."""
        return self._st.base

    @property
    def n_docs(self) -> int:
        """Total id space (main + delta), INCLUDING tombstoned docs —
        result ids index this space."""
        return self._st.n_total

    @property
    def n_alive(self) -> int:
        return int(self._st.alive.sum())

    @property
    def kernel(self) -> str:
        """The main segment's dense-arm kernel (the delta always scans
        exactly)."""
        return self._st.base.kernel

    @property
    def docs(self) -> Optional[tuple]:
        """The CURRENT epoch's id-aligned document store (None when the
        retriever was built without one). For text lookups paired with a
        result set use :meth:`search_with_docs` — this property and a
        separate search are two epoch reads."""
        return self._st.docs

    @property
    def stats(self) -> dict:
        st = self._st
        return {
            "n_main": st.n_main,
            "n_delta": len(st.delta_texts),
            "n_deleted": int((~st.alive).sum()),
            "n_alive": int(st.alive.sum()),
        }

    # ------------------------------------------------------------ updates

    def add_documents(
        self, texts: Sequence[str], embeddings: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Append documents; returns their (stable) global doc ids. The
        delta segment rebuilds from all pending delta texts — O(delta) —
        and combined idf is refreshed from df sums; the main segment's
        arrays are untouched. Thread-safe: concurrent searches keep
        serving the previous epoch until the new one lands atomically."""
        texts = list(texts)
        if not texts:
            return np.zeros(0, np.int64)
        if embeddings is None:
            embeddings = self._embedder(self._st)(texts)
        emb = np.asarray(embeddings, np.float32)
        with self._update_lock:
            st = self._st
            n_before = st.n_total
            ids = np.arange(n_before, n_before + len(texts), dtype=np.int64)
            if emb.shape != (len(texts), st.delta_emb.shape[1]):
                raise ValueError(
                    f"embeddings shape {emb.shape} != "
                    f"({len(texts)}, {st.delta_emb.shape[1]})"
                )
            new_tokens = tuple(tokenize_batch(texts))
            self._st = self._rebuild_delta(
                st._replace(
                    alive=np.concatenate(
                        [st.alive, np.ones(len(texts), bool)]
                    ),
                    delta_texts=st.delta_texts + tuple(texts),
                    delta_tokens=st.delta_tokens + new_tokens,
                    delta_emb=np.concatenate([st.delta_emb, emb]),
                    docs=(
                        st.docs + tuple(texts)
                        if st.docs is not None
                        else None
                    ),
                )
            )
        return ids

    def delete_ids(self, ids: Sequence[int]) -> None:
        """Tombstone documents (main or delta). Idempotent; out-of-range
        ids raise — a silently ignored delete must be impossible."""
        arr = np.asarray(list(ids), np.int64)
        with self._update_lock:
            st = self._st
            n = st.n_total
            if arr.size and (arr.min() < 0 or arr.max() >= n):
                raise ValueError(
                    f"delete_ids out of range [0, {n}): "
                    f"[{arr.min()}, {arr.max()}]"
                )
            alive = st.alive.copy()  # copy-on-write: readers keep theirs
            alive[arr] = False
            self._st = st._replace(alive=alive)

    def _rebuild_delta(self, st: "_Epoch") -> "_Epoch":
        """Build the new epoch's delta segment + main view (pure: reads
        ``st``, returns the completed epoch; caller assigns atomically)."""
        base_idx = self._base_postings(st)
        # fresh extended vocab per epoch (immutable once published; the
        # O(V) dict copy per add BATCH is the price of lock-free readers)
        vocab = extend_vocab(base_idx.vocab, st.delta_tokens)
        delta = build_postings_index(
            list(st.delta_texts),
            vocab=vocab,
            config=base_idx.config,
            avgdl_override=base_idx.avgdl,  # frozen-statistics contract
            pretokenized=st.delta_tokens,  # tokenized once at add time
        )
        # combined df -> combined idf over the full id space (deleted docs
        # keep counting until compact(), like unmerged Lucene segments).
        # Term-slot arrays (df/idf) include the padding slot 0.
        v = vocab.size
        n_total = st.n_total
        df = np.zeros(v, np.int32)
        df[: base_idx.df.shape[0]] = base_idx.df
        df[: delta.df.shape[0]] += delta.df
        idf = bm25_idf(df, n_total)
        # main view: same postings arrays, vocab-extended offsets (empty
        # segments for new terms), combined df/idf. impact_order is a
        # per-term-segment permutation and segments are unchanged, so the
        # base's lazily-built order carries over as-is.
        pad = v - (base_idx.term_offsets.shape[0] - 1)
        main_view = PostingsIndex(
            term_offsets=np.concatenate(
                [base_idx.term_offsets,
                 np.full(pad, base_idx.term_offsets[-1], np.int64)]
            ) if pad > 0 else base_idx.term_offsets,
            doc_ids=base_idx.doc_ids,
            tf=base_idx.tf,
            impact=base_idx.impact,
            df=df[: v],
            idf=idf,
            doc_len=base_idx.doc_len,
            avgdl=base_idx.avgdl,
            n_docs=base_idx.n_docs,
            vocab=vocab,
            config=base_idx.config,
            impact_order=base_idx.ensure_impact_order(),
        )
        # delta KEEPS its local df (merge_postings sums segment dfs; the
        # pruning trip-wire is per segment anyway) but scores with the
        # COMBINED idf so both arms share one statistic
        delta.idf = idf[: delta.idf.shape[0]]
        delta_dense = DenseRetriever(
            DenseIndex.from_embeddings(
                st.delta_emb, dtype=self._store_dtype
            ),
            self._embedder(st),
            kernel="xla",  # delta is small: the exact kernel, no staging
        )
        return st._replace(
            delta_postings=delta,
            delta_dense=delta_dense,
            main_view=main_view,
        )

    # ------------------------------------------------------------ search

    def _dense_arm(
        self, retr: DenseRetriever, q: jnp.ndarray, c: int,
        masks: Optional[np.ndarray], groups: Optional[np.ndarray],
        unmasked: Optional[np.ndarray], n_real: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One dense arm with optional mask: over-fetch + host compaction
        (tombstones are usually sparse) with the exact masked scan as the
        starvation fallback — the single-chip filtered design at host
        altitude. ``masks`` is None (unfiltered) or a (G, n_segment)
        stack with ``groups`` giving each query's row (per-query
        filters); ``unmasked`` is the per-group popcount (hoisted — one
        sum per search, not per chunk) and ``n_real`` the non-padding
        prefix of the chunk (padding rows never gate the over-fetch width
        or trigger the fallback)."""
        n = retr.index.n_docs
        c = min(c, n)
        if masks is None:
            vals, ids = retr._topk(q, c)
            return np.asarray(vals), np.asarray(ids)
        # over-fetch width: the most selective group with ANY eligible doc
        # among the REAL rows — zero-unmasked groups return empty from
        # this segment by construction (need = 0) and must not collapse
        # the width for everyone else
        counts = unmasked[np.unique(groups[:n_real])]
        counts = counts[counts > 0]
        c_fetch = filtered_fetch_width(
            c, n, int(counts.min()) if counts.size else 0
        )
        vals, ids = retr._topk(q, c_fetch)
        vals, ids = np.array(vals), np.array(ids)
        keep = (ids >= 0) & masks[groups[:, None], np.maximum(ids, 0)]
        # rank-compact survivors; count per query
        out_v = np.full((ids.shape[0], c), -np.inf, np.float32)
        out_i = np.full((ids.shape[0], c), -1, np.int32)
        surv = keep.sum(axis=1)
        for b in range(ids.shape[0]):
            kept = np.flatnonzero(keep[b])[:c]
            out_v[b, : kept.size] = vals[b, kept]
            out_i[b, : kept.size] = ids[b, kept]
        need = np.minimum(c, unmasked[groups])
        starved = np.flatnonzero(surv < need)
        starved = starved[starved < n_real]  # padding never re-runs
        if starved.size:
            from openintel_tpu.models.retrievers import run_per_group

            def arm(g, sub):
                mv, mi = retr._masked_topk(
                    q[starved[sub]], jnp.asarray(masks[g]), c
                )
                mv, mi = np.asarray(mv), np.asarray(mi)
                return np.where(mi < 0, -np.inf, mv), mi

            fv, fi = run_per_group(groups[starved], c, arm)
            out_v[starved] = fv
            out_i[starved] = fi
        return out_v, out_i

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        mode: str = "hybrid",
        filter_mask=None,
        filter_group=None,
        query_embeddings: Optional[np.ndarray] = None,
    ) -> SearchResult:
        return self._search_epoch(
            self._st, queries, k,
            candidates_per_arm=candidates_per_arm, mode=mode,
            filter_mask=filter_mask, filter_group=filter_group,
            query_embeddings=query_embeddings,
        )

    def search_with_docs(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        mode: str = "hybrid",
        filter_mask=None,
        filter_group=None,
        query_embeddings: Optional[np.ndarray] = None,
    ) -> tuple[SearchResult, Optional[tuple]]:
        """``search`` plus the SAME epoch's document store — the safe way
        to resolve result ids to texts: a compaction between a search and
        a separate docs read would pair renumbered ids with the wrong
        texts."""
        st = self._st
        res = self._search_epoch(
            st, queries, k,
            candidates_per_arm=candidates_per_arm, mode=mode,
            filter_mask=filter_mask, filter_group=filter_group,
            query_embeddings=query_embeddings,
        )
        return res, st.docs

    def _search_epoch(
        self,
        st: "_Epoch",
        queries: Sequence[str],
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        mode: str = "hybrid",
        filter_mask=None,
        filter_group=None,
        query_embeddings: Optional[np.ndarray] = None,
    ) -> SearchResult:
        if mode not in ("hybrid", "bm25", "dense"):
            raise ValueError(
                f"mode must be hybrid, bm25, or dense, got {mode!r}"
            )
        b = len(queries)
        if b == 0:
            return SearchResult(
                ids=np.zeros((0, k), np.int32),
                scores=np.zeros((0, k), np.float32),
            )
        n_total = st.n_total
        n_delta = len(st.delta_texts)
        masks = groups = None
        if filter_mask is not None:
            m = np.asarray(filter_mask)
            if (
                m.ndim in (1, 2)
                and m.dtype == np.bool_
                and st.n_main <= m.shape[-1] < n_total
            ):
                # a mask built against an OLDER epoch (a concurrent add
                # landed between the caller reading n_docs and this
                # snapshot): docs it could not know about stay excluded
                # until the caller refreshes — deterministic, never a
                # shape crash mid-serving. Applies to (G, n) stacks too.
                pad_cols = n_total - m.shape[-1]
                m = np.concatenate(
                    [m, np.zeros(m.shape[:-1] + (pad_cols,), bool)],
                    axis=-1,
                )
            if (
                m.ndim in (1, 2)
                and m.dtype == np.bool_
                and m.shape[-1] != n_total
            ):
                # ids are only stable within a compaction era — a filter
                # sized for another era would select the WRONG documents
                raise ValueError(
                    f"filter_mask length {m.shape[-1]} does not match the "
                    f"corpus ({n_total} docs) — a compaction may have "
                    "renumbered ids; rebuild the filter from current ids"
                )
            from openintel_tpu.models.retrievers import _as_group_masks

            masks, groups = _as_group_masks(m, filter_group, n_total, b)
        elif filter_group is not None:
            raise ValueError("filter_group requires filter_mask")
        if not st.alive.all():
            # tombstones AND into every mask row
            if masks is None:
                masks = st.alive[None, :]
                groups = np.zeros(b, np.int32)
            else:
                masks = masks & st.alive[None, :]
        if n_delta == 0:
            return self._single_segment_search(
                st, queries, k,
                candidates_per_arm=candidates_per_arm, mode=mode,
                masks=masks, groups=groups,
                query_embeddings=query_embeddings,
            )

        k = min(k, n_total)
        c = min(candidates_per_arm or k, n_total)
        if mode != "hybrid":
            c = k  # single arms return k results directly, no RRF pool
        # a segment slice that masks NOTHING (across every group row) is
        # the unfiltered path for that segment (same trick as
        # grouped_query_plan's all-True rows)
        masks_main = masks[:, : st.n_main] if masks is not None else None
        if masks_main is not None and masks_main.all():
            masks_main = None
        masks_delta = masks[:, st.n_main :] if masks is not None else None
        if masks_delta is not None and masks_delta.all():
            masks_delta = None
        # per-group popcounts once per SEARCH (the dense arms read them
        # every chunk)
        unm_main = (
            masks_main.sum(axis=1).astype(np.int64)
            if masks_main is not None
            else None
        )
        unm_delta = (
            masks_delta.sum(axis=1).astype(np.int64)
            if masks_delta is not None
            else None
        )

        # arm-specific query prep only (a bm25-only search must not pay
        # dense-embedding latency, nor a dense-only search the tokenize)
        if mode != "dense":
            from openintel_tpu.ops.bm25 import encode_query

            term_ids = [encode_query(st.main_view, q) for q in queries]
        else:
            term_ids = [[] for _ in queries]
        if mode != "bm25":
            if query_embeddings is None:
                query_embeddings = self._embedder(st)(list(queries))
            q_np = np.asarray(query_embeddings, np.float32)
        else:
            q_np = np.zeros((b, 1), np.float32)  # never read by bm25_merged

        # Bounded sub-batches (the base class's device_batch discipline:
        # fixed-shape dispatches, bounded jit cache / working set).
        # Padding rows are empty queries (group 0); results sliced to b.
        db = self._chunk_size(st, b)
        pad = (-b) % db
        if pad:
            term_ids = term_ids + [[]] * pad
            q_np = np.concatenate(
                [q_np, np.zeros((pad, q_np.shape[1]), np.float32)]
            )
        if groups is not None:
            groups = np.concatenate([groups, np.zeros(pad, np.int32)])
        vals_chunks, ids_chunks = [], []
        for lo in range(0, b + pad, db):
            vals, ids = self._search_chunk(
                st, term_ids[lo : lo + db], q_np[lo : lo + db],
                k, c, mode, masks_main, masks_delta,
                groups[lo : lo + db] if groups is not None else None,
                unm_main, unm_delta,
                min(db, b - lo) if lo < b else 0,  # real rows this chunk
            )
            vals_chunks.append(vals)
            ids_chunks.append(ids)
        return SearchResult(
            ids=np.concatenate(ids_chunks)[:b],
            scores=np.concatenate(vals_chunks)[:b],
        )

    def _search_chunk(
        self, st: "_Epoch", term_ids, q_np, k, c, mode, masks_main,
        masks_delta, groups, unm_main, unm_delta, n_real,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One device-batch chunk of the two-segment search: per-segment
        arm reductions (the MAIN segment through the overridable
        ``_main_*_ranked`` hooks), sharded-style (score, doc) merges, then
        RRF for hybrid mode (single-arm modes return their merged arm
        directly). ``masks_*`` are None or (G, n_segment) stacks with
        ``groups`` (chunk-aligned) giving each query's mask row."""
        from openintel_tpu.models.retrievers import grouped_query_plan

        delta_idx = st.delta_postings
        n_delta = delta_idx.n_docs

        def delta_plan():
            if masks_delta is None:
                return build_query_plan(
                    delta_idx, term_ids,
                    max_postings_per_term=prune_m, multi_budget=mb,
                )
            return grouped_query_plan(
                delta_idx, term_ids, masks_delta, groups,
                max_postings_per_term=prune_m, multi_budget=mb,
            )

        def bm25_merged(main=None):
            # two mask-aware plans (main keeps the C++ planner), two
            # device reductions, sharded-style merge by (score, doc);
            # ``main`` short-circuits the main arm when the fused hook
            # already produced it
            bv_m, bi_m = main if main is not None else self._main_bm25_ranked(
                st, term_ids, min(c, st.n_main), masks_main, groups,
                prune_m, mb,
            )
            plan_d = delta_plan()
            bv_d, bi_d = bm25_topk_device(
                plan_d.doc_ids, plan_d.weights, delta_idx.n_docs,
                min(c, n_delta),
                presorted=plan_d.presorted, max_run=plan_d.max_terms,
            )
            bi_d2 = np.asarray(bi_d)
            bi_d2 = np.where(bi_d2 >= 0, bi_d2 + st.n_main, -1)
            return _merge_ranked(
                bv_m, bi_m, np.asarray(bv_d), bi_d2, c,
            )

        def dense_merged(main=None):
            # main arm (configured kernel) + small exact delta arm, one
            # shared query dtype (see _main_query_dtype)
            q_dev = jnp.asarray(q_np, self._main_query_dtype(st))
            dv_m, di_m = main if main is not None else self._main_dense_ranked(
                st, q_np, q_dev, min(c, st.n_main), masks_main, groups,
                unm_main, n_real,
            )
            dv_d, di_d = self._dense_arm(
                st.delta_dense, q_dev, c, masks_delta, groups, unm_delta,
                n_real,
            )
            di_d = np.where(di_d >= 0, di_d + st.n_main, -1)
            return _merge_ranked(dv_m, di_m, dv_d, di_d, c)

        prune_m = auto_prune_m(st.n_total, c)
        mb = max(256, c)
        if mode == "bm25":
            return bm25_merged()
        if mode == "dense":
            return dense_merged()
        fused = self._main_arms_ranked(
            st, term_ids, q_np,
            jnp.asarray(q_np, self._main_query_dtype(st)),
            min(c, st.n_main), masks_main, groups, unm_main, n_real,
            prune_m, mb,
        )
        _, b_ids = bm25_merged(fused[:2] if fused is not None else None)
        _, d_ids = dense_merged(fused[2:] if fused is not None else None)
        vals, ids = rrf_fuse_device(
            jnp.asarray(b_ids), jnp.asarray(d_ids), k, self.rrf_k
        )
        return np.asarray(vals), np.asarray(ids)

    # ------------------------------------------------------------ compact

    def compact(self) -> tuple[PostingsIndex, DenseIndex, np.ndarray]:
        """Fold main + delta − tombstones into ONE fresh segment with TRUE
        statistics (avgdl/df/idf recomputed over the surviving docs,
        impacts re-saturated from the stored tf) and densely renumbered
        ids. Returns (postings, dense, id_map) where ``id_map[old] = new``
        (-1 for deleted); serve the result with a fresh retriever."""
        st = self._st
        merged = merge_postings(
            self._base_postings(st), st.delta_postings,
            st.n_total,
        )
        alive = st.alive
        id_map = np.full(alive.shape[0], -1, np.int64)
        id_map[alive] = np.arange(int(alive.sum()))
        n_new = int(alive.sum())
        keep_post = alive[merged.doc_ids]
        doc_ids = id_map[merged.doc_ids[keep_post]].astype(np.int32)
        tf = merged.tf[keep_post]
        # recompute per-term offsets/df over surviving postings
        v = merged.term_offsets.shape[0] - 1
        term_of_post = np.repeat(
            np.arange(v), np.diff(merged.term_offsets)
        )[keep_post]
        df = np.bincount(term_of_post, minlength=v).astype(np.int32)
        offsets = np.zeros(v + 1, np.int64)
        np.cumsum(df, out=offsets[1:])
        doc_len = merged.doc_len[alive]
        avgdl = float(doc_len.astype(np.float64).mean()) if n_new else 0.0
        impact = (
            bm25_impact(tf, doc_len[doc_ids], avgdl, merged.config)
            if tf.size
            else np.zeros(0, np.float32)
        )
        postings = PostingsIndex(
            term_offsets=offsets,
            doc_ids=doc_ids,
            tf=tf,
            impact=impact,
            df=df,
            idf=bm25_idf(df, n_new),
            doc_len=doc_len,
            avgdl=avgdl,
            n_docs=n_new,
            vocab=merged.vocab,
            config=merged.config,
        )
        all_emb = np.concatenate(
            [self._base_dense_rows(st), st.delta_emb]
        )
        dense = DenseIndex.from_embeddings(
            all_emb[alive], dtype=self._store_dtype,
        )
        return postings, dense, id_map

    def compact_in_place(self) -> np.ndarray:
        """``compact()`` and keep serving: build the fresh single segment,
        stage it on device as a new base retriever, and publish it as the
        next epoch (empty delta, no tombstones) in one atomic swap —
        searches in flight finish on the old epoch, new ones see the
        compacted corpus. Returns the ``id_map`` (old -> new, -1 for
        deleted); the CALLER owns renumbering any id-keyed state of its
        own (e.g. the MCP server's snippet store) — hold ``update_lock``
        around this call and that renumbering to make them atomic.

        Cost: the O(nnz) fold plus re-staging the corpus on device (the
        one unavoidable price of a new main segment)."""
        with self._update_lock:
            st = self._st
            postings, dense, id_map = self.compact()
            base = self._new_base(
                postings, dense, self._embedder(st),
                kernel=st.base.kernel,
                device_batch=st.base.device_batch,
            )
            self._st = _Epoch(
                base=base,
                alive=np.ones(postings.n_docs, bool),
                delta_texts=(),
                delta_tokens=(),
                delta_emb=np.zeros((0, dense.dim), np.float32),
                delta_postings=None,
                delta_dense=None,
                main_view=postings,
                docs=(
                    tuple(
                        st.docs[i]
                        for i in range(len(st.docs))
                        if id_map[i] >= 0
                    )
                    if st.docs is not None
                    else None
                ),
            )
        return id_map
