"""ShardedHybridRetriever: the servable multi-chip retrieval component.

The reference wires every capability it has into both composition roots
(reference: src/mcp/server.rs:171-192, src/main.rs:16-35); this component
gives the multi-chip path the same treatment. It owns the full lifecycle:

- load a saved index (postings + dense checkpoint, ``index.checkpoint``);
- pad the corpus shard-even and lay it out over a ("data", "corpus")
  mesh (``NamedSharding``, rows split over the corpus axis; the int8 path
  pads each shard to whole candidate-pass supers);
- per-query-batch host work: encode queries, build ONE global query plan
  (C++ planner fast path), split it at shard boundaries into per-shard
  local-id plans (:func:`shard_query_plans` — the single owner of that
  logic);
- run the one-program sharded hybrid step (per-shard BM25 + dense top-c,
  all-gather, deterministic global merge, fusion) and post-filter the
  corpus padding.

Cross-shard results are bit-identical to a single-chip run over the same
query plan (SURVEY.md hard part (d)): shards concatenate in shard order, so
equal scores resolve to the lower global doc id, and the split plan carries
exactly the global plan's candidates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from openintel_tpu import platform
from openintel_tpu.index.schema import DenseIndex, PostingsIndex
from openintel_tpu.models.embedding import HashingEmbedder
from openintel_tpu.models.retrievers import SearchResult
from openintel_tpu.ops.bm25 import _bucket, build_query_plan, encode_query
from openintel_tpu.ops.dense import SUPER_DOCS, int8_corpus, quantize_int8
from openintel_tpu.ops.fusion import BLEND_ALPHA, RRF_K
from openintel_tpu.parallel.mesh import CORPUS_AXIS, DATA_AXIS, make_mesh
from openintel_tpu.parallel.sharded import (
    sharded_bm25_topk,
    sharded_dense_topk,
    sharded_hybrid_topk,
)


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """Parse a CLI mesh spec: "8" -> (data=1, corpus=8); "2x4" -> (2, 4)."""
    s = spec.lower().strip()
    if "x" in s:
        d, c = s.split("x", 1)
        data, corpus = int(d), int(c)
    else:
        data, corpus = 1, int(s)
    if data < 1 or corpus < 1:
        raise ValueError(f"invalid mesh spec {spec!r}")
    return data, corpus


@dataclass(frozen=True)
class ShardedPlanMeta:
    """Host-side facts about a split plan the device step needs."""

    presorted: bool
    max_terms: int  # longest equal-doc run (distinct terms per query)
    width: int  # per-shard plan width


def shard_query_plans(
    index: PostingsIndex,
    queries_term_ids: Sequence[Sequence[int]],
    n_shards: int,
    *,
    shard_size: Optional[int] = None,
    max_postings_per_term: Optional[int] = None,
    multi_budget: int = 256,
    min_width: int = 128,
    doc_mask: Optional[np.ndarray] = None,
    doc_masks: Optional[np.ndarray] = None,
    groups: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, ShardedPlanMeta]:
    """Build ONE global query plan and split it at shard boundaries.

    Returns (doc_ids (S, B, W) int32 with sentinel ``shard_size``,
    weights (S, B, W) f32, meta). Ids are shard-local (global - shard_lo).

    Splitting the global plan (instead of planning per shard) keeps the
    candidate set — including impact pruning and multi-term forcing —
    byte-identical to the single-chip plan, so the merged cross-shard result
    equals the single-chip result exactly. Rows are sorted ascending by doc
    id, so each shard's entries are one contiguous slice (searchsorted).

    ``doc_mask`` builds a FILTERED global plan (masked docs never enter;
    same semantics as the single-chip plan — docs/specs/filtered-search.md),
    then splits it identically. ``doc_masks`` (G, n_docs) + ``groups``
    (B,) build the grouped per-query-filter plan
    (models.retrievers.grouped_query_plan) instead."""
    if doc_masks is not None:
        from openintel_tpu.models.retrievers import grouped_query_plan

        plan = grouped_query_plan(
            index, queries_term_ids, doc_masks, groups,
            max_postings_per_term=max_postings_per_term,
            multi_budget=multi_budget,
        )
    else:
        plan = build_query_plan(
            index,
            queries_term_ids,
            max_postings_per_term=max_postings_per_term,
            multi_budget=multi_budget,
            sort=True,
            doc_mask=doc_mask,
        )
    if shard_size is None:
        shard_size = -(-index.n_docs // n_shards)
    b, _ = plan.doc_ids.shape
    bounds = np.arange(n_shards + 1, dtype=np.int64) * shard_size
    # per row: positions of each shard boundary in the sorted id row
    cuts = np.empty((b, n_shards + 1), dtype=np.int64)
    for i in range(b):
        cuts[i] = np.searchsorted(plan.doc_ids[i], bounds)
    width = _bucket(max(int((cuts[:, 1:] - cuts[:, :-1]).max()), 1), min_width)

    pdi = np.full((n_shards, b, width), shard_size, dtype=np.int32)
    pw = np.zeros((n_shards, b, width), dtype=np.float32)
    for s in range(n_shards):
        lo = int(bounds[s])
        for i in range(b):
            a, z = int(cuts[i, s]), int(cuts[i, s + 1])
            if z > a:
                pdi[s, i, : z - a] = plan.doc_ids[i, a:z] - lo
                pw[s, i, : z - a] = plan.weights[i, a:z]
    return pdi, pw, ShardedPlanMeta(
        presorted=True, max_terms=plan.max_terms, width=width
    )


def shard_postings(index: PostingsIndex, lo: int, hi: int) -> PostingsIndex:
    """Slice a global PostingsIndex to the doc range [lo, hi) with local ids.

    Keeps global idf (what ``global_bm25_stats`` produces in a real build);
    used for per-host index shards and the multi-chip dry run."""
    v = index.term_offsets.shape[0] - 1
    term_offsets = np.zeros(v + 1, dtype=np.int64)
    ids_chunks, tf_chunks, imp_chunks = [], [], []
    total = 0
    for t in range(v):
        a, b = int(index.term_offsets[t]), int(index.term_offsets[t + 1])
        ids = index.doc_ids[a:b]
        m = (ids >= lo) & (ids < hi)
        sel = np.flatnonzero(m)
        ids_chunks.append(ids[sel] - lo)
        tf_chunks.append(index.tf[a:b][sel])
        imp_chunks.append(index.impact[a:b][sel])
        total += len(sel)
        term_offsets[t + 1] = total
    df_local = np.diff(term_offsets).astype(np.int32)
    return PostingsIndex(
        term_offsets=term_offsets,
        doc_ids=np.concatenate(ids_chunks).astype(np.int32)
        if total
        else np.zeros(0, np.int32),
        tf=np.concatenate(tf_chunks).astype(np.float32)
        if total
        else np.zeros(0, np.float32),
        impact=np.concatenate(imp_chunks).astype(np.float32)
        if total
        else np.zeros(0, np.float32),
        df=df_local,
        idf=index.idf,  # global idf
        doc_len=index.doc_len[lo:hi],
        avgdl=index.avgdl,
        n_docs=hi - lo,
        vocab=index.vocab,
        config=index.config,
    )


class ShardedHybridRetriever:
    """Hybrid (BM25 + dense + RRF) retrieval served over a device mesh.

    Drop-in alternative to ``models.retrievers.HybridRetriever`` for corpora
    that shard over chips: same ``search()`` surface, plus ``mode=`` to serve
    a single arm through the sharded program."""

    def __init__(
        self,
        postings: PostingsIndex,
        dense: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        mesh=None,
        data: int = 1,
        corpus: Optional[int] = None,
        kernel: Optional[str] = None,  # "xla" | "int8" | None = platform default
        rrf_k: float = RRF_K,
        fusion: str = "zblend",  # the single-chip default (measured A/B)
        blend_alpha: float = BLEND_ALPHA,
        block_size: int = 4096,
        max_postings_per_term: Optional[int] = None,
        multi_budget: int = 256,
        device_batch: int = 256,
    ):
        if mesh is None:
            devices = (
                jax.devices()[: data * corpus] if corpus is not None else None
            )
            mesh = make_mesh(data=data, corpus=corpus, devices=devices)
        self.mesh = mesh
        self.n_shards = int(self.mesh.shape[CORPUS_AXIS])
        self.data_size = int(self.mesh.shape[DATA_AXIS])
        self.postings = postings
        # host-side reference (usually mmap-backed) — compaction and the
        # sharded live corpus (parallel.updatable) read the original rows
        self.dense_index = dense
        self.n_docs = int(dense.n_docs)
        # ValueError (not assert): this is a user-input failure surfaced
        # through CLI/MCP error handlers, and must not vanish under -O
        if postings.n_docs != dense.n_docs:
            raise ValueError(
                f"postings ({postings.n_docs} docs) and dense index "
                f"({dense.n_docs} docs) disagree — mismatched checkpoint pair"
            )
        self.embedder = embedder or HashingEmbedder(dim=dense.dim)
        kernel = platform.check_kernel(kernel, dense.n_docs)
        self.kernel = kernel
        if fusion not in ("rrf", "zblend"):
            raise ValueError(f"unknown fusion {fusion!r}")
        self.rrf_k = rrf_k
        self.fusion = fusion
        self.blend_alpha = blend_alpha
        self.block_size = block_size
        self.max_postings_per_term = max_postings_per_term
        self.multi_budget = multi_budget
        self.device_batch = max(1, device_batch)

        # Shard-even corpus padding; the int8 pass consumes whole supers,
        # so its shards align to SUPER_DOCS (no in-jit re-pad of a shard).
        align = self.n_shards * (SUPER_DOCS if kernel == "int8" else 1)
        emb = np.asarray(dense.embeddings)
        pad = (-self.n_docs) % align
        if pad:
            emb = np.concatenate(
                [emb, np.zeros((pad, emb.shape[1]), emb.dtype)], axis=0
            )
        self.shard_size = emb.shape[0] // self.n_shards
        rows = NamedSharding(self.mesh, P(CORPUS_AXIS, None))
        if kernel == "int8":
            # int8 candidate rows + stored rows for the per-shard exact
            # rescore, both corpus-sharded
            self._emb = jax.device_put(int8_corpus(emb), rows)
            self._rescore = jax.device_put(jnp.asarray(emb), rows)
        else:
            self._emb = jax.device_put(jnp.asarray(emb), rows)
            self._rescore = None

    @classmethod
    def load(
        cls,
        index_prefix: str,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        **kwargs,
    ) -> "ShardedHybridRetriever":
        """Load a saved index pair (``openintel index --out PREFIX``) and
        shard it over the mesh."""
        from openintel_tpu.index.checkpoint import load_dense, load_postings

        postings = load_postings(f"{index_prefix}.postings.npz")
        dense = load_dense(f"{index_prefix}.dense.npz")
        return cls(postings, dense, embedder, **kwargs)

    def _postprocess(self, vals, ids, b: int, k: int) -> SearchResult:
        """Strip batch padding, mask corpus-padding ids, stable-compact."""
        vals = np.asarray(vals)[:b]
        ids = np.asarray(ids)[:b]
        bad = ids >= self.n_docs
        if bad.any():
            ids = np.where(bad, -1, ids)
            vals = np.where(bad, 0.0, vals)
            order = np.argsort(ids < 0, axis=1, kind="stable")
            ids = np.take_along_axis(ids, order, axis=1)
            vals = np.take_along_axis(vals, order, axis=1)
        return SearchResult(ids=ids.astype(np.int32), scores=vals.astype(np.float32))

    def _masked_dense_operand(self):
        """The stored rows for the exact masked dense scan: the rescore
        rows for the int8 path, the resident corpus otherwise."""
        return self._rescore if self.kernel == "int8" else self._emb

    def _mask_row_dev(self, padded_masks: np.ndarray, g: int) -> jax.Array:
        """Stage ONE padded mask row corpus-sharded — the (N_pad,) operand
        of :func:`sharded_dense_topk_masked` (exact masked scans run per
        distinct mask row)."""
        return jax.device_put(
            jnp.asarray(padded_masks[g]),
            NamedSharding(self.mesh, P(CORPUS_AXIS)),
        )

    def _pad_group_rows(
        self, rows: np.ndarray, db: int
    ) -> tuple[np.ndarray, int]:
        """Pad a group's row indices so dispatch shapes stay BUCKETED (the
        jit cache grows per distinct batch shape): counts >= db pad to a
        db multiple (chunks are exactly db); smaller counts pad to the
        next power-of-two multiple of the data axis, capped at db — at
        most log2(db/data) compiled sizes instead of one per count.
        Returns (padded index array, true row count); padding rows repeat
        index 0 and their results are discarded."""
        r = rows.size
        if r >= db:
            r_pad = -(-r // db) * db
        else:
            r_pad = self.data_size
            while r_pad < r:
                r_pad *= 2
            r_pad = min(r_pad, db)
        return np.concatenate([rows, np.zeros(r_pad - r, np.int64)]), r

    def _search_hybrid_filtered(
        self, q, q8, pdi, pw, meta, mask_dev, groups, shard_unmasked,
        *, b: int, k: int, c: int, nb: int, db: int,
    ) -> SearchResult:
        """Filtered sharded hybrid: one bounded dispatch per sub-batch of
        the filtered program, then the host starvation check — any query
        whose pool under-filled on SOME shard (survivors < min(c, its own
        group's per-shard unmasked count)) re-runs through the exact masked
        fallback (sharded masked dense over its group's mask row + the
        mask-aware BM25 plan rows + RRF). Exact at any selectivity, like
        the single-chip surface."""
        from openintel_tpu.models.retrievers import filtered_fetch_width
        from openintel_tpu.parallel.sharded import (
            _fuse_device,
            sharded_bm25_topk,
            sharded_dense_topk_masked,
            sharded_hybrid_filtered_topk,
        )

        # over-fetch width sized for the most selective group ACTUALLY in
        # the batch (padding rows excluded)
        group_unmasked = shard_unmasked.sum(axis=0)  # (G,)
        n_unmasked = int(group_unmasked[np.unique(groups[:b])].min())
        c_fetch = min(
            filtered_fetch_width(c, self.n_docs, n_unmasked), self.shard_size
        )
        pdi_d, pw_d = jnp.asarray(pdi), jnp.asarray(pw)
        g_dev = jnp.asarray(groups)
        outs = []  # device arrays only — convert AFTER the loop so the
        for lo in range(0, nb * db, db):  # sub-batch dispatches pipeline
            outs.append(sharded_hybrid_filtered_topk(
                self.mesh, self._emb, q[lo : lo + db],
                pdi_d[:, lo : lo + db], pw_d[:, lo : lo + db],
                mask_dev, g_dev[lo : lo + db], k,
                candidates_per_arm=c, c_fetch=c_fetch, rrf_k=self.rrf_k,
                fusion=self.fusion, blend_alpha=self.blend_alpha,
                block_size=self.block_size, kernel=self.kernel,
                presorted=meta.presorted, max_run=meta.max_terms,
                rescore=self._rescore,
                queries_i8=q8[lo : lo + db] if q8 is not None else None,
            ))
        vals_np = np.concatenate([np.asarray(v) for v, _, _ in outs])
        ids_np = np.concatenate([np.asarray(i) for _, i, _ in outs])
        surv_np = np.concatenate(  # (S, nb*db); np copies, so starved
            [np.asarray(s) for _, _, s in outs], axis=1  # rows patch in place
        )

        # Per-shard starvation: a shard's compacted list is exact-or-
        # complete iff it kept min(c, its OWN group's unmasked count on
        # that shard) survivors; a query starved on ANY shard may be
        # missing true filtered top-c docs from that shard. Padding rows
        # (>= b) never re-run.
        need = np.minimum(c, shard_unmasked[:, groups[:b]])  # (S, b)
        starved = np.flatnonzero((surv_np[:, :b] < need).any(axis=0))
        if starved.size:
            from openintel_tpu.models.retrievers import run_per_group

            op = self._masked_dense_operand()

            def arm(g, sub):
                rows, r = self._pad_group_rows(starved[sub], db)
                d_vals, d_ids = sharded_dense_topk_masked(
                    self.mesh, op, q[rows],
                    mask_dev[g],  # row slice of the resident device stack
                    c,
                    block_size=self.block_size,
                )
                b_vals, b_ids = sharded_bm25_topk(
                    self.mesh,
                    pdi_d[:, rows], pw_d[:, rows], self.shard_size, c,
                    presorted=meta.presorted, max_run=meta.max_terms,
                )
                fvals, fids = _fuse_device(
                    self.fusion,
                    jnp.asarray(b_vals), jnp.asarray(b_ids),
                    jnp.asarray(d_vals), jnp.asarray(d_ids),
                    k, self.rrf_k, self.blend_alpha,
                )
                return np.asarray(fvals)[:r], np.asarray(fids)[:r]

            fvals, fids = run_per_group(groups[starved], k, arm)
            vals_np[starved] = fvals
            ids_np[starved] = fids
        return self._postprocess(vals_np, ids_np, b, k)

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        query_embeddings: Optional[np.ndarray] = None,
        candidates_per_arm: Optional[int] = None,
        mode: str = "hybrid",
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        """Batched retrieval through the sharded device program.

        ``mode`` ∈ {"hybrid", "bm25", "dense"}. Query batches pad to the data
        axis; rankings are -1-padded like the single-chip retrievers.

        ``filter_mask`` (bool (n_docs,)) restricts results to unmasked docs
        with the single-chip semantics (docs/specs/filtered-search.md):
        BM25 filters in the (global, then split) plan; the dense arm
        over-fetches per shard and rank-compacts survivors; a host-side
        per-shard starvation check re-runs under-filled queries through the
        exact masked sharded fallback. Filtered hybrid runs one bounded
        dispatch per sub-batch (no scan fusion — the starvation check is
        per sub-batch host work). Per-query filters: (G, n_docs) masks +
        ``filter_group`` (one mask row index per query); the mask stack
        shards with the corpus and each query gathers its own row."""
        assert mode in ("hybrid", "bm25", "dense"), mode
        b = len(queries)
        if b == 0:
            return SearchResult(
                ids=np.zeros((0, k), np.int32), scores=np.zeros((0, k), np.float32)
            )
        k = min(k, self.n_docs)
        c = min(candidates_per_arm or k, self.n_docs)

        doc_masks = groups = None
        padded_masks = None  # (G, shard_size * n_shards) host bools
        mask_dev = None  # (G, N_pad) device, corpus-sharded on axis 1
        shard_unmasked = None  # (S, G) per-shard unmasked count per group
        if filter_mask is not None:
            from openintel_tpu.models.retrievers import _as_group_masks

            doc_masks, groups = _as_group_masks(
                filter_mask, filter_group, self.n_docs, b
            )
            padded_masks = np.zeros(
                (doc_masks.shape[0], self.shard_size * self.n_shards), bool
            )
            padded_masks[:, : self.n_docs] = doc_masks
            if mode == "hybrid":
                # only the fused hybrid program reads the full stack on
                # device; dense mode stages single rows (_mask_row_dev)
                # and the BM25 arm filters in the plan — no operand at all
                mask_dev = jax.device_put(
                    jnp.asarray(padded_masks),
                    NamedSharding(self.mesh, P(None, CORPUS_AXIS)),
                )
            shard_unmasked = (
                np.add.reduceat(
                    padded_masks,
                    np.arange(0, padded_masks.shape[1], self.shard_size),
                    axis=1,
                )
                .astype(np.int64)
                .T
            )
        elif filter_group is not None:
            raise ValueError("filter_group requires filter_mask")

        # Sub-batching: requests beyond ``device_batch`` queries scan
        # inside ONE device dispatch (sharded analogue of
        # HybridRetriever.run_prepared). db is a data-axis multiple; the
        # batch pads to nb * db.
        db = min(self.device_batch, max(b, 1))
        db = -(-db // self.data_size) * self.data_size
        pad = (-b) % db
        nb = (b + pad) // db
        if groups is not None:
            # padding rows carry group 0 (valid row; results discarded)
            groups = np.concatenate(
                [groups, np.zeros(nb * db - b, np.int32)]
            )

        q8 = None
        if mode in ("hybrid", "dense"):
            if query_embeddings is None:
                query_embeddings = self.embedder(list(queries))
            q_np = np.asarray(query_embeddings, np.float32)
            if pad:
                q_np = np.concatenate(
                    [q_np, np.zeros((pad, q_np.shape[1]), np.float32)]
                )
            if self.kernel == "int8":
                # every dense consumer runs the int8 pass: the hybrid
                # program, the unfiltered arm, and the filtered over-fetch
                # (only the masked starvation FALLBACK routes through the
                # stored rescore rows)
                q8 = jnp.asarray(quantize_int8(q_np))
                # f32 rescore queries: bf16-rounding the query shifts
                # near-ties in the exact rescore (models/retrievers.py)
                q = jnp.asarray(q_np, jnp.float32)
            else:
                q = jnp.asarray(q_np, self._emb.dtype)
        if mode in ("hybrid", "bm25"):
            from openintel_tpu.models.retrievers import auto_prune_m

            term_ids = [encode_query(self.postings, que) for que in queries]
            term_ids += [[]] * pad  # batch padding rows
            prune_m = (
                self.max_postings_per_term
                if self.max_postings_per_term is not None
                else auto_prune_m(self.n_docs, c)
            )
            pdi, pw, meta = shard_query_plans(
                self.postings,
                term_ids,
                self.n_shards,
                shard_size=self.shard_size,
                max_postings_per_term=prune_m,
                multi_budget=max(self.multi_budget, c),
                doc_masks=doc_masks,
                groups=groups,
            )

        if mode == "hybrid" and doc_masks is not None:
            return self._search_hybrid_filtered(
                q, q8, pdi, pw, meta, mask_dev, groups, shard_unmasked,
                b=b, k=k, c=c, nb=nb, db=db,
            )

        if mode == "hybrid" and nb > 1:
            from openintel_tpu.parallel.sharded import sharded_hybrid_topk_scan

            dim = q.shape[1]
            qbs = q.reshape(nb, db, dim)
            q8s = q8.reshape(nb, db, dim) if q8 is not None else None
            # (S, nb*db, W) -> (nb, S, db, W)
            pdis = jnp.asarray(
                np.stack(np.split(pdi, nb, axis=1))
            )
            pws = jnp.asarray(np.stack(np.split(pw, nb, axis=1)))
            vals, ids = sharded_hybrid_topk_scan(
                self.mesh, self._emb, qbs, pdis, pws, k,
                candidates_per_arm=c, rrf_k=self.rrf_k,
                fusion=self.fusion, blend_alpha=self.blend_alpha,
                block_size=self.block_size, kernel=self.kernel,
                presorted=meta.presorted, max_run=meta.max_terms,
                rescore=self._rescore, queries_i8=q8s,
                n_docs_true=self.n_docs,
            )
            return self._postprocess(
                np.asarray(vals).reshape(nb * db, k),
                np.asarray(ids).reshape(nb * db, k),
                b, k,
            )

        if mode == "dense" and doc_masks is not None:
            # Over-fetch + host rank-compaction (the single-chip
            # ``_dense_arm`` design at mesh altitude): ONE exact unfiltered
            # global top-c_fetch through the sharded kernel, keep each
            # query's unmasked survivors, and re-run only STARVED queries
            # (survivors < min(k, their group's unmasked count)) through
            # the exact masked scan per group. Tombstone-sparse filters —
            # the sharded live corpus's common case — cost ~one unfiltered
            # dispatch instead of a full masked rescan per mask row; the
            # fallback keeps exactness at any selectivity.
            from openintel_tpu.models.retrievers import (
                filtered_fetch_width,
                run_per_group,
            )
            from openintel_tpu.parallel.sharded import sharded_dense_topk_masked

            group_unmasked = doc_masks.sum(axis=1).astype(np.int64)  # (G,)
            counts = group_unmasked[np.unique(groups[:b])]
            counts = counts[counts > 0]
            c_fetch = min(
                filtered_fetch_width(
                    k, self.n_docs, int(counts.min()) if counts.size else 0
                ),
                self.shard_size,
            )
            outs = [
                sharded_dense_topk(
                    self.mesh, self._emb, q[lo : lo + db], c_fetch,
                    block_size=self.block_size, kernel=self.kernel,
                    rescore=self._rescore,
                    queries_i8=q8[lo : lo + db] if q8 is not None else None,
                    n_docs_true=self.n_docs,
                )
                for lo in range(0, nb * db, db)
            ]
            vals0 = np.concatenate([np.asarray(v) for v, _ in outs])
            ids0 = np.concatenate([np.asarray(i) for _, i in outs])
            keep = (ids0 >= 0) & doc_masks[
                groups[:, None], np.maximum(ids0, 0)
            ]
            vals = np.zeros((nb * db, k), np.float32)
            ids = np.full((nb * db, k), -1, np.int32)
            surv = keep.sum(axis=1)
            for i in range(nb * db):
                kept = np.flatnonzero(keep[i])[:k]
                vals[i, : kept.size] = vals0[i, kept]
                ids[i, : kept.size] = ids0[i, kept]
            need = np.minimum(k, group_unmasked[groups])
            starved = np.flatnonzero(surv < need)
            starved = starved[starved < b]  # padding rows never re-run
            if starved.size:
                op = self._masked_dense_operand()

                def arm(g, sub):
                    sel, r = self._pad_group_rows(starved[sub], db)
                    mrow = self._mask_row_dev(padded_masks, g)
                    souts = [
                        sharded_dense_topk_masked(
                            self.mesh, op, q[sel[lo : lo + db]], mrow, k,
                            block_size=self.block_size,
                        )
                        for lo in range(0, sel.size, db)
                    ]
                    return (
                        np.concatenate([np.asarray(v) for v, _ in souts])[:r],
                        np.concatenate([np.asarray(i) for _, i in souts])[:r],
                    )

                fvals, fids = run_per_group(groups[starved], k, arm)
                vals[starved] = fvals
                ids[starved] = fids
        elif mode == "dense":
            # bounded sub-batches: one jitted program per db-sized chunk
            # (a single giant dispatch would spike the b x shard_size score
            # working set and compile a fresh program per total batch size)
            outs = [
                sharded_dense_topk(
                    self.mesh, self._emb, q[lo : lo + db], k,
                    block_size=self.block_size, kernel=self.kernel,
                    rescore=self._rescore,
                    queries_i8=q8[lo : lo + db] if q8 is not None else None,
                    n_docs_true=self.n_docs,
                )
                for lo in range(0, nb * db, db)
            ]
            vals = np.concatenate([np.asarray(v) for v, _ in outs])
            ids = np.concatenate([np.asarray(i) for _, i in outs])
        elif mode == "bm25":
            pdi_d, pw_d = jnp.asarray(pdi), jnp.asarray(pw)
            outs = [
                sharded_bm25_topk(
                    self.mesh,
                    pdi_d[:, lo : lo + db], pw_d[:, lo : lo + db],
                    self.shard_size, k,
                    presorted=meta.presorted, max_run=meta.max_terms,
                )
                for lo in range(0, nb * db, db)
            ]
            vals = np.concatenate([np.asarray(v) for v, _ in outs])
            ids = np.concatenate([np.asarray(i) for _, i in outs])
        else:
            vals, ids = sharded_hybrid_topk(
                self.mesh, self._emb, q, jnp.asarray(pdi), jnp.asarray(pw), k,
                candidates_per_arm=c, rrf_k=self.rrf_k,
                fusion=self.fusion, blend_alpha=self.blend_alpha,
                block_size=self.block_size, kernel=self.kernel,
                presorted=meta.presorted, max_run=meta.max_terms,
                rescore=self._rescore, queries_i8=q8,
                n_docs_true=self.n_docs,
            )
        return self._postprocess(vals, ids, b, k)

    def search_with_arms(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        query_embeddings: Optional[np.ndarray] = None,
        term_ids: Optional[Sequence[Sequence[int]]] = None,
        plan_index: Optional[PostingsIndex] = None,
        max_postings_per_term: Optional[int] = None,
        multi_budget: Optional[int] = None,
    ) -> tuple[
        SearchResult,
        tuple[np.ndarray, np.ndarray],
        tuple[np.ndarray, np.ndarray],
    ]:
        """Unfiltered hybrid search that ALSO returns the globally-merged
        per-arm rankings the fusion consumed: (fused SearchResult,
        (bm25_vals, bm25_ids), (dense_vals, dense_ids)), arms ranked to
        ``candidates_per_arm``. One corpus-wide dispatch — the sharded
        live corpus merges these with its delta arms
        (parallel/updatable.py) instead of dispatching each arm
        separately. Arm ids are -1-padded with 0.0 scores; corpus-padding
        docs never appear (masked inside the program).

        ``term_ids``/``plan_index``/``max_postings_per_term``/
        ``multi_budget`` let a caller bring its OWN statistics view — the
        updatable wrapper plans over its combined-idf ``main_view`` with
        the combined-corpus prune budget, so the arm rankings stay
        bit-identical to its single-arm hooks."""
        from openintel_tpu.models.retrievers import auto_prune_m

        b = len(queries)
        if b == 0:
            z = lambda w: (  # noqa: E731 - tiny local shape helper
                np.zeros((0, w), np.float32), np.full((0, w), -1, np.int32)
            )
            empty = SearchResult(ids=z(k)[1], scores=z(k)[0])
            return empty, z(k), z(k)
        k = min(k, self.n_docs)
        c = min(candidates_per_arm or k, self.n_docs)
        db = min(self.device_batch, max(b, 1))
        db = -(-db // self.data_size) * self.data_size
        pad = (-b) % db
        nb = (b + pad) // db

        if query_embeddings is None:
            query_embeddings = self.embedder(list(queries))
        q_np = np.asarray(query_embeddings, np.float32)
        if pad:
            q_np = np.concatenate(
                [q_np, np.zeros((pad, q_np.shape[1]), np.float32)]
            )
        q8 = None
        if self.kernel == "int8":
            q8 = jnp.asarray(quantize_int8(q_np))
            q = jnp.asarray(q_np, jnp.float32)
        else:
            q = jnp.asarray(q_np, self._emb.dtype)

        plan_index = plan_index if plan_index is not None else self.postings
        if term_ids is None:
            term_ids = [encode_query(plan_index, que) for que in queries]
        else:
            term_ids = list(term_ids)
        term_ids += [[]] * pad
        if max_postings_per_term is not None:
            prune_m = max_postings_per_term
        elif self.max_postings_per_term is not None:
            prune_m = self.max_postings_per_term
        else:
            prune_m = auto_prune_m(self.n_docs, c)
        pdi, pw, meta = shard_query_plans(
            plan_index, term_ids, self.n_shards,
            shard_size=self.shard_size,
            max_postings_per_term=prune_m,
            multi_budget=(
                multi_budget
                if multi_budget is not None
                else max(self.multi_budget, c)
            ),
        )
        pdi_d, pw_d = jnp.asarray(pdi), jnp.asarray(pw)
        outs = [
            sharded_hybrid_topk(
                self.mesh, self._emb, q[lo : lo + db],
                pdi_d[:, lo : lo + db], pw_d[:, lo : lo + db], k,
                candidates_per_arm=c, rrf_k=self.rrf_k,
                fusion=self.fusion, blend_alpha=self.blend_alpha,
                block_size=self.block_size, kernel=self.kernel,
                presorted=meta.presorted, max_run=meta.max_terms,
                rescore=self._rescore,
                queries_i8=q8[lo : lo + db] if q8 is not None else None,
                n_docs_true=self.n_docs,
                return_arms=True,
            )
            for lo in range(0, nb * db, db)
        ]
        cat = lambda i: np.concatenate(  # noqa: E731
            [np.asarray(o[i]) for o in outs]
        )[:b]
        fused = self._postprocess(cat(0), cat(1), b, k)
        return fused, (cat(2), cat(3)), (cat(4), cat(5))
