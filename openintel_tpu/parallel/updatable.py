"""The sharded live corpus: per-shard-delta serving over a device mesh.

Closes the gap models/updatable.py documented: a live corpus used to be
single-chip, with mesh serving only consuming ``compact()`` output. This
subclass keeps the WHOLE main + delta + tombstones design of
:class:`~openintel_tpu.models.updatable.UpdatableHybridRetriever` (epochs,
frozen statistics, grouped filters, single-arm modes, compaction — the
reference has no analogue: it is stateless per invocation,
/root/reference/docs/superpowers/specs/2026-06-24-openintel-speculation-cli-design.md)
and swaps ONLY the main segment for a mesh-resident
:class:`~openintel_tpu.parallel.retriever.ShardedHybridRetriever` through
the five ``_main_*`` hooks:

- **BM25 main arm**: the combined-idf ``main_view`` feeds
  :func:`~openintel_tpu.parallel.retriever.shard_query_plans` — one global
  (mask-aware, C++) plan split at shard boundaries — then the sharded BM25
  program. The view swap is pure host state: device buffers never re-stage
  on an add, because idf lives in plan weights, not on device.
- **Dense main arm**: the sharded dense program; when tombstones/filters
  exist it rides the over-fetch + host-compaction path (exact masked
  sharded scan as the starvation fallback) rather than a full masked
  rescan — the property that makes mesh-scale tombstones affordable.
- **Delta**: unchanged — small single-device exact segment, merged with
  the main arm by (score desc, doc asc) exactly like the cross-shard
  merge, so results stay bit-identical to the combined-index oracle.
- **Compaction**: ``compact_in_place`` folds everything into one fresh
  segment and re-stages it over the SAME mesh in one epoch swap;
  searches in flight finish on the old epoch.

Cost model vs the fused single-segment path: while a delta exists, hybrid
searches pay one sharded dispatch per arm (instead of the fused hybrid
program) plus the tiny delta arms and a host merge; ``compact_in_place``
restores the fused path. Adds stay O(delta); deletes flip bits.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from openintel_tpu.index.schema import DenseIndex, PostingsIndex
from openintel_tpu.models.retrievers import SearchResult
from openintel_tpu.models.updatable import UpdatableHybridRetriever, _Epoch
from openintel_tpu.ops.fusion import RRF_K
from openintel_tpu.parallel.retriever import (
    ShardedHybridRetriever,
    shard_query_plans,
)
from openintel_tpu.parallel.sharded import sharded_bm25_topk


class ShardedUpdatableHybridRetriever(UpdatableHybridRetriever):
    """A live corpus served over a device mesh.

    Same surface and same results as :class:`UpdatableHybridRetriever`
    (asserted against the combined-index oracle in
    tests/test_sharded_updatable.py); the main segment shards over a
    ("data", "corpus") mesh like :class:`ShardedHybridRetriever`.
    """

    def __init__(
        self,
        postings: PostingsIndex,
        dense: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        mesh=None,
        data: int = 1,
        corpus: Optional[int] = None,
        kernel: Optional[str] = None,
        rrf_k: float = RRF_K,
        device_batch: int = 256,
        doc_store: Optional[Sequence[str]] = None,
        block_size: int = 4096,
        max_postings_per_term: Optional[int] = None,
        multi_budget: int = 256,
    ):
        # mesh config must exist before super().__init__ builds the base;
        # after the first base is staged, every rebuild (compaction)
        # reuses ITS mesh so the corpus never migrates devices mid-serve
        self._mesh_cfg = dict(
            mesh=mesh, data=data, corpus=corpus, block_size=block_size,
            max_postings_per_term=max_postings_per_term,
            multi_budget=multi_budget,
        )
        super().__init__(
            postings, dense, embedder,
            kernel=kernel, rrf_k=rrf_k, device_batch=device_batch,
            doc_store=doc_store,
        )

    @property
    def mesh(self):
        return self._st.base.mesh

    # ------------------------------------------------- main-segment hooks

    def _new_base(
        self, postings: PostingsIndex, dense: DenseIndex, embedder, *,
        kernel: Optional[str], device_batch: int,
    ) -> ShardedHybridRetriever:
        cfg = self._mesh_cfg
        # fusion="rrf" for the same reason as the single-chip updatable's
        # _new_base: the cross-segment merge is rank-based
        base = ShardedHybridRetriever(
            postings, dense, embedder,
            mesh=cfg["mesh"], data=cfg["data"], corpus=cfg["corpus"],
            kernel=kernel, rrf_k=self.rrf_k, fusion="rrf",
            block_size=cfg["block_size"],
            max_postings_per_term=cfg["max_postings_per_term"],
            multi_budget=cfg["multi_budget"],
            device_batch=device_batch,
        )
        cfg["mesh"] = base.mesh
        return base

    def _base_postings(self, st: _Epoch) -> PostingsIndex:
        return st.base.postings

    def _embedder(self, st: _Epoch):
        return st.base.embedder

    def _base_dense_rows(self, st: _Epoch) -> np.ndarray:
        return np.asarray(st.base.dense_index.embeddings, np.float32)

    def _base_dense_index(self, st: _Epoch) -> DenseIndex:
        return st.base.dense_index

    def _main_query_dtype(self, st: _Epoch):
        return jnp.float32 if st.base.kernel == "int8" else st.base._emb.dtype

    def _chunk_size(self, st: _Epoch, b: int) -> int:
        # every chunk dispatches through the mesh programs, whose batch
        # dimension shards over the data axis — round to a multiple
        db = min(st.base.device_batch, max(b, 1))
        return -(-db // st.base.data_size) * st.base.data_size

    def _main_bm25_ranked(
        self, st: _Epoch, term_ids, c: int, masks_main, groups,
        prune_m: int, mb: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """ONE global mask-aware plan over the combined-idf view, split at
        shard boundaries, dispatched through the sharded BM25 program —
        candidate sets identical to the single-chip plan, so the merged
        result equals the combined-index oracle."""
        base = st.base
        pdi, pw, meta = shard_query_plans(
            st.main_view, term_ids, base.n_shards,
            shard_size=base.shard_size,
            max_postings_per_term=prune_m, multi_budget=mb,
            doc_masks=masks_main, groups=groups,
        )
        vals, ids = sharded_bm25_topk(
            base.mesh, jnp.asarray(pdi), jnp.asarray(pw),
            base.shard_size, c,
            presorted=meta.presorted, max_run=meta.max_terms,
        )
        return np.asarray(vals), np.asarray(ids)

    def _main_dense_ranked(
        self, st: _Epoch, q_np: np.ndarray, q_dev, c: int, masks_main,
        groups, unm_main, n_real: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """The sharded dense program on the REAL rows of the chunk
        (padding rows stay host-side: the base re-buckets internally, and
        a padding row must never trigger its starvation fallback)."""
        del q_dev, unm_main
        b_chunk = len(q_np)
        vals = np.zeros((b_chunk, c), np.float32)
        ids = np.full((b_chunk, c), -1, np.int32)
        if n_real == 0:
            return vals, ids
        fkw = {}
        if masks_main is not None:
            fkw = {
                "filter_mask": masks_main,
                "filter_group": groups[:n_real],
            }
        res = st.base.search(
            [""] * n_real, k=c, mode="dense",
            query_embeddings=q_np[:n_real], **fkw,
        )
        w = res.ids.shape[1]
        vals[:n_real, :w] = res.scores
        ids[:n_real, :w] = res.ids
        return vals, ids

    def _main_arms_ranked(
        self, st: _Epoch, term_ids, q_np, q_dev, c: int, masks_main,
        groups, unm_main, n_real: int, prune_m: int, mb: int,
    ):
        """Both main arms from ONE sharded dispatch: the fused hybrid
        program already merges per-arm global rankings internally, so the
        live-corpus hybrid pays one corpus-wide program instead of two.
        Plans ride the combined-idf view with the combined-corpus prune
        budget, so the arms are bit-identical to the single-arm hooks.
        Filtered chunks (tombstones or user masks) return None — they
        keep the two mask-aware dispatch paths."""
        if masks_main is not None:
            return None
        del q_dev, unm_main, groups
        b_chunk = len(q_np)
        vals_z = np.zeros((b_chunk, c), np.float32)
        ids_z = np.full((b_chunk, c), -1, np.int32)
        if n_real == 0:
            return vals_z, ids_z, vals_z.copy(), ids_z.copy()
        _, (bv, bi), (dv, di) = st.base.search_with_arms(
            [""] * n_real, k=c, candidates_per_arm=c,
            query_embeddings=q_np[:n_real],
            term_ids=[list(t) for t in term_ids[:n_real]],
            plan_index=st.main_view,
            max_postings_per_term=prune_m, multi_budget=mb,
        )
        out = []
        for arr, z in ((bv, vals_z), (bi, ids_z), (dv, vals_z.copy()),
                       (di, ids_z.copy())):
            w = arr.shape[1]
            z[:n_real, :w] = arr
            out.append(z)
        return tuple(out)

    def _single_segment_search(
        self, st: _Epoch, queries, k: int, *, candidates_per_arm,
        mode: str, masks, groups, query_embeddings,
    ) -> SearchResult:
        """Delta-free fast path: the FUSED sharded program (hybrid) or the
        sharded single arm."""
        fkw = (
            {}
            if masks is None
            else {"filter_mask": masks, "filter_group": groups}
        )
        return st.base.search(
            queries, k=k, candidates_per_arm=candidates_per_arm,
            mode=mode, query_embeddings=query_embeddings, **fkw,
        )
