"""Index checkpointing: serialize built indexes to disk, mmap-reload.

The reference is stateless by design (no persistence in v1 — SURVEY.md §5),
but a large index build is long-running state worth checkpointing. Layout per
checkpoint ``<base>``:

- ``<base>.npz`` — postings CSR arrays + stats (a few hundred MB at 10M
  docs; loaded eagerly), with a ``<base>.vocab.json`` sidecar;
- ``<base>.npz`` + ``<base>.emb.npy`` for the dense index — the embedding
  matrix lives in a raw ``.npy`` so ``np.load(mmap_mode="r")`` actually maps
  it lazily (``np.load`` silently IGNORES mmap_mode for .npz members, so
  multi-GB matrices must not live inside the archive).

All writes are atomic (tmp + rename, arrays before sidecars) and loads
validate that the vocab sidecar matches the arrays it was saved with.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from openintel_tpu.index.schema import BM25Config, DenseIndex, PostingsIndex
from openintel_tpu.ops.tokenizer import Vocab

FORMAT_VERSION = 2


def _base(path: str | Path) -> Path:
    """Normalise '<x>' / '<x>.npz' to the checkpoint base path '<x>' so save
    and load always derive identical file names (with_suffix would mangle
    dotted names like 'run.v2')."""
    s = str(path)
    return Path(s[: -len(".npz")] if s.endswith(".npz") else s)


def _atomic_savez(target: Path, **arrays) -> None:
    tmp = target.parent / (target.name + ".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.rename(target)


def save_postings(index: PostingsIndex, path: str | Path) -> None:
    base = _base(path)
    base.parent.mkdir(parents=True, exist_ok=True)
    # A random pair token written into BOTH files makes the crash window
    # detectable even when the stale pairing happens to agree on sizes: a
    # crash between the two renames leaves the old npz (old/no token)
    # beside the new sidecar (new token), rejected at load. Vocab sidecar
    # FIRST, then the arrays atomically.
    import secrets

    pair_token = secrets.randbits(63)
    tmp_vocab = base.parent / (base.name + ".vocab.json.tmp")
    tmp_vocab.write_text(
        json.dumps(
            {"pair_token": pair_token, "token_to_id": index.vocab.token_to_id}
        )
    )
    tmp_vocab.rename(base.parent / (base.name + ".vocab.json"))
    _atomic_savez(
        base.parent / (base.name + ".npz"),
        term_offsets=index.term_offsets,
        doc_ids=index.doc_ids,
        tf=index.tf,
        impact=index.impact,
        df=index.df,
        idf=index.idf,
        doc_len=index.doc_len,
        meta=np.array([FORMAT_VERSION, index.n_docs], dtype=np.int64),
        stats=np.array([index.avgdl, index.config.k1, index.config.b], np.float64),
        pair_token=np.array([pair_token], dtype=np.int64),
    )


def load_postings(path: str | Path) -> PostingsIndex:
    base = _base(path)
    data = np.load(base.parent / (base.name + ".npz"))
    version, n_docs = (int(x) for x in np.asarray(data["meta"]))
    if version not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported index format version {version}")
    avgdl, k1, b = (float(x) for x in np.asarray(data["stats"]))
    sidecar = json.loads(
        (base.parent / (base.name + ".vocab.json")).read_text()
    )
    if "token_to_id" in sidecar:  # paired format (tokens are alnum-only, so
        # the wrapper key can never collide with a real vocabulary term)
        npz_token = (
            int(np.asarray(data["pair_token"])[0])
            if "pair_token" in data
            else None
        )
        if npz_token != int(sidecar["pair_token"]):
            raise ValueError(
                "vocab sidecar and postings arrays carry different pair "
                "tokens — interrupted save left a stale checkpoint pair"
            )
        raw_vocab = sidecar["token_to_id"]
    else:  # legacy flat sidecar (pre-pair-token): size check only
        raw_vocab = sidecar
    vocab = Vocab(token_to_id={k: int(v) for k, v in raw_vocab.items()})
    if vocab.size != int(data["df"].shape[0]):
        raise ValueError(
            f"vocab sidecar ({vocab.size} slots) does not match the postings "
            f"arrays ({int(data['df'].shape[0])} term slots) — "
            "stale/mismatched checkpoint pair"
        )
    return PostingsIndex(
        term_offsets=data["term_offsets"],
        doc_ids=data["doc_ids"],
        tf=data["tf"],
        impact=data["impact"],
        df=data["df"],
        idf=data["idf"],
        doc_len=data["doc_len"],
        avgdl=avgdl,
        n_docs=n_docs,
        vocab=vocab,
        config=BM25Config(k1=k1, b=b),
    )


def _is_bf16(dtype) -> bool:
    import ml_dtypes

    return dtype == np.dtype(ml_dtypes.bfloat16)


def save_dense(index: DenseIndex, path: str | Path) -> None:
    base = _base(path)
    base.parent.mkdir(parents=True, exist_ok=True)
    emb = np.asarray(index.embeddings)
    if _is_bf16(emb.dtype):
        raw, is_bf16 = emb.view(np.uint16), True
    elif emb.dtype in (np.float32, np.float16, np.float64):
        raw, is_bf16 = emb, False
    else:
        raise TypeError(f"unsupported embedding dtype {emb.dtype}")
    # the (potentially multi-GB) matrix lives OUTSIDE the npz so load can
    # genuinely memory-map it
    tmp = base.parent / (base.name + ".emb.tmp.npy")  # np.save appends .npy otherwise
    np.save(tmp, raw)
    tmp.rename(base.parent / (base.name + ".emb.npy"))
    _atomic_savez(
        base.parent / (base.name + ".npz"),
        meta=np.array(
            [FORMAT_VERSION, index.n_docs, index.dim, int(is_bf16)], np.int64
        ),
    )


def load_dense(path: str | Path, *, mmap: bool = True) -> DenseIndex:
    base = _base(path)
    data = np.load(base.parent / (base.name + ".npz"))
    version, n_docs, dim, is_bf16 = (int(x) for x in np.asarray(data["meta"]))
    if version not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported index format version {version}")
    emb_path = base.parent / (base.name + ".emb.npy")
    if emb_path.exists():
        emb = np.load(emb_path, mmap_mode="r" if mmap else None)
    else:  # version-1 checkpoints kept the matrix inside the npz
        emb = data["embeddings"]
    # A crash between the .emb.npy write and the meta write could pair an old
    # matrix with new meta — reject shape/dtype mismatches instead of loading
    # silently-corrupt embeddings (mirrors the postings vocab check).
    want_itemsize = 2 if is_bf16 else None
    if emb.size != n_docs * dim:
        raise ValueError(
            f"dense checkpoint matrix has {emb.size} elements, meta says "
            f"{n_docs} x {dim} — stale/mismatched checkpoint pair"
        )
    if want_itemsize is not None and emb.dtype.itemsize != want_itemsize:
        raise ValueError(
            f"dense checkpoint meta says bf16 (2-byte) storage but the matrix "
            f"dtype is {emb.dtype} — stale/mismatched checkpoint pair"
        )
    emb = emb.reshape(n_docs, dim)
    if is_bf16:
        import ml_dtypes

        emb = np.asarray(emb).view(ml_dtypes.bfloat16)
    return DenseIndex(embeddings=emb, n_docs=n_docs, dim=dim)


def save_index(
    prefix: str | Path,
    postings: PostingsIndex,
    dense: DenseIndex,
    docs=None,
    *,
    encoder: str | None = None,
) -> None:
    """Write the full on-disk index set at ``prefix`` — postings + dense
    arrays, the optional newline-delimited docs sidecar, and the meta
    sidecar recording how the dense rows were embedded (query time
    refuses a silent embedder mismatch). THE single writer of this
    four-file format: the CLI `index` paths and the MCP `compact_corpus`
    save all route here, so the layout cannot drift between surfaces."""
    import json

    prefix = str(prefix)
    if docs is not None and len(docs) != postings.n_docs:
        # a short/stale sidecar would shift every snippet after the gap
        # on reload (mirrors UpdatableHybridRetriever's doc_store check)
        raise ValueError(
            f"docs sidecar has {len(docs)} lines but the index has "
            f"{postings.n_docs} docs — refusing to persist a misaligned "
            "snippet store"
        )
    save_postings(postings, f"{prefix}.postings.npz")
    save_dense(dense, f"{prefix}.dense.npz")
    if docs is not None:
        Path(f"{prefix}.docs.txt").write_text("\n".join(docs))
    from openintel_tpu.index.schema import dense_store_name

    Path(f"{prefix}.meta.json").write_text(
        json.dumps(
            {
                "embedder": "neural" if encoder else "hashing",
                "dim": dense.dim,
                # derived from the matrix actually written (never a caller
                # claim), so meta cannot disagree with the stored dtype
                "dense_store": dense_store_name(
                    np.asarray(dense.embeddings).dtype
                ),
            }
        )
    )
