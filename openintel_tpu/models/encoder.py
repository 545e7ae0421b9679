"""Neural text encoder: a compact transformer for dense retrieval
and learned post analysis.

The reference's ``PostAnalyzer`` port is explicitly documented as "designed to
be replaced by an ML/LLM scorer" (reference: src/domain/ports/post_analyzer.rs:60-63,
README.md:190-191); its dense-retrieval analogue in BASELINE.md needs a real
query/document embedder. This module provides both from one trunk:

- pure functional params-as-pytree transformer (pre-LN, MHA + GELU MLP, mean
  pooling, L2 norm) — everything jittable, static shapes, bf16-friendly;
- InfoNCE contrastive training step (in-batch negatives) for retrieval;
- a 2-logit head (polarity, speculative) implementing the PostAnalyzer
  contract, trainable by distillation from the lexicon analyzer;
- tensor-parallel PartitionSpecs: attention sharded over heads, MLP sharded
  column-then-row, embeddings replicated — DP over the batch. XLA inserts
  the collectives from the shardings (no hand-written NCCL analogue).

No flax/haiku dependency: params are plain dicts, transforms are jax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32_768
    dim: int = 256
    depth: int = 4
    heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 128
    dtype: str = "float32"  # compute dtype; params stay f32

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def init_params(key: jax.Array, cfg: EncoderConfig) -> dict:
    """Initialise the encoder parameter pytree (f32)."""
    k_emb, k_pos, *k_blocks = jax.random.split(key, 2 + cfg.depth)
    scale = cfg.dim**-0.5
    params = {
        "tok_emb": jax.random.normal(k_emb, (cfg.vocab_size, cfg.dim)) * scale,
        "pos_emb": jax.random.normal(k_pos, (cfg.max_len, cfg.dim)) * scale,
        "blocks": [],
        "ln_f": {"g": jnp.ones(cfg.dim), "b": jnp.zeros(cfg.dim)},
    }
    for kb in k_blocks:
        k1, k2, k3, k4 = jax.random.split(kb, 4)
        mlp = cfg.dim * cfg.mlp_ratio
        params["blocks"].append(
            {
                "ln1": {"g": jnp.ones(cfg.dim), "b": jnp.zeros(cfg.dim)},
                "qkv": jax.random.normal(k1, (cfg.dim, 3 * cfg.dim)) * scale,
                "proj": jax.random.normal(k2, (cfg.dim, cfg.dim)) * scale,
                "ln2": {"g": jnp.ones(cfg.dim), "b": jnp.zeros(cfg.dim)},
                "fc1": jax.random.normal(k3, (cfg.dim, mlp)) * scale,
                "fc2": jax.random.normal(k4, (mlp, cfg.dim)) * (mlp**-0.5),
            }
        )
    return params


def _ln(x, p):
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.var(x, axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-6) * p["g"] + p["b"]


def _block(x, mask, p, cfg: EncoderConfig):
    b, s, d = x.shape
    h, hd = cfg.heads, cfg.head_dim
    y = _ln(x, p["ln1"])
    qkv = (y @ p["qkv"]).reshape(b, s, 3, h, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (b, s, h, hd)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    att = jnp.where(mask[:, None, None, :], att, -1e9)
    att = jax.nn.softmax(att, axis=-1)
    o = jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, d)
    x = x + o @ p["proj"]
    y = _ln(x, p["ln2"])
    x = x + jax.nn.gelu(y @ p["fc1"]) @ p["fc2"]
    return x


def encode(params: dict, cfg: EncoderConfig, ids: jax.Array, mask: jax.Array):
    """(B, S) int32 ids + bool mask -> (B, dim) unit-norm f32 embeddings."""
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    x = params["tok_emb"][ids] + params["pos_emb"][: ids.shape[1]][None]
    x = x.astype(dtype)
    for p in params["blocks"]:
        x = _block(x, mask, jax.tree_util.tree_map(lambda a: a.astype(dtype), p), cfg)
    x = _ln(x.astype(jnp.float32), params["ln_f"])
    denom = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
    pooled = jnp.sum(x * mask[:, :, None], axis=1) / denom
    return pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=1, keepdims=True), 1e-6)


# ---------------------------------------------------------------------------
# Training: InfoNCE contrastive retrieval + analyzer-head distillation
# ---------------------------------------------------------------------------


def info_nce_loss(params, cfg, q_ids, q_mask, d_ids, d_mask, temp=0.05):
    """Symmetric in-batch-negatives contrastive loss over (query, doc) pairs."""
    qe = encode(params, cfg, q_ids, q_mask)
    de = encode(params, cfg, d_ids, d_mask)
    logits = qe @ de.T / temp  # (B, B); diagonal = positives
    labels = jnp.arange(qe.shape[0])
    l_qd = jnp.mean(
        -jax.nn.log_softmax(logits, axis=1)[labels, labels]
    )
    l_dq = jnp.mean(
        -jax.nn.log_softmax(logits, axis=0)[labels, labels]
    )
    return 0.5 * (l_qd + l_dq)


def init_analyzer_head(key: jax.Array, cfg: EncoderConfig) -> dict:
    k = jax.random.split(key, 1)[0]
    return {
        "w": jax.random.normal(k, (cfg.dim, 2)) * cfg.dim**-0.5,
        "b": jnp.zeros(2),
    }


def analyzer_logits(params, head, cfg, ids, mask):
    """(B, 2): [polarity in (-1,1) via tanh, speculative logit]."""
    e = encode(params, cfg, ids, mask)
    out = e @ head["w"] + head["b"]
    return jnp.stack([jnp.tanh(out[:, 0]), out[:, 1]], axis=1)


def distill_loss(params, head, cfg, ids, mask, target_pol, target_spec):
    """Distill the lexicon analyzer: MSE on polarity + BCE on speculative."""
    out = analyzer_logits(params, head, cfg, ids, mask)
    mse = jnp.mean((out[:, 0] - target_pol) ** 2)
    bce = jnp.mean(
        jnp.maximum(out[:, 1], 0)
        - out[:, 1] * target_spec
        + jnp.log1p(jnp.exp(-jnp.abs(out[:, 1])))
    )
    return mse + bce


def sgd_train_step(params, cfg, batch, lr=1e-2):
    """One jittable InfoNCE step (plain SGD; swap in optax at call sites)."""
    loss, grads = jax.value_and_grad(info_nce_loss)(params, cfg, *batch)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


# ---------------------------------------------------------------------------
# Sharding: TP over heads/MLP, DP over batch. XLA inserts the collectives.
# ---------------------------------------------------------------------------


def param_partition_specs(cfg: EncoderConfig, model_axis: str = "corpus"):
    """PartitionSpec pytree for tensor-parallel params over ``model_axis``.

    qkv shards its output (heads) dimension; proj shards its input; the MLP
    shards fc1 columns and fc2 rows — the Megatron layout, so each block
    needs exactly one all-reduce per sublayer, which XLA derives from the
    shardings (no explicit collectives in model code)."""
    from jax.sharding import PartitionSpec as P

    rep = P()
    block = {
        "ln1": {"g": rep, "b": rep},
        "qkv": P(None, model_axis),
        "proj": P(model_axis, None),
        "ln2": {"g": rep, "b": rep},
        "fc1": P(None, model_axis),
        "fc2": P(model_axis, None),
    }
    return {
        "tok_emb": rep,
        "pos_emb": rep,
        "blocks": [block] * cfg.depth,
        "ln_f": {"g": rep, "b": rep},
    }


# ---------------------------------------------------------------------------
# Host-facing embedder (the DenseRetriever/HybridRetriever plug-in)
# ---------------------------------------------------------------------------


class NeuralEmbedder:
    """texts -> (N, dim) unit-norm embeddings; drop-in for HashingEmbedder.

    Tokenises with the shared word tokenizer, hashes tokens into the encoder
    vocabulary, pads to length buckets (bounded jit variants)."""

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        params: Optional[dict] = None,
        seed: int = 0,
    ):
        self.cfg = cfg or EncoderConfig()
        self.params = (
            params
            if params is not None
            else init_params(jax.random.PRNGKey(seed), self.cfg)
        )
        self.dim = self.cfg.dim
        self._encode = jax.jit(
            lambda p, ids, mask: encode(p, self.cfg, ids, mask)
        )

    def tokenize(self, texts) -> tuple[np.ndarray, np.ndarray]:
        import zlib

        from openintel_tpu.ops.tokenizer import tokenize

        rows = []
        for t in texts:
            toks = tokenize(t)[: self.cfg.max_len]
            # stable hash (Python's hash() is per-process salted) into
            # [2, vocab_size-1]: id 0 is padding, id 1 is the reranker's
            # reserved [SEP] — a real token hashing to 1 would present
            # phantom segment boundaries in concatenated pairs
            rows.append(
                [
                    (zlib.crc32(w.encode()) % (self.cfg.vocab_size - 2)) + 2
                    for w in toks
                ]
                or [0]
            )
        width = 8
        while width < max((len(r) for r in rows), default=1):
            width *= 2
        width = min(width, self.cfg.max_len)
        ids = np.zeros((len(rows), width), np.int32)
        mask = np.zeros((len(rows), width), bool)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r[:width]
            mask[i, : len(r)] = True
        return ids, mask

    def __call__(self, texts) -> np.ndarray:
        # bounded chunks: one giant corpus call would materialise
        # (N, S, D) activations (plus (N, H, S, S) attention scores) in a
        # single program — at 100k docs that is GBs of working set for a
        # result that is only (N, dim). Chunking also keeps the jit cache
        # to the pow2 width buckets.
        texts = list(texts)
        chunk = 2048
        if len(texts) <= chunk:
            ids, mask = self.tokenize(texts)
            return np.asarray(
                self._encode(self.params, ids, mask), np.float32
            )
        out = np.empty((len(texts), self.dim), np.float32)
        for lo in range(0, len(texts), chunk):
            ids, mask = self.tokenize(texts[lo : lo + chunk])
            out[lo : lo + chunk] = np.asarray(
                self._encode(self.params, ids, mask), np.float32
            )
        return out
