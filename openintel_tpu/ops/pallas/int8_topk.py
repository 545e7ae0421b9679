"""The int8 candidate pass as a Hopper kernel (Pallas, Triton route).

Same semantics as :func:`openintel_tpu.ops.dense.int8_topk_xla`; what the
kernel saves is device memory traffic. The plain version writes a (B, N)
int32 score matrix (2.7x the int8 corpus at B=256, D=384) and reads it back
twice; here each program keeps its running top-2 keys in registers and
writes only (BLOCK_Q, 2 * 128) keys per span of docs.

Grid: (query tiles, spans), both parallel; the query tile varies fastest so
the tiles that read one span of the corpus run together and share it
through L2. A program loops over the ``span`` sub-tiles of 128 docs of its
span: per sub-tile, (BLOCK_Q, D) x (128, D)^T int8 products accumulate in
int32 on the tensor cores (D in power-of-two chunks of at most 128, the
block sizes Triton accepts), the scores pack with their position into keys,
and a branchless top-2 fold keeps two keys per lane. Spans of one super
are merged with the other supers of their group by the shared second step,
:func:`openintel_tpu.ops.dense.int8_merge_topk`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from openintel_tpu.ops.dense import (
    KEY_BIAS,
    LANES,
    SUPER_DOCS,
    SUPER_TILES,
    int8_merge_topk,
)

# Tuned on an H100 at 1.25M x 384, batch 256 (docs/kernels.md): 128-row
# query tiles over spans of 32 sub-tiles give enough programs for 132 SMs;
# more stages overflow the shared memory a block may use.
BLOCK_Q = 128  # query rows per program (the padding unit of the batch)
SPAN = 32  # sub-tiles of 128 docs per program; divides SUPER_TILES
NUM_WARPS = 8
NUM_STAGES = 3


def _span_top2_kernel(q_ref, c_ref, out_ref, *, d_chunk, span, n_docs):
    j = pl.program_id(1)
    base = (j % (SUPER_TILES // span)) * span
    lane = jax.lax.broadcasted_iota(jnp.int32, (q_ref.shape[0], LANES), 1)
    qs = [
        q_ref[:, pl.ds(d, d_chunk)]
        for d in range(0, q_ref.shape[1], d_chunk)
    ]

    def body(t, carry):
        a1, a2 = carry
        rows = pl.ds(pl.multiple_of(t * LANES, LANES), LANES)
        s = None
        for i, qd in enumerate(qs):
            part = pl.dot(qd, c_ref[rows, pl.ds(i * d_chunk, d_chunk)], trans_b=True)
            s = part if s is None else s + part
        key = s * LANES + (KEY_BIAS + base + t)
        key = jnp.where(lane < n_docs - (j * span + t) * LANES, key, 0)
        return jnp.maximum(a1, key), jnp.maximum(a2, jnp.minimum(a1, key))

    zero = jnp.zeros((q_ref.shape[0], LANES), jnp.int32)
    a1, a2 = jax.lax.fori_loop(0, span, body, (zero, zero))
    out_ref[:, pl.ds(0, LANES)] = a1
    out_ref[:, pl.ds(LANES, LANES)] = a2


@functools.partial(jax.jit, static_argnames=("n_docs", "interpret", "span"))
def int8_span_top2(
    corpus8: jax.Array,  # (N_pad, D) int8, N_pad a multiple of SUPER_DOCS
    q8: jax.Array,  # (B, D) int8
    *,
    n_docs: int,
    interpret: bool,
    span: int = SPAN,
) -> jax.Array:
    """Top-2 keys per (span, lane): (B, n_super, 2 * SUPER_TILES // span,
    128) int32, the input of ``int8_merge_topk``."""
    n_pad, dim = corpus8.shape
    if n_pad % SUPER_DOCS or SUPER_TILES % span:
        raise ValueError(f"corpus rows {n_pad} not in whole supers / span {span}")
    b = q8.shape[0]
    if dim % 16:  # Triton's dot wants every dimension >= 16
        d_pad = -dim % 16
        corpus8 = jnp.pad(corpus8, ((0, 0), (0, d_pad)))
        q8 = jnp.pad(q8, ((0, 0), (0, d_pad)))
        dim += d_pad
    b_pad = -(-b // BLOCK_Q) * BLOCK_Q
    q8 = jnp.pad(q8, ((0, b_pad - b), (0, 0)))
    n_spans = n_pad // (span * LANES)
    keys = pl.pallas_call(
        functools.partial(
            _span_top2_kernel, d_chunk=min(LANES, dim & -dim), span=span,
            n_docs=n_docs,
        ),
        grid=(b_pad // BLOCK_Q, n_spans),
        in_specs=[
            pl.BlockSpec((BLOCK_Q, dim), lambda i, j: (i, 0)),
            pl.BlockSpec((span * LANES, dim), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((BLOCK_Q, 2 * LANES), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((b_pad, n_spans * 2 * LANES), jnp.int32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="int8_span_top2",
    )(q8, corpus8)
    n_super = n_pad // SUPER_DOCS
    return keys[:b].reshape(b, n_super, 2 * SUPER_TILES // span, LANES)


@functools.partial(
    jax.jit, static_argnames=("k", "n_docs", "group", "interpret")
)
def int8_topk(
    corpus8: jax.Array,
    q8: jax.Array,
    *,
    k: int,
    n_docs: int,
    group: int,
    interpret: bool,
) -> tuple[jax.Array, jax.Array]:
    """The int8 candidate pass: (vals (B, k), ids (B, k)), bit-identical to
    :func:`openintel_tpu.ops.dense.int8_topk_xla`."""
    return int8_merge_topk(
        int8_span_top2(corpus8, q8, n_docs=n_docs, interpret=interpret),
        k=k, n_docs=n_docs, group=group,
    )
