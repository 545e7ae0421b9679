"""Multi-host entry: jax.distributed wiring for multi-host builds/serving.

The single-host mesh code (parallel.mesh / parallel.sharded) is already
multi-host-shaped: a ("data", "corpus") mesh over ``jax.devices()`` spans
hosts transparently once ``jax.distributed.initialize`` has run; XLA hands
the collectives to NCCL, which joins the cards of one host all to all over
NVLink and reaches other hosts over the network (SURVEY.md §5 "distributed
communication backend"). This module is the one
place that owns process-group bring-up; the CLI exposes it as
``--coordinator`` on the index/search/mcp subcommands.

Typical 2-host launch (same index prefix on both hosts)::

    host0$ openintel search q --index IDX --mesh 2x8 \
               --coordinator host0:8476 --num-processes 2 --process-id 0
    host1$ openintel search q --index IDX --mesh 2x8 \
               --coordinator host0:8476 --num-processes 2 --process-id 1

Demonstrated hermetically in tests/test_multihost.py: two OS processes (4
virtual CPU devices each) join one process group through
:func:`initialize_distributed`, and ``ShardedHybridRetriever`` serves all
four modes over the cross-process 8-device mesh bit-identically to the
single-process oracle. Flag plumbing / argument validation is covered in
tests/test_distributed.py. No multi-host run on real cards has been made, so
the cost of the cross-host collectives is not measured.
"""

from __future__ import annotations

import os
from typing import Optional

_initialized = False


def initialize_distributed(
    coordinator: Optional[str],
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host process group. Returns True when initialization
    ran, False when skipped (no coordinator given).

    Must be called before any jax device/backend use in this process.
    ``num_processes``/``process_id`` fall back to the standard env vars
    (JAX_NUM_PROCESSES / JAX_PROCESS_ID) when omitted."""
    global _initialized
    if not coordinator:
        return False
    if _initialized:
        raise RuntimeError("distributed runtime already initialized")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if (num_processes is None) != (process_id is None):
        raise ValueError(
            "--num-processes and --process-id must be given together"
        )
    if num_processes is not None:
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {num_processes}")
        if not (0 <= process_id < num_processes):
            raise ValueError(
                f"process_id {process_id} out of range for "
                f"{num_processes} processes"
            )
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def add_distributed_flags(parser) -> None:
    """Attach the multi-host flags to an argparse subparser."""
    parser.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="multi-host: jax.distributed coordinator address "
        "(run the same command on every host)",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None,
        help="multi-host: total process count (with --coordinator)",
    )
    parser.add_argument(
        "--process-id", type=int, default=None,
        help="multi-host: this process's rank (with --coordinator)",
    )


def initialize_from_args(args) -> bool:
    """CLI hook: initialize the process group from parsed flags (no-op
    without --coordinator)."""
    return initialize_distributed(
        getattr(args, "coordinator", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None),
    )
