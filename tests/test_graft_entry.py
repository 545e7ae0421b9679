"""The entry points: entry() jits the served single-device step through the
served dense dispatch; dryrun_multichip() owns its (virtual CPU) platform."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def test_entry_compiles_and_runs_production_kernels():
    fn, args = graft.entry()
    vals, ids = jax.jit(fn)(*args)
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert vals.shape == ids.shape == (16, 10)
    assert ids.max() < 4096
    # real rankings: at least the top slot of every query is a valid doc
    assert (ids[:, 0] >= 0).all()


def test_entry_runs_the_served_dense_dispatch():
    """entry() fuses the int8 candidate pass + rescore (the served
    dense_arm_topk) with BM25: its rankings agree with the exact RRF
    oracle over the same plan and stored rows."""
    from openintel_tpu.ops import reference as ref

    fn, args = graft.entry()
    _, ids = jax.jit(fn)(*args)
    index, emb, queries, plan = graft._example_problem()
    rng = np.random.default_rng(3)
    term_ids = [list(rng.integers(1, 2001, size=4)) for _ in range(16)]
    hits = total = 0
    for i in range(16):
        _, bm = ref.bm25_topk(index, term_ids[i], 20)
        _, dn = ref.cosine_topk(np.asarray(emb), np.asarray(queries)[i], 20)
        _, want = ref.rrf_fuse([bm, dn], 10)
        want = {int(d) for d in want if d >= 0}
        hits += len(want & {int(d) for d in np.asarray(ids)[i]})
        total += len(want)
    assert hits / total >= 0.95


def test_dryrun_multichip_in_process():
    # conftest pinned cpu + 8 virtual devices -> the in-process path
    graft.dryrun_multichip(8)


def test_dryrun_multichip_reexecs_when_backends_are_wrong():
    """Simulate the driver: backends initialized with too few devices before
    the dryrun is requested — must re-exec a child and still pass."""
    repo = Path(__file__).resolve().parent.parent
    code = (
        "import os;"
        "os.environ['JAX_PLATFORMS']='cpu';"
        "os.environ.pop('XLA_FLAGS', None);"
        "import jax;"
        # jax.config overrides the env var once jax is imported: pin both
        "jax.config.update('jax_platforms', 'cpu');"
        "assert len(jax.devices()) == 1;"  # backends now live, 1 device
        f"import sys; sys.path.insert(0, {str(repo)!r});"
        "import __graft_entry__ as g;"
        "g.dryrun_multichip(8);"
        "print('REEXEC_OK')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=repo,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "REEXEC_OK" in res.stdout
    assert "dryrun_multichip OK" in res.stdout
