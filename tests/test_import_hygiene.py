"""Library import must never initialize a jax backend: a module-level
device value (e.g. ``jnp.float32(...)``) would start the device runtime at
import time — before argparse even runs in the CLI, and in every worker
process that only imports (see the NEG_INF comments in ops/)."""

import subprocess
import sys


def test_full_import_initializes_no_backend():
    code = (
        "import openintel_tpu.cli.main, openintel_tpu.models.retrievers,"
        "openintel_tpu.parallel.retriever, openintel_tpu.serving,"
        "openintel_tpu.mcp.server, openintel_tpu.models.eval,"
        "openintel_tpu.index.pipeline, openintel_tpu.models.train;"
        "from jax._src import xla_bridge as xb;"
        "fn = getattr(xb, 'backends_are_initialized', None);"
        "live = bool(fn()) if fn else bool(getattr(xb, '_backends', {}));"
        "import sys; sys.exit(2 if live else 0)"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, (
        f"rc={res.returncode}: a module initialized jax backends at import "
        f"time\n{res.stderr[-1000:]}"
    )
