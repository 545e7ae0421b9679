"""The one module that knows which platform the program runs on.

It names the platform, picks the default dense path for a corpus, decides
whether Pallas kernels run in interpret mode, and places the persistent
compile cache. Every other module asks here instead of reading
``jax.default_backend()`` itself.

- ``"cpu"``: tests and small hosts. The dense arm defaults to the exact
  XLA scan; an explicitly requested kernel runs in interpret mode.
- ``"gpu"``: an NVIDIA card. From ``AUTO_PRUNE_DOCS`` docs up the dense arm
  is the int8 candidate pass (the Hopper kernel) plus exact rescore, below
  it the exact XLA scan. Kernels always compile; one that fails raises.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

PLATFORMS = ("cpu", "gpu")
#: Dense-arm implementations a caller may request.
KERNELS = ("xla", "int8")
#: Used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a fixed path inside the
#: checkout, so repeated runs from one checkout hit the same cache.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def name(platform: Optional[str] = None) -> str:
    """The platform: ``platform`` if given, else JAX's default backend.
    Raises ValueError for any platform this program does not run on."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise ValueError(
            f"unsupported platform {platform!r}: this program runs on "
            f"{' or '.join(PLATFORMS)}"
        )
    return platform


def default_kernel(n_docs: int, platform: Optional[str] = None) -> str:
    """The dense path served for an ``n_docs`` corpus on ``platform``."""
    from openintel_tpu.models.retrievers import AUTO_PRUNE_DOCS

    if name(platform) == "gpu" and n_docs >= AUTO_PRUNE_DOCS:
        return "int8"
    return "xla"


def check_kernel(kernel: Optional[str], n_docs: int) -> str:
    """Resolve a requested dense path (None = the platform default);
    raises ValueError for a name that is not one of ``KERNELS``."""
    if kernel is None:
        return default_kernel(n_docs)
    if kernel not in KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r} (expected {' | '.join(KERNELS)})"
        )
    return kernel


def interpret(platform: Optional[str] = None) -> bool:
    """Whether Pallas kernels run in interpret mode: only on the CPU."""
    return name(platform) == "cpu"


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The cache directory to set in code: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself), else the
    fixed ``DEFAULT_CACHE_DIR``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compile cache for this process, caching
    every compiled program whatever its size or compile time."""
    import jax

    path = compile_cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
