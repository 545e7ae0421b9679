"""The platform module: the one owner of platform name, default dense path,
interpret mode and compile-cache placement; removed kernel names are
refused at every entry point; chip_smoke.py refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from openintel_tpu import platform
from openintel_tpu.index.build import build_postings_index
from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_token_corpus
from openintel_tpu.models.retrievers import (
    AUTO_PRUNE_DOCS,
    DenseRetriever,
    HybridRetriever,
)
from openintel_tpu.parallel.retriever import ShardedHybridRetriever

REPO = Path(__file__).resolve().parent.parent
REMOVED_KERNELS = ("pallas", "fast", "pallas_fast", "int4")


@pytest.mark.parametrize(
    "plat, n_docs, want",
    [
        ("cpu", 10, "xla"),
        ("cpu", 10 * AUTO_PRUNE_DOCS, "xla"),
        ("gpu", AUTO_PRUNE_DOCS - 1, "xla"),
        ("gpu", AUTO_PRUNE_DOCS, "int8"),
        ("gpu", 10_000_000, "int8"),
    ],
)
def test_default_kernel_table(plat, n_docs, want):
    assert platform.default_kernel(n_docs, plat) == want


@pytest.mark.parametrize("plat, want", [("cpu", True), ("gpu", False)])
def test_interpret_only_on_cpu(plat, want):
    assert platform.interpret(plat) is want


@pytest.mark.parametrize("plat", ["tpu", "rocm", "METAL"])
def test_other_platforms_raise_naming_the_platform(plat):
    for fn in (platform.name, platform.interpret):
        with pytest.raises(ValueError, match=plat):
            fn(plat)
    with pytest.raises(ValueError, match=plat):
        platform.default_kernel(AUTO_PRUNE_DOCS, plat)


def test_name_reads_the_backend():
    assert platform.name() == "cpu"  # conftest pins the CPU


def test_compile_cache_dir_honours_the_environment():
    assert platform.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_compile_cache_dir_defaults_inside_the_checkout():
    got = platform.compile_cache_dir({})
    assert got == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.fixture(scope="module")
def small_index():
    docs = synthetic_token_corpus(64, vocab_size=50, seed=1)
    return (
        build_postings_index(docs),
        DenseIndex.from_embeddings(synthetic_embeddings(64, dim=16, seed=2)),
    )


@pytest.mark.parametrize("kernel", REMOVED_KERNELS)
@pytest.mark.parametrize("which", ["dense", "hybrid", "sharded"])
def test_constructors_refuse_removed_kernels(small_index, kernel, which):
    postings, dense = small_index
    with pytest.raises(ValueError, match="unknown kernel"):
        if which == "dense":
            DenseRetriever(dense, kernel=kernel)
        elif which == "hybrid":
            HybridRetriever(postings, dense, kernel=kernel)
        else:
            ShardedHybridRetriever(postings, dense, data=1, corpus=4, kernel=kernel)


@pytest.mark.parametrize(
    "argv",
    [
        ["search", "q", "--index", "idx", "--kernel", "int4"],
        ["search", "q", "--index", "idx", "--kernel", "pallas"],
        ["search", "q", "--index", "idx", "--kernel", "fast"],
        ["evaluate", "corpus.txt", "--kernel", "int4"],
        ["mcp", "--index", "idx", "--kernel", "pallas"],
    ],
)
def test_cli_refuses_removed_kernels(argv, capsys):
    from openintel_tpu.cli.main import main

    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_mcp_refuses_removed_kernels(tmp_path, capsys):
    from openintel_tpu.cli.main import main
    from openintel_tpu.mcp.server import build_server

    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(synthetic_token_corpus(40, seed=3)) + "\n")
    assert main(["index", str(corpus), "--out", str(tmp_path / "idx"),
                 "--dim", "16"]) == 0
    capsys.readouterr()
    for kernel in REMOVED_KERNELS:
        with pytest.raises(ValueError, match="unknown kernel"):
            build_server(offline=True, index=str(tmp_path / "idx"), kernel=kernel)
    server = build_server(offline=True, index=str(tmp_path / "idx"), kernel="int8")
    assert server.retriever.kernel == "int8"


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_chip_smoke_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert np.all([not line.startswith("{") for line in res.stdout.splitlines()])
