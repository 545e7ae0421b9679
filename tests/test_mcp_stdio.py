"""Real-transport MCP test: spawn the server as a subprocess and speak
JSON-RPC over its stdio — the driving-adapter integration the reference
exercises through rmcp (src/mcp/server.rs:171-192)."""

import json
import os
import subprocess
import sys

# Hermetic: child servers run on host CPU (conftest pinned JAX_PLATFORMS).
_ENV = dict(os.environ)


def test_mcp_stdio_roundtrip():
    lines = "\n".join(
        [
            json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}}
            ),
            json.dumps({"jsonrpc": "2.0", "id": 2, "method": "tools/list"}),
            json.dumps(
                {
                    "jsonrpc": "2.0",
                    "id": 3,
                    "method": "tools/call",
                    "params": {
                        "name": "analyze_ticker",
                        "arguments": {"ticker": "AAPL"},
                    },
                }
            ),
            json.dumps({"jsonrpc": "2.0", "id": 4}),  # invalid: no method
        ]
    )
    proc = subprocess.run(
        [sys.executable, "-m", "openintel_tpu.cli.main", "mcp", "--offline"],
        input=lines + "\n",
        capture_output=True,
        text=True,
        timeout=110,
        env=_ENV,
    )
    responses = {
        d["id"]: d for d in map(json.loads, proc.stdout.strip().splitlines())
    }
    assert responses[1]["result"]["serverInfo"]["name"] == "openintel-tpu"
    names = [t["name"] for t in responses[2]["result"]["tools"]]
    assert names[:2] == ["list_sources", "analyze_ticker"] and len(names) == 6
    body = json.loads(responses[3]["result"]["content"][0]["text"])
    assert body["report"]["fusion"]["alignment"] == "confirming_bullish"
    assert responses[4]["error"]["code"] == -32600


def _read_responses(proc, want_ids, timeout_lines=200):
    """Collect responses by id (concurrent dispatch replies out of order)."""
    got = {}
    want = set(want_ids)
    for _ in range(timeout_lines):
        line = proc.stdout.readline()
        if not line:
            break
        d = json.loads(line)
        if d.get("id") in want:
            got[d["id"]] = d
            want.discard(d["id"])
        if not want:
            break
    assert not want, f"missing responses for ids {want}"
    return got


def test_mcp_concurrent_search_coalesces(tmp_path):
    """N concurrent search_corpus calls through the REAL stdio loop must
    fuse into fewer device batches than requests (serving.BatchCoalescer
    wired at the composition root; concurrent per-message dispatch)."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(
        "\n".join(
            f"document {i} about topic{i % 7} and theme{i % 5}"
            for i in range(40)
        )
        + "\n"
    )
    idx = tmp_path / "idx"
    build = subprocess.run(
        [
            sys.executable, "-m", "openintel_tpu.cli.main",
            "index", str(corpus), "--out", str(idx), "--dim", "32",
        ],
        capture_output=True, text=True, timeout=300, env=_ENV,
    )
    assert build.returncode == 0, build.stderr

    proc = subprocess.Popen(
        [
            sys.executable, "-m", "openintel_tpu.cli.main",
            "mcp", "--offline", "--index", str(idx),
        ],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_ENV,
    )
    try:
        proc.stdin.write(
            json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}}
            )
            + "\n"
        )
        proc.stdin.flush()
        _read_responses(proc, [1])

        n_req = 6
        reqs = [
            json.dumps(
                {
                    "jsonrpc": "2.0",
                    "id": 10 + i,
                    "method": "tools/call",
                    "params": {
                        "name": "search_corpus",
                        "arguments": {
                            "queries": [f"topic{i % 7}", f"theme{i % 5}"],
                            "k": 3,
                        },
                    },
                }
            )
            for i in range(n_req)
        ]
        proc.stdin.write("\n".join(reqs) + "\n")
        proc.stdin.flush()
        resps = _read_responses(proc, [10 + i for i in range(n_req)])
        for i in range(n_req):
            body = json.loads(resps[10 + i]["result"]["content"][0]["text"])
            assert not resps[10 + i]["result"].get("isError")
            assert len(body["results"]) == 2
            assert body["results"][0]["hits"], body

        proc.stdin.write(
            json.dumps(
                {
                    "jsonrpc": "2.0",
                    "id": 99,
                    "method": "tools/call",
                    "params": {"name": "server_stats", "arguments": {}},
                }
            )
            + "\n"
        )
        proc.stdin.flush()
        stats_resp = _read_responses(proc, [99])[99]
        stats = json.loads(stats_resp["result"]["content"][0]["text"])
        co = stats["coalescer"]
        assert co["queries_run"] == 2 * n_req
        # the whole point: far fewer fused device batches than requests
        assert co["batches_run"] < n_req, co
        assert stats["retriever"] == "HybridRetriever"
    finally:
        proc.stdin.close()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_mcp_non_object_messages_get_error_responses():
    """Valid-JSON non-object lines (a bare number, an array) must produce
    -32600 errors, not silently-dead dispatch tasks (round-3 review)."""
    lines = "\n".join(
        [
            json.dumps({"jsonrpc": "2.0", "id": 1, "method": "ping"}),
            "5",
            "[{}]",
            json.dumps({"jsonrpc": "2.0", "id": 2, "method": "ping"}),
        ]
    )
    proc = subprocess.run(
        [sys.executable, "-m", "openintel_tpu.cli.main", "mcp", "--offline"],
        input=lines + "\n",
        capture_output=True,
        text=True,
        timeout=110,
        env=_ENV,
    )
    docs = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    by_id = {d.get("id"): d for d in docs if d.get("id") is not None}
    assert by_id[1]["result"] == {} and by_id[2]["result"] == {}
    errs = [d for d in docs if d.get("id") is None and "error" in d]
    assert len(errs) == 2
    assert all(e["error"]["code"] == -32600 for e in errs)


import pytest


@pytest.mark.parametrize(
    "mesh_flags",
    [[], ["--mesh", "2x4"]],
    ids=["single-chip", "sharded-mesh"],
)
def test_mcp_updatable_lifecycle(tmp_path, mesh_flags):
    """--updatable end to end through the REAL stdio server: tools/list
    grows the update tools; index_documents makes docs searchable
    immediately (with snippets); delete_documents tombstones them;
    server_stats reports the segment state. Runs twice: the single-chip
    live corpus and the sharded one (--mesh 2x4 composes with
    --updatable: parallel/updatable.py serves the main segment over the
    virtual 8-device mesh with the identical lifecycle)."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(
        "\n".join(f"document {i} about topic{i % 7}" for i in range(30)) + "\n"
    )
    idx = tmp_path / "idx"
    build = subprocess.run(
        [
            sys.executable, "-m", "openintel_tpu.cli.main",
            "index", str(corpus), "--out", str(idx), "--dim", "32",
        ],
        capture_output=True, text=True, timeout=300, env=_ENV,
    )
    assert build.returncode == 0, build.stderr

    proc = subprocess.Popen(
        [
            sys.executable, "-m", "openintel_tpu.cli.main",
            "mcp", "--offline", "--index", str(idx), "--updatable",
            *mesh_flags,
        ],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_ENV,
    )

    def call(rid, name, arguments):
        proc.stdin.write(json.dumps({
            "jsonrpc": "2.0", "id": rid, "method": "tools/call",
            "params": {"name": name, "arguments": arguments},
        }) + "\n")
        proc.stdin.flush()
        resp = _read_responses(proc, [rid])[rid]
        assert not resp["result"].get("isError"), resp
        return json.loads(resp["result"]["content"][0]["text"])

    try:
        proc.stdin.write(json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}}
        ) + "\n")
        proc.stdin.write(json.dumps(
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list"}
        ) + "\n")
        proc.stdin.flush()
        resps = _read_responses(proc, [1, 2])
        names = [t["name"] for t in resps[2]["result"]["tools"]]
        assert "index_documents" in names and "delete_documents" in names

        out = call(3, "index_documents", {
            "texts": ["breaking story about zebrafish genomes",
                      "zebrafish genome follow-up analysis"],
        })
        new_ids = out["ids"]
        assert new_ids == [30, 31] and out["stats"]["n_delta"] == 2

        found = call(4, "search_corpus", {"queries": ["zebrafish genomes"], "k": 3})
        hits = found["results"][0]["hits"]
        assert {h["doc_id"] for h in hits} & set(new_ids)
        assert any("zebrafish" in h.get("text", "") for h in hits)

        call(5, "delete_documents", {"ids": [new_ids[0]]})
        after = call(6, "search_corpus", {"queries": ["zebrafish genomes"], "k": 3})
        ids_after = {h["doc_id"] for h in after["results"][0]["hits"]}
        assert new_ids[0] not in ids_after and new_ids[1] in ids_after

        stats = call(7, "server_stats", {})
        assert stats["updatable"]["n_deleted"] == 1
        assert stats["updatable"]["n_delta"] == 2

        # compact (renumbers: one deleted doc) + persist to the --index
        # prefix, then verify the survivor is searchable at its NEW id
        # with the right snippet
        out = call(8, "compact_corpus", {"save": True})
        assert out["ids_renumbered"] and out["n_docs"] == 31
        assert out["saved_to"] == str(idx)
        after2 = call(9, "search_corpus", {"queries": ["zebrafish genomes"], "k": 2})
        hit = after2["results"][0]["hits"][0]
        assert hit["doc_id"] == 30  # 31 renumbered down past deleted 30
        assert "follow-up" in hit["text"]
        stats2 = call(10, "server_stats", {})
        assert stats2["updatable"] == {
            "n_main": 31, "n_delta": 0, "n_deleted": 0, "n_alive": 31,
        }
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)

    # the saved compacted index serves cold through a plain (non-updatable)
    # server — persistence survives restarts
    check = subprocess.run(
        [
            sys.executable, "-m", "openintel_tpu.cli.main",
            "search", "zebrafish", "--index", str(idx), "-k", "1",
            "--format", "json",
        ],
        capture_output=True, text=True, timeout=120, env=_ENV,
    )
    assert check.returncode == 0, check.stderr
    hit = json.loads(check.stdout)[0]["hits"][0]
    assert hit["doc_id"] == 30 and "zebrafish" in hit["text"]
