"""``BENCHMARK.json`` parses, keeps to the rules of its format, and names
only files that are there; the result line has exactly its keys."""

import json
import re
from pathlib import Path

import pytest

from benchmark import common

ROOT = Path(__file__).resolve().parents[2]
M = common.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(json.dumps(M)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32
    assert all(line_ok(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in M["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"]), w
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = set()
    four = 0
    configs = {c["name"] for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert four <= max(1, len(M["workloads"]) // 4)


def metric_names():
    return [m["name"] for m in M["end_to_end"] + M["per_layer"]]


def test_metric_names_and_units():
    names = metric_names() + [w["name"] for w in M["workloads"]] + [
        c["name"] for c in M["configs"]]
    assert len(names) == len(set(names))
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_end_to_end():
    assert 1 <= len(M["end_to_end"]) <= 16
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert "p95" not in m["name"] and "p99" not in m["name"]
    cells = {w["name"] for w in M["workloads"]}
    for w in cells:
        got = [m["name"] for m in common.cell_metrics(M, w, "end_to_end")]
        assert "setup_s" in got and len(got) >= 2, w


def test_per_layer():
    assert 1 <= len(M["per_layer"]) <= 128
    e2e = {m["name"]: m for m in M["end_to_end"]}
    perf = (ROOT / "PERF.md").read_text()
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"]) and f"| {m['layer']} |" in perf
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for w in M["workloads"]:
        assert common.cell_metrics(M, w["name"], "per_layer"), w["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_finds_its_files(cell):
    w, entry = common.find_cell(M, cell)
    conf = common.config_file(entry)
    traffic = common.traffic_file(w["traffic"])
    assert conf["kind"] == traffic["kind"]
    for m in common.cell_metrics(M, cell, "per_layer"):
        assert callable(common.metric_reader(m["name"]))


def test_every_file_is_named_from_a_name():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert PATH.match(str(p.relative_to(ROOT))), p


def test_result_line_keys():
    line = common.result_line(True, 3, 0, {"x": {"value": 1.0, "unit": "s"}},
                              {"platform": "gpu", "kind": "k", "count": 1,
                               "memory_peak_bytes": 1},
                              {"a": {"value": 0, "limit": 0, "rule": "<="}})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    line = common.result_line(False, 3, 1, {}, {}, {}, {"device_ops": [],
                                                        "idle_gaps": []})
    assert list(json.loads(line)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "breakdown",
                                      "compared"]


def test_no_card_no_result(monkeypatch, capsys):
    """The command line measures the card only: without one it exits with
    another code than 0 and prints no result, never falling back to the
    CPU."""
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", M["workloads"][0]["name"], "--seed",
                   str(2**31 + 7), "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
