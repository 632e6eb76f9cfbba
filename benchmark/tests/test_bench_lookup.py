"""A cell's runner is found by its configuration's kind and a planner cell's
traffic generator by its traffic file's name, each as a file of the
harness: a new kind or a new generator is taken up as files alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import common, planner_cell
from benchmark.churn import Churn
from benchmark.run import cell_module
from benchmark.tests.test_bench_faults import SMALL_PLANNER

ROOT = Path(__file__).resolve().parents[2]


def test_planner_kind_is_planner_cell():
    assert cell_module("planner") is planner_cell


@pytest.mark.parametrize("kind, message", [
    ("nosuch", "benchmark/nosuch_cell.py: no such file"),
    ("../planner", "benchmark/../planner_cell.py: "),
    ("Planner", "benchmark/Planner_cell.py: "),
    ("plan ner", "benchmark/plan ner_cell.py: "),
])
def test_unknown_or_malformed_kind_names_the_file(kind, message):
    with pytest.raises((FileNotFoundError, ValueError), match=message):
        cell_module(kind)


def test_traffic_without_generator_gets_churn():
    traffic = common.traffic_file("churn")
    assert "generator" not in traffic
    assert planner_cell.generator(traffic) is Churn


@pytest.mark.parametrize("name, message", [
    ("nosuch", "benchmark/nosuch.py: no such file"),
    ("churn.py", "benchmark/churn.py.py: "),
    ("/etc/passwd", "benchmark//etc/passwd.py: "),
])
def test_unknown_generator_names_the_file(name, message):
    with pytest.raises((FileNotFoundError, ValueError), match=message):
        planner_cell.generator({"generator": name})


SPY_GENERATOR = '''
from benchmark.churn import Churn

BURSTS = [0]


class Generator(Churn):
    def bursts(self):
        BURSTS[0] += 1
        super().bursts()
'''

ECHO_CELL = '''
"""A cell kind of one test: answers its seed back."""


def run(conf, traffic, seed, seconds, trace, t_process, device="cuda",
        log=print):
    answers = [seed + i for i in range(traffic["answers"])]
    return {"setup_s": 0.5, "memory_peak_bytes": 0, "trace": None,
            "answers": answers, "seed": seed}


def compared(run):
    wrong = sum(a != run["seed"] + i for i, a in enumerate(run["answers"]))
    return {"answers_wrong": (wrong, 0, "<=")}


def end_to_end(run):
    return {"answers_per_s": float(len(run["answers"]))}


def counts(run):
    return len(run["answers"]), 0


def summary(run):
    return f"{len(run['answers'])} answers"
'''

PROBE = '''
import json, sys, time
from benchmark.run import run_cell
import benchmark
small = json.loads(sys.argv[1])
spy = run_cell("planner131k.spy", 2**31 + 3, 1.0, False, device="cpu",
               t_process=time.perf_counter(), conf_patch=small)
echo = run_cell("echo.one", 2**33 + 1, 1.0, False, device="cpu",
                t_process=time.perf_counter())
print(json.dumps({
    "package": benchmark.__file__,
    "spy_bursts": sys.modules["benchmark.spy_churn"].BURSTS[0],
    "spy_rounds": spy["attempted"], "spy_correct": spy["correct"],
    "echo_correct": echo["correct"], "echo_attempted": echo["attempted"],
    "echo_metrics": echo["metrics"], "echo_summary": echo["summary"]}))
'''


def test_new_kind_and_new_generator_taken_up_as_files(tmp_path):
    """A copy of the harness gets a new generator (a churn that counts its
    bursts) and a new kind of cell, as files and entries alone, and a run
    of each cell uses them."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "spy_churn.py").write_text(SPY_GENERATOR)
    spy = {**common.traffic_file("churn"), "generator": "spy_churn"}
    (bench / "traffic" / "spy.json").write_text(json.dumps(spy))
    (bench / "echo_cell.py").write_text(ECHO_CELL)
    (bench / "configs" / "echo.json").write_text(json.dumps(
        {"kind": "echo", "source": "a test"}))
    (bench / "traffic" / "echo.json").write_text(json.dumps(
        {"kind": "echo", "answers": 5}))
    manifest = common.load_manifest()
    manifest["configs"].append({"name": "echo", "source": "a test",
                                "file": "benchmark/configs/echo.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"] += [
        {"name": "planner131k.spy", "config": "planner-131k",
         "traffic": "spy", "chips": 1, "why": "a test"},
        {"name": "echo.one", "config": "echo", "traffic": "echo",
         "chips": 1, "why": "a test"}]
    manifest["end_to_end"].append({"name": "answers_per_s", "unit": "1/s",
                                   "better": "higher", "bound": 0.1,
                                   "source": "host_clock",
                                   "workloads": ["echo.one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    # the copy's harness first; the program from this checkout
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run(
        [sys.executable, "-c", PROBE, json.dumps(SMALL_PLANNER)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-4000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["package"].startswith(str(tmp_path))
    assert got["spy_correct"] and got["spy_rounds"] > 0
    # the warm-up's rounds and the window's, all through the new generator
    assert got["spy_bursts"] == got["spy_rounds"] + spy["warm_rounds"]
    assert got["echo_correct"] and got["echo_attempted"] == 5
    assert got["echo_metrics"] == {
        "answers_per_s": {"value": 5.0, "unit": "1/s"},
        "setup_s": {"value": 0.5, "unit": "s"}}
    assert got["echo_summary"] == "5 answers"
