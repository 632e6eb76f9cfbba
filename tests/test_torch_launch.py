"""The port's multi-host launcher (``python -m adlb_tpu_torch.runtime.launch``):
two launcher processes on one host split the ranks of one world and run
the nq C client (``examples/nq_c.c``, built against the port's libadlb) to
its known answer, with Python servers planning in the master's launcher and
with native servers plus the planning sidecar (``--device cpu``). With the
hotspot C client, whose tasks all enter the master's server, the other
launcher's clients are fed only by plans, so the master's launcher must run
device-route solves. A launcher whose sidecar fails exits non-zero."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu_torch.native.capi import build_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no C/C++ toolchain")


def _common(rdv, server_impl, nranks=6):
    return ["--rendezvous", rdv, "--nranks", str(nranks), "--nservers", "2",
            "--types", "1", "--server-impl", server_impl, "--balancer",
            "tpu", "--device", "cpu", "--solver-host-threshold", "0",
            "--timeout", "60"]


def _env(**kw):
    # puts stay at each client's home server, so the other server's
    # clients are fed by the planner's matches
    env = dict(os.environ, PYTHONPATH=ROOT, ADLB_NQ_N="9",
               ADLB_NQ_CUTOFF="3", ADLB_PUT_ROUTING="home", **kw)
    env.pop("ADLB_FABRIC", None)
    return env


def _solutions(*outs):
    return sum(int(n) for out in outs
               for n in re.findall(r"solutions=(\d+)", out))


def _planner(err):
    found = re.findall(r"\[adlb_launch\] planner (\{.*\})", err)
    return json.loads(found[-1]) if found else None


def _two_launchers(tmp_path, server_impl, example, env):
    """Run the world split over two launchers; returns their (stdout,
    stderr) pairs, the master's launcher first."""
    exe = build_example(os.path.join(ROOT, "examples", example))
    rdv = str(tmp_path / "world")
    launch = [sys.executable, "-m", "adlb_tpu_torch.runtime.launch"]
    common = _common(rdv, server_impl)
    # "host A": apps 0,1 + the master server 4; "host B": apps 2,3 + 5
    procs = [subprocess.Popen(launch + common + ["--ranks", ranks, exe],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for ranks in ("0,1,4", "2,3,5")]
    outs = [p.communicate(timeout=150) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
    counts = _planner(outs[0][1])  # the master's launcher planned
    assert counts is not None and _planner(outs[1][1]) is None
    assert counts["host_solves"] == 0
    return outs, counts


@pytest.mark.parametrize("server_impl", ["python", "native"])
def test_two_launchers_reach_nq_known_answer(tmp_path, server_impl):
    outs, _ = _two_launchers(tmp_path, server_impl, "nq_c.c", _env())
    assert _solutions(outs[0][0], outs[1][0]) == 352  # n-queens(9)


@pytest.mark.parametrize("server_impl", ["python", "native"])
def test_two_launchers_plan_on_the_device(tmp_path, server_impl):
    # 400 tasks of 2 ms at rank 0's server: its one consumer there needs
    # 0.8 s alone, so ranks 1 and 3 (homed on the other launcher's
    # server) are fed by plans long before the work runs out
    outs, counts = _two_launchers(
        tmp_path, server_impl, "hotspot_c.c",
        _env(ADLB_HOT_NTASKS="400", ADLB_HOT_WORK_US="2000"))
    done = [int(n) for out, _ in outs
            for n in re.findall(r"HOT done=(\d+)", out)]
    assert len(done) == 4 and sum(done) == 400
    assert counts["device_solves"] > 0


def test_launcher_exits_nonzero_when_its_sidecar_fails(tmp_path):
    exe = build_example(os.path.join(ROOT, "examples", "nq_c.c"))
    rdv = str(tmp_path / "world")
    code = (
        "import sys\n"
        "from adlb_tpu_torch.balancer import engine\n"
        "def broken(self, snapshots, world):\n"
        "    raise RuntimeError('injected planning failure')\n"
        "engine.PlanEngine.round = broken\n"
        "from adlb_tpu_torch.runtime import launch\n"
        "sys.exit(launch.main(sys.argv[1:]))\n")
    p = subprocess.run(
        [sys.executable, "-c", code] + _common(rdv, "native")
        + ["--ranks", "0-5", exe],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=150)
    assert p.returncode != 0, p.stdout + p.stderr
    assert "balancer sidecar failed" in p.stderr
    assert "injected planning failure" in p.stderr
    assert _planner(p.stderr)["host_solves"] == 0


def test_launcher_reports_whichever_server_planned():
    """A launcher prints one planner line for each planner it ran: its
    sidecar, and each Python server that planned (the master's, or a
    deputy's that failover promoted in a launcher that never hosted the
    master); a launcher whose servers never planned prints none."""
    from types import SimpleNamespace

    from adlb_tpu_torch.runtime.launch import planner_reports

    idle = SimpleNamespace(_solver=None, planner_report=lambda: None)
    promoted = SimpleNamespace(_solver=object(),
                               planner_report=lambda: {"device_solves": 3})
    sidecar = ("sidecar ep",
               SimpleNamespace(planner=lambda: {"device_solves": 5}))
    assert planner_reports(None, [idle, promoted]) == [{"device_solves": 3}]
    assert planner_reports(sidecar, [idle]) == [{"device_solves": 5}]
    assert planner_reports(None, [idle]) == []
