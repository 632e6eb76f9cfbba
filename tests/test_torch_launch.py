"""The port's multi-host launcher (``python -m adlb_tpu_torch.runtime.launch``):
two launcher processes on one host split the ranks of one world and run
the nq C client (``examples/nq_c.c``, built against the port's libadlb) to
its known answer, with Python servers planning in the master's launcher and
with native servers plus the planning sidecar (``--device cpu``). With a
hotspot app whose tasks all enter the master's server (in Python, and as
the C client ``tests/hotspot_go_c.c``), the clients homed at the other
server are fed only by plans, so the master's launcher must run
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
from adlb_tpu_torch.runtime.world import WorldSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no C/C++ toolchain")


def _common(rdv, server_impl, nranks=6, types="1", nservers=2):
    return ["--rendezvous", rdv, "--nranks", str(nranks), "--nservers",
            str(nservers), "--types", types, "--server-impl", server_impl,
            "--balancer",
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


#: a Python app for the launchers: rank 0 puts HOT_NTASKS tokens at its
#: home server, every other rank consumes them with HOT_WORK_US of sleep
#: each. Only a plan can feed a rank homed at the other server, so the
#: ranks that share rank 0's home wait for a GO unit, which each other rank
#: puts to them once it has been fed: the tokens stay queued until the
#: planner has solved, however fast the world runs
HOT_APP = """
import os, struct, sys, time
sys.path.insert(0, {root!r})
from adlb_tpu_torch.api import join_world
from adlb_tpu_torch.types import ADLB_SUCCESS

T, GO = 1, 2
with join_world(types=[T, GO]) as ctx:
    w = ctx.world
    local = [r for r in range(1, w.nranks)
             if w.is_app(r) and w.home_server(r) == w.home_server(0)]
    done = 0
    if ctx.rank == 0:
        for i in range(int(os.environ["HOT_NTASKS"])):
            assert ctx.put(struct.pack("<q", i), T) == ADLB_SUCCESS
    else:
        if ctx.rank in local:
            rc, r = ctx.reserve([GO])
            if rc == ADLB_SUCCESS:
                ctx.get_reserved(r.handle)
        while True:
            rc, r = ctx.reserve([T])
            if rc != ADLB_SUCCESS:
                break
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                break
            if done == 0 and ctx.rank not in local:
                for q in local:
                    ctx.put(b"go", GO, target_rank=q)
            done += 1
            time.sleep(1e-6 * int(os.environ["HOT_WORK_US"]))
    sys.stdout.write("HOT done={{}}\\n".format(done))
"""


#: a C client with HOT_APP's gate (its GO units are type 2)
HOT_GO_C = os.path.join(ROOT, "tests", "hotspot_go_c.c")


def _two_launchers(tmp_path, server_impl, example, env):
    """Run the world split over two launchers; returns their (stdout,
    stderr) pairs, the master's launcher first. ``example`` is a C client
    of ``examples/``, ``HOT_GO_C`` or ``HOT_APP``."""
    types = "1,2" if example in (HOT_APP, HOT_GO_C) else "1"
    if example == HOT_APP:
        app = tmp_path / "hot.py"
        app.write_text(HOT_APP.format(root=ROOT))
        prog = [sys.executable, str(app)]
    else:
        prog = [build_example(os.path.join(ROOT, "examples", example))]
    rdv = str(tmp_path / "world")
    launch = [sys.executable, "-m", "adlb_tpu_torch.runtime.launch"]
    common = _common(rdv, server_impl, types=types)
    # "host A": apps 0,1 + the master server 4; "host B": apps 2,3 + 5
    procs = [subprocess.Popen(launch + common + ["--ranks", ranks] + prog,
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
    # 400 tasks of 2 ms at rank 0's server: the ranks homed on the other
    # server are fed by plans, and the consumer that shares rank 0's home
    # starts only once one of them has been fed (HOT_APP)
    outs, counts = _two_launchers(
        tmp_path, server_impl, HOT_APP,
        _env(HOT_NTASKS="400", HOT_WORK_US="2000"))
    done = [int(n) for out, _ in outs
            for n in re.findall(r"HOT done=(\d+)", out)]
    assert len(done) == 4 and sum(done) == 400
    assert counts["device_solves"] > 0


@pytest.mark.parametrize("server_impl", ["python", "native"])
def test_two_launchers_plan_for_c_clients(tmp_path, server_impl):
    """The same world with C clients through the port's libadlb
    (``tests/hotspot_go_c.c``, ``HOT_APP``'s gate): the master's launcher
    (its Python master, or its sidecar for the native servers) makes
    device solves that feed the C clients."""
    world = WorldSpec(nranks=6, nservers=2, types=(1, 2))
    gated = [r for r in range(1, 4)
             if world.home_server(r) == world.home_server(0)]
    outs, counts = _two_launchers(
        tmp_path, server_impl, HOT_GO_C,
        _env(ADLB_HOT_NTASKS="400", ADLB_HOT_WORK_US="2000",
             ADLB_HOT_GATED=",".join(map(str, gated))))
    done = [int(n) for out, _ in outs
            for n in re.findall(r"HOT done=(\d+)", out)]
    assert gated and len(done) == 4 and sum(done) == 400
    assert counts["device_solves"] > 0


#: a Python app for the launchers' failover world: rank 0 puts 300 units,
#: every rank consumes them, 10 ms each
COVERAGE_APP = """
import struct, sys, time
sys.path.insert(0, {root!r})
from adlb_tpu_torch.api import join_world
from adlb_tpu_torch.types import ADLB_SUCCESS

with join_world(types=[1]) as ctx:
    if ctx.rank == 0:
        for i in range(300):
            ctx.put(struct.pack("<q", i), 1)
    got = []
    while True:
        rc, w = ctx.get_work([1])
        if rc != ADLB_SUCCESS:
            break
        got.append(struct.unpack("<q", w.payload)[0])
        time.sleep(0.01)
    sys.stdout.write("APP {{}} GOT {{!r}}\\n".format(ctx.rank, got))
"""


def test_two_launchers_survive_a_master_disconnect(tmp_path):
    """Two launchers, Python servers planning with the host threshold 0,
    ``--on-server-failure failover``, and the master (in the first
    launcher) disconnected at its 40th outbound frame by the fault spec:
    both launchers exit 0, the deputy (in the other launcher) plans the
    rest, and every unit is consumed. The master's rings to its same-host
    peers used to be released under its reactor's submit batch, and its
    launcher failed with the ring's ValueError."""
    app = tmp_path / "app.py"
    app.write_text(COVERAGE_APP.format(root=ROOT))
    rdv = str(tmp_path / "world")
    common = (_common(rdv, "python", nranks=7, nservers=3)
              + ["--on-server-failure", "failover", "--fault-spec",
                 json.dumps({"seed": 5, "disconnect_server_at": {"0": 40}})])
    launch = [sys.executable, "-m", "adlb_tpu_torch.runtime.launch"]
    # "host A": apps 0,1 + the master 4; "host B": apps 2,3 + 5 (the
    # deputy) and 6
    procs = [subprocess.Popen(launch + common + ["--ranks", ranks,
                                                 sys.executable, str(app)],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for ranks in ("0,1,4", "2,3,5,6")]
    outs = [p.communicate(timeout=150) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
    got = [x for out, _ in outs
           for lst in re.findall(r"APP \d+ GOT (\[[^\]]*\])", out)
           for x in json.loads(lst)]
    assert sorted(set(got)) == list(range(300))
    deputy = _planner(outs[1][1])
    assert deputy is not None and deputy["host_solves"] == 0


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
