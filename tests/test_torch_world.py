"""The port's main path end to end, its isolation from JAX, and its
refusals.

* A planned-balancer world of the port beside the JAX package's world on
  the same master/worker app: each unit consumed exactly once, the same
  answers, and the port's solves on the device path.
* A port world in a fresh interpreter imports neither ``jax`` nor any
  ``adlb_tpu`` module, and no file of the port imports them.
* ``device="cuda"`` without a card raises; a failing device solve aborts
  the world instead of falling back to numpy.
* Every feature of the JAX package's ``Config`` validates in the port, and
  a planned port world runs with each one on.
"""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import adlb_tpu
import adlb_tpu_torch
from adlb_tpu.runtime.world import Config as RefConfig
from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.balancer import solve as tsolve
from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver
from adlb_tpu_torch.balancer.engine import PlanEngine
from adlb_tpu_torch.runtime.world import Config

ROOT = pathlib.Path(__file__).resolve().parent.parent
TYPES = (1, 2, 3, 4)
ANSWER = 9
NUNITS = 240


def _value(i):
    return (i * 7919) % 1000003


def _make_app(success):
    """Rank 0 puts NUNITS typed, prioritised units and sums the answers;
    workers reserve and get until the world ends, answering each unit."""

    def app(ctx):
        if ctx.rank == 0:
            for i in range(NUNITS):
                ctx.put(i.to_bytes(4, "little"), TYPES[i % 4],
                        work_prio=(i * 31) % 97)
            total = 0
            for _ in range(NUNITS):
                rc, r = ctx.reserve([ANSWER])
                assert rc == success
                rc, buf = ctx.get_reserved(r.handle)
                total += int.from_bytes(buf, "little")
            ctx.set_problem_done()
            return total
        seen = []
        while True:
            rc, r = ctx.reserve(list(TYPES))
            if rc != success:
                return seen
            rc, buf = ctx.get_reserved(r.handle)
            if rc != success:
                return seen
            i = int.from_bytes(buf, "little")
            seen.append(i)
            ctx.put(_value(i).to_bytes(8, "little"), ANSWER, target_rank=0)

    return app


def _world(pkg, cfg, napps=8, nservers=2):
    res = pkg.run_world(num_app_ranks=napps, nservers=nservers,
                        types=TYPES + (ANSWER,),
                        app_fn=_make_app(pkg.ADLB_SUCCESS), cfg=cfg,
                        timeout=90)
    assert not res.aborted
    consumed = sorted(i for r in range(1, napps) for i in res.app_results[r])
    assert consumed == list(range(NUNITS))  # each unit exactly once
    assert res.app_results[0] == sum(_value(i) for i in range(NUNITS))
    return res


def _planned(cls, **kw):
    # puts stay home, so the other server's workers are fed by the planner
    return cls(balancer="tpu", solver_host_threshold=0, put_routing="home",
               balancer_max_tasks=32, balancer_max_requesters=8, **kw)


def test_port_world_matches_reference_world():
    ref = _world(adlb_tpu, _planned(RefConfig))
    before = dict(tsolve.solve_counts)
    launches = greedy_sweep.launches
    port = _world(adlb_tpu_torch, _planned(Config, device="cpu"))
    assert port.app_results[0] == ref.app_results[0]
    assert tsolve.solve_counts["device"] > before["device"]
    assert tsolve.solve_counts["host"] == before["host"]
    assert greedy_sweep.launches == launches  # CPU tensors: plain version


def test_port_world_imports_no_jax():
    # rank 0 puts a few units at its home server; every rank consumes
    # until exhaustion. Only a plan feeds the ranks homed at the other
    # server, so the ranks that share rank 0's home start once the planner
    # has made its first device solve, not after a fixed time
    code = (
        "import sys, time\n"
        "from adlb_tpu_torch import run_world, ADLB_SUCCESS\n"
        "from adlb_tpu_torch.balancer.solve import solve_counts\n"
        "from adlb_tpu_torch.runtime.world import Config\n"
        "def app(ctx):\n"
        "    if ctx.rank == 0:\n"
        "        for i in range(20): ctx.put(b'x', 1, work_prio=i)\n"
        "    home0 = ctx.world.home_server(0)\n"
        "    if ctx.world.home_server(ctx.rank) == home0:\n"
        "        while solve_counts['device'] == 0: time.sleep(0.005)\n"
        "    while True:\n"
        "        rc, r = ctx.reserve([1])\n"
        "        if rc != ADLB_SUCCESS: return 0\n"
        "        ctx.get_reserved(r.handle)\n"
        "cfg = Config(balancer='tpu', device='cpu', solver_host_threshold=0,\n"
        "             put_routing='home')\n"
        "run_world(num_app_ranks=4, nservers=2, types=[1], app_fn=app,\n"
        "          cfg=cfg, timeout=60)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'adlb_tpu' or m.startswith('adlb_tpu.')]\n"
        "print('LEAKED', bad, 'DEVICE_SOLVES', solve_counts['device'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED [] DEVICE_SOLVES" in out.stdout, out.stdout
    assert int(out.stdout.split()[-1]) > 0, out.stdout


def test_no_port_file_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|adlb_tpu)(\.|\s|$)", re.M)
    # a path into the JAX package's native plane (its sources, or the
    # binaries built there), written with / or as a module path
    native = re.compile(r"adlb_tpu[/.]native")
    files = sorted((ROOT / "adlb_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 45
    sources = [f for f in (ROOT / "adlb_tpu_torch").rglob("*")
               if f.suffix in (".cpp", ".hpp", ".c", ".cu")]
    assert len(sources) >= 8
    for f in files + sources:
        text = f.read_text()
        assert not pat.findall(text), f
        assert not native.findall(text), f


def test_native_world_touches_nothing_of_the_jax_package():
    """A native world of the port (C++ daemons, C clients, the sidecar, the
    compiled codec and queue core) in a fresh interpreter: no file under
    ``adlb_tpu/`` is opened, loaded or executed, and neither JAX nor the
    JAX package is imported."""
    code = (
        "import builtins, ctypes, subprocess, sys\n"
        "touched = []\n"
        "_open, _popen, _cdll = builtins.open, subprocess.Popen.__init__, "
        "ctypes.CDLL.__init__\n"
        "def spy_open(f, *a, **k):\n"
        "    touched.append(str(f)); return _open(f, *a, **k)\n"
        "def spy_popen(self, args, *a, **k):\n"
        "    touched.extend(map(str, args if isinstance(args, list) "
        "else [args])); return _popen(self, args, *a, **k)\n"
        "def spy_cdll(self, name, *a, **k):\n"
        "    touched.append(str(name)); return _cdll(self, name, *a, **k)\n"
        "builtins.open, subprocess.Popen.__init__ = spy_open, spy_popen\n"
        "ctypes.CDLL.__init__ = spy_cdll\n"
        "from adlb_tpu_torch.native import ensure_built\n"
        "from adlb_tpu_torch.runtime.codec import select_codec\n"
        "from adlb_tpu_torch.runtime.world import Config\n"
        "from adlb_tpu_torch.workloads import nq_native\n"
        "assert ensure_built() is not None and select_codec('c') == 'c'\n"
        "r = nq_native.run(n=6, num_app_ranks=3, nservers=2, cfg=Config(\n"
        "    balancer='tpu', device='cpu', solver_host_threshold=0,\n"
        "    exhaust_check_interval=0.2), timeout=60)\n"
        "assert r.solutions == 4, r\n"
        "maps = _open('/proc/self/maps').read()\n"
        "bad = [t for t in touched + maps.split() if '/adlb_tpu/' in t]\n"
        "bad += [m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.')\n"
        "        or m == 'adlb_tpu' or m.startswith('adlb_tpu.')]\n"
        "print('TOUCHED', len(touched), 'BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split()[1]) > 3, out.stdout


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Config(balancer="tpu")  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsolve.AssignmentSolver(types=TYPES, max_tasks=4, max_requesters=2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        PlanEngine(types=TYPES, max_tasks=4, max_requesters=2)


def _checkpoint(prefix):
    """A port world that puts 12 units of type 2, which nothing consumes,
    and checkpoints them under ``prefix``."""

    def app(ctx):
        if ctx.rank == 0:
            for i in range(12):
                ctx.put(i.to_bytes(4, "little"), 2)
            rc, n = ctx.checkpoint(prefix)
            assert rc == adlb_tpu_torch.ADLB_SUCCESS and n == 12
            ctx.set_problem_done()
        return None

    adlb_tpu_torch.run_world(num_app_ranks=4, nservers=2, types=[1, 2],
                             app_fn=app, cfg=Config(device="cpu"),
                             timeout=60)


@pytest.mark.parametrize("name,kw", [
    ("restore_path", {}),
    ("on_server_failure", {"on_server_failure": "failover"}),
    ("spill_dir", {"max_malloc_per_server": 1 << 20,
                   "spill_watermark_frac": 1e-6}),
    ("wal_dir", {}),
    ("ops_port", {"ops_port": 0}),
    ("control", {"control": True, "control_dry_run": True,
                 "obs_sync_interval": 0.1}),
    ("slo", {"slo": [{"name": "any", "p99_ms": 1e6, "window_s": 60}],
             "obs_sync_interval": 0.1}),
    ("periodic_log_interval", {"periodic_log_interval": 0.1}),
    ("hedge_budget_frac", {"hedge_budget_frac": 0.05,
                           "lease_timeout_s": 5.0}),
])
def test_ported_features_validate(name, kw, tmp_path, monkeypatch):
    """Each feature the port once refused builds its ``Config`` and runs a
    2-server planned port world: 30 units of type 1, each consumed once
    (a restored world also drains the 12 checkpointed units of type 2)."""
    from adlb_tpu_torch.runtime.spill import SpillStore

    kw = dict(kw)
    restored = 0
    spilled = []
    put = SpillStore.put
    monkeypatch.setattr(SpillStore, "put", lambda store, seqno, blob: (
        spilled.append(seqno), put(store, seqno, blob))[1])
    if name == "restore_path":
        _checkpoint(str(tmp_path / "pool"))
        kw["restore_path"], restored = str(tmp_path / "pool"), 12
    elif name in ("spill_dir", "wal_dir"):
        kw[name] = str(tmp_path / name)
    cfg = Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                 put_routing="home", balancer_max_tasks=32,
                 balancer_max_requesters=8, exhaust_check_interval=0.2, **kw)
    assert getattr(cfg, name) == getattr(
        Config(device="cpu", **kw), name) != getattr(Config(device="cpu"),
                                                      name)

    def app(ctx):
        if ctx.rank == 0:
            for i in range(30):
                ctx.put(i.to_bytes(4, "little"), 1, work_prio=i % 7)
        got = []
        while True:
            rc, r = ctx.reserve([1, 2])
            if rc != adlb_tpu_torch.ADLB_SUCCESS:
                return got
            rc, buf = ctx.get_reserved(r.handle)
            got.append((r.work_type, int.from_bytes(buf, "little")))

    res = adlb_tpu_torch.run_world(num_app_ranks=4, nservers=2, types=[1, 2],
                                   app_fn=app, cfg=cfg, timeout=60)
    assert not res.aborted
    got = sorted(x for v in res.app_results.values() for x in v)
    assert got == sorted([(1, i) for i in range(30)]
                         + [(2, i) for i in range(restored)])
    if name == "spill_dir":
        assert spilled, "nothing spilled"
    if name == "wal_dir":
        assert any((tmp_path / name).rglob("*")), "no WAL segment written"


def test_unported_modules_and_mesh_raise():
    # one device (the CPU): the mesh option plans on the single-device
    # solver, as the JAX package does on one chip; the JAX package's
    # other solver backends do not exist in the port
    engine = PlanEngine(types=TYPES, max_tasks=4, max_requesters=2,
                        use_mesh=True, device="cpu")
    assert isinstance(engine.solver, tsolve.AssignmentSolver)
    with pytest.raises(ValueError, match="solver_backend"):
        Config(device="cpu", solver_backend="pallas")


def test_mesh_config_validates():
    cfg = Config(balancer="tpu", balancer_mesh="auto", device="cpu")
    assert cfg.balancer_mesh == "auto"
    Config(balancer_mesh="auto", balancer_auction="host", device="cpu")
    with pytest.raises(ValueError, match="balancer_mesh"):
        Config(balancer_mesh="on", device="cpu")


def test_plan_engine_builds_the_sharded_solver_and_plans_across_servers():
    engine = PlanEngine(types=(1, 2), max_tasks=8, max_requesters=4,
                        use_mesh=True, nshards=4, nservers=6, device="cpu")
    solver = engine.solver
    assert isinstance(solver, DistributedAssignmentSolver)
    assert (solver.nshards, solver.S) == (4, 8)  # ceil(6 / 4) = 2 per shard
    snaps = {
        100: {"tasks": [(1, 1, 5, 8), (2, 2, 3, 8)], "reqs": [],
              "nbytes": 16, "consumers": 1},
        101: {"tasks": [], "reqs": [(7, 1, [1]), (8, 2, [2])],
              "nbytes": 0, "consumers": 2},
    }
    matches, _ = engine.round(snaps, None)
    assert sorted(matches) == [(100, 1, 101, 7, 1), (100, 2, 101, 8, 2)]
    assert solver.solve_count == 1


def test_sharded_solver_construction_error_propagates(monkeypatch):
    """The JAX package degrades to the single-device solver on any error
    here; the port raises."""
    with pytest.raises(ValueError, match="auction"):
        PlanEngine(types=TYPES, max_tasks=4, max_requesters=2, use_mesh=True,
                   nshards=2, auction="bogus", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        PlanEngine(types=TYPES, max_tasks=4, max_requesters=2, use_mesh=True,
                   nshards=2, device="cuda")


def test_device_solve_failure_aborts_the_world(monkeypatch):
    def broken(*args):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(greedy_sweep, "greedy_assign_torch", broken)
    host = tsolve.solve_counts["host"]
    with pytest.raises(RuntimeError, match="balancer failed"):
        adlb_tpu_torch.run_world(
            num_app_ranks=8, nservers=2, types=TYPES + (ANSWER,),
            app_fn=_make_app(adlb_tpu_torch.ADLB_SUCCESS),
            cfg=_planned(Config, device="cpu"), timeout=60)
    assert tsolve.solve_counts["host"] == host  # no numpy fallback


def test_unregistered_app_payload_class_refused():
    """The port's twin of ``tests/test_tcp_world.py::
    test_unregistered_app_payload_class_refused``, with the port's module
    path: an app-message payload whose class is not registered via
    ``register_safe_pickle`` is refused, and registering
    ``adlb_tpu_torch.runtime.world.Config`` makes the same bytes load."""
    import pickle

    from adlb_tpu_torch.runtime import codec as _codec
    from adlb_tpu_torch.runtime.codec import (loads_restricted,
                                              register_safe_pickle)
    from adlb_tpu_torch.runtime.messages import Tag, msg

    body = pickle.dumps(msg(Tag.AM_APP, 2, payload=Config(), apptag=1),
                        protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(pickle.UnpicklingError, match="register_safe_pickle"):
        loads_restricted(body)
    register_safe_pickle("adlb_tpu_torch.runtime.world", "Config")
    try:
        m = loads_restricted(body)
        assert isinstance(m.data["payload"], Config)
    finally:
        _codec._SAFE_PICKLE_GLOBALS.discard(
            ("adlb_tpu_torch.runtime.world", "Config"))
