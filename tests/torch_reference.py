"""Runs the JAX package's own test files, unchanged, against the port.

Each reference file runs in its own ``python -m pytest --noconftest -m
'not slow'`` subprocess whose working directory is a staged root
(:func:`stage`): copies of the reference test files under ``tests/``, links
to ``adlb_tpu_torch/``, ``examples/``, ``include/`` and ``scripts/``, and
the import alias of ``tests/torch_reference_alias.py``, which maps
``adlb_tpu`` and every ``adlb_tpu.<x>`` to ``adlb_tpu_torch.<x>`` and sets
the device the run was given as the default of every port entry point
whose default is ``"cuda"``. The staged root is the only directory on the
run's ``PYTHONPATH``, and its ``sitecustomize.py`` installs the alias in
every interpreter started there, ranks spawned by ``multiprocessing`` and
launchers started by ``subprocess`` included. Its ``adlb_tpu/`` holds the
alias too, for a process that reaches it without ``sitecustomize``, and
links ``adlb_tpu/native`` to the port's C and C++ sources, which the C
API tests compile. The JAX package's directory is on no path of the run.

A run fails if any process of it imported ``jax`` or a module file of the
JAX package (:func:`check_processes`), or if a test failed twice: a test
that fails is run once more alone, and every rerun is printed with its
node id.

Left out, because they reach JAX, Pallas or the device mesh (the port's
``test_torch_*`` files hold their contracts): ``test_pallas_solve``,
``test_sharded_parity``, ``test_device_auction``,
``test_distributed_solver``, ``test_ledger_parity``,
``test_host_device_parity`` and ``test_graft_entry``.

The one test excluded is in :data:`EXCLUDED`, with its reason.

    import sys; sys.path.insert(0, "tests")
    from torch_reference import run_reference_file
    run_reference_file("test_api_basic", "cpu", "/tmp/ref", print)
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference files, grouped by layer: one ``test_torch_reference_*``
#: file per group, one parametrised case per reference file
GROUPS = {
    "api": ["test_api_basic", "test_fused_delivery", "test_get_work",
            "test_iput", "test_queues"],
    "membership": ["test_membership", "test_trickle_ring"],
    "service": ["test_service_mode"],
    "failure": ["test_gray_failures", "test_failure_detection",
                "test_faults", "test_hedge", "test_failover",
                "test_master_failover"],
    "durability": ["test_checkpoint", "test_spill", "test_native_checkpoint"],
    "observability": ["test_slo", "test_control", "test_periodic_stats",
                      "test_obs"],
    "trace": ["test_trace", "test_lifecycle_trace", "test_profile",
              "test_debug_plumbing"],
    "transport": ["test_channel", "test_tcp_world", "test_shm_fabric"],
    "launch": ["test_launch"],
    "native": ["test_native_server", "test_native_wq", "test_capi",
               "test_fshim", "test_codec", "test_codec_fuzz",
               "test_utils_stats"],
    "workloads": ["test_balancer", "test_balancer_fuzz", "test_sim_scale",
                  "test_workloads", "test_workloads_extra",
                  "test_workloads_c1c3", "test_pmcmc", "test_soak"],
}

#: the files whose worlds plan with ``balancer="tpu"``: the runner's card
#: mode runs them with the device ``"cuda"``
CARD_FILES = ["test_balancer", "test_trickle_ring", "test_workloads",
              "test_workloads_c1c3", "test_pmcmc", "test_native_server",
              "test_service_mode", "test_obs", "test_lifecycle_trace"]

#: node id -> why the test cannot hold against the port unchanged
EXCLUDED = {
    "tests/test_tcp_world.py::test_unregistered_app_payload_class_refused":
        "it registers the JAX package's module path as a string "
        "(\"adlb_tpu.runtime.world\"), while the port's refusal names "
        "adlb_tpu_torch.runtime.world; tests/test_torch_world.py holds the "
        "contract with the port's path",
}

#: what the staged root links to in this checkout
LINKS = {"adlb_tpu_torch": "adlb_tpu_torch", "examples": "examples",
         "include": "include", "scripts": "scripts",
         os.path.join("adlb_tpu", "native"):
             os.path.join("adlb_tpu_torch", "native")}

SITECUSTOMIZE = "import _adlb_ref_alias\n_adlb_ref_alias.install()\n"
PACKAGE_INIT = (
    "# reached only by a process that started without sitecustomize\n"
    "import sys\n"
    "import _adlb_ref_alias\n"
    "_adlb_ref_alias.install()\n"
    "import adlb_tpu_torch\n"
    "sys.modules[__name__] = adlb_tpu_torch\n")


def stage(root: str, device: str, files, broken: bool = False,
          extra=None, host_threshold=None) -> str:
    """Lays out the staged root under ``root`` for a run on ``device`` of
    the reference files ``files``, plus the test files ``extra`` (name ->
    source) written beside them; returns its path. ``host_threshold``,
    when given, replaces the port's host-threshold defaults (see
    :func:`run_reference_file`). ``broken=True`` lays
    out a deliberately broken alias, for the test that shows a run fails on
    it: ``adlb_tpu`` links to the JAX package and only the pytest process
    installs the alias (every process still reports what it imported), so
    a spawned rank imports the JAX package."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    top = os.path.join(root, "root")
    report = os.path.join(root, "report")
    os.makedirs(os.path.join(top, "tests"))
    os.makedirs(report)
    for name in files:
        shutil.copyfile(os.path.join(REPO, "tests", f"{name}.py"),
                        os.path.join(top, "tests", f"{name}.py"))
    for name, source in (extra or {}).items():
        with open(os.path.join(top, "tests", f"{name}.py"), "w") as f:
            f.write(source)
    shutil.copyfile(os.path.join(REPO, "pytest.ini"),
                    os.path.join(top, "pytest.ini"))
    shutil.copyfile(os.path.join(REPO, "tests", "torch_reference_alias.py"),
                    os.path.join(top, "_adlb_ref_alias.py"))
    with open(os.path.join(top, "_adlb_ref_alias.json"), "w") as f:
        json.dump({"device": device, "host_threshold": host_threshold,
                   "report_dir": report, "repo": REPO}, f)
    links = dict(LINKS)
    if broken:
        links["adlb_tpu"] = "adlb_tpu"
        del links[os.path.join("adlb_tpu", "native")]
        site = ("import os\nimport _adlb_ref_alias\n"
                "_adlb_ref_alias.install('ADLB_REF_TOP' not in os.environ)\n"
                "os.environ['ADLB_REF_TOP'] = '1'\n")
    else:
        os.makedirs(os.path.join(top, "adlb_tpu"))
        with open(os.path.join(top, "adlb_tpu", "__init__.py"), "w") as f:
            f.write(PACKAGE_INIT)
        site = SITECUSTOMIZE
    with open(os.path.join(top, "sitecustomize.py"), "w") as f:
        f.write(site)
    for name, target in links.items():
        os.symlink(os.path.join(REPO, target), os.path.join(top, name))
    return top


def _pytest(top: str, args, timeout: float):
    """Runs pytest in the staged root; returns (exit code or None on
    timeout, the plugin's results or None, the run's output tail)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_") and k != "ADLB_REF_TOP"}
    env["PYTHONPATH"] = top
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q",
           "-p", "_adlb_ref_alias", "-p", "no:cacheprovider",
           "-p", "no:xdist", "-p", "no:randomly", *args]
    with open(os.path.join(top, "..", "out.log"), "w+") as out:
        proc = subprocess.Popen(cmd, cwd=top, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            # every process the run started: spawned ranks, launchers
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        out.seek(0)
        tail = out.read()[-4000:]
    path = os.path.join(top, "..", "report", f"results-{proc.pid}.json")
    results = None
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    return rc, results, tail


def check_processes(top: str) -> int:
    """Raises if any process of the run imported ``jax`` or a module file
    of the JAX package; returns the number of processes that held the
    alias."""
    report = os.path.join(top, "..", "report")
    bad = []
    for path in sorted(glob.glob(os.path.join(report, "violation-*.json"))):
        with open(path) as f:
            bad.append(json.load(f))
    procs = sorted(glob.glob(os.path.join(report, "proc-*.json")))
    for path in procs:
        with open(path) as f:
            rec = json.load(f)
        if rec["bad"]:
            bad.append(rec)
    if bad:
        raise AssertionError(f"a process of the run imported JAX or the JAX "
                             f"package: {bad[:5]}")
    return len(procs)


def run_reference_file(name: str, device: str, tmp: str, report=print,
                       timeout: float = 600.0, host_threshold=None,
                       broken: bool = False, extra=None) -> dict:
    """Runs ``tests/<name>.py`` of the JAX package against the port on
    ``device``; raises AssertionError if a test failed alone as well, if
    the run did not end, or if a process imported JAX or the JAX package.
    Returns the counts of passes, skips and reruns, the processes that
    held the alias, the pytest process's kernel launches and device
    solves, and the wall.

    ``host_threshold`` (the card mode passes 0) replaces the defaults of
    ``Config.solver_host_threshold`` and of ``AssignmentSolver``'s
    ``host_threshold_reqs``: the reference's worlds are small, and at the
    solver's default (64 parked requesters) they would solve on the host
    and never reach the kernel. ``broken`` and ``extra`` are
    :func:`stage`'s, for the tests of the runner itself."""
    t0 = time.perf_counter()
    top = stage(tmp, device, [n for g in GROUPS.values() for n in g],
                broken=broken, extra=extra, host_threshold=host_threshold)
    args = [f"tests/{name}.py", "-m", "not slow"]
    for node in EXCLUDED:
        if node.startswith(f"tests/{name}.py::"):
            args += ["--deselect", node]
    rc, results, tail = _pytest(top, args, timeout)
    if rc is None or results is None or rc not in (0, 1):
        raise AssertionError(f"{name} on {device}: pytest exit {rc}, no "
                             f"complete run:\n{tail}")
    outcomes = results["outcomes"]
    failed = sorted(n for n, o in outcomes.items() if o == "failed")
    if rc == 1 and not failed:
        raise AssertionError(f"{name}: pytest exit 1 with no failed test:"
                             f"\n{tail}")
    reruns = {}
    for node in failed:
        rrc, rres, rtail = _pytest(top, [node], timeout / 2)
        ok = rrc == 0 and rres is not None and \
            rres["outcomes"].get(node) == "passed"
        reruns[node] = "passed" if ok else "failed"
        report(f"reference suites on {device}: rerun alone {node}: "
               f"{reruns[node]}")
        if not ok:
            raise AssertionError(f"{node} failed on the port on {device}, "
                                 f"and again alone:\n{rtail}\nfirst run:\n"
                                 f"{tail}")
    nprocs = check_processes(top)
    counts = {
        "passed": sum(o == "passed" for o in outcomes.values()),
        "skipped": sum(o == "skipped" for o in outcomes.values()),
        "reruns": reruns, "processes": nprocs,
        "kernels": results["kernels"], "wall_s": time.perf_counter() - t0}
    if counts["passed"] + len(reruns) == 0:
        raise AssertionError(f"{name} on {device}: no test passed:\n{tail}")
    report(f"reference suites on {device}: {name}: {counts['passed']} "
           f"passed, {counts['skipped']} skipped, {len(reruns)} rerun, "
           f"{nprocs} processes held the alias, {counts['wall_s']:.1f} s; "
           f"the pytest process's kernel launches and device solves "
           f"{counts['kernels']}")
    return counts
