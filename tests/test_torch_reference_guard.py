"""The runner of the JAX package's suites (``tests/torch_reference.py``)
holds its alias in every process, and refuses a run in which any process
imported JAX or a module file of the JAX package.

Each case runs a probe test file in a staged root: a rank spawned with
``multiprocessing``'s ``"spawn"`` imports ``adlb_tpu.<x>`` and reports
what it got, while asserting nothing about it, as a reference test would
pass on whichever package it reached.
"""

import os

import pytest

from torch_reference import REPO, run_reference_file

PROBE = '''
import importlib
import inspect
import multiprocessing as mp
import pathlib


def _child(q, name):
    mod = importlib.import_module(name)
    from adlb_tpu.balancer.solve import AssignmentSolver

    default = inspect.signature(AssignmentSolver).parameters["device"]
    q.put((mod.__file__, mod.Config().device, default.default))


def test_spawned_rank():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_child, args=(q, "adlb_tpu.runtime.world"))
    p.start()
    p.join(120)
    got = q.get(timeout=5) if p.exitcode == 0 else None
    # beside the staged root: the directory the runner was given
    out = pathlib.Path(__file__).resolve().parents[2] / "probe.txt"
    out.write_text(repr(got))
'''


def _probe(tmp_path, broken=False, extra_test=""):
    run_reference_file("test_probe", "cpu", str(tmp_path), print,
                       timeout=300.0, broken=broken,
                       extra={"test_probe": PROBE + extra_test})


def test_spawned_ranks_run_the_port_with_the_runners_device(tmp_path):
    _probe(tmp_path)
    path, device, default = eval((tmp_path / "probe.txt").read_text())
    assert os.path.realpath(path) == os.path.join(
        REPO, "adlb_tpu_torch", "runtime", "world.py")
    assert device == default == "cpu"


def test_unaliased_spawned_ranks_fail_the_run(tmp_path):
    """A deliberately broken alias: only the pytest process installs it,
    and ``adlb_tpu`` links to the JAX package, so the spawned rank imports
    the JAX package. The probe passes; the run does not."""
    with pytest.raises(AssertionError, match="imported JAX or the JAX"):
        _probe(tmp_path, broken=True)


def test_a_jax_import_fails_the_run(tmp_path):
    with pytest.raises(AssertionError, match="imported JAX or the JAX"):
        _probe(tmp_path, extra_test='''

def test_imports_jax():
    try:
        import jax  # noqa: F401
    except ImportError:
        pass
''')


def test_a_module_file_of_the_jax_package_fails_the_run(tmp_path):
    with pytest.raises(AssertionError, match="imported JAX or the JAX"):
        _probe(tmp_path, extra_test=f'''

def test_loads_a_file_of_the_jax_package():
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(
        "ref_types", {os.path.join(REPO, "adlb_tpu", "types.py")!r})
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ref_types"] = mod
    spec.loader.exec_module(mod)
''')
