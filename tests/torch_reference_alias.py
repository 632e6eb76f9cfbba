"""The import alias under which the JAX package's own test files run against
the port (``tests/torch_reference.py`` stages it; pytest does not collect
this file).

Staged as ``_adlb_ref_alias.py`` in a directory that stands in for the
repository root, beside ``_adlb_ref_alias.json`` (the device and the
report directory, fixed when the directory is staged). The staged
``sitecustomize.py`` calls :func:`install` in every interpreter started
with that directory on its ``PYTHONPATH``: the pytest process, ranks
spawned by ``multiprocessing``, launchers and scripts run by ``subprocess``.

:func:`install` puts one finder first on ``sys.meta_path``:

* ``adlb_tpu`` and every ``adlb_tpu.<x>`` resolve to the module object of
  ``adlb_tpu_torch.<x>`` (the module names match), so a class reached
  through either name is one class, and ``python -m adlb_tpu.<x>`` runs
  the port's module;
* ``jax`` and ``jaxlib`` are refused, and the attempt is recorded;
* each port entry point whose ``device`` defaults to ``"cuda"`` gets the
  staged device as its default once its module is loaded, and, when a
  host threshold is staged, ``Config.solver_host_threshold`` and
  ``AssignmentSolver``'s ``host_threshold_reqs`` get it as theirs (a
  default that is no longer the one listed fails the load: the list
  below has drifted from the port).

Each process writes ``proc-<pid>.json`` to the report directory when it
starts and again at exit, with the modules it imported from a file under
the JAX package's directory or named ``jax``; the runner fails a run on
any such module and on any ``violation-*.json``.

Loaded into pytest as a plugin (``-p _adlb_ref_alias``), it also writes
each test's outcome, and the pytest process's kernel launches and solve
counts (:func:`kernel_counts`), to ``results-<pid>.json``.
"""

import atexit
import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import inspect
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "_adlb_ref_alias.json")) as _f:
    CONF = json.load(_f)

#: the device default of every port entry point that has one
DEVICE = {"device": ("cuda", "device")}
#: port module -> entry point -> parameter -> (the port's default, the
#: key of ``_adlb_ref_alias.json`` whose value replaces it)
PATCHES = {
    "adlb_tpu_torch.runtime.world": {"Config": {
        **DEVICE, "solver_host_threshold": (None, "host_threshold")}},
    "adlb_tpu_torch.balancer.solve": {"AssignmentSolver": {
        **DEVICE, "host_threshold_reqs": (64, "host_threshold")}},
    "adlb_tpu_torch.balancer.engine": {"PlanEngine": DEVICE},
    "adlb_tpu_torch.balancer.distributed": {
        "build_distributed_solver": DEVICE,
        "DistributedAssignmentSolver": DEVICE},
    "adlb_tpu_torch.balancer.plan_bench": {"run_sweep": DEVICE},
    "adlb_tpu_torch.graft_entry": {"entry": DEVICE,
                                   "dryrun_multichip": DEVICE},
}
_REFUSED = ("jax", "jaxlib")
_seq = [0]


def _write(name: str, record: dict) -> None:
    path = os.path.join(CONF["report_dir"], name)
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)


def _violation(what: str) -> None:
    _seq[0] += 1
    _write(f"violation-{os.getpid()}-{_seq[0]}.json",
           {"pid": os.getpid(), "argv": sys.argv, "what": what})


def bad_modules() -> list:
    """Modules of this process that are JAX's or were loaded from a file
    of the JAX package (``adlb_tpu/`` beside ``adlb_tpu_torch/``)."""
    ref = os.path.join(CONF["repo"], "adlb_tpu") + os.sep
    bad = []
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] in _REFUSED:
            bad.append(name)
            continue
        path = getattr(mod, "__file__", None)
        if path and os.path.realpath(path).startswith(ref):
            bad.append(f"{name} ({path})")
    return bad


def _report(stage: str) -> None:
    _write(f"proc-{os.getpid()}.json",
           {"pid": os.getpid(), "ppid": os.getppid(), "argv": sys.argv,
            "stage": stage, "bad": bad_modules()})


def _set_default(fn, owner: str, name: str, was, value) -> None:
    params = list(inspect.signature(fn).parameters.values())
    names = [p.name for p in params]
    if name not in names:
        raise RuntimeError(f"{owner} takes no {name} argument")
    p = params[names.index(name)]
    if p.default != was:
        raise RuntimeError(f"{owner}'s {name} default is {p.default!r}, "
                           f"not {was!r}")
    if p.kind == p.KEYWORD_ONLY:
        fn.__kwdefaults__ = {**fn.__kwdefaults__, name: value}
        return
    positional = [q for q in params
                  if q.kind in (q.POSITIONAL_ONLY, q.POSITIONAL_OR_KEYWORD)]
    defaults = list(fn.__defaults__)
    defaults[len(defaults) - len(positional) + positional.index(p)] = value
    fn.__defaults__ = tuple(defaults)


def patch_defaults(module) -> None:
    for attr, params in PATCHES[module.__name__].items():
        obj = getattr(module, attr)
        owner = f"{module.__name__}.{attr}"
        fn = obj.__init__ if inspect.isclass(obj) else obj
        fields = getattr(obj, "__dataclass_fields__", {})
        for name, (was, key) in params.items():
            if CONF.get(key) is None:
                continue
            _set_default(fn, owner, name, was, CONF[key])
            if name in fields:
                fields[name].default = CONF[key]
                setattr(obj, name, CONF[key])


class _AliasLoader(importlib.abc.Loader):
    """Loads ``adlb_tpu.<x>`` as the module object of ``adlb_tpu_torch.<x>``."""

    def __init__(self, port: str):
        self.port = port

    def create_module(self, spec):
        return importlib.import_module(self.port)

    def exec_module(self, module):
        pass  # the port's module ran when create_module imported it

    def get_code(self, fullname):  # ``python -m adlb_tpu.<x>`` (runpy)
        spec = importlib.util.find_spec(self.port)
        return spec.loader.get_code(self.port)


class _RefusedLoader(importlib.abc.Loader):
    """Records an import of ``jax`` or ``jaxlib`` and refuses it."""

    def create_module(self, spec):
        _violation(f"import {spec.name}")
        raise ImportError(f"{spec.name} may not be imported in a run of the "
                          f"JAX package's tests against the port")

    def exec_module(self, module):
        pass


class _PatchingLoader(importlib.abc.Loader):
    """The port module's own loader, with the device defaults set after the
    module has run."""

    def __init__(self, inner):
        self.inner = inner

    def create_module(self, spec):
        return self.inner.create_module(spec)

    def exec_module(self, module):
        self.inner.exec_module(module)
        patch_defaults(module)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class AliasFinder(importlib.abc.MetaPathFinder):
    def __init__(self, alias: bool = True):
        self.alias = alias

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _REFUSED:
            return importlib.util.spec_from_loader(name, _RefusedLoader())
        if not self.alias:
            return None
        if name == "adlb_tpu" or name.startswith("adlb_tpu."):
            port = "adlb_tpu_torch" + name[len("adlb_tpu"):]
            found = importlib.util.find_spec(port)
            if found is None:
                return None
            return importlib.util.spec_from_loader(
                name, _AliasLoader(port), origin=found.origin,
                is_package=found.submodule_search_locations is not None)
        if name in PATCHES:
            spec = importlib.machinery.PathFinder.find_spec(name, path)
            if spec is not None:
                spec.loader = _PatchingLoader(spec.loader)
            return spec
        return None


def install(alias: bool = True) -> None:
    """Installs the finder and the per-process report. ``alias=False``
    keeps only the refusal of JAX and the report: a deliberately broken
    alias, for the test that shows a run fails on it."""
    if any(isinstance(f, AliasFinder) for f in sys.meta_path):
        return
    sys.meta_path.insert(0, AliasFinder(alias))
    if alias:
        for name in PATCHES:  # a port module imported before the alias
            if name in sys.modules:
                patch_defaults(sys.modules[name])
    _report("start")
    atexit.register(_report, "exit")

_outcomes = {}


def pytest_runtest_logreport(report):
    """A test fails if any of its phases failed, is skipped if its setup
    or call skipped, and passes otherwise."""
    was = _outcomes.get(report.nodeid)
    if report.failed:
        _outcomes[report.nodeid] = "failed"
    elif report.skipped and was != "failed":
        _outcomes[report.nodeid] = "skipped"
    elif report.when == "call" and was is None:
        _outcomes[report.nodeid] = "passed"


def kernel_counts() -> dict:
    """This process's kernel launches, and its solves as
    ``solve.planner_counts()`` gives them: device and host solves,
    greedy-sweep launches, and the kept device solves
    (``ADLB_CHECK_SOLVES``) held against the numpy twin
    (``solves_checked``, ``solves_wrong``); zero for a module it never
    imported."""
    out = {}
    for name in ("candidates", "auction"):
        mod = sys.modules.get(f"adlb_tpu_torch.balancer.{name}")
        out[name] = mod.launches if mod is not None else 0
    solve = sys.modules.get("adlb_tpu_torch.balancer.solve")
    counts = solve.planner_counts() if solve is not None else {
        "device_solves": 0, "host_solves": 0, "greedy_sweep_launches": 0,
        "solves_checked": 0, "solves_wrong": 0}
    return {**out, **counts}


def pytest_sessionfinish(session, exitstatus):
    _write(f"results-{os.getpid()}.json",
           {"outcomes": _outcomes, "exitstatus": int(exitstatus),
            "bad": bad_modules(), "kernels": kernel_counts()})
