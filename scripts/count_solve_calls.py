"""Count the calls one device solve makes into torch's C extension and into
the kernel's ctypes library: the points where the balancer thread may give
up the interpreter lock and have to win it back.

    python3 scripts/count_solve_calls.py [--root DIR]

Runs a warm 65536 x 8192 device solve (bench.py's generator) through
``AssignmentSolver._device_solve`` of the ``adlb_tpu_torch`` under ``--root``
(default: this checkout) on the card, counts the calls with
``sys.setprofile`` (torch) and a counting stand-in for the loaded library
(ctypes), and prints one JSON line. Give ``--root`` an unpacked older
checkout to count its solve the same way. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path


def _is_torch(fn, tensor_type) -> bool:
    owner = getattr(fn, "__self__", None)
    return ((getattr(fn, "__module__", None) or "").startswith("torch")
            or isinstance(owner, tensor_type)
            or type(owner).__module__.startswith("torch"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose adlb_tpu_torch is counted")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("count_solve_calls: no CUDA device", file=sys.stderr)
        return 1
    from adlb_tpu_torch.balancer import greedy_sweep as gs
    from adlb_tpu_torch.balancer import solve

    rng = np.random.default_rng(1)
    nt, nr, t = 65536, 8192, 4
    arrs = (rng.integers(-50, 50, size=nt).astype(np.int32),
            rng.integers(0, t, size=nt).astype(np.int32),
            np.eye(t, dtype=bool)[rng.integers(0, t, nr)],
            np.ones(nr, dtype=bool))
    solver = solve.AssignmentSolver(types=tuple(range(1, t + 1)),
                                    max_tasks=4096, max_requesters=512,
                                    host_threshold_reqs=0)
    for _ in range(3):  # build, load, allocate
        solver._device_solve(*arrs)

    real = gs._lib
    lib_calls = collections.Counter()

    class Counting:
        def __getattr__(self, name):
            fn = getattr(real, name)

            def call(*a):
                lib_calls[name] += 1
                return fn(*a)
            return call

    torch_calls = collections.Counter()

    def profile(frame, event, arg):
        if event == "c_call" and _is_torch(arg, torch.Tensor):
            torch_calls[getattr(arg, "__qualname__", repr(arg))] += 1

    gs._lib = Counting()
    sys.setprofile(profile)
    try:
        solver._device_solve(*arrs)
    finally:
        sys.setprofile(None)
        gs._lib = real
    print(json.dumps({
        "root": str(Path(args.root).resolve()),
        "card": torch.cuda.get_device_name(0),
        "shape": [nt, nr, t],
        "torch_c_calls": sum(torch_calls.values()),
        "ctypes_calls": sum(lib_calls.values()),
        "torch_by_name": dict(sorted(torch_calls.items())),
        "ctypes_by_name": dict(lib_calls),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
