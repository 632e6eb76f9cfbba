"""Workload programs: the framework's "model zoo".

The reference ships its test/benchmark story as example mini-apps
(reference ``examples/``, SURVEY §4): self-checking known-answer programs
that exercise the full Put/Reserve/answer economy. These are their
re-designed equivalents, each a parameterizable function over
:func:`adlb_tpu_torch.api.run_world`, used both as integration tests and as
benchmark drivers:

* :mod:`~adlb_tpu_torch.workloads.nq` — n-queens DFS (reference ``examples/nq.c``)
* :mod:`~adlb_tpu_torch.workloads.tsp` — branch-and-bound TSP with tree-broadcast
  bound updates (reference ``examples/tsp.c``)
* :mod:`~adlb_tpu_torch.workloads.sudoku` — multi-type DFS (reference
  ``examples/sudoku.c``)
* :mod:`~adlb_tpu_torch.workloads.gfmc` — A/B/C/D work-package economy with
  self-validating counts (reference ``examples/c4.c``)
* :mod:`~adlb_tpu_torch.workloads.hotspot` — producer-concentrated balancing
  scenario (no reference analogue; the BASELINE.json north-star probe)
* :mod:`~adlb_tpu_torch.workloads.model` — minimal master/worker dummy-work model
  terminating by exhaustion (reference ``examples/model.c``)

The JAX package's other workloads (batcher, coinop, grid, add2, skel,
trickle, pmcmc, c1, c3, partest and the ``*_native`` probes, which need the
native plane) are later slices of the port.
"""
