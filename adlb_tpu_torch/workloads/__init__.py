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
* :mod:`~adlb_tpu_torch.workloads.batcher` — heterogeneous job bag (reference
  ``examples/batcher.c``)
* :mod:`~adlb_tpu_torch.workloads.gfmc` — A/B/C/D work-package economy with
  self-validating counts (reference ``examples/c4.c``)
* :mod:`~adlb_tpu_torch.workloads.coinop` — pop-latency probe (reference
  ``examples/coinop.cpp``)
* :mod:`~adlb_tpu_torch.workloads.grid` — data-affinity Jacobi relaxation with a
  sequential oracle (reference ``examples/grid_daf.c`` / ``grid_uni.c``)
* :mod:`~adlb_tpu_torch.workloads.add2` — answer-economy smoke test (reference
  ``examples/add2.c``)
* :mod:`~adlb_tpu_torch.workloads.skel` — 8-type synthetic stress probe
  (reference ``examples/skel.c`` / ``c2.c``)
* :mod:`~adlb_tpu_torch.workloads.hotspot` — producer-concentrated balancing
  scenario (no reference analogue; the BASELINE.json north-star probe)
* :mod:`~adlb_tpu_torch.workloads.trickle` — steady single-server work arrival
  with remote-only consumers, isolating dispatch/discovery latency (no
  reference analogue; the steal-to-exec-latency probe of BASELINE.md)
* ``*_native`` twins (nq, sudoku, gfmc, tsp, hotspot, coinop, trickle) —
  the probes above on the all-native plane (C clients ``examples/*_c.c``,
  C++ daemons, the planning sidecar), for scale and latency numbers free
  of interpreter coupling
* :mod:`~adlb_tpu_torch.workloads.pmcmc` — embarrassingly-parallel MCMC hard-disk
  demo with targeted solution returns (reference ``examples/pmcmc.c``)

* :mod:`~adlb_tpu_torch.workloads.model` — minimal master/worker dummy-work model
  terminating by exhaustion (reference ``examples/model.c``)
* :mod:`~adlb_tpu_torch.workloads.c1` — GFMC-precursor epoch workload whose B/C
  answers travel as app-to-app point-to-point messages, exercising the
  app_comm-equivalent messaging layer (reference ``examples/c1.c``)
* :mod:`~adlb_tpu_torch.workloads.c3` — batch-generation GFMC variant with a
  park-until-exhaustion master (reference ``examples/c3.c``)
* :mod:`~adlb_tpu_torch.workloads.partest` — synthetic-work calibration utility
  (define_work/do_work nugget loops, reference ``examples/partest.c``)

``c2.c`` is the skeleton behind :mod:`~adlb_tpu_torch.workloads.skel` and is
covered there; ``stats.c`` is a standalone statistics library, ported as
:mod:`adlb_tpu_torch.utils.stats`; ``grid_old_daf.c`` is a superseded draft
whose own header says it "does not agree with grid_uni in terms of
computed result" (reference ``examples/grid_old_daf.c:1-8``) — the
corrected algorithm is :mod:`~adlb_tpu_torch.workloads.grid`; ``f1.f`` /
``fbatcher.f`` are Fortran twins of c1/batcher exercising the Fortran
binding, which this framework validates through the C shim tests instead
(``tests/test_fshim.py``).
"""
