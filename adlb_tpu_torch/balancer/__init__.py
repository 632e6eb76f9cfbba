"""Balancer: the planner that replaces the reference's gossip + stealing.

The reference approximates global state with a 0.1 s ring-gossiped status
vector and makes per-server greedy decisions (qmstat/RFR/push, reference
``src/adlb.c:806-822,1802-2070``). Here servers stream fixed-shape queue-state
snapshots to a balancer, which computes a *global* task->requester assignment
in one solve: on the card, one launch of the greedy-sweep kernel
(:mod:`adlb_tpu_torch.balancer.greedy_sweep`).
"""

from adlb_tpu_torch.balancer.solve import AssignmentSolver  # noqa: F401
