"""Unified observability: metrics registry, flight recorder, ops endpoint.

The reference scatters its observability across compile-time layers — MPE
spans (``src/adlb_prof.c``), the STAT_APS periodic ring, the debug server's
11-counter heartbeat, and the cblog circular buffer. The rebuild reproduced
each piece in isolation; this package unifies them around one per-rank
:class:`~adlb_tpu_torch.obs.metrics.Registry` that every layer (transport, server
reactor, balancer engine, client) writes into, one JSON
:class:`~adlb_tpu_torch.obs.flight.FlightRecorder` artifact emitted when a world
dies, and one live HTTP surface
(:class:`~adlb_tpu_torch.obs.ops_server.OpsServer`) on the master server —
plus the tail-aware layer: unit journeys with tail-based promotion
(:mod:`~adlb_tpu_torch.obs.journey`) and the continuous sampling profiler
(:mod:`~adlb_tpu_torch.obs.profile`), both riding the same gossip plane.
"""

from adlb_tpu_torch.obs.flight import FlightRecorder, resolve_flight_dir
from adlb_tpu_torch.obs.journey import JourneyRecorder
from adlb_tpu_torch.obs.profile import Profiler
from adlb_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    expose_merged,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "FlightRecorder",
    "JourneyRecorder",
    "Profiler",
    "expose_merged",
    "resolve_flight_dir",
]
