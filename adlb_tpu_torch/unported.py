"""Deferred imports of modules whose slice of the port has not landed yet.

The runtime reaches several optional subsystems (spill, WAL, replicas, the
TCP/shm transports, SLO, ops endpoint, controller, native plane) through
imports inside the functions that use them. In ``adlb_tpu_torch`` such an
import goes through :func:`require`, so a feature whose module is not yet
ported fails with ``NotImplementedError`` naming it, instead of an
``ImportError`` that reads like a broken installation. Once the module is
ported, ``require`` returns it unchanged.
"""

from __future__ import annotations

import importlib


def require(module: str):
    """Import ``adlb_tpu_torch.<module>`` or raise ``NotImplementedError``
    when that module is not part of the port yet."""
    full = f"adlb_tpu_torch.{module}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name is not None and (full == e.name
                                   or full.startswith(e.name + ".")):
            raise NotImplementedError(
                f"{full} is not ported to adlb_tpu_torch yet") from e
        raise
