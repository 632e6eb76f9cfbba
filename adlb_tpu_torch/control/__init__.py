"""The fleet brain: closed-loop control over the actuators.

See :mod:`adlb_tpu_torch.control.controller` for the decision engine the
master's obs tick drives when ``Config(control=True)``.
"""

from adlb_tpu_torch.control.controller import Controller, parse_policy

__all__ = ["Controller", "parse_policy"]
