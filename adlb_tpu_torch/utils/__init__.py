"""Framework utilities (running statistics, small shared helpers)."""

from adlb_tpu_torch.utils.stats import RunningStats

__all__ = ["RunningStats"]
