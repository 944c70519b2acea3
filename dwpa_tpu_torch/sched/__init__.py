"""Client-side scheduling: pack small work units into full device
batches (mixed-ESSID fusion — see ``sched.fuse`` and
``sched.executor``).
"""

from .executor import MultiUnitExecutor, WorkUnit
from .fuse import FusedBatch, FusedUnit, fuse_units, fused_width, fused_widths

__all__ = [
    "FusedBatch",
    "FusedUnit",
    "MultiUnitExecutor",
    "WorkUnit",
    "fuse_units",
    "fused_width",
    "fused_widths",
]
