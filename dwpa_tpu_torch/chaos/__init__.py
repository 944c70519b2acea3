"""Deterministic chaos harness: seeded fault schedules for every layer.

A copy of the JAX package's harness, driving the port's client and
server: the same seed gives the same fault schedule in both.  One seeded
:class:`FaultPlan` decides, call by call, which fault (if any) a
:class:`ChaosTransport` injects under the real retry stack, and
``fsfault`` provides torn-write/short-read injection for the journal
formats.  Everything is driven by explicit seeds and virtual clocks —
the same seed replays the identical fault schedule, so a soak failure
is a one-line repro, not a flake.
"""

from .plan import FAULT_KINDS, FaultPlan
from .transport import ChaosTransport, VirtualClock, WsgiTransport
from .fsfault import FsFaultInjector, flip_byte, tear_tail
from .dbfault import (DB_FAULT_KINDS, DbFaultPlan, SimulatedCrash,
                      install as install_db_faults, sweep_invariants)

__all__ = [
    "FAULT_KINDS",
    "FaultPlan",
    "ChaosTransport",
    "VirtualClock",
    "WsgiTransport",
    "FsFaultInjector",
    "flip_byte",
    "tear_tail",
    "DB_FAULT_KINDS",
    "DbFaultPlan",
    "SimulatedCrash",
    "install_db_faults",
    "sweep_invariants",
]
