"""Discrete-event runtime for the uBFT protocol layer.

The protocol code in ``repro.core`` is written against the abstract
``Process`` / ``Network`` interfaces defined here.  The simulator provides a
microsecond-resolution virtual clock, busy-server process semantics (a process
handles one event at a time; handler cost delays subsequent events), a
calibrated network-latency model, and hooks for failure injection and
Byzantine adversaries.
"""

from repro_torch.sim.events import PeriodicHandle, Process, Simulator
from repro_torch.sim.faults import FaultEvent, FaultInjector, FaultSchedule
from repro_torch.sim.net import NetworkModel, NetParams

__all__ = ["PeriodicHandle", "Process", "Simulator", "NetworkModel",
           "NetParams", "FaultEvent", "FaultInjector", "FaultSchedule"]
