"""Discrete-event runtime for the uBFT protocol layer (copied from
``repro.sim``).  Fault injection is not part of the port yet, so this
package does not re-export a ``faults`` module."""

from repro_torch.sim.events import PeriodicHandle, Process, Simulator
from repro_torch.sim.net import NetworkModel, NetParams

__all__ = ["PeriodicHandle", "Process", "Simulator", "NetworkModel",
           "NetParams"]
