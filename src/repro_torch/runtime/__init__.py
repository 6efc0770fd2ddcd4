"""Runtime services of the port: deterministic fault injection."""
from .faults import DeviceLostError, FaultInjector, FaultPlan, InjectedFault

__all__ = ["DeviceLostError", "FaultInjector", "FaultPlan", "InjectedFault"]
