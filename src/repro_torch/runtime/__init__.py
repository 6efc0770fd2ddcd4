"""Runtime services of the port: deterministic fault injection and the
fault-tolerant training driver."""
from .driver import FaultTolerantDriver, StragglerMonitor, TrainResult
from .faults import (DeviceLostError, FaultInjector, FaultPlan, InjectedFault,
                     as_injector)

__all__ = ["DeviceLostError", "FaultInjector", "FaultPlan", "FaultTolerantDriver",
           "InjectedFault", "StragglerMonitor", "TrainResult", "as_injector"]
