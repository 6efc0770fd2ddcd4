"""Runtime services of the port: deterministic fault injection, the
fault-tolerant training driver, the elastic re-planner and the KV slot pool
of stateful decode serving."""
from .driver import (ElasticPlanner, FaultTolerantDriver, ReplanDecision,
                     StragglerMonitor, TrainResult)
from .faults import (DeviceLostError, FaultInjector, FaultPlan, InjectedFault,
                     as_injector)
from .kvstate import DecodeSession, KVSlotPool, SlotError

__all__ = ["ElasticPlanner", "FaultTolerantDriver", "ReplanDecision",
           "StragglerMonitor", "TrainResult",
           "DeviceLostError", "FaultInjector", "FaultPlan", "InjectedFault",
           "as_injector",
           "DecodeSession", "KVSlotPool", "SlotError"]
