"""`repro_torch.runtime` — fault tolerance and elasticity: the policy
classes of the JAX package's ``runtime`` and the restart skeleton that
serving shares."""
from .fault_tolerance import (ElasticPlan, ElasticScaler, HeartbeatMonitor,
                              StragglerDetector, run_with_restarts)

__all__ = ["ElasticPlan", "ElasticScaler", "HeartbeatMonitor",
           "StragglerDetector", "run_with_restarts"]
