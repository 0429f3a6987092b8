"""The planner's actions and actuators (copies of ``dynamo_tpu/planner/
actions.py`` and ``actuate.py``): the pool names, the action journal and
the runtime actuator that ``worker/roles.py`` and the autoscaler drive.
The rest of the JAX planner (predictors, interpolators, connectors, the
adjustment loop and the operator) is not ported yet."""

from dynamo_tpu_torch.planner.actions import (
    ActionJournal,
    FleetResize,
    Hold,
    PoolMove,
    ReplicaScale,
    ScaleActionError,
)

__all__ = [
    "ActionJournal",
    "FleetResize",
    "PoolMove",
    "ReplicaScale",
    "Hold",
    "ScaleActionError",
]
