"""SLA/load planner: predictors, perf interpolators, scaling connectors,
the adjustment loop (reference: components/planner/), and the
closed-loop autoscaler operator (operator.py + actuate.py) that
actually drives the fleet. Port of ``dynamo_tpu/planner/``; the port
adds ``profile_sweep.py``, which sweeps a ``TorchEngine`` into the
profile the interpolators read."""

from dynamo_tpu_torch.planner.actions import (
    ActionJournal,
    FleetResize,
    Hold,
    PoolMove,
    ReplicaScale,
    ScaleActionError,
)
from dynamo_tpu_torch.planner.connector import (
    LocalProcessConnector,
    RecordingConnector,
)
from dynamo_tpu_torch.planner.core import (
    HttpMetricsSource,
    Planner,
    PlannerConfig,
    PlannerObservation,
)
from dynamo_tpu_torch.planner.interpolate import (
    DecodeInterpolator,
    PrefillInterpolator,
    interpolators_from_card_dict,
    load_profile,
    profile_as_card_dict,
    save_profile,
)
from dynamo_tpu_torch.planner.operator import (
    ControlLaw,
    OperatorConfig,
    SlaAutoscaler,
    register_planner_metrics,
)
from dynamo_tpu_torch.planner.predictors import make_predictor

__all__ = [
    "Planner",
    "PlannerConfig",
    "PlannerObservation",
    "HttpMetricsSource",
    "LocalProcessConnector",
    "RecordingConnector",
    "DecodeInterpolator",
    "PrefillInterpolator",
    "load_profile",
    "save_profile",
    "profile_as_card_dict",
    "interpolators_from_card_dict",
    "make_predictor",
    "ControlLaw",
    "OperatorConfig",
    "SlaAutoscaler",
    "register_planner_metrics",
    "ActionJournal",
    "FleetResize",
    "PoolMove",
    "ReplicaScale",
    "Hold",
    "ScaleActionError",
]
