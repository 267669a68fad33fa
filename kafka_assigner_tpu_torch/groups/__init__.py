"""Consumer-group workload family, the port of the reference's
``kafka_assigner_tpu/groups/``: capacity-constrained partition-to-consumer
packing, as a sticky rebalance plan per group or as the batched autoscale
sweep ("how many consumers at 1x, 1.5x, 2x of today's lag").

- :mod:`.model`  — the synthetic family and the envelope validators;
- :mod:`.encode` — ingest to bucketed int32 packing arrays;
- :mod:`.solve`  — the plan and sweep pipelines (the device path through
  ``parallel/whatif.py``, or the host oracle ``solvers/greedypack.py``).

Surface: ``python -m kafka_assigner_tpu_torch.groups`` (``cli.py:
run_groups``).
"""
from .model import (
    GROUPS_SCHEMA_VERSION,
    synthetic_group_state,
    validate_groups_plan,
    validate_groups_sweep,
)
from .encode import GroupEncoding, encode_group
from .solve import group_plan_envelope, group_sweep_envelope, load_group_states

__all__ = [
    "GROUPS_SCHEMA_VERSION",
    "GroupEncoding",
    "encode_group",
    "group_plan_envelope",
    "group_sweep_envelope",
    "load_group_states",
    "synthetic_group_state",
    "validate_groups_plan",
    "validate_groups_sweep",
]
