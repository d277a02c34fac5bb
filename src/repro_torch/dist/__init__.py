"""Distribution layer of the port (``repro.dist``): logical-axis sharding
rules, the train and serve step builders on a device or a DeviceMesh, fault
tolerance, and elastic resharding.

  - :mod:`repro_torch.dist.sharding`: logical axis name -> mesh axis rules
    per (arch, mode), specs with divisibility fallbacks, DTensor placements.
  - :mod:`repro_torch.dist.step`: ``make_train_step`` / ``make_serve_fns``,
    and placing a train or serve state on a mesh.
  - :mod:`repro_torch.dist.comm`: a mesh's process groups, its collectives,
    the tensor-parallel autograd functions the model code uses, and the
    flash-decoding merge of partial attention across ranks.
  - :mod:`repro_torch.dist.ft`: heartbeat-based fault tolerance.
  - :mod:`repro_torch.dist.elastic`: reshard a train state onto a new mesh.
  - :mod:`repro_torch.dist.spawn`: run a function on N spawned ranks.
"""

from .elastic import reshard_state
from .ft import FaultToleranceManager, SimulatedFailure
from .sharding import cache_logical_axes, make_rules, pspec_for_axes, shardings_for
from .step import (
    make_batch_specs,
    make_serve_fns,
    make_train_state_specs,
    make_train_step,
    param_specs,
    place_serve_params,
    placed_serve_state,
)

__all__ = [
    "reshard_state",
    "FaultToleranceManager", "SimulatedFailure",
    "cache_logical_axes", "make_rules", "pspec_for_axes", "shardings_for",
    "make_batch_specs", "make_serve_fns", "make_train_state_specs",
    "make_train_step", "param_specs", "place_serve_params", "placed_serve_state",
]
