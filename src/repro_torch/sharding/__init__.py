"""Partitioning specs for the production meshes (DESIGN.md §2)."""
from repro_torch.sharding.partitioning import (batch_specs, cache_specs,
                                               dp_axes, fwd_param_specs,
                                               master_param_specs,
                                               opt_state_specs)
