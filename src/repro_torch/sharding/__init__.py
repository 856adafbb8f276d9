"""Sharding rules (logical axes to mesh axes, ``PartitionSpec``) and the
column groups of the tensor-parallel step."""
from .rules import (RULES_A, RULES_B, RULES_B2, RULES_B3,  # noqa: F401
                    RULES_SERVE, RULES_SERVE_2D, P, PartitionSpec,
                    ShardingStrategy, cuts_data, model_sharded_dims,
                    pod_specs, shapes_and_axes,
                    spec_for_leaf, specs_for_tree, stack_shapes)
