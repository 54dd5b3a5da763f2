"""The model stack the LM-loss workload evaluates (copies of the parts of
``repro/models`` that h2o-danube-3 and rwkv6 run), and its sharding rules.

``param_specs`` here is ``sharding.param_specs`` (a ``PartitionSpec`` per
parameter), as in the reference; ``transformer.param_specs`` is the
parameter tree's shapes.  Call each by its module where both are near.
"""
from repro_torch.models.sharding import (  # noqa: F401
    enforce_divisible,
    input_specs,
    mesh_axes,
    param_specs,
    to_named,
)
