"""The model stack (copies of ``repro/models``), its training and serving
steps and its sharding rules.

``param_specs`` here is ``sharding.param_specs`` (a ``PartitionSpec`` per
parameter), as in the reference; ``transformer.param_specs`` is the
parameter tree's shapes.  Call each by its module where both are near.
"""
from repro_torch.models.transformer import (  # noqa: F401
    NULL_CTX,
    ShardCtx,
    count_params,
    find_segments,
    forward,
    head_weight,
    init_cache,
    init_params,
    layer_sigs,
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.sharding import (  # noqa: F401
    cache_specs,
    enforce_divisible,
    input_specs,
    mesh_axes,
    param_specs,
    to_named,
)
