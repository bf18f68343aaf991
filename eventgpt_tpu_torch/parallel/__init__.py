"""Parallelism layer: device mesh, sharding rules, distributed bootstrap.

Port of ``eventgpt_tpu/parallel``'s serving half over ``torch.distributed``,
one rank per device:

  * :mod:`eventgpt_tpu_torch.parallel.mesh`     -- ``Mesh(data, fsdp, context, model)``
    and its collectives
  * :mod:`eventgpt_tpu_torch.parallel.sharding` -- partition spec trees of every
    parameter tree
  * :mod:`eventgpt_tpu_torch.parallel.serving`  -- the serving layout: a rank's
    shard of the tree and of the KV cache
  * :mod:`eventgpt_tpu_torch.parallel.dist`     -- the process group's bootstrap

The training mesh, ring and Ulysses attention and the multi-process dry
run are not ported yet.
"""

from eventgpt_tpu_torch.parallel.mesh import (AXES, Mesh, best_mesh_config,  # noqa: F401
                                              make_mesh, single_device_mesh)
from eventgpt_tpu_torch.parallel.sharding import (batch_spec,  # noqa: F401
                                                  clip_param_specs, eventchat_param_specs,
                                                  kv_cache_specs, llama_param_specs,
                                                  projector_param_specs, qformer_param_specs,
                                                  shard_params)
