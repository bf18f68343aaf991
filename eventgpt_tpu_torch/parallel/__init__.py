"""Parallelism layer: device mesh, sharding rules, distributed bootstrap.

Port of ``eventgpt_tpu/parallel`` over ``torch.distributed``, one rank per
device:

  * :mod:`eventgpt_tpu_torch.parallel.mesh`      -- ``Mesh(data, fsdp, context, model)``
    and its collectives
  * :mod:`eventgpt_tpu_torch.parallel.autograd`  -- the collectives a gradient
    crosses, as autograd Functions (no JAX counterpart: ``jax.grad`` derives them)
  * :mod:`eventgpt_tpu_torch.parallel.sharding`  -- partition spec trees of every
    parameter tree, and the training layout
  * :mod:`eventgpt_tpu_torch.parallel.serving`   -- the serving layout: a rank's
    shard of the tree and of the KV cache
  * :mod:`eventgpt_tpu_torch.parallel.sp_common` -- the sequence-parallel layout
  * :mod:`eventgpt_tpu_torch.parallel.ring`      -- ring attention over ``context``
  * :mod:`eventgpt_tpu_torch.parallel.ulysses`   -- Ulysses all-to-all attention
  * :mod:`eventgpt_tpu_torch.parallel.multiproc` -- the multi-process dry run
  * :mod:`eventgpt_tpu_torch.parallel.dist`      -- the process group's bootstrap
"""

from eventgpt_tpu_torch.parallel.mesh import (AXES, Mesh, best_mesh_config,  # noqa: F401
                                              make_mesh, single_device_mesh)
from eventgpt_tpu_torch.parallel.ring import (dense_reference_attention,  # noqa: F401
                                              ring_attention_shard_map, ring_self_attention)
from eventgpt_tpu_torch.parallel.sharding import (batch_spec,  # noqa: F401
                                                  clip_param_specs, eventchat_param_specs,
                                                  kv_cache_specs, llama_param_specs,
                                                  projector_param_specs, qformer_param_specs,
                                                  shard_frozen, shard_params, shard_trainable,
                                                  trainable_param_specs, vocab_safe_llama_specs)
from eventgpt_tpu_torch.parallel.sp_common import SP_QKV_SPEC, SP_VALID_SPEC  # noqa: F401
from eventgpt_tpu_torch.parallel.ulysses import (ulysses_attention_shard_map,  # noqa: F401
                                                 ulysses_self_attention)
