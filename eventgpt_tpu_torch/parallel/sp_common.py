"""The layout both sequence-parallel attention modes (ring, Ulysses) take.

Port of ``eventgpt_tpu/parallel/sp_common.py``: the specs of the arrays
their callables receive, one place for both so that a mesh-axis change
cannot desynchronize them. In the port a spec says which block of the
global array a rank holds (``parallel/sharding.local_slice``).
"""

from eventgpt_tpu_torch.parallel.sharding import P

# q/k/v (B, S, H, hd): batch over (data, fsdp), sequence over context,
# heads over model.
SP_QKV_SPEC = P(("data", "fsdp"), "context", "model", None)
# validity masks (B, S).
SP_VALID_SPEC = P(("data", "fsdp"), "context")
