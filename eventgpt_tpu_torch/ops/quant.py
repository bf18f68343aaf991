"""Weight-only int8 and int4 quantization of the LLaMA matmuls.

Port of ``eventgpt_tpu/ops/quant.py``. Quantized leaves keep
the JAX package's layouts, so the two packages hold the same arrays:

  * int8: ``{"q": (K, N) int8, "s": (1, N) f32}``, symmetric per output
    channel, ``s = max|w| / 127`` over K;
  * int4: ``{"q4": (K/2, N) uint8, "s": (K/G, N) f32}``, symmetric per
    (group of G contraction rows, output channel), ``s = max|w| / 7``.
    Byte ``[r, n]`` holds row ``2r`` in its high nibble and row ``2r+1`` in
    its low nibble, each as offset-binary ``value + 8``.

The port's dense weights are ``nn.Linear``'s (out, in), so the quantizer
reads ``w.T`` = (K, N). ``matmul`` / ``matmul_f32_out`` dispatch on the
leaf: dense, int8 (a library GEMM that keeps the f32 accumulator before the
f32 scale) or int4 (``_matmul4``: the K4 kernel of ``ops/int4_matmul.py``
where its shape gate holds, else the grouped two-plane einsum, as in the
JAX package), or a training-time LoRA composite ``{"w": base, "a": A*scale
(d_in, r), "b": B (r, d_out)}`` (``train/lora.apply_lora``), evaluated as
``x @ w + (drop(x) @ a) @ b``: the factors keep the JAX package's math
layout, the base weight the port's (out, in).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.ops import int4_matmul as i4k

QuantizedLeaf = Dict[str, torch.Tensor]


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def is_quantized4(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q4" in leaf and "s" in leaf


def is_lora(leaf: Any) -> bool:
    """Apply-form LoRA composite leaf: {"w": base, "a": A*scale, "b": B},
    plus {"seed", "dr"} when the adapter branch drops its input (and
    ``dshard``, the (parts, index) of each input dim, on a mesh)."""
    return isinstance(leaf, dict) and "w" in leaf and "a" in leaf and "b" in leaf


def _lora_branch_input(x: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
    """The adapter branch's input: ``x``, or with the leaf's dropout state
    inverted dropout at rate ``dr`` (peft semantics: the base ``x @ w`` is
    never dropped). The mask comes from a generator seeded with the leaf's
    own ``seed``, so a checkpointed layer's recompute draws the mask its
    forward drew."""
    if "seed" not in w:
        return x
    keep = 1.0 - w["dr"]
    g = torch.Generator(device=x.device)
    g.manual_seed(int(w["seed"]))
    shard = w.get("dshard")
    if shard is None:
        mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    else:
        # A rank's block of a mesh-sharded input: the mask is drawn for the
        # global shape ((parts, index) per dim) and the block sliced from it,
        # so the ranks together drop what one device drops.
        whole = torch.rand([n * parts for n, (parts, _) in zip(x.shape, shard)], generator=g,
                           device=x.device)
        for d, (n, (_, index)) in enumerate(zip(x.shape, shard)):
            whole = whole.narrow(d, index * n, n)
        mask = whole < keep
    return torch.where(mask, x / x.new_tensor(keep), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


def _lora_delta(x: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
    """(drop(x) @ a) @ b in x.dtype."""
    xl = _lora_branch_input(x, w)
    return torch.matmul(xl, w["a"].to(x.dtype)) @ w["b"].to(x.dtype)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, on any device. A Python-number divisor would let
    CUDA multiply by its reciprocal instead, which can land one ulp away
    from the CPU's (and numpy's) quotient; the 0-dim device tensor keeps
    the quantized payloads and scales equal on the card and the CPU."""
    return x / x.new_tensor(d)


def quantize_tensor(w: torch.Tensor) -> QuantizedLeaf:
    """(..., K, N) -> int8 payload + (..., 1, N) f32 per-channel scale."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = true_div(amax.clamp_min(1e-8), 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": scale.contiguous()}


def quantize_tensor4(w: torch.Tensor, group: int = 128) -> QuantizedLeaf:
    """(K, N) -> packed (K/2, N) uint8 + (K/G, N) f32 group scales;
    ``group=0`` is one group over all of K."""
    k, n = w.shape[-2], w.shape[-1]
    if group <= 0:
        group = k
    if k % group or group % 2:
        raise ValueError(f"group {group} must be even and divide K={k}")
    w32 = w.float()
    wg = w32.reshape(w32.shape[:-2] + (k // group, group, n))
    amax = wg.abs().amax(dim=-2, keepdim=True)  # (..., K/G, 1, N)
    scale = true_div(amax.clamp_min(1e-8), 7.0)
    q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int32).reshape(w32.shape[:-2] + (k, n))
    even, odd = q[..., 0::2, :] + 8, q[..., 1::2, :] + 8
    packed = ((even << 4) | odd).to(torch.uint8)
    return {"q4": packed.contiguous(), "s": scale[..., 0, :].contiguous()}


def dequantize_tensor(leaf: QuantizedLeaf, dtype=torch.float32) -> torch.Tensor:
    return (leaf["q"].float() * leaf["s"]).to(dtype)


def _unpack4(q4: torch.Tensor) -> tuple:
    """Packed (K/2, N) uint8 -> f32 (hi, lo) planes: hi = even rows."""
    hi = (q4 >> 4).to(torch.int32) - 8
    lo = (q4 & 0xF).to(torch.int32) - 8
    return hi.float(), lo.float()


def dequantize_tensor4(leaf: QuantizedLeaf, dtype=torch.float32) -> torch.Tensor:
    hi, lo = _unpack4(leaf["q4"])
    half_k, n = hi.shape
    k = 2 * half_k
    w = torch.stack([hi, lo], dim=-2).reshape(k, n)
    gc = leaf["s"].shape[-2]
    w = w.reshape(gc, k // gc, n) * leaf["s"][:, None, :]
    return w.reshape(k, n).to(dtype)


def _matmul4(x: torch.Tensor, leaf: QuantizedLeaf) -> torch.Tensor:
    """x (..., K) @ int4 leaf -> (..., N) f32 accumulator.

    Where ``int4_matmul.supported`` holds, K4 runs (x rounded to bf16, as
    the kernel does). Otherwise the grouped two-plane product runs in f32
    on x as given, which is the f32 accumulation of the JAX fallback
    einsum: bf16 x times a small integer is exact in f32.
    """
    q4, s = leaf["q4"], leaf["s"]
    if q4.ndim != 2:
        raise ValueError("int4 matmul expects a per-layer (K/2, N) plane")
    half_k, n = q4.shape
    k = 2 * half_k
    gc = s.shape[-2]
    lead = x.shape[:-1]
    if i4k.supported(k, n, k // gc):
        return i4k.int4_matmul(x.reshape(-1, k).contiguous(), q4, s).reshape(*lead, n)
    hg = half_k // gc  # packed rows per group
    hi, lo = _unpack4(q4)
    xg = x.reshape(-1, gc, hg, 2).float()
    part = torch.einsum("bgk,gkn->bgn", xg[..., 0], hi.reshape(gc, hg, n))
    part = part + torch.einsum("bgk,gkn->bgn", xg[..., 1], lo.reshape(gc, hg, n))
    y = torch.einsum("bgn,gn->bn", part, s)
    return y.reshape(*lead, n)


def int8_gemm_form(x: torch.Tensor) -> str:
    """Which GEMM ``_matmul8_f32`` runs for ``x``: on a card with 16-bit x
    and a torch that has ``mm(..., out_dtype=)``, one bf16/f16 GEMM with an
    f32 output; otherwise the product of the f32-upcast operands (exact
    products, the same f32 accumulator)."""
    if (x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16)
            and "dtype" in torch.ops.aten.mm.overloads()):
        return "mm_out_dtype_f32"
    return "f32_upcast"


def _matmul8_f32(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ int8 (K, N) as the f32 accumulator of the x.dtype
    product, before the per-channel scale."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if int8_gemm_form(x) == "mm_out_dtype_f32":
        y = torch.mm(x2, q.to(x.dtype), out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), q.float())
    return y.reshape(*lead, q.shape[-1])


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a dense (out, in) weight or a quantized leaf, in x.dtype.
    Quantized products keep the f32 accumulator and round once, after the
    f32 scale. A LoRA composite adds its delta to the base product."""
    if is_lora(w):
        return matmul(x, w["w"]) + _lora_delta(x, w)
    if is_quantized4(w):
        return _matmul4(x, w).to(x.dtype)
    if is_quantized(w):
        return (_matmul8_f32(x, w["q"]) * w["s"]).to(x.dtype)
    return F.linear(x, w)


def matmul_f32_out(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Like ``matmul`` but returns the f32 accumulator (lm_head logits).
    For a dense weight that is the product of the f32-upcast operands:
    bf16 products are exact in f32. A LoRA composite adds its x.dtype delta
    in f32."""
    if is_lora(w):
        return matmul_f32_out(x, w["w"]) + _lora_delta(x, w).float()
    if is_quantized4(w):
        return _matmul4(x, w)
    if is_quantized(w):
        return _matmul8_f32(x, w["q"]) * w["s"]
    return F.linear(x.float(), w.float())


_LAYER_WEIGHTS = ("q_proj", "k_proj", "v_proj", "qkv_proj", "o_proj",
                  "gate_proj", "up_proj", "gate_up_proj", "down_proj")


def quantize_llama_params(params: Dict[str, Any], bits: int = 8,
                          group: int = 128) -> Dict[str, Any]:
    """Quantize every LLaMA matmul weight, lm_head included; embeddings and
    norms stay as they are. ``bits=4`` selects the packed group-wise
    scheme; a leaf whose K is not a multiple of ``group`` takes one group
    over all of K (the JAX package's per-leaf group clamp).

    Works on the tensors' own device and **replaces the leaves of
    ``params`` in place**, one at a time, so that the full-precision leaf
    is dropped as soon as its quantized form exists: on the card a 7B tree
    never holds two full copies. Pass a ``llama.copy_tree`` of the tree to
    keep the original. Returns ``params``.
    """
    if bits == 4:
        def qt(w):
            k = w.shape[-1]  # (out, in): K is the in axis
            g = group if group > 0 and k % group == 0 else k
            return quantize_tensor4(w.T, g)
    elif bits == 8:
        def qt(w):
            return quantize_tensor(w.T)
    else:
        raise ValueError(f"unsupported bits={bits} (4 or 8)")
    for layer in params["layers"]:
        for name in _LAYER_WEIGHTS:
            if name in layer:
                layer[name] = qt(layer[name])
    params["lm_head"] = qt(params["lm_head"])
    return params


def dequantize_llama_params(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """A new tree with every quantized leaf dequantized to a dense (out, in)
    weight in ``dtype``; other leaves are shared with ``params``."""
    def dq(leaf):
        if is_quantized4(leaf):
            return dequantize_tensor4(leaf, dtype).T.contiguous()
        if is_quantized(leaf):
            return dequantize_tensor(leaf, dtype).T.contiguous()
        return leaf

    return {**params,
            "layers": [{k: dq(v) for k, v in layer.items()} for layer in params["layers"]],
            "lm_head": dq(params["lm_head"])}
