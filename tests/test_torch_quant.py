"""The port's quantized path against the JAX package, at f32 on the CPU.

Weight-only int8 and int4 quantization (``ops/quant.py``), the int4 matmul
K4 and the int8 decode attention K2 through their plain versions, fused
q|k|v and gate|up weights, the int8 KV cache, and the quantized one-shot
``generate`` and CLI. Inputs come from numpy seeds; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do, and computes at
``highest`` matmul precision (pinned by conftest).

Tolerances, stated where they are used:
- quantized payloads are equal exactly; scales to rtol 1e-6, the JAX
  package's own host-vs-device bar (tests/test_quant.py);
- products and logits are f32 sums of the same terms in another order:
  atol 1e-4 on values of order 1 (tests/test_torch_models.py's bar);
- int4 logits at K4's widths: K4 rounds its input to bf16, in both
  packages. Where an f32 activation differs in its last bit between them
  (summation order), that rounding can land one bf16 step (2^-8) apart;
  through two layers this moves logits by ~1e-2 (1.1e-2 measured, nine
  such activations in one row of fused_int4's first layer), so atol 3e-2;
- K2 against the JAX kernel: the same arithmetic, whose bf16 rounding of
  p * v_s can flip where exp differs in its last bit: 2^-8 of one slot's
  share, so atol 2e-3; against the f32 dequantize-then-attend reference
  the JAX package's own 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import llama as jllama
from eventgpt_tpu.ops import quant as jquant
from eventgpt_tpu.ops.decode_attention import (
    decode_attention_int8 as j_decode,
    decode_attention_int8_reference as j_decode_ref,
)
from eventgpt_tpu.ops.int4_matmul import int4_matmul as j_int4, supported as j_supported
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import llama_params_from_jax, params_from_jax
from eventgpt_tpu_torch.ops import decode_attention as tda
from eventgpt_tpu_torch.ops import int4_matmul as ti4
from eventgpt_tpu_torch.ops import quant as tquant
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

ATOL = 1e-4
CPU = torch.device("cpu")

# A LLaMA whose widths pass K4's gate for q, o, gate|up, down, lm_head and
# the fused q|k|v (N = 512), while k and v (N = 128) take the fallback.
_ALIGNED = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                num_heads=4, num_kv_heads=2, max_seq_len=256)
J_AL, T_AL = jcfg.LlamaConfig(**_ALIGNED), tcfg.LlamaConfig(**_ALIGNED)
# LlamaConfig.tiny: K = 64 / 128, below the default group -> the group clamp.
J_TINY, T_TINY = jcfg.LlamaConfig.tiny(), tcfg.LlamaConfig.tiny()
LM_CONFIGS = {"aligned": (J_AL, T_AL), "tiny": (J_TINY, T_TINY)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm_trees():
    """Per LM config: the JAX package's f32 parameters as numpy."""
    return {name: _np_tree(jllama.init_llama_params(jc, jax.random.PRNGKey(3)))
            for name, (jc, _) in LM_CONFIGS.items()}


def _port(jtree, tc):
    return llama_params_from_jax(jtree, tc, torch.float32, CPU)


def _assert_leaf_equal(t_leaf, j_leaf):
    if isinstance(j_leaf, dict):
        assert set(t_leaf) == set(j_leaf)
        for key, val in j_leaf.items():
            if key == "s":
                np.testing.assert_allclose(t_leaf[key].numpy(), np.asarray(val), rtol=1e-6, atol=0)
            else:
                assert t_leaf[key].dtype == torch.from_numpy(np.array(val)).dtype
                np.testing.assert_array_equal(t_leaf[key].numpy(), np.asarray(val))
    else:
        np.testing.assert_array_equal(t_leaf.numpy(), np.asarray(j_leaf))


def _assert_trees_equal(got, want):
    assert len(got["layers"]) == len(want["layers"])
    for t_layer, j_layer in zip(got["layers"], want["layers"]):
        assert set(t_layer) == set(j_layer)
        for name in t_layer:
            _assert_leaf_equal(t_layer[name], j_layer[name])
    _assert_leaf_equal(got["lm_head"], want["lm_head"])


@pytest.mark.parametrize("lm", ["aligned", "tiny"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fuse", [False, True])
def test_quantization_equals_jax_host(lm_trees, lm, bits, fuse):
    """quantize(convert(w)) in the port == convert(JAX host quantize(w)):
    the same payloads, the same scales, the layouts of the JAX package.
    Fused: the port's in-place fuse == the conversion of JAX's fused tree."""
    jc, tc = LM_CONFIGS[lm]
    jtree = lm_trees[lm]
    if fuse:
        jtree = jllama.fuse_llama_params(jtree)
        unfused = tllama.fuse_llama_params(_port(lm_trees[lm], tc))
        _assert_trees_equal(unfused, _port(jtree, tc))
    got = tquant.quantize_llama_params(_port(jtree, tc), bits=bits)
    want = _port(jquant.quantize_llama_params(jtree, host=True, bits=bits), tc)
    _assert_trees_equal(got, want)
    leaf = got["layers"][0]["o_proj"]
    assert (tquant.is_quantized4 if bits == 4 else tquant.is_quantized)(leaf)
    if bits == 4:
        # The group clamp: tiny's K = 64 takes one group over all of K.
        assert leaf["s"].shape[0] == (2 if lm == "aligned" else 1)
        deq = tquant.dequantize_tensor4(leaf)
        j_leaf = jquant.quantize_llama_params(jtree, host=True, bits=4)["layers"]["attn"]["o"]
        j_deq = jquant.dequantize_tensor4({k: v[0] for k, v in j_leaf.items()})
        np.testing.assert_array_equal(deq.numpy(), np.asarray(j_deq))


def test_copy_tree_keeps_the_original(lm_trees):
    tp = _port(lm_trees["aligned"], T_AL)
    q = tquant.quantize_llama_params(tllama.fuse_llama_params(tllama.copy_tree(tp)), bits=4)
    assert "q_proj" in tp["layers"][0] and torch.is_tensor(tp["lm_head"])
    assert "qkv_proj" in q["layers"][0] and tquant.is_quantized4(q["lm_head"])


@pytest.mark.parametrize("m", [1, 4, 37])
def test_int4_plain_matches_jax_kernel(m):
    """K4's plain version against the JAX Pallas kernel in interpret mode,
    at an aligned shape; both round x to bf16 first. Outputs are O(30):
    atol 1e-4 with rtol 1e-5 for the f32 summation order."""
    k, n, group = 512, 256, 128
    assert j_supported(k, n, group) and ti4.supported(k, n, group)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    leaf = jquant.quantize_tensor4_host(rng.standard_normal((k, n)).astype(np.float32), group)
    want = np.asarray(j_int4(jnp.asarray(x), jnp.asarray(leaf["q4"]), jnp.asarray(leaf["s"])))
    got = ti4.int4_matmul(torch.from_numpy(x), torch.from_numpy(leaf["q4"]),
                          torch.from_numpy(leaf["s"]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_int4_shape_gate_is_the_jax_gate():
    for k, n, group in [(4096, 11008, 128), (11008, 4096, 128), (4096, 32000, 128),
                        (4096, 12288, 128), (4096, 22016, 128), (64, 64, 64),
                        (4096, 100, 128), (512, 256, 8), (512, 256, 512), (258, 256, 2)]:
        assert ti4.supported(k, n, group) == j_supported(k, n, group)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("k,n", [(512, 256), (64, 48)])  # K4's gate / the fallback
def test_quant_matmul_matches_jax(kind, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    j_leaf = (jquant.quantize_tensor_host(w) if kind == "int8"
              else jquant.quantize_tensor4_host(w, 64))
    t_leaf = {key: torch.from_numpy(np.asarray(v)) for key, v in j_leaf.items()}
    xt = torch.from_numpy(x)
    for t_fn, j_fn in ((tquant.matmul, jquant.matmul),
                       (tquant.matmul_f32_out, jquant.matmul_f32_out)):
        got = t_fn(xt, t_leaf)
        assert got.dtype == torch.float32 and got.shape == (2, 3, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_fn(jnp.asarray(x), j_leaf)),
                                   atol=ATOL, rtol=1e-5)
    # A bf16 x: the f32 accumulator keeps its exact products.
    xb = xt.to(torch.bfloat16)
    want = np.asarray(jquant.matmul_f32_out(jnp.asarray(xb.float().numpy(), jnp.bfloat16), j_leaf))
    np.testing.assert_allclose(tquant.matmul_f32_out(xb, t_leaf).numpy(), want,
                               atol=ATOL, rtol=1e-5)
    assert tquant.int8_gemm_form(xb) == "f32_upcast"


def _decode_case(L=3, B=2, S=128, KV=4, G=2, hd=64, seed=0):
    """The inputs of tests/test_decode_attention.py::_case."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, KV, G, hd)).astype(np.float32),
            rng.integers(-127, 128, (L, B, S, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, B, S, KV, 1)).astype(np.float32),
            rng.integers(-127, 128, (L, B, S, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, B, S, KV, 1)).astype(np.float32))


@pytest.mark.parametrize("case,li,n_valid", [
    (dict(), 0, [37, 100]),
    (dict(), 2, [37, 100]),
    (dict(KV=4, G=1), 1, [5, 128]),            # KV below 8: the whole axis in one block
    (dict(KV=16, G=2, S=64, hd=32), 1, [20, 64]),  # a multi-block grid
])
def test_decode_plain_matches_jax(case, li, n_valid):
    arrays = _decode_case(**case)
    nv = np.asarray(n_valid, np.int32)
    got = tda.decode_attention_int8(*map(torch.from_numpy, arrays), li, torch.from_numpy(nv))
    jarr = [jnp.asarray(a) for a in arrays]
    want = np.asarray(j_decode(*jarr, li, jnp.asarray(nv)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)
    ref = np.asarray(j_decode_ref(*jarr, li, jnp.asarray(nv)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=2e-2)


def test_decode_plain_masks_stale_slots():
    q, kq, ks, vq, vs = map(torch.from_numpy, _decode_case(B=1))
    nv = torch.tensor([40], dtype=torch.int32)
    out = tda.decode_attention_int8_plain(q, kq, ks, vq, vs, 0, nv)
    kq[:, :, 40:] = 127
    vs[:, :, 40:] = 1e3
    torch.testing.assert_close(tda.decode_attention_int8_plain(q, kq, ks, vq, vs, 0, nv), out,
                               rtol=0, atol=0)


# Variants of the LLaMA tree and cache: (fuse, bits, int8 KV cache).
VARIANTS = {
    "int8": (False, 8, False),
    "int4": (False, 4, False),
    "fused": (True, None, False),
    "fused_int8": (True, 8, False),
    "fused_int4": (True, 4, False),
    "kv_int8": (False, None, True),
}


def _variant_trees(jtree, tc, fuse, bits):
    if fuse:
        jtree = jllama.fuse_llama_params(jtree)
    if bits:
        jtree = jquant.quantize_llama_params(jtree, host=True, bits=bits)
    tp = _port(jtree, tc)
    return jtree, tp


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_llama_logits_match_jax(lm_trees, variant):
    """Prefill and decode-step f32 logits at the aligned widths, where K4
    (through its plain version here) carries the int4 products."""
    fuse, bits, kv_quant = VARIANTS[variant]
    atol = 3e-2 if bits == 4 else ATOL  # int4: bf16 rounding of K4's input (module doc)
    jp, tp = _variant_trees(lm_trees["aligned"], T_AL, fuse, bits)
    rng = np.random.default_rng(7)
    b, t, max_len = 2, 24, 32
    embeds = (rng.standard_normal((b, t, 256)) * 0.5).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [17]])
    j_cache = jllama.init_kv_cache(J_AL, b, max_len, dtype=jnp.float32, quant=kv_quant)
    j_logits, j_cache = jllama.prefill(jp, J_AL, jnp.asarray(embeds), jnp.asarray(mask), j_cache,
                                       last_only=True)
    t_cache = tllama.init_kv_cache(T_AL, b, max_len, dtype=torch.float32, quant=kv_quant)
    t_logits, t_cache = tllama.prefill(tp, T_AL, torch.from_numpy(embeds), torch.from_numpy(mask),
                                       t_cache, last_only=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=atol, rtol=1e-4)
    if kv_quant:
        _assert_leaf_equal(t_cache["k"], {"q": j_cache["k"]["q"], "s": j_cache["k"]["s"]})
    tok = rng.standard_normal((b, 1, 256)).astype(np.float32)
    for _ in range(2):
        j_step, j_cache = jllama.decode_step(jp, J_AL, jnp.asarray(tok), j_cache)
        t_step, t_cache = tllama.decode_step(tp, T_AL, torch.from_numpy(tok), t_cache)
        np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), atol=atol, rtol=1e-4)
        tok = tok[::-1].copy()
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(j_cache["length"]))


def _chat_configs(aligned: bool):
    jc, tc = jcfg.EventChatConfig.tiny(vocab_size=128), tcfg.EventChatConfig.tiny(vocab_size=128)
    if aligned:
        jc = dataclasses.replace(jc, llama=J_AL,
                                 projector=dataclasses.replace(jc.projector, output_dim=256))
        tc = dataclasses.replace(tc, llama=T_AL,
                                 projector=dataclasses.replace(tc.projector, output_dim=256))
    return jc, tc


@pytest.mark.parametrize("aligned,fuse,bits,kv_quant", [
    (True, False, 4, True),   # int4 + int8 KV cache at K4's widths
    (False, True, 8, False),  # int8 + fused on EventChatConfig.tiny
])
def test_quantized_greedy_chains_token_identical(aligned, fuse, bits, kv_quant):
    jc, tc = _chat_configs(aligned)
    jp = _np_tree(jchat.init_eventchat_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, tc, torch.float32, CPU)
    jp["llama"], _ = _variant_trees(jp["llama"], tc.llama, fuse, bits)
    if fuse:
        tllama.fuse_llama_params(tp["llama"])
    tquant.quantize_llama_params(tp["llama"], bits=bits)
    rng = np.random.default_rng(1)
    size = jc.vision.image_size
    pixels = rng.standard_normal((2, jc.num_event_frames, 3, size, size)).astype(np.float32)
    ids = [rng.integers(3, 128, 4).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 3).tolist(),
           rng.integers(3, 128, 9).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 6).tolist()]
    kwargs = dict(max_new_tokens=8, temperature=0.0, eos_token_id=None, kv_quant=kv_quant)
    want = jchat.generate(jp, jc, ids, pixels, **kwargs)
    got = tchat.generate(tp, tc, ids, pixels, device="cpu", **kwargs)
    assert got == want and all(len(row) == 8 for row in got)


@pytest.fixture(scope="module")
def event_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("quant_cli") / "events.npy")
    np.save(path, synthetic_event_stream(7, n_events=20_000))
    return path


def test_cli_runs_the_quantized_path_on_the_cpu(event_path):
    out = infer.main(["--model_path", "tiny-random", "--event_frame", event_path,
                      "--query", "What is happening?", "--device", "cpu", "--temperature", "0",
                      "--max_new_tokens", "4", "--quant", "int4", "--kv_cache", "int8",
                      "--fuse_params"])
    assert isinstance(out, str)
    out8 = infer.main(["--model_path", "tiny-random", "--event_frame", event_path,
                       "--query", "q", "--device", "cpu", "--max_new_tokens", "2",
                       "--quant", "int8"])
    assert isinstance(out8, str)


@pytest.mark.parametrize("flags,match", [
    (["--mesh_model", "2"], "mesh"),
    (["--mesh_fsdp", "2"], "mesh"),
])
def test_cli_still_refuses_unported_flags(event_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        infer.main(["--model_path", "tiny-random", "--event_frame", event_path, "--query", "q",
                    "--device", "cpu", "--quant", "int4", *flags])


@pytest.mark.parametrize("variant", ["speculative", "draft_head_alone", "beam"])
def test_cli_decoding_variants_on_the_quantized_path(event_path, variant):
    """--quant int4: speculation prints the greedy answer, --draft_head
    without --speculative is the JAX CLI's ValueError, beam search runs."""
    common = ["--model_path", "tiny-random", "--event_frame", event_path, "--query", "q",
              "--device", "cpu", "--quant", "int4", "--temperature", "0",
              "--max_new_tokens", "6"]
    if variant == "speculative":
        assert infer.main(common + ["--speculative", "4"]) == infer.main(common)
    elif variant == "draft_head_alone":
        with pytest.raises(ValueError, match="--speculative"):
            infer.main(common + ["--draft_head", "heads.npz"])
    else:
        assert isinstance(infer.main(common + ["--num_beams", "2"]), str)


def test_cli_quantized_path_wants_a_card_by_default(event_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--model_path", "tiny-random", "--event_frame", event_path, "--query", "q",
                    "--quant", "int4", "--kv_cache", "int8", "--fuse_params"])
