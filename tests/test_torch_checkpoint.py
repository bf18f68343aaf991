"""Checkpoints in the PyTorch port against the JAX package.

- The safetensors format: files of the ``safetensors`` package read equal
  through the port's own reader, and the port's files read equal through
  ``safetensors.safe_open`` (the test may import the package; the port may
  not). Exact: the bytes are the same.
- The config: ``from_hf_config``, the presets and the JSON round trip give
  the JAX package's ``to_dict`` (without the fields the port does not
  carry: ``hidden_act`` and ``max_event_stream_us``).
- Loading: a directory written by the JAX ``write_hf_checkpoint`` loads in
  the port to exactly ``params_from_jax(eventchat_params_from_hf(
  load_state_dict(dir)))``, and a directory the port writes loads in the
  JAX package to exactly the tree it came from, with an equal
  ``config.json``.
- The CLIs: the port's ``cli.infer`` and ``cli.serve`` engine print the JAX
  ``cli.infer``'s answer on the same directory (f32, greedy; equal strings).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import save_file as st_save_torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.cli import infer as jinfer
from eventgpt_tpu.models import convert as jconv
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer as tinfer
from eventgpt_tpu_torch.cli import serve as tserve
from eventgpt_tpu_torch.models import _safetensors
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.models.llama import fuse_llama_params
from eventgpt_tpu_torch.ops.image import process_event_file
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

# vocab 259 is the bare byte tokenizer's size, so registering <ev_patch>
# takes the resize path too.
JCFG = jcfg.EventChatConfig.tiny(vocab_size=259)
TCFG = tcfg.EventChatConfig.tiny(vocab_size=259)
# Fields of the JAX config that the port does not carry: two that neither
# package reads.
_NOT_CARRIED = {"vision": ("hidden_act",)}


def _jax_dict(cfg):
    d = jcfg.to_dict(cfg)
    d.pop("max_event_stream_us")
    for part, keys in _NOT_CARRIED.items():
        for k in keys:
            d[part].pop(k)
    return d


def assert_trees_equal(a, b, path="params"):
    """Same structure, dtypes, shapes and values, leaf for leaf."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), path


# -- the safetensors format -------------------------------------------------

def _every_dtype():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(7, generator=g).half(),
        "f32": torch.randn(2, 3, 4, generator=g),
        "f64": torch.randn(3, generator=g).double(),
        "i8": torch.randint(-128, 128, (5,), generator=g).to(torch.int8),
        "u8": torch.randint(0, 256, (9,), generator=g).to(torch.uint8),
        "i32": torch.randint(-2**31, 2**31 - 1, (4,), generator=g).int(),
        "i64": torch.randint(-2**62, 2**62, (3, 1), generator=g),
        "bool": torch.rand(5, generator=g) > 0.5,
        "scalar": torch.tensor(3.25),
        "empty": torch.zeros(0, 4),
    }


def test_port_reads_the_packages_files(tmp_path):
    ts = _every_dtype()
    path = str(tmp_path / "pkg.safetensors")
    st_save_torch(ts, path, metadata={"format": "pt", "note": "x"})
    got = _safetensors.load_file(path, "cpu")
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape and torch.equal(got[k], t), k
    header, _ = _safetensors.read_header(path)
    assert header["__metadata__"] == {"format": "pt", "note": "x"}
    # numpy-written files too (no bf16 there).
    arrays = {k: t.numpy() for k, t in ts.items() if t.dtype != torch.bfloat16}
    st_save_numpy(arrays, str(tmp_path / "np.safetensors"))
    got = _safetensors.load_file(str(tmp_path / "np.safetensors"), "cpu")
    for k, a in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), a)


def test_package_reads_the_ports_files(tmp_path):
    ts = _every_dtype()
    path = str(tmp_path / "port.safetensors")
    assert _safetensors.save_file(ts, path, metadata={"format": "pt"}) == sum(
        t.numel() * t.element_size() for t in ts.values())
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert set(f.keys()) == set(ts)
        for k, t in ts.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and got.shape == t.shape and torch.equal(got, t), k
    # The data section starts 8-aligned and every tensor on a multiple of
    # its element size, back to back.
    header, start = _safetensors.read_header(path)
    assert start % 8 == 0
    spans = sorted((v["data_offsets"], k) for k, v in header.items() if k != "__metadata__")
    end = 0
    for (b, e), k in spans:
        assert b == end and b % ts[k].element_size() == 0, k
        end = e


def test_reader_casts_floats_only_and_refuses_bad_files(tmp_path):
    ts = _every_dtype()
    path = str(tmp_path / "a.safetensors")
    _safetensors.save_file(ts, path)
    got = _safetensors.load_file(path, "cpu", torch.bfloat16)
    for k, t in ts.items():
        want = torch.bfloat16 if t.is_floating_point() else t.dtype
        assert got[k].dtype == want and torch.equal(got[k], t.to(want)), k
    bad = str(tmp_path / "bad.safetensors")
    with open(bad, "wb") as f:
        f.write((10**9).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="past the end"):
        _safetensors.load_file(bad, "cpu")


# -- the config -------------------------------------------------------------

HF_DICTS = {
    "empty": {},
    "eventgpt_7b": {"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
                    "num_attention_heads": 32, "max_position_embeddings": 2048,
                    "event_feature_adaptor": True, "mm_use_im_patch_token": True},
    "adaptor_key_false": {"event_feature_adaptor": False, "use_event_qformer": False},
    "qformer_on": {"use_event_qformer": True, "hidden_size": 5120,
                   "qformer_config": {"num_queries": 16, "num_heads": 4, "hidden_size": 7,
                                      "foreign": 1}},
    "qformer_value_false": {"use_event_qformer": 0, "qformer_config": {"num_layers": 3}},
    "foreign_vision_keys": {"vision_config": {"hidden_size": 32, "num_layers": 2,
                                              "model_type": "clip_vision_model",
                                              "projection_dim": 768}},
    "long_context": {"max_position_embeddings": 16384, "num_key_value_heads": 8,
                     "tie_word_embeddings": True, "rope_theta": 5e5,
                     "spatial_temporal_encoder": False, "mm_projector_depth": 3,
                     "mm_use_im_start_end": True},
}


@pytest.mark.parametrize("name", sorted(HF_DICTS))
@pytest.mark.parametrize("attn_impl", ["flash", "dense", None])
def test_from_hf_config_matches_jax(name, attn_impl):
    hf = HF_DICTS[name]
    # attn_impl None resolves by platform in JAX (dense off a TPU) and by
    # device in the port (dense on the cpu).
    got = tcfg.from_hf_config(hf, attn_impl=attn_impl, device="cpu")
    assert tcfg.to_dict(got) == _jax_dict(jcfg.from_hf_config(hf, attn_impl=attn_impl))


def test_default_attn_impl_is_flash_on_the_card():
    assert tcfg.default_attn_impl("cuda") == "flash"
    assert tcfg.default_attn_impl(torch.device("cuda", 0)) == "flash"
    assert tcfg.default_attn_impl("cpu") == "dense"
    assert tcfg.from_hf_config({}).llama.attn_impl == "flash"


@pytest.mark.parametrize("preset", ["eventgpt_7b", "eventgpt_13b", "tiny"])
def test_presets_and_json_round_trip_match_jax(preset, tmp_path):
    ours, theirs = getattr(tcfg.EventChatConfig, preset)(), getattr(jcfg.EventChatConfig, preset)()
    assert tcfg.to_dict(ours) == _jax_dict(theirs)
    ours = dataclasses.replace(ours, use_event_qformer=True)
    theirs = dataclasses.replace(theirs, use_event_qformer=True)
    tcfg.save_config(ours, str(tmp_path / "port.json"))
    jcfg.save_config(theirs, str(tmp_path / "jax.json"))
    assert tcfg.load_config(str(tmp_path / "port.json")) == ours
    assert tcfg.load_config(str(tmp_path / "jax.json")) == ours
    assert jcfg.load_config(str(tmp_path / "port.json")) == theirs
    assert ours.num_event_tokens == theirs.num_event_tokens == 32


# -- loading and writing ----------------------------------------------------

def _jax_params(cfg, seed):
    return jax.tree_util.tree_map(np.asarray,
                                  jchat.init_eventchat_params(cfg, jax.random.PRNGKey(seed)))


def _write_jax_checkpoint(d, kind):
    """A directory in one of the layouts a user can hold: the JAX
    package's sharded safetensors, pytorch_model*.bin, a tied checkpoint
    with no lm_head, or one without the feature adaptor."""
    cfg = JCFG
    if kind == "no_adaptor":
        cfg = dataclasses.replace(cfg, projector=dataclasses.replace(cfg.projector,
                                                                     use_feature_adaptor=False))
    params = _jax_params(cfg, 7)
    jconv.write_hf_checkpoint(params, cfg, d, num_shards=3)
    if kind in ("bin", "tied"):
        sd = jconv.load_state_dict(d)
        for name in os.listdir(d):
            if name.endswith((".safetensors", ".index.json")):
                os.remove(os.path.join(d, name))
        with open(os.path.join(d, "config.json")) as f:
            hf = json.load(f)
        if kind == "bin":
            keys = sorted(sd)
            for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
                torch.save({k: torch.from_numpy(np.array(sd[k])) for k in part},
                           os.path.join(d, f"pytorch_model-0000{i + 1}-of-00002.bin"))
        else:
            sd.pop("lm_head.weight")
            st_save_numpy(sd, os.path.join(d, "model.safetensors"))
            hf["tie_word_embeddings"] = True
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
    return d


@pytest.mark.parametrize("kind", ["safetensors", "bin", "tied", "no_adaptor"])
def test_port_loads_jax_checkpoints(kind, tmp_path):
    d = _write_jax_checkpoint(str(tmp_path / kind), kind)
    cfg, params, tok = tinfer.load_model(d, "float32", tokenizer_path="byte", device="cpu")
    with open(os.path.join(d, "config.json")) as f:
        jc = jcfg.from_hf_config(json.load(f), attn_impl="dense")
    assert tcfg.to_dict(cfg) == _jax_dict(jc)
    want = tconv.params_from_jax(jconv.eventchat_params_from_hf(jconv.load_state_dict(d), jc),
                                 cfg, torch.float32, "cpu")
    assert_trees_equal(params, want)
    assert ("adaptor" in params["projector"]) == (kind != "no_adaptor")
    lm = params["llama"]
    if kind == "tied":
        assert cfg.llama.tie_word_embeddings
        assert torch.equal(lm["lm_head"], lm["embed_tokens"])
    # Every leaf owns its storage: in-place preparation cannot corrupt another.
    assert lm["lm_head"].untyped_storage().data_ptr() != lm["embed_tokens"].untyped_storage().data_ptr()
    # bf16 loads cast every float leaf on the way in.
    _, p16, _ = tinfer.load_model(d, "bfloat16", tokenizer_path="byte", device="cpu")
    assert p16["llama"]["layers"][1]["down_proj"].dtype == torch.bfloat16
    assert torch.equal(p16["clip"]["patch_embedding"], want["clip"]["patch_embedding"].bfloat16())


@pytest.mark.parametrize("kind", ["plain", "no_adaptor", "tied"])
def test_jax_loads_port_checkpoints(kind, tmp_path):
    cfg = JCFG
    if kind == "no_adaptor":
        cfg = dataclasses.replace(cfg, projector=dataclasses.replace(cfg.projector,
                                                                     use_feature_adaptor=False))
    if kind == "tied":
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama,
                                                                 tie_word_embeddings=True))
    jp = _jax_params(cfg, 8)
    tc = tcfg.event_chat_config_from_dict(jcfg.to_dict(cfg))
    tp = tconv.params_from_jax(jp, tc, torch.float32, "cpu")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    tconv.write_hf_checkpoint(tp, tc, ours, num_shards=2)
    jconv.write_hf_checkpoint(jp, cfg, theirs, num_shards=2)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in ("config.json", "model.safetensors.index.json"):
        with open(os.path.join(ours, name)) as f, open(os.path.join(theirs, name)) as g:
            assert json.load(f) == json.load(g), name
    with open(os.path.join(ours, "config.json")) as f:
        loaded_cfg = jcfg.from_hf_config(json.load(f), attn_impl="dense")
    back = jconv.eventchat_params_from_hf(jconv.load_state_dict(ours), loaded_cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_round_trip_keeps_bf16_and_refuses_fused_trees(tmp_path):
    tp = tconv.init_eventchat_params(TCFG, torch.Generator().manual_seed(3), torch.bfloat16,
                                     "cpu")
    d = str(tmp_path / "bf16")
    tconv.write_hf_checkpoint(tp, TCFG, d, num_shards=4)
    header, _ = _safetensors.read_header(os.path.join(d, "model-00001-of-00004.safetensors"))
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {"BF16"}
    cfg, back, _ = tinfer.load_model(d, "bfloat16", tokenizer_path="byte", device="cpu")
    # from_hf_config puts the (ungated) Q-Former at the LM's width.
    assert cfg == dataclasses.replace(
        TCFG, llama=dataclasses.replace(TCFG.llama, attn_impl="dense"),
        qformer=dataclasses.replace(TCFG.qformer, hidden_size=TCFG.llama.hidden_size))
    assert_trees_equal(back, tp)
    fuse_llama_params(back["llama"])
    with pytest.raises(ValueError, match="fused or quantized"):
        tconv.write_hf_checkpoint(back, cfg, str(tmp_path / "fused"))


def test_partial_module_matches_jax(tmp_path):
    """A reference-style partial checkpoint (a raw torch.save dict of one
    module) loads with its prefix stripped, as in the JAX package; keys
    without the prefix pass through there too."""
    g = torch.Generator().manual_seed(5)
    raw = {"model.feature_adaptor.weight": torch.randn(6, 6, generator=g).bfloat16(),
           "model.feature_adaptor.bias": torch.randn(6, generator=g),
           "other.scale": torch.randn(2, generator=g)}
    path = str(tmp_path / "adaptor.bin")
    torch.save(raw, path)
    want = jconv.load_partial_module(path, "model.feature_adaptor.")
    got = tconv.load_partial_module(path, "model.feature_adaptor.", "cpu", torch.float32)
    assert set(got) == set(want) == {"weight", "bias", "other.scale"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    kept = tconv.load_partial_module(path, "model.feature_adaptor.", "cpu")
    assert kept["weight"].dtype == torch.bfloat16


def test_loaders_default_to_the_card(tmp_path, monkeypatch):
    """Like every entry point of the port, the readers place weights on
    ``cuda`` unless the caller names another device, and raise where there
    is none rather than load a tree into host memory."""
    path = str(tmp_path / "a.safetensors")
    _safetensors.save_file({"w": torch.ones(2)}, path)
    torch.save({"m.w": torch.ones(2)}, str(tmp_path / "pytorch_model.bin"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: _safetensors.load_file(path),
                 lambda: tconv.load_state_dict(str(tmp_path)),
                 lambda: tconv.load_partial_module(str(tmp_path / "pytorch_model.bin"), "m.")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()


# -- the CLIs on one directory ----------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ckpt")
    d = _write_jax_checkpoint(str(root / "ckpt"), "safetensors")
    ev = str(root / "events.npy")
    np.save(ev, synthetic_event_stream(11, n_events=20_000))
    return d, ev


CLI_CASES = {
    "plain": [],
    "int4_int8kv_fused": ["--quant", "int4", "--kv_cache", "int8", "--fuse_params"],
    "model_base": ["--model_base", "x"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_infer_cli_prints_the_jax_answer(ckpt, case, capsys):
    d, ev = ckpt
    common = ["--model_path", d, "--tokenizer_path", "byte", "--event_frame", ev,
              "--query", "What is happening?", "--temperature", "0", "--max_new_tokens", "8",
              "--dtype", "float32", *CLI_CASES[case]]
    want = jinfer.main(common)
    got = tinfer.main(common + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert want and got == want and out[-2:] == [want, want]


def test_serve_engine_from_the_directory_answers_as_the_jax_cli(ckpt):
    d, ev = ckpt
    query = "Describe the scene."
    want = jinfer.main(["--model_path", d, "--tokenizer_path", "byte", "--event_frame", ev,
                        "--query", query, "--temperature", "0", "--max_new_tokens", "6",
                        "--dtype", "float32"])
    args = tserve.build_parser().parse_args(
        ["--model_path", d, "--tokenizer_path", "byte", "--device", "cpu", "--dtype", "float32",
         "--max_batch", "2", "--chunk", "4", "--max_len", "256"])
    cfg, engine = tserve.build_engine(args)
    try:
        _, pixels = process_event_file(ev, cfg.num_event_frames, cfg.vision.image_size)
        toks = engine.result(engine.submit(query, pixels, 6), timeout=120)
    finally:
        engine.shutdown()
    answer = engine.tokenizer.batch_decode([toks], skip_special_tokens=True)[0].strip()
    assert want and answer == want


def test_a_checkpoint_wants_the_byte_tokenizer(ckpt):
    d, ev = ckpt
    with pytest.raises(NotImplementedError, match="HF tokenizer"):
        tinfer.main(["--model_path", d, "--event_frame", ev, "--query", "q", "--device", "cpu"])
    args = tserve.build_parser().parse_args(["--model_path", d, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="HF tokenizer"):
        tserve.build_engine(args)
