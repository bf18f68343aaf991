"""The port's Trainer and ``cli/train`` against the JAX package, f32 on the CPU.

Streams are written with ``synthetic_event_stream`` into ``tmp_path``.

- The JAX ``Trainer`` (mesh 1x1) and the port's, from the same parameters
  and data, log the same ``metrics.jsonl`` losses within 1e-4 over 3
  steps: stage 1, and stage 2 with the same ``lora_weight_path`` factors.
- The port's ``projector_last.npz``/``lora_last.npz`` load through the JAX
  ``checkpoint.load_component`` to the trainer's tensors, and the JAX
  trainer's load through the port's; ``find_latest_checkpoint`` orders as
  the JAX package's.
- Stage-2 resume equals an uninterrupted run; ``save_steps`` then
  ``--resume_from auto``; divergence ``raise``/``rewind``; preemption
  through an injected ``GracefulShutdown``; eval during and after
  training; ``freeze_mm_mlp_adapter``; the refusals of the unported
  options; and ``python -m eventgpt_tpu_torch.cli.train --device cpu``.
- Telemetry: the ``telemetry.jsonl`` records and their ``registry`` key,
  the trace spans, the ``profile_dir`` capture and ``--trace_out``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import checkpoint as jckpt
from eventgpt_tpu.config import EventChatConfig as JConfig
from eventgpt_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.train import args as jargs
from eventgpt_tpu.train.trainer import Trainer as JTrainer
from eventgpt_tpu_torch import checkpoint as tckpt
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import train as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer
from eventgpt_tpu_torch.models.convert import params_from_jax, projector_params_to_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.train import args as targs_mod
from eventgpt_tpu_torch.train.optim import tree_leaves
from eventgpt_tpu_torch.train.resilience import GracefulShutdown
from eventgpt_tpu_torch.train.trainer import Trainer, TrainingDivergedError

LOSS_ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    entries = []
    for i in range(4):
        np.save(d / f"ev{i}.npy", synthetic_event_stream(100 + i, n_events=3000))
        entries.append({"id": i, "event": f"ev{i}.npy", "conversations": [
            {"from": "human", "value": "<event>\nDescribe the scene."},
            {"from": "gpt", "value": f"Answer number {i}."}]})
    (d / "qa.json").write_text(json.dumps(entries))
    (d / "eval.json").write_text(json.dumps(entries[:3]))
    return str(d)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray,
                                  jchat.init_eventchat_params(JConfig.tiny(), jax.random.PRNGKey(0)))


def _kw(data, out, **kw):
    d = dict(output_dir=str(out), stage=1, max_steps=3, per_device_train_batch_size=2,
             logging_steps=1, save_steps=-1, bf16=False, learning_rate=1e-2)
    d.update(kw)
    return d


def _port_trainer(jparams, data, out, eval_data=False, margs=None, **kw):
    cfg = tcfg.EventChatConfig.tiny()
    params = params_from_jax(jparams, cfg, torch.float32, "cpu")
    dargs = targs_mod.DataArguments(
        data_path=os.path.join(data, "qa.json"), event_folder=data,
        eval_data_path=os.path.join(data, "eval.json") if eval_data else "")
    return Trainer(cfg, params, load_tokenizer("byte"), margs or targs_mod.ModelArguments(),
                   dargs, targs_mod.TrainingArguments(**_kw(data, out, **kw)), device="cpu")


def _jax_trainer(jparams, data, out, **kw):
    dargs = jargs.DataArguments(data_path=os.path.join(data, "qa.json"), event_folder=data)
    return JTrainer(JConfig.tiny(), jparams, j_load_tokenizer("byte"), jargs.ModelArguments(),
                    dargs, jargs.TrainingArguments(**_kw(data, out, mesh_data=1, mesh_fsdp=1,
                                                         **kw)))


def _losses(path):
    return [r["loss"] for r in map(json.loads, open(path)) if "loss" in r and "step" in r
            and "event" not in r]


def _random_lora_npz(path):
    rng = np.random.default_rng(5)
    cfg = JConfig.tiny().llama
    from eventgpt_tpu.train.lora import LoraConfig as JL, init_lora_params

    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
        init_lora_params(cfg, JL(r=4), jax.random.PRNGKey(3)))
    jckpt.save_component(path, tree, prefix="lora.")
    return tree


@pytest.mark.parametrize("stage", [1, 2])
def test_trainer_matches_jax_and_components_cross_load(jparams, data, tmp_path, stage):
    kw = {}
    if stage == 2:
        lora_path = str(tmp_path / "lora_in.npz")
        _random_lora_npz(lora_path)
        kw = dict(stage=2, lora_r=4, lora_alpha=8.0, lora_weight_path=lora_path,
                  mm_projector_lr=1e-3, learning_rate=2e-3)
    jt = _jax_trainer(jparams, data, tmp_path / "jax", **kw)
    jt.train()
    tt = _port_trainer(jparams, data, tmp_path / "port", **kw)
    tt.train()
    want, got = _losses(jt.metrics_path), _losses(tt.metrics_path)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)

    # The port's components through the JAX loader, and the JAX trainer's
    # through the port's: the same trees.
    proj = jckpt.load_component(str(tmp_path / "port" / "projector_last.npz"),
                                strip_prefix="model.visual_projector.")
    mine = projector_params_to_jax(tt.state.trainable["projector"])
    for (p, a), (_, b) in zip(tree_leaves(proj), tree_leaves(mine)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    theirs = tckpt.load_component(str(tmp_path / "jax" / "projector_last.npz"),
                                  strip_prefix="model.visual_projector.")
    jproj = jax.tree_util.tree_map(np.asarray, jt.state.trainable["projector"])
    for (p, a), (_, b) in zip(tree_leaves(theirs), tree_leaves(jproj)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    if stage == 2:
        lora = jckpt.load_component(str(tmp_path / "port" / "lora_last.npz"),
                                    strip_prefix="lora.")
        for (p, a), (_, b) in zip(tree_leaves(lora), tree_leaves(tt.state.trainable["lora"])):
            np.testing.assert_array_equal(a, b.detach().numpy(), err_msg=str(p))
        jl = tckpt.load_component(str(tmp_path / "jax" / "lora_last.npz"), strip_prefix="lora.")
        jlora = jax.tree_util.tree_map(np.asarray, jt.state.trainable["lora"])
        for (p, a), (_, b) in zip(tree_leaves(jl), tree_leaves(jlora)):
            np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_stage2_resume_equals_uninterrupted(jparams, data, tmp_path):
    """A fresh trainer resumed from ``ckpt_step2`` takes the same steps 3-4
    as the trainer that wrote it, continued in memory (each restarts its
    epoch count at the resume, as the JAX trainer does)."""
    kw = dict(stage=2, lora_r=4, lora_alpha=8.0, max_steps=4, save_steps=2)
    first = _port_trainer(jparams, data, tmp_path / "a", **kw)
    first.targs.max_steps = 2
    first.train()
    again = _port_trainer(jparams, data, tmp_path / "b", **kw)
    again.resume(str(tmp_path / "a" / "ckpt_step2"))
    assert again.state.step == 2
    again.train()
    first.targs.max_steps = 4
    first.train()
    assert len(_losses(again.metrics_path)) == 2
    np.testing.assert_allclose(_losses(again.metrics_path), _losses(first.metrics_path)[-2:],
                               atol=1e-6, rtol=0)
    for (p, a), (_, b) in zip(tree_leaves(again.state.trainable),
                              tree_leaves(first.state.trainable)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=0,
                                   err_msg=str(p))


class _TriggerAfter(GracefulShutdown):
    """A shutdown that requests itself after N polls: a SIGTERM landing
    mid-epoch, deterministically."""

    def __init__(self, after: int):
        super().__init__(signals=())
        self._countdown = after

    @property
    def requested(self):
        self._countdown -= 1
        return self._countdown < 0

    @requested.setter
    def requested(self, value):
        pass


def test_preemption_then_auto_resume(jparams, data, tmp_path):
    out = tmp_path / "out"
    tr = _port_trainer(jparams, data, out, max_steps=4)
    result = tr.train(shutdown=_TriggerAfter(after=2))
    assert result.get("preempted") is True
    saved = tr.state.step
    assert 0 < saved < 4
    latest = tckpt.find_latest_checkpoint(str(out))
    assert latest == os.path.join(str(out), f"ckpt_preempt_step{saved}")
    tr2 = _port_trainer(jparams, data, out, max_steps=4)
    tr2.resume(latest)
    assert tr2.state.step == saved
    metrics = tr2.train()
    assert metrics["step"] == 4 and np.isfinite(metrics["loss"])


def _poison(tr, which):
    real = tr.train_step
    calls = {"n": 0}

    def poisoned(state, batch):
        state, metrics = real(state, batch)
        calls["n"] += 1
        if which is None or calls["n"] == which:
            metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
        return state, metrics

    tr.train_step = poisoned


def test_divergence_rewind_and_raise(jparams, data, tmp_path):
    tr = _port_trainer(jparams, data, tmp_path / "rw", on_divergence="rewind", save_steps=1,
                       max_steps=4)
    _poison(tr, 2)
    metrics = tr.train()
    assert metrics["step"] == 4 and np.isfinite(metrics["loss"])
    events = [json.loads(line) for line in open(tr.metrics_path)]
    rewinds = [e for e in events if e.get("event") == "divergence_rewind"]
    assert len(rewinds) == 1 and rewinds[0]["rewind"] == 1
    tr = _port_trainer(jparams, data, tmp_path / "rs", on_divergence="raise")
    _poison(tr, None)
    with pytest.raises(TrainingDivergedError, match="resume_from auto"):
        tr.train()


def test_eval_freeze_and_telemetry(jparams, data, tmp_path):
    tr = _port_trainer(jparams, data, tmp_path / "ev", eval_data=True, eval_steps=2,
                       stage=2, lora_r=4, freeze_mm_mlp_adapter=True)
    proj = tr.state.frozen["projector"]["mlp"][0]["weight"].clone()
    metrics = tr.train()
    assert "projector" not in tr.state.trainable
    assert torch.equal(tr.state.frozen["projector"]["mlp"][0]["weight"], proj)
    records = [json.loads(line) for line in open(tr.metrics_path)]
    evals = [r for r in records if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2, 3]
    assert metrics["eval_loss"] == evals[-1]["eval_loss"] and evals[-1]["eval_tokens"] > 0
    tele = [json.loads(line) for line in open(os.path.join(tmp_path / "ev", "telemetry.jsonl"))]
    assert [r["step"] for r in tele] == [1, 2, 3]
    assert set(tele[0]) == {"step", "micro", "step_wall_s", "data_wait_s", "compute_s",
                            "tokens_seen", "loss", "grad_norm", "registry"}
    assert not os.path.exists(tmp_path / "ev" / "projector_last.npz")
    assert os.path.exists(tmp_path / "ev" / "lora_last.npz")
    with pytest.raises(ValueError, match="freeze_mm_mlp_adapter"):
        _port_trainer(jparams, data, tmp_path / "x", freeze_mm_mlp_adapter=True)


# The training mesh is ported: a mesh of 2 ranks in this single process
# raises the ValueError that names the launcher (with the data and fsdp
# sizes left to the world, the JAX ``best_mesh_config``'s), and the sequence-parallel
# attn_impl values on one device train as dense attention, as in the JAX
# package (tests/test_torch_train_mesh.py runs the meshes).
@pytest.mark.parametrize("flag", [{"mesh_fsdp": 2}, {"mesh_context": 2},
                                  {"attn_impl": "ulysses"}, {"attn_impl": "ring"},
                                  {"mesh_model": 2}])
def test_unported_options_raise(jparams, data, tmp_path, flag):
    if "attn_impl" in flag:
        tt = _port_trainer(jparams, data, tmp_path / "x", **flag)
        assert tt.mesh is None and tt.cfg.llama.attn_impl == flag["attn_impl"]
        return
    with pytest.raises(ValueError, match=r"needs 2 ranks, have 1.*torch.distributed.run"
                                         r"|1 devices not divisible by model\*context=2"):
        _port_trainer(jparams, data, tmp_path / "x", **flag)


def test_telemetry_registry_profile_and_trace_out_match_jax(jparams, data, tmp_path):
    """Two steps in each package, both registries zeroed and both tracers
    armed: the ``telemetry.jsonl`` records carry the same keys, the same
    ``registry`` names and the same step and token counts, and the traces
    the same span names; the port's ``profile_dir`` capture of step 2
    writes a trace that loads. ``cli/train --trace_out`` writes its spans."""
    from eventgpt_tpu.obs import metrics as jmetrics
    from eventgpt_tpu.obs import trace as jtrace
    from eventgpt_tpu_torch.obs import metrics as tmetrics
    from eventgpt_tpu_torch.obs import trace as ttrace

    out = {}
    for pkg, make, met, trc in (("torch", _port_trainer, tmetrics, ttrace),
                                ("jax", _jax_trainer, jmetrics, jtrace)):
        met.REGISTRY.reset()
        tracer = trc.configure(4096)
        extra = {"profile_dir": str(tmp_path / "prof")} if pkg == "torch" else {}
        tr = make(jparams, data, tmp_path / pkg, max_steps=2, **extra)
        try:
            tr.train()
        finally:
            trc.disable()
        tele = [json.loads(line) for line in open(tmp_path / pkg / "telemetry.jsonl")]
        reg = tele[-1]["registry"]
        out[pkg] = ([sorted(r) for r in tele], sorted(reg), reg["egpt_train_steps_total"],
                    reg["egpt_train_tokens_total"],
                    {(e["name"], e["cat"]) for e in tracer.events()})
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == 2 and ("batch_to_device", "train") in out["torch"][4]
    events = [json.loads(line) for line in open(tmp_path / "torch" / "metrics.jsonl")]
    # The window opens after step 1; the run ends inside it, and train()
    # closes the capture on its way out.
    assert [(e["event"], e["step"]) for e in events
            if e.get("event", "").startswith("profile_")] == [("profile_start", 2)]
    traces = [f for f in os.listdir(tmp_path / "prof") if f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    path = str(tmp_path / "cli_trace.json")
    tcli.main(["--model_path", "tiny-random", "--data_path", os.path.join(data, "qa.json"),
               "--event_folder", data, "--device", "cpu", "--bf16", "false", "--max_steps", "1",
               "--per_device_train_batch_size", "2", "--output_dir", str(tmp_path / "cli"),
               "--trace_out", path])
    assert {e["name"] for e in ttrace.load_trace(path)} == {"batch_to_device"}


def test_find_latest_checkpoint_orders_as_jax(tmp_path):
    layout = [("ckpt_step9", None), ("ckpt_step1", "40"), ("ckpt_preempt_step9", None),
              ("ckpt_last", "3"), ("ckpt_last.tmp-123", "99"),
              ("ckpt_last.orbax-checkpoint-tmp-5", "99")]
    for name, step in layout:
        (tmp_path / name).mkdir()
        if step:
            (tmp_path / name / "STEP").write_text(step)
        assert tckpt.find_latest_checkpoint(str(tmp_path)) == \
            jckpt.find_latest_checkpoint(str(tmp_path))
    assert tckpt.find_latest_checkpoint(str(tmp_path)).endswith("ckpt_step1")


def test_cli_train_subprocess_and_auto_resume(data, tmp_path):
    out = str(tmp_path / "out")
    base = [sys.executable, "-m", "eventgpt_tpu_torch.cli.train", "--model_path", "tiny-random",
            "--data_path", os.path.join(data, "qa.json"), "--event_folder", data,
            "--stage", "2", "--lora_r", "4", "--bf16", "false", "--device", "cpu",
            "--per_device_train_batch_size", "2", "--output_dir", out, "--logging_steps", "1"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run(base + ["--max_steps", "2", "--save_steps", "2"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "'step': 2" in res.stdout
    assert os.path.isdir(os.path.join(out, "ckpt_step2"))
    res = subprocess.run(base + ["--max_steps", "3", "--resume_from", "auto"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "auto-resuming" in res.stderr and "'step': 3" in res.stdout
    steps = [r["step"] for r in map(json.loads, open(os.path.join(out, "metrics.jsonl")))]
    assert steps == [1, 2, 3]


# --trace_out and --profile_dir are ported; their slots hold the mesh
# flags, which in a single process raise the ValueError that names the
# launcher (the ids keep the names these cases had when the mesh raised
# NotImplementedError).
@pytest.mark.parametrize("argv,exc", [
    pytest.param(["--mesh_fsdp", "2"], ValueError, id="argv0-NotImplementedError"),
    pytest.param(["--mesh_data", "2"], ValueError, id="argv1-NotImplementedError"),
    pytest.param(["--mesh_context", "2"], ValueError, id="argv2-NotImplementedError")])
def test_cli_refuses_unported_flags(data, tmp_path, argv, exc):
    with pytest.raises(exc):
        tcli.main(["--model_path", "tiny-random", "--data_path", os.path.join(data, "qa.json"),
                   "--event_folder", data, "--device", "cpu", "--bf16", "false",
                   "--output_dir", str(tmp_path)] + argv)


def test_cli_defaults_to_the_card():
    args = tcli.build_parser().parse_args([])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.build_trainer(targs_mod.ModelArguments(), targs_mod.DataArguments(),
                               targs_mod.TrainingArguments())
