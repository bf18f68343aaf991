"""Training loop: the port of ``eventgpt_tpu/train/trainer.py``.

Wires dataset -> collator -> train step -> metrics -> checkpoints, with the
JAX trainer's flow: special-token registration and the embedding resize;
the stage split (stage 1: projector [+ Q-Former] [+ new embedding rows];
stage 2: LoRA + projector, or LoRA alone with ``freeze_mm_mlp_adapter``);
HF step semantics (``max_steps``, warmup, ``save_steps`` and the schedule
count optimizer updates, one per ``gradient_accumulation_steps``
micro-batches); ``metrics.jsonl``, ``telemetry.jsonl`` and
``heartbeat.json``; ``save_steps`` and ``save("last")``; a token-weighted
``evaluate``; preemption to ``ckpt_preempt_step{n}``; and ``on_divergence``
``raise`` or ``rewind`` (reload the latest checkpoint, reshuffle, tokens not
counted twice).

bf16 applies to the frozen tree and the forward only: the trainable master
weights and the AdamW moments stay f32, cast to the compute dtype inside
the combine. The loss and gradient norm stay on the device and are read
back on logging and save steps only.

Telemetry, as in the JAX trainer: the ``egpt_train_*`` metrics, a
``telemetry.jsonl`` record per optimizer step with the registry's
``egpt_train_*`` summary under ``registry``, a ``torch.profiler`` range
around each micro-step while profiling is armed, and with ``profile_dir`` a
capture of optimizer steps ``[profile_start_step, + profile_num_steps)``
written there as a Chrome trace.

The mesh (``mesh_*``): one rank a device under ``python -m
torch.distributed.run`` (``parallel/mesh.make_mesh`` after
``parallel/dist.initialize_distributed``), ``mesh_data``/``mesh_fsdp`` of
-1 filling the world (``best_mesh_config``). The JAX trainer's checks raise
its ``ValueError``s: ``mesh_context`` > 1 needs ``attn_impl`` ``ring`` or
``ulysses``, Ulysses needs the heads a rank holds to divide by the context
size, and the context size must divide ``SEQ_BUCKET``. The global batch is
``per_device_train_batch_size`` x data x fsdp; every rank reads the same
global batches (one seed, one order) and keeps its rows and sequence chunk
(``steps.batch_to_device(batch, mesh)``). The frozen tree takes the
serving layout (``parallel/sharding.shard_frozen``), the trainables the
training layout (``shard_trainable``: the JAX specs on ``model``,
replicated over ``fsdp``). Rank 0 alone writes ``metrics.jsonl``,
``telemetry.jsonl``, ``heartbeat.json``, the checkpoints and the
components, from trees gathered to their whole size, so the files are a
one-device run's; ``resume`` loads them on every rank and keeps the
rank's blocks. The preemption flag is agreed over the ranks every
``preempt_poll_micros`` micro-batches.

Not ported, and refused with ``NotImplementedError`` (``refuse_unported``):
a ``model`` axis that does not divide the q heads or the KV heads (serving
replicates such heads; training would need their partial gradients summed).
f32 training on the card with ``attn_impl="flash"`` raises ``ValueError``:
the flash kernel takes bf16 only (pass ``attn_impl="dense"``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from eventgpt_tpu_torch import checkpoint as ckpt
from eventgpt_tpu_torch import constants, faults
from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models.convert import lora_from_jax, projector_params_to_jax
from eventgpt_tpu_torch.models.llama import resize_token_embeddings
from eventgpt_tpu_torch.models.qformer import save_qformer_components
from eventgpt_tpu_torch.obs import metrics as obs_metrics
from eventgpt_tpu_torch.obs import profiling as obs_profiling
from eventgpt_tpu_torch.parallel import dist as pdist
from eventgpt_tpu_torch.parallel import sharding
from eventgpt_tpu_torch.train import steps as steps_mod
from eventgpt_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from eventgpt_tpu_torch.train.data import EventChatDataset, batch_iterator
from eventgpt_tpu_torch.train.lora import LoraConfig
from eventgpt_tpu_torch.train.optim import linear_warmup_cosine, make_optimizer
from eventgpt_tpu_torch.train.prefetch import PrefetchIterator
from eventgpt_tpu_torch.train.resilience import GracefulShutdown, Heartbeat

log = logging.getLogger("eventgpt_tpu_torch.train")


class TrainingDivergedError(RuntimeError):
    """Loss went non-finite; training state before the divergence is on disk."""


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def refuse_unported(cfg: EventChatConfig, mesh_shape) -> None:
    """The JAX trainer's meshes that the port does not train on raise here:
    a ``model`` axis that divides the MLP but not the q or the KV heads."""
    m = int(mesh_shape.get("model", 1))
    if m > 1 and (cfg.llama.num_heads % m or cfg.llama.num_kv_heads % m):
        raise NotImplementedError(
            f"mesh_model={m} with {cfg.llama.num_heads} q heads and {cfg.llama.num_kv_heads} "
            f"KV heads: training on a model axis that does not divide the heads is not "
            f"ported (serving replicates such heads)")


def check_mesh_config(cfg: EventChatConfig, mesh_shape) -> None:
    """The JAX trainer's checks of a mesh against the config, with its
    ``ValueError`` texts."""
    ctx = int(mesh_shape["context"])
    if ctx > 1 and cfg.llama.attn_impl not in ("ring", "ulysses"):
        raise ValueError(
            "mesh_context > 1 requires attn_impl='ring' or 'ulysses' "
            "(sequence parallelism); dense/flash attention cannot "
            "consume a context-sharded sequence"
        )
    if ctx > 1 and cfg.llama.attn_impl == "ulysses":
        local_heads = cfg.llama.num_heads // int(mesh_shape["model"])
        if local_heads % ctx:
            raise ValueError(
                f"attn_impl='ulysses' re-shards heads over context: "
                f"num_heads/model = {local_heads} must divide by "
                f"mesh_context={ctx} (use attn_impl='ring' otherwise)"
            )
    if ctx > 1 and constants.SEQ_BUCKET % ctx:
        raise ValueError(
            f"mesh_context={ctx} must divide the {constants.SEQ_BUCKET}-token "
            f"sequence bucket (use 2, 4, 8, ...)"
        )


def build_training_mesh(train_args: TrainingArguments, device_type: str):
    """The mesh of the ``mesh_*`` fields, or None for one device in a single
    process: ``mesh_data``/``mesh_fsdp`` as given (one of them given, the
    other -1 is 1), or both -1 ``best_mesh_config`` over the world (the JAX
    trainer's rule, which reads a lone explicit one as -1). A mesh of N > 1
    ranks needs a world of N (``make_mesh`` raises otherwise)."""
    import torch.distributed as dist

    from eventgpt_tpu_torch.config import MeshConfig
    from eventgpt_tpu_torch.parallel.mesh import best_mesh_config, make_mesh

    if train_args.mesh_data > 0 or train_args.mesh_fsdp > 0:
        mcfg = MeshConfig(data=max(train_args.mesh_data, 1), fsdp=max(train_args.mesh_fsdp, 1),
                          model=train_args.mesh_model, context=train_args.mesh_context)
    else:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mcfg = best_mesh_config(world, model=train_args.mesh_model,
                                context=train_args.mesh_context)
    n = mcfg.data * mcfg.fsdp * mcfg.context * mcfg.model
    if n == 1 and not dist.is_initialized():
        return None
    return make_mesh(mcfg, device_type)


class Trainer:
    """Two-stage EventChat trainer on one device (default ``cuda``) or, with
    ``mesh_*`` (or a ``mesh``), on this rank's share of a mesh.

    ``stage=1`` trains the projector; ``stage=2`` (or ``lora_enable``)
    trains LoRA + projector.
    """

    def __init__(self, cfg: EventChatConfig, params: Dict[str, Any], tokenizer: Any,
                 model_args: ModelArguments, data_args: DataArguments,
                 train_args: TrainingArguments, device="cuda", mesh=None):
        if mesh is None:
            mesh = build_training_mesh(train_args, resolve_device(device).type)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.margs, self.dargs, self.targs = model_args, data_args, train_args
        # This rank's wall per optimizer step, and the logged (step, loss,
        # grad_norm): the same global numbers on every rank of a mesh.
        self.step_seconds: list = []
        self.logged: list = []

        if train_args.attn_impl:
            cfg = dataclasses.replace(
                cfg, llama=dataclasses.replace(cfg.llama, attn_impl=train_args.attn_impl))
        if train_args.remat_policy != cfg.llama.remat_policy:
            cfg = dataclasses.replace(
                cfg, llama=dataclasses.replace(cfg.llama, remat_policy=train_args.remat_policy))
        if (not train_args.bf16 and cfg.llama.attn_impl == "flash"
                and self.device.type == "cuda"):
            raise ValueError(
                "f32 training (bf16 false) with attn_impl='flash' on the card: the flash "
                "kernel takes bf16 only; pass attn_impl='dense' for f32")
        if mesh is not None:
            check_mesh_config(cfg, mesh.shape)
            refuse_unported(cfg, mesh.shape)

        # Special tokens (initialize_vision_tokenizer): the patch token, and
        # with mm_use_im_start_end the start/end tokens, whose new embedding
        # rows become a trainable stage-1 leaf.
        self.num_new_im_tokens = 0
        if model_args.mm_use_im_patch_token:
            tokenizer.add_tokens([constants.DEFAULT_EVENT_PATCH_TOKEN], special_tokens=True)
        if model_args.mm_use_im_start_end:
            self.num_new_im_tokens = tokenizer.add_tokens(
                [constants.DEFAULT_EV_START_TOKEN, constants.DEFAULT_EV_END_TOKEN],
                special_tokens=True)
        if len(tokenizer) > cfg.llama.vocab_size:
            params = {**params, "llama": resize_token_embeddings(params["llama"],
                                                                 len(tokenizer))}
            cfg = dataclasses.replace(
                cfg, llama=dataclasses.replace(cfg.llama, vocab_size=len(tokenizer)))
        self.cfg = cfg

        def dataset(path):
            return EventChatDataset(path, tokenizer, cfg, event_folder=data_args.event_folder,
                                    conv_version=data_args.conv_version,
                                    image_aspect_ratio=data_args.image_aspect_ratio)

        self.dataset = dataset(data_args.data_path)
        self.eval_dataset = dataset(data_args.eval_data_path) if data_args.eval_data_path \
            else None

        # --- stage split -------------------------------------------------
        dtype = torch.bfloat16 if train_args.bf16 else torch.float32
        self.lora_cfg: Optional[LoraConfig] = None
        if train_args.stage == 2 or train_args.lora_enable:
            self.lora_cfg = LoraConfig(r=train_args.lora_r, alpha=train_args.lora_alpha,
                                       dropout=train_args.lora_dropout)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(train_args.seed)
            trainable, frozen = steps_mod.split_stage2(params, cfg, self.lora_cfg, gen,
                                                       dtype=torch.float32)
            if train_args.lora_weight_path:
                trainable["lora"] = lora_from_jax(
                    ckpt.load_component(train_args.lora_weight_path, strip_prefix="lora."),
                    torch.float32, self.device)
            source = "trainable"
            if train_args.freeze_mm_mlp_adapter:
                frozen = {**frozen, "projector": trainable.pop("projector")}
                source = "frozen"
            self.combine = steps_mod.make_stage2_combine(
                self.lora_cfg, dropout_seed=train_args.seed, projector_source=source,
                mesh=mesh)
        else:
            if train_args.freeze_mm_mlp_adapter:
                raise ValueError(
                    "freeze_mm_mlp_adapter with stage 1 would leave nothing trainable "
                    "(stage 1 trains only the projector)")
            trainable, frozen = steps_mod.split_stage1(
                params, trainable_embed_rows=self.num_new_im_tokens)
            self.combine = steps_mod.stage1_combine

        # f32 master copies of the trainables (never the caller's tensors);
        # the frozen tree in the compute dtype, shared where it already is.
        dev = self.device
        self.specs = None
        if mesh is None:
            trainable = tree_map(lambda x: x.detach().to(dev, torch.float32).clone(), trainable)
            frozen = tree_map(lambda x: x.detach().to(dev, dtype), frozen)
        else:
            self.specs = sharding.trainable_param_specs(
                trainable, self.lora_cfg.targets if self.lora_cfg else None)
            trainable = sharding.shard_trainable(trainable, self.specs, mesh)
            frozen = sharding.shard_frozen(frozen, cfg, mesh, dtype)
        base_combine = self.combine

        def cast_combine(tr, fz, step=None, _base=base_combine, _dt=dtype):
            return _base(tree_map(lambda x: x.to(_dt), tr), fz, step)

        self.combine = cast_combine

        # --- optimizer: HF step semantics --------------------------------
        dp = 1 if mesh is None else mesh.shape["data"] * mesh.shape["fsdp"]
        self.global_batch_size = train_args.per_device_train_batch_size * dp
        accum = max(train_args.gradient_accumulation_steps, 1)
        micro_per_epoch = len(self.dataset) // self.global_batch_size
        steps_per_epoch = max(micro_per_epoch // accum, 1)
        total = (train_args.max_steps if train_args.max_steps > 0
                 else steps_per_epoch * train_args.num_train_epochs)
        warmup = (train_args.warmup_steps if train_args.warmup_steps > 0
                  else int(total * train_args.warmup_ratio))
        schedule = linear_warmup_cosine(
            train_args.learning_rate, total, warmup, min_lr=train_args.min_lr,
            warmup_start_lr=0.0 if warmup else -1.0)
        self.optimizer = make_optimizer(
            schedule, weight_decay=train_args.weight_decay, grad_clip=train_args.max_grad_norm,
            projector_lr=train_args.mm_projector_lr,
            accum_steps=train_args.gradient_accumulation_steps)

        self.state = steps_mod.init_train_state(trainable, frozen, self.optimizer)
        self.train_step = steps_mod.make_train_step(cfg, self.optimizer, self.combine,
                                                    mesh=mesh, specs=self.specs)
        self.eval_step = steps_mod.make_eval_step(cfg, self.combine, mesh=mesh)
        self.metrics_path = os.path.join(train_args.output_dir, "metrics.jsonl")
        self.telemetry = (obs_metrics.JsonlSink(
            os.path.join(train_args.output_dir, "telemetry.jsonl"))
            if train_args.telemetry and pdist.is_primary() else None)
        self._profiling = False
        if train_args.profile_dir:
            # Arms the micro-step ranges; the capture window opens at
            # profile_start_step (_maybe_profile).
            obs_profiling.configure(train_args.profile_dir)
        self.heartbeat = Heartbeat(train_args.output_dir)
        self._last_ckpt: Optional[str] = None
        if train_args.on_divergence not in ("raise", "rewind"):
            raise ValueError(f"on_divergence must be 'raise' or 'rewind', "
                             f"got {train_args.on_divergence!r}")

    # ------------------------------------------------------------------
    def _append(self, path: str, record: Dict[str, Any]) -> None:
        os.makedirs(self.targs.output_dir, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _log(self, record: Dict[str, Any]) -> None:
        if not pdist.is_primary():
            return
        self._append(self.metrics_path, record)
        log.info("step %s: %s", record.get("step"), record)

    def _to_device(self, host_batch):
        return steps_mod.batch_to_device(host_batch, self.mesh if self.mesh is not None
                                         else self.device)

    def evaluate(self, step: Optional[int] = None) -> Dict[str, float]:
        """Mean next-token loss over the held-out set, weighted by tokens;
        logs an ``eval_loss`` record and returns it."""
        if self.eval_dataset is None:
            raise ValueError("no eval dataset (set --eval_data_path)")
        total_loss, total_tokens = 0.0, 0
        dp = self.global_batch_size // self.targs.per_device_train_batch_size
        for host_batch in batch_iterator(self.eval_dataset, self.global_batch_size, self.cfg,
                                         shuffle=False, drop_last=False,
                                         max_len=self.targs.model_max_length):
            b = next(iter(host_batch.values())).shape[0]
            if self.mesh is not None and b % dp:
                # The trailing partial batch padded to the data-parallel
                # extent with IGNORE-labelled copies: no tokens counted.
                import numpy as np

                pad = dp - b % dp
                host_batch = {k: np.concatenate([v] + [v[:1]] * pad)
                              for k, v in host_batch.items()}
                host_batch["labels"][b:] = constants.IGNORE_INDEX
            batch = self._to_device(host_batch)
            metrics = self.eval_step(self.state, batch)
            n = float(metrics["n_tokens"])
            total_loss += float(metrics["loss"]) * n
            total_tokens += n
        if total_tokens == 0:
            raise ValueError(
                f"eval dataset {self.dargs.eval_data_path!r} produced zero supervised "
                f"tokens — empty or fully filtered eval set")
        record = {"eval_loss": total_loss / total_tokens, "eval_tokens": int(total_tokens),
                  **({"step": step} if step is not None else {})}
        self._log(record)
        return record

    def save(self, tag: str = "last") -> str:
        """Full state checkpoint plus the component artifacts, in the JAX
        trainer's file names, keys and layouts."""
        out_dir = self.targs.output_dir
        out = os.path.join(out_dir, f"ckpt_{tag}")
        state = self.state
        tr, opt_state = state.trainable, state.opt_state
        if self.mesh is not None:
            tr, opt_state = self._whole_state()
        self._last_ckpt = out
        if not pdist.is_primary():
            pdist.barrier(f"save {tag}")
            return out
        os.makedirs(out_dir, exist_ok=True)
        ckpt.save_checkpoint(out, {"trainable": tr, "opt_state": opt_state,
                                   "step": state.step}, step=state.step)
        if "projector" in tr:
            ckpt.save_component(os.path.join(out_dir, f"projector_{tag}.npz"),
                                projector_params_to_jax(tr["projector"]),
                                prefix="model.visual_projector.")
        if "embed_new" in tr:
            ckpt.save_component(os.path.join(out_dir, f"embed_tokens_{tag}.npz"),
                                {"embed_tokens": {"weight": tr["embed_new"]}}, prefix="model.")
        if "lora" in tr:
            ckpt.save_component(os.path.join(out_dir, f"lora_{tag}.npz"), tr["lora"],
                                prefix="lora.")
        if "qformer" in tr:
            save_qformer_components(
                tr["qformer"], os.path.join(out_dir, f"query_embedder_{tag}.npz"),
                os.path.join(out_dir, f"attention_layers_{tag}.npz"),
                num_heads=self.cfg.qformer.num_heads)
        if self.mesh is not None:
            pdist.barrier(f"save {tag}")
        return out

    def _leaf_specs(self) -> list:
        """The trainables' specs in ``tree_leaves`` order (the optimizer's
        moment lists follow it)."""
        return [spec for _, spec in sharding.spec_leaves(self.specs)]

    def _whole_state(self):
        """The trainables and the optimizer state gathered to their whole
        size on every rank (each ``model``-split leaf over ``model``)."""
        mesh = self.mesh
        tr = sharding.gather_trainable(self.state.trainable, self.specs, mesh)
        specs = self._leaf_specs()
        opt = dict(self.state.opt_state)
        for key in ("mu", "nu", "acc"):
            if key in opt:
                opt[key] = [sharding.gather_trainable(t, s, mesh) for t, s in zip(opt[key], specs)]
        return tr, opt

    def resume(self, path: str) -> None:
        """Restore a checkpoint; on a mesh every rank loads the whole state
        and keeps its blocks."""
        if self.mesh is None:
            restored = ckpt.load_checkpoint(path, self.device)
            trainable, opt = restored["trainable"], restored["opt_state"]
        else:
            restored = ckpt.load_checkpoint(path, "cpu")
            trainable = sharding.shard_trainable(restored["trainable"], self.specs, self.mesh)
            opt = dict(restored["opt_state"])
            for key in ("mu", "nu", "acc"):
                if key in opt:
                    opt[key] = [sharding.shard_trainable(t, s, self.mesh)
                                for t, s in zip(opt[key], self._leaf_specs())]
        self.state = steps_mod.TrainState(trainable, self.state.frozen, opt,
                                          int(restored["step"]))
        self._last_ckpt = path

    # ------------------------------------------------------------------
    def train(self, shutdown: Optional[GracefulShutdown] = None) -> Dict[str, float]:
        """Run the training loop. ``shutdown`` (a ``GracefulShutdown``) is
        injectable; by default one is installed, so SIGTERM/SIGINT save
        ``ckpt_preempt_step{n}`` and return ``{"preempted": True, ...}``.
        Non-finite loss follows ``on_divergence``."""
        own_shutdown = shutdown is None
        if own_shutdown:
            shutdown = GracefulShutdown().install()
        try:
            return self._train_loop(shutdown)
        finally:
            if own_shutdown:
                shutdown.uninstall()
            if self._profiling:
                # Training ended inside the capture window: write it.
                obs_profiling.stop_trace()
                self._profiling = False

    def _maybe_profile(self, step: int) -> None:
        """Open and close the ``profile_dir`` capture at optimizer-step
        boundaries: steps [profile_start_step, + profile_num_steps) run
        inside one ``torch.profiler`` capture (a start above 1 keeps the
        first step's kernel builds and allocator growth out)."""
        targs = self.targs
        if not targs.profile_dir:
            return
        start = max(int(targs.profile_start_step), 1)
        stop = start + max(int(targs.profile_num_steps), 1)
        if not self._profiling and step + 1 == start:
            obs_profiling.start_trace(targs.profile_dir)
            self._profiling = True
            self._log({"event": "profile_start", "step": step + 1, "dir": targs.profile_dir})
        elif self._profiling and step + 1 >= stop:
            obs_profiling.stop_trace()
            self._profiling = False
            self._log({"event": "profile_stop", "step": step})

    def _train_loop(self, shutdown: GracefulShutdown) -> Dict[str, float]:
        targs = self.targs
        accum = max(targs.gradient_accumulation_steps, 1)
        # state.step counts micro-batches; the user-facing step counts
        # optimizer updates (HF semantics).
        micro = self.state.step
        step = micro // accum
        done = False
        last_metrics: Dict[str, Any] = {}
        t_start = time.perf_counter()
        tokens_seen = 0
        rewinds = 0
        ckpt_tokens: Dict[str, int] = {}  # tokens_seen at each save point
        last_beat = 0.0
        last_eval_step = -1

        if len(self.dataset) < self.global_batch_size:
            raise ValueError(
                f"dataset has {len(self.dataset)} entries but the batch is "
                f"{self.global_batch_size}; every epoch would yield zero batches (drop_last)")
        epochs = targs.num_train_epochs if targs.max_steps <= 0 else 10**9
        epoch = -1
        while epoch + 1 < epochs:
            epoch += 1
            if done:
                break
            it = batch_iterator(
                self.dataset, self.global_batch_size, self.cfg,
                # + rewinds: a rewind replays with another shuffle.
                shuffle=True, seed=targs.seed + epoch + 1000 * rewinds,
                group_by_modality_length=targs.group_by_modality_length,
                max_len=targs.model_max_length)
            if targs.prefetch_depth > 0:
                it = PrefetchIterator(it, depth=targs.prefetch_depth)
            window: list = []  # (loss, grad_norm) device scalars, one per micro
            win_data_wait = 0.0
            t_window = time.perf_counter()
            diverged = False
            self._maybe_profile(step)

            def timed_iter(src):
                src = iter(src)
                while True:
                    t0 = time.perf_counter()
                    try:
                        x = next(src)
                    except StopIteration:
                        return
                    yield time.perf_counter() - t0, x

            try:
                for dt_iter, host_batch in timed_iter(it):
                    # The micro-batch boundary is a fault site.
                    faults.maybe_fail("train.step")
                    faults.maybe_delay("train.step")
                    poll = (self.mesh is None
                            or micro % max(targs.preempt_poll_micros, 1) == 0)
                    if poll and shutdown.globally_requested(self.mesh):
                        self.save(f"preempt_step{step}")
                        last_metrics = {**last_metrics, "preempted": True,
                                        "reason": shutdown.reason, "step": step}
                        self._log({"event": "preempt", "reason": shutdown.reason,
                                   "step": step})
                        return last_metrics
                    t0 = time.perf_counter()
                    batch = self._to_device(host_batch)
                    dt_data = dt_iter + (time.perf_counter() - t0)
                    win_data_wait += dt_data
                    obs_metrics.TRAIN_DATA_WAIT.observe(dt_data)
                    with obs_profiling.step_annotation(micro):
                        self.state, metrics = self.train_step(self.state, batch)
                    micro += 1
                    tok_n = int(host_batch["attn_mask"].sum())
                    tokens_seen += tok_n
                    obs_metrics.TRAIN_TOKENS.inc(tok_n)
                    window.append((metrics["loss"], metrics["grad_norm"]))
                    if micro % accum:
                        continue  # gradients still accumulating
                    step += 1

                    need_log = step % targs.logging_steps == 0 or step == 1
                    need_save = targs.save_steps > 0 and step % targs.save_steps == 0
                    if need_log or need_save:
                        # Mean over the accumulation window, read back only
                        # here; a save step reads it too, so no checkpoint is
                        # written from a window that went non-finite.
                        loss = float(torch.stack([w[0] for w in window]).sum()) / len(window)
                        gnorm = float(torch.stack([w[1] for w in window]).sum()) / len(window)
                        if not math.isfinite(loss):
                            if (targs.on_divergence == "rewind"
                                    and rewinds < targs.max_divergence_rewinds
                                    and self._last_ckpt):
                                rewinds += 1
                                self._log({"event": "divergence_rewind", "step": step,
                                           "loss": loss, "rewind": rewinds,
                                           "checkpoint": self._last_ckpt})
                                self.resume(self._last_ckpt)
                                micro = self.state.step
                                step = micro // accum
                                # The discarded steps' tokens are not counted
                                # twice (the replay counts them again).
                                tokens_seen = ckpt_tokens.get(self._last_ckpt, tokens_seen)
                                diverged = True
                                break  # a new epoch iterator, reshuffled
                            raise TrainingDivergedError(
                                f"non-finite loss {loss} at optimizer step {step}; restart "
                                f"with --resume_from auto to continue from the last "
                                f"checkpoint in {targs.output_dir}")
                        if need_log:
                            dt = time.perf_counter() - t_window
                            self.logged.append({"step": step, "loss": loss, "grad_norm": gnorm})
                            last_metrics = {
                                "step": step, "epoch": epoch, "loss": loss, "grad_norm": gnorm,
                                "step_time_s": round(dt, 4),
                                "tokens_per_s": round(
                                    tokens_seen / (time.perf_counter() - t_start), 1),
                            }
                            self._log(last_metrics)
                    # Telemetry: the optimizer step's wall time split into
                    # data wait (iterator + host-to-device) and compute.
                    step_wall = time.perf_counter() - t_window
                    self.step_seconds.append(step_wall)
                    compute_s = max(step_wall - win_data_wait, 0.0)
                    obs_metrics.TRAIN_STEP_SECONDS.observe(step_wall)
                    obs_metrics.TRAIN_COMPUTE.observe(compute_s)
                    obs_metrics.TRAIN_STEPS.inc()
                    if need_log:
                        obs_metrics.TRAIN_LOSS.set(loss)
                        obs_metrics.TRAIN_GRAD_NORM.set(gnorm)
                    if self.telemetry is not None:
                        os.makedirs(targs.output_dir, exist_ok=True)
                        rec = {"step": step, "micro": micro,
                               "step_wall_s": round(step_wall, 6),
                               "data_wait_s": round(win_data_wait, 6),
                               "compute_s": round(compute_s, 6),
                               "tokens_seen": tokens_seen}
                        if need_log:
                            rec["loss"] = loss
                            rec["grad_norm"] = gnorm
                        # The registry's view, as /metrics would show it.
                        rec["registry"] = obs_metrics.REGISTRY.summary(("egpt_train_",))
                        self.telemetry.write(rec)
                    self._maybe_profile(step)
                    win_data_wait = 0.0
                    window.clear()
                    t_window = time.perf_counter()
                    now = time.perf_counter()
                    if pdist.is_primary() and (
                            need_log or now - last_beat > targs.heartbeat_interval_s):
                        self.heartbeat.beat(step, **({"loss": loss} if need_log else {}))
                        last_beat = now
                    if need_save:
                        self.save(f"step{step}")
                        ckpt_tokens[self._last_ckpt] = tokens_seen
                    if (self.eval_dataset is not None and targs.eval_steps > 0
                            and step % targs.eval_steps == 0):
                        last_metrics = {**last_metrics, **self.evaluate(step)}
                        last_eval_step = step
                    if 0 < targs.max_steps <= step:
                        done = True
                        break
            finally:
                if isinstance(it, PrefetchIterator):
                    it.close()
            if diverged:
                # Replay from the restored step; rewinds bump the shuffle seed.
                epoch -= 1
        if (self.eval_dataset is not None and targs.eval_steps >= 0
                and last_eval_step != step):
            last_metrics = {**last_metrics, **self.evaluate(step)}
        self.save("last")
        return last_metrics
