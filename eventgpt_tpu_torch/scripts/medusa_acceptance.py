"""Trained Medusa heads against lookup drafting on the same served traffic.

The port of ``scripts/medusa_acceptance.py``, reproducible in-tree:

  1. Build the deterministic motion-QA corpus (``data/motion_corpus.py``):
     pixels -> direction and speed is learnable, the per-sample track
     counts are not echoable.
  2. Finetune the tiny model (the LM and the projector; CLIP frozen) until
     its greedy captions track the corpus.
  3. Train a Medusa head stack (``train/medusa.py``) on the same data.
  4. Serve the held-out split through three fresh ``ContinuousBatcher``
     instances -- lookup drafts, trained heads, random heads -- with the
     same traffic, budgets and windows, and compare the realized
     acceptance (``spec_tokens_per_iteration``: committed tokens per weight
     pass).

Greedy chains must be identical across the three (speculation is exact);
only the acceptance may differ. Prints one JSON line, with the JAX
script's keys. ``_finetune``, ``_train_heads`` and ``_serve_traffic`` take
the parameter tree, so a test can feed them a tree converted from the JAX
package. ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _finetune(cfg, params, tokenizer, dataset, steps, batch_size, lr, log_every, device):
    """Full-model finetune (LM + projector; CLIP frozen). The trained
    tensors are updated in place; returns (the tree, the last logged
    loss)."""
    from eventgpt_tpu_torch.train import steps as steps_mod
    from eventgpt_tpu_torch.train.data import batch_iterator
    from eventgpt_tpu_torch.train.optim import (linear_warmup_cosine, make_optimizer,
                                                tree_leaves)

    trainable = {"llama": params["llama"], "projector": params["projector"]}
    frozen = {"clip": params["clip"]}

    def combine(trainable, frozen, step=None):
        return {"clip": frozen["clip"], "llama": trainable["llama"],
                "projector": trainable["projector"]}

    opt = make_optimizer(linear_warmup_cosine(lr, steps, max(steps // 20, 1)))
    state = steps_mod.init_train_state(trainable, frozen, opt)
    step_fn = steps_mod.make_train_step(cfg, opt, combine)

    step, loss = 0, float("nan")
    epoch = 0
    while step < steps:
        for host in batch_iterator(dataset, batch_size, cfg, shuffle=True, seed=epoch):
            state, metrics = step_fn(state, steps_mod.batch_to_device(host, device))
            step += 1
            if step % log_every == 0 or step == steps:
                loss = float(metrics["loss"])
                print(f"[finetune] step {step}/{steps} loss {loss:.4f}",
                      file=sys.stderr, flush=True)
            if step >= steps:
                break
        epoch += 1
    if not loss == loss:
        raise RuntimeError("finetune diverged (NaN)")
    for _, t in tree_leaves(trainable):
        t.requires_grad_(False)
    return {"clip": frozen["clip"], "llama": state.trainable["llama"],
            "projector": state.trainable["projector"]}, loss


def _train_heads(cfg, params, dataset, num_heads, steps, batch_size, lr, log_every, device):
    from eventgpt_tpu_torch.train.data import batch_iterator
    from eventgpt_tpu_torch.train.medusa import (init_medusa_state, make_adamw,
                                                 make_medusa_train_step)
    from eventgpt_tpu_torch.train.steps import batch_to_device

    opt = make_adamw(lr)
    state = init_medusa_state(cfg, params, num_heads, opt)
    step_fn = make_medusa_train_step(cfg, opt)
    step, loss = 0, float("nan")
    epoch = 0
    while step < steps:
        for host in batch_iterator(dataset, batch_size, cfg, shuffle=True, seed=1000 + epoch):
            state, metrics = step_fn(state, batch_to_device(host, device))
            step += 1
            if step % log_every == 0 or step == steps:
                loss = float(metrics["loss"])
                print(f"[medusa] step {step}/{steps} loss {loss:.4f} "
                      f"per_head {[round(float(x), 3) for x in metrics['per_head_loss']]}",
                      file=sys.stderr, flush=True)
            if step >= steps:
                break
        epoch += 1
    if not loss == loss:
        raise RuntimeError("medusa training diverged (NaN)")
    return state.trainable, loss


def _serve_traffic(params, cfg, traffic, draft_head, speculative, budget, max_batch, eos,
                   device):
    """One fresh batcher (a cold history: the honest serving start), all
    the eval requests -> (answers by submit order, tokens per iteration,
    wall s)."""
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    srv = ContinuousBatcher(params, cfg, max_batch=max_batch, max_len=256, chunk=16,
                            eos_token_id=eos, speculative=speculative, draft_head=draft_head,
                            device=device)
    # Warm every function, then zero the counters: the first draft must not
    # pay everyone's first calls, and the acceptance counters must hold the
    # measured traffic only.
    srv.warmup(prompt_lens=[len(traffic[0][0]) + 16])
    srv.reset_serving_stats()
    t0 = time.perf_counter()
    rids = [srv.submit(ids, px, budget) for ids, px in traffic]
    outs = srv.run_until_drained()
    wall = time.perf_counter() - t0
    return [outs[r] for r in rids], srv.spec_tokens_per_iteration(), wall


def eval_traffic(cfg, tokenizer, eval_entries, events_dir):
    """The held-out requests: the serving twin of ``preprocess_plain``'s
    layout (bos, the event block, a newline), the distribution the model
    was tuned on."""
    from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX
    from eventgpt_tpu_torch.ops.image import process_event_file

    nl = tokenizer("\n", add_special_tokens=False)["input_ids"]
    bos = getattr(tokenizer, "bos_token_id", None)
    prompt = ([bos] if bos is not None else []) + [EVENT_TOKEN_INDEX] + list(nl)
    traffic = []
    for e in eval_entries:
        _, px = process_event_file(os.path.join(events_dir, e["event"]),
                                   cfg.num_event_frames, cfg.vision.image_size)
        traffic.append((list(prompt), px))
    return traffic


def random_heads(shape, device):
    """The study's random heads: ``np.random.default_rng(7)`` normals
    times 0.5, in f32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    w = rng.normal(size=tuple(shape)).astype(np.float32) * 0.5
    return {"w": torch.from_numpy(w).to(device)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Medusa vs lookup acceptance (PyTorch)")
    p.add_argument("--out_dir", default=None,
                   help="corpus/workspace dir (default: fresh tempdir)")
    p.add_argument("--n_train", type=int, default=96)
    p.add_argument("--n_eval", type=int, default=16)
    p.add_argument("--finetune_steps", type=int, default=600)
    p.add_argument("--medusa_steps", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--medusa_lr", type=float, default=2e-3)
    p.add_argument("--num_heads", type=int, default=3)
    p.add_argument("--speculative", type=int, default=4)
    p.add_argument("--budget", type=int, default=56)
    p.add_argument("--max_batch", type=int, default=1,
                   help="1 = sequential serving, so tokens_per_iteration is PER-CHAIN "
                        "acceptance; >1 reports aggregate per weight pass")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_heads", default=None,
                   help="optionally save the trained stack (.npz)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from eventgpt_tpu_torch.cli.infer import load_model
    from eventgpt_tpu_torch.data.motion_corpus import build_motion_corpus
    from eventgpt_tpu_torch.device import resolve_device
    from eventgpt_tpu_torch.train.data import EventChatDataset

    device = resolve_device(args.device)
    args_dir = args.out_dir or tempfile.mkdtemp(prefix="medusa_acc_")
    paths = build_motion_corpus(args_dir, args.n_train, args.n_eval)
    cfg, params, tokenizer = load_model("tiny-random", "float32", None, None, device=device)
    dataset = EventChatDataset(paths["train"], tokenizer, cfg, event_folder=paths["events"],
                               conv_version="plain")

    t0 = time.perf_counter()
    model, ft_loss = _finetune(cfg, params, tokenizer, dataset, args.finetune_steps,
                               args.batch_size, args.lr, args.log_every, device)
    ft_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    heads, md_loss = _train_heads(cfg, model, dataset, args.num_heads, args.medusa_steps,
                                  args.batch_size, args.medusa_lr, args.log_every, device)
    md_s = time.perf_counter() - t0
    if args.save_heads:
        from eventgpt_tpu_torch.models.medusa import save_medusa

        save_medusa(args.save_heads, heads)

    with open(paths["eval"]) as f:
        eval_entries = json.load(f)
    traffic = eval_traffic(cfg, tokenizer, eval_entries, paths["events"])
    eos = getattr(tokenizer, "eos_token_id", None)

    results = {}
    answers = {}
    for name, draft in (("lookup", None), ("medusa_trained", heads),
                        ("medusa_random", random_heads(heads["w"].shape, device))):
        outs, tpi, wall = _serve_traffic(model, cfg, traffic, draft, args.speculative,
                                         args.budget, args.max_batch, eos, device)
        results[name] = {"tokens_per_iteration": round(tpi, 3), "wall_s": round(wall, 2)}
        answers[name] = outs

    # Exactness: speculation must never change the greedy chain.
    if not (answers["lookup"] == answers["medusa_trained"] == answers["medusa_random"]):
        raise RuntimeError("greedy chains diverged across draft types -- "
                           "speculation exactness violated")

    # How well the model learned the distribution: context for the
    # acceptance numbers, not a correctness gate.
    decoded = tokenizer.batch_decode(answers["lookup"], skip_special_tokens=True)
    exact = sum(d.strip() == e["conversations"][1]["value"].strip()
                for d, e in zip(decoded, eval_entries))

    record = {
        "metric": "medusa_vs_lookup_tokens_per_iteration",
        "value": results["medusa_trained"]["tokens_per_iteration"],
        "unit": "tok/weight-pass",
        "lookup": results["lookup"],
        "medusa_trained": results["medusa_trained"],
        "medusa_random": results["medusa_random"],
        "speculative_window": args.speculative,
        "num_heads": args.num_heads,
        "traffic_requests": len(traffic),
        "budget": args.budget,
        "finetune": {"steps": args.finetune_steps, "loss": round(ft_loss, 4),
                     "wall_s": round(ft_s, 1)},
        "medusa_train": {"steps": args.medusa_steps, "loss": round(md_loss, 4),
                         "wall_s": round(md_s, 1)},
        "eval_caption_exact": f"{exact}/{len(decoded)}",
        "workspace": args_dir,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
