"""The port's multi-process dry run (``parallel/multiproc.py``) across real
OS processes, on the CPU over gloo (``device="cpu"``: the entry point's
default is the card, which ``test_dryrun_defaults_to_the_card`` holds).

One dry run (two worker processes joined through the ``EGPT_*`` contract,
a mesh of fsdp 2 spanning them, plus the single-process reference job)
serves every check of its test:

- the two stage-2 losses equal the single-process reference's within 1e-5
  relative (the launcher raises otherwise);
- the checkpoint is gathered whole and written once, by rank 0, and every
  rank restores its blocks bit for bit (rank 1 included);
- a preemption requested on rank 1 alone is agreed on both ranks, which
  checkpoint at the same step.

A second launch with ``EGPT_FAULTS=multiproc.worker:n=1`` in rank 1's
environment fails with rank 1 named, within seconds, and no worker left;
``multiproc.launch`` armed in the launcher's process fails it before any
worker starts.

``cli/train`` under ``python -m torch.distributed.run`` (a world of 2,
context 2, Ulysses, gloo): rank 0 alone writes ``metrics.jsonl`` and the
checkpoints, every rank prints its ``[mesh-rank]`` line with the same
losses, and a second launch with ``--resume_from auto`` restores every
rank's blocks and takes step 3.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from eventgpt_tpu_torch import faults
from eventgpt_tpu_torch.parallel.multiproc import launch_multiprocess_dryrun


def test_multiprocess_train_checkpoint_and_preemption_match_one_process():
    summary = launch_multiprocess_dryrun(n_processes=2, mesh_shape=(1, 2, 1, 1), n_steps=2,
                                         attn_impl="dense", device="cpu", timeout=120.0)
    assert summary["mesh"] == {"data": 1, "fsdp": 2, "context": 1, "model": 1}
    assert summary["devices"] == ["cpu", "cpu"] and summary["device_single_process"] == "cpu"
    assert len(summary["losses_multiproc"]) == 2
    assert summary["losses_multiproc"] == pytest.approx(summary["losses_single_process"],
                                                        rel=1e-5)
    ranks = sorted(summary["ranks"], key=lambda r: r["rank"])
    assert [r["ckpt_written_by_me"] for r in ranks] == [True, False]
    assert all(r["resumed_ok"] for r in ranks)
    assert summary["checkpoints"] == {"ckpt_mp": ["STEP", "state.pt"],
                                      "ckpt_preempt_step2": ["STEP", "state.pt"]}
    pre = [r["preempt"] for r in ranks]
    assert [p["local_flag"] for p in pre] == [False, True]
    assert all(p["agreed"] for p in pre)
    assert pre[0]["step"] == pre[1]["step"] == 2
    assert [p["reason"] for p in pre] == ["peer", "simulated-preemption"]


def test_worker_fault_surfaces_as_that_ranks_failure():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)worker rank 1 failed.*multiproc\.worker"):
        launch_multiprocess_dryrun(n_processes=2, mesh_shape=(1, 2, 1, 1), device="cpu",
                                   timeout=60.0,
                                   worker_env={1: {"EGPT_FAULTS": "multiproc.worker:n=1"}})
    assert time.monotonic() - t0 < 30


def test_launch_fault_fails_before_any_worker():
    faults.configure("multiproc.launch:n=1")
    try:
        with pytest.raises(faults.InjectedFault, match="multiproc.launch"):
            launch_multiprocess_dryrun(n_processes=2, mesh_shape=(1, 2, 1, 1))
    finally:
        faults.configure("")


def test_dryrun_defaults_to_the_card():
    """The entry point runs on the card unless ``--device cpu`` is given; an
    unknown device is refused before any process starts."""
    from eventgpt_tpu_torch.parallel.multiproc import build_parser

    assert build_parser().parse_args([]).device == "cuda"
    assert build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(ValueError, match="device 'gpu'"):
        launch_multiprocess_dryrun(n_processes=2, mesh_shape=(1, 2, 1, 1), device="gpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, env):
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    try:
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return [json.loads(ln.split("[mesh-rank] ", 1)[1]) for ln in stderr.splitlines()
            if "[mesh-rank] " in ln], stderr


def test_cli_train_under_a_world_of_two_checkpoints_from_rank0_and_resumes(tmp_path):
    from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

    entries = []
    for i in range(2):
        np.save(tmp_path / f"ev{i}.npy", synthetic_event_stream(100 + i, n_events=2000))
        entries.append({"id": i, "event": f"ev{i}.npy", "conversations": [
            {"from": "human", "value": f"<event>\nWhat moves {i}?"},
            {"from": "gpt", "value": f"A car {i}."}]})
    (tmp_path / "qa.json").write_text(json.dumps(entries))
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(var, None)

    def argv(*extra):
        return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
                "-m", "eventgpt_tpu_torch.cli.train", "--model_path", "tiny-random",
                "--data_path", str(tmp_path / "qa.json"), "--event_folder", str(tmp_path),
                "--stage", "2", "--lora_r", "4", "--per_device_train_batch_size", "2",
                "--bf16", "false", "--device", "cpu", "--mesh_context", "2",
                "--attn_impl", "ulysses", "--logging_steps", "1", "--output_dir", str(out),
                *extra]

    reports, stderr = _launch(argv("--max_steps", "2", "--save_steps", "2"), env)
    assert sorted(r["rank"] for r in reports) == [0, 1]
    assert reports[0]["losses"] == reports[1]["losses"] and len(reports[0]["losses"]) == 2
    assert "backend gloo" in stderr
    steps = [json.loads(ln)["step"] for ln in open(out / "metrics.jsonl") if '"loss"' in ln]
    assert steps == [1, 2]
    assert sorted(d for d in os.listdir(out) if d.startswith("ckpt_")) == ["ckpt_last",
                                                                           "ckpt_step2"]
    assert not any(".tmp-" in d for d in os.listdir(out))

    reports, stderr = _launch(argv("--max_steps", "3", "--resume_from", "auto"), env)
    assert "auto-resuming" in stderr
    assert [r["micro_steps"] for r in reports] == [3, 3]
    assert reports[0]["losses"] == reports[1]["losses"] and len(reports[0]["losses"]) == 1
    steps = [json.loads(ln)["step"] for ln in open(out / "metrics.jsonl") if '"loss"' in ln]
    assert steps == [1, 2, 3]
    assert open(out / "ckpt_last" / "STEP").read() == "3"
