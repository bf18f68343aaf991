"""Real ``cli/serve --worker --device cpu`` processes behind the port's
``ProcFleet``: each loads a tiny f32 checkpoint (written by the port; the
JAX reference loads it too) and serves paged int8-KV batchers. Two fleets, three legs:

- colocated (2 workers): the chains equal the JAX ``ContinuousBatcher``'s on
  the same checkpoint, each worker's ``stats`` op carries the kernels'
  launch counts (0 on the CPU);
- SIGKILL on the same fleet: ``procfleet.worker_kill`` kills the busiest
  worker mid-decode, its requests redo on the survivor with the same
  chains, and the slot respawns;
- disaggregated (1 prefill : 1 decode): the chains equal the colocated
  ones, and every record that crossed the processes holds the int8 KV
  payload of the port's in-process handoff bit for bit.

Also a ``--device cuda`` worker on a machine without a card, booked as a
crash. Every wait is bounded and every fleet shuts down in a ``finally``."""

import os

import numpy as np
import pytest
import torch

from eventgpt_tpu import serve as jserve
from eventgpt_tpu.cli.infer import load_model as jload_model
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
from eventgpt_tpu_torch.fleet_proc import ProcFleet
from eventgpt_tpu_torch.models.convert import init_eventchat_params, write_hf_checkpoint

WAIT_S = 90.0
BUDGET = 48
SERVE_FLAGS = ["--dtype", "float32", "--device", "cpu", "--tokenizer_path", "byte",
               "--max_batch", "2", "--chunk", "2", "--max_len", "256", "--kv_layout", "paged",
               "--kv_pool_blocks", "12", "--kv_cache", "int8"]


@pytest.fixture(autouse=True)
def _disarm():
    tfaults.disable()
    yield
    tfaults.disable()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The checkpoint (written by the port, loaded by both packages), the
    requests and the JAX batcher's chains on them."""
    ckpt = str(tmp_path_factory.mktemp("procfleet") / "ckpt")
    cfg = tcfg.EventChatConfig.tiny()
    write_hf_checkpoint(init_eventchat_params(cfg, torch.Generator().manual_seed(0),
                                              torch.float32, "cpu"), cfg, ckpt)
    jcfg, params, _ = jload_model(ckpt, "float32", None, "byte")
    size = jcfg.vision.image_size
    reqs = []
    for i in range(4):
        pv = np.random.default_rng(400 + i).normal(
            size=(jcfg.num_event_frames, 3, size, size)).astype(np.float32)
        reqs.append(([1, 7, 7, -200, 9, 10, 11, 80 + i], pv, BUDGET))
    ref = jserve.ContinuousBatcher(params, jcfg, max_batch=2, chunk=2, max_len=256,
                                   eos_token_id=2, kv_quant=True, kv_layout="paged",
                                   kv_pool_blocks=12)
    rids = [ref.submit(*r) for r in reqs]
    done = ref.run_until_drained()
    return ckpt, reqs, [done[r] for r in rids]


def _fleet(ckpt, *flags):
    args = tcli.build_parser().parse_args(["--model_path", ckpt, "--proc_fleet", "2",
                                           "--fleet_probe_interval_s", "0.02",
                                           "--procfleet_respawn_backoff_s", "0.05",
                                           "--procfleet_spawn_timeout_s", str(WAIT_S),
                                           *SERVE_FLAGS, *flags])
    return tcli.build_engine(args)[1]


def _wait(cond, what):
    import time

    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {WAIT_S} s waiting for {what}")
        time.sleep(0.005)


def test_colocated_chains_equal_jax_then_a_sigkill_redoes_them(tiny, monkeypatch):
    ckpt, reqs, want = tiny
    # The workers inherit a 10 ms sleep per scheduler step (a tiny model on
    # the CPU finishes 48 tokens before a probe tick could see them).
    monkeypatch.setenv("EGPT_FAULTS", "serve.step:delay=0.01")
    fleet = _fleet(ckpt)
    try:
        assert [s.role for s in fleet.slots] == ["colocated", "colocated"]
        frids = [fleet.submit_ids(*r) for r in reqs]
        assert [fleet.result(f, timeout=WAIT_S) for f in frids] == want
        assert [fleet.worker_of(f) for f in frids] == [0, 1, 0, 1]
        for i in range(2):
            st = fleet.worker_stats(i)
            assert st["launches"] == {"flash_attention.cu": 0, "int4_matmul.cu": 0,
                                      "decode_attention.cu": 0, "paged_attention.cu": 0}
            assert st["int4_launches_by_m"] == {} and "cuda_memory" not in st
            assert st["requests"] == 2

        # The redo leg: the busiest worker SIGKILLed once rows decode.
        frids = [fleet.submit_ids(*r) for r in reqs]
        _wait(lambda: any(s.snapshot.get("active_rows", 0) for s in fleet.slots),
              "a decoding worker")
        tfaults.configure("procfleet.worker_kill:n=1")
        _wait(lambda: fleet.n_deaths >= 1, "the scripted SIGKILL")
        assert tfaults.stats()["procfleet.worker_kill"]["fires"] == 1
        assert [fleet.result(f, timeout=WAIT_S) for f in frids] == want
        moved = [f for f in frids if fleet._requests[f].failovers]
        killed = next(s.idx for s in fleet.slots if s.kills)
        assert moved and fleet.n_failovers == len(moved) and fleet.n_kills == 1
        assert {fleet.worker_of(f) for f in moved} == {1 - killed}
        _wait(lambda: all(s.state == "ok" for s in fleet.slots), "the respawn")
        assert fleet.n_respawns == 1
        assert sum(len(s.crashes) for s in fleet.slots) == 1
    finally:
        fleet.shutdown()
    assert all(s.proc is None for s in fleet.slots)


def test_disaggregated_chains_equal_colocated_and_records_cross_bit_exact(tiny):
    ckpt, reqs, want = tiny
    # The port's in-process handoff on the same checkpoint, one request at
    # a time as the fleet's prefill worker takes them below.
    args = tcli.build_parser().parse_args(["--model_path", ckpt, *SERVE_FLAGS])
    cfg, params, tok = load_model(ckpt, "float32", None, "byte", "cpu")
    cfg, params = prepare_model(cfg, params, tok, args)
    pre = tcli.make_batcher(args, params, cfg, tok, "cpu", role="prefill")
    local = []
    for r in reqs:
        pre.submit(*r)
        while pre.queue or any(x is not None for x in pre.rows):
            pre.step()
        local += pre.pop_handoffs()
    assert len(local) == len(reqs)

    fleet = _fleet(ckpt, "--proc_fleet_roles", "1:1")
    shipped = []
    ship = fleet._ship_handoff

    def spy(src, out):
        shipped.append(out)
        return ship(src, out)

    fleet._ship_handoff = spy
    try:
        assert [s.role for s in fleet.slots] == ["prefill", "decode"]
        frids = []
        for r in reqs:
            frids.append(fleet.submit_ids(*r))
            _wait(lambda: fleet.n_handoffs == len(frids), "the ship")
        assert [fleet.result(f, timeout=WAIT_S) for f in frids] == want
        assert [fleet.worker_of(f) for f in frids] == [1] * len(reqs)
        fl = fleet.fleet_stats()
        assert fl["handoffs"]["shipped"] == len(reqs) and fl["handoffs"]["redos"] == 0
        assert fl["handoffs"]["bytes"] == sum(o["rec"]["nbytes_kv"] for o in local)
        assert fleet.worker_stats(0)["launches"]["flash_attention.cu"] == 0
    finally:
        fleet.shutdown()
    assert [o["rid"] for o in shipped] == [o["rid"] for o in local]
    for got, sent in zip(shipped, local):
        assert got["input_ids"] == sent["input_ids"] and got["tokens"] == sent["tokens"]
        for key in ("k", "v"):
            for plane in ("q", "s"):
                g, s = got["rec"][key][plane], sent["rec"][key][plane]
                assert g.dtype == s.dtype and torch.equal(g, s), (key, plane)
        assert got["rec"]["k"]["q"].dtype == torch.int8
        assert torch.equal(got["rec"]["logits"], sent["rec"]["logits"])
        assert int(got["rec"]["length"]) == int(sent["rec"]["length"])


def test_a_cuda_worker_without_a_card_is_booked_as_a_crash(tmp_path, monkeypatch):
    """A worker asked for the card that finds none exits non-zero; the
    coordinator books the crash (here the breaker gives the one slot up at
    once) and no worker carries on on the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    args = tcli.build_parser().parse_args(["--proc_fleet", "2", "--dtype", "float32"])
    assert "cuda" in tcli._worker_argv(args)
    with pytest.raises(RuntimeError, match="no worker became routable"):
        ProcFleet(tcli._worker_argv(args), 1, workdir=str(tmp_path), crash_limit=1,
                  spawn_timeout_s=WAIT_S)
    with open(os.path.join(str(tmp_path), "worker0.log")) as f:
        log = f.read()
    assert "no CUDA device" in log, log[-2000:]
