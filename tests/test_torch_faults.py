"""Fault injection in the port (``eventgpt_tpu_torch/faults.py``) against the
JAX package's (``eventgpt_tpu/faults.py``), and the batcher's and trainer's
fault sites against the JAX batcher's, f32 on the CPU.

- The registry: for a grid of ``n``, ``every``, ``p`` (with a seed),
  ``times`` and ``delay`` specs, the port fires on the same calls as the JAX
  registry over 1000 calls, with the same stats; ``EGPT_FAULTS`` and
  ``EGPT_FAULTS_SEED`` arm it; bad specs raise the JAX errors.
- The sites, each stepped in lockstep with the JAX batcher under the same
  spec (each package's own registry armed with it): ``serve.step`` and
  ``serve.admit`` reach the caller and the queued request survives;
  ``serve.mixed_dispatch`` re-queues the lanes and leaves the decode rows'
  chains alone; ``serve.spec_adapt`` takes the fixed default window for
  that boundary; ``serve.preempt`` defers and ``serve.spill`` drops, with
  the pool intact. Every chain equals the JAX batcher's under the spec.
  ``train.step`` fires once per micro-batch of the port's trainer.
"""

import json

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
LONG_S = 3600.0
SPECS = ["s:n=1", "s:n=7", "s:n=1000", "s:every=1", "s:every=3", "s:every=7,times=4",
         "s:p=0.3", "s:p=0.5,times=10", "s:p=0.05", "s:p=0.9,times=999", "s:every=2;t:n=3",
         "s:n=5,times=3", "s:delay=0.000001", "s:delay=0.000001,every=5",
         "s:delay=0.000001,p=0.25,times=7"]
SEEDS = [0, 7, 12345]


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.disable()
    tfaults.disable()
    yield
    jfaults.disable()
    tfaults.disable()


def _pattern(mod, spec: str, seed: int, calls: int = 1000):
    """The calls of sites s and t (in turn) that fire, failures and delays,
    and the registry's stats after."""
    reg = mod.FaultRegistry(spec, seed)
    fired = []
    for i in range(calls):
        for site in ("s", "t"):
            for want_delay in (False, True):
                if reg.check(site, want_delay) is not None:
                    fired.append((i, site, want_delay))
    return fired, reg.stats()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spec", SPECS)
def test_firing_pattern_equals_jax(spec, seed):
    got = _pattern(tfaults, spec, seed)
    assert got == _pattern(jfaults, spec, seed)
    assert got[0], "the spec never fired: the comparison is empty"


def test_module_probes_fire_as_jax():
    seqs = {}
    for mod in (jfaults, tfaults):
        mod.configure("a:every=3,times=2;b:p=0.4;c:delay=0.000001,n=2", seed=3)
        out = []
        for i in range(30):
            for site in ("a", "b", "c", "unarmed"):
                try:
                    mod.maybe_fail(site)
                except mod.InjectedFault as e:
                    out.append((i, site, str(e)))
                if mod.maybe_delay(site):
                    out.append((i, site, "delay"))
        seqs[mod.__name__] = (out, mod.stats())
        assert mod.enabled()
        mod.disable()
        assert not mod.enabled() and mod.stats() == {}
    assert seqs["eventgpt_tpu_torch.faults"] == seqs["eventgpt_tpu.faults"]
    assert issubclass(tfaults.InjectedFault, RuntimeError)


def test_env_var_and_seed_arm_both(monkeypatch):
    monkeypatch.setenv("EGPT_FAULTS", "envsite:p=0.5")
    monkeypatch.setenv("EGPT_FAULTS_SEED", "11")
    pats = []
    for mod in (jfaults, tfaults):
        mod.configure()
        out = []
        for _ in range(64):
            try:
                mod.maybe_fail("envsite")
                out.append(0)
            except mod.InjectedFault:
                out.append(1)
        pats.append(out)
    assert pats[0] == pats[1] and 0 < sum(pats[1]) < 64
    monkeypatch.setenv("EGPT_FAULTS", "")
    tfaults.configure()
    assert not tfaults.enabled()


@pytest.mark.parametrize("spec,match", [("nocolon", "site:key=value"),
                                        ("x:frequency=2", "unknown fault key"),
                                        ("x:n=abc", "could not convert")])
def test_bad_specs_raise_as_jax(spec, match):
    errs = []
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match=match) as e:
            mod.configure(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the batcher's sites, in lockstep with the JAX batcher -----------------

def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _pair(trees, **kw):
    args = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **args),
            jserve.ContinuousBatcher(trees[0], JCFG, **args))


def _arm(spec):
    jfaults.configure(spec)
    tfaults.configure(spec)


def _step_both(port, jsrv):
    """One step of each; the name of the fault each raised (None if none),
    which must be the same."""
    raised = []
    for srv, mod in ((port, tfaults), (jsrv, jfaults)):
        try:
            srv.step()
            raised.append(None)
        except mod.InjectedFault as e:
            raised.append(str(e).split(" (")[0])
    assert raised[0] == raised[1], raised
    return raised[0]


def _drive(port, jsrv, late=(), late_after=2, limit=300, same_schedule=True):
    """Step both until drained (submitting ``late`` after ``late_after``
    steps), holding the queues and rows equal after every step unless
    ``same_schedule`` is off; returns the faults raised, by step."""
    raised = {}
    for n in range(limit):
        if n == late_after:
            for ids, seed, budget, slo in late:
                _submit_both(port, jsrv, ids, seed, budget, slo)
        if n >= late_after and not (port.queue or jsrv.queue) and all(
                r is None for r in port.rows + jsrv.rows):
            break
        got = _step_both(port, jsrv)
        if got:
            raised[n] = got
        if not same_schedule:
            continue
        assert [q.rid for q in port.queue] == [q.rid for q in jsrv.queue], n
        assert ([r.rid if r else None for r in port.rows]
                == [r.rid if r else None for r in jsrv.rows]), n
    else:
        pytest.fail("the scenario does not drain")
    port._drain()
    jsrv._drain()
    assert port.finished == jsrv.finished
    assert port.finish_status == jsrv.finish_status
    return raised


def _submit_both(port, jsrv, ids, seed, budget, slo=None):
    """Submit to both; ``slo`` is a dict of ``workload.SLO`` fields."""
    rid = port.submit(ids, _pv(seed), budget, slo=slo and twork.SLO(**slo))
    assert jsrv.submit(ids, _pv(seed), budget, slo=slo and jwork.SLO(**slo)) == rid
    return rid


@pytest.mark.parametrize("spec", ["serve.step:n=2", "serve.admit:n=1"])
def test_step_and_admit_faults_reach_the_caller_as_jax(trees, spec):
    site = spec.split(":")[0]
    port, jsrv = _pair(trees, max_batch=1)
    rid = _submit_both(port, jsrv, [1, -200, 5], 0, 6)
    _arm(spec)
    raised = _drive(port, jsrv)
    assert list(raised.values()) == [f"injected fault at {site}"]
    assert len(port.finished[rid]) == 6 and port.finish_status[rid] == "ok"
    assert tfaults.stats()[site] == jfaults.stats()[site]


@pytest.mark.parametrize("spec", ["serve.mixed_dispatch:n=1", "serve.mixed_dispatch:every=1"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mixed_dispatch_fault_requeues_lanes_as_jax(trees, spec, layout):
    _arm(spec)
    port, jsrv = _pair(trees, prefill_budget=16, prefill_lane_chunk=4, kv_layout=layout)
    a = _submit_both(port, jsrv, [1, 5, -200, 9, 9], 0, 24)
    # Paged, the JAX handler keeps a re-queued lane's reservation (its pool
    # ends with every block used), so its gate defers where the port, which
    # releases it, admits: the schedules part, the chains do not.
    _drive(port, jsrv, late=[([1, 5, -200, 3], 0, 8, None), ([2, 6, -200, 11], 3, 7, None)],
           same_schedule=layout == "dense")
    assert tfaults.stats()["serve.mixed_dispatch"]["fires"] >= 1
    if layout == "dense":
        assert tfaults.stats() == jfaults.stats()
    # The lane requests re-admitted and finished; the decode row never noticed.
    assert sorted(port.finished) == [a, a + 1, a + 2]
    assert all(s == "ok" for s in port.finish_status.values())
    assert not port._lanes and len(port._lane_free) == port._lane_cap
    if layout == "paged":
        st = port._pool.stats()
        assert st["free_blocks"] == st["usable_blocks"] - \
            port.prefix_cache_stats().get("blocks_held", 0)


def test_spec_adapt_fault_takes_the_default_window_as_jax(trees):
    _arm("serve.spec_adapt:n=2")
    port, jsrv = _pair(trees, spec_buckets="0,2,4")
    _submit_both(port, jsrv, [1, 5, -200, 9, 9], 0, 30)
    _submit_both(port, jsrv, [1, -200, 7, 7], 1, 12)
    _drive(port, jsrv, late=[([3, -200, 11], 3, 9, None)])
    assert tfaults.stats()["serve.spec_adapt"] == jfaults.stats()["serve.spec_adapt"]
    assert tfaults.stats()["serve.spec_adapt"]["fires"] == 1
    assert list(port.spec_depth_trace) == list(jsrv.spec_depth_trace)
    assert list(port.spec_depth_trace)[1] == port._spec_ctl.default_window


@pytest.mark.parametrize("spec", ["serve.preempt:n=1", "serve.spill:n=1"])
def test_preempt_and_spill_faults_fall_back_as_jax(trees, spec):
    site = spec.split(":")[0]
    _arm(spec)
    port, jsrv = _pair(trees, kv_layout="paged", preempt=True, kv_pool_blocks=4,
                       spill_capacity_mb=64)
    port._recompute_flops_per_s = jsrv._recompute_flops_per_s = 1.0  # price spills in
    rb = _submit_both(port, jsrv, [1, 5, -200, 9, 9], 0, 40,
                      slo=dict(name="batch", latency_s=LONG_S))
    _drive(port, jsrv, late=[([3, -200, 11, 4], 1, 12,
                              dict(name="interactive", ttft_s=LONG_S))], late_after=6)
    assert tfaults.stats()[site] == jfaults.stats()[site]
    assert tfaults.stats()[site]["fires"] == 1
    assert port.preemptions == jsrv.preemptions and port.block_deferrals == jsrv.block_deferrals
    st = port._pool.stats()
    assert st == jsrv._pool.stats()
    if site == "serve.spill":
        assert port.preemptions >= 1 and st["spills"] == 0  # dropped, not spilled
    assert len(port.finished[rb]) == 40
    assert st["free_blocks"] + st["used_blocks"] == st["usable_blocks"]
    assert st["spilled_runs"] == 0 and port._spill_store.stats()["records"] == 0


def test_train_step_fires_once_per_micro_batch(tmp_path):
    from eventgpt_tpu_torch.data.tokenizer import load_tokenizer
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
    from eventgpt_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments
    from eventgpt_tpu_torch.train.trainer import Trainer

    for i in range(2):
        np.save(tmp_path / f"ev{i}.npy", synthetic_event_stream(100 + i, n_events=4000))
    entries = [{"event": f"ev{i % 2}.npy", "conversations": [
        {"from": "human", "value": "<event>\nWhat is happening?"},
        {"from": "gpt", "value": f"Answer {i}."}]} for i in range(4)]
    (tmp_path / "qa.json").write_text(json.dumps(entries))
    cfg = TCFG
    params = init_eventchat_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")

    def trainer(out):
        targs = TrainingArguments(output_dir=str(tmp_path / out), stage=1, max_steps=2,
                                  per_device_train_batch_size=2, logging_steps=1,
                                  save_steps=-1, bf16=False)
        return Trainer(cfg, params, load_tokenizer("byte"), ModelArguments(),
                       DataArguments(data_path=str(tmp_path / "qa.json"),
                                     event_folder=str(tmp_path)), targs, device="cpu")

    tfaults.configure("train.step:delay=0.000001")
    trainer("a").train()
    assert tfaults.stats()["train.step"] == {"calls": 2, "fires": 2}
    tfaults.configure("train.step:n=2")
    with pytest.raises(tfaults.InjectedFault, match="train.step"):
        trainer("b").train()
    assert tfaults.stats()["train.step"] == {"calls": 2, "fires": 1}
