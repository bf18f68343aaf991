"""The port's ``workload`` module and its SLO scoring in the batcher,
against the JAX package on the CPU.

- ``generate_trace`` + ``save_trace`` write the byte-identical JSONL for
  one spec in both packages (Poisson, Gamma and on-off arrivals), and each
  package loads the other's file.
- ``SLO.met`` agrees on a grid that includes every inclusive boundary.
- The batcher scores a finish on synthetic clocks exactly as the JAX
  batcher does (``slo_stats()`` and ``request_stats``, ``itl_s`` and
  ``slo_met`` included), on and past each target and for a request that
  never committed.
- ``replay`` drives the port's batcher to the JAX batcher's chains, with
  the SLO classes armed or not.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwl
from eventgpt_tpu.config import EventChatConfig as JConfig
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import serve as tserve
from eventgpt_tpu_torch import workload as twl
from eventgpt_tpu_torch.config import EventChatConfig as TConfig
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX
from eventgpt_tpu_torch.models.convert import params_from_jax

JCFG, TCFG = JConfig.tiny(), TConfig.tiny()


@pytest.mark.parametrize("arrival", ["poisson", "gamma", "onoff"])
def test_trace_files_are_byte_identical_to_jax(tmp_path, arrival):
    kw = dict(seed=7, n_requests=24, rate_rps=20.0, arrival=arrival, sessions=3)
    t_path, j_path = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    t_spec, j_spec = twl.WorkloadSpec(**kw), jwl.WorkloadSpec(**kw)
    twl.save_trace(str(t_path), t_spec, twl.generate_trace(t_spec))
    jwl.save_trace(str(j_path), j_spec, jwl.generate_trace(j_spec))
    assert t_path.read_bytes() == j_path.read_bytes()
    spec, trace = twl.load_trace(str(j_path))
    assert spec == t_spec and trace == twl.generate_trace(t_spec)
    assert [dataclasses.asdict(r) for r in trace] == \
        [dataclasses.asdict(r) for r in jwl.load_trace(str(t_path))[1]]


def test_stream_pixels_and_cache_positions_match_jax():
    shape = (JCFG.num_event_frames, 3, 8, 8)
    np.testing.assert_array_equal(twl.stream_pixels(shape, 1001), jwl.stream_pixels(shape, 1001))
    spec = twl.WorkloadSpec(seed=3, n_requests=6)
    j_trace = jwl.generate_trace(jwl.WorkloadSpec(seed=3, n_requests=6))
    assert ([twl.cache_positions(r, 582) for r in twl.generate_trace(spec)]
            == [jwl.cache_positions(r, 582) for r in j_trace])


def test_slo_met_matches_jax_on_a_grid_with_its_boundaries():
    targets = [None, 0.5, 1.0]
    values = [0.0, 0.5, 0.5 + 1e-9, 1.0, 1.0 + 1e-9, 2.0]
    n = 0
    for ttft, itl, lat in itertools.product(targets, repeat=3):
        t_slo = twl.SLO("interactive", ttft_s=ttft, itl_s=itl, latency_s=lat)
        j_slo = jwl.SLO("interactive", ttft_s=ttft, itl_s=itl, latency_s=lat)
        for v in itertools.product(values, repeat=3):
            assert t_slo.met(*v) == j_slo.met(*v), (ttft, itl, lat, v)
            n += 1
    assert n == 27 * 216
    assert twl.SLO("batch", latency_s=1.0).met(9.0, 9.0, 1.0)  # inclusive
    assert not twl.SLO("batch", latency_s=1.0).met(0.0, 0.0, 1.0 + 1e-9)


def test_spec_slo_for_classes():
    spec = twl.WorkloadSpec(interactive_ttft_s=0.5, interactive_itl_s=0.05,
                            batch_latency_s=12.0)
    assert spec.slo_for("interactive") == twl.SLO("interactive", ttft_s=0.5, itl_s=0.05)
    assert spec.slo_for("batch") == twl.SLO("batch", latency_s=12.0)
    assert twl.SLO_CLASSES == jwl.SLO_CLASSES
    with pytest.raises(ValueError, match="unknown SLO class"):
        spec.slo_for("vip")


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _scored(mod, srv, slo, monkeypatch, t_first, t_last, t_done, n_tokens):
    """``_record_finish`` of one request on hand-set clocks."""
    req = mod._Request(0, [1, EVENT_TOKEN_INDEX, 5], None, n_tokens)
    req.slo = slo
    req.t_submit = 100.0
    req.t_first = 100.0 + t_first if t_first is not None else None
    req.t_last = 100.0 + t_last if t_last is not None else None
    req.tokens = list(range(n_tokens))
    monkeypatch.setattr(mod.time, "perf_counter", lambda: 100.0 + t_done)
    srv._record_finish(req, mod.STATUS_OK)
    monkeypatch.undo()
    return srv


@pytest.mark.parametrize("clocks", [
    dict(t_first=1.0, t_last=1.3, t_done=10.0, n_tokens=4),   # exactly on every target
    dict(t_first=1.2, t_last=1.5, t_done=10.0, n_tokens=4),   # past TTFT
    dict(t_first=1.0, t_last=1.6, t_done=10.0, n_tokens=4),   # past ITL
    dict(t_first=1.0, t_last=1.3, t_done=10.5, n_tokens=4),   # past latency
    dict(t_first=None, t_last=None, t_done=5.0, n_tokens=0),  # never committed
], ids=["met", "ttft", "itl", "latency", "no_token"])
def test_batcher_scores_a_finish_as_jax(trees, monkeypatch, clocks):
    kw = dict(max_batch=1, max_len=256, chunk=4)
    port = tserve.ContinuousBatcher(trees[1], TCFG, device="cpu", **kw)
    jsrv = jserve.ContinuousBatcher(trees[0], JCFG, **kw)
    _scored(tserve, port, twl.SLO("interactive", ttft_s=1.0, itl_s=0.1, latency_s=10.0),
            monkeypatch, **clocks)
    _scored(jserve, jsrv, jwl.SLO("interactive", ttft_s=1.0, itl_s=0.1, latency_s=10.0),
            monkeypatch, **clocks)
    assert port.slo_stats() == jsrv.slo_stats()
    assert port.request_stats[0].keys() == jsrv.request_stats[0].keys()
    for key, val in jsrv.request_stats[0].items():
        assert port.request_stats[0][key] == pytest.approx(val, abs=1e-12), key
    port.reset_serving_stats()
    assert port.slo_stats() == {"classes": {}, "window_n": 0, "window_size": 256,
                                "goodput_ratio": 0.0}


def test_unknown_slo_class_is_refused_at_submit(trees):
    srv = tserve.ContinuousBatcher(trees[1], TCFG, device="cpu", max_batch=1, max_len=256)
    with pytest.raises(ValueError, match="unknown SLO class"):
        srv.submit([1, EVENT_TOKEN_INDEX, 5], np.zeros((1,), np.float32), 4,
                   slo=twl.SLO("vip", ttft_s=1.0))
    assert not srv.queue


def test_replay_gives_the_jax_chains_armed_or_not(trees):
    kw = dict(seed=11, n_requests=8, rate_rps=100.0, arrival="gamma", sessions=2, prompt_max=16,
              output_min=2, output_max=6, interactive_ttft_s=0.5, interactive_itl_s=0.1,
              batch_latency_s=5.0)
    t_spec, j_spec = twl.WorkloadSpec(**kw), jwl.WorkloadSpec(**kw)
    shape = (JCFG.num_event_frames, 3, JCFG.vision.image_size, JCFG.vision.image_size)
    srv_kw = dict(max_batch=2, max_len=256, chunk=4, eos_token_id=None)

    def run_port(armed):
        srv = tserve.ContinuousBatcher(trees[1], TCFG, device="cpu", **srv_kw)
        res = twl.replay(srv, twl.generate_trace(t_spec), paced=False,
                         pixels_for=lambda r: twl.stream_pixels(shape, r.pixels_seed),
                         slo_for=(lambda r: t_spec.slo_for(r.slo_class)) if armed else None)
        return res["finished"], srv

    jsrv = jserve.ContinuousBatcher(trees[0], JCFG, **srv_kw)
    want = jwl.replay(jsrv, jwl.generate_trace(j_spec), paced=False,
                      pixels_for=lambda r: jwl.stream_pixels(shape, r.pixels_seed))["finished"]
    armed, armed_srv = run_port(True)
    plain, plain_srv = run_port(False)
    assert armed == plain == want
    st = armed_srv.slo_stats()
    assert sum(c["finished"] for c in st["classes"].values()) == 8
    assert set(st["classes"]) == set(twl.SLO_CLASSES)
    assert plain_srv.slo_stats()["classes"] == {}
