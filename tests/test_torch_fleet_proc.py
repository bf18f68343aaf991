"""The port's process-fleet coordinator (``eventgpt_tpu_torch/fleet_proc.py``)
against the JAX package's (``tests/test_fleet_proc.py``'s scenarios), over
stub workers: each scenario runs on the JAX ``ProcFleet`` over the JAX stub
and on the port's over the port's stub, side by side, and the decisions
(routes, pins, failovers, crash loops, handoff retries and redos, fault
fires, chains) must be equal. Also the workers' command line (every
forwarded flag round-trips; every parser flag is classified), the handler's
capped ``collect_handoffs``. Every wait is bounded, and every fleet shuts
down (its workers with it) in a ``finally``."""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import fleet_proc as jfp
from eventgpt_tpu.cli import serve as jcli
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch import fleet_proc as tfp
from eventgpt_tpu_torch import rpc
from eventgpt_tpu_torch.cli import serve as tcli

EVENT = -200
WAIT_S = 60.0
PKGS = {"jax": (jfp, jfaults, jcli), "torch": (tfp, tfaults, tcli)}


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.disable()
    tfaults.disable()
    yield
    jfaults.disable()
    tfaults.disable()


def _pv(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, 3, 4, 4)).astype(np.float32)


def _chain(ids, budget):
    s = sum(ids)
    return [(s + k) % 251 for k in range(budget)]


def _fleet(fp, n=2, token_delay_s=0.002, **kw):
    kw.setdefault("spawn_timeout_s", WAIT_S)
    kw.setdefault("probe_interval_s", 0.02)
    return fp.ProcFleet(fp.stub_worker_cmd(token_delay_s), n, **kw)


def _wait(cond, what, bound_s=WAIT_S):
    deadline = time.monotonic() + bound_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {bound_s} s waiting for {what}")
        time.sleep(0.01)


def _both(script):
    """``script(fleet_proc, faults, cli_serve)`` for each package, in two
    threads at once; {package: its decisions}."""
    out, errs = {}, {}

    def run(name):
        try:
            out[name] = script(*PKGS[name])
        except BaseException as e:  # re-raised below, in the test's thread
            errs[name] = e

    threads = [threading.Thread(target=run, args=(name,), daemon=True) for name in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * WAIT_S)
    for name, e in errs.items():
        raise AssertionError(f"the {name} scenario failed: {e!r}") from e
    assert set(out) == set(PKGS), f"a scenario did not end: {sorted(out)}"
    return out


def test_spawn_fault_affinity_rpc_fault_and_crash_loop_decisions_equal_jax():
    """``procfleet.spawn:n=1`` fails the first spawn, booked as a crash and
    respawned. Then submit and result with the affinity pin and the stats'
    shape; a ``procfleet.rpc`` trip under traffic, absorbed by the bounded
    retry; and slot 0 killed until its crash-loop breaker gives it up (the
    spawn crash counts in the window): capacity degrades, the fleet stays
    green and serves on the other worker, and the slot stays failed."""
    ids, ids9, ids5 = [1, 2, EVENT, 7], [1, 2, EVENT, 9], [1, 2, EVENT, 5]

    def script(fp, faults, _):
        faults.configure("procfleet.spawn:n=1")
        fleet = _fleet(fp, respawn_backoff_s=0.05, respawn_backoff_max_s=0.2, crash_limit=3,
                       crash_window_s=60.0)
        try:
            out = {"spawn_fires": faults.stats()["procfleet.spawn"]["fires"],
                   "states": [s.state for s in fleet.slots],
                   "crashes": [len(s.crashes) for s in fleet.slots]}
            fr = fleet.submit_ids(ids, _pv(1), 6)
            chains = [fleet.result(fr, timeout=WAIT_S)]
            fr2 = fleet.submit_ids(ids, _pv(1), 4)  # the same session
            chains.append(fleet.result(fr2, timeout=WAIT_S))
            st = fleet.stats()["fleet"]
            out["fleet"] = {k: st[k] for k in ("proc_fleet", "workers", "routable", "pins",
                                               "roles", "failovers", "deaths")}
            out["shipped"] = st["handoffs"]["shipped"]
            out["policy"] = fleet.fleet_stats()["policy"]
            faults.configure("procfleet.rpc:n=3")
            frs = [fleet.submit_ids(ids9, _pv(i), 5) for i in range(3)]
            chains += [fleet.result(f, timeout=WAIT_S) for f in frs]
            out["rpc_fires"] = faults.stats()["procfleet.rpc"]["fires"]
            out["workers"] = [fleet.worker_of(f) for f in [fr, fr2] + frs]
            kills = 0
            deadline = time.monotonic() + WAIT_S
            while fleet.slots[0].state != "failed":
                assert time.monotonic() < deadline, f"breaker never tripped: {fleet.slots[0]}"
                if fleet.slots[0].state in ("ok", "starting") and fleet.slots[0].proc is not None:
                    fleet.kill_worker(0)
                    kills += 1
                    _wait(lambda: fleet.slots[0].proc is None, "the kill to be booked")
                time.sleep(0.005)
            fr = fleet.submit_ids(ids5, _pv(9), 4)
            chains.append(fleet.result(fr, timeout=WAIT_S))
            time.sleep(0.3)
            out.update(chains=chains, kills=kills, crash_looped=fleet.n_crash_looped,
                       crashes_after=len(fleet.slots[0].crashes),
                       breaker_open=fleet.breaker_open(),
                       routable=sum(s.routable for s in fleet.slots),
                       last_worker=fleet.worker_of(fr), state_later=fleet.slots[0].state)
            return out
        finally:
            fleet.shutdown()

    out = _both(script)
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert (got["spawn_fires"], got["states"], got["crashes"]) == (1, ["ok", "ok"], [1, 0])
    assert got["chains"] == ([_chain(ids, 6), _chain(ids, 4)] + [_chain(ids9, 5)] * 3
                             + [_chain(ids5, 4)])
    assert got["workers"][1] == got["workers"][0]  # the pin
    assert got["fleet"] == {"proc_fleet": True, "workers": 2, "routable": 2, "pins": 1,
                            "roles": None, "failovers": 0, "deaths": 0}
    assert got["policy"]["crash_limit"] == 3 and got["policy"]["handoff_retries"] == 3
    assert got["rpc_fires"] == 1 and got["shipped"] == 0
    assert (got["kills"], got["crash_looped"], got["crashes_after"]) == (2, 1, 3)
    assert (got["breaker_open"], got["routable"], got["last_worker"], got["state_later"]) == (
        False, 1, 1, "failed")


def test_graceful_drain_reroutes_and_shutdown_drains_decisions_equal_jax():
    """The busiest worker drained mid-decode: its requests re-route over
    ``export_requests`` (path drain) with their chains, the slot respawns;
    then a submit followed at once by ``shutdown`` still gets its answer."""
    ids = [1, 2, EVENT, 6]

    def script(fp, faults, _):
        fleet = _fleet(fp, token_delay_s=0.02, respawn_backoff_s=0.05)
        try:
            frs = [fleet.submit_ids(ids, _pv(i), 40) for i in range(4)]  # 0.8 s each
            homes = [fleet.worker_of(f) for f in frs]
            time.sleep(0.1)
            busy = max(fleet.slots, key=lambda s: s.inflight)
            moved = fleet.drain_worker(busy.idx)
            chains = [fleet.result(f, timeout=WAIT_S) for f in frs]
            after = [fleet.worker_of(f) for f in frs]
            _wait(lambda: all(s.state == "ok" for s in fleet.slots), "the drained slot's respawn")
            numbers = {"homes": homes, "drained": busy.idx, "moved": moved, "after": after,
                       "chains": chains, "kills": fleet.n_kills, "failovers": fleet.n_failovers,
                       "respawns": fleet.n_respawns,
                       "crashes": [len(s.crashes) for s in fleet.slots],
                       "deaths": fleet.n_deaths}
            fr = fleet.submit_ids([1, 2, EVENT, 8], _pv(3), 20)
        finally:
            fleet.shutdown()
        numbers["after_shutdown"] = fleet.result(fr, timeout=1)
        numbers["procs_left"] = [s.proc is not None for s in fleet.slots]
        return numbers

    out = _both(script)
    # The JAX probe may book the drained worker's orderly exit as a crash
    # and a second death (ROADMAP Queue 3); the port's never does.
    jax_race = {k: out["jax"].pop(k) for k in ("crashes", "deaths")}
    assert jax_race["deaths"] in (1, 2) and jax_race["crashes"][1] == 0
    got = out["torch"]
    assert got.pop("crashes") == [0, 0] and got.pop("deaths") == 1
    assert got == out["jax"]
    assert got["homes"] == [0, 1, 0, 1] and got["drained"] == 0 and got["moved"] == 2
    assert got["after"] == [1, 1, 1, 1]
    assert got["chains"] == [_chain(ids, 40)] * 4
    assert (got["kills"], got["failovers"], got["respawns"]) == (1, 2, 1)
    assert got["after_shutdown"] == _chain([1, 2, EVENT, 8], 20)
    assert got["procs_left"] == [False, False]


@pytest.mark.parametrize("roles,n,match", [("2", 2, "want P:D"), ("a:b", 2, "want P:D"),
                                           ("2:0", 2, "at least one prefill"),
                                           ("2:2", 2, "!= fleet size")])
def test_roles_validation_equals_jax(roles, n, match):
    for fp, _, _ in PKGS.values():
        with pytest.raises(ValueError, match=match):
            fp.ProcFleet(fp.stub_worker_cmd(), n, roles=roles)


def test_decode_placement_and_handoff_retry_decisions_equal_jax():
    """1 prefill : 2 decode. ``procfleet.handoff:n=1`` trips the first ship
    (to slot 1, the first of two equal headrooms); the retry lands it on
    slot 2, with no redo. Once a probe shows slot 2's pool smaller, the
    second request's record goes to slot 1: placement by free pool bytes."""
    ids, ids2 = [1, 2, EVENT, 9], [1, 2, EVENT, 8]

    def script(fp, faults, _):
        faults.configure("procfleet.handoff:n=1")
        fleet = _fleet(fp, n=3, roles="1:2", token_delay_s=0.05)
        try:
            roles = [s.role for s in fleet.slots]
            fr1 = fleet.submit_ids(ids, _pv(1), 30)
            _wait(lambda: fleet.n_handoffs >= 1, "the first ship")
            w1 = fleet.worker_of(fr1)
            _wait(lambda: (fleet.slots[w1].snapshot or {}).get("kv_free_blocks", 256) < 256,
                  "a probe of the loaded decode worker")
            fr2 = fleet.submit_ids(ids2, _pv(2), 30)
            _wait(lambda: fleet.n_handoffs >= 2, "the second ship")
            chains = [fleet.result(f, timeout=WAIT_S) for f in (fr1, fr2)]
            st = fleet.stats()["fleet"]
            return {"roles": roles, "placed": [w1, fleet.worker_of(fr2)], "chains": chains,
                    "fires": faults.stats()["procfleet.handoff"]["fires"],
                    "retries": fleet.n_handoff_retries, "redos": fleet.n_handoff_redos,
                    "handoffs": fleet.n_handoffs, "failovers": fleet.n_failovers,
                    "bytes": st["handoffs"]["bytes"], "stats_roles": st["roles"]}
        finally:
            fleet.shutdown()

    out = _both(script)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"roles": ["prefill", "decode", "decode"], "placed": [2, 1],
                            "chains": [_chain(ids, 30), _chain(ids2, 30)], "fires": 1,
                            "retries": 1, "redos": 0, "handoffs": 2, "failovers": 0,
                            "bytes": 2 * 4 * len(ids), "stats_roles": "1:2"}


def test_handoff_exhaustion_falls_back_to_redo_and_http_decisions_equal_jax():
    """1 prefill : 1 decode: the tripped ship has no other decode worker, so
    the request redoes from its prefill (one failover, one redo, then one
    clean ship) with its chain. ``GET /fleet`` and ``GET /stats`` over each
    package's own ``make_handler`` show the topology."""
    ids = [1, 2, EVENT, 5]

    def script(fp, faults, cli):
        faults.configure("procfleet.handoff:n=1")
        fleet = _fleet(fp, roles="1:1")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli.make_handler(fleet, None))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def get(path):
            url = f"http://127.0.0.1:{httpd.server_address[1]}{path}"
            with urllib.request.urlopen(url, timeout=30) as r:
                return json.loads(r.read().decode())

        try:
            fr = fleet.submit_ids(ids, _pv(4), 8)
            chain = fleet.result(fr, timeout=WAIT_S)
            fl, st = get("/fleet"), get("/stats")
            return {"chain": chain, "worker": fleet.worker_of(fr),
                    "fires": faults.stats()["procfleet.handoff"]["fires"],
                    "redos": fleet.n_handoff_redos, "retries": fleet.n_handoff_retries,
                    "handoffs": fleet.n_handoffs, "failovers": fleet.n_failovers,
                    "fleet_roles": fl["roles"], "per_worker": [w["role"] for w in fl["per_worker"]],
                    "shipped": fl["handoffs"]["shipped"], "bytes": fl["handoffs"]["bytes"],
                    "headroom_known": all(w["kv_free_blocks"] is not None
                                          for w in fl["per_worker"]),
                    "stats_roles": st["fleet"]["roles"], "status": st["status"]}
        finally:
            httpd.shutdown()
            httpd.server_close()
            fleet.shutdown()

    out = _both(script)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"chain": _chain(ids, 8), "worker": 1, "fires": 1, "redos": 1,
                            "retries": 1, "handoffs": 1, "failovers": 1, "fleet_roles": "1:1",
                            "per_worker": ["prefill", "decode"], "shipped": 1,
                            "bytes": 4 * len(ids), "headroom_known": True, "stats_roles": "1:1",
                            "status": "ok"}


def test_the_telemetry_parts_are_refused_by_name():
    """The coordinator's journeys, series, alerts and memory, and the
    workers' ops for them, raise with the telemetry item named."""
    handler = tfp.WorkerHandler(engine=None)
    for op in ("journey", "series", "alerts", "memory"):
        with pytest.raises(NotImplementedError, match="item 6"):
            handler(op, {})
    fleet = object.__new__(tfp.ProcFleet)
    for call in (lambda: fleet.journey(0), lambda: fleet.journeys(), lambda: fleet.series(),
                 lambda: fleet.alerts(), lambda: fleet.memory_stats()):
        with pytest.raises(NotImplementedError, match="item 6"):
            call()
    with pytest.raises(NotImplementedError, match="streaming"):
        fleet.stream_queue(0)


def test_the_coordinators_telemetry_routes_answer_501():
    """Behind the HTTP handler the coordinator's refusals are a 501 naming
    the item, not a crashed handler."""
    import http.client

    fleet = object.__new__(tfp.ProcFleet)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tcli.make_handler(fleet, None))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for path in ("/request?rid=3", "/requests", "/series", "/alerts", "/memory"):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", path)
            res = conn.getresponse()
            assert res.status == 501 and b"item 6b" in res.read(), path
    finally:
        httpd.shutdown()
        httpd.server_close()


class _Outbox:
    """An engine whose handoff outbox holds three records of 3 KiB planes."""

    def __init__(self):
        self.recs = [{"rid": i, "input_ids": [1, 2], "t_gather": time.perf_counter(),
                      "elapsed_s": 0.5, "rec": {"k": torch.zeros(3 * 1024, dtype=torch.int8),
                                                "n_blocks": 1}}
                     for i in range(3)]

    def collect_handoffs(self):
        out, self.recs = self.recs, []
        return out


def test_collect_answers_up_to_the_run_cap_and_replays_until_acked(monkeypatch):
    """``collect_handoffs`` serves the unacked records up to the run cap (less
    a frame) and leaves the rest; unacked records replay, with the outbox
    wait added to ``elapsed_s`` and the worker's clock stamp kept off."""
    monkeypatch.setattr(rpc, "MAX_MSG_BYTES", 1024)
    monkeypatch.setattr(rpc, "MAX_RUN_BYTES", 1024 + 2 * 3 * 1024)
    handler = tfp.WorkerHandler(_Outbox())
    first = handler("collect_handoffs", {})
    assert [r["rid"] for r in first] == [0, 1]
    assert all("t_gather" not in r and r["elapsed_s"] >= 0.5 for r in first)
    assert [r["rid"] for r in handler("collect_handoffs", {})] == [0, 1]  # replayed
    handler("ack_handoffs", {"rids": [0, 1]})
    assert [r["rid"] for r in handler("collect_handoffs", {})] == [2]
    handler("ack_handoffs", {"rids": [2]})
    assert handler("collect_handoffs", {}) == []


def test_worker_argv_round_trips_every_forwarded_flag():
    """Each ``WORKER_FORWARDED_FLAGS`` entry, set to a value other than its
    default, survives the coordinator -> argv -> worker parse."""
    parser = tcli.build_parser()
    args = parser.parse_args([])
    choices = {"dtype": "float32", "quant": "int8", "kv_cache": "int8", "kv_layout": "paged",
               "conv_mode": "plain", "device": "cpu", "attn_impl": "dense"}
    for dest, kind, default in tcli.WORKER_FORWARDED_FLAGS:
        if kind == "flag":
            setattr(args, dest, True)
        elif dest in choices:
            setattr(args, dest, choices[dest])
        elif isinstance(default, (int, float)) and not isinstance(default, bool):
            setattr(args, dest, type(default)(default) + 3)
        else:
            setattr(args, dest, f"x_{dest}")
    argv = tcli._worker_argv(args)
    assert argv[1:4] == ["-m", "eventgpt_tpu_torch.cli.serve", "--worker"]
    back = parser.parse_args(argv[3:])
    assert back.worker
    for dest, kind, _ in tcli.WORKER_FORWARDED_FLAGS:
        want, got = getattr(args, dest), getattr(back, dest)
        if kind == "value" and not isinstance(want, str):
            got = type(want)(got)
        assert got == want, f"--{dest} did not round-trip: {want!r} -> {got!r}"


def test_every_parser_flag_is_classified_and_the_jax_forwarding_kept():
    """Every flag of the port's parser is forwarded, coordinator-only or set
    per slot; every flag the JAX CLI forwards is forwarded by the port (the
    telemetry flags since they are ported), and its coordinator's telemetry
    sinks stay with the coordinator; the port adds only its --device and
    --attn_impl and the Q-Former flags."""
    forwarded = {dest for dest, _, _ in tcli.WORKER_FORWARDED_FLAGS}
    classes = (tcli.WORKER_COORDINATOR_ONLY, tcli.WORKER_PER_SLOT)
    for i, a in enumerate((forwarded,) + classes):
        for b in ((forwarded,) + classes)[i + 1:]:
            assert not a & b, a & b
    dests = {a.dest for a in tcli.build_parser()._actions if a.dest != "help"}
    unclassified = dests - forwarded - set().union(*classes)
    assert not unclassified, f"unclassified serving flags {sorted(unclassified)}"
    assert not (forwarded | tcli.WORKER_PER_SLOT) - dests
    jax_forwarded = {dest for dest, _, _ in jcli.WORKER_FORWARDED_FLAGS}
    assert jax_forwarded <= forwarded
    assert forwarded - jax_forwarded == {"device", "attn_impl", "use_event_qformer",
                                         "pretrain_query_embedder", "pretrain_attention_layers"}
    assert tcli.WORKER_PER_SLOT == jcli.WORKER_PER_SLOT
    assert {"trace_buffer", "trace_out", "profile_dir", "proc_fleet"} <= \
        tcli.WORKER_COORDINATOR_ONLY & jcli.WORKER_COORDINATOR_ONLY


def test_roles_without_the_paged_layout_fail_at_the_coordinator():
    args = tcli.build_parser().parse_args(["--proc_fleet", "2", "--proc_fleet_roles", "1:1",
                                           "--device", "cpu"])
    with pytest.raises(ValueError, match="requires --kv_layout paged"):
        tcli.build_engine(args)
