"""The port's RPC wire (``eventgpt_tpu_torch/rpc.py``) against the JAX
package's (``tests/test_rpc.py``'s cases), on the CPU.

- JSON values, bytes, ``SLO`` and arrays (numpy or host tensors) round-trip
  bit for bit; ``bfloat16`` tensors, which numpy lacks, too.
- ``call``: a round trip, a remote error as data, the deadline on a dead
  endpoint, a ``procfleet.rpc`` trip absorbed by the retries, the retries
  exhausted, no retry after a non-idempotent send, the frame cap.
- Above the frame cap, a message crosses as a run of capped frames behind a
  run header (count and total, the total under ``MAX_RUN_BYTES``); a
  corrupt run is refused. The JAX wire refuses such messages.
- The raw frame: arrays ride uninflated after the header; plain payloads
  stay JSON; truncations are loud; it crosses a live server.
- Across the packages: for a record of numpy-native dtypes the port's
  ``dumps`` and ``dumps_frame`` of tensors are the JAX bytes of the same
  values as numpy, each package decodes the other's frame, and a port
  client talks to a JAX server and back.
- The handoff through a frame: a prefill-role record, encoded and decoded,
  splices into a decode-role batcher and gives the in-process handoff's
  chain and the JAX batcher's, plain, int8 KV and bf16.
"""

import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import rpc as jrpc
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults
from eventgpt_tpu_torch import rpc
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher
from eventgpt_tpu_torch.workload import SLO


@pytest.fixture(autouse=True)
def _disarm():
    faults.disable()
    jfaults.disable()
    yield
    faults.disable()
    jfaults.disable()


def _echo_server(mod=rpc):
    return mod.RpcServer(lambda op, p: {"op": op, "payload": p})


def _same(got, want):
    """A decoded tensor holds ``want``'s dtype, shape and bytes."""
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == tuple(want.shape)
    w = want if isinstance(want, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(want))
    assert got.dtype == w.dtype
    assert torch.equal(got.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))


def test_wire_roundtrip_arrays_bit_exact():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(5, 3, 28, 28)).astype(np.float32)
    bf = torch.from_numpy(arr).to(torch.bfloat16)
    out = rpc.loads(rpc.dumps({"pixels": arr, "t": torch.from_numpy(arr), "bf": bf,
                               "ids": [1, 2, -200], "n": np.int64(3), "x": np.float32(0.5)}))
    assert out["ids"] == [1, 2, -200] and out["n"] == 3 and out["x"] == 0.5
    _same(out["pixels"], arr)
    _same(out["t"], arr)
    _same(out["bf"], bf)
    with pytest.raises(TypeError, match="cannot encode"):
        rpc.dumps({"c": torch.zeros(2, dtype=torch.complex64)})


def test_wire_roundtrip_slo_and_bytes():
    slo = SLO("interactive", ttft_s=1.0, itl_s=0.25)
    out = rpc.loads(rpc.dumps({"slo": slo, "blob": b"\x00\xff"}))
    assert out["slo"] == slo and out["blob"] == b"\x00\xff"


def test_call_round_trip_and_remote_error():
    server = _echo_server()
    try:
        got = rpc.call(server.addr, "snapshot", {"x": 1}, deadline_s=5)
        assert got == {"op": "snapshot", "payload": {"x": 1}}
    finally:
        server.stop()

    def boom(op, p):
        raise ValueError("bad op payload")

    server = rpc.RpcServer(boom)
    try:
        with pytest.raises(rpc.RpcRemoteError) as e:
            rpc.call(server.addr, "submit_ids", {}, deadline_s=5)
        assert e.value.type_name == "ValueError" and "bad op payload" in e.value.remote_msg
    finally:
        server.stop()


def test_deadline_bounds_dead_endpoint():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()[:2]
    s.close()  # nothing listens here now
    t0 = time.monotonic()
    with pytest.raises(rpc.RpcError):
        rpc.call(addr, "ping", deadline_s=0.5, retries=50, backoff_s=0.01, backoff_max_s=0.05)
    assert time.monotonic() - t0 < 5.0


def test_injected_rpc_fault_is_retried_and_absorbed():
    server = _echo_server()
    try:
        faults.configure("procfleet.rpc:n=1")
        assert rpc.call(server.addr, "ping", deadline_s=10, retries=3)["op"] == "ping"
        assert faults.stats()["procfleet.rpc"] == {"calls": 2, "fires": 1}
    finally:
        server.stop()


def test_injected_fault_exhausts_bounded_retries():
    server = _echo_server()
    try:
        faults.configure("procfleet.rpc:every=1")
        t0 = time.monotonic()
        with pytest.raises(rpc.RpcError, match="3 attempt"):
            rpc.call(server.addr, "ping", deadline_s=5, retries=2, backoff_s=0.01)
        assert faults.stats()["procfleet.rpc"]["fires"] == 3  # 1 + retries
        assert time.monotonic() - t0 < 5.0
    finally:
        server.stop()


def test_retry_sent_false_never_retries_after_send():
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    addr = lsock.getsockname()[:2]
    accepts = []

    def rude():  # reads the request, answers nothing
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            accepts.append(1)
            try:
                rpc.recv_msg(conn)
            except rpc.RpcError:
                pass
            conn.close()

    threading.Thread(target=rude, daemon=True).start()
    try:
        with pytest.raises(rpc.RpcError, match="not retried"):
            rpc.call(addr, "submit_ids", {}, deadline_s=5, retries=5, retry_sent=False)
        assert len(accepts) == 1
    finally:
        lsock.close()


def test_frame_cap_rejects_corrupt_length_prefix():
    assert rpc.MAX_MSG_BYTES == jrpc.MAX_MSG_BYTES
    server = _echo_server()
    try:
        with socket.create_connection(server.addr, timeout=5) as s:
            s.sendall((rpc.MAX_MSG_BYTES + 1).to_bytes(4, "big"))
            s.settimeout(5)
            assert s.recv(16) == b""
    finally:
        server.stop()
    with pytest.raises(rpc.RpcError, match="frame cap"):
        rpc.send_msg(None, b"\x00" * (rpc.MAX_MSG_BYTES + 1))


def _socket_pair_send(data):
    """``data`` through ``send_frames`` on one end of a socket pair (in a
    thread) and ``recv_msg`` on the other: (what arrived, the bytes that
    crossed the socket)."""
    a, b = socket.socketpair()
    wire = bytearray()

    class Tap:
        def sendall(self, buf):
            wire.extend(buf)
            a.sendall(buf)

    sender = threading.Thread(target=rpc.send_frames, args=(Tap(), data), daemon=True)
    try:
        sender.start()
        b.settimeout(30)
        got = rpc.recv_msg(b)
        sender.join(timeout=30)
        return bytes(got), bytes(wire)
    finally:
        a.close()
        b.close()


def test_a_message_above_the_cap_crosses_in_capped_frames():
    """Above ``MAX_MSG_BYTES`` a message crosses as a run: the run mark, the
    frame count and the total, then frames of at most the cap; at most the
    cap it is one frame, the JAX bytes."""
    small = b"\x01" * 1000
    got, wire = _socket_pair_send(small)
    assert got == small and wire == len(small).to_bytes(4, "big") + small
    big = bytes(np.random.default_rng(0).integers(0, 256, rpc.MAX_MSG_BYTES + 4097, np.uint8))
    got, wire = _socket_pair_send(big)
    assert got == big
    assert rpc.run_frames(len(big)) == 2
    head = rpc.RUN_MARK.to_bytes(4, "big") + (2).to_bytes(4, "big") + len(big).to_bytes(8, "big")
    assert wire.startswith(head)
    first = int.from_bytes(wire[16:20], "big")
    assert first == rpc.MAX_MSG_BYTES
    second = 20 + first
    assert int.from_bytes(wire[second:second + 4], "big") == 4097
    assert len(wire) == 16 + 2 * 4 + len(big)
    # Over a live server, both ways: a 7B-sized plane in a call and back.
    server = _echo_server()
    try:
        plane = torch.from_numpy(np.frombuffer(big, np.int8).copy())
        out = rpc.call(server.addr, "import_handoff", {"rec": {"q": plane}}, deadline_s=60)
        _same(out["payload"]["rec"]["q"], plane)
    finally:
        server.stop()


def test_runs_at_a_small_cap_and_the_run_cap(monkeypatch):
    monkeypatch.setattr(rpc, "MAX_MSG_BYTES", 1000)
    monkeypatch.setattr(rpc, "MAX_RUN_BYTES", 4000)
    data = bytes(range(256)) * 10  # 2560 bytes: three frames
    got, wire = _socket_pair_send(data)
    assert got == data and int.from_bytes(wire[4:8], "big") == 3
    assert len(wire) == 16 + 3 * 4 + len(data)
    with pytest.raises(rpc.RpcError, match="run cap"):
        rpc.send_frames(None, b"\x00" * 4001)
    with pytest.raises(rpc.RpcError, match="frame cap"):
        rpc.send_msg(None, b"\x00" * 1001)


@pytest.mark.parametrize("bad", ["count", "total_small", "total_large", "overrun", "short"])
def test_a_corrupt_run_is_refused(monkeypatch, bad):
    monkeypatch.setattr(rpc, "MAX_MSG_BYTES", 1000)
    monkeypatch.setattr(rpc, "MAX_RUN_BYTES", 4000)
    count, total, frames = 3, 2500, [1000, 1000, 500]
    if bad == "count":
        count = 2
    elif bad == "total_small":
        count, total = 1, 900
    elif bad == "total_large":
        count, total = 5, 4500
    elif bad == "overrun":
        frames = [1000, 1000, 1000]
    elif bad == "short":
        frames = [1000, 1000, 400]
    msg = (rpc.RUN_MARK.to_bytes(4, "big") + count.to_bytes(4, "big") + total.to_bytes(8, "big")
           + b"".join(n.to_bytes(4, "big") + b"\x00" * n for n in frames))
    a, b = socket.socketpair()
    try:
        a.sendall(msg)
        a.shutdown(socket.SHUT_WR)
        b.settimeout(5)
        with pytest.raises(rpc.RpcError):
            rpc.recv_msg(b)
    finally:
        a.close()
        b.close()


def _record(as_tensor: bool):
    rng = np.random.default_rng(7)
    k = rng.normal(size=(2, 3, 64, 2, 16)).astype(np.float32)
    arrays = {"q": (k * 100).astype(np.int8), "s": np.ascontiguousarray(k[..., :1]), "v": k,
              "length": np.asarray(37, np.int32), "logits": np.ascontiguousarray(k[0, 0, 0])}
    if as_tensor:
        arrays = {n: torch.from_numpy(a) for n, a in arrays.items()}
    slo = (SLO if as_tensor else jwork.SLO)("interactive", ttft_s=1.0)
    return {"op": "import_handoff", "payload": {
        "slo": slo, "ids": [1, -200, 5], "deadline_s": None,
        "rec": {"k": {"q": arrays["q"], "s": arrays["s"]}, "v": arrays["v"],
                "length": arrays["length"], "logits": arrays["logits"], "n_blocks": 2}}}


def test_raw_frame_roundtrip_bit_exact_and_uninflated():
    msg = _record(as_tensor=True)
    buf = rpc.dumps_frame(msg)
    assert buf.startswith(rpc.RAW_MAGIC)
    rec = msg["payload"]["rec"]
    leaves = [rec["k"]["q"], rec["k"]["s"], rec["v"], rec["length"], rec["logits"]]
    raw_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert len(buf) < raw_bytes + 2048
    assert len(rpc.dumps(msg)) > raw_bytes * 4 / 3
    out = rpc.loads_frame(buf)
    assert out["op"] == "import_handoff" and out["payload"]["slo"] == msg["payload"]["slo"]
    got = out["payload"]["rec"]
    assert got["n_blocks"] == 2 and got["length"].shape == ()  # 0-d stays 0-d
    for g, w in zip([got["k"]["q"], got["k"]["s"], got["v"], got["length"], got["logits"]],
                    leaves):
        _same(g, w)
    got["v"][0, 0, 0] = 0.0  # decoded tensors own writable memory


def test_bf16_planes_cross_a_frame_bit_for_bit():
    x = torch.randn(3, 64, 2, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    rec = {"k": x, "v": x[1:], "empty": torch.zeros((0, 4), dtype=torch.bfloat16)}
    out = rpc.loads_frame(rpc.dumps_frame(rec))
    for name in rec:
        _same(out[name], rec[name])
    with pytest.raises(rpc.RpcError, match="unknown array dtype"):
        rpc.loads_frame(rpc.dumps_frame({"x": np.zeros(2, np.int8)}).replace(b'"int8"',
                                                                            b'"int9"'))


def test_raw_frame_plain_payloads_stay_json():
    buf = rpc.dumps_frame({"op": "ping", "payload": {}})
    assert not buf.startswith(rpc.RAW_MAGIC)
    assert rpc.loads_frame(buf) == {"op": "ping", "payload": {}}


def test_raw_frame_truncations_are_loud():
    buf = rpc.dumps_frame({"x": torch.arange(8, dtype=torch.int32)})
    with pytest.raises(rpc.RpcError, match="truncated"):
        rpc.loads_frame(buf[:6])
    with pytest.raises(rpc.RpcError, match="overruns"):
        rpc.loads_frame(buf[:20])
    with pytest.raises(rpc.RpcError, match="trailing"):
        rpc.loads_frame(buf + b"\x00")


def test_raw_frame_crosses_live_server():
    server = _echo_server()
    try:
        arr = torch.arange(12, dtype=torch.int32).reshape(3, 4)
        got = rpc.call(server.addr, "import_handoff", {"rec": {"kv": arr}}, deadline_s=5)
        _same(got["payload"]["rec"]["kv"], arr)
    finally:
        server.stop()


def test_numpy_native_frames_are_the_jax_bytes():
    t_msg, j_msg = _record(as_tensor=True), _record(as_tensor=False)
    assert rpc.dumps_frame(t_msg) == jrpc.dumps_frame(j_msg)
    assert rpc.dumps(t_msg) == jrpc.dumps(j_msg)
    as_numpy = {**t_msg, "payload": {**t_msg["payload"], "slo": j_msg["payload"]["slo"]}}
    assert rpc.dumps_frame(_numpy(t_msg)) == jrpc.dumps_frame(_numpy(as_numpy))  # numpy in
    # Each package decodes the other's frame.
    j_out = jrpc.loads_frame(rpc.dumps_frame(t_msg))["payload"]["rec"]
    t_out = rpc.loads_frame(jrpc.dumps_frame(j_msg))["payload"]["rec"]
    for path in (("k", "q"), ("k", "s"), ("v",), ("length",), ("logits",)):
        j, t, src = j_out, t_out, j_msg["payload"]["rec"]
        for key in path:
            j, t, src = j[key], t[key], src[key]
        assert j.tobytes() == src.tobytes() and j.shape == src.shape
        _same(t, src)


def test_a_port_client_talks_to_a_jax_server_and_back():
    arr = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    for server, caller in ((_echo_server(jrpc), rpc), (_echo_server(rpc), jrpc)):
        try:
            got = caller.call(server.addr, "op", {"a": arr if caller is rpc else arr.numpy(),
                                                  "slo": None}, deadline_s=5)
            a = got["payload"]["a"]
            if caller is rpc:
                _same(a, arr)
            else:
                assert a.tobytes() == arr.numpy().tobytes()
        finally:
            server.stop()


# -- the handoff record through a frame ------------------------------------

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
IDS = [1, 5, -200, 9, 9]
BUDGET = 16


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _kw(**kw):
    return {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None,
            "kv_layout": "paged", "kv_pool_blocks": 12, **kw}


def _gather(pre):
    rid = pre.submit(IDS, _pv(3), BUDGET)
    for _ in range(400):
        if pre.handoff_ready:
            break
        pre.step()
    out = pre.pop_handoffs()
    assert [o["rid"] for o in out] == [rid]
    return out[0]


def _splice(dec, out):
    rid = dec.import_handoff(out["input_ids"], out["max_new_tokens"], out["rec"],
                             tokens=out["tokens"], prompt_len=out["prompt_len"],
                             deadline_s=out["deadline_s"], slo=out["slo"])
    return dec.run_until_drained()[rid]


def _numpy(x):
    """``x`` with every tensor as a numpy array, key order kept."""
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _leaves(x):
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    return [x] if isinstance(x, (torch.Tensor, np.ndarray)) else []


@pytest.mark.parametrize("name,kw,dtype", [("plain", {}, torch.float32),
                                           ("int8_kv", {"kv_quant": True}, torch.float32),
                                           ("bf16", {}, torch.bfloat16)])
def test_a_handoff_through_a_frame_splices_the_same_chain(trees, name, kw, dtype):
    params = trees[1] if dtype == torch.float32 else params_from_jax(trees[0], TCFG, dtype,
                                                                     "cpu")

    def port(**extra):
        return ContinuousBatcher(params, TCFG, device="cpu", **_kw(**kw, **extra))

    out = _gather(port(role="prefill"))
    in_process = _splice(port(role="decode"), out)
    wire = {k: v for k, v in out.items() if k != "t_gather"}
    buf = rpc.dumps_frame(wire)
    back = rpc.loads_frame(buf)
    assert len(buf) < out["rec"]["nbytes_kv"] + 4096  # raw, not base64
    for got, want in zip(_leaves(back["rec"]), _leaves(out["rec"])):
        _same(got, want)
    assert back["input_ids"] == out["input_ids"] and back["tokens"] == out["tokens"]
    assert _splice(port(role="decode"), back) == in_process
    assert len(in_process) == BUDGET
    if dtype == torch.float32:
        # The same chain as the JAX package's handoff, and for a record of
        # numpy-native dtypes the JAX bytes of the same values.
        pre = jserve.ContinuousBatcher(trees[0], JCFG, **_kw(role="prefill", **kw))
        j_out = _gather(pre)
        dec = jserve.ContinuousBatcher(trees[0], JCFG, **_kw(role="decode", **kw))
        assert _splice(dec, j_out) == in_process
        assert rpc.dumps_frame(wire["rec"]) == jrpc.dumps_frame(_numpy(wire["rec"]))
