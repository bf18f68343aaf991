"""Length-prefixed JSON-over-TCP RPC, and the wire form of host records.

Port of ``eventgpt_tpu/rpc.py``. It moves host records (token ids, pixels,
stats, a KV handoff record) between processes on one host and fails loudly
and boundedly when the other side is slow, wedged or dead. There is no
pickling (a dead peer can corrupt nothing beyond a parse error), no pooling
and no discovery: one call is one connection, one request and one
response, each framed as a 4-byte big-endian length and a payload.

  * **A deadline per call.** ``call(..., deadline_s=...)`` bounds the
    connect, the send and the response read together; when it runs out the
    call raises ``RpcTimeout``.
  * **Bounded exponential backoff with jitter.** Transport failures
    (refused or reset connections, short reads, a ``procfleet.rpc`` fault)
    retry up to ``retries`` times, sleeping ``backoff_s * 2^attempt``
    (capped, jittered) while the deadline allows.
  * **Mutating ops never retry blindly.** With ``retry_sent=False`` a
    failure after the request left the socket raises instead of retrying,
    so that a request is never delivered twice.
  * **Remote exceptions are data.** A handler exception comes back as
    ``{"error": {"type", "msg"}}`` and raises ``RpcRemoteError``, never
    retried.

The ``procfleet.rpc`` fault site fires per attempt, before any byte moves.

A message of at most ``MAX_MSG_BYTES`` is one frame, the JAX package's
bytes. A larger one (a 7B KV handoff record, hundreds of MB) crosses as a
run of frames: the length prefix ``RUN_MARK`` (above the cap, so a JAX peer
refuses it), a u32 frame count and a u64 total, then that many ordinary
frames of at most ``MAX_MSG_BYTES`` each. The total is bounded by
``MAX_RUN_BYTES``. Any other length prefix above the cap is refused as
corrupt, as in the JAX package.

Wire values beyond JSON: a numpy array or a host tensor is
``{"__nd__": [shape, dtype, b64]}``, bytes are ``{"__b64__": ...}``, and
``workload.SLO`` is ``{"__slo__": {...}}`` (an allowed type, not general
hydration). ``dumps_frame`` carries a record with arrays as a raw frame:
``b"EGRB" + u32(header length) + header JSON + the arrays' bytes``, each
array in the header replaced by ``{"__blob__": i, "shape", "dtype"}`` and
the blob lengths listed beside it; a message with no array is the plain JSON
form, and ``loads_frame`` tells the two apart by the magic. A tensor's dtype
tag is numpy's name where numpy has the type, so a record of numpy-native
dtypes (int8 planes, f32 scales, int32 lengths) makes the same bytes as the
JAX package's ``dumps_frame`` of the same values; ``bfloat16``, which numpy
lacks, travels under that tag as its raw bytes, bit for bit. Every array
decodes to a host ``torch.Tensor``.
"""

from __future__ import annotations

import base64
import json
import random
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from eventgpt_tpu_torch import faults

_LEN = struct.Struct(">I")
# One socket frame holds a pixel stream or an exported request batch; 64 MiB
# is far above those and far below "a corrupt length prefix allocates the
# host away". A 7B handoff record (225-242 MB) is larger: it crosses as a
# run of frames (``send_frames``), whose total is bounded by MAX_RUN_BYTES,
# which holds four such records.
MAX_MSG_BYTES = 64 * 1024 * 1024
MAX_RUN_BYTES = 1024 * 1024 * 1024
RUN_MARK = 0xFFFFFFFF
_RUN_HEAD = struct.Struct(">IQ")  # frame count, total bytes

# torch dtype <-> the wire's dtype tag (numpy's name; "bfloat16" has none).
_TAGS = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
         torch.bfloat16: "bfloat16", torch.int8: "int8", torch.uint8: "uint8",
         torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
         torch.bool: "bool"}
_DTYPES = {tag: dt for dt, tag in _TAGS.items()}


class RpcError(RuntimeError):
    """A transport or protocol failure (refused, reset, short read, a frame
    too large, the deadline)."""


class RpcTimeout(RpcError):
    """The call's deadline passed before a response arrived."""


class RpcRemoteError(RuntimeError):
    """The peer's handler raised; ``type_name`` is its exception's class."""

    def __init__(self, type_name: str, msg: str):
        super().__init__(f"{type_name}: {msg}")
        self.type_name = type_name
        self.remote_msg = msg


# -- arrays on the wire ----------------------------------------------------

def _array_bytes(o) -> Optional[Tuple[list, str, bytes]]:
    """(shape, dtype tag, contiguous bytes) of a numpy array or a tensor,
    None for anything else. A device tensor is refused: records are host
    values."""
    if isinstance(o, np.ndarray):
        # The shape of ``o``, not of the contiguous copy, which is at least 1-d.
        arr = np.ascontiguousarray(o)
        return list(o.shape), str(arr.dtype), arr.tobytes()
    if isinstance(o, torch.Tensor):
        if o.device.type != "cpu":
            raise TypeError(f"cannot encode a tensor on {o.device}: move it to the host first")
        if o.dtype not in _TAGS:
            raise TypeError(f"cannot encode a {o.dtype} tensor for RPC")
        flat = o.detach().contiguous().reshape(-1)
        return list(o.shape), _TAGS[o.dtype], flat.view(torch.uint8).numpy().tobytes()
    return None


def _tensor(shape, tag: str, raw: bytes) -> torch.Tensor:
    if tag not in _DTYPES:
        raise RpcError(f"unknown array dtype {tag!r} on the wire")
    dtype = _DTYPES[tag]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def _enc_default(o):
    got = _array_bytes(o)
    if got is not None:
        shape, tag, raw = got
        return {"__nd__": [shape, tag, base64.b64encode(raw).decode()]}
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(o)).decode()}
    from eventgpt_tpu_torch.workload import SLO

    if isinstance(o, SLO):
        return {"__slo__": {"name": o.name, "ttft_s": o.ttft_s, "itl_s": o.itl_s,
                            "latency_s": o.latency_s}}
    raise TypeError(f"cannot encode {type(o).__name__} for RPC")


def _dec_hook(d: Dict[str, Any]):
    if "__nd__" in d and len(d) == 1:
        shape, tag, b64 = d["__nd__"]
        return _tensor(shape, tag, base64.b64decode(b64))
    if "__b64__" in d and len(d) == 1:
        return base64.b64decode(d["__b64__"])
    if "__slo__" in d and len(d) == 1:
        from eventgpt_tpu_torch.workload import SLO

        return SLO(**d["__slo__"])
    return d


def dumps(obj: Any) -> bytes:
    return json.dumps(obj, default=_enc_default).encode()


def loads(data: bytes) -> Any:
    return json.loads(data.decode(), object_hook=_dec_hook)


# -- the raw frame ---------------------------------------------------------
#
# RAW_MAGIC | u32 header_len | header JSON | blob 0 | blob 1 | ...
# header = {"h": <payload, arrays as __blob__ refs>, "b": [len, ...]}. The
# JSON form always starts with "{", so one receive path decodes both.

RAW_MAGIC = b"EGRB"
_BLOB_KEYS = frozenset(("__blob__", "shape", "dtype"))


def _extract_blobs(o: Any, blobs: list) -> Any:
    got = _array_bytes(o)
    if got is not None:
        shape, tag, raw = got
        blobs.append(raw)
        return {"__blob__": len(blobs) - 1, "shape": shape, "dtype": tag}
    if isinstance(o, dict):
        return {k: _extract_blobs(v, blobs) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_extract_blobs(v, blobs) for v in o]
    return o


def dumps_frame(obj: Any) -> bytes:
    """``obj`` for the wire: the raw frame when it holds arrays (their bytes
    follow the header as they are, no base64), else the JSON form."""
    blobs: list = []
    header_obj = _extract_blobs(obj, blobs)
    if not blobs:
        return dumps(obj)
    header = json.dumps({"h": header_obj, "b": [len(b) for b in blobs]},
                        default=_enc_default).encode()
    return b"".join([RAW_MAGIC, _LEN.pack(len(header)), header] + blobs)


def _restore_blobs(o: Any, blobs: list) -> Any:
    if isinstance(o, dict):
        if _BLOB_KEYS.issuperset(o) and "__blob__" in o:
            return _tensor(o["shape"], o["dtype"], blobs[int(o["__blob__"])])
        return {k: _restore_blobs(v, blobs) for k, v in o.items()}
    if isinstance(o, list):
        return [_restore_blobs(v, blobs) for v in o]
    return o


def loads_frame(data: bytes) -> Any:
    """Decode either form (by the magic prefix)."""
    if not data.startswith(RAW_MAGIC):
        return loads(data)
    if len(data) < len(RAW_MAGIC) + _LEN.size:
        raise RpcError("raw frame truncated before its header length")
    (hlen,) = _LEN.unpack_from(data, len(RAW_MAGIC))
    off = len(RAW_MAGIC) + _LEN.size
    if off + hlen > len(data):
        raise RpcError(f"raw frame header of {hlen} bytes overruns the {len(data)}-byte frame")
    header = json.loads(data[off:off + hlen].decode(), object_hook=_dec_hook)
    off += hlen
    blobs = []
    mv = memoryview(data)
    for n in header["b"]:
        if off + n > len(data):
            raise RpcError("raw frame blob table overruns the frame")
        blobs.append(mv[off:off + n])
        off += n
    if off != len(data):
        raise RpcError(f"raw frame has {len(data) - off} trailing bytes")
    return _restore_blobs(header["h"], blobs)


# -- socket framing --------------------------------------------------------

def send_msg(sock: socket.socket, data: bytes) -> None:
    """``data`` as one frame; above ``MAX_MSG_BYTES`` it raises."""
    if len(data) > MAX_MSG_BYTES:
        raise RpcError(f"message of {len(data)} bytes exceeds the {MAX_MSG_BYTES}-byte "
                       f"frame cap")
    sock.sendall(_LEN.pack(len(data)) + data)


def run_frames(n: int) -> int:
    """The frames a message of ``n`` bytes crosses in (1 up to the cap)."""
    return max(-(-n // MAX_MSG_BYTES), 1)


def send_frames(sock: socket.socket, data: bytes) -> None:
    """``data`` as one frame when it fits the cap, else as a run of capped
    frames behind the run header; above ``MAX_RUN_BYTES`` it raises."""
    n = len(data)
    if n <= MAX_MSG_BYTES:
        send_msg(sock, data)
        return
    if n > MAX_RUN_BYTES:
        raise RpcError(f"message of {n} bytes exceeds the {MAX_RUN_BYTES}-byte run cap")
    sock.sendall(_LEN.pack(RUN_MARK) + _RUN_HEAD.pack(run_frames(n), n))
    view = memoryview(data)
    for off in range(0, n, MAX_MSG_BYTES):
        part = view[off:off + MAX_MSG_BYTES]
        sock.sendall(_LEN.pack(len(part)))
        sock.sendall(part)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise RpcError(f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:], min(len(view) - got, 1 << 22))
        if not n:
            raise RpcError(f"connection closed mid-frame ({got}/{len(view)} bytes)")
        got += n


def _recv_run(sock: socket.socket) -> bytearray:
    count, total = _RUN_HEAD.unpack(_recv_exact(sock, _RUN_HEAD.size))
    if not MAX_MSG_BYTES < total <= MAX_RUN_BYTES or count != run_frames(total):
        raise RpcError(f"bad run header: {count} frames of {total} bytes (the run cap is "
                       f"{MAX_RUN_BYTES}; corrupt prefix?)")
    buf = bytearray(total)
    view = memoryview(buf)
    off = 0
    for i in range(count):
        (m,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
        if m == 0 or m > MAX_MSG_BYTES or off + m > total:
            raise RpcError(f"frame {i} of a run holds {m} bytes at offset {off} of {total}")
        _recv_into(sock, view[off:off + m])
        off += m
    if off != total:
        raise RpcError(f"a run of {count} frames ended at {off} of {total} bytes")
    return buf


def recv_msg(sock: socket.socket) -> bytes:
    """One message: a frame, or a run of frames behind a run header."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n == RUN_MARK:
        return _recv_run(sock)
    if n > MAX_MSG_BYTES:
        raise RpcError(f"frame of {n} bytes exceeds the {MAX_MSG_BYTES}-byte cap "
                       f"(corrupt prefix?)")
    return _recv_exact(sock, n)


# -- client ----------------------------------------------------------------

def call(addr: Tuple[str, int], op: str, payload: Optional[dict] = None, *,
         deadline_s: float = 10.0, retries: int = 3, backoff_s: float = 0.05,
         backoff_max_s: float = 2.0, retry_sent: bool = True) -> Any:
    """One RPC to ``addr``; returns the handler's result.

    ``deadline_s`` bounds the whole call, attempts and backoffs together;
    ``retries`` bounds the transport retries; ``retry_sent=False`` marks a
    non-idempotent op, which raises instead of retrying once its request was
    sent. Raises ``RpcTimeout`` or ``RpcError`` when the transport gives up,
    ``RpcRemoteError`` when the handler raised."""
    t_deadline = time.monotonic() + float(deadline_s)
    request = dumps_frame({"op": op, "payload": payload or {}})
    attempt = 0
    rng = random.Random()  # jitter only: an unseeded draw is the point
    while True:
        sent = False
        try:
            # A trip here is a transport failure before any socket work: it
            # takes the path a refused connection takes.
            faults.maybe_fail("procfleet.rpc")
            faults.maybe_delay("procfleet.rpc")
            remaining = t_deadline - time.monotonic()
            if remaining <= 0:
                raise RpcTimeout(f"rpc {op!r} to {addr}: deadline of {deadline_s}s exhausted "
                                 f"after {attempt} attempt(s)")
            with socket.create_connection(addr, timeout=remaining) as s:
                s.settimeout(max(t_deadline - time.monotonic(), 0.001))
                sent = True
                send_frames(s, request)
                resp = loads_frame(recv_msg(s))
            if "error" in resp:
                err = resp["error"]
                raise RpcRemoteError(err.get("type", "RuntimeError"), err.get("msg", ""))
            return resp.get("result")
        except RpcRemoteError:
            raise
        except (OSError, RpcError, faults.InjectedFault, ValueError) as e:
            attempt += 1
            if sent and not retry_sent:
                raise RpcError(f"rpc {op!r} to {addr} failed after the request was sent; "
                               f"not retried (non-idempotent): {e!r}") from e
            if attempt > retries or time.monotonic() >= t_deadline:
                if isinstance(e, RpcTimeout) or time.monotonic() >= t_deadline:
                    raise RpcTimeout(f"rpc {op!r} to {addr} timed out after {attempt} "
                                     f"attempt(s): {e!r}") from e
                raise RpcError(f"rpc {op!r} to {addr} failed after {attempt} attempt(s): "
                               f"{e!r}") from e
            delay = min(backoff_s * (2.0 ** (attempt - 1)), backoff_max_s)
            delay *= 1.0 + 0.5 * rng.random()  # decorrelating jitter
            time.sleep(max(min(delay, t_deadline - time.monotonic()), 0.0))


# -- server ----------------------------------------------------------------

class RpcServer:
    """A thread-per-connection server over ``handler(op, payload) ->
    result``, one call per connection. A handler exception becomes an
    ``{"error": ...}`` response; a transport error on one connection touches
    no other."""

    def __init__(self, handler: Callable[[str, dict], Any], host: str = "127.0.0.1",
                 port: int = 0, read_timeout_s: float = 30.0):
        self._handler = handler
        self._read_timeout_s = float(read_timeout_s)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.addr: Tuple[str, int] = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.addr[1]

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            # shutdown() wakes a thread blocked in accept() (close() alone
            # does not, on Linux); then the socket closes.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=5)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break  # closed by stop()
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            try:
                conn.settimeout(self._read_timeout_s)
                msg = loads_frame(recv_msg(conn))
            except (OSError, RpcError, ValueError):
                return  # a half-open or garbage connection: drop it
            try:
                resp = {"result": self._handler(msg.get("op", ""), msg.get("payload") or {})}
            except Exception as e:  # a handler's error is data
                resp = {"error": {"type": type(e).__name__, "msg": str(e)}}
            try:
                send_frames(conn, dumps_frame(resp))
            except (OSError, RpcError, TypeError):
                pass  # the client went away, or the result cannot be encoded
