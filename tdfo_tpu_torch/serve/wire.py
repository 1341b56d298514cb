"""Length-prefixed JSON wire protocol of the process fleet — port of
``tdfo_tpu/serve/wire.py`` (host-only; frames are byte-identical to the
reference's).

A frame is a 4-byte big-endian unsigned length and that many bytes of
UTF-8 JSON.  The length is checked against ``max_frame`` before the body
is read, on both send and receive (``[serving] max_frame_bytes``).  EOF at
a frame boundary is a clean :class:`Disconnect`; EOF mid-frame is a torn
frame (:class:`WireError`), which is how the ingress tells a drained peer
from a SIGKILLed one.  Messages are dicts: ``score`` / ``reply``, ``sync``,
``heartbeat``, ``probe``, ``drain``, ``shutdown``.  Feature batches ride
:func:`encode_feats` / :func:`decode_feats`: dtype, shape and nested lists,
exact for int32 and float32 (JSON's binary64 holds every f32), so scores
that cross the wire stay bitwise comparable.  Connects retry through
``utils/retry.retry_call``, the repo's one backoff law.
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

from tdfo_tpu_torch.utils.retry import retry_call

__all__ = [
    "MAX_FRAME_BYTES", "WireError", "FrameTooLarge", "Disconnect",
    "send_msg", "recv_msg", "encode_feats", "decode_feats",
    "listen", "connect",
]

# default frame cap; [serving] max_frame_bytes overrides per fleet
MAX_FRAME_BYTES = 8 << 20

_HEADER = struct.Struct(">I")


class WireError(RuntimeError):
    """Protocol violation: torn frame, undecodable payload."""


class FrameTooLarge(WireError):
    """Declared frame length exceeds the cap — refused before the body is
    read.  The connection is poisoned (the body bytes are still in flight);
    callers must close it."""


class Disconnect(WireError):
    """Clean EOF at a frame boundary — the peer closed deliberately (drain,
    shutdown) or died between messages.  NOT raised mid-frame."""


def send_msg(sock: socket.socket, obj: Mapping[str, Any], *,
             max_frame: int = MAX_FRAME_BYTES) -> None:
    """Serialize ``obj`` and send it as one length-prefixed frame."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > max_frame:
        raise FrameTooLarge(
            f"refusing to send a {len(payload)}-byte frame (max_frame = "
            f"{max_frame}); shrink the batch or raise "
            "[serving] max_frame_bytes")
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool) -> bytes:
    """Read exactly ``n`` bytes.  EOF with zero bytes read at a frame
    boundary is a :class:`Disconnect`; any other short read is a torn
    frame."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if at_boundary and got == 0:
                raise Disconnect("peer closed the connection")
            raise WireError(
                f"torn frame: EOF after {got} of {n} expected bytes "
                f"({'header' if at_boundary else 'body'})")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket, *,
             max_frame: int = MAX_FRAME_BYTES) -> dict[str, Any]:
    """Receive one frame and decode it.  Raises :class:`FrameTooLarge` from
    the DECLARED length, before any body byte is read."""
    header = _recv_exact(sock, _HEADER.size, at_boundary=True)
    (length,) = _HEADER.unpack(header)
    if length > max_frame:
        raise FrameTooLarge(
            f"peer declared a {length}-byte frame (max_frame = {max_frame}); "
            "refusing before reading the body")
    body = _recv_exact(sock, length, at_boundary=False)
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"undecodable frame payload: {e}") from e
    if not isinstance(obj, dict):
        raise WireError(f"frame payload must be a JSON object, got "
                        f"{type(obj).__name__}")
    return obj


def encode_feats(batch: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """Feature batch -> JSON-safe codec.  int32 is exact; float32 round-trips
    bitwise through JSON's binary64 (f32 ⊂ f64), which keeps cross-process
    probe logits bitwise comparable to in-process scoring."""
    out: dict[str, Any] = {}
    for name, v in batch.items():
        arr = np.asarray(v)
        out[name] = {"dtype": arr.dtype.name, "shape": list(arr.shape),
                     "data": arr.ravel().tolist()}
    return out


def decode_feats(enc: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Inverse of :func:`encode_feats`."""
    out: dict[str, np.ndarray] = {}
    for name, spec in enc.items():
        arr = np.asarray(spec["data"], dtype=np.dtype(spec["dtype"]))
        out[name] = arr.reshape(spec["shape"])
    return out


def listen(path: str | Path, *, backlog: int = 16) -> socket.socket:
    """Bind an ``AF_UNIX`` listener at ``path`` (stale socket files from a
    SIGKILLed predecessor are unlinked — the respawn case)."""
    path = Path(path)
    if path.exists():
        path.unlink()
    path.parent.mkdir(parents=True, exist_ok=True)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(str(path))
    sock.listen(backlog)
    return sock


def listener_from_fd(fd: int) -> socket.socket:
    """Adopt an inherited, already-listening ``AF_UNIX`` socket (the
    socket-activation handoff: the supervisor binds BEFORE spawning and
    passes the fd, so the ingress can connect the instant the child
    exists — a cold child importing torch and opening its CUDA context
    never widens the connect window)."""
    return socket.socket(socket.AF_UNIX, socket.SOCK_STREAM, fileno=fd)


def _dial(path: str) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sock.connect(path)
    except OSError:
        sock.close()
        raise
    return sock


def connect(path: str | Path, *,
            attempts: int = 5,
            base_ms: float = 10.0,
            max_ms: float = 2000.0,
            sleep: Callable[[float], None] = time.sleep,
            rng: random.Random | None = None) -> socket.socket:
    """Connect to a replica's listener, retrying through ``retry_call`` (the
    repo's one backoff law) — a freshly respawned replica needs a beat to
    bind, and that window is exactly what the schedule covers.
    ``sleep``/``rng`` are injectable so tests pin the schedule."""
    return retry_call(
        _dial, str(path),
        description=f"wire.connect:{os.path.basename(str(path))}",
        attempts=attempts,
        base_delay=base_ms / 1000.0,
        max_delay=max_ms / 1000.0,
        retry_on=(OSError,),
        sleep=sleep,
        rng=rng,
    )
