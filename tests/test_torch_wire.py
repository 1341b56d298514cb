"""The port's wire protocol (``tdfo_tpu_torch/serve/wire.py``) against
``tdfo_tpu/serve/wire.py``, on the CPU: frames byte-identical in both
directions over a ``socketpair`` (the reference's ``send_msg`` feeding the
port's ``recv_msg`` and the port's feeding the reference's), the feature
codec exact for f32 and int32, torn and oversized frames refused as the
reference refuses them, the connect retries on the one backoff law, and
``listener_from_fd`` adopting a pre-bound listener (the supervisor's
socket activation)."""

import os
import random
import socket

import numpy as np
import pytest

from tdfo_tpu.serve import wire as jwire
from tdfo_tpu_torch.serve import wire as twire
from tdfo_tpu_torch.utils.retry import backoff_delay


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(9).astype(np.float32)
    # the f32 edges: subnormals, the largest, negative zero, one ulp steps
    f32[:5] = np.array([1e-45, -3.4028235e38, -0.0, 1.0000001, 1.1754942e-38],
                       np.float32)
    return {"user_id": rng.integers(0, 2**31 - 1, 9, dtype=np.int32),
            "avg_rating": f32,
            "mat": rng.standard_normal((3, 4)).astype(np.float32),
            "label": rng.integers(0, 2, 9, dtype=np.int8)}


MSGS = [{"type": "score", "rid": "r1", "feats": None},
        {"type": "drain"},
        {"type": "reply", "rid": 7, "scores": [0.25, -1.5, 3.0000001192092896],
         "queue_depth": 2, "batch_fill": 0.5},
        {"type": "sync", "skew": ["abc"], "slow": []},
        {"type": "probed", "results": {"a": None, "b": [1e-45]}}]


def _frames(wire_mod, msgs):
    """The bytes ``wire_mod.send_msg`` puts on a socket for ``msgs``."""
    a, b = socket.socketpair()
    try:
        for m in msgs:
            wire_mod.send_msg(a, m)
        a.close()
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        b.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_frames_are_the_reference_frames(seed):
    msgs = [dict(m) for m in MSGS]
    msgs[0]["feats"] = twire.encode_feats(_batch(seed))
    assert twire.encode_feats(_batch(seed)) == jwire.encode_feats(_batch(seed))
    assert _frames(twire, msgs) == _frames(jwire, msgs)


@pytest.mark.parametrize("sender,receiver", [(jwire, twire), (twire, jwire)],
                         ids=["reference_to_port", "port_to_reference"])
def test_frames_cross_the_packages(sender, receiver):
    msgs = [dict(m) for m in MSGS]
    msgs[0]["feats"] = sender.encode_feats(_batch())
    a, b = socket.socketpair()
    try:
        for m in msgs:
            sender.send_msg(a, m)
        got = [receiver.recv_msg(b) for _ in msgs]
        assert got == msgs
        out = receiver.decode_feats(got[0]["feats"])
        for k, v in _batch().items():
            assert out[k].dtype == v.dtype and out[k].shape == v.shape
            assert out[k].tobytes() == v.tobytes(), k  # bitwise, -0.0 included
        a.close()
        with pytest.raises(receiver.Disconnect):
            receiver.recv_msg(b)
    finally:
        b.close()


@pytest.mark.parametrize("cut", ["header", "body"])
def test_torn_frames_raise_as_the_reference(cut):
    errors = []
    for wire in (jwire, twire):
        a, b = socket.socketpair()
        try:
            if cut == "header":
                a.sendall(b"\x00\x00")
            else:
                a.sendall(wire._HEADER.pack(100) + b'{"type":')
            a.close()
            with pytest.raises(wire.WireError, match="torn frame") as e:
                wire.recv_msg(b)
            assert not isinstance(e.value, wire.Disconnect)
            errors.append(str(e.value))
        finally:
            b.close()
    assert errors[0] == errors[1]


def test_oversized_and_non_object_frames_refuse_as_the_reference():
    msgs = []
    for wire in (jwire, twire):
        a, b = socket.socketpair()
        try:
            with pytest.raises(wire.FrameTooLarge) as e1:
                wire.send_msg(a, {"blob": "x" * 2048}, max_frame=1024)
            a.sendall(wire._HEADER.pack(1 << 30))  # declared 1 GiB, no body
            with pytest.raises(wire.FrameTooLarge) as e2:
                wire.recv_msg(b, max_frame=1024)
            c, d = socket.socketpair()
            c.sendall(wire._HEADER.pack(9) + b"[1, 2, 3]")
            with pytest.raises(wire.WireError, match="JSON object") as e3:
                wire.recv_msg(d)
            c.close()
            d.close()
            msgs.append((str(e1.value), str(e2.value), str(e3.value)))
        finally:
            a.close()
            b.close()
    assert msgs[0] == msgs[1]


def test_connect_retries_follow_the_backoff_law(tmp_path):
    path = tmp_path / "nobody.sock"
    slept = {}
    for name, wire in (("jax", jwire), ("port", twire)):
        slept[name] = []
        with pytest.raises(OSError):
            wire.connect(path, attempts=4, base_ms=10.0, max_ms=2000.0,
                         sleep=slept[name].append, rng=random.Random(13))
    ref = random.Random(13)
    assert slept["port"] == slept["jax"] == [
        backoff_delay(i, base_delay=0.010, max_delay=2.0, rng=ref)
        for i in range(3)]


def test_listener_from_fd_adopts_a_prebound_listener(tmp_path):
    """The supervisor's handoff: a listener bound here, its fd duplicated
    (what ``pass_fds`` gives the child) and the original closed; a client
    connects before anyone adopts it, then the adopted listener accepts
    and the frames flow."""
    path = tmp_path / "replica-0.sock"
    path.write_text("stale")  # a SIGKILLed predecessor's socket file
    listener = twire.listen(path)
    fd = os.dup(listener.fileno())
    listener.close()
    client = jwire.connect(path, attempts=1)
    adopted = twire.listener_from_fd(fd)
    try:
        conn, _ = adopted.accept()
        twire.send_msg(conn, {"type": "synced", "version": 3})
        assert jwire.recv_msg(client) == {"type": "synced", "version": 3}
        jwire.send_msg(client, {"type": "shutdown"})
        assert twire.recv_msg(conn) == {"type": "shutdown"}
        conn.close()
    finally:
        client.close()
        adopted.close()
