"""A non-streamed request whose client hangs up frees its slot, on the
torch port's server (the reference cancels on ``asyncio.CancelledError``).

The client sends a JSON completion, waits until the engine is decoding
it, and closes its socket: the server's wait sees the connection at end
of file, cancels every candidate of the request, and the engine finishes
them as ``cancelled`` and frees their slots — long before ``max_tokens``.
The engine's decode block is slowed so the request is still decoding
when the client leaves.
"""

import json
import socket
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402

MAX_TOKENS = 900


@pytest.fixture
def server():
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "1024", "--decode-slots", "4"])
    submitted = []
    real_submit, real_block = engine.submit, engine._decode_block

    def submit(req, *a, **k):
        submitted.append(req)
        return real_submit(req, *a, **k)

    def slow_block(*a, **k):
        time.sleep(0.02)
        return real_block(*a, **k)

    engine.submit = submit
    engine._decode_block = slow_block
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address[1], engine, submitted
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


def _send(port, body):
    data = json.dumps(body).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(b"POST /v1/completions HTTP/1.0\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(data) + data)
    return sock


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


@pytest.mark.parametrize("n", [1, 3])
def test_hung_up_client_frees_the_slots(server, n):
    port, engine, submitted = server
    sock = _send(port, {"prompt": "hello there", "max_tokens": MAX_TOKENS,
                        "temperature": 0.8, "n": n, "seed": 5})
    _wait(lambda: len(submitted) == n
          and all(len(r.output_tokens) >= 3 for r in submitted))
    assert sum(s is not None for s in engine.slots) == n
    sock.close()
    for r in submitted:
        assert r.done.wait(30)
    assert [r.finish_reason for r in submitted] == ["cancelled"] * n
    assert all(len(r.output_tokens) < MAX_TOKENS for r in submitted)
    _wait(lambda: all(s is None for s in engine.slots))


def test_client_that_stays_gets_its_answer(server):
    """The poll cancels nothing while the client waits (a readable socket
    that is not at end of file, or none, is no hang-up)."""
    port, engine, submitted = server
    sock = _send(port, {"prompt": "hi", "max_tokens": 40, "temperature": 0})
    data = b""
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            break
        data += chunk
    sock.close()
    head, _, body = data.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.0 200")
    assert json.loads(body)["usage"]["completion_tokens"] == 40
    assert submitted[0].finish_reason == "length"
