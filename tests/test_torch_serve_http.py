"""The port's HTTP front end against ``pixray_tpu.serve.http``.

- bytes: both packages' handlers, each with a stub product that yields
  fixed PNGs, answer /health, /products, /queue, an unknown path, an
  unknown product, a bad JSON body, a full queue, a streamed POST and a
  product that raises with the same bytes (the Date header fixed);
- the port's handler removes each frame file once it has read it;
- the bounded queue, and the per-job deadline that unwedges it (as
  ``tests/test_aux.py`` holds the JAX package's);
- one real ``pixrayapi`` request on the CPU streams PNG parts.
"""

import http.client
import os
import socket
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import yaml

import pixray_tpu.serve.http as JH
import pixray_tpu_torch.serve.http as H
import pixray_tpu_torch.serve.predictors as P

# a 2x1 RGB PNG
PNG = bytes.fromhex("89504e470d0a1a0a0000000d4948445200000002000000010802000000"
                    "7b40e85d0000000f49444154789c63f8cfc0f01f0003030200ef0e5c2e0000000049454e44ae426082")
STUB_FRAMES = []


class StubProduct:
    """Yields ``n`` fresh copies of a fixed PNG, then raises if asked."""

    def __init__(self, device=None):
        pass

    def setup(self):
        pass

    def predict(self, n=2, fail=None):
        for _ in range(n):
            fd, path = tempfile.mkstemp(suffix=".png")
            with os.fdopen(fd, "wb") as f:
                f.write(PNG)
            STUB_FRAMES.append(path)
            yield path
        if fail:
            raise ValueError(fail)


def _raw(port, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(request)
        chunks = []
        while chunk := sock.recv(65536):
            chunks.append(chunk)
    return b"".join(chunks)


def _post(path, body: bytes) -> bytes:
    return (f"POST {path} HTTP/1.0\r\nContent-Length: {len(body)}\r\n\r\n").encode() + body


REQUESTS = [
    b"GET /health HTTP/1.0\r\n\r\n",
    b"GET /products HTTP/1.0\r\n\r\n",
    b"GET /queue HTTP/1.0\r\n\r\n",
    b"GET /nope HTTP/1.0\r\n\r\n",
    _post("/other", b"{}"),
    _post("/predictions/no_such_product", b"{}"),
    _post("/predictions/stub", b"{not json"),
    _post("/predictions/stub", b'{"n": 3}'),
    _post("/predictions/stub", b'{"n": 1, "fail": "the stub failed"}'),
]


def _exchange(module, monkeypatch, **worker_kw):
    monkeypatch.setitem(module.PRODUCTS, "stub", StubProduct)
    monkeypatch.setattr(module.PredictionHandler, "date_time_string", lambda self, timestamp=None: "FIXED")
    worker = module._Worker(max_pending=2, job_timeout=60, **worker_kw)
    worker.start()
    full = module._Worker(max_pending=1, **worker_kw)  # never started: its one job stays queued
    assert full.submit(module._Job("stub", {}))
    server = ThreadingHTTPServer(("127.0.0.1", 0), module.PredictionHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        monkeypatch.setattr(module, "get_worker", lambda: worker)
        out = [_raw(port, r) for r in REQUESTS]
        monkeypatch.setattr(module, "get_worker", lambda: full)
        out += [_raw(port, _post("/predictions/stub", b"{}")), _raw(port, b"GET /queue HTTP/1.0\r\n\r\n")]
        return out
    finally:
        server.shutdown()
        server.server_close()


def test_responses_are_byte_equal_to_jax(monkeypatch):
    port = _exchange(H, monkeypatch, device="cpu")
    ref = _exchange(JH, monkeypatch)
    assert len(port) == len(ref) == len(REQUESTS) + 2
    for got, want in zip(port, ref):
        assert got == want
    streamed = port[REQUESTS.index(_post("/predictions/stub", b'{"n": 3}'))]
    assert streamed.count(b"Content-Type: image/png\r\nContent-Length: %d\r\n\r\n" % len(PNG) + PNG) == 3
    assert streamed.endswith(b"--pixrayframe--\r\n")
    assert b"Content-Type: text/plain\r\n\r\nValueError: the stub failed\r\n" in port[-3]
    assert port[-2].startswith(b"HTTP/1.0 503 queue full\r\n") and b"Retry-After: 30\r\n" in port[-2]
    assert port[-1].endswith(b'{"pending": 1, "capacity": 4}')
    for path in STUB_FRAMES:
        if os.path.exists(path):
            os.remove(path)


def test_handler_removes_frames_it_sent(monkeypatch):
    STUB_FRAMES.clear()
    monkeypatch.setitem(H.PRODUCTS, "stub", StubProduct)
    worker = H._Worker(max_pending=1, job_timeout=60, device="cpu")
    worker.start()
    monkeypatch.setattr(H, "get_worker", lambda: worker)
    server = ThreadingHTTPServer(("127.0.0.1", 0), H.PredictionHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        body = _raw(server.server_address[1], _post("/predictions/stub", b'{"n": 2}'))
    finally:
        server.shutdown()
        server.server_close()
    assert body.count(PNG) == 2 and len(STUB_FRAMES) == 2
    assert not any(os.path.exists(p) for p in STUB_FRAMES)


def test_bounded_queue_backpressure():
    w = H._Worker(max_pending=1, device="cpu")  # not started: jobs stay queued
    assert w.submit(H._Job("text2image", {})) is True
    assert w.submit(H._Job("text2image", {})) is False


def test_job_deadline_unwedges_queue(monkeypatch):
    """A render stuck past the per-job deadline is cancelled (the client
    gets a timeout part), the worker keeps draining later jobs, and the
    abandoned runner is listed."""

    class StuckPredictor:
        def __init__(self, device=None):
            pass

        def setup(self):
            pass

        def predict(self, **kw):
            time.sleep(3)  # wedged inside one device call, never yields in time
            yield "never"

    class QuickPredictor(StuckPredictor):
        def predict(self, **kw):
            yield from []

    monkeypatch.setitem(H.PRODUCTS, "stuck", StuckPredictor)
    monkeypatch.setitem(H.PRODUCTS, "quick", QuickPredictor)
    w = H._Worker(max_pending=2, job_timeout=0.2, device="cpu")
    w.start()
    j1, j2 = H._Job("stuck", {}), H._Job("quick", {})
    assert w.submit(j1) and w.submit(j2)
    path, err = j1.frames.get(timeout=10)
    assert path is None and err == "TimeoutError: render exceeded the 0.2s job deadline"
    path, err = j2.frames.get(timeout=10)  # queue kept draining
    assert path is None and err is None
    assert len(w.abandoned) == 1
    w.abandoned[0].join(10)
    assert not w.abandoned[0].is_alive() and j1.frames.empty()  # stopped at its frame, which it did not send


def test_real_pixrayapi_request_on_cpu(tmp_path, monkeypatch):
    cogs = tmp_path / "cogs"
    cogs.mkdir()
    (cogs / "pixrayapi.yaml").write_text(yaml.dump(dict(
        drawer="fast_pixel", prompts="a test prompt", clip_models="TinyTest", size=[64, 36], iterations=2,
        save_every=1, display_every=1, vector_prompts="none", num_cuts=4, seed=42, learning_rate_drops=[],
        outdir=str(tmp_path / "out"), steps_per_call=1)))
    monkeypatch.setattr(P, "COGS_DIR", str(cogs))
    worker = H._Worker(device="cpu")
    worker.start()
    monkeypatch.setattr(H, "get_worker", lambda: worker)
    server = ThreadingHTTPServer(("127.0.0.1", 0), H.PredictionHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST", "/predictions/pixrayapi", body=b'{"settings": "seed: 5\\n"}')
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "multipart/x-mixed-replace; boundary=pixrayframe"
        body = resp.read()
    finally:
        server.shutdown()
        server.server_close()
    assert body.count(b"Content-Type: image/png") == 3  # displays at steps 1 and 2, then the end
    assert body.count(b"\x89PNG\r\n\x1a\n") == 3 and b"text/plain" not in body
    assert body.endswith(b"--pixrayframe--\r\n")


@pytest.mark.parametrize("argv", [["--device", "cpu", "--port", "0"], ["--port", "0"]])
def test_main_parses_device(argv, monkeypatch):
    """``main`` starts the worker on ``--device`` (the card by default) before serving."""
    seen = []

    class Stop(Exception):
        pass

    class Server:
        def __init__(self, address, handler):
            seen.append(address)

        def serve_forever(self):
            raise Stop

    monkeypatch.setattr(H, "get_worker", lambda device="cuda": seen.append(device))
    monkeypatch.setattr(H, "ThreadingHTTPServer", Server)
    monkeypatch.setattr("sys.argv", ["http"] + argv)
    with pytest.raises(Stop):
        H.main()
    assert seen == ["cpu" if "cpu" in argv else "cuda", ("0.0.0.0", 0)]
