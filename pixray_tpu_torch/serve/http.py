"""Streaming HTTP front end of the port (standard library only).

POST /predictions/<product> with a JSON body of the product's keyword
arguments; the response streams one multipart PNG part per intermediate
image.  GET /health, /products and /queue.  The routes, status codes,
headers and multipart framing are ``pixray_tpu.serve.http``'s, byte for
byte.

A ThreadingHTTPServer handles I/O concurrently, while ONE worker thread
owns the device and drains a bounded job queue: a request beyond the bound
gets 503 with Retry-After.  Each job runs in a runner thread with a
deadline (``$PIXRAY_TPU_JOB_TIMEOUT``, 600 s); past it the client gets a
timeout part and the worker starts the next job while the abandoned runner
stops at its next frame.  The next job can therefore capture its CUDA
graph while the abandoned runner still launches work: the engine captures
in the thread-local mode (``engine/step.py``).  The handler removes each
frame file once it has read it.

    python -m pixray_tpu_torch.serve.http --port 5000 [--device cpu]
    curl -X POST localhost:5000/predictions/text2image \
         -d '{"prompts": "a sunrise", "drawer": "pixel"}'
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pixray_tpu_torch.serve.predictors import PRODUCTS

BOUNDARY = "pixrayframe"
MAX_PENDING = 4  # bounded job queue: beyond this, reject with 503
JOB_TIMEOUT_S = float(os.environ.get("PIXRAY_TPU_JOB_TIMEOUT", "600"))


def _discard(path) -> None:
    """Remove a frame file the consumer owns."""
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


class _Job:
    def __init__(self, product: str, kwargs: dict):
        self.product = product
        self.kwargs = kwargs
        self.frames: queue.Queue = queue.Queue()  # file paths; (None, err) ends
        self.cancelled = threading.Event()  # deadline hit: runner must stop


class _Worker(threading.Thread):
    """Single thread that owns the device; drains the job queue in order.

    Each job runs in a helper thread bounded by ``job_timeout`` seconds.  A
    render past the deadline is cancelled: its client receives a timeout
    error part and the worker moves on to the next job.  Cancellation is
    cooperative: the runner stops at its next yielded frame (and removes
    it); a runner blocked inside one device call is abandoned (a daemon
    thread) and the next job proceeds beside it.  ``abandoned`` lists the
    runners left past their deadline (those still alive at the last one).
    """

    def __init__(self, max_pending: int = MAX_PENDING, job_timeout: float = JOB_TIMEOUT_S, device="cuda"):
        super().__init__(daemon=True)
        self.jobs: queue.Queue = queue.Queue(maxsize=max_pending)
        self.job_timeout = job_timeout
        self.device = device
        self.abandoned: list[threading.Thread] = []
        self._predictors: dict = {}

    def submit(self, job: _Job) -> bool:
        try:
            self.jobs.put_nowait(job)
            return True
        except queue.Full:
            return False

    def _run_job(self, job: _Job) -> None:
        try:
            predictor = self._predictors.get(job.product)
            if predictor is None:
                predictor = PRODUCTS[job.product](device=self.device)
                predictor.setup()
                self._predictors[job.product] = predictor
            for path in predictor.predict(**job.kwargs):
                if job.cancelled.is_set():
                    _discard(path)
                    return  # deadline already reported to the client
                job.frames.put((path, None))
            job.frames.put((None, None))
        except Exception as e:  # surface the error to the waiting client
            if not job.cancelled.is_set():
                job.frames.put((None, f"{type(e).__name__}: {e}"))

    def run(self):
        while True:
            job = self.jobs.get()
            runner = threading.Thread(target=self._run_job, args=(job,), daemon=True)
            runner.start()
            runner.join(self.job_timeout)
            if runner.is_alive():
                job.cancelled.set()
                self.abandoned = [t for t in self.abandoned if t.is_alive()] + [runner]
                job.frames.put(
                    (None, f"TimeoutError: render exceeded the "
                           f"{self.job_timeout:g}s job deadline")
                )


_worker: _Worker | None = None


def get_worker(device="cuda") -> _Worker:
    """The process's worker, started on ``device`` at the first call."""
    global _worker
    if _worker is None:
        _worker = _Worker(device=device)
        _worker.start()
    return _worker


class PredictionHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")
        elif self.path == "/products":
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(sorted(PRODUCTS)).encode())
        elif self.path == "/queue":
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(
                json.dumps({"pending": get_worker().jobs.qsize(),
                            "capacity": MAX_PENDING}).encode()
            )
        else:
            self.send_error(404)

    def do_POST(self):  # noqa: N802
        if not self.path.startswith("/predictions/"):
            self.send_error(404)
            return
        product = self.path.split("/predictions/", 1)[1].strip("/")
        if product not in PRODUCTS:
            self.send_error(404, f"unknown product {product}")
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b"{}"
        try:
            kwargs = json.loads(body or "{}")
        except json.JSONDecodeError as e:
            self.send_error(400, f"bad JSON body: {e}")
            return

        job = _Job(product, kwargs)
        if not get_worker().submit(job):
            self.send_response(503, "queue full")
            self.send_header("Retry-After", "30")
            self.end_headers()
            return

        self.send_response(200)
        self.send_header("Content-Type", f"multipart/x-mixed-replace; boundary={BOUNDARY}")
        self.end_headers()
        try:
            while True:
                path, err = job.frames.get()
                if path is None:
                    if err:
                        self.wfile.write(f"--{BOUNDARY}\r\n".encode())
                        self.wfile.write(b"Content-Type: text/plain\r\n\r\n")
                        self.wfile.write(err.encode())
                        self.wfile.write(b"\r\n")
                    break
                with open(path, "rb") as f:
                    data = f.read()
                _discard(path)
                self.wfile.write(f"--{BOUNDARY}\r\n".encode())
                self.wfile.write(b"Content-Type: image/png\r\n")
                self.wfile.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()
        except BrokenPipeError:
            # client gone: keep draining (and removing the frames) so the
            # worker never blocks on a full frame queue for a dead connection
            while (path := job.frames.get()[0]) is not None:
                _discard(path)
            return
        self.wfile.write(f"--{BOUNDARY}--\r\n".encode())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--device", default="cuda", help="where the engines run")
    args = parser.parse_args()
    get_worker(args.device)  # start the device-owning worker before accepting traffic
    server = ThreadingHTTPServer((args.host, args.port), PredictionHandler)
    print(f"pixray_tpu_torch serving on {args.host}:{args.port} ({args.device}) — products: {sorted(PRODUCTS)}")
    server.serve_forever()


if __name__ == "__main__":
    main()
