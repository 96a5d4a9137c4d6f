"""Adversarial serving concurrency on the port's worker and router
(``lithographysimulator_tpu_torch/serve.py``): the scripted races of
tests/test_serve_stress.py, on the CPU.

JobRunner races run against a scripted ``_run`` (threading events pin the
exact interleaving: no sleeps, no flakes); router failure modes run against
hand-rolled misbehaving socket backends. The contract under test: terminal
states are consistent, specified 4xx statuses (404/409/410) are returned
where specified, and 5xx never leaks where they are."""

import http.server
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu_torch.serve as serve_mod
from lithographysimulator_tpu_torch.serve import (
    JobCancelled,
    JobRunner,
    Router,
    _encode_array,
    make_server,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _submit(runner, **extra):
    body = {"kind": "tiled", "mask": _encode_array(np.zeros((16, 16)))}
    body.update(extra)
    return runner.submit(body)["job_id"]


def _wait_terminal(runner, jid, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, s = runner.status(jid)
        if s["status"] in ("done", "error", "cancelled"):
            return s
        time.sleep(0.005)
    raise AssertionError(f"job {jid} never reached a terminal state")


# ---------------------------------------------------------------------------
# Cancellation racing completion
# ---------------------------------------------------------------------------


def test_cancel_racing_completion_completion_wins():
    """Cancel lands AFTER the job's last cancellation check but BEFORE it
    returns: the job completes, the terminal state is 'done' (never a
    half-cancelled hybrid), the result is intact, and a late second cancel
    reports the terminal state with 200."""
    runner = JobRunner("cpu")
    started = threading.Event()
    cancel_done = threading.Event()

    def scripted_run(job):
        job.progress = 0.5
        started.set()
        assert cancel_done.wait(30)
        return {"value": 7, "arr": np.ones((4, 4), np.float32)}

    runner._run = scripted_run
    jid = _submit(runner)
    assert started.wait(30)
    code, payload = runner.cancel(jid)
    assert code == 200 and payload["status"] == "cancelling"
    cancel_done.set()

    final = _wait_terminal(runner, jid)
    assert final["status"] == "done"
    assert final["progress"] == 1.0
    assert final["value"] == 7
    # second cancel after completion: 200 + terminal state, not an error
    code, payload = runner.cancel(jid)
    assert code == 200 and payload["status"] == "done"


def test_cancel_racing_completion_cancel_wins():
    """Cancel lands before the job's next cancellation check: terminal
    state is 'cancelled', no result is attached, and the executor moves on
    to later jobs."""
    runner = JobRunner("cpu")
    started = threading.Event()
    cancel_done = threading.Event()
    runs = []

    def scripted_run(job):
        runs.append(job.id)
        if len(runs) == 1:
            started.set()
            assert cancel_done.wait(30)
            if job.cancelled:
                raise JobCancelled()
        return {"ok": True}

    runner._run = scripted_run
    jid = _submit(runner)
    assert started.wait(30)
    code, payload = runner.cancel(jid)
    assert code == 200 and payload["status"] == "cancelling"
    cancel_done.set()
    final = _wait_terminal(runner, jid)
    assert final["status"] == "cancelled"
    assert "ok" not in final

    # executor is alive: a follow-up job completes
    jid2 = _submit(runner)
    assert _wait_terminal(runner, jid2)["status"] == "done"
    assert runs == [jid, jid2]


def test_cancel_queued_behind_running_job():
    """Cancelling a QUEUED job while the worker is busy drops it from the
    queue synchronously — it never runs."""
    runner = JobRunner("cpu")
    release = threading.Event()
    started = threading.Event()
    runs = []

    def scripted_run(job):
        runs.append(job.id)
        started.set()
        assert release.wait(30)
        return {}

    runner._run = scripted_run
    first = _submit(runner)
    assert started.wait(30)
    queued = _submit(runner)
    code, payload = runner.cancel(queued)
    assert code == 200 and payload["status"] == "cancelled"
    release.set()
    assert _wait_terminal(runner, first)["status"] == "done"
    _, s = runner.status(queued)
    assert s["status"] == "cancelled"
    assert runs == [first]  # the cancelled job never executed


def test_artifact_of_cancelled_job_is_409():
    """A cancelled job's artifact path answers 409 (job not done), never a
    5xx or a stale array."""
    runner = JobRunner("cpu")
    started = threading.Event()
    cancel_done = threading.Event()

    def scripted_run(job):
        started.set()
        assert cancel_done.wait(30)
        raise JobCancelled()

    runner._run = scripted_run
    jid = _submit(runner)
    assert started.wait(30)
    runner.cancel(jid)
    cancel_done.set()
    _wait_terminal(runner, jid)
    code, err = runner.artifact(jid, "image")
    assert code == 409 and "not done" in err["error"]


# ---------------------------------------------------------------------------
# Artifact eviction racing a streaming client
# ---------------------------------------------------------------------------


@pytest.fixture()
def stress_server():
    srv = make_server("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()


def test_eviction_while_client_streams(stress_server, monkeypatch):
    """Evicting an artifact while a client connection is mid-stream must
    not corrupt the in-flight response; afterwards the path answers 410."""
    monkeypatch.setattr(serve_mod, "_INLINE_ARRAY_LIMIT", 1024)
    url, srv = stress_server
    mask = np.zeros((96, 96), np.float32)
    for x in range(8, 84, 24):
        mask[:, x:x + 8] = 1.0
    req = urllib.request.Request(
        url + "/jobs", data=json.dumps(
            {"kind": "tiled", "mask": _encode_array(mask),
             "pixel_number": 48, "rank": 16, "halo": 8,
             "source": {"kind": "classical", "sigma_out": 0.5}}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        jid = json.loads(resp.read())["job_id"]
    runner = srv.service.jobs()  # the JobRunner behind the HTTP surface
    final = _wait_terminal(runner, jid, timeout=120)
    assert final["status"] == "done"
    path = final["image"]["stream_path"]

    # open the stream (headers in), then evict while the body is in flight
    resp = urllib.request.urlopen(url + path, timeout=60)
    assert resp.status == 200
    job = runner._jobs[jid]
    expected = job.artifacts["image"].copy()
    monkeypatch.setattr(JobRunner, "MAX_ARTIFACT_BYTES", 1)
    runner._evict_artifacts()
    assert not job.artifacts  # eviction really happened mid-stream
    blob = resp.read()
    resp.close()
    got = np.frombuffer(blob, np.float32).reshape(96, 96)
    np.testing.assert_array_equal(got, expected)  # stream unharmed

    code = None
    try:
        urllib.request.urlopen(url + path, timeout=30)
    except urllib.error.HTTPError as err:
        code = err.code
        payload = json.loads(err.read())
    assert code == 410 and "evicted" in payload["error"]


# ---------------------------------------------------------------------------
# Router vs misbehaving backends
# ---------------------------------------------------------------------------


class _BlockingBackend:
    """Minimal real-HTTP backend whose /simulate blocks until released;
    records arrival order."""

    def __init__(self):
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, status, payload):
                blob = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                self._reply(200, {"status": "ok"})

            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                tag = json.loads(body).get("tag")
                with outer.lock:
                    outer.seen.append(tag)
                assert outer.release.wait(60)
                self._reply(200, {"tag": tag})

        self.seen = []
        self.lock = threading.Lock()
        self.release = threading.Event()
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()


def test_router_backpressure_all_served_and_bounded():
    """All-backends-busy: excess requests queue at the router (admission
    semaphore), every queued request is eventually served exactly once with
    200, the queue counter reports the backlog, and a request that cannot
    be admitted within queue_wait_s gets a clean 503."""
    backend = _BlockingBackend()
    try:
        router = Router([backend.url], max_inflight=1, queue_wait_s=30.0,
                        affinity=False)
        results = {}

        def fire(tag):
            body = json.dumps({"tag": tag}).encode()
            results[tag] = router.dispatch("/simulate", body)

        threads = [threading.Thread(target=fire, args=(t,))
                   for t in ("a", "b", "c", "d")]
        for t in threads:
            t.start()
            time.sleep(0.15)  # let each reach the admission gate in order
        # exactly one is in flight at the backend; the rest are queued
        deadline = time.time() + 10
        while time.time() < deadline and len(backend.seen) < 1:
            time.sleep(0.01)
        assert len(backend.seen) == 1
        assert router.queued >= 1  # backlog is visible

        backend.release.set()
        for t in threads:
            t.join(60)
        assert sorted(results) == ["a", "b", "c", "d"]
        for tag, (status, payload) in results.items():
            assert status == 200 and payload["tag"] == tag, (tag, status)
        assert sorted(backend.seen) == ["a", "b", "c", "d"]  # exactly once

        # bounded wait: with the backend blocked again and a tiny budget,
        # the router answers 503 instead of hanging
        backend.release.clear()
        hold = threading.Thread(
            target=lambda: router.dispatch(
                "/simulate", json.dumps({"tag": "hold"}).encode()))
        hold.start()
        time.sleep(0.2)
        fast = Router([backend.url], max_inflight=1, queue_wait_s=0.2,
                      affinity=False)
        # consume the single slot of the fresh router too
        hold2 = threading.Thread(
            target=lambda: fast.dispatch(
                "/simulate", json.dumps({"tag": "hold2"}).encode()))
        hold2.start()
        time.sleep(0.2)
        status, payload = fast.dispatch(
            "/simulate", json.dumps({"tag": "late"}).encode())
        assert status == 503 and "queue wait" in payload["error"]
        backend.release.set()
        hold.join(60)
        hold2.join(60)
    finally:
        backend.release.set()
        backend.close()


def _raw_socket_backend(script):
    """One-connection-at-a-time raw socket server: ``script(conn)`` decides
    what bytes (if any) to send before closing."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def serve():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except TimeoutError:
                continue
            except OSError:
                break
            with conn:
                try:
                    conn.recv(65536)
                    script(conn)
                except OSError:
                    pass
        srv.close()

    threading.Thread(target=serve, daemon=True).start()
    return f"http://127.0.0.1:{port}", stop


def test_router_no_failover_after_status_line():
    """A backend that dies MID-RESPONSE (status line sent, body truncated)
    must NOT be retried — the request may have executed. The router
    surfaces 502, and the healthy sibling backend never sees the request."""
    good = _BlockingBackend()
    good.release.set()

    def die_mid_body(conn):
        conn.sendall(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: 1000\r\n\r\n{\"par")
        # close with data outstanding

    bad_url, stop = _raw_socket_backend(die_mid_body)
    try:
        router = Router([bad_url, good.url], affinity=False, timeout_s=10.0)
        router._next = 0  # deterministic: first attempt hits the dying one
        status, payload = router.dispatch(
            "/simulate", json.dumps({"tag": "x"}).encode())
        assert status == 502 and "aborted" in payload["error"]
        assert good.seen == []  # no double-dispatch of maybe-executed work
    finally:
        stop.set()
        good.close()


def test_router_fails_over_before_status_line():
    """A backend that resets the connection BEFORE any response bytes is
    safe to fail over: the sibling serves the request, the client sees 200
    and no 5xx."""
    good = _BlockingBackend()
    good.release.set()

    def slam(conn):
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        b"\x01\x00\x00\x00\x00\x00\x00\x00")  # RST on close

    bad_url, stop = _raw_socket_backend(slam)
    try:
        router = Router([bad_url, good.url], affinity=False, timeout_s=10.0)
        router._next = 0
        status, payload = router.dispatch(
            "/simulate", json.dumps({"tag": "y"}).encode())
        assert status == 200 and payload["tag"] == "y"
        assert good.seen == ["y"]
    finally:
        stop.set()
        good.close()
