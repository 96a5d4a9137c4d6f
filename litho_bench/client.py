"""Closed-loop HTTP clients of a port worker, in a process of their own.

Each client thread posts a ``/simulate`` body, waits for the reply,
decodes its image (base64 float32) and posts the next: the farm worker
that waits for its clip's image. The threads live in a child process, so
that their JSON and base64 work does not hold the server's interpreter
lock. The parent makes the masks from the seed and sends them packed 8
to a byte (a pipe can be slow: 268 MB of float32 took 30 s on an H100
host); the child encodes the request bodies before the window opens. A
latency runs from the send to the decoded reply.

The parent talks to the child over a pipe: the packed masks (the child
answers ``ready`` once their bodies are encoded); ``go`` (with the window's seconds) runs the clients until
the window closes (no request is sent after it; those in flight finish)
and answers the requests' records and the decoded images of the sampled
masks' first replies.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def post(url: str, body: bytes, timeout: float) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, {"error": err.read().decode(errors="replace")}


def get(url: str, timeout: float = 60.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def decode(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["data_b64"])
    return np.frombuffer(raw, dtype=obj.get("dtype", "float32")).reshape(
        obj["shape"]).copy()


def body_of(mask: np.ndarray, request: dict) -> bytes:
    arr = np.ascontiguousarray(mask, np.float32)
    return json.dumps({**request, "mask": {
        "shape": list(arr.shape), "dtype": "float32",
        "data_b64": base64.b64encode(arr.tobytes()).decode("ascii")}}).encode()


def run_clients(url: str, payloads: list[bytes], clients: int,
                seconds: float, sample: set, timeout: float) -> dict:
    """The closed loops. Client ``c`` sends masks ``c, c + clients, ...``
    in turn."""
    records, kept, lock = [], {}, threading.Lock()
    deadline = time.perf_counter() + seconds

    def loop(c: int):
        k = 0
        while time.perf_counter() < deadline:
            i = (c + k * clients) % len(payloads)
            t0 = time.perf_counter()
            try:
                status, reply = post(url, payloads[i], timeout)
                image = decode(reply["image"]) if status == 200 else None
            except (OSError, ValueError, KeyError) as exc:
                status, reply, image = -1, {"error": repr(exc)}, None
            t1 = time.perf_counter()
            rec = {"client": c, "mask": i, "t0": t0, "t1": t1,
                   "status": status,
                   "server_s": reply.get("report", {}).get("wall_clock_s")}
            with lock:
                records.append(rec)
                if image is not None and i in sample and i not in kept:
                    kept[i] = image
            k += 1

    threads = [threading.Thread(target=loop, args=(c,)) for c in range(clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"records": records, "kept": kept,
            "seconds": time.perf_counter() - t_start}


def child(conn, url: str, params: dict) -> None:
    """The client process: take the masks (0/1, packed 8 to a byte), encode
    their bodies, wait for ``go``, run, answer."""
    packed, shape = conn.recv()
    pool = np.unpackbits(packed, axis=-1, count=shape[-1]).astype(np.float32)
    payloads = [body_of(m, params["request"]) for m in pool]
    conn.send("ready")
    msg = conn.recv()
    if msg[0] != "go":
        return
    conn.send(run_clients(url + "/simulate", payloads, params["clients"],
                          msg[1], set(params["sample"]), params["timeout_s"]))
    conn.close()
