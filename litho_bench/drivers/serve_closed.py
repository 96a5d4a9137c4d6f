"""Closed-loop clients of the port's HTTP worker: ``serve.make_server`` on
127.0.0.1 at an ephemeral port (batching as the traffic file says) over
the run's device, and ``clients`` closed-loop clients, threads of one child
process (:mod:`litho_bench.client`), posting distinct seeded masks to
``/simulate`` with one signature (the configuration's optics, SOCS at its
rank). Set-up starts the server, sends one warm request (it builds the
kernel set into the program's cache) and starts the clients' process,
which encodes the bodies of the masks set-up makes before the window
opens.
The server and the child process end before the comparison."""

from __future__ import annotations

import multiprocessing
import threading

import numpy as np
import torch

from litho_bench import client, judge, masks

WARM_TIMEOUT_S = 600.0


def request_of(cfg: dict) -> dict:
    ill = cfg["illumination"]
    return {"pixel_number": cfg["pixel_number"], "pixel_size": cfg["pixel_nm"],
            "wavelength": cfg["wavelength_nm"], "na": cfg["na"],
            "source": {"kind": ill["kind"], "sigma_in": ill["sigma_in"],
                       "sigma_out": ill["sigma_out"], "poles": ill["poles"],
                       "rotation": ill["rotation_rad"]},
            "aberrations": list(cfg["aberrations_osa"]), "solver": "socs",
            "socs_rank": cfg["socs_rank"]}


def setup(ctx):
    from lithographysimulator_tpu_torch import serve

    cfg, tr = ctx.config, ctx.traffic
    srv = serve.make_server("127.0.0.1", 0, device=ctx.device,
                            batching=tr["batching"],
                            batch_window_s=tr["batch_window_s"],
                            max_batch=tr["max_batch"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    params = {"request": request_of(cfg), "clients": tr["clients"],
              "timeout_s": tr["timeout_s"],
              "sample": judge.sample(masks.rng_for(ctx.seed, 1), tr["pool"],
                                     tr["sample"])}
    mp = multiprocessing.get_context("spawn")
    conn, child_conn = mp.Pipe()
    proc = mp.Process(target=client.child, args=(child_conn, url, params),
                      daemon=True)
    proc.start()
    pool = masks.layouts(ctx.seed, 0, tr["pool"], cfg["pixel_number"],
                         cfg["layout"], device=ctx.device)
    host = pool.to(torch.uint8).cpu().numpy()
    conn.send((np.packbits(host, axis=-1), host.shape))
    warm = masks.layouts(ctx.seed, 2, 1, cfg["pixel_number"], cfg["layout"],
                         device="cpu")[0].numpy()
    status, reply = client.post(url + "/simulate",
                                client.body_of(warm, request_of(cfg)),
                                WARM_TIMEOUT_S)
    if status != 200:
        raise RuntimeError(f"warm request: {status} {reply}")
    if conn.recv() != "ready":
        raise RuntimeError("the clients' process did not start")
    return {"server": srv, "thread": thread, "url": url, "proc": proc,
            "conn": conn, "pool": pool}


def window(state, ctx, seconds):
    url = state["url"]
    before = client.get(url + "/health")
    with ctx.span("bench.requests"):
        state["conn"].send(("go", seconds))
        out = state["conn"].recv()
    after = client.get(url + "/health")
    recs = out["records"]
    ok = [r for r in recs if r["status"] == 200]
    t0 = min(r["t0"] for r in recs)
    end = max(r["t1"] for r in recs)
    n = ctx.config["pixel_number"]
    return {"attempted": len(recs), "failed": len(recs) - len(ok),
            "seconds": out["seconds"],
            "latencies_s": [r["t1"] - r["t0"] if r["status"] == 200
                            else end - t0 for r in recs],
            "overheads_s": [r["t1"] - r["t0"] - r["server_s"] for r in ok
                            if r["server_s"] is not None],
            "images": len(ok), "pixels": len(ok) * n * n,
            "socs_images": len(ok), "socs_rank": ctx.config["socs_rank"],
            "socs_n": n, "served": after["requests_served"] - before["requests_served"],
            "batches": after["batches_run"] - before["batches_run"],
            "kept": out["kept"]}


def release(state):
    state["conn"].close()
    state["proc"].join(timeout=60)
    if state["proc"].is_alive():
        state["proc"].kill()
        state["proc"].join()
    state["server"].shutdown()
    state["server"].server_close()
    state["thread"].join(timeout=60)


def compare(state, record, ctx):
    pairs = [(state["pool"][i], torch.as_tensor(np.asarray(image)), None)
             for i, image in sorted(record["kept"].items())]
    return [("failed_requests", float(record["failed"]), 0.0)] + \
        judge.socs_checks(ctx.config, pairs)
