"""Port parity: the HTTP worker, jobs and router (``serve.py``) of the
torch port against the JAX package's, over real sockets on the CPU.

The same JSON bodies go to a JAX server and a port server (``device=
"cpu"``) on 32^2 grids: an exact ``/simulate`` image agrees within the
``rtol=1e-6`` of tests/test_serve.py:57, and every job kind ends ``done``
on both (at 64^2 tiles, a classical sigma-0.2 source and rank 24, where
both packages' kernel builds are exact: tiled images within 1e-5 of their
peak, equal CD matrices and decompositions). SOCS requests draw other
probes in each package, so a SOCS response is held to the exact image
within its reported bound, and to the port's own ``simulate_batch`` on the
cached kernels. The rest covers tests/test_serve.py's cases on the port's
server: batching, errors, limits, jobs, cancel, artifacts, the router;
not the slow fleet throughput test, and not the JAX worker's jit-cache
hygiene (ROADMAP.md D12: ``/health`` reports the SOCS kernel cache).
"""

import inspect
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu.serve as jserve
import lithographysimulator_tpu_torch as lt
import lithographysimulator_tpu_torch.serve as pserve
from lithographysimulator_tpu_torch.serve import (_decode_array,
                                                  _encode_array, make_router,
                                                  make_server)

CFG = lt.OpticsConfig(pixel_number=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _start(srv) -> str:
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    srv = make_server("127.0.0.1", 0, device="cpu")
    yield _start(srv)
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_server():
    srv = jserve.make_server("127.0.0.1", 0)
    yield _start(srv)
    srv.shutdown()


@pytest.fixture(scope="module")
def fleet():
    """Two port workers and a port router over them."""
    servers = [make_server("127.0.0.1", 0, device="cpu") for _ in range(2)]
    backends = [_start(srv) for srv in servers]
    router = make_router(backends, "127.0.0.1", 0)
    yield _start(router), servers
    router.shutdown()
    for srv in servers:
        srv.shutdown()


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _poll_job(url, job_id, timeout_s=180.0):
    seen = []
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        status, payload = _get(url, f"/jobs/{job_id}")
        assert status == 200, payload
        seen.append(payload["progress"])
        if payload["status"] in ("done", "error", "cancelled"):
            return payload, seen
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish: {payload}")


def _demo_mask() -> np.ndarray:
    return lt.demo_bars(CFG, device="cpu").geometry.numpy()


def _simulate_body(mask, **overrides):
    body = {
        "pixel_number": 32,
        "mask": _encode_array(mask),
        "source": {"kind": "classical", "sigma_out": 0.5},
        "normalize": True,
    }
    body.update(overrides)
    return body


def _local(mask, **kw) -> np.ndarray:
    return lt.simulate(lt.from_array(mask, CFG, device="cpu"),
                       lt.LightSource(CFG, sigma_out=0.5).classical(),
                       device="cpu", normalize=True, **kw).image.numpy()


def _job_body(kind, big_n=96, **overrides):
    mask = np.zeros((big_n, big_n), np.float32)
    for x in range(8, big_n - 12, 24):
        mask[:, x:x + 8] = 1.0
    body = {"kind": kind, "mask": _encode_array(mask), "pixel_number": 48,
            "rank": 16, "halo": 8,
            "source": {"kind": "classical", "sigma_out": 0.5}}
    body.update(overrides)
    return body


# ---------------------------------------------------------------------------
# The port against the JAX server
# ---------------------------------------------------------------------------


def test_simulate_matches_the_jax_server(server, jax_server):
    """The same body on both servers: exact images within rtol 1e-6 (the
    tolerance of tests/test_serve.py:57), and each equal to a local
    simulate of its own package."""
    mask = _demo_mask()
    body = _simulate_body(mask)
    status, ours = _post(server, "/simulate", body)
    jstatus, ref = _post(jax_server, "/simulate", body)
    assert status == jstatus == 200
    a, b = _decode_array(ours["image"]), _decode_array(ref["image"])
    assert a.shape == (32, 32) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7 * b.max())
    np.testing.assert_array_equal(a, _local(mask))
    assert ours["report"]["source_points"] == ref["report"]["source_points"] > 0
    assert ours["report"]["solver"] == ref["report"]["solver"] == "gau23"


def test_socs_requests_hold_their_bound(server, jax_server):
    """solver socs, rank pinned at 24: randomized builds draw other probes
    in each package, so each response is held to the exact image within
    the port's reported bound, and the port's to its own simulate_batch on
    the same cached kernels (equal: the build is seeded)."""
    rng = np.random.default_rng(4)
    mask = (rng.random((32, 32)) > 0.6).astype(np.float32)
    body = _simulate_body(mask, solver="socs", socs_rank=24)
    status, ours = _post(server, "/simulate", body)
    jstatus, ref = _post(jax_server, "/simulate", body)
    assert status == jstatus == 200
    exact = _local(mask)
    run = lt.simulate(lt.from_array(mask, CFG, device="cpu"),
                      lt.LightSource(CFG, sigma_out=0.5).classical(),
                      device="cpu", normalize=True, solver="socs",
                      socs_rank=24)
    bound = run.report["socs_image_nrms_bound"]
    batch = lt.simulate_batch(
        mask[None], CFG, lt.LightSource(CFG, sigma_out=0.5).classical(),
        device="cpu", solver="socs", socs_rank=24, normalize=True)[0]
    a, b = _decode_array(ours["image"]), _decode_array(ref["image"])
    np.testing.assert_array_equal(a, batch.numpy())
    for img in (a, b):
        err = np.sqrt(np.mean((img - exact) ** 2)) / exact.max()
        assert err <= bound, (err, bound)


def test_the_wire_format_is_shared():
    """Either package's encoder is decoded by the other, bit for bit."""
    arr = np.random.default_rng(0).random((3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(jserve._decode_array(_encode_array(arr)), arr)
    np.testing.assert_array_equal(_decode_array(jserve._encode_array(arr)), arr)
    assert _encode_array(arr) == jserve._encode_array(arr)
    np.testing.assert_array_equal(_decode_array(arr.tolist()), arr)


PARITY = {"pixel_number": 64, "rank": 24, "halo": 16,
          "source": {"kind": "classical", "sigma_out": 0.2}}
KIND_EXTRA = {
    "tiled": {},
    "fem": {"defocus_nm": [-60.0, 0.0, 60.0], "doses": [0.9, 1.0, 1.1],
            "threshold": 0.25},
    "opc": {"steps": 2, "lr": 0.2},
    "stochastic": {"trials": 4, "dose_photons": 5.0, "diffusion": 10.0,
                   "threshold": 0.3, "seed": 1},
    "lele": {"min_pitch_nm": 200.0},
    "film": {"nz": 2, "stack": {"thickness_nm": 100.0}},
}


@pytest.mark.parametrize("kind", sorted(KIND_EXTRA))
def test_every_job_kind_ends_done_on_both_servers(server, jax_server, kind):
    big_n = 128
    mask = np.zeros((big_n, big_n), np.float32)
    for x in range(10, big_n - 10, 12):
        mask[8:-8, x:x + 5] = 1.0
    body = dict(PARITY, kind=kind, mask=_encode_array(mask), **KIND_EXTRA[kind])
    finals = []
    for url in (server, jax_server):
        status, payload = _post(url, "/jobs", body)
        assert status == 200, payload
        final, _ = _poll_job(url, payload["job_id"])
        assert final["status"] == "done", final
        assert final["progress"] == 1.0
        finals.append(final)
    ours, ref = finals
    assert ours.keys() == ref.keys()
    if kind == "tiled":
        a, b = _decode_array(ours["image"]), _decode_array(ref["image"])
        assert a.shape == (big_n, big_n) and ours["rank"] == ref["rank"] == 24
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * b.max())
    elif kind == "fem":
        assert ours["cd_nm"] == ref["cd_nm"]
        assert ours["depth_of_focus_nm"] == ref["depth_of_focus_nm"]
    elif kind == "lele":
        for key in ("features", "conflict_edges", "violations", "masks"):
            assert ours[key] == ref[key], key
        for key in ("mask_a", "mask_b"):
            np.testing.assert_array_equal(_decode_array(ours[key]),
                                          _decode_array(ref[key]))
    elif kind == "film":
        assert ours["depths_nm"] == ref["depths_nm"] == [25.0, 75.0]
        a, b = _decode_array(ours["exposure"]), _decode_array(ref["exposure"])
        assert a.shape == b.shape == (2, big_n, big_n)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * b.max())
    elif kind == "opc":
        a = _decode_array(ours["mask"])
        assert a.shape == (big_n, big_n) and 0.0 <= a.min() <= a.max() <= 1.0
    else:  # stochastic: the ensembles agree in distribution only (D2)
        assert ours["trials"] == ref["trials"] == 4
        assert ours["big_n"] == ref["big_n"] == big_n
        band = _decode_array(ours["print_probability"])
        assert 0.0 <= band.min() <= band.max() <= 1.0


def test_jax_client_helpers_read_the_port_server(server, monkeypatch):
    """A JAX client fetches a port job's artifact with its own helper."""
    monkeypatch.setattr(pserve, "_INLINE_ARRAY_LIMIT", 1024)
    status, payload = _post(server, "/jobs", _job_body("tiled"))
    final, _ = _poll_job(server, payload["job_id"])
    desc = final["image"]
    ours = pserve.fetch_artifact(server, desc["stream_path"])
    ref = jserve.fetch_artifact(server, desc["stream_path"])
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (96, 96)


# ---------------------------------------------------------------------------
# The port worker: tests/test_serve.py's cases
# ---------------------------------------------------------------------------


def test_health(server):
    status, payload = _get(server, "/health")
    assert status == 200 and payload["status"] == "ok"
    assert payload["device_count"] >= 1 and payload["platform"] == "cpu"
    assert payload["socs_cache_entries"] >= 0
    assert payload["socs_cache_bytes"] >= 0
    assert "live_programs" not in payload  # D12


def test_health_counts_the_cache_and_the_launches(server):
    """/health adds the SOCS kernel-set cache's hits, misses, evictions,
    key reuses and bounds from an entry's terms, and the int8 launches by
    kernel (none on the CPU) to its keys; a SOCS request's look-up shows
    among them."""
    before = _get(server, "/health")[1]
    keys = ("socs_cache_hits", "socs_cache_misses", "socs_cache_evictions",
            "socs_cache_key_reuses", "socs_cache_bound_from_entry")
    assert all(isinstance(before[k], int) and before[k] >= 0 for k in keys)
    assert set(before["int8_launches"]) == {
        "window_product_limbs", "row_limb_gemm", "row_requantize",
        "column_intensity"}
    status, _ = _post(server, "/simulate", _simulate_body(
        _demo_mask(), solver="socs", socs_rank=8))
    assert status == 200
    after = _get(server, "/health")[1]
    assert (after["socs_cache_hits"] + after["socs_cache_misses"]
            > before["socs_cache_hits"] + before["socs_cache_misses"])


def test_a_served_request_carries_its_id_on_its_spans(server):
    """Under a profiler, one /simulate's read, decode, queue and encode
    spans share its request id, and the batch span that ran it lists that
    id, with its coalescing window and its run inside it."""
    from torch.profiler import ProfilerActivity, profile

    from lithographysimulator_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        status, _ = _post(server, "/simulate", _simulate_body(_demo_mask()))
    assert status == 200
    spans = profiling.recording()["spans"]
    wire = [s for s in spans if s["name"] in (
        "litho.serve.read", "litho.serve.decode", "litho.serve.queue",
        "litho.serve.encode")]
    assert {s["name"] for s in wire} == {"litho.serve.read", "litho.serve.decode",
                                         "litho.serve.queue", "litho.serve.encode"}
    (rid,) = {s["request"] for s in wire}
    assert rid is not None
    (batch,) = [s for s in spans if s["name"] == "litho.serve.batch"]
    assert batch["attrs"] == {"size": 1, "requests": [rid]}
    inside = {s["name"] for s in spans if s["parent"] == batch["id"]}
    assert inside == {"litho.serve.batch.window", "litho.serve.batch.run"}
    (queue,) = [s for s in wire if s["name"] == "litho.serve.queue"]
    assert queue["start_ns"] <= batch["end_ns"] and queue["end_ns"] <= batch["end_ns"]


def test_entry_points_default_to_the_card():
    svc = pserve.LithoService(batching=False)
    assert svc.device == torch.device("cuda")
    assert inspect.signature(pserve.JobRunner).parameters["device"].default == "cuda"
    assert inspect.signature(pserve.make_server).parameters["device"].default == "cuda"
    with pytest.raises(SystemExit) as exc:
        pserve.main(["--help"])
    assert exc.value.code == 0


def test_bad_requests(server):
    status, payload = _post(server, "/simulate", {"pixel_number": 32})
    assert status == 400 and "mask" in payload["error"]
    status, payload = _post(server, "/simulate", {
        "pixel_number": 32, "mask": _encode_array(np.zeros((32, 32))),
        "source": {"kind": "laser"}})
    assert status == 400 and "laser" in payload["error"]
    status, _ = _post(server, "/nope", {})
    assert status == 404
    req = urllib.request.Request(server + "/simulate", data=b"{nope",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400


@pytest.mark.parametrize("field,value", [("pixel_number", 65536),
                                         ("pixel_number", 4),
                                         ("socs_rank", 10**6),
                                         ("chunk", 10**6)])
def test_resource_limits_rejected(server, field, value):
    body = {"pixel_number": 32, "mask": _encode_array(np.zeros((32, 32))),
            field: value}
    status, payload = _post(server, "/simulate", body)
    assert status == 400 and "out of range" in payload["error"]


def test_requests_counted(server):
    _post(server, "/simulate", _simulate_body(_demo_mask()))
    assert _get(server, "/health")[1]["requests_served"] >= 1


def test_concurrent_requests_all_succeed(server):
    """8 concurrent posts with different masks: each response carries its
    own mask's image."""
    rng = np.random.default_rng(0)
    masks = [(rng.random((32, 32)) > 0.7).astype(np.float32) for _ in range(8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(
            lambda m: _post(server, "/simulate", _simulate_body(m)), masks))
    for mask, (status, payload) in zip(masks, results):
        assert status == 200
        np.testing.assert_allclose(_decode_array(payload["image"]),
                                   _local(mask), rtol=1e-5, atol=1e-7)


def test_batching_coalesces_same_signature(server):
    before = _get(server, "/health")[1]
    rng = np.random.default_rng(1)
    masks = [(rng.random((32, 32)) > 0.5).astype(np.float32) for _ in range(8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(
            lambda m: _post(server, "/simulate", _simulate_body(m)), masks))
    assert all(status == 200 for status, _ in results)
    after = _get(server, "/health")[1]
    served = after["requests_served"] - before["requests_served"]
    batches = after["batches_run"] - before["batches_run"]
    assert served == 8 and batches < served
    assert after["batched_requests"] > before["batched_requests"]


def test_batch_error_isolated(server):
    status, _ = _post(server, "/simulate",
                      _simulate_body(np.zeros((32, 32)), solver="magic"))
    assert status == 400
    status, _ = _post(server, "/simulate", _simulate_body(_demo_mask()))
    assert status == 200


def test_unbatched_service_matches_batched(server):
    svc = pserve.LithoService(device="cpu", batching=False)
    out = svc.simulate(_simulate_body(_demo_mask()))
    np.testing.assert_array_equal(_decode_array(out["image"]),
                                  _local(_demo_mask()))
    assert svc.requests_served == 1 and svc.batches_run == 0


def test_polarized_simulate(server):
    mask = _demo_mask()
    common = dict(na=1.35, immersion_index=1.437)
    st_s, scalar = _post(server, "/simulate", _simulate_body(mask, **common))
    st_x, pol_x = _post(server, "/simulate",
                        _simulate_body(mask, polarization="x", **common))
    assert st_s == st_x == 200
    a, b = _decode_array(scalar["image"]), _decode_array(pol_x["image"])
    assert np.abs(a - b).max() > 1e-3 * a.max()
    status, pol_socs = _post(server, "/simulate", _simulate_body(
        mask, polarization="x", solver="socs", **common))
    assert status == 200
    c = _decode_array(pol_socs["image"])
    assert np.abs(c - b).max() < 2e-2 * b.max()
    status, _ = _post(server, "/simulate",
                      _simulate_body(mask, polarization="circular?"))
    assert status == 400
    status, _ = _post(server, "/simulate",
                      _simulate_body(mask, polarization=[[1, 0], 1]))
    assert status == 200


def test_chromatic_simulate(server):
    mask = _demo_mask()
    chrom = {"bandwidth_pm": 1.0, "focus_nm_per_pm": -400.0, "samples": 3}
    st_m, mono = _post(server, "/simulate", _simulate_body(mask))
    st_c, poly = _post(server, "/simulate", _simulate_body(mask, chromatic=chrom))
    assert st_m == st_c == 200
    a, b = _decode_array(mono["image"]), _decode_array(poly["image"])
    assert np.abs(a - b).max() > 1e-4 * a.max()
    status, socs = _post(server, "/simulate", _simulate_body(
        mask, chromatic=chrom, solver="socs"))
    assert status == 200
    assert np.abs(_decode_array(socs["image"]) - b).max() < 2e-2 * b.max()
    for bad in ({"shape": "gaussian"}, {"bandwidth_pm": 0.5, "samples": 99}):
        status, _ = _post(server, "/simulate", _simulate_body(mask, chromatic=bad))
        assert status == 400


def test_simulate_accepts_perturbation_and_obscuration(server):
    base = _simulate_body(_demo_mask())
    a = _decode_array(_post(server, "/simulate", base)[1]["image"])
    status, blurred = _post(server, "/simulate",
                            dict(base, msd_x_nm=40.0, flare_tis=0.1))
    assert status == 200
    b = _decode_array(blurred["image"])
    assert not np.allclose(a, b) and b.max() < a.max()
    status, obscured = _post(server, "/simulate", dict(base, obscuration=0.3))
    assert status == 200 and not np.allclose(a, _decode_array(obscured["image"]))
    status, err = _post(server, "/simulate", dict(base, obscuration=1.5))
    assert status == 400 and "obscuration" in err["error"]


M3D = {"model": "boundary_layer", "width_nm": 8.0,
       "beta_h": [-0.3, 0.0], "beta_v": [-0.3, 0.1]}


def test_simulate_endpoint_m3d(server, jax_server):
    mask = np.zeros((48, 48), np.float32)
    mask[:, 16:26] = 1.0
    body = {"mask": _encode_array(mask), "pixel_number": 48,
            "source": {"kind": "classical", "sigma_out": 0.5},
            "normalize": True}
    status, thin = _post(server, "/simulate", body)
    assert status == 200
    body["m3d"] = M3D
    status, thick = _post(server, "/simulate", body)
    jstatus, ref = _post(jax_server, "/simulate", body)
    assert status == jstatus == 200
    a, b = _decode_array(thin["image"]), _decode_array(thick["image"])
    assert np.isfinite(b).all()
    assert np.linalg.norm(a - b) / np.linalg.norm(a) > 1e-2
    r = _decode_array(ref["image"])
    np.testing.assert_allclose(b, r, rtol=1e-6, atol=1e-7 * r.max())


def test_m3d_path_payloads_rejected(server):
    """String 'm3d' payloads are refused on both surfaces: the server must
    never read a client-named local file."""
    mask = np.zeros((48, 48), np.float32)
    body = {"mask": _encode_array(mask), "pixel_number": 48,
            "m3d": "/etc/passwd"}
    status, payload = _post(server, "/simulate", body)
    assert status == 400 and "dict" in payload["error"]
    status, payload = _post(server, "/jobs", _job_body("tiled", m3d="/etc/passwd"))
    assert status == 200
    final, _ = _poll_job(server, payload["job_id"])
    assert final["status"] == "error" and "dict" in final["error"]


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------


def test_job_tiled_with_progress_equals_local_tiled(server):
    """The job's image equals a local tiled_socs_image on the kernel set
    the job cached, bit for bit; progress rises to 1."""
    from lithographysimulator_tpu_torch.ops.tiled import tiled_socs_image
    from lithographysimulator_tpu_torch.simulate import _socs_kernels_cached

    body = _job_body("tiled", tiles_per_dispatch=1)
    status, payload = _post(server, "/jobs", body)
    assert status == 200 and payload["status"] == "queued"
    final, progress = _poll_job(server, payload["job_id"])
    assert final["status"] == "done", final
    img = _decode_array(final["image"])
    tile = lt.OpticsConfig(pixel_number=48)
    src = lt.LightSource(tile, sigma_out=0.5).classical()
    socs = _socs_kernels_cached(tile, src, np.zeros(1, np.float32), 16,
                                device="cpu")[0]
    local = tiled_socs_image(_decode_array(body["mask"]), socs, tile, halo=8)
    np.testing.assert_array_equal(img, local.numpy())
    assert final["progress"] == 1.0 and final["rank"] == 16
    assert all(b >= a for a, b in zip(progress, progress[1:]))


def test_job_fem_end_to_end(server):
    body = _job_body("fem", defocus_nm=[-50.0, 0.0, 50.0],
                     doses=[0.9, 1.0, 1.1], threshold=0.3)
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert np.asarray(final["cd_nm"]).shape == (3, 3)
    assert "depth_of_focus_nm" in final and final["cdu"]["count"] > 0
    assert "cd_map_nm" in final


def test_job_fem_pv_bands(server):
    body = _job_body("fem", defocus_nm=[-80.0, 0.0, 80.0],
                     doses=[0.9, 1.0, 1.1], threshold=0.3, pv_bands=True)
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert final["pv"]["band_area_frac"] > 0
    outer, inner, band = (_decode_array(final[f"pv_{k}"])
                          for k in ("outer", "inner", "band"))
    assert not ((inner > 0.5) & (outer < 0.5)).any()
    np.testing.assert_array_equal(band > 0.5, (outer > 0.5) & (inner < 0.5))


def test_job_fem_reports_nils_and_hotspots(server):
    body = _job_body("fem", defocus_nm=[0.0], doses=[1.0], threshold=0.25,
                     hotspot_nils=100.0)
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert final["nils"]["mean_nils"] > 0
    assert 0 < len(final["hotspots"]["locations"]) <= 10


def test_job_concurrent_with_simulate(server):
    """A running job does not break /simulate traffic: both threads launch
    on one device."""
    job_id = _post(server, "/jobs", _job_body("tiled", big_n=128))[1]["job_id"]
    for _ in range(3):
        st, sim = _post(server, "/simulate", _simulate_body(_demo_mask()))
        assert st == 200
        np.testing.assert_array_equal(_decode_array(sim["image"]),
                                      _local(_demo_mask()))
    final, _ = _poll_job(server, job_id)
    assert final["status"] == "done", final


def test_job_validation_errors(server):
    status, payload = _post(server, "/jobs", {"kind": "nope", "mask": [[0.0]]})
    assert status == 400 and "kind" in payload["error"]
    status, _ = _post(server, "/jobs", _job_body("tiled", mask=[[0.0, 1.0]]))
    assert status == 400
    status, _ = _post(server, "/jobs", _job_body(
        "tiled", mask=_encode_array(np.zeros((8200, 1), np.float32))))
    assert status == 400
    assert _get(server, "/jobs/not-a-job")[0] == 404


def test_job_cancellation(server):
    jid = _post(server, "/jobs", _job_body("tiled", big_n=192,
                                           tiles_per_dispatch=1))[1]["job_id"]
    deadline = time.time() + 60
    while time.time() < deadline and _get(server, f"/jobs/{jid}")[1]["status"] != "running":
        time.sleep(0.01)
    status, _ = _post(server, f"/jobs/{jid}/cancel", {})
    assert status == 200
    final, _ = _poll_job(server, jid, timeout_s=120)
    assert final["status"] == "cancelled"
    jid2 = _post(server, "/jobs", _job_body("tiled"))[1]["job_id"]
    done, _ = _poll_job(server, jid2)
    assert done["status"] == "done"
    status, payload = _post(server, f"/jobs/{jid2}/cancel", {})
    assert status == 200 and payload["status"] == "done"
    assert _post(server, "/jobs/zzz/cancel", {})[0] == 404


def test_job_opc_kind(server):
    final, _ = _poll_job(server, _post(server, "/jobs", _job_body(
        "opc", steps=4, lr=0.2))[1]["job_id"], timeout_s=300)
    assert final["status"] == "done", final
    corrected = _decode_array(final["mask"])
    assert corrected.shape == (96, 96) and np.isfinite(corrected).all()
    assert 0.0 <= corrected.min() and corrected.max() <= 1.0


def test_job_artifact_streaming(server, monkeypatch):
    monkeypatch.setattr(pserve, "_INLINE_ARRAY_LIMIT", 1024)
    jid = _post(server, "/jobs", _job_body("tiled"))[1]["job_id"]
    final, _ = _poll_job(server, jid)
    assert final["status"] == "done", final
    desc = final["image"]
    assert "data_b64" not in desc and desc["artifact"] == "image"
    assert desc["shape"] == [96, 96] and desc["nbytes"] == 96 * 96 * 4
    arr = pserve.fetch_artifact(server, desc["stream_path"])
    assert arr.shape == (96, 96) and arr.dtype == np.float32 and arr.max() > 0
    assert "data_b64" not in _get(server, f"/jobs/{jid}")[1]["image"]
    status, err = _get(server, "/jobs/job-999999-0/artifact/image")
    assert status == 404 and "error" in err
    status, err = _get(server, f"/jobs/{jid}/artifact/nope")
    assert status == 404 and "error" in err


def test_artifact_eviction_returns_410(server, monkeypatch):
    monkeypatch.setattr(pserve, "_INLINE_ARRAY_LIMIT", 1024)
    monkeypatch.setattr(pserve.JobRunner, "MAX_ARTIFACT_BYTES", 1)
    final, _ = _poll_job(server, _post(server, "/jobs",
                                       _job_body("tiled"))[1]["job_id"])
    assert final["status"] == "done", final
    status, err = _get(server, final["image"]["stream_path"])
    assert status == 410 and "evicted" in err["error"]


def test_job_stochastic_full_chip(server):
    body = _job_body("stochastic", trials=6, dose_photons=0.2, diffusion=25.0,
                     threshold=0.35, noise="gaussian", seed=3)
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert final["trials"] == 6 and final["big_n"] == 96
    assert final["ler_nm"] >= 0 and "break_rate" in final
    band = _decode_array(final["print_probability"])
    assert band.shape == (96, 96) and 0.0 <= band.min() <= band.max() <= 1.0


def test_job_lele_decomposition(server):
    big_n = 96
    mask = np.zeros((big_n, big_n), np.float32)
    for x in range(8, big_n - 8, 6):
        mask[8:-8, x:x + 3] = 1.0
    body = {"kind": "lele", "mask": _encode_array(mask), "pixel_number": 48,
            "rank": 16, "halo": 8, "min_pitch_nm": 200.0,
            "source": {"kind": "classical", "sigma_out": 0.3}}
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert final["violations"] == 0 and final["features"] > 4
    a, b = _decode_array(final["mask_a"]), _decode_array(final["mask_b"])
    assert not ((a > 0.5) & (b > 0.5)).any()
    np.testing.assert_array_equal(np.maximum(a, b) > 0.5, mask > 0.5)
    assert _decode_array(final["profile"]).shape == (big_n, big_n)


def test_jobs_listing(server):
    jid = _post(server, "/jobs", _job_body("tiled"))[1]["job_id"]
    status, listing = _get(server, "/jobs")
    assert status == 200 and listing["count"] >= 1
    mine = [j for j in listing["jobs"] if j["job_id"] == jid]
    assert mine and mine[0]["kind"] == "tiled"
    assert {"status", "progress", "age_s"} <= set(mine[0])
    _poll_job(server, jid)


def test_job_tiled_m3d_model(server):
    thin, _ = _poll_job(server, _post(server, "/jobs",
                                      _job_body("tiled"))[1]["job_id"])
    thick, _ = _poll_job(server, _post(server, "/jobs",
                                       _job_body("tiled", m3d=M3D))[1]["job_id"])
    assert thin["status"] == thick["status"] == "done", thick
    a, b = _decode_array(thin["image"]), _decode_array(thick["image"])
    assert np.isfinite(b).all() and b.max() > 0
    assert np.linalg.norm(a - b) / np.linalg.norm(a) > 1e-2


def test_job_film_end_to_end(server):
    body = _job_body("film", nz=3, stack={"n_resist": [1.71, 0.02],
                                         "thickness_nm": 120.0,
                                         "under_layers": [[37.0, "barc"]],
                                         "n_substrate": "si"})
    final, progress = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert final["depths_nm"] == [20.0, 60.0, 100.0]
    exposure = _decode_array(final["exposure"])
    assert exposure.shape == (3, 96, 96) and exposure.max() > 0
    means = exposure.mean(axis=(1, 2))
    assert means.std() / means.mean() > 0.05
    assert all(b >= a for a, b in zip(progress, progress[1:]))


def test_job_film_explicit_depths_and_artifact(server, monkeypatch):
    monkeypatch.setattr(pserve, "_INLINE_ARRAY_LIMIT", 1024)
    body = _job_body("film", depths_nm=[5.0, 95.0], stack={"thickness_nm": 100.0})
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    assert final["depths_nm"] == [5.0, 95.0]
    desc = final["exposure"]
    assert desc["artifact"] == "exposure" and desc["shape"] == [2, 96, 96]
    arr = pserve.fetch_artifact(server, desc["stream_path"])
    assert arr.shape == (2, 96, 96) and arr.max() > 0


def test_job_film_volumetric_stochastic(server):
    body = _job_body("film", nz=3, stack={"n_resist": [1.71, 0.02],
                                         "thickness_nm": 120.0,
                                         "n_substrate": "si"},
                     stochastic_trials=6, dose_photons=40.0)
    final, _ = _poll_job(server, _post(server, "/jobs", body)[1]["job_id"])
    assert final["status"] == "done", final
    sto = final["stochastic"]
    assert sto["trials"] == 6 and len(sto["slabs"]) == 3
    assert [s["depth_nm"] for s in sto["slabs"]] == [0.0, 40.0, 80.0]
    for s in sto["slabs"]:
        assert set(s) >= {"ler_nm", "lwr_nm", "mean_cd_nm", "break_rate",
                          "bridge_rate"}


@pytest.mark.parametrize("bad", [{"stack": {"n_resist": "unobtanium"}},
                                 {"stack": {"resist_index": 1.7}},
                                 {"nz": 0}, {"depths_nm": []},
                                 {"stochastic_trials": 10_000}])
def test_job_film_validation(server, bad):
    status, payload = _post(server, "/jobs", _job_body("film", **{"nz": 2, **bad}))
    assert status == 200
    final, _ = _poll_job(server, payload["job_id"])
    assert final["status"] == "error", (bad, final)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


def test_router_health_lists_backends(fleet):
    url, _ = fleet
    payload = _get(url, "/health")[1]
    assert payload["role"] == "router" and len(payload["backends"]) == 2
    assert all(b["ok"] and b["health"]["platform"] == "cpu"
               for b in payload["backends"])
    assert payload["max_inflight"] >= 1 and "queued_requests" in payload


def test_router_affinity_and_matches(fleet):
    url, servers = fleet
    mask = _demo_mask()
    before = [srv.service.requests_served for srv in servers]
    for _ in range(4):
        status, payload = _post(url, "/simulate", _simulate_body(mask))
        assert status == 200
    np.testing.assert_array_equal(_decode_array(payload["image"]), _local(mask))
    served = [srv.service.requests_served - b for srv, b in zip(servers, before)]
    assert sorted(served) == [0, 4]


def test_router_spreads_distinct_signatures(fleet):
    url, servers = fleet
    before = [srv.service.requests_served for srv in servers]
    for px in (20.0, 22.0, 24.0, 26.0, 28.0, 30.0):
        status, _ = _post(url, "/simulate",
                          _simulate_body(_demo_mask(), pixel_size=px))
        assert status == 200
    served = [srv.service.requests_served - b for srv, b in zip(servers, before)]
    assert min(served) >= 1


def test_router_failover_skips_dead_backend():
    live = make_server("127.0.0.1", 0, device="cpu")
    live_url = _start(live)
    router = make_router(["http://127.0.0.1:9", live_url], "127.0.0.1", 0)
    url = _start(router)
    try:
        for _ in range(2):  # round-robin starts at each backend once
            status, _ = _post(url, "/simulate", _simulate_body(_demo_mask()))
            assert status == 200
        health = _get(url, "/health")[1]
        assert [b["ok"] for b in health["backends"]] == [False, True]
    finally:
        router.shutdown()
        live.shutdown()


def test_router_pins_job_polls(fleet):
    url, _ = fleet
    status, payload = _post(url, "/jobs", _job_body("tiled"))
    assert status == 200
    final, _ = _poll_job(url, payload["job_id"])
    assert final["status"] == "done", final
    assert _decode_array(final["image"]).shape == (96, 96)
    assert _get(url, "/jobs/unknown-id")[0] == 404


def test_router_relays_artifact_stream(fleet, monkeypatch):
    monkeypatch.setattr(pserve, "_INLINE_ARRAY_LIMIT", 1024)
    url, servers = fleet
    jid = _post(url, "/jobs", _job_body("tiled"))[1]["job_id"]
    final, _ = _poll_job(url, jid)
    desc = final["image"]
    assert desc.get("artifact") == "image"
    arr = pserve.fetch_artifact(url, desc["stream_path"])
    owner = [srv for srv in servers if srv.service._jobs is not None
             and jid in srv.service._jobs._jobs][0]
    np.testing.assert_array_equal(arr, owner.service._jobs._jobs[jid]
                                  .artifacts["image"])
    status, err = _get(url, "/jobs/zzz/artifact/image")
    assert status == 404 and "error" in err


def test_router_aggregates_jobs_listing(fleet):
    url, _ = fleet
    jid = _post(url, "/jobs", _job_body("tiled", big_n=64))[1]["job_id"]
    status, listing = _get(url, "/jobs")
    assert status == 200
    assert any(j["job_id"] == jid and "backend" in j for j in listing["jobs"])
    _poll_job(url, jid)
