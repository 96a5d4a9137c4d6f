"""HTTP serving for the imaging pipeline: a batching worker and a router.

Port of ``lithographysimulator_tpu/serve.py``, with the same endpoints,
request bodies, limits and wire format (a client of one server can talk to
the other):

* ``LithoService`` + :func:`make_server`: a worker that owns one device
  (``device="cuda"`` unless the caller asks for the CPU). Requests are
  parsed on handler threads (``ThreadingHTTPServer``), then batched across
  clients: concurrent ``/simulate`` requests with the same optical
  signature (config + source + solver + aberrations + options) ride one
  :func:`.simulate.simulate_batch`, so the pupil, source and SOCS work is
  paid once per batch. One worker thread runs the batches.
* ``Router`` + :func:`make_router`: a stdlib fan-out over N workers with
  signature affinity, admission queues and failover to the next worker on
  connection errors before any response byte arrived.

Endpoints (JSON bodies; arrays as nested lists or base64 float32):

* ``POST /simulate``: config fields + ``mask`` (n x n), ``source`` spec
  (kind/sigmas/poles/rotation/shift), optional ``aberrations``, ``solver``,
  ``normalize``, ``polarization``, ``chromatic``, perturbation fields and
  ``m3d`` (the m3dcal JSON object). Returns the aerial image (base64
  float32) and the run report.
* ``POST /jobs``: a long-running full-chip job, ``{"kind": "tiled" | "fem"
  | "opc" | "stochastic" | "lele" | "film", ...}`` -> ``{"job_id": ...}``.
  Jobs run one at a time on their own thread with live progress, and
  ``/simulate`` traffic keeps flowing meanwhile: both threads launch onto
  the device's default stream, which orders their work.
* ``GET /jobs``: summaries of the tracked jobs; ``GET /jobs/<id>``: status,
  progress and, when done, the result. A result is read back from the
  device once, at the end of its job; arrays over 4 MB become artifact
  descriptors, streamed as chunked raw float32 by ``GET
  /jobs/<id>/artifact/<name>`` (:func:`fetch_artifact`).
* ``POST /jobs/<id>/cancel``: drops a queued job, stops a running one at
  its next progress tick.
* ``GET /health``: the device, uptime, the batching counters
  (``requests_served``, ``batches_run``, ``batched_requests``), the SOCS
  kernel cache held for the signatures served (``socs_cache_entries``,
  ``socs_cache_bytes``; ROADMAP.md D12: the JAX worker's ``live_programs``
  and ``jit_cache_clears`` count XLA programs, which the port does not
  compile), the cache's look-ups since the process started
  (``socs_cache_hits``, ``socs_cache_misses``, ``socs_cache_evictions``,
  ``socs_cache_key_reuses``, ``socs_cache_bound_from_entry``) and the int8
  kernels' launches by kernel (``int8_launches``).

While a profiler trace records (:mod:`.utils.profiling`), a worker's POST
carries a request id, issued as its body arrives, on its spans:
``litho.serve.read`` (the body off the socket), ``litho.serve.decode``
(JSON, then the body's checks and base64), ``litho.serve.queue`` (from the
enqueue to the batch worker's take, the coalescing window included) and
``litho.serve.encode`` (the image's base64, then the reply's JSON and its
write). The worker marks each batch (``litho.serve.batch``, with its
``size`` and its ``requests``' ids) and, within it, the coalescing wait
(``.window``) and the run (``.run``: ``simulate_batch`` and the read-back).

Start a worker on the card: ``python -m lithographysimulator_tpu_torch.serve
--port 8100`` (``--device cuda:1`` for another card). Start a router:
``python -m lithographysimulator_tpu_torch.serve --router --backends
http://127.0.0.1:8100 http://127.0.0.1:8101 --port 8000``.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import functools
import json
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ._spans import (Counters, current_request, end_span, request_scope, span,
                     stamp)


def _complex_index(value) -> complex:
    """A refractive index from the wire: a MATERIALS_193 name, an
    [re, im] pair, or a bare real number. Dict/str payloads never touch
    the filesystem (see the 'm3d' guard)."""
    from .ops.filmstack import MATERIALS_193

    if isinstance(value, str):
        try:
            return MATERIALS_193[value]
        except KeyError:
            raise ValueError(
                f"unknown material {value!r} (expected one of "
                f"{sorted(MATERIALS_193)} or an [re, im] pair)") from None
    if isinstance(value, (list, tuple)):
        if len(value) != 2:
            raise ValueError(f"index pair must be [re, im], got {value!r}")
        return complex(float(value[0]), float(value[1]))
    return complex(float(value), 0.0)


def _parse_wafer_stack(spec: dict):
    """A :class:`.ops.filmstack.WaferStack` from the film job's ``stack``
    body field (all-default spec = bare resist on silicon)."""
    from .ops.filmstack import WaferStack

    if not isinstance(spec, dict):
        raise ValueError("'stack' must be a JSON object")
    known = {"n_resist", "thickness_nm", "under_layers", "n_substrate"}
    unknown = set(spec) - known
    if unknown:
        raise ValueError(f"unknown stack fields {sorted(unknown)}")
    kwargs = {}
    if "n_resist" in spec:
        kwargs["n_resist"] = _complex_index(spec["n_resist"])
    if "thickness_nm" in spec:
        kwargs["thickness_nm"] = float(spec["thickness_nm"])
    if "n_substrate" in spec:
        kwargs["n_substrate"] = _complex_index(spec["n_substrate"])
    layers = spec.get("under_layers") or ()
    kwargs["under_layers"] = tuple(
        (float(d), _complex_index(n)) for d, n in layers)
    return WaferStack(**kwargs)


@functools.lru_cache(maxsize=64)
def _source_from_sig(config, source_sig) -> np.ndarray:
    """The host source map of a request's source signature."""
    from .models.source import LightSource

    kind, s_in, s_out, sx, sy, poles, rotation = source_sig
    ls = LightSource(config, sigma_in=s_in, sigma_out=s_out,
                     shift_x=sx, shift_y=sy)
    if kind == "annular":
        return ls.annular()
    if kind == "classical":
        return ls.classical()
    if kind == "quasar":
        return ls.quasar(poles, rotation)
    if kind == "dipole":
        return ls.dipole(rotation)
    return ls.monopole()


def _source_sig(src_spec: dict) -> tuple:
    return (
        src_spec.get("kind", "classical"),
        float(src_spec.get("sigma_in", 0.0)),
        float(src_spec.get("sigma_out", 0.6)),
        float(src_spec.get("shift_x", 0.0)),
        float(src_spec.get("shift_y", 0.0)),
        int(src_spec.get("poles", 4)),
        float(src_spec.get("rotation", -np.pi / 8)),
    )


def _parse_config(body: dict, pixel_number: int):
    from .config import OpticsConfig

    return OpticsConfig(
        pixel_number=pixel_number,
        pixel_size=float(body.get("pixel_size", 25.0)),
        wavelength=float(body.get("wavelength", 193.0)),
        na=float(body.get("na", 0.7)),
        immersion_index=float(body.get("immersion_index", 1.0)),
        channel_tol=float(body.get("channel_tol", 1e-6)),
        obscuration=float(body.get("obscuration", 0.0)),
    )


def _parse_m3d(body: dict):
    """The calibrated thick-mask model of a body's ``m3d`` (the m3dcal JSON
    object), or None. Dict payloads only: ``model_from_json`` also accepts
    file paths (a CLI convenience), which over HTTP would let a client make
    the server read arbitrary local files."""
    if body.get("m3d") is None:
        return None
    from .ops.mask3d import model_from_json

    if not isinstance(body["m3d"], dict):
        raise ValueError(
            "'m3d' must be the m3dcal JSON object (a dict); "
            "string/path payloads are not accepted over the API")
    return model_from_json(body["m3d"])


def _encode_array(arr) -> dict:
    arr = np.ascontiguousarray(np.asarray(arr, np.float32))
    return {
        "shape": list(arr.shape),
        "dtype": "float32",
        "data_b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def _decode_array(obj) -> np.ndarray:
    if isinstance(obj, dict) and "data_b64" in obj:
        raw = base64.b64decode(obj["data_b64"])
        return np.frombuffer(raw, dtype=obj.get("dtype", "float32")).reshape(
            obj["shape"]).copy()
    return np.asarray(obj, np.float32)


# Result arrays at or below this size are inlined into the job-status JSON
# as base64; larger ones become streamable artifacts (raw float32 over
# ``GET /jobs/<id>/artifact/<name>``, written in chunks: no base64 copy, no
# multi-hundred-MB JSON string, and status polls of a done job stay light).
_INLINE_ARRAY_LIMIT = 4 * 1024 * 1024
_STREAM_CHUNK = 8 * 1024 * 1024


def fetch_artifact(base_url: str, stream_path: str, *,
                   timeout: float = 300.0) -> np.ndarray:
    """Client helper: stream a job-result artifact back as an ndarray.

    ``stream_path`` is the ``stream_path`` field of an artifact descriptor in
    a done job's status payload (``/jobs/<id>/artifact/<name>``); shape and
    dtype ride the X-Shape / X-Dtype response headers."""
    with urllib.request.urlopen(base_url.rstrip("/") + stream_path,
                                timeout=timeout) as resp:
        shape = tuple(int(s) for s in resp.headers["X-Shape"].split(",") if s)
        dtype = resp.headers.get("X-Dtype", "float32")
        chunks = []
        while True:
            chunk = resp.read(_STREAM_CHUNK)
            if not chunk:
                break
            chunks.append(chunk)
    return np.frombuffer(b"".join(chunks), dtype=dtype).reshape(shape).copy()


class _Pending:
    """One enqueued /simulate request: its optical signature, mask, and the
    slot its result (or error) lands in; its request id and handler thread,
    and the start of its wait in the queue (:func:`._spans.stamp`), for the
    ``litho.serve.queue`` span that the batch worker ends."""

    __slots__ = ("signature", "mask", "event", "image", "error", "request",
                 "thread", "queued_ns")

    def __init__(self, signature, mask):
        self.signature = signature
        self.mask = mask
        self.event = threading.Event()
        self.image = None
        self.error: Exception | None = None
        self.request = current_request()
        self.thread = threading.get_ident()
        self.queued_ns = None


class JobCancelled(Exception):
    """Raised inside a job's progress callback when it has been cancelled."""


class _Job:
    """One submitted full-chip job and its live state."""

    __slots__ = ("id", "kind", "body", "status", "progress", "result",
                 "error", "created", "cancelled", "artifacts")

    def __init__(self, job_id: str, kind: str, body: dict):
        self.id = job_id
        self.kind = kind
        self.body = body
        self.status = "queued"
        self.progress = 0.0
        self.result: dict | None = None
        self.error: str | None = None
        self.created = time.time()
        self.cancelled = False
        # name -> float32 ndarray for results too large to inline as base64;
        # served raw+chunked via GET /jobs/<id>/artifact/<name>
        self.artifacts: dict[str, np.ndarray] = {}


class JobRunner:
    """Sequential executor for long-running full-chip jobs on ``device``.
    One worker thread drains a FIFO queue; each job updates its
    ``progress`` through the library progress callbacks, so ``GET
    /jobs/<id>`` polls are live. Jobs do not hold the service's lock:
    their launches and the batch worker's interleave on the device's
    default stream."""

    MAX_BIG_N = 8192
    MAX_JOBS_KEPT = 64
    # total bytes of streamable artifacts held across DONE jobs; beyond
    # this, the oldest done jobs' artifacts are dropped (their stream paths
    # then return 410 Gone): results must be fetched promptly
    MAX_ARTIFACT_BYTES = 2 << 30

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._jobs: dict[str, _Job] = {}
        self._queue: list[str] = []
        self._cv = threading.Condition()
        self._seq = 0
        self._worker = threading.Thread(target=self._drain_forever,
                                        daemon=True, name="litho-job-worker")
        self._worker.start()

    # -- public API ----------------------------------------------------------

    def submit(self, body: dict) -> dict:
        kind = body.get("kind")
        if kind not in ("tiled", "fem", "opc", "stochastic", "lele", "film"):
            raise ValueError(f"unknown job kind {kind!r} "
                             "(expected tiled/fem/opc/stochastic/lele/film)")
        # validate the mask early so submission errors are synchronous 400s
        mask = _decode_array(body["mask"])
        if mask.ndim != 2 or mask.shape[0] != mask.shape[1]:
            raise ValueError(f"mask must be square 2-D, got {mask.shape}")
        if mask.shape[0] > self.MAX_BIG_N:
            raise ValueError(
                f"mask size {mask.shape[0]} exceeds {self.MAX_BIG_N}")
        with self._cv:
            self._seq += 1
            job_id = f"job-{self._seq:06d}-{int(time.time()) % 100000}"
            job = _Job(job_id, kind, dict(body, mask=mask))
            if len(self._jobs) >= self.MAX_JOBS_KEPT:
                # evict oldest FINISHED job; refuse if everything is live
                for jid in list(self._jobs):
                    if self._jobs[jid].status in ("done", "error"):
                        del self._jobs[jid]
                        break
                else:
                    raise ValueError("job store full (all jobs still live)")
            self._jobs[job_id] = job
            self._queue.append(job_id)
            self._cv.notify_all()
        return {"job_id": job_id, "status": "queued"}

    def status(self, job_id: str) -> tuple[int, dict]:
        job = self._jobs.get(job_id)
        if job is None:
            return 404, {"error": f"unknown job {job_id!r}"}
        out = {"job_id": job.id, "kind": job.kind, "status": job.status,
               "progress": round(job.progress, 4),
               "age_s": round(time.time() - job.created, 1)}
        if job.status == "done" and job.result is not None:
            out.update(job.result)
        if job.status == "error":
            out["error"] = job.error
        return 200, out

    def list_jobs(self) -> dict:
        """Summaries of every tracked job, oldest first (no results: poll
        the individual job for those)."""
        with self._cv:
            jobs = [{"job_id": j.id, "kind": j.kind, "status": j.status,
                     "progress": round(j.progress, 4),
                     "age_s": round(time.time() - j.created, 1)}
                    for j in self._jobs.values()]
        return {"jobs": jobs, "count": len(jobs),
                "queued": len(self._queue)}

    def artifact(self, job_id: str, name: str):
        """(status, ndarray-or-error-dict) for a done job's named artifact."""
        job = self._jobs.get(job_id)
        if job is None:
            return 404, {"error": f"unknown job {job_id!r}"}
        if job.status != "done":
            return 409, {"error": f"job {job_id} is {job.status}, not done"}
        arr = job.artifacts.get(name)
        if arr is None:
            desc = (job.result or {}).get(name)
            if isinstance(desc, dict) and desc.get("artifact"):
                return 410, {"error": f"artifact {name!r} of {job_id} was "
                                      "evicted (fetch results promptly)"}
            return 404, {"error": f"no artifact {name!r} on job {job_id}"}
        return 200, arr

    def cancel(self, job_id: str) -> tuple[int, dict]:
        """Cancel a queued or running job. A queued job is dropped from the
        queue immediately; a running one stops at its next progress tick
        (between groups of tiles or focal planes)."""
        with self._cv:
            job = self._jobs.get(job_id)
            if job is None:
                return 404, {"error": f"unknown job {job_id!r}"}
            if job.status in ("done", "error", "cancelled"):
                return 200, {"job_id": job_id, "status": job.status}
            job.cancelled = True
            if job_id in self._queue:  # still queued: finish it here
                self._queue.remove(job_id)
                job.status = "cancelled"
        return 200, {"job_id": job_id, "status": "cancelling"
                     if job.status == "running" else job.status}

    # -- execution -----------------------------------------------------------

    def _drain_forever(self):
        while True:
            with self._cv:
                self._cv.wait_for(lambda: bool(self._queue))
                job = self._jobs[self._queue.pop(0)]
            if job.cancelled:
                job.status = "cancelled"
                continue
            job.status = "running"
            try:
                job.result = self._finalize_result(job, self._run(job))
                job.progress = 1.0
                job.status = "done"
            except JobCancelled:
                job.status = "cancelled"
            except Exception as exc:  # noqa: BLE001 - surfaced via status
                job.error = f"{type(exc).__name__}: {exc}"
                job.status = "error"
            self._evict_artifacts()

    def _finalize_result(self, job: _Job, raw: dict) -> dict:
        """Split a job's raw result: small arrays inline as base64, large
        ones become streamable artifacts referenced by descriptor (an
        8192^2 float32 image is 256 MB raw, which as inline base64 would
        balloon every status poll of the done job). Device tensors are read
        back here, once, at the end of the job."""
        out = {}
        for k, v in raw.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if not (isinstance(v, np.ndarray) and v.ndim > 0):
                out[k] = v
                continue
            v = np.ascontiguousarray(v, np.float32)
            if v.nbytes <= _INLINE_ARRAY_LIMIT:
                out[k] = _encode_array(v)
            else:
                job.artifacts[k] = v
                out[k] = {"artifact": k, "shape": list(v.shape),
                          "dtype": "float32", "nbytes": int(v.nbytes),
                          "stream_path": f"/jobs/{job.id}/artifact/{k}"}
        return out

    def _evict_artifacts(self):
        """Keep total artifact bytes across done jobs under the cap,
        dropping the OLDEST done jobs' artifacts first."""
        with self._cv:
            done = [j for j in self._jobs.values()
                    if j.status == "done" and j.artifacts]
            total = sum(a.nbytes for j in done
                        for a in j.artifacts.values())
            for job in sorted(done, key=lambda j: j.created):
                if total <= self.MAX_ARTIFACT_BYTES:
                    break
                total -= sum(a.nbytes for a in job.artifacts.values())
                job.artifacts = {}

    @staticmethod
    def _parse_common(body: dict):
        from .ops.vector import polarization_states

        config = _parse_config(body, int(body.get("pixel_number", 256)))
        source = _source_from_sig(config, _source_sig(body.get("source", {})))
        polarization = LithoService._parse_polarization(
            body.get("polarization", "scalar"))
        if polarization is not None:
            polarization_states(polarization)  # validate spec
        rank = int(body.get("rank", 64))
        halo = body.get("halo")
        halo = int(halo) if halo is not None else None
        chromatic = LithoService._parse_chromatic(body.get("chromatic"))
        return config, source, polarization, rank, halo, chromatic

    def _run(self, job: _Job) -> dict:
        body = job.body
        device = self.device
        (config, source, polarization, rank, halo,
         chromatic) = self._parse_common(body)
        mask = np.asarray(body["mask"], np.float32)
        mask3d = _parse_m3d(body)
        aberrations = np.asarray(body.get("aberrations") or [0.0], np.float32)

        def progress(f):
            if job.cancelled:
                raise JobCancelled(job.id)
            job.progress = float(f)

        if job.kind == "tiled":
            from .ops.tiled import tiled_socs_image
            from .simulate import _socs_kernels_cached

            # the kernel-set cache /simulate uses: a repeated setup skips
            # the build, and its kernels are the ones a local call gets
            socs = _socs_kernels_cached(
                config, source, aberrations, rank, device=device,
                polarization=polarization,
                apodize=bool(body.get("apodize", True)),
                chromatic=chromatic)[0]
            image = tiled_socs_image(
                mask, socs, config, halo=halo,
                tiles_per_dispatch=int(body.get("tiles_per_dispatch", 8)),
                mask3d=mask3d, progress_cb=progress)
            return {"image": image,
                    "big_n": int(mask.shape[0]), "rank": int(socs.rank)}
        if job.kind == "fem":
            from .metrology import tiled_fem
            from .models.resist import ResistModel

            result = tiled_fem(
                mask, config, source,
                defocus_nm=[float(d) for d in
                            body.get("defocus_nm", [-60.0, 0.0, 60.0])],
                doses=[float(d) for d in body.get("doses", [0.9, 1.0, 1.1])],
                target_cd_nm=body.get("target_cd_nm"),
                resist=ResistModel(
                    threshold=float(body.get("threshold", 0.3))),
                tolerance=float(body.get("tolerance", 0.10)),
                rank=rank, halo=halo, polarization=polarization,
                chromatic=chromatic,
                hotspot_nils=(float(body["hotspot_nils"])
                              if body.get("hotspot_nils") is not None
                              else None),
                pv_bands=bool(body.get("pv_bands", False)),
                mask3d=mask3d, progress_cb=progress, device=device)
            cdu = dict(result["cdu"] or {})
            cd_map = cdu.pop("cd_map_nm", None)
            out = {
                "cd_nm": np.asarray(result["cd_nm"]).tolist(),
                "defocus_nm": np.asarray(result["defocus_nm"]).tolist(),
                "doses": np.asarray(result["doses"]).tolist(),
                "target_cd_nm": result["target_cd_nm"],
                "depth_of_focus_nm": result["depth_of_focus_nm"],
                "exposure_latitude": result["exposure_latitude"],
                "in_spec_fraction": result["in_spec_fraction"],
                "cdu": cdu,
            }
            if result.get("nils") is not None:
                out["nils"] = result["nils"]
            if result.get("hotspots") is not None:
                spots = dict(result["hotspots"])
                spots["locations"] = spots["locations"][:10]
                out["hotspots"] = spots
            if cd_map is not None:
                out["cd_map_nm"] = np.nan_to_num(cd_map)
            if result.get("epe") is not None:
                out["epe"] = {k: v for k, v in result["epe"].items()
                              if not k.startswith("epe_")}
            if result.get("pv") is not None:
                pv = dict(result["pv"])
                for key in ("outer", "inner", "band"):
                    out[f"pv_{key}"] = pv.pop(key)  # arrays: inline/artifact
                out["pv"] = pv
            return out
        if job.kind == "lele":
            from .models.multipatterning import multipatterning_print
            from .models.resist import ResistModel

            n_masks = int(body.get("masks", 2))
            overlay = body.get("overlay_nm")
            if overlay is not None:
                overlay = [(float(p[0]), float(p[1])) for p in overlay]
            result = multipatterning_print(
                mask, config, source,
                min_pitch_nm=float(body.get("min_pitch_nm", 200.0)),
                masks=n_masks, overlay_nm=overlay,
                resist=ResistModel(
                    threshold=float(body.get("threshold", 0.35))),
                rank=rank, halo=halo, polarization=polarization,
                chromatic=chromatic, progress_cb=progress, device=device)
            out = {
                "masks": n_masks,
                "features": result["features"],
                "conflict_edges": result["conflict_edges"],
                "violations": result["violations"],
                "profile": result["profile"],
                "profile_single": result["profile_single"],
                "big_n": int(mask.shape[0]),
            }
            # mask_a / mask_b for the LELE (2-mask) case; further masks
            # continue the alphabet (mask_c, ...)
            for i, m in enumerate(result["masks"]):
                out[f"mask_{chr(ord('a') + i)}"] = m
            return out
        if job.kind == "film":
            return self._run_film(job, body, config, source, polarization,
                                  rank, halo, mask, mask3d, aberrations,
                                  progress)
        if job.kind == "stochastic":
            from .metrology import tiled_stochastic
            from .models.stochastic import StochasticResist

            return tiled_stochastic(
                mask, config, source,
                model=StochasticResist(
                    dose_photons_per_nm2=float(
                        body.get("dose_photons", 20.0)),
                    quantum_efficiency=float(
                        body.get("quantum_efficiency", 1.0)),
                    pag_per_nm2=float(body.get("pag", 0.0)),
                    diffusion_nm=float(body.get("diffusion", 5.0)),
                    threshold=float(body.get("threshold", 0.3)),
                    noise=str(body.get("noise", "poisson"))),
                trials=int(body.get("trials", 32)),
                seed=int(body.get("seed", 0)),
                psd=bool(body.get("psd", False)),
                rank=rank, halo=halo, polarization=polarization,
                chromatic=chromatic, mask3d=mask3d, progress_cb=progress,
                device=device)

        # job.kind == "opc"
        from .optimize import opc_correct_tiled

        corrected = opc_correct_tiled(
            mask, config, source, halo=halo, rank=rank,
            steps=int(body.get("steps", 40)),
            sweeps=int(body.get("sweeps", 1)),
            learning_rate=float(body.get("lr", 0.15)),
            polarization=polarization, chromatic=chromatic,
            mask3d=mask3d, progress_cb=progress, device=device)
        return {"mask": corrected, "big_n": int(mask.shape[0])}

    def _run_film(self, job, body, config, source, polarization, rank, halo,
                  mask, mask3d, aberrations, progress) -> dict:
        """The ``film`` kind: the (nz, M, M) in-film exposure on per-slab
        SOCS kernels, and with ``stochastic_trials`` the volumetric
        stochastic resist on it (z-resolved LER and defects)."""
        from .ops.tiled import tiled_film_stack
        from .simulate import film_socs_kernels

        stack = _parse_wafer_stack(body.get("stack") or {})
        depths = body.get("depths_nm")
        if depths is None:
            nz = int(body.get("nz", 4))
            if not 1 <= nz <= 64:
                raise ValueError(f"nz must be in [1, 64], got {nz}")
            dz = stack.thickness_nm / nz
            depths = ((np.arange(nz) + 0.5) * dz).tolist()
        depths = [float(z) for z in depths]
        if not depths or len(depths) > 64:
            raise ValueError("depths_nm must hold 1..64 depths")
        sto_trials = int(body.get("stochastic_trials", 0))
        if sto_trials and not 1 <= sto_trials <= 256:
            raise ValueError("stochastic_trials must be in [1, 256]")
        kernels = film_socs_kernels(
            source, aberrations, device=self.device, config=config,
            wafer_stack=stack, depths_nm=depths, polarization=polarization,
            apodize=bool(body.get("apodize", True)), rank=rank)
        progress(0.02)  # kernels built; the tile loop reports the rest
        tile_top = 1.0 if not sto_trials else 0.85
        exposure = tiled_film_stack(
            mask, kernels, config,
            source_total=float(np.asarray(source).sum()), halo=halo,
            tiles_per_dispatch=int(body.get("tiles_per_dispatch", 8)),
            mask3d=mask3d,
            progress_cb=lambda f: progress(0.02 + (tile_top - 0.02) * f))
        out = {"exposure": exposure, "depths_nm": depths,
               "big_n": int(mask.shape[0]), "rank": int(kernels[0].rank)}
        if sto_trials:
            from .models.stochastic import (StochasticResist,
                                            stochastic_volume_ensemble)

            model = StochasticResist(
                dose_photons_per_nm2=float(body.get("dose_photons", 20.0)),
                diffusion_nm=float(body.get("diffusion", 5.0)),
                threshold=float(body.get("threshold", 0.3)),
                noise=str(body.get("noise", "poisson")))
            big_cfg = dataclasses.replace(config,
                                          pixel_number=int(mask.shape[0]))
            dz = (depths[1] - depths[0]) if len(depths) > 1 else (
                stack.thickness_nm / len(depths))
            vol = stochastic_volume_ensemble(
                exposure, big_cfg, model, dz_nm=float(dz),
                trials=sto_trials, seed=int(body.get("seed", 0)))
            out["stochastic"] = {
                "trials": vol["trials"],
                "ler_top_nm": vol["ler_top_nm"],
                "ler_bottom_nm": vol["ler_bottom_nm"],
                "slabs": vol["slabs"],
            }
            progress(1.0)
        return out


class LithoService:
    """Request handling on ``device``, separated from the HTTP plumbing for
    testability.

    ``batching=True`` (default) routes /simulate through a single worker
    thread that coalesces same-signature requests arriving within
    ``batch_window_s`` into one :func:`.simulate.simulate_batch`.
    ``batching=False`` runs each request inline under the service lock
    (still thread-safe)."""

    # Request-body limits: a hostile or buggy pixel_number or socs_rank
    # would trigger multi-GB allocations and minutes-long builds, wedging
    # the server. Out-of-range values are rejected with 400.
    MAX_PIXEL_NUMBER = 2048
    MAX_SOCS_RANK = 1024
    MAX_CHUNK = 64
    # Batched requests wait on the worker with a generous bound: a hung
    # device must not pile up handler threads forever; expire to 503.
    BATCH_WAIT_TIMEOUT_S = 900.0

    def __init__(self, *, device="cuda", batching: bool = True,
                 batch_window_s: float = 0.005, max_batch: int = 8):
        self.device = torch.device(device)
        self.started = time.time()
        self._counts = Counters("serve", ("requests_served", "batches_run",
                                          "batched_requests"))
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.batching = batching
        self._lock = threading.Lock()  # one batch at a time
        self._cv = threading.Condition()
        self._queue: list[_Pending] = []
        self._jobs: JobRunner | None = None  # created on first /jobs use
        self._jobs_lock = threading.Lock()
        if batching:
            self._worker = threading.Thread(
                target=self._drain_forever, daemon=True,
                name="litho-batch-worker")
            self._worker.start()

    @property
    def requests_served(self) -> int:
        return self._counts.totals["requests_served"]

    @property
    def batches_run(self) -> int:
        return self._counts.totals["batches_run"]

    @property
    def batched_requests(self) -> int:
        return self._counts.totals["batched_requests"]

    # -- request parsing -----------------------------------------------------

    def _parse(self, body: dict):
        """Validate + canonicalize a /simulate body into (signature, mask).
        The signature is hashable and identifies everything EXCEPT the mask:
        requests sharing it can ride one batch."""
        pixel_number = int(body.get("pixel_number", 64))
        socs_rank = body.get("socs_rank", "auto")
        if socs_rank != "auto":
            socs_rank = int(socs_rank)
        chunk = int(body.get("chunk", 4))
        if not 8 <= pixel_number <= self.MAX_PIXEL_NUMBER:
            raise ValueError(
                f"pixel_number {pixel_number} out of range [8, {self.MAX_PIXEL_NUMBER}]")
        if socs_rank != "auto" and not 1 <= socs_rank <= self.MAX_SOCS_RANK:
            raise ValueError(
                f"socs_rank {socs_rank} out of range [1, {self.MAX_SOCS_RANK}]")
        if not 1 <= chunk <= self.MAX_CHUNK:
            raise ValueError(f"chunk {chunk} out of range [1, {self.MAX_CHUNK}]")
        solver = body.get("solver", "gau23")
        if solver not in ("gau23", "direct", "socs"):
            raise ValueError(f"unknown solver {solver!r}")
        polarization = self._parse_polarization(
            body.get("polarization", "scalar"))

        config = _parse_config(body, pixel_number)
        mask = _decode_array(body["mask"])
        if mask.shape != (config.n, config.n):
            raise ValueError(
                f"mask shape {mask.shape} != ({config.n}, {config.n})")

        source_sig = _source_sig(body.get("source", {}))
        if source_sig[0] not in ("annular", "classical", "quasar", "dipole",
                                 "monopole"):
            raise ValueError(f"unknown source kind {source_sig[0]!r}")
        aberr = tuple(float(a) for a in (body.get("aberrations") or ()))
        chromatic = self._parse_chromatic(body.get("chromatic"))
        perturb = self._parse_perturbation(body)
        # both thick-mask model kinds are frozen dataclasses, so they ride
        # the batching signature
        mask3d = _parse_m3d(body)
        signature = (config, source_sig, aberr, solver, chunk,
                     bool(body.get("normalize", False)), socs_rank,
                     polarization, chromatic, perturb, mask3d)
        return signature, mask

    @staticmethod
    def _parse_perturbation(body: dict):
        """Scanner non-ideality fields (msd_x_nm / msd_y_nm / flare_tis /
        flare_kernel_nm) -> ImagePerturbation, or None when all absent."""
        keys = ("msd_x_nm", "msd_y_nm", "flare_tis", "flare_kernel_nm")
        if not any(body.get(k) for k in keys):
            return None
        from .ops.perturb import ImagePerturbation

        return ImagePerturbation(**{k: float(body.get(k, 0.0))
                                    for k in keys})

    @staticmethod
    def _parse_polarization(spec):
        """'scalar'/None -> None; 'x'/'y'/'unpolarized' pass through; a
        2-element list is an explicit Jones vector, entries either numbers
        or [re, im] pairs (JSON has no complex type)."""
        if spec in (None, "scalar"):
            return None
        if spec in ("x", "y", "unpolarized"):
            return spec
        if isinstance(spec, (list, tuple)) and len(spec) == 2:
            def as_complex(v):
                if isinstance(v, (list, tuple)):
                    if len(v) != 2:
                        raise ValueError(
                            f"Jones component {v!r} is not [re, im]")
                    return complex(float(v[0]), float(v[1]))
                return complex(float(v))

            jones = (as_complex(spec[0]), as_complex(spec[1]))
            if abs(jones[0]) == 0 and abs(jones[1]) == 0:
                raise ValueError("zero Jones vector")
            return jones
        raise ValueError(f"unknown polarization {spec!r}")

    @staticmethod
    def _parse_chromatic(spec):
        """None -> monochromatic; a dict with ``bandwidth_pm`` (plus optional
        ``focus_nm_per_pm`` / ``samples`` / ``shape``) -> LaserSpectrum
        (hashable, so it rides the batching signature)."""
        if spec in (None, {}, "monochromatic"):
            return None
        if not isinstance(spec, dict) or "bandwidth_pm" not in spec:
            raise ValueError(
                f"chromatic must be a dict with 'bandwidth_pm', got {spec!r}")
        from .config import LaserSpectrum

        out = LaserSpectrum(
            bandwidth_pm=float(spec["bandwidth_pm"]),
            focus_nm_per_pm=float(spec.get("focus_nm_per_pm", -250.0)),
            samples=int(spec.get("samples", 7)),
            shape=str(spec.get("shape", "gaussian")))
        if out.samples > 33:
            raise ValueError(f"chromatic samples {out.samples} > 33")
        return None if out.bandwidth_pm == 0 else out

    # -- execution -----------------------------------------------------------

    def _run_batch(self, signature, masks: np.ndarray) -> np.ndarray:
        """(B, n, n) host masks -> (B, n, n) host images: one
        :func:`.simulate.simulate_batch` on the device (the source map and
        SOCS kernels made once), read back once."""
        from .simulate import simulate_batch

        (config, source_sig, aberr, solver, chunk, normalize, socs_rank,
         polarization, chromatic, perturb, mask3d) = signature
        images = simulate_batch(
            masks, config, _source_from_sig(config, source_sig),
            np.asarray(aberr, np.float32) if aberr else None,
            device=self.device, solver=solver, chunk=chunk,
            normalize=normalize, socs_rank=socs_rank,
            polarization=polarization, chromatic=chromatic, perturb=perturb,
            mask3d=mask3d)
        return images.cpu().numpy()

    def _drain_once(self, timeout: float | None = None) -> bool:
        """Pull one same-signature batch off the queue and execute it.
        Returns False if the queue stayed empty through ``timeout``."""
        with contextlib.ExitStack() as stack:
            with self._cv:
                if not self._queue and not self._cv.wait_for(
                        lambda: bool(self._queue), timeout=timeout):
                    return False
                batch_span = stack.enter_context(span("litho.serve.batch"))
                # Coalescing window: let same-signature stragglers arrive.
                with span("litho.serve.batch.window"):
                    if (self.batch_window_s > 0
                            and len(self._queue) < self.max_batch):
                        self._cv.wait(self.batch_window_s)
                signature = self._queue[0].signature
                batch = [p for p in self._queue if p.signature == signature]
                batch = batch[: self.max_batch]
                for p in batch:
                    self._queue.remove(p)
                    end_span("litho.serve.queue", p.queued_ns,
                             thread=p.thread, request=p.request)
            batch_span.set(size=len(batch),
                           requests=[p.request for p in batch])
            try:
                with span("litho.serve.batch.run"):
                    masks = np.stack([p.mask for p in batch])
                    with self._lock:
                        images = self._run_batch(signature, masks)
                self._counts.add("requests_served", len(batch))
                self._counts.add("batches_run")
                if len(batch) > 1:
                    self._counts.add("batched_requests", len(batch))
                for p, img in zip(batch, images):
                    p.image = img
            except Exception as exc:  # noqa: BLE001 - delivered to each waiter
                for p in batch:
                    p.error = exc
            finally:
                for p in batch:
                    p.event.set()
        return True

    def _drain_forever(self):
        while True:
            self._drain_once(timeout=None)

    # -- endpoints -----------------------------------------------------------

    def health(self) -> dict:
        from .ops.kernels.intensity_int8 import LAUNCHES
        from .simulate import socs_cache_counts, socs_cache_stats
        from .utils.profiling import device_info

        entries, nbytes = socs_cache_stats()
        cache = socs_cache_counts()
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self.started, 1),
            **self._counts.snapshot(),
            "batching": self.batching,
            "socs_cache_entries": entries,
            "socs_cache_bytes": nbytes,
            "socs_cache_hits": cache["hits"],
            "socs_cache_misses": cache["misses"],
            "socs_cache_evictions": cache["evictions"],
            "socs_cache_key_reuses": cache["key_reuses"],
            "socs_cache_bound_from_entry": cache["bound_from_entry"],
            "int8_launches": dict(LAUNCHES),
            **device_info(self.device),
        }

    def simulate(self, body: dict) -> dict:
        with span("litho.serve.decode"):
            signature, mask = self._parse(body)
        t0 = time.perf_counter()
        if self.batching:
            pending = _Pending(signature, mask)
            with self._cv:
                pending.queued_ns = stamp()
                self._queue.append(pending)
                self._cv.notify_all()
            if not pending.event.wait(timeout=self.BATCH_WAIT_TIMEOUT_S):
                with self._cv:  # still queued -> drop it; mid-batch -> leave
                    if pending in self._queue:
                        self._queue.remove(pending)
                raise TimeoutError(
                    f"batch worker did not respond within "
                    f"{self.BATCH_WAIT_TIMEOUT_S:.0f}s (hung device?)")
            if pending.error is not None:
                raise pending.error
            image = pending.image
        else:
            with self._lock:
                image = self._run_batch(signature, mask[None])[0]
            self._counts.add("requests_served")
        config, source_sig, _, solver, *_ = signature
        report = {
            "solver": solver,
            "pixel_number": config.n,
            "source_points": int((_source_from_sig(config, source_sig) > 0).sum()),
            "wall_clock_s": round(time.perf_counter() - t0, 4),
        }
        with span("litho.serve.encode"):
            return {"image": _encode_array(image), "report": report}

    def jobs(self) -> JobRunner:
        with self._jobs_lock:
            if self._jobs is None:
                self._jobs = JobRunner(self.device)
            return self._jobs

    def stream(self, path: str):
        """Streaming dispatch: ``GET /jobs/<id>/artifact/<name>`` returns
        ``(200, ndarray)``, which the HTTP layer writes as chunked raw
        float32 (Content-Length known, X-Shape/X-Dtype headers), never
        building a base64/JSON copy. ``None`` for any other path (falls
        through to the JSON dispatch)."""
        if not (path.startswith("/jobs/") and "/artifact/" in path):
            return None
        rest = path[len("/jobs/"):]
        job_id, _, name = rest.partition("/artifact/")
        return self.jobs().artifact(job_id, name)

    def dispatch(self, path: str, body: dict | None) -> tuple[int, dict]:
        try:
            if path == "/health":
                return 200, self.health()
            if path == "/simulate":
                return 200, self.simulate(body or {})
            if path == "/jobs":
                if body is not None:
                    return 200, self.jobs().submit(body)
                return 200, self.jobs().list_jobs()
            if path.startswith("/jobs/"):
                rest = path[len("/jobs/"):]
                if rest.endswith("/cancel") and body is not None:
                    return self.jobs().cancel(rest[: -len("/cancel")])
                return self.jobs().status(rest)
            return 404, {"error": f"unknown endpoint {path}"}
        except TimeoutError as exc:
            return 503, {"error": f"{type(exc).__name__}: {exc}"}
        except (KeyError, ValueError, TypeError) as exc:
            return 400, {"error": f"{type(exc).__name__}: {exc}"}
        except Exception as exc:  # noqa: BLE001 - surface as 500
            return 500, {"error": f"{type(exc).__name__}: {exc}"}


class Router:
    """Fan-out over backend workers with failover: a backend that refuses
    connections is skipped (and retried on later requests: no permanent
    ejection, workers restart in place).

    Routing is SIGNATURE-AFFINE by default: requests whose optical signature
    (config + source + solver fields) matches are sent to the same worker,
    so they coalesce into that worker's batches and share its SOCS kernel
    cache; distinct signatures spread across workers. Requests without a
    parseable signature fall back to round-robin."""

    def __init__(self, backends: list[str], *, timeout_s: float = 300.0,
                 affinity: bool = True, max_inflight: int = 8,
                 queue_wait_s: float = 120.0):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.backends = [b.rstrip("/") for b in backends]
        self.timeout_s = timeout_s
        self.affinity = affinity
        self.forwarded = [0] * len(self.backends)
        self.queued = 0  # requests that waited for an admission slot
        self._next = 0
        self._lock = threading.Lock()
        # Router-side queue: at most max_inflight requests in flight per
        # backend; excess handler threads WAIT on the semaphore (bounded by
        # queue_wait_s) instead of piling onto a busy worker.
        self.max_inflight = max_inflight
        self.queue_wait_s = queue_wait_s
        self._slots = [threading.BoundedSemaphore(max_inflight)
                       for _ in self.backends]
        # job id -> backend index: /jobs/<id> polls MUST land on the worker
        # that owns the job (job state is process-local)
        self._job_backend: dict[str, int] = {}

    _SIGNATURE_FIELDS = ("pixel_number", "pixel_size", "wavelength", "na",
                         "immersion_index", "channel_tol", "obscuration",
                         "solver", "chunk", "normalize",
                         "msd_x_nm", "msd_y_nm", "flare_tis",
                         "socs_rank", "aberrations", "source", "polarization",
                         "chromatic")

    def _pick_start(self, raw_body: bytes | None) -> int:
        if self.affinity and raw_body:
            try:
                body = json.loads(raw_body)
                sig = json.dumps(
                    {k: body.get(k) for k in self._SIGNATURE_FIELDS},
                    sort_keys=True)
                # crc32, not hash(): str hashing is salted per process, and
                # affinity must agree across router restarts
                return zlib.crc32(sig.encode()) % len(self.backends)
            except (json.JSONDecodeError, TypeError, AttributeError):
                pass
        with self._lock:
            start = self._next
            self._next = (self._next + 1) % len(self.backends)
        return start

    def _forward_one(self, url: str, body: bytes | None) -> tuple[int, dict]:
        """Forward, preserving the HTTP method (GET when ``body`` is None).

        Raises OSError only for failures BEFORE any response bytes arrived
        (connection refused/reset, timeout waiting for the status line):
        the only failures that are safe to fail over. Once the backend has
        started replying it may have executed the request, so read errors
        past that point surface as a 502 instead of a retried dispatch."""
        req = urllib.request.Request(
            url, data=body,
            headers={"Content-Type": "application/json"},
            method="POST" if body is not None else "GET")
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as exc:  # backend replied with 4xx/5xx
            try:
                payload = json.loads(exc.read())
            except Exception:  # noqa: BLE001
                payload = {"error": str(exc)}
            return exc.code, payload
        # Status line received: no failover from here on.
        try:
            with resp:
                return resp.status, json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001 - mid-response failure
            return 502, {"error": f"backend response aborted: {exc}"}

    def stream(self, path: str):
        """Relay an artifact stream from the job's pinned backend: returns
        ``(status, (headers, chunk_iterator))`` on success, ``(status,
        error_dict)`` on failure, ``None`` for non-artifact paths. The body
        is relayed chunk by chunk: the router never buffers the artifact."""
        if not (path.startswith("/jobs/") and "/artifact/" in path):
            return None
        job_id = path[len("/jobs/"):].split("/")[0]
        i = self._job_backend.get(job_id)
        if i is None:
            return 404, {"error": f"unknown job {job_id!r}"}
        try:
            resp = urllib.request.urlopen(self.backends[i] + path,
                                          timeout=self.timeout_s)
        except urllib.error.HTTPError as exc:
            try:
                payload = json.loads(exc.read())
            except Exception:  # noqa: BLE001
                payload = {"error": str(exc)}
            return exc.code, payload
        except OSError as exc:
            return 503, {"error": f"job backend unreachable: {exc}"}
        headers = {k: resp.headers[k]
                   for k in ("Content-Type", "Content-Length",
                             "X-Shape", "X-Dtype")
                   if resp.headers.get(k)}

        def chunks(resp=resp):
            with resp:
                while True:
                    blob = resp.read(_STREAM_CHUNK)
                    if not blob:
                        break
                    yield blob

        with self._lock:
            self.forwarded[i] += 1
        return resp.status, (headers, chunks())

    def dispatch(self, path: str, raw_body: bytes | None) -> tuple[int, dict]:
        if path == "/health":
            per_backend = []
            for i, backend in enumerate(self.backends):
                try:
                    status, payload = self._forward_one(backend + "/health", None)
                    ok = status == 200
                except OSError:
                    ok, payload = False, {"error": "unreachable"}
                per_backend.append({"backend": backend, "ok": ok,
                                    "forwarded": self.forwarded[i],
                                    **({"health": payload} if ok else payload)})
            return 200, {"status": "ok", "role": "router",
                         "max_inflight": self.max_inflight,
                         "queued_requests": self.queued,
                         "tracked_jobs": len(self._job_backend),
                         "backends": per_backend}
        if path == "/jobs" and raw_body is None:
            # GET listing: aggregate every backend's tracked jobs
            jobs, queued = [], 0
            for backend in self.backends:
                try:
                    status, payload = self._forward_one(backend + "/jobs",
                                                        None)
                except OSError:
                    continue
                if status == 200:
                    for j in payload.get("jobs", ()):
                        jobs.append(dict(j, backend=backend))
                    queued += int(payload.get("queued", 0))
            return 200, {"jobs": jobs, "count": len(jobs), "queued": queued}
        if path.startswith("/jobs/"):
            # pinned: the owning worker holds the job state (the id is the
            # first path segment: /jobs/<id> and /jobs/<id>/cancel alike)
            job_id = path[len("/jobs/"):].split("/")[0]
            i = self._job_backend.get(job_id)
            if i is None:
                return 404, {"error": f"unknown job {job_id!r}"}
            try:
                status, payload = self._forward_one(
                    self.backends[i] + path, raw_body)
            except OSError as exc:
                return 503, {"error": f"job backend unreachable: {exc}"}
            with self._lock:
                self.forwarded[i] += 1
            return status, payload

        start = self._pick_start(raw_body)
        last_err: Exception | str | None = None
        for attempt in range(len(self.backends)):
            i = (start + attempt) % len(self.backends)
            # Admission slot: wait (bounded) on the per-backend queue. A
            # short grab-or-move probe first, so a busy affine backend
            # spills to an idle one before anyone queues.
            slot = self._slots[i]
            acquired = slot.acquire(timeout=0.05)
            if not acquired:
                if attempt < len(self.backends) - 1:
                    last_err = "backend busy"
                    continue  # try the next backend before queueing
                with self._lock:
                    self.queued += 1
                acquired = slot.acquire(timeout=self.queue_wait_s)
                if not acquired:
                    return 503, {"error": "router queue wait exceeded "
                                          f"{self.queue_wait_s:.0f}s"}
            try:
                # raw_body is None exactly for GET: pass it through so the
                # method is preserved (a GET must not become a POST b"{}").
                status, payload = self._forward_one(
                    self.backends[i] + path, raw_body)
            except OSError as exc:  # connection refused / reset -> failover
                last_err = exc
                continue
            finally:
                slot.release()
            with self._lock:
                self.forwarded[i] += 1
            if (path == "/jobs" and status == 200
                    and isinstance(payload, dict) and "job_id" in payload):
                with self._lock:
                    if len(self._job_backend) > 512:
                        self._job_backend.pop(next(iter(self._job_backend)))
                    self._job_backend[payload["job_id"]] = i
            return status, payload
        return 503, {"error": f"all backends unavailable: {last_err}"}


def _make_http_server(host: str, port: int, dispatch_json, dispatch_raw=None,
                      dispatch_stream=None):
    """Shared HTTP plumbing: dispatch_json(path, body_dict) for parsed-JSON
    handlers, dispatch_raw(path, raw_bytes) to forward bodies untouched,
    dispatch_stream(path) for chunked binary artifact GETs (returns None to
    fall through, (status, ndarray) to stream a local array, (status,
    (headers, chunk_iter)) to relay, or (status, dict) for a JSON error)."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, payload: dict):
            blob = json.dumps(payload, default=repr).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _stream_array(self, arr: np.ndarray):
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(arr.nbytes))
            self.send_header("X-Shape", ",".join(map(str, arr.shape)))
            self.send_header("X-Dtype", str(arr.dtype))
            self.end_headers()
            mv = memoryview(arr).cast("B")
            for off in range(0, len(mv), _STREAM_CHUNK):
                self.wfile.write(mv[off:off + _STREAM_CHUNK])

        def _relay_stream(self, status: int, headers: dict, chunks):
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            for blob in chunks:
                self.wfile.write(blob)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if dispatch_stream is not None:
                res = dispatch_stream(self.path)
                if res is not None:
                    status, payload = res
                    if isinstance(payload, np.ndarray):
                        self._stream_array(payload)
                    elif isinstance(payload, tuple):
                        self._relay_stream(status, *payload)
                    else:
                        self._reply(status, payload)
                    return
            status, payload = (dispatch_raw or dispatch_json)(self.path, None)
            self._reply(status, payload)

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            if dispatch_raw is not None:
                raw = self.rfile.read(length) or b"{}"
                self._reply(*dispatch_raw(self.path, raw))
                return
            # a worker's request (the router's path stays unspanned): its
            # id is issued as the body arrives, and its spans carry it
            with request_scope():
                with span("litho.serve.read"):
                    raw = self.rfile.read(length) or b"{}"
                try:
                    with span("litho.serve.decode"):
                        body = json.loads(raw)
                except json.JSONDecodeError:
                    self._reply(400, {"error": "invalid JSON body"})
                    return
                status, payload = dispatch_json(self.path, body)
                with span("litho.serve.encode"):
                    self._reply(status, payload)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


def make_server(host: str = "127.0.0.1", port: int = 8100, *,
                device="cuda", batching: bool = True,
                batch_window_s: float = 0.005,
                max_batch: int = 8) -> ThreadingHTTPServer:
    """A worker's HTTP server (not started: call ``serve_forever``) over a
    :class:`LithoService` on ``device``, which it carries as ``.service``."""
    service = LithoService(device=device, batching=batching,
                           batch_window_s=batch_window_s, max_batch=max_batch)
    server = _make_http_server(host, port, service.dispatch,
                               dispatch_stream=service.stream)
    server.service = service  # type: ignore[attr-defined]
    return server


def make_router(backends: list[str], host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """A router's HTTP server over ``backends`` (worker base URLs), which
    it carries as ``.router``."""
    router = Router(backends)
    server = _make_http_server(host, port, None, dispatch_raw=router.dispatch,
                               dispatch_stream=router.stream)
    server.router = router  # type: ignore[attr-defined]
    return server


def serve(host: str = "127.0.0.1", port: int = 8100, **kwargs):
    server = make_server(host, port, **kwargs)
    print(f"lithographysimulator_tpu_torch worker on "
          f"{server.service.device} at http://{host}:{port}", flush=True)
    server.serve_forever()


def serve_router(backends: list[str], host: str = "127.0.0.1",
                 port: int = 8000):
    server = make_router(backends, host, port)
    print(f"lithographysimulator_tpu_torch router on http://{host}:{port} -> "
          f"{len(backends)} backend(s)", flush=True)
    server.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lithographysimulator_tpu_torch.serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--device", default="cuda",
                    help="torch device the worker runs on ('cuda', 'cuda:1', "
                         "'cpu')")
    ap.add_argument("--no-batching", action="store_true")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--router", action="store_true",
                    help="run as a router over --backends (start one worker "
                         "per card, each with its own --device)")
    ap.add_argument("--backends", nargs="+", default=[],
                    help="worker base URLs for --router")
    a = ap.parse_args(argv)
    if a.router:
        serve_router(a.backends, a.host, a.port)
    else:
        serve(a.host, a.port, device=a.device, batching=not a.no_batching,
              max_batch=a.max_batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
