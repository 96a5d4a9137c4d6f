"""One caller in a closed loop: ``simulate(mask, source, aberrations,
solver='gau23', polarization=p, device=...)`` on a pool of distinct seeded
masks taken in turn, so that every call runs the exact (Abbe) engine: one
pass over every source point for each field component of each Jones state.
The optics (NA at the pupil's edge, the immersion index) and the pixelated
source are formed from the configuration, as a user forms them. Set-up
makes the pool on the device and makes one warm call. Traffic: ``pool``
masks; ``sample`` of the images the window completed are compared, the
first of a seeded order of the pool that the window reached.

``compare``: the worst ``image_nrms`` and ``broadband_nrms`` (see
:mod:`litho_bench.judge`) of those images against the float64 vector
image of the same mask (:mod:`litho_bench.reference.vector`)."""

from __future__ import annotations

import time

import numpy as np

from litho_bench import judge, masks, program
from litho_bench.reference import optics as ro
from litho_bench.reference import vector as rv


def optics(cfg: dict):
    """The port's optics of the configuration; a port without
    ``pupil_at_na`` refuses it here, before any work."""
    return program.lt().OpticsConfig(
        pixel_number=cfg["pixel_number"], pixel_size=cfg["pixel_nm"],
        wavelength=cfg["wavelength_nm"], na=cfg["na"],
        immersion_index=cfg["immersion_index"],
        pupil_at_na=cfg["pupil_at_na"])


def fields_per_image(cfg: dict, source: np.ndarray) -> tuple[int, int]:
    """(fields, passes) of one image: live source points times the three
    field components times the polarization's Jones states."""
    passes = 3 * len(rv.STATES[cfg["polarization"]])
    return passes * int(np.count_nonzero(source)), passes


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    oc = optics(cfg)
    lt = program.lt()
    source = rv.dipole_source(cfg)
    pool = masks.layouts(ctx.seed, 0, tr["pool"], cfg["pixel_number"],
                         cfg["layout"], device=ctx.device)
    state = {"optics": oc, "source": source,
             "aberrations": program.aberrations(cfg), "pool": pool,
             "masks": [lt.Mask(geometry=g, config=oc) for g in pool],
             "order": masks.rng_for(ctx.seed, 1).permutation(tr["pool"]).tolist()}
    call(state, ctx, 0)
    return state


def call(state, ctx, i):
    cfg = ctx.config
    return program.lt().simulate(
        state["masks"][i], state["source"], state["aberrations"],
        solver="gau23", polarization=cfg["polarization"],
        apodize=cfg["apodize"], device=ctx.device)


def window(state, ctx, seconds):
    n = ctx.config["pixel_number"]
    pool = len(state["masks"])
    fields, passes = fields_per_image(ctx.config, state["source"])
    kept, k = {}, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = k % pool
        with ctx.span("bench.simulate"):
            result = call(state, ctx, i)
        kept.setdefault(i, result.image)
        k += 1
    return {"attempted": k, "failed": 0, "images": k, "pixels": k * n * n,
            "abbe_fields": k * fields, "abbe_passes": k * passes,
            "abbe_n": n, "kept": kept}


def sampled(state, record, k: int) -> list[int]:
    """The first ``k`` of the seeded order of the pool that the window
    completed."""
    return [i for i in state["order"] if i in record["kept"]][:k]


def checks(cfg: dict, pairs) -> list:
    """The cell's numbers, each beside its limit, for (geometry, the
    program's image) pairs (a window that produced nothing fails)."""
    if not pairs:
        return [("images_compared", 0.0, -1.0)]
    source = rv.dipole_source(cfg)
    block = cfg["vector_reference"]["block"]
    worst, worst_band = 0.0, 0.0
    for geometry, image in pairs:
        ref = rv.image(geometry, source, cfg, cfg["polarization"], block=block)
        image = image.to(ref.device)
        worst = max(worst, ro.nrms(image, ref))
        worst_band = max(worst_band, judge.broadband(cfg, image, ref))
    limits = cfg["limits"]
    return [("image_nrms", worst, limits["image_nrms"]),
            ("broadband_nrms", worst_band, limits["broadband_nrms"])]


def compare(state, record, ctx):
    picks = sampled(state, record, ctx.traffic["sample"])
    return checks(ctx.config, [(state["pool"][i], record["kept"][i])
                               for i in picks])
