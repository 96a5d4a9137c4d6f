"""One caller in a closed loop: the stochastic print of a line/space clip.
A call is ``simulate(mask, source, aberrations, solver='socs',
socs_rank=r, perturb=..., device=...)`` (the SOCS image with the pupil's
edge at NA / lambda, the scanner's stage blur and flare), then
``stochastic_ensemble(image, optics, resist, trials=T, seed=s,
trial_chunk=c, psd=True)``: ``T`` Monte-Carlo exposures, their cut lines
read back, LER, LWR, LCDU, bridge and break rates, the print probability
and the averaged edge PSD. The masks (seeded gratings of
:mod:`litho_bench.lines`) are taken in turn; ``s`` is drawn from
``--seed`` and grows by one a call, so every call draws new trials.

Set-up forms the optics, the dipole, the perturbation, the resist and the
pool on the device, as a user forms them, and makes one whole warm call,
which builds the kernel set and meets every shape. The record keeps, for
the first call on each mask, the image, ``s`` and the ensemble's dict, and
the window's change of the port's ``stochastic.*`` counters (None where the
port has none).

``compare``: for the first ``sample`` masks of a seeded order of the pool
that the window reached, the image against the float64 SOCS image of the
same mask (:mod:`litho_bench.reference.euv`: ``image_nrms``,
``broadband_nrms``), and the ensemble against the float64 ensemble of the
same image and seed (:mod:`litho_bench.reference.stochastic`, which draws
the same photon counts): the worst relative difference of LER, LWR and
LCDU, the worst absolute difference of the mean and the deterministic CD
(nm) and of the bridge and break rates, the mean absolute difference of
the print probability and the relative RMS of the averaged PSD."""

from __future__ import annotations

import math
import time

import numpy as np

from litho_bench import judge, lines, masks, program
from litho_bench.reference import euv
from litho_bench.reference import optics as ro
from litho_bench.reference import stochastic as rst
from litho_bench.reference import vector as rv

CHECKS = ("ler_rel", "lwr_rel", "lcdu_rel", "mean_cd_abs_nm",
          "deterministic_cd_abs_nm", "bridge_rate_abs", "break_rate_abs",
          "print_probability_mad", "psd_rel_rms")


def optics(cfg: dict, **over):
    return program.lt().OpticsConfig(
        pixel_number=cfg["pixel_number"], pixel_size=cfg["pixel_nm"],
        wavelength=cfg["wavelength_nm"], na=cfg["na"],
        immersion_index=cfg["immersion_index"],
        pupil_at_na=over.get("pupil_at_na", cfg["pupil_at_na"]))


def perturbation(cfg: dict):
    return program.lt().ImagePerturbation(**cfg["perturbation"])


def resist(cfg: dict, **over):
    return program.lt().StochasticResist(**{**cfg["resist"], **over})


def row_step(cfg: dict, traffic: dict) -> int:
    return traffic["row_step"] or max(1, cfg["pixel_number"] // 512)


def counts() -> dict | None:
    """The port's ``stochastic.*`` totals, or None where it keeps none."""
    try:
        from lithographysimulator_tpu_torch.models.stochastic import \
            stochastic_counts
    except ImportError:
        return None
    return stochastic_counts()


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    lt = program.lt()
    oc = optics(cfg)
    pool, params = lines.layouts(ctx.seed, 0, tr["pool"], cfg["pixel_number"],
                                 cfg["grating"], cfg["pixel_nm"],
                                 device=ctx.device)
    state = {"optics": oc, "source": rv.dipole_source(cfg),
             "aberrations": program.aberrations(cfg),
             "perturb": perturbation(cfg), "resist": resist(cfg),
             "pool": pool, "params": params,
             "masks": [lt.Mask(geometry=g, config=oc) for g in pool],
             "order": masks.rng_for(ctx.seed, 1).permutation(tr["pool"]).tolist(),
             "seed0": int(masks.rng_for(ctx.seed, 2).integers(2**62))}
    call(state, ctx, 0, state["seed0"] - 1)
    return state


def call(state, ctx, i, s):
    """(the simulate result, the ensemble's dict) of mask ``i``, trials of
    seed ``s``."""
    cfg, tr = ctx.config, ctx.traffic
    lt = program.lt()
    with ctx.span("bench.simulate"):
        result = lt.simulate(state["masks"][i], state["source"],
                             state["aberrations"], solver="socs",
                             socs_rank=cfg["socs_rank"], perturb=state["perturb"],
                             device=ctx.device)
    with ctx.span("bench.stochastic"):
        ens = lt.stochastic_ensemble(result.image, state["optics"],
                                     state["resist"], trials=tr["trials"],
                                     seed=s, trial_chunk=tr["trial_chunk"],
                                     psd=tr["psd"], row_step=tr["row_step"])
    return result, ens


def window(state, ctx, seconds):
    cfg, tr = ctx.config, ctx.traffic
    n = cfg["pixel_number"]
    pool = len(state["masks"])
    before = counts()
    kept, k = {}, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i, s = k % pool, state["seed0"] + k
        result, ens = call(state, ctx, i, s)
        kept.setdefault(i, (result.image, s, ens))
        k += 1
    after = counts()
    delta = (None if before is None or after is None
             else {key: after[key] - before[key] for key in after})
    return {"attempted": k, "failed": 0, "images": k, "pixels": k * n * n,
            "trials": k * tr["trials"], "socs_images": k,
            "socs_rank": cfg["socs_rank"], "socs_n": n,
            "row_step": row_step(cfg, tr), "stochastic_counts": delta,
            "kept": kept}


def sampled(state, record, k: int) -> list[int]:
    """The first ``k`` of the seeded order of the pool that the window
    completed."""
    return [i for i in state["order"] if i in record["kept"]][:k]


def _rel(value: float, ref: float) -> float:
    if value == ref:
        return 0.0
    d = abs(value - ref) / abs(ref) if ref else math.inf
    return d if math.isfinite(d) else math.inf


def _abs(value: float, ref: float) -> float:
    d = abs(value - ref)
    return d if math.isfinite(d) else math.inf


def ensemble_errors(ens: dict, ref: dict) -> dict:
    """Each of :data:`CHECKS` between the program's ensemble and the
    reference's."""
    prob = np.asarray(ens["print_probability"], np.float64)
    p_ref = ref["print_probability"]
    out = {"ler_rel": _rel(ens["ler_nm"], ref["ler_nm"]),
           "lwr_rel": _rel(ens["lwr_nm"], ref["lwr_nm"]),
           "lcdu_rel": _rel(ens["lcdu_nm"], ref["lcdu_nm"]),
           "mean_cd_abs_nm": _abs(ens["mean_cd_nm"], ref["mean_cd_nm"]),
           "deterministic_cd_abs_nm": _abs(ens["deterministic_cd_nm"],
                                           ref["deterministic_cd_nm"]),
           "bridge_rate_abs": _abs(ens["bridge_rate"], ref["bridge_rate"]),
           "break_rate_abs": _abs(ens["break_rate"], ref["break_rate"]),
           "print_probability_mad": (float(np.abs(prob - p_ref).mean())
                                     if prob.shape == p_ref.shape else math.inf)}
    p, r = ens.get("psd", {}), ref.get("psd", {})
    edges = (p.get("n_edges", 0), r.get("n_edges", 0))
    p, r = p.get("psd_nm3"), r.get("psd_nm3")
    if edges == (0, 0):
        out["psd_rel_rms"] = 0.0  # neither has a line across the cut lines
    elif 0 in edges or np.shape(p) != np.shape(r):
        out["psd_rel_rms"] = math.inf
    else:
        d = np.asarray(p, np.float64) - r
        num, den = float(np.mean(d * d)), float(np.mean(r * r))
        out["psd_rel_rms"] = (math.sqrt(num / den) if den > 0
                              else 0.0 if num == 0 else math.inf)
    return out


def checks(cfg: dict, traffic: dict, items, *, kernels=None) -> list:
    """The cell's numbers, each beside its limit, for (geometry, the
    program's image, s, the program's ensemble) items (a window that
    produced nothing fails). ``kernels``: the reference's kernel set, when
    the caller has it."""
    if not items:
        return [("ensembles_compared", 0.0, -1.0)]
    device = items[0][1].device
    kernels = kernels or euv.kernel_set(cfg, device)
    worst = dict.fromkeys(("image_nrms", "broadband_nrms") + CHECKS, 0.0)
    for geometry, image, s, ens in items:
        ref_image = euv.image(geometry.to(device), *kernels, cfg)
        errors = {"image_nrms": ro.nrms(image, ref_image),
                  "broadband_nrms": judge.broadband(cfg, image, ref_image)}
        ref = rst.ensemble(image, cfg, seed=s, trials=traffic["trials"],
                           row_step=row_step(cfg, traffic), psd=traffic["psd"])
        errors.update(ensemble_errors(ens, ref))
        for name, value in errors.items():
            worst[name] = max(worst[name], value)
    limits = {**cfg["limits"], **cfg["ensemble_limits"]}
    return [(name, value, limits[name]) for name, value in worst.items()]


def compare(state, record, ctx):
    picks = sampled(state, record, ctx.traffic["sample"])
    return checks(ctx.config, ctx.traffic,
                  [(state["pool"][i], *record["kept"][i]) for i in picks])
