"""The controls of ``euv1024.stochastic64``'s comparison: the program with
one part of its model or precision changed, each judged as a run is
(:func:`litho_bench.drivers.stochastic_stream.checks`) against the
configuration's own reference. Each has to exceed at least one limit, and
the program has to stay under every one.

* ``gaussian noise``: the resist's ``noise='gaussian'`` (mean + sqrt(mean)
  times a normal draw) in place of the Poisson counts;
* ``no PAG saturation``: ``pag_per_nm2=0``;
* ``diffusion +10%``: the acid's diffusion length 10% longer;
* ``63 trials as 64``: an ensemble of one trial fewer judged as one of
  the traffic's trials;
* ``TF32 apply``: the image from the zoom-DFT apply (``engine='matmul'``)
  with TF32 on, the precision below the float32 the configuration states
  (a card only: a CPU has no TF32);
* ``rank cut to 3/4``: the image from a kernel set cut to three quarters
  of the configuration's rank (192 of 256);
* ``pupil edge at 1/lambda``: the image with the pupil's edge at 1 /
  lambda (the default convention) in place of NA / lambda.

Beside them, :func:`reduced_references` judges the reference itself
computed in less than its float64: the image in complex64 with TF32 on,
and the chain after the draw in float32 and in float16.
"""

from __future__ import annotations

import contextlib

import torch

from litho_bench import lines, masks, program
from litho_bench.drivers import stochastic_stream as drv
from litho_bench.reference import euv
from litho_bench.reference import stochastic as rst
from litho_bench.reference import vector as rv

CONTROLS = ("gaussian noise", "no PAG saturation", "diffusion +10%",
            "63 trials as 64", "TF32 apply", "rank cut to 3/4",
            "pupil edge at 1/lambda")


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def case(cfg: dict, traffic: dict, seed: int, device: str):
    """(geometry, trials' seed) of the mask a run seeded ``seed`` judges
    first, and the seed of its first call on it."""
    pool, _ = lines.layouts(seed, 0, traffic["pool"], cfg["pixel_number"],
                            cfg["grating"], cfg["pixel_nm"], device=device)
    first = masks.rng_for(seed, 1).permutation(traffic["pool"]).tolist()[0]
    return pool[first], int(masks.rng_for(seed, 2).integers(2**62)) + first


def image(cfg: dict, geometry, device: str, *, rank: int | None = None,
          pupil_at_na: bool | None = None, matmul_tf32: bool = False):
    """The program's image of ``geometry``: ``simulate`` as the cell calls
    it, or the apply's ``engine='matmul'`` under TF32."""
    lt = program.lt()
    over = {} if pupil_at_na is None else {"pupil_at_na": pupil_at_na}
    oc = drv.optics(cfg, **over)
    source = rv.dipole_source(cfg)
    rank = cfg["socs_rank"] if rank is None else rank
    if not matmul_tf32:
        return lt.simulate(lt.Mask(geometry=geometry, config=oc), source,
                           program.aberrations(cfg), solver="socs",
                           socs_rank=rank, perturb=drv.perturbation(cfg),
                           device=device).image
    socs = lt.randomized_socs(lt.pupil_function(program.aberrations(cfg), oc,
                                                device=device),
                              source, oc, rank=rank)
    with tf32():
        img = lt.socs_image(lt.mask_spectrum(geometry, oc), socs, oc,
                            engine="matmul")
    return lt.apply_perturbation(img, drv.perturbation(cfg), oc)


def ensemble(cfg: dict, traffic: dict, img, s: int, *, trials: int | None = None,
             **resist_over) -> dict:
    """The program's ensemble of ``img`` as the cell calls it."""
    return program.lt().stochastic_ensemble(
        img, drv.optics(cfg), drv.resist(cfg, **resist_over),
        trials=traffic["trials"] if trials is None else trials, seed=s,
        trial_chunk=traffic["trial_chunk"], psd=traffic["psd"],
        row_step=traffic["row_step"])


def _judged(cfg, traffic, geometry, img, s, ens, kernels) -> dict:
    return {name: value for name, value, _ in
            drv.checks(cfg, traffic, [(geometry, img, s, ens)], kernels=kernels)}


def readings(cfg: dict, traffic: dict, seed: int, device: str, *,
             controls=CONTROLS, kernels=None) -> dict:
    """{'program' or a control: {check: value}} of the mask a run seeded
    ``seed`` judges first."""
    kernels = kernels or euv.kernel_set(cfg, device)
    geometry, s = case(cfg, traffic, seed, device)
    sound = image(cfg, geometry, device)
    variants = {"program": (sound, {}),
                "gaussian noise": (sound, {"noise": "gaussian"}),
                "no PAG saturation": (sound, {"pag_per_nm2": 0.0}),
                "diffusion +10%": (sound, {"diffusion_nm": 1.1 * cfg["resist"]["diffusion_nm"]}),
                "63 trials as 64": (sound, {"trials": traffic["trials"] - 1}),
                "TF32 apply": (None, {"matmul_tf32": True}),
                "rank cut to 3/4": (None, {"rank": 3 * cfg["socs_rank"] // 4}),
                "pupil edge at 1/lambda": (None, {"pupil_at_na": False})}
    out = {}
    for name in ("program",) + tuple(controls):
        img, over = variants[name]
        if img is None:
            img, over = image(cfg, geometry, device, **over), {}
        ens = ensemble(cfg, traffic, img, s, **over)
        out[name] = _judged(cfg, traffic, geometry, img, s, ens, kernels)
    return out


def reduced_references(cfg: dict, traffic: dict, seed: int, device: str, *,
                       kernels=None) -> dict:
    """{'reference image in complex64 with TF32' | 'reference chain in
    float32' | 'reference chain in float16': {check: value}}: the
    reference in less than float64, judged as the program is."""
    kernels = kernels or euv.kernel_set(cfg, device)
    geometry, s = case(cfg, traffic, seed, device)
    sound = image(cfg, geometry, device)
    out = {}
    with tf32():
        low = euv.image(geometry, *kernels, cfg, dtype=torch.complex64)
    out["reference image in complex64 with TF32"] = _judged(
        cfg, traffic, geometry, low.to(torch.float32), s,
        ensemble(cfg, traffic, low.to(torch.float32), s), kernels)
    for name, dtype in (("float32", torch.float32), ("float16", torch.float16)):
        ens = rst.ensemble(sound, cfg, seed=s, trials=traffic["trials"],
                           row_step=drv.row_step(cfg, traffic),
                           psd=traffic["psd"], dtype=dtype)
        out[f"reference chain in {name}"] = _judged(cfg, traffic, geometry,
                                                    sound, s, ens, kernels)
    return out


def failed(reading: dict, limits: dict) -> list[str]:
    """The checks of one reading over their limits (or not finite)."""
    return [k for k, v in reading.items()
            if not (v <= limits[k] and v == v and abs(v) != float("inf"))]
