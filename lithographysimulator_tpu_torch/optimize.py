"""Inverse lithography: differentiable source-mask optimization (SMO).

Port of ``lithographysimulator_tpu/optimize.py``. The imaging pipeline
(mask spectrum -> pupil -> Abbe accumulation, or the SOCS apply) is
differentiable in the mask geometry, the source weights and the Zernike
coefficients, so the optimizers here are gradient descent on it: a
sigmoid-parameterized continuous mask (and optionally non-negative source
weights) is fitted so that the simulated aerial image, or the developed
resist profile, matches a target.

A step is a loss closure, ``loss.backward()`` and ``torch.optim.Adam.step()``
(optax's ``adam`` defaults are torch's); each history value is the loss
before that step's update, as the JAX loops record it. On CUDA the forward
runs through the hand-written int8 kernels (``engine='auto'``) and their
gradient recomputes each chunk in float32 (``ops/abbe._Int8Intensity``),
as the JAX package's ``custom_vjp`` does; the process-window OPC images
its corners on the float32 ``matmul`` engine instead (see
:func:`opc_correct_pw`).

SMO's loss is the squared error of raw intensities, whose scale grows
with the grid (the reference's unnormalized transforms): at 1024^2 most
of its gradient's squares overflow float32, and an Adam kept in float32
(optax's, in the JAX package) stops moving those pixels. :func:`optimize`
and :func:`optimize_socs` therefore step float64 copies of their
parameters (the forward still runs in float32 on their rounding); below
the overflow they take the JAX package's steps to float32 rounding
(ROADMAP.md Queue 3, D10).

Host data (numpy targets, geometries) needs ``device=``; tensors stay on
their device. With ``mesh=`` (a :class:`.parallel.Mesh`) the exact forward
splits its source points over the mesh
(:func:`.parallel.abbe_image_sharded`) and the image, the loss and the
parameters live on the mesh's first device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._tensors import to_tensor
from .config import OpticsConfig
from .metrology import _builder
from .models.pupil import pupil_function
from .models.resist import ResistModel
from .ops.abbe import abbe_image_points
from .ops.fraunhofer import mask_spectrum
from .ops.hopkins import socs_image
from .ops.tiled import _sync, chip_tensor, default_halo, tile_layout
from .ops.mask3d import _adam_fit, _history, _optimizer_steps


@dataclasses.dataclass(frozen=True)
class SMOProblem:
    """Static description of one source-mask optimization problem."""

    config: OpticsConfig
    solver: str = "gau23"
    chunk: int = 4
    mask_steepness: float = 4.0  # sigmoid sharpness of the latent -> mask map
    optimize_source: bool = False
    # Optional thick-mask model (ops.mask3d): the optimizer then corrects
    # the layout THROUGH the Mask-3D model (M3D-aware SMO/OPC).
    mask3d: object | None = None


def _device(device, *xs) -> torch.device:
    """``device``, else the device of the first tensor among ``xs``; host
    data needs an explicit device (no silent CPU)."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("host data needs an explicit device= (e.g. 'cuda' or 'cpu')")


def _host_aberrations(aberrations) -> np.ndarray:
    if isinstance(aberrations, torch.Tensor):
        aberrations = aberrations.detach().cpu().numpy()
    return np.asarray(aberrations, np.float32)


def _host_shifts(shifts) -> np.ndarray:
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.cpu().numpy()
    return np.asarray(shifts)


def mask_from_latent(latent: torch.Tensor, steepness: float) -> torch.Tensor:
    """Continuous (0, 1) mask from unconstrained latents."""
    return torch.sigmoid(steepness * latent)


def latent_from_mask(geometry: torch.Tensor, steepness: float) -> torch.Tensor:
    """Inverse of :func:`mask_from_latent` on clipped geometry (init helper)."""
    g = torch.clamp(geometry, 1e-4, 1 - 1e-4)
    return torch.log(g / (1 - g)) / steepness


def init_params(problem: SMOProblem, geometry_init, source_weights_init=None,
                *, device=None) -> dict:
    """``{"mask_latent"}`` (and ``"source_logits"`` when the problem
    optimizes the source) on the device of ``geometry_init``, or on
    ``device`` for host data."""
    geometry = to_tensor(geometry_init, device=device, dtype=torch.float32)
    params = {"mask_latent": latent_from_mask(geometry, problem.mask_steepness)}
    if problem.optimize_source:
        if source_weights_init is None:
            raise ValueError("optimize_source=True needs source_weights_init")
        w0 = to_tensor(source_weights_init, device=geometry.device,
                       dtype=torch.float32)
        params["source_logits"] = torch.log(torch.clamp(w0, min=1e-3))
    return params


def _source_weights(params: dict, weights: torch.Tensor,
                    problem: SMOProblem) -> torch.Tensor:
    """The per-point weights the image uses: ``exp(logits)`` on the live
    points (padding stays dark) when the source is optimized."""
    if not problem.optimize_source:
        return weights
    live = (weights > 0).to(torch.float32)
    return torch.exp(params["source_logits"]) * live


def forward(params: dict, aberrations, shifts, weights, problem: SMOProblem,
            mesh=None) -> torch.Tensor:
    """Differentiable aerial image from SMO parameters, on the device of
    ``params["mask_latent"]`` (host aberrations and weights move there);
    with ``mesh`` the source points are split over it and the image is on
    its first device."""
    cfg = problem.config
    latent = params["mask_latent"]
    device = latent.device
    geom = mask_from_latent(latent, problem.mask_steepness)
    if problem.mask3d is not None:
        geom = problem.mask3d.apply(geom, cfg)
    spectrum = mask_spectrum(geom, cfg, solver=problem.solver)
    pupil = pupil_function(to_tensor(aberrations, device=device,
                                     dtype=torch.float32), cfg)
    w = _source_weights(params, to_tensor(weights, device=device,
                                          dtype=torch.float32), problem)
    if mesh is not None:
        from .parallel import abbe_image_sharded

        return abbe_image_sharded(spectrum, pupil, _host_shifts(shifts), w,
                                  cfg, mesh, solver=problem.solver,
                                  chunk=problem.chunk, normalize=True)
    return abbe_image_points(spectrum, pupil, _host_shifts(shifts), w, cfg,
                             device=device, solver=problem.solver,
                             chunk=problem.chunk, normalize=True)


def loss_fn(params, target, aberrations, shifts, weights, problem: SMOProblem,
            mesh=None) -> torch.Tensor:
    image = forward(params, aberrations, shifts, weights, problem, mesh)
    return torch.mean((image - to_tensor(target, device=image.device)) ** 2)


def make_train_step(problem: SMOProblem, optimizer, mesh=None):
    """A ``(params, opt_state, target, aberrations, shifts, weights) ->
    (params, opt_state, loss)`` training step.

    ``optimizer`` takes the place of the JAX package's optax transform: a
    factory that makes a ``torch.optim.Optimizer`` from a list of tensors,
    e.g. ``functools.partial(torch.optim.SGD, lr=0.1)``. ``opt_state`` is
    that optimizer, or ``None`` at the first step: the step then copies
    ``params`` into fresh leaf tensors and builds the optimizer on them.
    The returned ``params`` are the optimizer's tensors, updated in place;
    pass them and ``opt_state`` to the next step. ``loss`` is the loss
    before the update (a detached 0-dim tensor). ``mesh`` splits the
    forward's source points over a :class:`.parallel.Mesh`."""

    def step(params, opt_state, target, aberrations, shifts, weights):
        if opt_state is None:
            params = _leaves(params)
            opt_state = optimizer(list(params.values()))
        (loss,) = _optimizer_steps(opt_state, lambda: loss_fn(
            params, target, aberrations, shifts, weights, problem, mesh), 1)
        return params, opt_state, loss

    return step


def _leaves(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def _masters(params: dict) -> dict:
    """float64 leaf copies of ``params``, which Adam steps (see the module
    docstring: its second moment of an SMO gradient overflows float32)."""
    return {k: v.detach().to(torch.float64).requires_grad_()
            for k, v in params.items()}


def _working(masters: dict) -> dict:
    """The float32 parameters the forward runs on, in the graph."""
    return {k: v.float() for k, v in masters.items()}


def optimize(
    problem: SMOProblem,
    target,
    geometry_init,
    aberrations,
    shifts,
    weights,
    *,
    steps: int = 100,
    learning_rate: float = 0.1,
    source_weights_init=None,
    mesh=None,
    device=None,
) -> tuple[dict, list[float]]:
    """Run SMO for ``steps`` Adam iterations on the exact Abbe model;
    returns (params, loss history). Runs on ``device``, else on the device
    of the tensor ``target`` or ``geometry_init``; with ``mesh`` on the
    mesh's first device, the forward's source points split over the mesh."""
    if mesh is not None and device is None:
        device = mesh.first
    device = _device(device, target, geometry_init)
    masters = _masters(init_params(problem, geometry_init, source_weights_init,
                                   device=device))
    target = to_tensor(target, device=device, dtype=torch.float32)
    aberrations = _host_aberrations(aberrations)
    shifts = _host_shifts(shifts)
    weights = to_tensor(weights, device=device, dtype=torch.float32)
    history = _adam_fit(list(masters.values()), lambda: loss_fn(
        _working(masters), target, aberrations, shifts, weights, problem,
        mesh), steps, learning_rate)
    return {k: v.detach().float() for k, v in masters.items()}, history


# ---------------------------------------------------------------------------
# SOCS-accelerated SMO (alternating mask / source phases)
# ---------------------------------------------------------------------------

def _source_map_from_points(shifts, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter per-point source weights back onto the (n, n) weight map on
    the weights' device (the inverse of :func:`..ops.abbe.source_points`;
    zero-weight padding points scatter zeros at the center, harmless)."""
    weights = to_tensor(weights, dtype=torch.float32)
    idx = torch.as_tensor(_host_shifts(shifts).astype(np.int64) + n // 2,
                          device=weights.device)
    return torch.zeros((n, n), dtype=torch.float32,
                       device=weights.device).index_put_(
        (idx[:, 0], idx[:, 1]), weights, accumulate=True)


def _socs_loss(latent, problem: SMOProblem, socs, w_sum, target):
    """The SOCS-model loss of a mask step: the image of the latent's mask
    through the fixed kernels, over the source's total weight."""
    cfg = problem.config
    geom = mask_from_latent(latent, problem.mask_steepness)
    if problem.mask3d is not None:
        geom = problem.mask3d.apply(geom, cfg)
    spectrum = mask_spectrum(geom, cfg, solver=problem.solver)
    image = socs_image(spectrum, socs, cfg, solver=problem.solver,
                       chunk=problem.chunk) / w_sum
    return torch.mean((image - target) ** 2)


def optimize_socs(
    problem: SMOProblem,
    target,
    geometry_init,
    aberrations,
    shifts,
    weights,
    *,
    steps: int = 100,
    learning_rate: float = 0.1,
    rank: int = 64,
    power_iters: int = 2,
    source_weights_init=None,
    mask_steps_per_build: int = 20,
    source_learning_rate: float | None = None,
    chromatic=None,
    device=None,
) -> tuple[dict, list[float]]:
    """SMO with the SOCS forward model on the mask phase.

    Mask-only problems build ONE kernel set and run every gradient step
    through :func:`..ops.hopkins.socs_image`: O(rank) FFT-sized work a
    step instead of O(source points), with the same physics up to the
    rank truncation. The aerial image is a quadratic form in the mask
    spectrum for FIXED kernels, so holding them constant across mask steps
    is exact.

    With ``problem.optimize_source=True`` the loop alternates: an outer
    iteration rebuilds the kernels for the CURRENT source, warm-started
    from the previous iteration's Ritz basis (``power_iters`` capped at 1:
    a source step is a small operator perturbation), runs
    ``mask_steps_per_build`` SOCS mask steps against it, then takes one
    exact-Abbe gradient step on the source logits (the kernels absorb the
    source, so its gradient needs the per-point path). Returns (params,
    loss history) like :func:`optimize`; history entries are SOCS-model
    losses for mask steps and Abbe-model losses for source steps. Runs on
    ``device``, else on the device of the tensor ``target`` or
    ``geometry_init``."""
    cfg = problem.config
    device = _device(device, target, geometry_init)
    masters = _masters(init_params(problem, geometry_init, source_weights_init,
                                   device=device))
    latent = masters["mask_latent"]
    target = to_tensor(target, device=device, dtype=torch.float32)
    aberrations = _host_aberrations(aberrations)
    shifts = _host_shifts(shifts)
    weights = to_tensor(weights, device=device, dtype=torch.float32)
    live = (weights > 0).to(torch.float32)

    if chromatic is not None and problem.optimize_source:
        # the source step's exact-Abbe gradient path is monochromatic
        raise ValueError(
            "chromatic SMO requires optimize_source=False (mask-only)")

    def build(source_map, init_basis, iters):
        """(kernels, Ritz basis) of ``source_map``: the JAX package's
        ``_socs_build_basis_with_channels``, scalar or polychromatic."""
        return _builder(cfg, rank, source_map, device, polarization=None,
                        apodize=True, chromatic=chromatic)(
            aberrations, init_basis=init_basis, power_iters=iters,
            return_basis=True)

    mask_opt = torch.optim.Adam([latent], lr=learning_rate)
    kernels = {}

    def mask_loss():
        return _socs_loss(latent.float(), problem, kernels["socs"],
                          kernels["w_sum"], target)

    if not problem.optimize_source:
        kernels["socs"], _ = build(
            _source_map_from_points(shifts, weights, cfg.n), None, power_iters)
        kernels["w_sum"] = weights.sum()
        history = _history(_optimizer_steps(mask_opt, mask_loss, steps))
        return {"mask_latent": latent.detach().float()}, history

    logits = masters["source_logits"]
    src_lr = learning_rate if source_learning_rate is None else source_learning_rate
    src_opt = torch.optim.Adam([logits], lr=src_lr)

    def source_loss():
        return loss_fn({"mask_latent": latent.detach().float(),
                        "source_logits": logits.float()},
                       target, aberrations, shifts, weights, problem)

    losses = []
    basis = None
    done = 0
    while done < steps:
        with torch.no_grad():
            w_now = torch.exp(logits.float()) * live
        src_map = _source_map_from_points(shifts, w_now, cfg.n)
        kernels["socs"], basis = build(
            src_map, basis, power_iters if basis is None else min(power_iters, 1))
        kernels["w_sum"] = w_now.sum()
        k = min(mask_steps_per_build, steps - done)
        losses += _optimizer_steps(mask_opt, mask_loss, k)
        done += k
        losses += _optimizer_steps(src_opt, source_loss, 1)
    return ({"mask_latent": latent.detach().float(),
             "source_logits": logits.detach().float()}, _history(losses))


# ---------------------------------------------------------------------------
# Aberration retrieval (wavefront metrology)
# ---------------------------------------------------------------------------

def fit_aberrations(
    target_image,
    spectrum,
    shifts,
    weights,
    config: OpticsConfig,
    *,
    n_coeffs: int = 10,
    steps: int = 200,
    learning_rate: float = 0.05,
    solver: str = "gau23",
    chunk: int = 4,
    init=None,
    defocus_nm=None,
    device=None,
) -> tuple[torch.Tensor, list[float]]:
    """Recover OSA Zernike coefficients from a measured aerial image by
    gradient descent through the imaging model.

    The target and model images are normalized per iteration, so absolute
    dose need not be known. Piston (index 0) is a global phase with no
    intensity signature and is pinned to zero.

    Through-focus mode (the scanner-matching workflow): pass ``defocus_nm``
    (length F) and a matching (F, n, n) ``target_image`` stack. A single
    in-focus image cannot determine the SIGN of even (focus-symmetric)
    aberrations, so aberration metrology measures a focal stack; each known
    stage offset is ADDED to the fitted entry-4 base defocus (both nm), which
    keeps the residual scanner defocus identifiable from two or more planes.
    The planes are imaged one after another and their losses averaged.

    Runs on ``device``, else on the device of the tensor ``spectrum`` or
    ``target_image``; returns the coefficients there."""
    device = _device(device, spectrum, target_image)
    target = to_tensor(target_image, device=device, dtype=torch.float32)
    if defocus_nm is not None:
        offsets = np.asarray(defocus_nm, np.float32)
        if target.ndim != 3 or target.shape[0] != offsets.shape[0]:
            raise ValueError(
                f"defocus_nm has {offsets.shape[0]} planes; target_image "
                f"must be a matching (F, n, n) stack, got {tuple(target.shape)}")
        n_coeffs = max(n_coeffs, 5)  # entry 4 carries the focal offsets
        plane_offsets = torch.zeros((offsets.shape[0], n_coeffs),
                                    dtype=torch.float32, device=device)
        plane_offsets[:, 4] = torch.as_tensor(offsets, device=device)
    else:
        if target.ndim != 2:
            raise ValueError("single-image fit expects an (n, n) target; "
                             "pass defocus_nm for a focal stack")
        plane_offsets = None
    target = target / torch.clamp(torch.amax(target, dim=(-2, -1),
                                             keepdim=True), min=1e-30)
    mask_vec = torch.ones((n_coeffs,), dtype=torch.float32, device=device)
    mask_vec[0] = 0.0
    spectrum = to_tensor(spectrum, device=device, dtype=torch.complex64)
    shifts = _host_shifts(shifts)
    weights = to_tensor(weights, device=device, dtype=torch.float32)

    def one_plane(coeffs, target_plane):
        pupil = pupil_function(coeffs, config)
        image = abbe_image_points(spectrum, pupil, shifts, weights, config,
                                  device=device, solver=solver, chunk=chunk,
                                  normalize=True)
        image = image / torch.clamp(torch.max(image), min=1e-30)
        return torch.mean((image - target_plane) ** 2)

    coeffs = (torch.zeros((n_coeffs,), dtype=torch.float32, device=device)
              if init is None else
              to_tensor(init, device=device, dtype=torch.float32).clone())
    coeffs.requires_grad_()

    def loss():
        c = coeffs * mask_vec
        if plane_offsets is None:
            return one_plane(c, target)
        return torch.stack([one_plane(cf, t) for cf, t in
                            zip(c + plane_offsets, target)]).mean()

    history = _adam_fit([coeffs], loss, steps, learning_rate)
    return coeffs.detach() * mask_vec, history


# ---------------------------------------------------------------------------
# Resist-aware OPC
# ---------------------------------------------------------------------------

def _default_resist(resist):
    return resist or ResistModel(threshold=0.35, steepness=30.0)


def opc_correct(
    target_geometry,
    aberrations,
    shifts,
    weights,
    problem: SMOProblem,
    *,
    resist=None,
    steps: int = 150,
    learning_rate: float = 0.15,
    device=None,
) -> tuple[torch.Tensor, list[float]]:
    """Optical proximity correction: optimize the mask so the *developed
    resist pattern* matches the target layout (not just the aerial image).

    The loss is the mean squared difference between the differentiable
    resist profile of the simulated image and the binary target; gradients
    flow through develop -> image -> spectrum -> mask. Returns the
    corrected continuous mask (on the target's device, or on ``device``
    for a host target) and the loss history."""
    resist = _default_resist(resist)
    device = _device(device, target_geometry)
    target = to_tensor(target_geometry, device=device, dtype=torch.float32)
    aberrations = _host_aberrations(aberrations)
    shifts = _host_shifts(shifts)
    weights = to_tensor(weights, device=device, dtype=torch.float32)
    params = _leaves(init_params(problem, target))  # start from the design

    def loss():
        image = forward(params, aberrations, shifts, weights, problem)
        profile = resist.develop(image, problem.config)
        return torch.mean((profile - target) ** 2)

    history = _adam_fit(list(params.values()), loss, steps, learning_rate)
    corrected = mask_from_latent(params["mask_latent"].detach(),
                                 problem.mask_steepness)
    return corrected, history


# ---------------------------------------------------------------------------
# Full-chip (tile-streamed) OPC
# ---------------------------------------------------------------------------

def opc_correct_tiled(
    target_big,
    tile_config,
    source_map,
    *,
    resist=None,
    halo: int | None = None,
    steps: int = 60,
    learning_rate: float = 0.15,
    mask_steepness: float = 4.0,
    rank: int = 64,
    sweeps: int = 1,
    aberrations=None,
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    progress_cb=None,
    mask3d=None,
    device=None,
) -> np.ndarray:
    """Resist-aware OPC on an arbitrarily large layout, tile by tile.

    Imaging locality (the property :mod:`.ops.tiled` stitches with) makes
    OPC local too: each tile is optimized under tile-sized optics with its
    halo ring frozen (to the original design on the first sweep, to the
    already-corrected mask on later sweeps and for tiles later in the
    row-major order: Gauss-Seidel) and only the halo-free core lands in
    the output. The per-tile forward model is the SOCS path (one kernel
    build a call, differentiable through ``socs_image``), so the cost is
    O(sweeps * tiles * steps) SOCS images at tile size.

    ``polarization`` builds the kernels with the vector Jones-pupil
    physics, ``chromatic`` polychromatic; ``mask3d`` makes the correction
    M3D-aware (the forward model images the layout THROUGH the thick-mask
    model). The padded chip and the corrected chip stay on ``device`` (a
    tensor target's own by default) and the corrected CONTINUOUS mask is
    read back once, as a host array (threshold at 0.5 for manufactured
    geometry). ``progress_cb(fraction)`` is called after each tile, once
    the device has finished it."""
    device = _device(device, target_big)
    if aberrations is None:
        aberrations = np.zeros((5,), np.float32)
    n = tile_config.n
    if halo is None:
        halo = min(default_halo(tile_config), n // 4)
    socs = _builder(tile_config, rank, source_map, device,
                    polarization=polarization, apodize=apodize,
                    chromatic=chromatic)(_host_aberrations(aberrations))
    return _opc_tiles(target_big, socs, tile_config, halo=halo, steps=steps,
                      learning_rate=learning_rate,
                      mask_steepness=mask_steepness,
                      resist=_default_resist(resist), sweeps=sweeps,
                      progress_cb=progress_cb, mask3d=mask3d)


def _tile_loss(latent, frozen, core, target_core, socs, tile_config,
               halo: int, steepness: float, resist, mask3d):
    """One tile's OPC loss: the latent's mask inside ``core``, the frozen
    ring outside it, imaged through the kernels and developed; the
    mismatch is read on the halo-free core only."""
    n = tile_config.n
    mask = torch.where(core, mask_from_latent(latent, steepness), frozen)
    if mask3d is not None:
        mask = mask3d.apply(mask, tile_config)
    spectrum = mask_spectrum(mask, tile_config, solver="gau23")
    profile = resist.develop(socs_image(spectrum, socs, tile_config),
                             tile_config)
    return torch.mean((profile[halo:n - halo, halo:n - halo]
                       - target_core) ** 2)


def _opc_tiles(target_big, socs, tile_config, *, halo: int, steps: int,
               learning_rate: float, mask_steepness: float, resist,
               sweeps: int, progress_cb, mask3d) -> np.ndarray:
    """:func:`opc_correct_tiled`'s sweeps with a prebuilt kernel set, on
    the kernels' device."""
    device = socs.kernels.device
    n = tile_config.n
    target = chip_tensor(target_big, device).to(torch.float32)
    big_n = target.shape[-1]
    tiles, step_px = tile_layout(big_n, n, halo)
    pad_hi = tiles * step_px + halo - big_n + (n - step_px)
    target_pad = torch.nn.functional.pad(target, (halo, pad_hi, halo, pad_hi))
    corrected = target_pad.clone()
    core = torch.zeros((n, n), dtype=torch.bool, device=device)
    core[halo:n - halo, halo:n - halo] = True
    inner = slice(halo, n - halo)

    n_sweeps = max(1, sweeps)
    done = 0
    for _ in range(n_sweeps):
        for ti in range(tiles):
            for tj in range(tiles):
                y0, x0 = ti * step_px, tj * step_px
                # a view: the tile's steps read the ring, nothing writes it
                frozen = corrected[y0:y0 + n, x0:x0 + n]
                target_core = target_pad[y0 + halo:y0 + n - halo,
                                         x0 + halo:x0 + n - halo]
                latent = latent_from_mask(target_pad[y0:y0 + n, x0:x0 + n],
                                          mask_steepness).requires_grad_()
                _optimizer_steps(
                    torch.optim.Adam([latent], lr=learning_rate),
                    lambda: _tile_loss(latent, frozen, core, target_core, socs,
                                       tile_config, halo, mask_steepness,
                                       resist, mask3d), steps)
                with torch.no_grad():
                    corrected[y0 + halo:y0 + n - halo,
                              x0 + halo:x0 + n - halo] = mask_from_latent(
                        latent, mask_steepness)[inner, inner]
                done += 1
                if progress_cb is not None:
                    _sync(device)
                    progress_cb(done / (n_sweeps * tiles * tiles))
    return corrected[halo:halo + big_n, halo:halo + big_n].cpu().numpy()


# ---------------------------------------------------------------------------
# Process-window-aware OPC
# ---------------------------------------------------------------------------

def opc_correct_pw(
    target_geometry,
    config,
    source_map,
    *,
    defocus_nm=(-60.0, 0.0, 60.0),
    doses=(0.95, 1.0, 1.05),
    corner_weights=None,
    resist=None,
    steps: int = 120,
    learning_rate: float = 0.15,
    mask_steepness: float = 4.0,
    rank: int = 64,
    aberrations=None,
    polarization=None,
    chromatic=None,
    device=None,
) -> tuple[torch.Tensor, dict]:
    """Process-window-aware OPC: optimize the mask so the developed resist
    pattern matches the target across EVERY (defocus, dose) corner of the
    process window at once, not just at nominal conditions.

    One SOCS kernel set is built per defocus plane, warm-started from the
    previous plane's Ritz basis (``power_iters=0``), so the sweep pays 1
    cold and F-1 cheap builds; the (defocus x dose) corner grid shares
    each plane's kernel set (and its image) across the doses, indexed, not
    copied. Every step sums the weighted resist-profile mismatch of all
    corners, with gradients through each. ``polarization`` builds vector
    kernels, ``chromatic`` polychromatic ones.

    The corners image on the float32 ``matmul`` engine (TF32 off) on CUDA
    and on ``fft`` on the CPU, never on the int8 kernels: the JAX package
    pins its f32 engine here too, as the accuracy point for an
    optimization forward model (ROADMAP.md Queue 3, D8).

    Returns ``(corrected_mask, report)`` with the last step's pre-update
    per-corner losses as an (F, D) array. Runs on ``device``, else on the
    device of a tensor ``target_geometry``."""
    resist = _default_resist(resist)
    device = _device(device, target_geometry)
    if aberrations is None:
        aberrations = np.zeros((5,), np.float32)
    aberrations = _host_aberrations(aberrations)
    if aberrations.shape[0] < 5:
        aberrations = np.pad(aberrations, (0, 5 - aberrations.shape[0]))
    build = _builder(config, rank, source_map, device,
                     polarization=polarization, apodize=True,
                     chromatic=chromatic)
    kernel_sets = []
    basis = None
    for d in defocus_nm:
        ab = aberrations.copy()
        ab[4] += float(d)
        if basis is None:
            socs, basis = build(ab, return_basis=True)
        else:
            socs, basis = build(ab, init_basis=basis, power_iters=0,
                                return_basis=True)
        kernel_sets.append(socs)
    del basis

    n_corners = len(defocus_nm) * len(doses)
    if corner_weights is None:
        weights = torch.full((n_corners,), 1.0 / n_corners,
                             dtype=torch.float32, device=device)
    else:
        weights = to_tensor(np.asarray(corner_weights, np.float32),
                            device=device)
        if weights.shape != (n_corners,):
            raise ValueError(f"corner_weights shape {tuple(weights.shape)} != "
                             f"({n_corners},)")
        weights = weights / torch.sum(weights)
    engine = "matmul" if device.type == "cuda" else "fft"

    target = to_tensor(target_geometry, device=device, dtype=torch.float32)
    latent = latent_from_mask(target, mask_steepness).requires_grad_()
    last = {}

    def loss():
        mask = mask_from_latent(latent, mask_steepness)
        spectrum = mask_spectrum(mask, config, solver="gau23")
        losses = []
        for socs in kernel_sets:
            img = socs_image(spectrum, socs, config, engine=engine)
            img = img / torch.clamp(torch.max(img), min=1e-30)
            for dose in doses:
                profile = resist.develop(img * float(dose), config,
                                         normalize=False)
                losses.append(torch.mean((profile - target) ** 2))
        losses = torch.stack(losses)
        last["losses"] = losses.detach()
        return torch.sum(weights * losses)

    history = _history(_optimizer_steps(
        torch.optim.Adam([latent], lr=learning_rate), loss, steps))
    corrected = mask_from_latent(latent.detach(), mask_steepness)
    report = {
        "loss_history": history,
        "corner_losses": last["losses"].cpu().numpy().reshape(
            len(defocus_nm), len(doses)),
        "defocus_nm": list(defocus_nm),
        "doses": list(doses),
    }
    return corrected, report
