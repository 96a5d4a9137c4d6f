"""Thick-mask (Mask-3D) effects: the boundary-layer and edge-kernel models.

Port of ``lithographysimulator_tpu/ops/mask3d.py``. The imaging stack
treats the mask as a thin Kirchhoff screen; real masks are ~70 nm of
absorber on glass, and near feature edges the topography perturbs the
field: orientation-dependent CD bias, pattern shift and a best-focus shift
that the thin mask cannot produce. The boundary-layer (BL) model
(Tirapu-Azpiroz & Yablonovitch, JOSA A 23, 2006) adds thin strips of
complex transmission along every edge; on an n x n grid with pixel size p
a strip of width w and amplitude beta is an added field ``beta * (w / p)``
on the edge pixels, found from first differences of the geometry: pure
elementwise and roll work, zero away from edges and differentiable in the
mask and the model's parameters.

* forward: :func:`apply_boundary_layers` and :func:`apply_edge_kernel`
  give the effective complex mask that every imaging path consumes
  unchanged (``simulate(mask3d=...)`` calls the model's ``.apply``);
* calibration: :func:`fit_boundary_layer` and :func:`fit_edge_kernel` fit
  the parameters to a reference image by ``torch.optim.Adam`` through the
  imaging stack (the int8 engine on the card: its gradient recomputes in
  float32), and :func:`boundary_layer_from_rcwa` does so against the
  in-repo rigorous RCWA near field (:mod:`.rcwa`);
* :func:`model_to_json` / :func:`model_from_json` read and write the JSON
  that ``m3dcal --out`` and ``--m3d`` exchange, the same as the JAX
  package's.

Edge-orientation convention: a VERTICAL edge runs along the row axis
(transmission changes along axis 1); ``beta_v`` scales vertical-edge
strips, ``beta_h`` horizontal-edge strips. ``width_nm == 0`` or
``beta == 0`` recovers the thin mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._tensors import to_tensor
from ..config import OpticsConfig

_EPS = 1e-20  # smooths |diff| at exactly-flat regions so mask grads stay finite


@dataclasses.dataclass(frozen=True)
class BoundaryLayer:
    """Static BL parameters (hashable: usable as a cache key).

    width_nm: physical strip width (per edge side, total added amplitude per
        unit edge length is ``beta * width_nm``).
    beta_h / beta_v: complex added transmission of horizontal- / vertical-
        edge strips. Real part biases CD; imaginary part produces the
        thick-mask best-focus shift and pattern asymmetry through focus.
    beta_h_asym / beta_v_asym: oblique-incidence (EUV chief-ray shadowing)
        asymmetry: rising / falling edges carry beta +- asym (see
        :func:`edge_fields_signed`). 0 = symmetric model.
    """

    width_nm: float = 8.0
    beta_h: complex = 0.0
    beta_v: complex = 0.0
    beta_h_asym: complex = 0.0
    beta_v_asym: complex = 0.0

    def apply(self, geometry: torch.Tensor, config: OpticsConfig) -> torch.Tensor:
        return apply_boundary_layers(
            geometry, config,
            width_nm=self.width_nm, beta_h=self.beta_h, beta_v=self.beta_v,
            beta_h_asym=self.beta_h_asym, beta_v_asym=self.beta_v_asym)


def _safe_abs(d: torch.Tensor) -> torch.Tensor:
    if d.is_complex():
        return torch.sqrt(d.real ** 2 + d.imag ** 2 + _EPS)
    return torch.sqrt(d * d + _EPS)


def edge_fields(geometry: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E_h, E_v) edge-strength maps: each unit transmission step contributes
    total weight 1 per edge, split 1/2-1/2 onto the two pixels flanking it.
    Works on continuous and complex (PSM) masks alike; periodic (roll)
    boundaries match the FFT spectrum's own periodicity."""
    g = to_tensor(geometry)
    d0 = _safe_abs(g - torch.roll(g, 1, dims=0))  # steps along rows
    d1 = _safe_abs(g - torch.roll(g, 1, dims=1))  # steps along columns
    e_h = 0.5 * (d0 + torch.roll(d0, -1, dims=0))
    e_v = 0.5 * (d1 + torch.roll(d1, -1, dims=1))
    return e_h, e_v


def edge_fields_signed(geometry: torch.Tensor):
    """:func:`edge_fields` split by step direction: ``(E_h_rise, E_h_fall,
    E_v_rise, E_v_fall)`` where *rise* means transmission MAGNITUDE
    increasing along the +axis direction. ``rise + fall`` recovers
    :func:`edge_fields` (to 1 ulp). Direction is by |t| for real dtypes
    too: a real alternating PSM's +1 -> -1 step splits evenly, while a
    0 -> -1 step is a rise."""
    g = to_tensor(geometry)
    mag = _safe_abs(g)
    d0 = _safe_abs(g - torch.roll(g, 1, dims=0))
    d1 = _safe_abs(g - torch.roll(g, 1, dims=1))
    s0 = mag - torch.roll(mag, 1, dims=0)
    s1 = mag - torch.roll(mag, 1, dims=1)
    rise0, fall0 = 0.5 * (d0 + s0), 0.5 * (d0 - s0)
    rise1, fall1 = 0.5 * (d1 + s1), 0.5 * (d1 - s1)

    def split(d, axis):
        return 0.5 * (d + torch.roll(d, -1, dims=axis))

    return split(rise0, 0), split(fall0, 0), split(rise1, 1), split(fall1, 1)


def _static_zero(beta) -> bool:
    """True only for a literal Python zero (not a tensor)."""
    return isinstance(beta, (int, float, complex)) and complex(beta) == 0.0


def _c64(value, device) -> torch.Tensor:
    """``value`` (a Python number or a tensor that may require grad) as a
    complex64 tensor on ``device``."""
    return torch.as_tensor(value, dtype=torch.complex64, device=device)


def _scale(width_nm, config: OpticsConfig, device) -> torch.Tensor:
    """``width_nm / pixel_size`` in float32, as the JAX package divides."""
    return (torch.as_tensor(width_nm, dtype=torch.float32, device=device)
            / torch.tensor(config.pixel_size, dtype=torch.float32,
                           device=device))


def apply_boundary_layers(
    geometry: torch.Tensor,
    config: OpticsConfig,
    *,
    width_nm,
    beta_h,
    beta_v,
    beta_h_asym=0.0,
    beta_v_asym=0.0,
) -> torch.Tensor:
    """Effective complex64 transmission with BL strips added along edges.
    ``width_nm`` and the betas may be Python numbers (the forward path) or
    tensors (the calibration path differentiates through them)."""
    g = to_tensor(geometry)
    dev = g.device
    scale = _scale(width_nm, config, dev)
    if _static_zero(beta_h_asym) and _static_zero(beta_v_asym):
        e_h, e_v = edge_fields(g)
        pert = scale * (_c64(beta_h, dev) * e_h + _c64(beta_v, dev) * e_v)
        return g.to(torch.complex64) + pert
    # asymmetric model (oblique-incidence shadowing): rising and falling
    # edges carry beta +- asym respectively
    e_hr, e_hf, e_vr, e_vf = edge_fields_signed(g)
    bh, bv = _c64(beta_h, dev), _c64(beta_v, dev)
    bha, bva = _c64(beta_h_asym, dev), _c64(beta_v_asym, dev)
    pert = scale * ((bh + bha) * e_hr + (bh - bha) * e_hf
                    + (bv + bva) * e_vr + (bv - bva) * e_vf)
    return g.to(torch.complex64) + pert


@dataclasses.dataclass(frozen=True)
class EdgeKernelM3D:
    """Generalized (multi-tap) thick-mask edge model, the "wide boundary
    layer"; :class:`BoundaryLayer` is the K=0 case. Each edge orientation
    (h/v) and step direction (rise/fall by transmission magnitude) carries
    its own complex tap vector over pixel offsets -K..K along the step
    axis; the added field is ``(width_nm / pixel_size) * sum_o taps[o] *
    shift_o(edge strips)``. Hashable, consumed by every imaging path
    through the same ``.apply`` as BoundaryLayer. At EUV the 1-px strip
    floors at ~11% image NRMS on the 6-degree rigorous fixture; K=1 reaches
    ~1.2% and K=2 ~0.1% (the JAX package's tests/test_mask3d.py)."""

    width_nm: float = 8.0
    taps_h_rise: tuple = (0j,)
    taps_h_fall: tuple = (0j,)
    taps_v_rise: tuple = (0j,)
    taps_v_fall: tuple = (0j,)

    def __post_init__(self):
        lens = {len(self.taps_h_rise), len(self.taps_h_fall),
                len(self.taps_v_rise), len(self.taps_v_fall)}
        if len(lens) != 1 or (next(iter(lens)) % 2) == 0:
            raise ValueError("tap vectors must share one odd length")

    @property
    def k(self) -> int:
        return (len(self.taps_v_rise) - 1) // 2

    def apply(self, geometry: torch.Tensor, config: OpticsConfig) -> torch.Tensor:
        return apply_edge_kernel(
            geometry, config, width_nm=self.width_nm,
            taps_h_rise=self.taps_h_rise, taps_h_fall=self.taps_h_fall,
            taps_v_rise=self.taps_v_rise, taps_v_fall=self.taps_v_fall)


def apply_edge_kernel(
    geometry: torch.Tensor,
    config: OpticsConfig,
    *,
    width_nm,
    taps_h_rise,
    taps_h_fall,
    taps_v_rise,
    taps_v_fall,
) -> torch.Tensor:
    """Effective complex64 transmission under the multi-tap edge model.
    Tap vectors may be tuples of Python complex or complex tensors (the
    calibration path). Offsets run along the step axis (vertical edges
    shift along x, horizontal along y)."""
    g = to_tensor(geometry)
    dev = g.device
    e_hr, e_hf, e_vr, e_vf = edge_fields_signed(g)
    scale = _scale(width_nm, config, dev)

    def conv(field, taps, axis):
        k = (len(taps) - 1) // 2
        out = torch.zeros(g.shape, dtype=torch.complex64, device=dev)
        for i, off in enumerate(range(-k, k + 1)):
            out = out + _c64(taps[i], dev) * torch.roll(field, off, dims=axis)
        return out

    pert = scale * (conv(e_hr, taps_h_rise, 0) + conv(e_hf, taps_h_fall, 0)
                    + conv(e_vr, taps_v_rise, 1) + conv(e_vf, taps_v_fall, 1))
    return g.to(torch.complex64) + pert


def _fit_imager(config: OpticsConfig, solver: str, chunk: int,
                stacked: bool, target_shape: tuple, *, device, engine: str):
    """Shared imaging core of the M3D fits: effective mask -> jointly
    max-normalized aerial image(s) on ``device``. ``stacked`` selects the
    through-focus path (aberrations (F, A), output (F, n, n)); the target
    shape is validated against it up front (a mismatched pair would
    otherwise broadcast silently into a meaningless loss)."""
    from ..models.pupil import pupil_function
    from .abbe import abbe_image_points
    from .focus import through_focus_images
    from .fraunhofer import mask_spectrum

    if stacked != (len(target_shape) == 3):
        raise ValueError(
            f"aberrations {'stack' if stacked else 'vector'} needs a "
            f"{'(F, n, n)' if stacked else '(n, n)'} target, got shape "
            f"{tuple(target_shape)}")

    def imaged(eff, aberrations, shifts, weights):
        spectrum = mask_spectrum(eff, config, solver=solver)
        if stacked:
            image = through_focus_images(
                spectrum, aberrations, shifts, weights, config, device=device,
                solver=solver, chunk=chunk, normalize=True, engine=engine)
        else:
            pupil = pupil_function(aberrations, config, device=device)
            image = abbe_image_points(
                spectrum, pupil, shifts, weights, config, device=device,
                solver=solver, chunk=chunk, normalize=True, engine=engine)
        return image / torch.clamp(image.max(), min=1e-30)

    return imaged


def _fit_inputs(target_image, geometry, shifts, weights, aberrations, *,
                device):
    """Host or device inputs of a fit as the imaging stack takes them:
    (target normalized to its max, geometry tensor, host shifts, weights
    tensor, host float32 aberrations)."""
    if aberrations is None:
        aberrations = np.zeros((1,), np.float32)
    if isinstance(aberrations, torch.Tensor):
        aberrations = aberrations.detach().cpu().numpy()
    aberrations = np.asarray(aberrations, np.float32)
    geometry = to_tensor(geometry, device=device)
    target = to_tensor(target_image, device=device, dtype=torch.float32)
    target = target / torch.clamp(target.max(), min=1e-30)
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.cpu().numpy()
    weights = to_tensor(weights, device=device, dtype=torch.float32)
    return target, geometry, np.asarray(shifts), weights, aberrations


def _optimizer_steps(opt: torch.optim.Optimizer, loss_fn, steps: int) -> list:
    """``steps`` steps of ``opt`` on the scalar ``loss_fn()``; returns the
    losses as 0-dim tensors on their device, each taken before its step's
    update as optax's loops record it. Nothing here waits for the device:
    the caller reads the values back, if at all."""
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return losses


def _history(losses: list) -> list:
    """The 0-dim loss tensors of :func:`_optimizer_steps` as floats, read
    back at once."""
    return torch.stack(losses).tolist() if losses else []


def _adam_fit(params: list, loss_fn, steps: int, learning_rate: float) -> list:
    """``steps`` Adam steps (optax's defaults, which are torch's: b1 0.9,
    b2 0.999, eps 1e-8) on the real tensors ``params``; returns the loss
    history (see :func:`_optimizer_steps`)."""
    return _history(_optimizer_steps(torch.optim.Adam(params, lr=learning_rate),
                                     loss_fn, steps))


def fit_edge_kernel(
    target_image,
    geometry,
    shifts,
    weights,
    config: OpticsConfig,
    *,
    device,
    k: int = 1,
    width_nm: float = 8.0,
    solver: str = "gau23",
    chunk: int = 8,
    steps: int = 200,
    learning_rate: float = 0.02,
    aberrations=None,
    engine: str = "auto",
) -> tuple[EdgeKernelM3D, list[float]]:
    """Calibrate an :class:`EdgeKernelM3D` (4 * (2k+1) complex taps)
    against a reference aerial image: the multi-tap analog of
    :func:`fit_boundary_layer`, the same Adam loop through the imaging
    stack on ``device`` (``engine`` 'auto' is int8 on CUDA). Edge
    orientations absent from the pattern get zero gradient and keep zero
    taps. A 2-D ``aberrations`` stack (F, A) with a matching (F, n, n)
    target fits through focus."""
    target, geometry, shifts, weights, aberrations = _fit_inputs(
        target_image, geometry, shifts, weights, aberrations, device=device)
    imaged = _fit_imager(config, solver, chunk, aberrations.ndim == 2,
                         tuple(target.shape), device=device, engine=engine)
    n_taps = 2 * int(k) + 1
    params = torch.zeros((4, n_taps, 2), dtype=torch.float32, device=device,
                         requires_grad=True)

    def loss_fn():
        taps = torch.complex(params[..., 0], params[..., 1])  # (4, n_taps)
        eff = apply_edge_kernel(
            geometry, config, width_nm=width_nm,
            taps_h_rise=taps[0], taps_h_fall=taps[1],
            taps_v_rise=taps[2], taps_v_fall=taps[3])
        image = imaged(eff, aberrations, shifts, weights)
        return torch.mean((image - target) ** 2)

    history = _adam_fit([params], loss_fn, steps, learning_rate)
    host = params.detach().cpu().numpy()
    taps = host[..., 0] + 1j * host[..., 1]
    fitted = EdgeKernelM3D(
        width_nm=width_nm,
        taps_h_rise=tuple(complex(c) for c in taps[0]),
        taps_h_fall=tuple(complex(c) for c in taps[1]),
        taps_v_rise=tuple(complex(c) for c in taps[2]),
        taps_v_fall=tuple(complex(c) for c in taps[3]),
    )
    return fitted, history


def fit_boundary_layer(
    target_image,
    geometry,
    shifts,
    weights,
    config: OpticsConfig,
    *,
    device,
    width_nm: float = 8.0,
    solver: str = "gau23",
    chunk: int = 8,
    steps: int = 200,
    learning_rate: float = 0.02,
    aberrations=None,
    fit_asym: bool = False,
    engine: str = "auto",
) -> tuple[BoundaryLayer, list[float]]:
    """Calibrate (beta_h, beta_v) against a reference aerial image by Adam
    on the normalized-image MSE, through the imaging stack on ``device``
    (``engine`` 'auto' is int8 on CUDA). ``fit_asym=True`` also fits the
    rising/falling asymmetry (beta_h_asym, beta_v_asym). The strip width is
    held fixed (width and |beta| are nearly degenerate to first order).

    Through focus: pass ``aberrations`` as an (F, A) stack and
    ``target_image`` as the matching (F, n, n) stack, jointly normalized.
    An in-focus image constrains Im beta only at second order; the
    +-defocus planes' asymmetry pins it at first order.

    Returns the fitted :class:`BoundaryLayer` and the loss history."""
    target, geometry, shifts, weights, aberrations = _fit_inputs(
        target_image, geometry, shifts, weights, aberrations, device=device)
    imaged = _fit_imager(config, solver, chunk, aberrations.ndim == 2,
                         tuple(target.shape), device=device, engine=engine)
    keys = ["bh_re", "bh_im", "bv_re", "bv_im"]
    if fit_asym:
        keys += ["ah_re", "ah_im", "av_re", "av_im"]
    params = {k: torch.zeros((), dtype=torch.float32, device=device,
                             requires_grad=True) for k in keys}

    def loss_fn():
        p = params
        asym = ({"beta_h_asym": torch.complex(p["ah_re"], p["ah_im"]),
                 "beta_v_asym": torch.complex(p["av_re"], p["av_im"])}
                if fit_asym else {})
        eff = apply_boundary_layers(
            geometry, config, width_nm=width_nm,
            beta_h=torch.complex(p["bh_re"], p["bh_im"]),
            beta_v=torch.complex(p["bv_re"], p["bv_im"]), **asym)
        image = imaged(eff, aberrations, shifts, weights)
        return torch.mean((image - target) ** 2)

    history = _adam_fit(list(params.values()), loss_fn, steps, learning_rate)
    v = {k: float(t.detach()) for k, t in params.items()}
    fitted = BoundaryLayer(
        width_nm=width_nm,
        beta_h=complex(v["bh_re"], v["bh_im"]),
        beta_v=complex(v["bv_re"], v["bv_im"]),
        beta_h_asym=complex(v["ah_re"], v["ah_im"]) if fit_asym else 0.0,
        beta_v_asym=complex(v["av_re"], v["av_im"]) if fit_asym else 0.0,
    )
    return fitted, history


def grating_geometry(config: OpticsConfig, *, pitch_px: int, duty: float,
                     transmission: complex = 0.0, axis: int = 1, device):
    """Drawn thin-mask line/space layout on ``device`` matching the
    centering convention of :func:`.rcwa.rcwa_effective_mask`: absorber of
    complex ``transmission`` covering ``duty`` of each period, centered on
    x = 0 (periodic wrap). ``duty * pitch_px`` should be an ODD pixel count
    for an exact raster (an even count rasterizes one pixel narrow). Binary
    masks are real float32, others complex64."""
    n = int(config.pixel_number)
    if pitch_px <= 0 or n % int(pitch_px):
        raise ValueError(f"pitch_px={pitch_px} must divide pixel_number={n}")
    x = np.arange(n)
    half = 0.5 * duty * pitch_px
    dist = np.minimum(x % pitch_px, pitch_px - (x % pitch_px))
    row = np.where(dist < half, complex(transmission), 1.0 + 0.0j)
    geom = np.broadcast_to(row[None, :], (n, n))
    if axis == 0:
        geom = geom.T
    if complex(transmission) == 0.0:
        return torch.as_tensor(np.ascontiguousarray(geom.real),
                               dtype=torch.float32, device=device)
    return torch.as_tensor(np.ascontiguousarray(geom), dtype=torch.complex64,
                           device=device)


def boundary_layer_from_rcwa(
    config: OpticsConfig,
    *,
    device,
    stack="binary_cr",
    pitch_px: int = 16,
    duty: float = 7.0 / 16.0,
    illumination_pol: str = "unpolarized",
    width_nm: float = 8.0,
    magnification: float = 4.0,
    n_harmonics: int = 31,
    sigma_out: float = 0.5,
    solver: str = "gau23",
    chunk: int = 8,
    steps: int = 150,
    learning_rate: float = 0.05,
    incidence_deg: float = 0.0,
    azimuth_deg: float = 0.0,
    taps: int = 0,
    defocus_nm=(),
):
    """Calibrate the BL model from first principles, with no external EMF
    tool: run the in-repo RCWA oracle (:mod:`.rcwa`) on a line/space
    topography of the absorber ``stack``, image the rigorous near field
    through :func:`..simulate.simulate` on ``device``, and fit beta by
    Adam against that image (one fit per polarization, on the auto
    engine: int8 on CUDA). For lines along y (a VERTICAL
    edge), E parallel to the lines is TE and E across them TM:

    - ``illumination_pol='x'``: beta_v = beta_TM, beta_h = beta_TE;
    - ``'y'``: beta_v = beta_TE, beta_h = beta_TM;
    - ``'unpolarized'``: both fit against the TE/TM-averaged image, so
      beta_h = beta_v by rotational symmetry.

    ``defocus_nm`` (e.g. ``(-80, 0, 80)``) makes the target a
    through-focus stack, which pins Im beta at first order.
    ``incidence_deg`` tilts the illumination (the EUV chief ray with the
    reflective ``euv_ta`` stack) towards ``azimuth_deg``; a tilt turns on
    the asymmetric fit. ``taps > 0`` fits the multi-tap
    :class:`EdgeKernelM3D` instead; at oblique incidence its horizontal
    taps are calibrated directly against the conical-mount near field of
    a horizontal grating.

    Returns the calibrated model and a report dict with the
    per-polarization fits, loss histories and the rigorous/thin/corrected
    image residuals (nRMS) that certify the fit. Same algorithm and
    defaults as the JAX package's function; source points come from
    :func:`.abbe.source_points` padded to ``chunk``."""
    from ..models.mask import Mask, from_array
    from ..models.source import LightSource
    from ..simulate import simulate
    from .abbe import _pad_points, source_points
    from .focus import focus_stack_aberrations
    from .rcwa import rcwa_effective_mask, thin_mask_transmission

    if illumination_pol not in ("x", "y", "unpolarized"):
        raise ValueError(f"unknown illumination_pol {illumination_pol!r}")

    src = np.asarray(LightSource(config, sigma_out=sigma_out).classical())
    pts = source_points(src)
    shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
    defocus_nm = (tuple(float(d) for d in
                        np.atleast_1d(np.asarray(defocus_nm, np.float64)))
                  if np.size(defocus_nm) else ())
    stack_ab = (focus_stack_aberrations(np.zeros(5, np.float32),
                                        np.asarray(defocus_nm, np.float32))
                if defocus_nm else None)

    t_thin = thin_mask_transmission(stack, config.wavelength,
                                    incidence_deg=incidence_deg)
    if abs(t_thin) < 0.02:
        t_thin = 0.0  # binary: draw the standard opaque layout
    fit_asym = incidence_deg != 0.0
    # Oblique + multi-tap: calibrate horizontal edges DIRECTLY against the
    # conical-mount near field (see the docstring) instead of symmetrizing.
    direct_h = taps > 0 and fit_asym

    def imaged(geometry) -> np.ndarray:
        if isinstance(geometry, torch.Tensor):
            mask = Mask(geometry=geometry, config=config)
        else:
            mask = from_array(geometry, config, device=device)
        if stack_ab is None:
            img = simulate(mask, src, device=device, solver=solver,
                           normalize=True).image.cpu().numpy()
        else:
            # through-focus target: one plane per defocus, ONE joint
            # normalization (the through-focus contrast loss is signal)
            img = np.stack([
                simulate(mask, src, ab, device=device, solver=solver,
                         normalize=True).image.cpu().numpy()
                for ab in stack_ab])
        return img / max(float(img.max()), 1e-30)

    def nrms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    report = {"pitch_px": pitch_px, "duty": duty,
              "defocus_nm": list(defocus_nm), "azimuth_deg": azimuth_deg,
              "thin_nrms": {}, "fit_nrms": {}, "history": {}}

    def calibration_pass(axis: int, azim: float, tag: str) -> dict:
        """Fit one grating orientation against its rigorous near field:
        axis=1 (vertical lines) at conical azimuth ``azim``, axis=0
        (horizontal lines) at ``90 - azimuth_deg``; the horizontal pass's
        report keys carry an ``h_`` prefix. A pass at exactly 90 degrees
        has a mirror-symmetric near field, so its edge-kernel taps are
        symmetrized before certification."""
        sym_taps = taps > 0 and float(azim) == 90.0
        geom = grating_geometry(config, pitch_px=pitch_px, duty=duty,
                                transmission=t_thin, axis=axis, device=device)
        thin_img = imaged(geom)
        targets = {}
        for pol in ("te", "tm"):
            rig = rcwa_effective_mask(
                config, pitch_px=pitch_px, duty=duty, stack=stack, pol=pol,
                axis=axis, magnification=magnification,
                n_harmonics=n_harmonics, incidence_deg=incidence_deg,
                azimuth_deg=azim)
            targets[pol] = imaged(rig)
        fit_targets = ({"avg": 0.5 * (targets["te"] + targets["tm"])}
                       if illumination_pol == "unpolarized" else targets)
        axis_fits = {}
        for key, target in fit_targets.items():
            fit_kw = dict(device=device, width_nm=width_nm, solver=solver,
                          chunk=chunk, steps=steps,
                          learning_rate=learning_rate, aberrations=stack_ab)
            if taps > 0:
                bl, hist = fit_edge_kernel(target, geom, shifts, weights,
                                           config, k=taps, **fit_kw)
            else:
                bl, hist = fit_boundary_layer(target, geom, shifts, weights,
                                              config, fit_asym=fit_asym,
                                              **fit_kw)
            if sym_taps:
                # symmetrize the taps of this pass's own edge orientation
                names = (("taps_h_rise", "taps_h_fall") if axis == 0
                         else ("taps_v_rise", "taps_v_fall"))
                tr, tf = getattr(bl, names[0]), getattr(bl, names[1])
                kk = len(tr)
                sym = tuple(0.5 * (tr[i] + tf[kk - 1 - i])
                            for i in range(kk))
                bl = dataclasses.replace(
                    bl, **{names[0]: sym, names[1]: sym[::-1]})
            axis_fits[key] = bl
            corrected = imaged(bl.apply(geom, config))
            report["thin_nrms"][tag + key] = nrms(thin_img, target)
            report["fit_nrms"][tag + key] = nrms(corrected, target)
            report["history"][tag + key] = hist
        return axis_fits

    fits = calibration_pass(1, azimuth_deg, "")
    fits_h = (calibration_pass(0, 90.0 - azimuth_deg, "h_")
              if direct_h else None)

    if taps > 0:
        result = _edge_kernel_from_fits(fits, illumination_pol, width_nm,
                                        fits_h=fits_h)
    # the fitted asymmetry lives on the calibration grating's vertical
    # edges only (the tilt is across them; see the docstring)
    elif illumination_pol == "unpolarized":
        beta = fits["avg"].beta_v
        result = BoundaryLayer(width_nm=width_nm, beta_h=beta, beta_v=beta,
                               beta_v_asym=fits["avg"].beta_v_asym)
    elif illumination_pol == "x":
        result = BoundaryLayer(width_nm=width_nm,
                               beta_h=fits["te"].beta_v,
                               beta_v=fits["tm"].beta_v,
                               beta_v_asym=fits["tm"].beta_v_asym)
    else:
        result = BoundaryLayer(width_nm=width_nm,
                               beta_h=fits["tm"].beta_v,
                               beta_v=fits["te"].beta_v,
                               beta_v_asym=fits["te"].beta_v_asym)
    report["fits"] = fits
    if fits_h is not None:
        report["fits_h"] = fits_h
    return result, report


def _symmetrized_taps(fit: EdgeKernelM3D) -> tuple[tuple, tuple]:
    """(rise, fall) horizontal-edge tap vectors from a vertical-edge fit:
    the mirror x → −x maps a rising edge at offset o to a falling edge at
    −o, so the incidence-symmetric part is the average of the two — what a
    horizontal edge (unshadowed by an x-tilt) should carry. At normal
    incidence this is exact (the fit already satisfies rise[o] == fall[−o]
    up to optimizer noise); at oblique incidence it strips the shadowing
    asymmetry, which belongs to the tilt axis only."""
    vr, vf = fit.taps_v_rise, fit.taps_v_fall
    sym = tuple(0.5 * (vr[i] + vf[len(vf) - 1 - i]) for i in range(len(vr)))
    return sym, sym[::-1]


def _edge_kernel_from_fits(fits: dict, illumination_pol: str,
                           width_nm: float,
                           fits_h: dict | None = None) -> EdgeKernelM3D:
    """Assemble the full (h, v) edge kernel from per-orientation fits, with
    the same TE/TM-to-orientation mapping as the BoundaryLayer path. The
    TE/TM keys are relative to each grating's own lines, so the SAME key
    selects the matching physical polarization in both passes (e.g.
    x-polarized light is TM across vertical lines and TE along horizontal
    ones). Without a horizontal pass (``fits_h`` None — normal incidence),
    horizontal taps are the mirror-symmetrized vertical fit."""
    if illumination_pol == "unpolarized":
        v_fit = h_fit = fits["avg"]
        h_key = "avg"
    elif illumination_pol == "x":
        v_fit, h_fit = fits["tm"], fits["te"]
        h_key = "te"
    else:
        v_fit, h_fit = fits["te"], fits["tm"]
        h_key = "tm"
    if fits_h is not None:
        h = fits_h[h_key]
        h_rise, h_fall = h.taps_h_rise, h.taps_h_fall
    else:
        h_rise, h_fall = _symmetrized_taps(h_fit)
    return EdgeKernelM3D(
        width_nm=width_nm,
        taps_h_rise=h_rise, taps_h_fall=h_fall,
        taps_v_rise=v_fit.taps_v_rise, taps_v_fall=v_fit.taps_v_fall)


# ---------------------------------------------------------------------------
# JSON round trip: m3dcal writes, imaging commands read
# ---------------------------------------------------------------------------


def _c_pair(z) -> list:
    return [float(complex(z).real), float(complex(z).imag)]


def model_to_json(model) -> dict:
    """Serializable dict for a calibrated M3D model — the contract between
    ``m3dcal --out`` and the imaging commands' ``--m3d`` flag. Complex
    numbers become [re, im] pairs (JSON has no complex type)."""
    if isinstance(model, EdgeKernelM3D):
        return {
            "model": f"edge_kernel_k{model.k}",
            "width_nm": float(model.width_nm),
            "taps_v_rise": [_c_pair(c) for c in model.taps_v_rise],
            "taps_v_fall": [_c_pair(c) for c in model.taps_v_fall],
            "taps_h_rise": [_c_pair(c) for c in model.taps_h_rise],
            "taps_h_fall": [_c_pair(c) for c in model.taps_h_fall],
        }
    if isinstance(model, BoundaryLayer):
        out = {
            "model": "boundary_layer",
            "width_nm": float(model.width_nm),
            "beta_h": _c_pair(model.beta_h),
            "beta_v": _c_pair(model.beta_v),
        }
        if model.beta_h_asym or model.beta_v_asym:
            out["beta_h_asym"] = _c_pair(model.beta_h_asym)
            out["beta_v_asym"] = _c_pair(model.beta_v_asym)
        return out
    raise TypeError(f"not an M3D model: {type(model).__name__}")


def model_from_json(obj) -> "BoundaryLayer | EdgeKernelM3D":
    """Rebuild a :class:`BoundaryLayer` / :class:`EdgeKernelM3D` from the
    ``m3dcal`` output JSON (a dict, a JSON string, or a file path). Extra
    keys (the calibration report: NRMS tables, stack name, timings) are
    ignored, so the whole m3dcal stdout line round-trips."""
    import json as _json
    import os as _os

    if isinstance(obj, (str, _os.PathLike)):
        s = _os.fspath(obj)
        if _os.path.exists(s):
            with open(s) as fh:
                obj = _json.load(fh)
        else:
            obj = _json.loads(s)
    if not isinstance(obj, dict) or "model" not in obj:
        raise ValueError("expected an m3dcal JSON object with a 'model' key")

    def _z(pair) -> complex:
        return complex(float(pair[0]), float(pair[1]))

    kind = str(obj["model"])
    width = float(obj.get("width_nm", 8.0))
    if kind.startswith("edge_kernel"):
        return EdgeKernelM3D(
            width_nm=width,
            taps_v_rise=tuple(_z(p) for p in obj["taps_v_rise"]),
            taps_v_fall=tuple(_z(p) for p in obj["taps_v_fall"]),
            taps_h_rise=tuple(_z(p) for p in obj["taps_h_rise"]),
            taps_h_fall=tuple(_z(p) for p in obj["taps_h_fall"]),
        )
    if kind == "boundary_layer":
        return BoundaryLayer(
            width_nm=width,
            beta_h=_z(obj.get("beta_h", (0.0, 0.0))),
            beta_v=_z(obj.get("beta_v", (0.0, 0.0))),
            beta_h_asym=_z(obj.get("beta_h_asym", (0.0, 0.0))),
            beta_v_asym=_z(obj.get("beta_v_asym", (0.0, 0.0))),
        )
    raise ValueError(f"unknown M3D model kind {kind!r}")
