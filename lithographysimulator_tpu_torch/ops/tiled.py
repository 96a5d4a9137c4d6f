"""Tiled full-chip imaging: arbitrarily large masks through fixed-size optics.

Port of ``lithographysimulator_tpu/ops/tiled.py``. Imaging is local: the
coherent point-spread functions decay over a few lambda/NA, so the chip is
cut into overlapping tiles, each imaged under the tile-sized optics, and
only the halo-free tile cores are stitched into the output. Tile (i, j)'s
window starts at ``(i*step, j*step)`` of the chip zero-padded by ``halo``
below and ``tiles*step + halo - M + (n - step)`` above, and its core is
``[halo:halo+step]`` of the tile image.

A tile is a slice of the padded chip on the kernels' device, then the
thick-mask model (``mask3d.apply``), the spectrum, the port's
:func:`.hopkins.socs_image` (on CUDA the four int8 kernels) and a crop
into the stitched image. The kernel set is built once for the tile optics
and serves every tile; memory stays O(tile^2) above the chip itself.
``tiles_per_dispatch`` is the number of tiles handled together: the
streaming path reads that many windows from the host per upload, and
``progress_cb`` reports once per group, after a synchronize (the JAX
package's ``block_until_ready``). It changes no value.

While a profiler trace records, :func:`tiled_socs_image` marks its call
(``litho.tiled``), the padding (``.pad``), each tile from its window to its
stitched core (``.tile``: the host's enqueue of a tile) and the final crop
(``.finish``); every tiled path marks a tile's spectrum and apply
(``litho.tiled.tile.spectrum``, ``.apply``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._spans import span
from .._tensors import to_tensor
from ..config import OpticsConfig
from .fraunhofer import mask_spectrum
from .hopkins import SOCSKernels, socs_image


def default_halo(config: OpticsConfig, *, wavelengths: float = 8.0) -> int:
    """Halo in pixels covering ``wavelengths`` * lambda/NA of optical
    interaction distance (rounded up to a multiple of 8), clamped so the
    tile (``config.n``) keeps a core of at least 8 px. Pass ``halo``
    explicitly to override (larger halos need a larger tile)."""
    distance_nm = wavelengths * config.wavelength / config.na
    px = math.ceil(distance_nm / config.pixel_size)
    halo = ((px + 7) // 8) * 8
    max_halo = ((config.n - 8) // 2) // 8 * 8
    return max(0, min(halo, max_halo))


def tile_layout(big_n: int, tile_n: int, halo: int):
    """Number of tile steps per axis and the core (stitched) step size."""
    step = tile_n - 2 * halo
    if step <= 0:
        raise ValueError(f"halo {halo} too large for tile size {tile_n}")
    tiles = math.ceil(big_n / step)
    return tiles, step


def _check_mask3d_halo(mask3d, halo: int) -> None:
    """Per-window mask3d application is only exact when the apply stencil
    (1 px for BoundaryLayer, k+1 px for EdgeKernelM3D) lies inside the
    cropped halo; otherwise the roll wraparound from a window edge leaks
    into the kept tile core."""
    if mask3d is None:
        return
    stencil = getattr(mask3d, "k", 0) + 1
    if halo < stencil:
        raise ValueError(
            f"halo {halo} is smaller than the mask3d apply stencil "
            f"({stencil} px): per-tile thick-mask application would wrap "
            f"tap contributions into the kept core. Use halo >= {stencil}.")


def _layout(big_n: int, tile_config: OpticsConfig, halo, mask3d):
    """(halo, tiles, step) of a chip, with the halo defaulted and checked."""
    if halo is None:
        halo = default_halo(tile_config)
    tiles, step = tile_layout(big_n, tile_config.n, halo)
    _check_mask3d_halo(mask3d, halo)
    return halo, tiles, step


def chip_tensor(mask_big, device) -> torch.Tensor:
    """The chip on ``device``: complex64 if it is complex (an effective
    thick-mask or phase-shift mask), else float32."""
    complex_ = (mask_big.is_complex() if isinstance(mask_big, torch.Tensor)
                else np.iscomplexobj(mask_big))
    return to_tensor(mask_big, device=device,
                     dtype=torch.complex64 if complex_ else torch.float32)


def _padded_chip(mask_big, n: int, halo: int, tiles: int, step: int,
                 device) -> torch.Tensor:
    """:func:`chip_tensor`, zero-padded so every tile window ``[t*step,
    t*step + n)`` of the result is in range."""
    chip = chip_tensor(mask_big, device)
    pad_hi = tiles * step + halo - chip.shape[-1] + (n - step)
    return torch.nn.functional.pad(chip, (halo, pad_hi, halo, pad_hi))


def _groups(tiles: int, tiles_per_dispatch: int) -> list:
    """Row-major tile coordinates, in groups of ``tiles_per_dispatch``."""
    coords = [(i, j) for i in range(tiles) for j in range(tiles)]
    k = max(1, min(tiles_per_dispatch, len(coords)))
    return [coords[s:s + k] for s in range(0, len(coords), k)]


def _spectrum(window: torch.Tensor, tile_config, spectrum_solver, mask3d):
    """A tile window's spectrum, through the thick-mask model if any."""
    if mask3d is not None:
        window = mask3d.apply(window, tile_config)
    return mask_spectrum(window, tile_config, solver=spectrum_solver)


def _core(window: torch.Tensor, socs: SOCSKernels, tile_config, halo: int,
          step: int, *, solver, chunk, engine, spectrum_solver, mask3d
          ) -> torch.Tensor:
    """One tile: (n, n) mask window -> (step, step) image core."""
    with span("litho.tiled.tile.spectrum"):
        spectrum = _spectrum(window, tile_config, spectrum_solver, mask3d)
    with span("litho.tiled.tile.apply"):
        img = socs_image(spectrum, socs, tile_config, solver=solver,
                         chunk=chunk, engine=engine)
    return img[halo:halo + step, halo:halo + step]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tiled_socs_image(
    mask_big,
    socs: SOCSKernels,
    tile_config: OpticsConfig,
    *,
    halo: int | None = None,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    spectrum_solver: str = "gau23",
    tiles_per_dispatch: int = 8,
    progress_cb=None,
    mask3d=None,
) -> torch.Tensor:
    """(M, M) float32 aerial image of an arbitrarily large mask, tile by
    tile, on the kernels' device (a host mask is moved there).
    ``progress_cb(fraction)`` (optional) is called after each group of
    ``tiles_per_dispatch`` tiles, once the device has finished it.

    ``socs`` must be built for ``tile_config`` (same optics every tile). The
    mask is zero-padded outside its boundary; each tile's core (tile minus
    halo ring) lands in the output."""
    device = socs.kernels.device
    big_n = mask_big.shape[-1]
    n = tile_config.n
    halo, tiles, step = _layout(big_n, tile_config, halo, mask3d)
    with span("litho.tiled"):
        with span("litho.tiled.pad"):
            padded = _padded_chip(mask_big, n, halo, tiles, step, device)
        out = torch.empty((tiles * step, tiles * step), dtype=torch.float32,
                          device=device)
        groups = _groups(tiles, tiles_per_dispatch)
        for gi, group in enumerate(groups):
            for i, j in group:
                with span("litho.tiled.tile"):
                    out[i * step:(i + 1) * step, j * step:(j + 1) * step] = _core(
                        padded[i * step:i * step + n, j * step:j * step + n],
                        socs, tile_config, halo, step, solver=solver,
                        chunk=chunk, engine=engine,
                        spectrum_solver=spectrum_solver, mask3d=mask3d)
            if progress_cb is not None:
                _sync(device)
                progress_cb((gi + 1) / len(groups))
        with span("litho.tiled.finish"):
            return out[:big_n, :big_n].contiguous()


def tiled_socs_image_stream(
    window_fn,
    big_n: int,
    socs: SOCSKernels,
    tile_config: OpticsConfig,
    *,
    halo: int | None = None,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    spectrum_solver: str = "gau23",
    tiles_per_dispatch: int = 8,
    mask3d=None,
) -> torch.Tensor:
    """(M, M) aerial image of a chip that never exists as one array, on
    the kernels' device.

    ``window_fn(row0, col0) -> (n, n) float32`` supplies the mask window
    whose low corner sits at CHIP pixel (row0, col0); both may be negative
    (halo outside the chip: return zeros there). The windows of a group of
    ``tiles_per_dispatch`` tiles are read on the host and uploaded in one
    copy, so memory beyond the output is O(tiles_per_dispatch * n^2)."""
    device = socs.kernels.device
    n = tile_config.n
    halo, tiles, step = _layout(big_n, tile_config, halo, mask3d)
    out = torch.empty((tiles * step, tiles * step), dtype=torch.float32,
                      device=device)
    for group in _groups(tiles, tiles_per_dispatch):
        windows = torch.as_tensor(np.stack([
            np.asarray(window_fn(i * step - halo, j * step - halo), np.float32)
            for i, j in group]), device=device)
        for (i, j), window in zip(group, windows):
            out[i * step:(i + 1) * step, j * step:(j + 1) * step] = _core(
                window, socs, tile_config, halo, step, solver=solver,
                chunk=chunk, engine=engine, spectrum_solver=spectrum_solver,
                mask3d=mask3d)
    return out[:big_n, :big_n].contiguous()


def tiled_socs_image_field(
    mask_big,
    tile_config: OpticsConfig,
    source_map,
    aberrations_fn,
    *,
    field_points: int = 3,
    rank: int = 64,
    halo: int | None = None,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    spectrum_solver: str = "gau23",
    tiles_per_dispatch: int = 8,
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    blend: str = "linear",
    mask3d=None,
    device=None,
) -> torch.Tensor:
    """Full-chip image under FIELD-DEPENDENT aberrations, on ``device``
    (a tensor ``mask_big`` defaults it to its own). ``aberrations_fn(fx,
    fy) -> OSA coefficient vector`` gives the wavefront at normalized field
    position (fx, fy) in [-1, 1]^2 (chip center = (0, 0)).

    The field is sampled on a ``field_points`` ^2 grid and one SOCS kernel
    set is built per sample that some tile references, so the build cost
    is O(field_points^2), not O(tiles^2). ``field_points=1`` reduces
    exactly to :func:`tiled_socs_image` with center aberrations.

    ``blend``: ``"linear"`` (default) images each tile as the
    separable-linear interpolation of its (up to 4) surrounding samples'
    images, so printed CDs vary continuously across the chip; ``"nearest"``
    gives each tile one kernel set (exact distance ties break toward the
    field center, keeping the assignment mirror-symmetric).

    ``polarization``/``apodize`` switch the per-sample builds to the
    polarized vector build and ``chromatic`` (a
    :class:`..config.LaserSpectrum`) to the polychromatic build; both
    compose. Weighted cores accumulate on the device in the JAX package's
    order and float32 weights."""
    from ..models.pupil import pupil_function
    from ..simulate import _channel_rotation_cached, _socs_build

    if blend not in ("linear", "nearest"):
        raise ValueError(f"unknown blend mode {blend!r}")
    if device is None and isinstance(mask_big, torch.Tensor):
        device = mask_big.device
    if device is None:
        raise ValueError("host data needs an explicit device= (e.g. 'cuda' or 'cpu')")
    device = torch.device(device)
    big_n = mask_big.shape[-1]
    n = tile_config.n
    halo, tiles, step = _layout(big_n, tile_config, halo, mask3d)
    padded = _padded_chip(mask_big, n, halo, tiles, step, device)

    if field_points < 1:
        raise ValueError("field_points must be >= 1")
    centers = (np.linspace(-1.0, 1.0, field_points + 2)[1:-1]
               if field_points > 1 else np.zeros(1))
    tile_centers = ((np.arange(tiles) + 0.5) * step / big_n) * 2.0 - 1.0

    def axis_weights(tc: float) -> list[tuple[int, float]]:
        """Per-axis (sample index, weight) pairs for one tile center."""
        if blend == "nearest" or len(centers) == 1:
            d = np.abs(tc - centers) + 1e-9 * np.abs(centers)
            return [(int(d.argmin()), 1.0)]
        if tc <= centers[0]:
            return [(0, 1.0)]
        if tc >= centers[-1]:
            return [(len(centers) - 1, 1.0)]
        i1 = int(np.searchsorted(centers, tc))
        i0 = i1 - 1
        a = float((tc - centers[i0]) / (centers[i1] - centers[i0]))
        if a < 1e-9:
            return [(i0, 1.0)]
        if a > 1.0 - 1e-9:
            return [(i1, 1.0)]
        return [(i0, 1.0 - a), (i1, a)]

    per_tile = [axis_weights(float(tc)) for tc in tile_centers]
    # (sample_iy, sample_ix) -> [(ti, tj, weight)]; only referenced samples
    # get a kernel build
    groups: dict = {}
    for ti in range(tiles):
        for tj in range(tiles):
            for iy, wy in per_tile[ti]:
                for ix, wx in per_tile[tj]:
                    groups.setdefault((iy, ix), []).append((ti, tj, wy * wx))

    rot = _channel_rotation_cached(tile_config, polarization, apodize,
                                   chromatic, str(device))
    src = to_tensor(np.asarray(source_map, np.float32), device=device)
    out = torch.zeros((tiles, tiles, step, step), dtype=torch.float32,
                      device=device)
    for (i, j), members in groups.items():
        coeffs = np.asarray(aberrations_fn(float(centers[j]),
                                           float(centers[i])), np.float32)
        socs = _socs_build(tile_config, rank, coeffs, src,
                           pupil_function(coeffs, tile_config, device=device),
                           polarization=polarization, apodize=apodize,
                           chromatic=chromatic, rot=rot)
        weights = np.asarray(members, np.float64)[:, 2].astype(np.float32)
        for (ti, tj, _), w in zip(members, weights):
            core = _core(padded[ti * step:ti * step + n, tj * step:tj * step + n],
                         socs, tile_config, halo, step, solver=solver,
                         chunk=chunk, engine=engine,
                         spectrum_solver=spectrum_solver, mask3d=mask3d)
            out[ti, tj] += float(w) * core
        del socs
    stitched = out.permute(0, 2, 1, 3).reshape(tiles * step, tiles * step)
    return stitched[:big_n, :big_n].contiguous()


def array_window_fn(mask_big, n: int):
    """A ``window_fn`` over an in-memory chip array (zero-padded outside):
    the streaming path's reference provider. ``n`` is the tile size."""
    if isinstance(mask_big, torch.Tensor):
        mask_big = mask_big.detach().cpu().numpy()
    mask_big = np.asarray(mask_big, np.float32)
    big_n = mask_big.shape[-1]

    def window_fn(row0: int, col0: int) -> np.ndarray:
        out = np.zeros((n, n), np.float32)
        r_lo, r_hi = max(row0, 0), min(row0 + n, big_n)
        c_lo, c_hi = max(col0, 0), min(col0 + n, big_n)
        if r_lo < r_hi and c_lo < c_hi:
            out[r_lo - row0:r_hi - row0, c_lo - col0:c_hi - col0] = \
                mask_big[r_lo:r_hi, c_lo:c_hi]
        return out

    return window_fn


def tiled_film_stack(
    mask_big,
    kernels: list,
    tile_config: OpticsConfig,
    *,
    source_total=None,
    normalize: bool = True,
    halo: int | None = None,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    spectrum_solver: str = "gau23",
    tiles_per_dispatch: int = 8,
    progress_cb=None,
    mask3d=None,
) -> torch.Tensor:
    """(nz, M, M) rigorous in-film exposure of an arbitrarily large mask,
    on the kernels' device: the full-chip counterpart of
    :func:`..simulate.film_socs_stack`. Each tile window's spectrum is
    taken once and imaged with every slab's film-SOCS kernel set
    (:func:`..simulate.film_socs_kernels`); the halo-free cores are
    stitched per slab. The slabs' kernels are used where they lie, one copy
    (an 8-slab rank-96 set is 6.4 GB at 1024^2), never stacked.

    ``normalize=True`` needs ``source_total`` (sum of source weights), the
    exact path's scaling, as ``film_socs_stack``. Feed the stack to
    :meth:`..models.resist.DepthResist.develop_profile` (on a
    ``.rigorous()`` instance) for the full-chip 3-D develop."""
    from ..simulate import _normalized

    if not kernels:
        raise ValueError("kernels must be a non-empty list of per-slab "
                         "SOCSKernels (see film_socs_kernels)")
    if normalize and source_total is None:
        raise ValueError("normalize=True needs source_total (sum of source "
                         "weights) to match the exact path's scaling")
    shapes = {tuple(s.kernels.shape) for s in kernels}
    if len(shapes) != 1:
        raise ValueError(f"per-slab kernel sets must share one shape, got "
                         f"{sorted(shapes)}")
    device = kernels[0].kernels.device
    big_n = mask_big.shape[-1]
    n = tile_config.n
    halo, tiles, step = _layout(big_n, tile_config, halo, mask3d)
    padded = _padded_chip(mask_big, n, halo, tiles, step, device)
    total = float(source_total) if source_total is not None else 1.0
    out = torch.empty((len(kernels), tiles * step, tiles * step),
                      dtype=torch.float32, device=device)
    groups = _groups(tiles, tiles_per_dispatch)
    for gi, group in enumerate(groups):
        for i, j in group:
            spectrum = _spectrum(
                padded[i * step:i * step + n, j * step:j * step + n],
                tile_config, spectrum_solver, mask3d)
            for z, socs in enumerate(kernels):
                img = socs_image(spectrum, socs, tile_config, solver=solver,
                                 chunk=chunk, engine=engine)
                if normalize:
                    img = _normalized(img, total)
                out[z, i * step:(i + 1) * step, j * step:(j + 1) * step] = \
                    img[halo:halo + step, halo:halo + step]
        if progress_cb is not None:
            _sync(device)
            progress_cb((gi + 1) / len(groups))
    return out[:, :big_n, :big_n].contiguous()


def tiled_socs_image_scan(
    mask_big,
    socs: SOCSKernels,
    tile_config: OpticsConfig,
    *,
    halo: int | None = None,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    spectrum_solver: str = "gau23",
    mask3d=None,
) -> torch.Tensor:
    """:func:`tiled_socs_image` with every tile in one group: the JAX
    package's single-dispatch ``lax.map`` variant. The same loop, so the
    same image."""
    _, tiles, _ = _layout(mask_big.shape[-1], tile_config, halo, mask3d)
    return tiled_socs_image(mask_big, socs, tile_config, halo=halo,
                            solver=solver, chunk=chunk, engine=engine,
                            spectrum_solver=spectrum_solver,
                            tiles_per_dispatch=tiles * tiles, mask3d=mask3d)
