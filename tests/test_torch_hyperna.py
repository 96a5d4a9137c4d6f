"""Hyper-NA immersion imaging in the port: the pupil's edge at NA/lambda
(``OpticsConfig.pupil_at_na``), and the polarized exact image against the
plain float64 vector reference of the benchmark
(``litho_bench/reference/vector.py``, which imports nothing of the port).

The reference's optics are those of the benchmark's ``arfi1024``
configuration (ArF water immersion at NA 1.35, a y-polarized x dipole,
9 nm pixels), here at 64^2 and 128^2."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu_torch.ops import abbe as pa
from lithographysimulator_tpu_torch.ops import vector as pv
from lithographysimulator_tpu_torch.grid import Grid
from lithographysimulator_tpu_torch.ops.fraunhofer import (_dft_kernel_cached,
                                                          trapezoid_weights)
from lithographysimulator_tpu_torch.utils import config_fingerprint, profiling
from litho_bench import judge, masks
from litho_bench.reference import optics as ro
from litho_bench.reference import vector as rv

ROOT = Path(__file__).resolve().parents[1]
ARFI = json.loads((ROOT / "litho_bench" / "configs" / "arfi1024.json").read_text())
LAYOUT = {"block_px": 32, "min_px": 4, "max_width_px": 6, "max_space_px": 8,
          "max_contact_px": 8}
# The port's CPU engine transforms each field with complex64 FFTs (a unit
# roundoff of 6e-8); summed over the source points its image lies a few
# 1e-8 of the peak from the float64 reference (3e-8-4e-8 at these sizes,
# 1.1e-8-1.7e-8 above the band). The tolerances leave ten times that,
# and sit five decades under what the left-out z component, the 1/lambda
# pupil edge or the scalar image read (above 1e-2).
IMAGE_TOL = 5e-7
BAND_TOL = 2e-7


def _cfg(n: int, **kw) -> dict:
    return dict(ARFI, pixel_number=n, layout=LAYOUT, **kw)


def _optics(cfg: dict, **kw) -> pt.OpticsConfig:
    args = dict(pixel_number=cfg["pixel_number"], pixel_size=cfg["pixel_nm"],
                wavelength=cfg["wavelength_nm"], na=cfg["na"],
                immersion_index=cfg["immersion_index"],
                pupil_at_na=cfg["pupil_at_na"])
    return pt.OpticsConfig(**{**args, **kw})


def _geometry(n: int, seed: int = 5) -> torch.Tensor:
    return masks.layouts(seed, 0, 1, n, LAYOUT, device="cpu")[0]


def _program(cfg: dict, geometry, polarization="y", **optics_kw):
    oc = _optics(cfg, **optics_kw)
    return pt.simulate(pt.Mask(geometry=geometry, config=oc),
                       rv.dipole_source(cfg),
                       np.asarray(cfg["aberrations_osa"], np.float32),
                       solver="gau23", polarization=polarization,
                       apodize=cfg["apodize"], device="cpu")


def _errors(cfg, image, ref) -> tuple[float, float]:
    return ro.nrms(image, ref), judge.broadband(cfg, image, ref)


def _grating_modulation(pitch_px: int, pupil_at_na: bool) -> float:
    """Modulation of the coherent (one on-axis point) image of a 1:1
    vertical grating of ``pitch_px`` 10 nm pixels at NA 0.7."""
    n = 240
    cfg = pt.OpticsConfig(pixel_number=n, pixel_size=10.0, wavelength=193.0,
                          na=0.7, pupil_at_na=pupil_at_na)
    x = np.arange(n)
    geom = np.broadcast_to(((x % pitch_px) < pitch_px // 2).astype(np.float32),
                           (n, n))
    src = np.zeros((n, n), np.float32)
    src[n // 2, n // 2] = 1.0
    img = pt.simulate(pt.Mask(geometry=torch.as_tensor(geom.copy()), config=cfg),
                      src, device="cpu").image
    core = img[n // 4:3 * n // 4, n // 4:3 * n // 4].double()
    hi, lo = float(core.max()), float(core.min())
    return (hi - lo) / (hi + lo)


def test_the_pupil_edge_moves_the_grating_cutoff_to_lambda_over_na():
    """A coherent grating images only while its first order passes the
    pupil: pitch above lambda / pupil_na. At NA 0.7 that is 275.7 nm with
    the edge at NA/lambda and 193 nm without it. A 240 nm grating images
    without the edge and not with it (what is left, under 0.25, is the
    finite grating's leakage); 320 nm images either way."""
    assert _grating_modulation(24, True) < 0.3
    assert _grating_modulation(32, True) > 0.99
    assert _grating_modulation(24, False) > 0.99


def test_the_default_convention_is_unchanged_bit_for_bit():
    """``pupil_at_na`` False (the default) keeps beta, the direct solver's
    phase and every image as they were; True divides beta by NA."""
    for kw in (dict(), dict(pixel_number=128, pixel_size=9.0, na=1.35,
                            immersion_index=1.437)):
        base = pt.OpticsConfig(**kw)
        assert base == pt.OpticsConfig(**kw, pupil_at_na=False)
        assert base.wavelength_scaling().beta == (
            base.wavelength / (base.delta_k * base.pixel_size))
        na_edge = pt.OpticsConfig(**kw, pupil_at_na=True)
        assert na_edge.wavelength_scaling().beta == (
            base.wavelength / (base.na * base.delta_k * base.pixel_size))
        grid = Grid(base)
        old = (np.exp(2j * np.pi / base.wavelength * grid.k[:, None]
                      * grid.x[None, :]) * trapezoid_weights(base.n)[None, :])
        np.testing.assert_array_equal(_dft_kernel_cached(base, 1), old)
        # file caches keep the two conventions apart
        assert config_fingerprint(base) != config_fingerprint(na_edge)
    cfg = _cfg(64)
    g = _geometry(64)
    default = pt.OpticsConfig(pixel_number=64, pixel_size=cfg["pixel_nm"],
                              na=cfg["na"], immersion_index=cfg["immersion_index"])
    for solver in ("gau23", "direct"):
        images = [pt.simulate(pt.Mask(geometry=g, config=oc),
                              rv.dipole_source(cfg), solver=solver,
                              polarization="y", device="cpu").image
                  for oc in (default, _optics(cfg, pupil_at_na=False))]
        assert torch.equal(images[0], images[1])


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("polarization", ["y", "x", "unpolarized"])
def test_vector_exact_image_matches_the_plain_reference(n, polarization):
    cfg = _cfg(n)
    g = _geometry(n)
    result = _program(cfg, g, polarization)
    assert result.report["pupil_edge"] == "NA/wavelength"
    ref = rv.image(g, rv.dipole_source(cfg), cfg, polarization)
    image_nrms, band = _errors(cfg, result.image, ref)
    assert image_nrms < IMAGE_TOL and band < BAND_TOL


@pytest.mark.parametrize("n", [64, 128])
def test_dropping_z_the_na_edge_or_the_vector_model_fails(n):
    """At the tolerances above, the image with its z component left out,
    the image with the pupil's edge at 1/lambda, and the scalar image each
    fail against the reference."""
    cfg = _cfg(n)
    g = _geometry(n)
    ref = rv.image(g, rv.dipole_source(cfg), cfg, "y")
    oc = _optics(cfg)
    pts = pa.source_points(rv.dipole_source(cfg))
    shifts, weights = pa._pad_points(pts.shifts, pts.weights, 4)
    spec = pt.mask_spectrum(g, oc)
    pupil = pt.pupil_function(np.asarray(cfg["aberrations_osa"], np.float32), oc,
                              device="cpu")
    comps = pv.vector_pupils(pupil, oc, (0.0, 1.0), apodize=True)
    no_z = sum(pa.abbe_image_points(spec, comps[c], shifts, weights, oc,
                                    device="cpu") for c in (0, 1))
    controls = {"no z": no_z,
                "1/lambda edge": _program(cfg, g, pupil_at_na=False).image,
                "scalar": _program(cfg, g, polarization=None).image}
    for name, image in controls.items():
        image_nrms, band = _errors(cfg, image, ref)
        assert image_nrms > 100 * IMAGE_TOL, name


def test_the_reference_field_sum_is_the_scalar_references_fft():
    """At the scalar limit of the vector factors (NA -> 0, no
    apodization; y and z then carry 1e-18 of x's power), the reference's
    field sum over the disk's box equals the scalar reference's padded-FFT
    exact image."""
    cfg = dict(_cfg(64), na=1e-9, pupil_at_na=False, apodize=False)
    g = _geometry(64)
    src = rv.dipole_source(_cfg(64))
    ours = rv.image(g, src, cfg, "x")
    plain = ro.abbe_image(ro.spectrum(g, cfg), ro.pupil(cfg, device="cpu"),
                          src, cfg)
    assert ro.nrms(ours, plain) < 1e-12


def test_spans_and_the_field_counter_are_recorded():
    """Under a trace: one ``litho.vector.component`` span a pass (state
    and component), a ``litho.abbe.setup`` span inside each windowed pass,
    and the ``abbe.fields`` tally of every field computed."""
    cfg = dict(_cfg(64), illumination=dict(ARFI["illumination"], sigma_out=0.85))
    oc = _optics(cfg)
    pts = pa.source_points(rv.dipole_source(cfg))
    shifts, weights = pa._pad_points(pts.shifts, pts.weights, 4)
    assert np.abs(shifts).max() <= 64 // 4 - 2  # the windowed path
    spec = pt.mask_spectrum(_geometry(64), oc)
    pupil = pt.pupil_function(np.zeros(10, np.float32), oc, device="cpu")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        pv.vector_abbe_image(spec, pupil, shifts, weights, oc, device="cpu",
                             polarization="unpolarized", engine="int8")
    rec = profiling.recording()
    passes = [s for s in rec["spans"] if s["name"] == "litho.vector.component"]
    assert [(s["attrs"]["state"], s["attrs"]["component"]) for s in passes] == [
        (p, c) for p in (0, 1) for c in (0, 1, 2)]
    setups = [s for s in rec["spans"] if s["name"] == "litho.abbe.setup"]
    assert len(setups) == 6
    by_id = {s["id"]: s for s in rec["spans"]}
    assert all(by_id[s["parent"]]["name"] == "litho.vector.component"
               for s in setups)
    assert rec["counters"]["abbe.fields"] == 6 * len(shifts)
