"""Port parity: the port's own copies of the RCWA solvers (ops/rcwa.py,
ops/rcwa2d.py) against the JAX package's modules, on the cases of
test_rcwa.py, test_rcwa_conical.py and test_rcwa2d.py.

Both sides are host numpy complex128 on the same inputs, so every output is
held equal bit for bit (assert_array_equal), not to a tolerance."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu.ops import rcwa as jr
from lithographysimulator_tpu.ops import rcwa2d as jr2
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import rcwa as pr
from lithographysimulator_tpu_torch.ops import rcwa2d as pr2

LAM = 193.0
FILMS = [(20.0, 1.965 + 1.201j), (68.0, 0.842 + 1.647j), (35.0, 1.44 + 0j)]
EUV_CFG = jt.OpticsConfig(pixel_number=64, wavelength=13.5, na=0.33,
                          pixel_size=4.0)


def _equal(a, b) -> None:
    """Same dataclass fields, or the same arrays, bit for bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _layers(mod, spec):
    return [mod.GratingLayer(*args, **kw) for args, kw in spec]


def _layers2d(mod, spec):
    return [mod.PatternedLayer(*args, **kw) for args, kw in spec]


ABSORBER = [((80.0, 0.9 + 1.7j), dict(duty=0.45))]
HOMOGENEOUS = [((d, 2.0, n, 0.0), {}) for d, n in FILMS]
LOSSLESS = [((150.0, 2.1, 1.0, 0.45), {})]
EUV_LINE = [((60.0, 0.926 + 0.044j), dict(duty=0.5))]

PLANAR = {
    "homogeneous-te-0": (600.0, HOMOGENEOUS, dict(pol="te", n_super=1.5631,
                                                  n_sub=1.0, theta_deg=0.0,
                                                  n_harmonics=11)),
    "homogeneous-tm-23": (600.0, HOMOGENEOUS, dict(pol="tm", n_super=1.5631,
                                                   n_sub=1.0, theta_deg=23.0,
                                                   n_harmonics=11)),
    "lossless-te": (800.0, LOSSLESS, dict(pol="te", n_super=1.5, n_sub=1.0,
                                          theta_deg=8.0, n_harmonics=41)),
    "lossless-tm": (800.0, LOSSLESS, dict(pol="tm", n_super=1.5, n_sub=1.0,
                                          theta_deg=8.0, n_harmonics=41)),
    "absorber-tm-20": (600.0, ABSORBER, dict(pol="tm", n_super=1.5,
                                             theta_deg=20.0)),
}


@pytest.mark.parametrize("case", sorted(PLANAR))
def test_rcwa_orders_equal_jax(case):
    period, spec, kw = PLANAR[case]
    _equal(pr.rcwa_orders(period, _layers(pr, spec), LAM, **kw),
           jr.rcwa_orders(period, _layers(jr, spec), LAM, **kw))


CONICAL = {
    "planar-s-20": (600.0, ABSORBER, 193.0, dict(n_super=1.5, theta_deg=20.0,
                                                 phi_deg=0.0, psi_deg=90.0)),
    "lossless-37": (800.0, LOSSLESS, 193.0, dict(n_super=1.5, theta_deg=25.0,
                                                 phi_deg=55.0, psi_deg=37.0,
                                                 n_harmonics=41)),
    "euv-along-lines": (540.0, EUV_LINE, 13.5, dict(theta_deg=6.0,
                                                    phi_deg=90.0, psi_deg=0.0,
                                                    n_harmonics=21)),
}


@pytest.mark.parametrize("case", sorted(CONICAL))
def test_rcwa_orders_conical_equal_jax(case):
    period, spec, lam, kw = CONICAL[case]
    _equal(pr.rcwa_orders_conical(period, _layers(pr, spec), lam, **kw),
           jr.rcwa_orders_conical(period, _layers(jr, spec), lam, **kw))


CROSSED = {
    "y-uniform": ((600.0, 500.0), [((80.0,), dict(
        n_fill=1.0, n_box=0.9 + 1.7j, boxes=((0.2, 0.0, 0.65, 1.0),)))],
        dict(n_super=1.5, theta_deg=17.0, phi_deg=35.0, psi_deg=55.0,
             mx_max=5, my_max=3)),
    "homogeneous": ((600.0, 500.0), [((55.0,), dict(n_fill=1.4 + 0.2j)),
                                     ((30.0,), dict(n_fill=2.0 + 0.0j))],
                    dict(n_super=1.5, n_sub=1.2, theta_deg=33.0, phi_deg=40.0,
                         psi_deg=90.0, mx_max=2, my_max=2)),
    "crossed": ((500.0, 450.0), [((100.0,), dict(
        n_fill=1.0, n_box=2.1, boxes=((0.1, 0.1, 0.6, 0.55),)))],
        dict(n_super=1.5, theta_deg=14.0, phi_deg=25.0, psi_deg=40.0,
             mx_max=4, my_max=4)),
}


@pytest.mark.parametrize("case", sorted(CROSSED))
def test_rcwa2d_orders_equal_jax(case):
    (px, py), spec, kw = CROSSED[case]
    _equal(pr2.rcwa2d_orders(px, py, _layers2d(pr2, spec), LAM, **kw),
           jr2.rcwa2d_orders(px, py, _layers2d(jr2, spec), LAM, **kw))


@pytest.mark.parametrize("pol,theta", [("te", 0.0), ("tm", 23.0)])
def test_transfer_matrix_stack_equal_jax(pol, theta):
    args = ([n for _, n in FILMS], [d for d, _ in FILMS], LAM)
    kw = dict(pol=pol, n_super=1.5631, n_sub=1.0, theta_deg=theta)
    _equal(pr.transfer_matrix_stack(*args, **kw),
           jr.transfer_matrix_stack(*args, **kw))


@pytest.mark.parametrize("stack,lam,deg", [("binary_cr", 193.0, 0.0),
                                           ("att_psm_mosi", 193.0, 0.0),
                                           ("euv_ta", 13.5, 6.0)])
def test_thin_mask_transmission_equal_jax(stack, lam, deg):
    assert (pr.thin_mask_transmission(stack, lam, incidence_deg=deg)
            == jr.thin_mask_transmission(stack, lam, incidence_deg=deg))
    _equal(pr.resolve_stack(stack, lam), jr.resolve_stack(stack, lam))


EFFECTIVE = {
    "binary-te": (jt.OpticsConfig(pixel_number=64),
                  dict(pitch_px=16, duty=7 / 16, pol="te")),
    "binary-tm-axis0": (jt.OpticsConfig(pixel_number=64),
                        dict(pitch_px=16, duty=7 / 16, pol="tm", axis=0)),
    "psm-clear": (jt.OpticsConfig(pixel_number=32),
                  dict(pitch_px=16, duty=0.0, stack="att_psm_mosi")),
    "euv-6deg": (EUV_CFG, dict(pitch_px=16, duty=7 / 16, stack="euv_ta",
                               pol="te", incidence_deg=6.0)),
    "euv-conical": (EUV_CFG, dict(pitch_px=16, duty=7 / 16, stack="euv_ta",
                                  pol="tm", incidence_deg=6.0,
                                  azimuth_deg=90.0)),
}


@pytest.mark.parametrize("case", sorted(EFFECTIVE))
def test_rcwa_effective_mask_equal_jax(case):
    cfg, kw = EFFECTIVE[case]
    _equal(pr.rcwa_effective_mask(config_from_jax(cfg), **kw),
           jr.rcwa_effective_mask(cfg, **kw))


def test_rcwa2d_effective_mask_and_boxes_geometry_equal_jax():
    """The line-end fixture of test_mask3d_2d.py at DUV normal incidence,
    and its drawn layout (binary and attenuated)."""
    cfg = jt.OpticsConfig(pixel_number=32)
    boxes = ((0.28125, 0.0, 0.71875, 0.53125),)
    kw = dict(boxes=boxes, pitch_x_px=16, pol="y", mx_max=3, my_max=3)
    _equal(pr2.rcwa2d_effective_mask(config_from_jax(cfg), **kw),
           jr2.rcwa2d_effective_mask(cfg, **kw))
    for t in (0.0, 0.245 * np.exp(1j * np.pi)):
        _equal(pr2.boxes_geometry(cfg, boxes, 16, transmission=t,
                                  device="cpu").numpy(),
               np.asarray(jr2.boxes_geometry(cfg, boxes, 16, transmission=t)))
