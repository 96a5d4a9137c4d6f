"""Port parity: resist calibration (models/calibrate.py) of the torch port
against the JAX package's.

The port's calibration is the JAX package's numpy code bound to the port's
resist models: on the same gauge images ``gauge_cd`` and
``calibrate_resist`` return JAX's results exactly. On gauges each package
images itself (three line/space pitches at 64^2 on the CPU, images within
the 1e-6 class of each other), both fits recover the hidden threshold and
diffusion within tests/test_calibrate.py's tolerance (0.01 and 1.5 nm)
and lie within that tolerance of each other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.models import calibrate as jc
from lithographysimulator_tpu.models import resist as jr
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    resist_from_jax)
from lithographysimulator_tpu_torch.models import calibrate as pc

CFG = jt.OpticsConfig(pixel_number=96)  # 25 nm px
PCFG = config_from_jax(CFG)
TRUE = jr.ResistModel(threshold=0.42, diffusion_nm=12.0)
PITCHES = (8, 12, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gauges():
    """tests/test_calibrate.py's synthetic line-grating gauges."""
    x = np.arange(CFG.n)
    return [np.tile((0.5 + 0.5 * c * np.cos(2 * np.pi * x / p)) ** 2, (CFG.n, 1))
            for p, c in zip(PITCHES, (0.9, 0.8, 0.7))]


@pytest.mark.parametrize("model", [
    TRUE, jr.ResistModel(threshold=0.3), jr.MackResist(m_threshold=0.55,
                                                        develop_s=40.0)],
    ids=["lumped", "lumped_sharp", "mack"])
def test_gauge_cd_equals_jax(model):
    for im in _gauges():
        for stat in ("median", "mean"):
            assert (pc.gauge_cd(resist_from_jax(model), torch.tensor(im), PCFG,
                                cd_stat=stat)
                    == jc.gauge_cd(model, im, CFG, cd_stat=stat))


def test_blur_np_equals_jax():
    img = np.random.default_rng(7).random((32, 32))
    np.testing.assert_array_equal(pc._blur_np(img, 9.0, 25.0),
                                  jc._blur_np(img, 9.0, 25.0))


def test_calibrate_equals_jax_on_the_same_gauges():
    images = _gauges()
    measured = [jc.gauge_cd(TRUE, im, CFG) for im in images]
    start = jr.ResistModel(threshold=0.30, diffusion_nm=0.0)
    ref = jc.calibrate_resist(images, measured, CFG, model=start)
    ours = pc.calibrate_resist(images, measured, PCFG,
                               model=resist_from_jax(start))
    assert isinstance(ours["model"], pt.ResistModel)
    assert ours["params"] == ref["params"]
    assert ours["evals"] == ref["evals"] and ours["rms_nm"] == ref["rms_nm"]
    np.testing.assert_array_equal(ours["cd_nm"], ref["cd_nm"])
    assert ours["params"]["threshold"] == pytest.approx(0.42, abs=0.01)
    assert ours["params"]["diffusion_nm"] == pytest.approx(12.0, abs=1.5)


def test_calibrate_input_validation():
    images = _gauges()
    with pytest.raises(ValueError, match="measured"):
        pc.calibrate_resist(images, [50.0], PCFG)
    with pytest.raises(ValueError, match="unknown model field"):
        pc.calibrate_resist(images, [50.0, 60.0, 70.0], PCFG,
                            fit=("not_a_field",))
    with pytest.raises(ValueError, match="at least one"):
        pc.calibrate_resist(images, [50.0, 60.0, 70.0], PCFG, fit=())


def test_calibrate_on_each_packages_images():
    """Gauges imaged by each package (line/space at three pitches, 64^2,
    annular source): the "measured" CDs come from the hidden model on each
    package's own images; both fits recover it."""
    cfg = jt.OpticsConfig(pixel_number=64)
    pcfg = config_from_jax(cfg)
    src = np.asarray(jt.LightSource(cfg, sigma_in=0.3, sigma_out=0.7).annular())
    jimgs, pimgs = [], []
    for pitch in (8, 16, 32):
        geom = np.array(jt.lines_and_spaces(cfg, line_width_px=pitch // 2,
                                            pitch_px=pitch).geometry)
        jimgs.append(np.asarray(jt.simulate(jt.from_array(geom, cfg), src).image))
        pimgs.append(pt.simulate(pt.from_array(geom, pcfg, device="cpu"), src,
                                 device="cpu").image)
    start = jr.ResistModel(threshold=0.30, diffusion_nm=2.0)
    fits = []
    for mod, imgs, c, model in ((jc, jimgs, cfg, start),
                                (pc, pimgs, pcfg, resist_from_jax(start))):
        measured = [mod.gauge_cd(resist_from_jax(TRUE) if mod is pc else TRUE,
                                 im, c) for im in imgs]
        out = mod.calibrate_resist(imgs, measured, c, model=model)
        assert out["params"]["threshold"] == pytest.approx(0.42, abs=0.01)
        assert out["params"]["diffusion_nm"] == pytest.approx(12.0, abs=1.5)
        fits.append(out["params"])
    assert fits[1]["threshold"] == pytest.approx(fits[0]["threshold"], abs=0.01)
    assert fits[1]["diffusion_nm"] == pytest.approx(fits[0]["diffusion_nm"],
                                                    abs=1.5)
