"""Port parity: the port's copy of the mask rule checks (models/mrc.py)
against the JAX package's, on the geometry of tests/test_mrc.py and on a
random raster.

MRC is host numpy in both packages: every count, label map, violation map
and repaired mask is equal, element for element. A tensor mask (the
port's) is read back first and gives the same result.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.models import mrc as jmrc
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    mask_rules_from_jax)
from lithographysimulator_tpu_torch.models import mrc as pmrc

JCFG = jt.OpticsConfig(pixel_number=64, pixel_size=10.0)
PCFG = config_from_jax(JCFG)
RULES = jmrc.MaskRules(min_width_nm=40.0, min_space_nm=40.0,
                       min_area_nm2=1000.0)


def _mask(w_line=6, gap=6):
    m = np.zeros((64, 64), np.float32)
    m[:, 8:8 + w_line] = 1.0
    m[:, 8 + w_line + gap:8 + 2 * w_line + gap] = 1.0
    return m


def _defective():
    m = _mask(gap=2)
    m[:, 40:42] = 1.0      # width violation
    m[30:32, 50:52] = 1.0  # area violation
    return m


def _random():
    rng = np.random.default_rng(5)
    return (rng.random((64, 64)) < 0.35).astype(np.float32)


def _same(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ours[k], v)
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("make", [_mask, _defective, _random])
def test_mrc_check_matches_jax(make):
    m = make()
    rules = mask_rules_from_jax(RULES)
    assert rules == pt.MaskRules(40.0, 40.0, 1000.0)
    ref = jmrc.mrc_check(m, JCFG, RULES)
    _same(pmrc.mrc_check(m, PCFG, rules), ref)
    _same(pt.mrc_check(torch.as_tensor(m), 10.0, rules), ref)
    for only in (pt.MaskRules(min_width_nm=30.0), pt.MaskRules(min_space_nm=30.0),
                 pt.MaskRules(min_area_nm2=500.0)):
        _same(pt.mrc_check(m, PCFG, only),
              jmrc.mrc_check(m, JCFG, jmrc.MaskRules(
                  only.min_width_nm, only.min_space_nm, only.min_area_nm2)))


@pytest.mark.parametrize("make", [_defective, _random])
def test_mrc_clean_matches_jax(make):
    m = make()
    ours = pt.mrc_clean(m, PCFG, mask_rules_from_jax(RULES))
    ref = jmrc.mrc_clean(m, JCFG, RULES)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_label_components_matches_jax():
    u = np.zeros((16, 16))
    u[4:12, 2:4] = 1
    u[4:12, 8:10] = 1
    u[10:12, 2:10] = 1  # a U: one component through the union-find
    u[0, 15] = 1
    for m in (u, _random(), np.zeros((8, 8))):
        labels, count = pmrc.label_components(m)
        ref_labels, ref_count = jmrc.label_components(m)
        assert count == ref_count
        np.testing.assert_array_equal(labels, ref_labels)
    assert pmrc.label_components(u)[1] == 2


def test_rules_validation():
    with pytest.raises(ValueError):
        pt.MaskRules(min_width_nm=-1.0)
