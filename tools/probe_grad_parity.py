"""Two parity findings of the int8 gradient and the M3D fits, measured on
the CPU against the JAX package (both packages imported; run from the repo
root with JAX on the CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/probe_grad_parity.py

1. The weights' gradient of sum(image * M), d/dw_b = sum(M |E_b|^2), in
   float32 from JAX's f32 engine and from the port's int8 engine (its
   float32 backward), each against a complex128 evaluation of the same
   sum, as max|dg| / max|g| (ROADMAP.md Queue 3, F4). The inputs are those
   of tests/test_torch_int8_grad.py.
2. fit_boundary_layer for 5 steps in both packages on demo_bars in focus,
   and on the asymmetric layout at 50 nm defocus with coma of
   tests/test_torch_mask3d.py: the largest |beta difference| and the
   largest relative difference of the loss histories.
"""

from __future__ import annotations

import sys

import numpy as np


def weights_gradient() -> None:
    import torch

    sys.path.insert(0, ".")
    from tests import test_torch_int8_grad as t

    torch.set_num_threads(1)
    inputs = t.inputs.__wrapped__()
    _, _, g_jax = t._jax_grads(*inputs)
    _, _, g_port = t._port_grads(*inputs, "int8")
    g64 = t._weights_grad_f64(*inputs)
    scale = np.abs(g64).max()
    print(f"[1] weights gradient, max|dg|/max|g| against complex128: JAX f32 "
          f"{np.abs(g_jax - g64).max() / scale:.3e}, port int8 "
          f"{np.abs(g_port - g64).max() / scale:.3e}; port against JAX "
          f"{np.abs(g_port - g_jax).max() / scale:.3e}")


def fits() -> None:
    import lithographysimulator_tpu as jt
    import lithographysimulator_tpu_torch as pt
    from lithographysimulator_tpu.ops import mask3d as jm
    from lithographysimulator_tpu_torch.ops import mask3d as pm
    from tests import test_torch_mask3d as t

    shifts, weights = t._padded_points()
    g = np.array(jt.demo_bars(t.CFG).geometry)
    asym = g.copy()
    asym[3:7, 2:13] = 1.0
    asym[24:27, 20:30] = 1.0
    for tag, geom, ab in (("demo_bars in focus", g, np.zeros(1, np.float32)),
                          ("asymmetric, defocus and coma", asym, t.FIT_ABERR)):
        jmask = jt.from_array(geom, t.CFG)
        pmask = pt.from_array(geom, t.PCFG, device="cpu")
        target = np.asarray(jt.simulate(jmask, t.SRC, ab, normalize=True,
                                        mask3d=t.BL_ASYM).image)
        kw = dict(width_nm=6.0, steps=5, learning_rate=0.02, aberrations=ab)
        ref, ref_hist = jm.fit_boundary_layer(target, jmask.geometry, shifts,
                                              weights, t.CFG, **kw)
        ours, hist = pm.fit_boundary_layer(target, pmask.geometry, shifts,
                                           weights, t.PCFG, device="cpu", **kw)
        beta = max(abs(ours.beta_h - ref.beta_h), abs(ours.beta_v - ref.beta_v))
        loss = np.max(np.abs(np.array(hist) / np.array(ref_hist) - 1))
        print(f"[2] fit_boundary_layer, 5 steps, {tag}: max |d beta| "
              f"{beta:.3e}, max relative d loss {loss:.3e}")


if __name__ == "__main__":
    weights_gradient()
    fits()
