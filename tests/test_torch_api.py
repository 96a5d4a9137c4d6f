"""The port's public API against the JAX package's: the names it exports,
matmul_compensated, the JAX keywords it accepts (block=, matmul_precision=,
engine='pallas') and the m3dcal -> simulate --m3d handoff of the CLI, all on
the CPU."""

import importlib.util
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import compensated as jc
from lithographysimulator_tpu_torch import cli as pcli
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import abbe as pa

from .conftest import normalized_rms

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
SRC = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _defining_module(name: str) -> str:
    """The JAX package module that defines ``jt.<name>`` (by identity for
    constants, which carry no __module__)."""
    obj = getattr(jt, name)
    mod = getattr(obj, "__module__", None)
    if isinstance(mod, str) and mod.startswith("lithographysimulator_tpu"):
        return mod
    for mod_name, mod in sorted(sys.modules.items()):
        if (mod_name.startswith("lithographysimulator_tpu.")
                and getattr(mod, name, None) is obj):
            return mod_name
    raise AssertionError(f"no module of the JAX package defines {name}")


def test_every_name_of_a_ported_module_is_exported():
    """Each name of the JAX package's __all__ whose defining module has a
    counterpart in the port is in the port's __all__ (and defined)."""
    owed = []
    for name in jt.__all__:
        port_mod = _defining_module(name).replace(
            "lithographysimulator_tpu", "lithographysimulator_tpu_torch", 1)
        if importlib.util.find_spec(port_mod) is not None:
            owed.append(name)
    assert len(owed) >= 80
    assert sorted(set(owed) - set(pt.__all__)) == []
    assert all(hasattr(pt, name) for name in pt.__all__)


def test_port_exports_every_name_of_the_jax_package():
    """Every module of the JAX package's __all__ has its counterpart now:
    the port's __all__ contains the whole of it."""
    assert sorted(set(jt.__all__) - set(pt.__all__)) == []


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("k", [300, 1500])
def test_matmul_compensated_matches_jax(dtype, k):
    rng = np.random.default_rng(k)

    def draw(*shape):
        x = rng.normal(size=shape)
        if dtype == np.complex64:
            x = x + 1j * rng.normal(size=shape)
        return x.astype(dtype)

    a, b = draw(24, k), draw(k, 40)
    exact = a.astype(np.complex128) @ b.astype(np.complex128)
    ref = np.asarray(jc.matmul_compensated(a, b))
    ours = pt.matmul_compensated(torch.as_tensor(a), torch.as_tensor(b))
    assert ours.dtype == torch.as_tensor(a).dtype
    scale = np.abs(exact).max()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ours.numpy(), exact, rtol=0, atol=1e-6 * scale)
    with pytest.raises(ValueError, match="contraction"):
        pt.matmul_compensated(torch.as_tensor(a), torch.as_tensor(a))


def test_block_is_accepted_and_changes_nothing():
    mask = pt.demo_bars(PCFG, device="cpu")
    a = pt.simulate(mask, SRC, device="cpu").image
    b = pt.simulate(mask, SRC, device="cpu", block=False).image
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    batch = pt.simulate_batch(mask.geometry[None], PCFG, SRC, device="cpu",
                              block=False)
    np.testing.assert_array_equal(batch[0].numpy(), a.numpy())


def test_matmul_precision_highest_only():
    spectrum = pt.mask_spectrum(pt.demo_bars(PCFG, device="cpu").geometry, PCFG)
    pupil = pt.pupil_function(np.zeros(1, np.float32), PCFG, device="cpu")
    pts = pt.source_points(SRC)
    shifts, weights = pa._pad_points(pts.shifts, pts.weights, 4)
    kw = dict(device="cpu", engine="matmul")
    base = pt.abbe_image_points(spectrum, pupil, shifts, weights, PCFG, **kw)
    same = pt.abbe_image_points(spectrum, pupil, shifts, weights, PCFG,
                                matmul_precision="highest", **kw)
    np.testing.assert_array_equal(base.numpy(), same.numpy())
    acc = pt.accumulate_intensity(pupil, spectrum, shifts,
                                  torch.as_tensor(weights), PCFG,
                                  matmul_precision="highest")
    assert acc.shape == (32, 32)
    for reduced in ("default", "high", "bfloat16"):
        with pytest.raises(ValueError, match="highest"):
            pt.abbe_image_points(spectrum, pupil, shifts, weights, PCFG,
                                 matmul_precision=reduced, **kw)
        with pytest.raises(ValueError, match="highest"):
            pt.accumulate_intensity(pupil, spectrum, shifts,
                                    torch.as_tensor(weights), PCFG,
                                    matmul_precision=reduced)


def test_pallas_is_an_alias_of_int8():
    assert pa.resolve_engine("pallas", device="cpu") == "int8"
    assert pa.resolve_engine("pallas", device="cuda") == "int8"
    with pytest.raises(ValueError):
        pa.resolve_engine("warp9", device="cpu")
    spectrum = pt.mask_spectrum(pt.demo_bars(PCFG, device="cpu").geometry, PCFG)
    pupil = pt.pupil_function(np.zeros(1, np.float32), PCFG, device="cpu")
    socs = pt.tcc_eigensystem(pupil, SRC, PCFG, rank=8)
    a = pt.socs_image(spectrum, socs, PCFG, engine="pallas")
    b = pt.socs_image(spectrum, socs, PCFG, engine="int8")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    pts = pt.source_points(SRC)
    shifts, weights = pa._pad_points(pts.shifts, pts.weights, 4)
    a = pt.abbe_image_points(spectrum, pupil, shifts, weights, PCFG,
                             device="cpu", engine="pallas")
    b = pt.abbe_image_points(spectrum, pupil, shifts, weights, PCFG,
                             device="cpu", engine="int8")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cli_m3dcal_out_and_m3d_flag(tmp_path, capsys):
    """As tests/test_mask3d.py::test_cli_m3dcal_out_and_m3d_flag: m3dcal
    --out writes the calibrated model, its stdout line has the JAX CLI's
    keys, simulate --m3d consumes the file, and the image differs from the
    thin-mask run by the boundary-layer perturbation."""
    from lithographysimulator_tpu.cli import main as jmain

    cal = tmp_path / "cal.json"
    args = ["m3dcal", "--pixel-number", "32", "--pitch", "16", "--steps"]
    assert pcli.main(args + ["30", "--device", "cpu", "--out", str(cal)]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == json.loads(cal.read_text())
    model = pt.model_from_json(str(cal))
    assert isinstance(model, pt.BoundaryLayer) and model.beta_h != 0
    assert jmain(args + ["2"]) == 0
    assert set(line) == set(json.loads(capsys.readouterr().out.splitlines()[-1]))

    out_m3d, out_thin = tmp_path / "m3d.npy", tmp_path / "thin.npy"
    common = ["simulate", "--device", "cpu", "--pixel-number", "32"]
    assert pcli.main(common + ["--m3d", str(cal), "--out", str(out_m3d)]) == 0
    assert "BL(" in json.loads(capsys.readouterr().out.splitlines()[0])["mask3d"]
    assert pcli.main(common + ["--out", str(out_thin)]) == 0
    capsys.readouterr()
    img_m3d, img_thin = np.load(out_m3d), np.load(out_thin)
    assert img_m3d.shape == img_thin.shape == (32, 32)
    assert np.abs(img_m3d - img_thin).max() > 1e-4
    # the scalar --mask3d-* flags build the same kind of model
    flags = ["--mask3d-width", "8", "--mask3d-beta-h=-0.2+0.1j",
             "--mask3d-beta-v=-0.3"]
    assert pcli.main(common + flags) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["mask3d"] == "BL(w=8.0nm, bh=(-0.2+0.1j), bv=(-0.3+0j))"
    ref = jt.simulate(jt.demo_bars(CFG), np.asarray(jt.LightSource(
        CFG, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)),
        mask3d=jt.BoundaryLayer(width_nm=8.0, beta_h=-0.2 + 0.1j,
                                beta_v=-0.3 + 0j))
    assert report["mask3d"] == ref.report["mask3d"]
    ours = pt.simulate(pt.demo_bars(PCFG, device="cpu"), np.asarray(
        ref.source_map), device="cpu", mask3d=pcli._build_mask3d(
            pcli_args(flags)))
    assert normalized_rms(ours.image.numpy(), np.asarray(ref.image)) < 1e-6


def pcli_args(flags):
    """The parsed ``simulate`` flags of the port's CLI."""
    import argparse

    parser = argparse.ArgumentParser()
    pcli._add_common(parser)
    return parser.parse_args(flags)


# ---------------------------------------------------------------------------
# F8: the signature sweep and the repairs it found
# ---------------------------------------------------------------------------

#: (JAX module, name, method or None) -> why a JAX parameter (a list) or the
#: whole name ("absent") has no counterpart in the port; decided in
#: ROADMAP.md Queue 3
SWEEP_EXCEPTIONS = {
    # D2: a trial draws from a torch.Generator, not a jax.random key
    ("models.stochastic", "StochasticResist", "deprotection"): ["key"],
    ("models.stochastic", "StochasticResist", "contour"): ["key"],
    ("models.stochastic", "StochasticResist", "deprotection_volume"): ["key"],
    # the port times a stage with CUDA events: nothing to synchronize
    ("utils.profiling", "StageTimer", None): ["sync"],
    # wide accumulation is native float64 here (ops/compensated._wide)
    ("ops.compensated", "two_sum", None): "absent",
    # the plain versions (column_intensity_int8_plain et al.) are the
    # reference of the limb math
    ("ops.kernels.intensity_int8", "reference_window_intensity_int8", None):
        "absent",
}


def _sweep() -> dict:
    """Every public function and class (and each public method of such a
    class) defined in a module of the JAX package whose port module
    exists -> the JAX parameters its port namesake lacks (a port
    ``**kwargs`` takes any name). ``xfer`` is dropped on purpose."""
    import importlib
    import inspect
    import pkgutil

    def lacking(jobj, pobj):
        try:
            jparams = inspect.signature(jobj).parameters
            pparams = inspect.signature(pobj).parameters
        except ValueError:  # a builtin's subclass (an exception): no signature
            return []
        if any(p.kind == p.VAR_KEYWORD for p in pparams.values()):
            return []
        return [p for p in jparams if p not in pparams]

    found = {}
    for info in pkgutil.walk_packages(jt.__path__, "lithographysimulator_tpu."):
        if info.name.rsplit(".", 1)[-1].startswith("_"):
            continue
        port_name = info.name.replace("lithographysimulator_tpu",
                                      "lithographysimulator_tpu_torch", 1)
        if importlib.util.find_spec(port_name) is None:
            assert info.name.endswith(".xfer"), info.name
            continue
        jmod = importlib.import_module(info.name)
        pmod = importlib.import_module(port_name)
        short = info.name.split(".", 1)[1]
        for name, obj in vars(jmod).items():
            if (name.startswith("_") or getattr(obj, "__module__", None) != info.name
                    or not (inspect.isfunction(obj) or inspect.isclass(obj))):
                continue
            pobj = getattr(pmod, name, None)
            if pobj is None:
                found[(short, name, None)] = "absent"
                continue
            if lack := lacking(obj, pobj):
                found[(short, name, None)] = lack
            if not inspect.isclass(obj):
                continue
            for meth, fn in vars(obj).items():
                if meth.startswith("_") or not inspect.isfunction(fn):
                    continue
                pfn = getattr(pobj, meth, None)
                if pfn is None:
                    found[(short, name, meth)] = "absent"
                elif lack := lacking(fn, pfn):
                    found[(short, name, meth)] = lack
    return found


def test_every_jax_parameter_exists_in_the_port():
    """F8's sweep: each parameter of every public function, class and
    method of the JAX package exists in the port's namesake, but for the
    decided exceptions above (the port's added device= parameters are
    extra, never missing). Before F8: socs_image(matmul_precision=),
    socs_image_nrms_bound(polarization=, apodize=), resolve_engine(allowed=),
    StageTimer(log=), trace, annotate and dense_source_points."""
    assert _sweep() == SWEEP_EXCEPTIONS


def test_f8_socs_and_engine_arguments():
    """socs_image takes matmul_precision ('highest' only, the same image);
    socs_image_nrms_bound takes polarization= and apodize= (the vector
    trace, JAX's value for the same kernels) and without config= reports
    the sup bound instead of raising; resolve_engine takes allowed= as
    JAX's does."""
    from lithographysimulator_tpu.ops import abbe as ja
    from lithographysimulator_tpu.ops import hopkins as jh
    from lithographysimulator_tpu_torch.interop import socs_from_numpy
    from lithographysimulator_tpu_torch.ops import hopkins as ph

    spec = np.array(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))
    pup = np.array(jt.pupil_function(np.zeros(1), CFG))
    js = jt.tcc_eigensystem(pup, SRC, CFG, rank=8)
    ps = socs_from_numpy(np.asarray(js.kernels), np.asarray(js.eigenvalues),
                         device="cpu")
    tspec, tpup = torch.as_tensor(spec), torch.as_tensor(pup)
    img = ph.socs_image(tspec, ps, PCFG)
    np.testing.assert_array_equal(
        ph.socs_image(tspec, ps, PCFG, matmul_precision="highest").numpy(),
        img.numpy())
    with pytest.raises(ValueError, match="highest"):
        ph.socs_image(tspec, ps, PCFG, matmul_precision="default")
    jimg = np.asarray(jh.socs_image(spec, js, CFG))
    for pol, apodize in (("unpolarized", True), ("x", False)):
        ref = jh.socs_image_nrms_bound(js, spec, jimg, pupil=pup,
                                       source_map=SRC, polarization=pol,
                                       apodize=apodize, config=CFG)
        ours = ph.socs_image_nrms_bound(ps, tspec, img, pupil=tpup,
                                        source_map=SRC, polarization=pol,
                                        apodize=apodize, config=PCFG)
        assert abs(ours - ref) <= 1e-5 * abs(ref)
    sup = ph.socs_image_nrms_bound(
        ps, tspec, img, trace=ph.tcc_total_trace(tpup, SRC))
    no_config = ph.socs_image_nrms_bound(ps, tspec, img, pupil=tpup,
                                         source_map=SRC)
    assert no_config == sup
    assert no_config >= jh.socs_image_nrms_bound(js, spec, jimg, pupil=pup,
                                                 source_map=SRC)
    for engine, allowed in (("auto", ("fft", "matmul")), ("int8", ("fft",))):
        if engine == "auto":
            assert pa.resolve_engine(engine, device="cuda",
                                     allowed=allowed) == "matmul"
            assert pa.resolve_engine(engine, device="cpu",
                                     allowed=allowed) == "fft"
            continue
        for call in (lambda: pa.resolve_engine(engine, device="cpu",
                                               allowed=allowed),
                     lambda: ja.resolve_engine(engine, allowed=allowed)):
            with pytest.raises(ValueError, match="allowed"):
                call()


def test_f8_profiling_helpers(tmp_path, caplog):
    """utils re-exports the JAX package's names (its complex-transfer
    helpers excepted); trace writes a profiler trace of its block,
    annotate names a function's range in it, and StageTimer(log=True)
    logs each stage."""
    import logging

    import lithographysimulator_tpu.utils as ju
    import lithographysimulator_tpu_torch.utils as pu

    names = {n for n in dir(ju) if not n.startswith("_")
             and not hasattr(getattr(ju, n), "__path__")}
    assert names - {"to_device_complex", "to_host_complex"} <= set(dir(pu))

    @pu.annotate("litho_stage")
    def double(x):
        return 2 * x

    assert double.__name__ == "double"
    with pu.trace(tmp_path / "trace"):
        out = double(torch.ones(4))
    assert float(out.sum()) == 8.0
    assert "litho_stage" in (tmp_path / "trace" / "trace.json").read_text()
    timer = pu.StageTimer("cpu", log=True)
    with caplog.at_level(logging.INFO, logger="lithographysimulator_tpu_torch"):
        with timer.stage("spectrum"):
            pass
    assert "stage spectrum" in caplog.text
    assert set(timer.report()) == {"spectrum"}


def _device_defaults(obj) -> list:
    """``(qualname, default)`` of each parameter named ``device`` (or
    ``*_device``) of a function or method that has a default."""
    import inspect

    fn = inspect.unwrap(obj)
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return []
    return [(fn.__qualname__, p.default) for p in params
            if (p.name == "device" or p.name.endswith("_device"))
            and p.default is not inspect.Parameter.empty]


def test_no_function_of_the_port_defaults_to_the_cpu():
    """Step 0's third fault class as a sweep: no function or method of any
    port module, public or private, falls back to the CPU when no device
    is given (a ``device`` default of 'cpu'). ``_channel_rotation_cached``
    had one, unreached: every caller passed the device."""
    import inspect
    import pkgutil

    found = []
    for info in pkgutil.walk_packages(pt.__path__, pt.__name__ + "."):
        if info.name.endswith(".__main__"):  # runs the CLI on import
            continue
        mod = importlib.import_module(info.name)
        for obj in vars(mod).values():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            members = [obj]
            if inspect.isclass(obj):
                members += [m for m in vars(obj).values() if callable(m)]
            for member in members:
                for qualname, default in _device_defaults(member):
                    if str(default) == "cpu" or (
                            isinstance(default, torch.device)
                            and default.type == "cpu"):
                        found.append(f"{mod.__name__}.{qualname}")
    assert found == []
