"""The port's device-built forms (ipde_tpu_torch/ops/forms_dev.py) against
ipde_tpu.ops.forms_dev's twins on the same curves, on CPU tensors.

Curves and targets of tests/test_forms_dev.py: star(128, a=0.15, f=4), a
source star(96, a=0.1, f=3, r=1.4) and 37 targets on the circle of radius
1.9.  Each form within 1e-12 of the largest entry, as that test asserts
against the numpy builders; the rule-36 filters of a numpy-seeded matrix
within 1e-13 (absolute, entries O(1)); the spectral resampling matrix within
1e-14.  Marker ``gpu``: every form built on the card against the same form
on the CPU, skipped with a reason where torch sees no CUDA device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.ops import forms_dev as jfd
from ipde_tpu.qfs.qfs import resample_dev as jresample_dev
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.ops import forms_dev as fd
from ipde_tpu_torch.qfs.qfs import resample_dev

K = 2.5


def _curves(star_fn):
    c = star_fn(128, a=0.15, f=4)
    s = star_fn(96, a=0.1, f=3, r=1.4)
    th = np.linspace(0, 2 * np.pi, 37)
    return c, s, 1.9 * np.cos(th), 1.9 * np.sin(th)


# name -> the builder's arguments after the curves (c: on-surface, s:
# source curve, targets tx, ty with normals tx / 1.9, ty / 1.9)
NAIVE = {
    "laplace_slp_naive_dev": lambda c, s, tx, ty: (s, tx, ty),
    "laplace_dlp_naive_dev": lambda c, s, tx, ty: (s, tx, ty),
    "mh_slp_naive_dev": lambda c, s, tx, ty: (s, tx, ty, K),
    "mh_dlp_naive_dev": lambda c, s, tx, ty: (s, tx, ty, K),
    "laplace_slp_normal_naive_dev": lambda c, s, tx, ty: (
        s, tx, ty, tx / 1.9, ty / 1.9),
    "mh_slp_normal_naive_dev": lambda c, s, tx, ty: (
        s, tx, ty, tx / 1.9, ty / 1.9, K),
    "stokes_slp_naive_dev": lambda c, s, tx, ty: (s, tx, ty),
    "stokes_dlp_naive_dev": lambda c, s, tx, ty: (s, tx, ty),
}
SELF = {name: (lambda c, s, tx, ty: (c,)) for name in (
    "laplace_slp_self_dev", "laplace_dlp_self_dev",
    "laplace_slp_normal_self_dev", "stokes_slp_self_dev",
    "stokes_dlp_self_dev")}
FIX = {"stokes_pressure_fix_dev": lambda c, s, tx, ty: (
    c, c.normal_x, c.normal_y)}
BUILDERS = {**NAIVE, **SELF, **FIX}


@pytest.fixture(scope="module")
def curves():
    return _curves(jstar), _curves(star)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_form_matches_ipde_tpu(curves, name):
    jc, tc = curves
    args = BUILDERS[name]
    want = np.asarray(getattr(jfd, name)(*args(*jc)))
    got = getattr(fd, name)(*args(*tc), device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == want.shape
    scale = np.abs(want).max()
    tol = 1e-13 if name in FIX else 1e-12 * scale
    assert np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("which", ["rows", "cols"])
def test_rule36_filter_matches_ipde_tpu(which):
    rng = np.random.default_rng(0)
    n = 64
    B = rng.standard_normal((2 * n, 3 * n))
    got = getattr(fd, f"filter_{which}_dev")(torch.as_tensor(B), n)
    want = np.asarray(getattr(jfd, f"filter_{which}_dev")(jnp.asarray(B), n))
    assert np.abs(got.numpy() - want).max() <= 1e-13


@pytest.mark.parametrize("n_in,n_out", [(64, 192), (65, 130), (128, 128)])
def test_resample_dev_matches_ipde_tpu(n_in, n_out):
    got = resample_dev(n_in, n_out, "cpu")
    want = np.asarray(jresample_dev(n_in, n_out))
    assert got.shape == (n_out, n_in)
    assert np.abs(got.numpy() - want).max() <= 1e-14
    # it interpolates a band-limited function exactly
    t_in = np.arange(n_in) * 2 * np.pi / n_in
    t_out = np.arange(n_out) * 2 * np.pi / n_out
    f = lambda t: np.cos(3 * t) + np.sin(5 * t)  # noqa: E731
    assert np.abs(got.numpy() @ f(t_in) - f(t_out)).max() <= 1e-13


@pytest.mark.gpu
def test_forms_on_cuda_match_cpu():
    """Every builder and both filters on the card against the CPU (the
    CUDA log, sqrt and Bessel functions against the CPU's), within the
    tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    tc = _curves(star)
    for name, args in BUILDERS.items():
        want = getattr(fd, name)(*args(*tc), device="cpu")
        got = getattr(fd, name)(*args(*tc), device="cuda").cpu()
        assert (got - want).abs().max() <= 1e-12 * want.abs().max(), name
    B = torch.as_tensor(np.random.default_rng(0).standard_normal((128, 192)))
    for fn in (fd.filter_rows_dev, fd.filter_cols_dev):
        assert (fn(B.cuda(), 64).cpu() - fn(B, 64)).abs().max() <= 1e-13
