"""The port's Laplace single-layer apply (ipde_tpu_torch.ops.kernels)
against ipde_tpu's XLA path and its Pallas kernel (interpret mode), and
the CUDA kernel against the plain version (marker ``gpu``: skipped with a
reason where torch sees no CUDA device; on a GPU machine run
``python -m pytest tests/test_torch_*.py -m gpu``).

Inputs are the double-single-rounded clouds of tests/test_pallas_ds.py,
near-coincident pairs included, made with numpy from a seed."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipde_tpu.ops import kernels as jax_kernels
from ipde_tpu.ops import pallas_ds
from ipde_tpu_torch.ops import kernels


def _ds_round(x):
    hi = x.astype(np.float32).astype(np.float64)
    lo = (x - hi).astype(np.float32).astype(np.float64)
    return hi + lo


def _cloud(T=700, S=300, seed=0, near=True):
    rng = np.random.default_rng(seed)
    sx = np.cos(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    sy = np.sin(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    r = 0.8 * np.sqrt(rng.uniform(0.01, 1, T))
    th = rng.uniform(0, 2 * np.pi, T)
    tx = r * np.cos(th)
    ty = r * np.sin(th)
    if near:
        k = min(32, T, S)
        tx[:k] = sx[:k] + 10.0 ** rng.uniform(-4, -2, k)
        ty[:k] = sy[:k] + 10.0 ** rng.uniform(-4, -2, k)
    q = rng.standard_normal(S) / S
    return tuple(_ds_round(a) for a in (sx, sy, q, tx, ty))


def _plain(args):
    return kernels.laplace_slp_apply(*map(torch.as_tensor, args)).numpy()


@pytest.mark.parametrize("seed,near", [(0, True), (4, False), (7, True)])
def test_plain_matches_xla_path(seed, near):
    args = _cloud(seed=seed, near=near)
    want = np.asarray(jax_kernels.laplace_slp_apply(
        *map(jnp.asarray, args)))
    assert np.abs(_plain(args) - want).max() < 1e-12


@pytest.mark.parametrize("seed", [0, 4])
def test_plain_matches_pallas_interpret(seed):
    args = _cloud(seed=seed)
    want = np.asarray(pallas_ds.laplace_slp_apply(*args, interpret=True))
    assert np.abs(_plain(args) - want).max() < 1e-12


def test_plain_clamps_coincident_pairs():
    # a target ON a source: r^2 = 0 is clamped at 1e-30, as in the TPU
    # kernel, so the sum stays finite
    sx, sy, q, tx, ty = (torch.as_tensor(a) for a in _cloud(T=50, S=40))
    tx[0], ty[0] = sx[3], sy[3]
    got = kernels.laplace_slp_apply(sx, sy, q, tx, ty)
    assert torch.isfinite(got).all()
    want = q[3] * (-np.log(1e-30)) / (4 * np.pi)
    rest = kernels.laplace_slp_apply(
        torch.cat([sx[:3], sx[4:]]), torch.cat([sy[:3], sy[4:]]),
        torch.cat([q[:3], q[4:]]), tx[:1], ty[:1])
    assert abs(float(got[0] - rest[0]) - float(want)) < 1e-12


def test_wrapper_checks_and_cpu_route():
    sx, sy, q, tx, ty = (torch.as_tensor(a) for a in _cloud(T=64, S=32))
    before = kernels.laplace_slp_apply.launches
    out = kernels.laplace_slp_apply(sx, sy, q, tx, ty)
    assert out.shape == (64,) and out.dtype == torch.float64
    # the CPU route runs the plain version and launches nothing
    assert kernels.laplace_slp_apply.launches == before
    assert torch.equal(out, kernels.laplace_slp_apply_plain(sx, sy, q, tx, ty))
    with pytest.raises(TypeError):
        kernels.laplace_slp_apply(sx.float(), sy, q, tx, ty)
    with pytest.raises(ValueError):
        kernels.laplace_slp_apply(sx, sy, q[:-1], tx, ty)
    with pytest.raises(ValueError):
        kernels.laplace_slp_apply(sx, sy, q, tx[::2], ty[::2])
    with pytest.raises(ValueError):
        kernels.laplace_slp_apply(sx, sy, q, tx[:, None], ty[:, None])


def test_module_import_builds_nothing():
    # importing the kernel modules neither needs nvcc nor builds
    code = ("import ipde_tpu_torch.ops.kernels as k, sys; "
            "import ipde_tpu_torch.ops.stokes_kernels; "
            "sys.exit(0 if not k._libs else 1)")
    assert subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1]).returncode == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,seed", [(700, 300, 0), (70001, 3001, 4),
                                      (1, 1, 5), (257, 255, 6)])
def test_cuda_kernel_matches_plain(T, S, seed):
    dev = _cuda()
    sx, sy, q, tx, ty = (torch.as_tensor(a, device=dev)
                         for a in _cloud(T=T, S=S, seed=seed))
    before = kernels.laplace_slp_apply.launches
    got = kernels.laplace_slp_apply(sx, sy, q, tx, ty)
    torch.cuda.synchronize()
    assert kernels.laplace_slp_apply.launches == before + 1
    want = kernels.laplace_slp_apply_plain(sx, sy, q, tx, ty)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-12, rel


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices():
    dev = _cuda()
    sx, sy, q, tx, ty = (torch.as_tensor(a) for a in _cloud(T=16, S=8, seed=1))
    with pytest.raises(ValueError):
        kernels.laplace_slp_apply(sx.to(dev), sy, q, tx, ty)
