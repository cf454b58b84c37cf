"""The port's Laplace single-layer apply (ipde_tpu_torch.ops.kernels)
against ipde_tpu's XLA path and its Pallas kernel (interpret mode), the
Laplace kernels' algorithm and special values on the CPU, and the CUDA
kernels against the plain versions (marker ``gpu``: skipped with a
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

from _torch_testing import cloud as _cloud
from _torch_testing import cuda_or_skip as _cuda
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.ops import kernels as jax_kernels
from ipde_tpu.ops import pallas_ds
from ipde_tpu_torch.ops import kernels


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


def _numpy_sums(sx, sy, q, tx, ty):
    """(u, gx, gy) by a float64 numpy loop over the targets: the Laplace
    single layer and its gradient with r^2 clamped at 1e-30."""
    u, gx, gy = (np.empty(tx.shape[0]) for _ in range(3))
    with np.errstate(invalid="ignore"):
        for i in range(tx.shape[0]):
            dx, dy = tx[i] - sx, ty[i] - sy
            r2 = dx * dx + dy * dy
            r2 = np.where(r2 < 1e-30, 1e-30, r2)       # keeps a NaN
            u[i] = -(np.log(r2) * q).sum() / (4 * np.pi)
            gx[i] = -(dx / r2 * q).sum() / (2 * np.pi)
            gy[i] = -(dy / r2 * q).sum() / (2 * np.pi)
    return u, gx, gy


@pytest.mark.parametrize("case", ["nan_target", "nan_charge", "coincident"])
@pytest.mark.parametrize("which", ["laplace", "grad"])
def test_plain_special_values(which, case):
    """What the CUDA kernels must carry, fixed on the plain versions against
    a numpy loop: a NaN target coordinate gives NaN at that target only, a
    NaN charge gives NaN everywhere, a coincident pair stays finite."""
    sx, sy, q, tx, ty = (a.copy() for a in _cloud(T=60, S=40, seed=3))
    if case == "nan_target":
        ty[17] = np.nan
    elif case == "nan_charge":
        q[5] = np.nan
    else:
        tx[0], ty[0] = sx[3], sy[3]
    args = [torch.as_tensor(a) for a in (sx, sy, q, tx, ty)]
    u, gx, gy = _numpy_sums(sx, sy, q, tx, ty)
    if which == "laplace":
        got, want = [kernels.laplace_slp_apply(*args).numpy()], [u]
    else:
        got = [g.numpy() for g in kernels.laplace_slp_grad_apply(*args)]
        want = [gx, gy]
    for g, w in zip(got, want):
        bad = np.isnan(g)
        assert bad.tolist() == {"nan_target": np.arange(60) == 17,
                                "nan_charge": np.ones(60, bool),
                                "coincident": np.zeros(60, bool)}[case].tolist()
        scale = np.abs(w[~bad]).max() if not bad.all() else 0.0
        assert np.allclose(g, w, rtol=1e-12, atol=1e-12 * scale,
                           equal_nan=True)


@pytest.mark.parametrize("T,S", [(0, 5), (7, 0), (0, 0)])
@pytest.mark.parametrize("which", ["laplace", "grad"])
def test_empty_inputs(which, T, S):
    """No targets give empty outputs, no sources give zeros."""
    rng = np.random.default_rng(2)
    sx, sy, q = (torch.as_tensor(rng.standard_normal(S)) for _ in range(3))
    tx, ty = (torch.as_tensor(rng.standard_normal(T)) for _ in range(2))
    out = (kernels.laplace_slp_apply if which == "laplace"
           else kernels.laplace_slp_grad_apply)(sx, sy, q, tx, ty)
    for o in (out if isinstance(out, tuple) else (out,)):
        assert o.shape == (T,) and o.dtype == torch.float64
        assert not o.any()


@pytest.mark.parametrize("S", [300, 3600])
def test_kernel_algorithm_matches_plain(S):
    """The Laplace sum formed as csrc/laplace_slp.cu forms it (the table log
    of LAPLACE_LOG_TABLE_BITS bits with log 2 in one piece, ``fast_log``,
    on the clamped r^2) against the plain version on a near-coincident
    cloud: within 1e-13 of max|plain|, so the kernel's algorithm keeps the
    1e-12 of its check on the card."""
    sx, sy, q, tx, ty = (torch.as_tensor(a)
                         for a in _cloud(T=700, S=S, seed=S))
    want = kernels.laplace_slp_apply_plain(sx, sy, q, tx, ty)
    got = torch.empty_like(want)
    for i0 in range(0, tx.shape[0], 128):
        dx = tx[i0:i0 + 128, None] - sx[None, :]
        dy = ty[i0:i0 + 128, None] - sy[None, :]
        r2 = (dx * dx + dy * dy).clamp_min_(kernels._MIN_R2)
        lg = kernels.fast_log(r2, kernels.LAPLACE_LOG_TABLE_BITS,
                              split_ln2=False)
        got[i0:i0 + 128] = -(lg @ q) / (4 * np.pi)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-13, rel


def test_module_import_builds_nothing():
    # importing the kernel modules neither needs nvcc nor builds
    code = ("import ipde_tpu_torch.ops.kernels as k, sys; "
            "import ipde_tpu_torch.ops.stokes_kernels; "
            "sys.exit(0 if not k._libs else 1)")
    assert subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1]).returncode == 0


# ---------------------------------------------------------------------------
# the kernels' FP64 log (its numpy/torch twin) and the build key
# ---------------------------------------------------------------------------

def _log_inputs(which, bits=kernels.LOG_TABLE_BITS):
    rng = np.random.default_rng(12)
    if which == "wide":
        return 10.0 ** rng.uniform(-30, 3, 400_000)
    if which == "near_one":
        return np.concatenate([1.0 + rng.uniform(-1e-8, 1e-8, 100_000),
                               1.0 + rng.uniform(-2e-2, 2e-2, 100_000),
                               np.nextafter(1.0, [0.0, 2.0]), [1.0]])
    # every table interval's two ends, in several binades, and the extremes
    step = 1 << (20 - bits)
    hi = np.arange(1 << bits, dtype=np.int64) * step \
        + kernels._LOG_SQRT_HALF_HI
    lo = (hi << 32).view(np.float64)
    up = (((hi + step) << 32) - 1).view(np.float64)
    m = np.concatenate([lo, up])
    return np.concatenate([m * 2.0 ** e for e in (-100, -1, 0, 1, 9)]
                          + [[1e-30, 1e3, 2.3e-308, 1.7e308]])


# the table sizes and log-2 modes the kernels use: log_pos with 6 bits (the
# Stokeslet and Yukawa kernels), log_normal with 8 (the Laplace kernel)
_LOG_MODES = {"": (kernels.LOG_TABLE_BITS, True),
              "-laplace": (kernels.LAPLACE_LOG_TABLE_BITS, False)}


@pytest.mark.parametrize("which,mode", [
    pytest.param(w, m, id=w + m) for m in _LOG_MODES
    for w in ("wide", "near_one", "edges")])
def test_fast_log_matches_numpy(which, mode):
    """The twin of csrc/fp64_math.cuh log_pos and log_normal (same table,
    polynomial and log 2) against numpy's log in extended precision:
    absolute error at most 4e-16 max(1, |log a|)."""
    bits, split = _LOG_MODES[mode]
    a = _log_inputs(which, bits)
    want = np.log(a.astype(np.longdouble))
    got = kernels.fast_log(torch.as_tensor(a), bits,
                           split).numpy().astype(np.longdouble)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max()) <= 4e-16, float(err.max())
    if which == "near_one":
        one = torch.ones(1, dtype=torch.float64)
        assert kernels.fast_log(one, bits, split).item() == 0.0


def test_log_table():
    _check_log_table(kernels.LOG_TABLE_BITS)


def test_log_table_of_the_laplace_kernel():
    assert kernels.log_table(kernels.LAPLACE_LOG_TABLE_BITS) is \
        kernels.log_table(8)
    _check_log_table(kernels.LAPLACE_LOG_TABLE_BITS)


def _check_log_table(bits):
    full = kernels.log_table(bits)
    n = 1 << bits
    assert full.shape == (n + 5, 2) and not full.flags.writeable
    t = full[:n]
    assert np.array_equal(t[:, 1], -np.log(t[:, 0]))
    # c_i has at most 20 bits, so m_hi c_i and m_lo c_i are exact in the
    # twin and fma(m, c_i, -1) rounds once in the kernel
    mant = np.frexp(t[:, 0])[0] * 2.0 ** 20
    assert np.array_equal(mant, np.round(mant))
    assert (t[:, 0] == 1.0).sum() == 1 and (np.diff(t[:, 0]) < 0).all()
    # the constants, in the order of csrc/fp64_math.cuh LogConsts
    ln2_hi, ln2_lo, *q, min_r2, pad = full[n:].ravel()
    assert ln2_hi + ln2_lo == np.log(2.0) and abs(ln2_lo) < 2.0 ** -31
    assert ln2_hi.hex().endswith("00000p-1")      # e * ln2_hi is exact
    assert q == [(-1.0) ** (j + 1) / j for j in range(2, 8)]
    assert (min_r2, pad) == (kernels._MIN_R2, 0.0)


@pytest.mark.parametrize("which", ["wide", "k0_range", "edges"])
def test_fast_exp_neg_matches_numpy(which):
    """The twin of csrc/fp64_math.cuh exp_neg (same table, reduction and
    polynomial) against numpy's exp in extended precision: relative error
    at most 4e-16 on [-700, 0]."""
    rng = np.random.default_rng(14)
    if which == "wide":
        t = -rng.uniform(0, 700, 400_000)
    elif which == "k0_range":
        t = -rng.uniform(2, 36, 400_000)
    else:       # multiples of log(2)/64, where the reduction rounds either way
        t = -np.arange(0, 64 * 1000) * (np.log(2.0) / 64)
        t = np.concatenate([t, np.nextafter(t, 0), np.nextafter(t, -800),
                            [-700.0, -0.0, -1e-300]])
    want = np.exp(t.astype(np.longdouble))
    got = kernels.fast_exp_neg(torch.as_tensor(t)).numpy()
    err = np.abs(got.astype(np.longdouble) - want) / want
    assert float(err.max()) <= 4e-16, float(err.max())
    table = kernels.exp_table()
    n = kernels.EXP_TABLE_ENTRIES
    assert table.shape == (n + 8,) and not table.flags.writeable
    assert table[0] == 1.0 and np.all(np.diff(table[:n]) > 0) and table[n - 1] < 2
    assert table[n + 1] + table[n + 2] == np.log(2.0) / n


def test_library_key_covers_headers(tmp_path, monkeypatch):
    """A library is keyed on its source AND the headers of csrc/: an edited
    header builds anew and never loads a stale library."""
    from ipde_tpu_torch.utils import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "thing.cu").write_text("// source\n")
    (csrc / "shared.cuh").write_text("// header v1\n")
    fake = tmp_path / "fake_nvcc"
    fake.write_text("#!/bin/sh\nfor a; do out=$a; done\necho built > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_CSRC", csrc)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = kernels.library_path("thing")
    assert first.exists() and kernels.library_path("thing") == first
    (csrc / "shared.cuh").write_text("// header v2\n")
    second = kernels.library_path("thing")
    assert second != first and second.exists()
    (csrc / "thing.cu").write_text("// source, edited\n")
    assert kernels.library_path("thing") not in (first, second)
    (csrc / "thing.cu").write_text("// source\n")
    (csrc / "shared.cuh").write_text("// header v1\n")
    assert kernels.library_path("thing") == first


def _grad_rel(got, want):
    """Max difference relative to max(1, |gx| + |gy|) per row."""
    scale = (want[0].abs() + want[1].abs()).clamp_min(1.0)
    return max(float(((g - w).abs() / scale).max()) for g, w in zip(got, want))


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
    before = kernels.laplace_slp_grad_apply.launches
    got = kernels.laplace_slp_grad_apply(sx, sy, q, tx, ty)
    torch.cuda.synchronize()
    assert kernels.laplace_slp_grad_apply.launches == before + 1
    want = kernels.laplace_slp_grad_apply_plain(sx, sy, q, tx, ty)
    assert _grad_rel(got, want) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,seed", [(7200, 3600, 2), (12000, 1800, 3),
                                      (67584, 300, 4), (67585, 300, 4),
                                      (8193, 1023, 5), (33, 31, 6)])
@pytest.mark.parametrize("which", ["laplace", "grad"])
def test_cuda_kernel_split_and_ragged_shapes(which, T, S, seed):
    """Launches on either side of the split threshold (sources split across
    blocks up to 67,584 targets) and with T and S that are multiples of no
    tile: within 1e-12 of the plain version, and two runs bit-equal."""
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev)
            for a in _cloud(T=T, S=S, seed=seed)]
    stem, kernel, plain = {
        "laplace": ("laplace_slp", kernels.laplace_slp_apply,
                    kernels.laplace_slp_apply_plain),
        "grad": ("laplace_grad", kernels.laplace_slp_grad_apply,
                 kernels.laplace_slp_grad_apply_plain)}[which]
    if S >= 64:
        assert (kernels.split_count(stem, T, S) > 1) == (T <= 67584)
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if which == "laplace":
        assert torch.equal(got, again)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    else:
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _grad_rel(got, want) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["nan_target", "nan_source", "nan_charge",
                                  "inf_target", "coincident"])
@pytest.mark.parametrize("S", [300, 3600])
def test_cuda_kernel_carries_nan(S, case):
    """The kernels' loops neither clamp nor branch; a thread that meets an
    r^2 they do not take redoes its sum on the slow path.  With one source
    range (S = 300) and with several (S = 3,600): NaN where the plain
    version has NaN, and the plain version's values everywhere else."""
    dev = _cuda()
    sx, sy, q, tx, ty = (a.copy() for a in _cloud(T=600, S=S, seed=2))
    if case == "nan_target":
        ty[17] = np.nan
    elif case == "nan_source":
        sx[S - 1] = np.nan
    elif case == "nan_charge":
        q[5] = np.nan
    elif case == "inf_target":
        tx[300] = np.inf
    else:
        tx[0], ty[0] = sx[3], sy[3]
        tx[599], ty[599] = sx[S - 2], sy[S - 2]
    args = [torch.as_tensor(a, device=dev) for a in (sx, sy, q, tx, ty)]
    outs = [kernels.laplace_slp_apply(*args),
            *kernels.laplace_slp_grad_apply(*args)]
    wants = [kernels.laplace_slp_apply_plain(*args),
             *kernels.laplace_slp_grad_apply_plain(*args)]
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        if case == "nan_target":
            assert torch.isnan(got).nonzero().flatten().tolist() == [17]
        if case == "coincident":
            assert bool(torch.isfinite(got).all())
        ok = torch.isfinite(want)
        assert torch.equal(got[~ok & ~torch.isnan(want)],
                           want[~ok & ~torch.isnan(want)])      # infinities
        if bool(ok.any()):
            scale = max(float(want[ok].abs().max()), 1.0)
            assert float((got[ok] - want[ok]).abs().max()) <= 1e-12 * scale


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices():
    dev = _cuda()
    sx, sy, q, tx, ty = (torch.as_tensor(a) for a in _cloud(T=16, S=8, seed=1))
    with pytest.raises(ValueError):
        kernels.laplace_slp_apply(sx.to(dev), sy, q, tx, ty)
