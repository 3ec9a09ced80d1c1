"""The Krylov solvers of the port vs the JAX package's on the CPU in f64:
the two device GMRES twins (``device_pgmres``: JAX's batched GMRES;
``device_fgmres``: the flexible one, also with a nonlinear
preconditioner), the host ``solve_sadpnt_krylov`` and ``solve_sadpnt(
krylov=...)``, ``KrylovSaddleSolver`` and ``cnab(linsolver='krylov')``."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import cnab as jax_cnab
from dolfin_navier_scipy_tpu.solve.krylov import (
    device_fgmres as jax_fgmres, device_pgmres as jax_pgmres,
    solve_sadpnt_krylov as jax_sadpnt_krylov)
from dolfin_navier_scipy_tpu.solve.krylov_saddle import (
    KrylovSaddleSolver as JaxKrylovSaddleSolver)
from dolfin_navier_scipy_tpu.solve.timeint import _build_ops as jax_ops
from dolfin_navier_scipy_tpu_torch.models import (
    drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.solve import (
    KrylovSaddleSolver, cnab, device_fgmres, device_pgmres, solve_nse,
    solve_sadpnt, solve_sadpnt_krylov)
from dolfin_navier_scipy_tpu_torch.solve.sadpnt import solve_sadpnt_host
from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops

from torch_parity import align_native

torch.set_num_threads(1)
_CACHE = {}


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _system(n=40, seed=11):
    """A seeded nonsymmetric, diagonally weighted system."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n) + np.diag(
        2.0 + rng.uniform(size=n))
    return A, rng.normal(size=n), 1.0 / np.diag(A)


@pytest.mark.parametrize("restart, maxiter", [(8, 3), (40, 1)])
def test_device_pgmres_matches_jax(restart, maxiter):
    """Batched GMRES: the same cycles (a tolerance they cannot reach)
    give the same iterate; the n-dimensional restart solves exactly."""
    A, b, d = _system()
    At, dt_ = torch.as_tensor(A), torch.as_tensor(d)
    out = device_pgmres(lambda x: At @ x, torch.as_tensor(b),
                        lambda x: dt_ * x, tol=1e-15, restart=restart,
                        maxiter=maxiter)
    ref = jax.jit(lambda bb: jax_pgmres(
        lambda x: jnp.asarray(A) @ x, bb, lambda x: jnp.asarray(d) * x,
        tol=1e-15, restart=restart, maxiter=maxiter))(jnp.asarray(b))
    assert _rel(out, ref) <= 1e-10
    if restart >= len(b):
        assert _rel(out, np.linalg.solve(A, b)) <= 1e-10
    # stopped by the tolerance: the same number of short cycles
    x1 = device_pgmres(lambda x: At @ x, torch.as_tensor(b),
                       lambda x: dt_ * x, tol=1e-4, restart=3,
                       maxiter=50)
    r1 = jax.jit(lambda bb: jax_pgmres(
        lambda x: jnp.asarray(A) @ x, bb, lambda x: jnp.asarray(d) * x,
        tol=1e-4, restart=3, maxiter=50))(jnp.asarray(b))
    assert _rel(x1, r1) <= 1e-10
    assert 1e-6 < _rel(A @ x1.numpy(), b) < 1e-2


@pytest.mark.parametrize("nonlinear", [False, True])
def test_device_fgmres_matches_jax(nonlinear):
    A, b, d = _system()
    At, dt_, dj = torch.as_tensor(A), torch.as_tensor(d), jnp.asarray(d)
    if nonlinear:
        def pt(u):
            return dt_ * u * (1.0 + 0.1 * torch.tanh(u))

        def pj(u):
            return dj * u * (1.0 + 0.1 * jnp.tanh(u))
    else:
        def pt(u):
            return dt_ * u

        def pj(u):
            return dj * u
    x0 = np.full(len(b), 0.1)
    out = device_fgmres(lambda x: At @ x, pt, torch.as_tensor(b),
                        restart=10, cycles=3, x0=torch.as_tensor(x0))
    ref = jax_fgmres(lambda x: jnp.asarray(A) @ x, pj, jnp.asarray(b),
                     restart=10, cycles=3, x0=jnp.asarray(x0))
    assert _rel(out, ref) <= 1e-10
    assert _rel(A @ out.numpy(), b) <= 1e-6


def _cavity(N):
    key = ("cavity", N)
    if key not in _CACHE:
        align_native()
        _CACHE[key] = (jax_cavity(N=N, nu=1e-2),
                       torch_cavity(N=N, nu=1e-2, device="cpu"))
    return _CACHE[key]


def test_solve_sadpnt_krylov_matches_jax_and_the_direct_solve():
    jp, tp = _cavity(6)
    rhsv = np.random.default_rng(9).normal(size=len(tp.invinds))
    stats = []
    prm = dict(tol=1e-12, maxiter=400, restart=200)
    x, counter = solve_sadpnt_krylov(
        amat=tp.Mc, jmat=tp.Jc, jmatT=tp.JTc, rhsv=rhsv,
        krpslvprms=dict(prm, convstatsl=stats))
    xj, _ = jax_sadpnt_krylov(amat=jp.Mc, jmat=jp.Jc, jmatT=jp.JTc,
                              rhsv=rhsv, krpslvprms=dict(prm))
    direct = solve_sadpnt_host(amat=tp.Mc, jmat=tp.Jc, jmatT=tp.JTc,
                               rhsv=rhsv)
    assert len(stats) == counter.niter > 0 and stats[-1] < 1e-10
    assert _rel(x, xj) <= 1e-10
    assert np.abs(x - direct).max() <= 1e-7
    # the functional entry point routes there
    xs = solve_sadpnt(amat=tp.Mc, jmat=tp.Jc, jmatT=tp.JTc, rhsv=rhsv,
                      krylov="gmres", krpslvprms=prm, device="cpu")
    assert _rel(xs, x) == 0.0


def test_krylov_saddle_solver_matches_jax():
    jp, tp = _cavity(6)
    tdt = 0.5 * 0.01
    coeff = sps.csr_matrix(tp.Mc + tdt * tp.Ac)
    slv = KrylovSaddleSolver(coeff=coeff, jmat=tp.Jc,
                             aff=tp.affine_ops(device="cpu"), theta_dt=tdt,
                             mp=tp.MP, tol=1e-11, device="cpu")
    jslv = JaxKrylovSaddleSolver(
        coeff=sps.csr_matrix(jp.Mc + tdt * jp.Ac), jmat=jp.Jc,
        aff=jp.affine_ops(), theta_dt=tdt, mp=jp.MP, tol=1e-11)
    rng = np.random.default_rng(12)
    rv, rp = rng.normal(size=slv.nv), rng.normal(size=slv.np)
    x, res = slv.solve_res(torch.as_tensor(rv), torch.as_tensor(rp))
    xj = jax.jit(jslv.solve)(jnp.asarray(rv), jnp.asarray(rp))
    assert _rel(x, xj) <= 1e-10
    direct = solve_sadpnt_host(amat=coeff, jmat=tp.Jc, jmatT=tp.JTc,
                               rhsv=rv, rhsp=rp).ravel()
    assert _rel(x, direct) <= 1e-8
    assert float(res) <= 1e-9
    with pytest.raises(ValueError, match="refinement"):
        slv.solve(rv, rp, refine=1)


def test_krylov_cnab_matches_jax_and_the_dense_route():
    """20 CNAB steps on the Krylov solver: the JAX package's run to 1e-10,
    the port's dense route to 1e-8; ``solve_nse(krylov=...)`` is that
    run."""
    jp, tp = _cavity(8)
    rng = np.random.default_rng(13)
    v0 = 0.1 * rng.normal(size=len(tp.invinds))
    trange = np.linspace(0.0, 0.05, 21)
    dt = float(trange[1] - trange[0])
    ops = _build_ops(tp, dt, theta=0.5, linsolver="krylov", device="cpu")
    assert isinstance(ops.solver, KrylovSaddleSolver)
    assert ops.solver.tol == 1e-11
    out = cnab(trange=trange, prob=tp, inivel=v0, ops=ops, save_every=None,
               device="cpu")
    jout = jax_cnab(trange=trange, prob=jp, inivel=v0, save_every=None,
                    ops=jax_ops(jp, dt, theta=0.5, linsolver="krylov"))
    dense = cnab(trange=trange, prob=tp, inivel=v0, linsolver="dense",
                 save_every=None, device="cpu")
    assert _rel(out["v"], jout["v"]) <= 1e-10
    assert _rel(out["v"], dense["v"]) <= 1e-8
    nse = solve_nse(prob=tp, trange=trange, iniv=v0, krylov="gmres",
                    save_every=None, device="cpu")
    assert _rel(nse["v"], out["v"]) <= 1e-12
