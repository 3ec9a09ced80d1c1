"""Newton-in-time of the port (``solve/newton_ti.py``, reached through
``solve_nse(treat_nonl_explicit=False)`` and ``lin_vel_point``) vs the JAX
package on the CPU in f64: twins of ``tests/test_newton_ti.py`` on shorter
horizons — steady preservation, a perturbed start, a warm start about a
stored trajectory, temporal sections, Dirichlet control, static feedback
through ``solve_nse`` and the block-Schur preconditioner."""

import copy
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu.solve.newton_ti import (
    solve_nse_newton_ti as jax_newton_ti)
from dolfin_navier_scipy_tpu.solve.timeint import (
    DirichletControl as JaxDirichletControl)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity,
    observation_operator)
from dolfin_navier_scipy_tpu_torch.solve import (
    DirichletControl, solve_nse, solve_nse_newton_ti, solve_steadystate_nse)

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-10
TRANGE = np.linspace(0.0, 0.1, 11)
_CACHE = {}


def _cavity():
    """Both packages' cavity (N=8, nu=1e-2) and its steady state."""
    if "cavity" not in _CACHE:
        align_native()
        jp = jax_cavity(N=8, nu=1e-2)
        tp = torch_cavity(N=8, nu=1e-2, device="cpu")
        vss = np.asarray(solve_steadystate_nse(
            tp, linsolver="host-sparse", vel_nwtn_tol=1e-13)).ravel()
        _CACHE["cavity"] = (jp, tp, vss[jp.invinds])
    return _CACHE["cavity"]


def _perturbed(seed, scale):
    vss = _cavity()[2]
    return vss + scale * np.random.default_rng(seed).normal(size=len(vss))


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same(out, ref, keys=("v", "p", "v_traj")):
    for k in keys:
        assert _rel(out[k], ref[k]) <= RTOL, k
    assert len(out["nwtn_norms"]) == len(ref["nwtn_norms"])
    assert np.allclose(out["nwtn_norms"], ref["nwtn_norms"], rtol=1e-6,
                       atol=1e-14)
    assert out["ffflag"] is False


def _both(probs=None, **kw):
    """The same ``solve_nse`` call in both packages (on the cavity, or on
    ``probs``)."""
    jp, tp = probs or _cavity()[:2]
    ref = jax_solve_nse(prob=jp, treat_nonl_explicit=False, **kw)
    out = solve_nse(prob=tp, treat_nonl_explicit=False, device="cpu", **kw)
    return out, ref


def test_implicit_preserves_steady_state():
    vss = _cavity()[2]
    out, ref = _both(trange=TRANGE, iniv=vss, vel_nwtn_stps=3,
                     vel_nwtn_tol=1e-12, save_every=5)
    _same(out, ref, ("v", "p", "v_traj", "vs", "ps"))
    assert np.array_equal(out["times"], ref["times"])
    assert np.abs(out["v"].numpy() - vss).max() < 1e-8
    assert out["nwtn_norms"][-1] < 1e-8
    assert out["v_traj"].shape == (len(TRANGE), len(vss))
    st = out["stats"]
    assert st["sweeps"] == len(out["nwtn_norms"])
    assert st["matvecs"] == st["preconds"] > 0


def _perturbed_kw():
    return dict(trange=TRANGE, iniv=_perturbed(3, 0.05), vel_nwtn_tol=1e-12,
                save_every=None)


def _perturbed_runs(affine=True):
    """Both packages' runs from a perturbed state (shared by the tests that
    read them); ``affine=False``: on problems without element tensors,
    whose Newton system takes the sparse operators."""
    key = ("perturbed", affine)
    if key not in _CACHE:
        probs = None
        if not affine:
            probs = tuple(copy.copy(p) for p in _cavity()[:2])
            for p in probs:
                p.affine_ops = lambda *a, **k: None
        _CACHE[key] = _both(probs=probs, vel_nwtn_stps=6,
                            **_perturbed_kw())
    return _CACHE[key]


@pytest.mark.parametrize("affine", [True, False],
                         ids=["old", "no-affine-ops"])
def test_perturbed_start_matches_jax(affine):
    """From a perturbed state; also without element tensors."""
    out, ref = _perturbed_runs(affine=affine)
    _same(out, ref)
    assert out["vs"] is None and out["nwtn_norms"][-1] < 1e-12


def test_linearization_warm_start():
    """Newton about a stored trajectory (the port's own, handed over as a
    tensor; the JAX run gets its own: the converged perturbed-start runs)
    starts converged."""
    jp, tp, _ = _cavity()
    first, jfirst = _perturbed_runs()
    warm = solve_nse(prob=tp, treat_nonl_explicit=False, vel_nwtn_stps=2,
                     lin_vel_point=first["v_traj"], device="cpu",
                     **_perturbed_kw())
    jwarm = jax_solve_nse(prob=jp, treat_nonl_explicit=False,
                          vel_nwtn_stps=2,
                          lin_vel_point=np.asarray(jfirst["v_traj"]),
                          **_perturbed_kw())
    _same(warm, jwarm)
    assert warm["nwtn_norms"][0] < 1e-10


def test_nsects_sectioning():
    """Two temporal sections and a full sweep, each section starting with
    a Picard sweep and the Krylov solves started from the updated
    linearization (``krylovini="upd"``)."""
    out, ref = _both(trange=TRANGE, iniv=_perturbed(9, 0.03),
                     vel_nwtn_stps=6, vel_pcrd_stps=1, krylovini="upd",
                     vel_nwtn_tol=1e-12, nsects=2, addfullsweep=True,
                     save_every=None)
    _same(out, ref)
    assert out["v_traj"].shape == (len(TRANGE), len(_cavity()[2]))


def test_static_feedback_through_solve_nse():
    """``feedbackthroughdict``: umat = b_mat, vmat = mtxtb.T and the
    throughput b (b^T w) reach the Newton system (reference
    stokes_navier_utils.py:1367-1384)."""
    jp, tp, vss = _cavity()
    C = observation_operator(tp, ny=2)[:, tp.invinds]
    B, mtxtb = 1e-2 * C.T, 0.5 * C.T
    w = np.linspace(0, 1, len(vss))
    kw = dict(trange=TRANGE, iniv=_perturbed(4, 0.02), vel_nwtn_stps=3,
              vel_nwtn_tol=1e-12, save_every=None)
    out, ref = _both(closed_loop=True, static_feedback=True, b_mat=B,
                     feedbackthroughdict={None: dict(mtxtb=mtxtb, w=w)},
                     **kw)
    _same(out, ref)
    free = solve_nse(prob=tp, treat_nonl_explicit=False, device="cpu",
                     **kw)
    assert _rel(out["v"], free["v"].numpy()) > 1e-8


def _wake(**kw):
    key = ("wake", tuple(sorted(kw)))
    if key not in _CACHE:
        align_native()
        jp = jax_wake(level=0, Re=40, charvel=0.2, **kw)
        tp = torch_wake(level=0, Re=40, charvel=0.2, device="cpu", **kw)
        vss = np.asarray(solve_steadystate_nse(
            tp, linsolver="host-sparse", vel_pcrd_stps=2, vel_nwtn_stps=5,
            vel_nwtn_tol=1e-10)).ravel()
        _CACHE[key] = (jp, tp, vss[jp.invinds])
    return _CACHE[key]


def test_dirichlet_control_matches_jax():
    """The rotating cylinder (``sin(20 t)`` times the tangent stencil) in
    the implicit path, evaluated along the previous sweep's trajectory."""
    jp, tp, v0 = _wake(movingwallcntrl=True)
    dofs, stencil = tp.dircntrl[0]
    jdofs, jstencil = jp.dircntrl[0]
    trange = np.linspace(0.0, 0.003, 7)
    kw = dict(trange=trange, iniv=v0, inip=np.zeros(tp.np_cond),
              vel_nwtn_stps=2, vel_nwtn_tol=1e-12, save_every=None)
    out = solve_nse_newton_ti(
        prob=tp, device="cpu", **kw,
        controls=[DirichletControl(dofs, stencil,
                                   lambda t, v, p, m, mode: (
                                       math.sin(20.0 * t), m))])
    ref = jax_newton_ti(
        prob=jp, **kw,
        controls=[JaxDirichletControl(jdofs, jstencil,
                                      lambda t, v, p, m, mode: (
                                          jnp.sin(20.0 * t), m))])
    _same(out, ref)
    free = solve_nse_newton_ti(prob=tp, device="cpu", **kw)
    assert _rel(out["v"], free["v"].numpy()) > 1e-6


def test_schur_preconditioner_matches_jax():
    """The block-Schur Stokes-level solver as the preconditioner (the
    route past the dense window; here forced at wake level 0)."""
    jp, tp, v0 = _wake()
    v0 = v0 + 0.01 * np.random.default_rng(2).normal(size=len(v0))
    kw = dict(trange=np.linspace(0.0, 0.002, 3), iniv=v0,
              inip=np.zeros(tp.np_cond), vel_nwtn_stps=2,
              vel_nwtn_tol=1e-11, save_every=None, linsolver="schur")
    out = solve_nse_newton_ti(prob=tp, device="cpu", **kw)
    ref = jax_newton_ti(prob=jp, **kw)
    _same(out, ref)
    nrm = out["nwtn_norms"]
    assert all(b < a for a, b in zip(nrm, nrm[1:])), nrm


@pytest.mark.parametrize("kwargs,match", [
    (dict(save_data=True), "save_data"),
    (dict(paraviewoutput=True), "paraviewoutput"),
])
def test_the_keys_still_unported_raise(kwargs, match):
    _, tp, vss = _cavity()
    with pytest.raises(NotImplementedError, match=match):
        solve_nse(prob=tp, trange=TRANGE, iniv=vss,
                  treat_nonl_explicit=False, device="cpu", **kwargs)
