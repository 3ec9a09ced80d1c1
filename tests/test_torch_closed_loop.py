"""Closed-loop feedback through the port's ``solve_nse`` vs the JAX package
on the CPU in f64 — twins of the JAX package's
``test_solve_nse_closed_loop_dynamic`` and
``test_solve_nse_static_feedback_facade``: dynamic LTI feedback (AB2,
trapezoidal, the monolithic linear-implicit augmentation) and static
feedback through ``feedbackthroughdict`` (arrays and ``.npy`` paths)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import drivencavity_problem as jax_cavity
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu_torch.control import get_heunab_lti
from dolfin_navier_scipy_tpu_torch.models import (
    drivencavity_problem as torch_cavity, observation_operator)
from dolfin_navier_scipy_tpu_torch.solve import (
    solve_nse, solve_steadystate_nse)

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-10
_CACHE = {}


def _setup():
    if not _CACHE:
        align_native()
        jp, tp = (jax_cavity(N=8, nu=1e-2),
                  torch_cavity(N=8, nu=1e-2, device="cpu"))
        v0 = solve_steadystate_nse(tp, only_stokes=True).ravel()[tp.invinds]
        C = observation_operator(tp, ny=2)[:, tp.invinds]
        _CACHE.update(jp=jp, tp=tp, v0=v0, C=C,
                      kw=dict(t0=0.0, tE=0.1, Nts=40, iniv=v0,
                              save_every=None))
    return _CACHE


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _observer():
    s = _setup()
    ny, nin, hN = s["C"].shape[0], len(s["tp"].invinds), 3
    rng = np.random.default_rng(5)
    hA = -np.eye(hN)
    hB = 0.3 * rng.normal(size=(hN, ny))
    hC = 0.05 * rng.normal(size=(ny, hN))
    B = 1e-2 * rng.normal(size=(nin, ny))
    return dict(ha=hA, hb=hB, hc=hC, inihx=np.ones(hN)), B


def _dynamic(pkg, disc):
    key = (pkg, disc)
    if key not in _CACHE:
        s = _setup()
        dfb, B = _observer()
        kw = dict(closed_loop=True, dynamic_feedback=True, dyn_fb_dict=dfb,
                  dyn_fb_disc=disc, b_mat=B, cv_mat=s["C"], **s["kw"])
        _CACHE[key] = (jax_solve_nse(prob=s["jp"], **kw) if pkg == "jax"
                       else solve_nse(prob=s["tp"], device="cpu", **kw))
    return _CACHE[key]


def test_closed_loop_dynamic_equals_hand_built_dynamic_rhs():
    s = _setup()
    dfb, B = _observer()
    out = _dynamic("torch", "AB2")
    fbk, mem0 = get_heunab_lti(hb=dfb["hb"], ha=dfb["ha"], hc=dfb["hc"],
                               inihx=dfb["inihx"], device="cpu")
    Bt, Ct = torch.from_numpy(B), torch.from_numpy(s["C"])

    def dynamic_rhs(t, vc=None, memory=None, mode=None):
        u, memory = fbk(t, vc=Ct @ vc, memory=memory, mode=mode)
        return Bt @ u, memory

    ref = solve_nse(prob=s["tp"], dynamic_rhs=dynamic_rhs,
                    dynamic_rhs_memory=mem0, device="cpu", **s["kw"])
    assert np.abs((out["v"] - ref["v"]).numpy()).max() <= 1e-13
    assert not out["ffflag"]


@pytest.mark.parametrize("disc", ["AB2", "trapezoidal", "linear_implicit"])
def test_closed_loop_dynamic_matches_jax(disc):
    out, ref = _dynamic("torch", disc), _dynamic("jax", disc)
    assert _rel(out["v"], ref["v"]) <= RTOL
    assert _rel(out["p"], ref["p"]) <= RTOL
    if disc != "AB2":
        # the same closed loop, another discretization of the observer
        ab2 = _dynamic("torch", "AB2")["v"].numpy()
        assert np.abs(out["v"].numpy() - ab2).max() <= 1e-4
    if disc == "linear_implicit":
        assert out["hx"].shape == (3,)
        assert _rel(out["hx"], ref["hx"]) <= RTOL


def test_closed_loop_dynamic_discretization_is_checked():
    s = _setup()
    dfb, B = _observer()
    with pytest.raises(ValueError):
        solve_nse(prob=s["tp"], closed_loop=True, dynamic_feedback=True,
                  dyn_fb_dict=dfb, dyn_fb_disc="RK4", b_mat=B,
                  cv_mat=s["C"], device="cpu", **s["kw"])


@pytest.mark.parametrize("stored", [False, True])
def test_static_feedback_facade(stored, tmp_path):
    """feedbackthroughdict: umat = b_mat, vmat = mtxtb.T, rhs throughput
    b (b^T w) (reference stokes_navier_utils.py:1367-1384); the entries as
    arrays or as ``.npy`` paths (with and without the suffix)."""
    s = _setup()
    tp, C = s["tp"], s["C"]
    nin = len(tp.invinds)
    B = 1e-2 * C.T
    mtxtb = 0.5 * C.T
    w = np.linspace(0, 1, nin)
    if stored:
        np.save(tmp_path / "mtxtb.npy", mtxtb)
        np.save(tmp_path / "w.npy", w)
        fbtd = {None: dict(mtxtb=str(tmp_path / "mtxtb.npy"),
                           w=str(tmp_path / "w"))}
    else:
        fbtd = {None: dict(mtxtb=mtxtb, w=w)}
    out = solve_nse(prob=tp, closed_loop=True, static_feedback=True,
                    feedbackthroughdict=fbtd, b_mat=B, device="cpu",
                    **s["kw"])
    fv_fb = torch.from_numpy((B @ (B.T @ w)).ravel())
    fv0 = torch.from_numpy(np.asarray(tp.fv).ravel())
    ref = solve_nse(prob=tp, umat=B, vmat=mtxtb.T,
                    f_tdp=lambda t: fv0 + fv_fb, device="cpu", **s["kw"])
    assert np.abs((out["v"] - ref["v"]).numpy()).max() <= 1e-13
    if stored:
        jout = jax_solve_nse(
            prob=s["jp"], closed_loop=True, static_feedback=True,
            feedbackthroughdict={None: dict(mtxtb=mtxtb, w=w)}, b_mat=B,
            **s["kw"])
        assert _rel(out["v"], jout["v"]) <= RTOL
        # with a caller's own forcing the throughput adds to it
        jfv0 = jnp.asarray(np.asarray(s["jp"].fv).ravel())
        out2 = solve_nse(prob=tp, closed_loop=True, static_feedback=True,
                         feedbackthroughdict=fbtd, b_mat=B,
                         f_tdp=lambda t: 2.0 * fv0, device="cpu", **s["kw"])
        ref2 = jax_solve_nse(
            prob=s["jp"], closed_loop=True, static_feedback=True,
            feedbackthroughdict={None: dict(mtxtb=mtxtb, w=w)}, b_mat=B,
            f_tdp=lambda t: 2.0 * jfv0, **s["kw"])
        assert _rel(out2["v"], ref2["v"]) <= RTOL
