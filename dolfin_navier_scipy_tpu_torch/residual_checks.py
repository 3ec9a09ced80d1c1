"""Residual verifiers — the framework's "sanitizer" layer.

Twin of the JAX package's ``residual_checks.py`` (the reference's
``residual_checks.py``): weak-form steady-state residuals (incl. the
drag/lift-by-test-function trick, :42-56), IMEX update residuals for the
explicit schemes (:59-103), and the Leray-projected residual (:16-38).

The reference cross-validates its scipy-side updates against an
independently dolfin-assembled weak form ("double-entry bookkeeping",
tests/test_units_residuals.py).  Here the two independent sides are the
device kernels (torch, the hand-written CUDA kernels on the card) and the
host numpy assembly oracles: every function here runs on the host, and
takes numpy arrays or tensors (on any device; they are read back).
"""

import numpy as np
import torch

from .ops.convection import convection_vector_host
from .solve.sadpnt import solve_sadpnt_host


def _np(x):
    """A caller's vector as a flat host f64 array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64).ravel()


def get_steady_state_res(prob, rho=1.0):
    """Returns ``res(v_full, p, phi=None)``.

    Without ``phi``: the full-dof steady momentum residual
    ``A v + N(v)v - J^T p - fv`` (host assembly — independent of the
    device kernels).  With ``phi`` (a full-dof test vector): the scalar
    ``phi^T R`` — the Babuska-Miller functional trick
    (residual_checks.py:42-56).
    """
    A = prob.full["A"]
    JT = prob.full["JT"]

    fvb = (np.zeros(prob.nv_full) if prob.fv_body_full is None
           else np.asarray(prob.fv_body_full).ravel())

    def res(v_full, p, phi=None):
        v_full = _np(v_full)
        p = _np(p)
        if prob.geo.ppin is not None and len(p) == prob.np_cond:
            p = np.concatenate([p, [0.0]])
        conv = convection_vector_host(prob.ctx, v_full).ravel()
        R = rho * (A @ v_full + conv - JT @ p - fvb)
        if phi is None:
            return R
        return float(_np(phi) @ R)

    return res


def app_prj_via_sadpnt(amat=None, jmat=None, rhsv=None, jmatT=None,
                       transposedprj=False):
    """Apply the discrete Leray projector via a saddle-point solve
    (the ``lau.app_prj_via_sadpnt`` interface, SURVEY.md 2.9).

    Solves ``[[amat, J^T],[J, 0]] [w; lam] = [rhsv; 0]``; returns
    ``rhsv - J^T lam = Pi^T rhsv`` when ``transposedprj`` else
    ``w = Pi amat^{-1} rhsv``.
    """
    rhsv = _np(rhsv).reshape(-1, 1)
    out = solve_sadpnt_host(amat=amat, jmat=jmat, jmatT=jmatT, rhsv=rhsv)
    nv = amat.shape[0]
    if transposedprj:
        jT = jmat.T if jmatT is None else jmatT
        return rhsv - jT @ out[nv:]
    return out[:nv]


def prjctd_steadystate_res(prob, v_full, p=None):
    """Leray-projected steady residual on the inner dofs
    (residual_checks.py:16-38): pressure-independent residual norm."""
    res = get_steady_state_res(prob)(
        v_full, np.zeros(prob.np_cond + (1 if prob.geo.ppin else 0)))
    rin = res[prob.invinds]
    return app_prj_via_sadpnt(amat=prob.Mc, jmat=prob.Jc, jmatT=prob.JTc,
                              rhsv=rin, transposedprj=True)


def get_imex_res(prob, dt, scheme="heun"):
    """Returns the discrete IMEX residual function for the bootstrap and
    AB2 steps (reference residual_checks.py:59-103).

    All convection terms are evaluated with the *host* oracle so that a
    vanishing residual certifies the device-side integrator.

    ``res(...)`` signatures (full-dof velocity vectors, raw scaled
    pressure ``ptilde = -dt * p_phys``):

    * ``eule``: ``res(v_old, v_new, p_new)``
      ``M(v_n - v_c) + dt A v_n + J^T ptil + dt N(v_c)v_c - dt fv = 0``
    * ``heun``: ``res(v_old, v_pred, v_new, p_new)`` (trapezoidal corr.)
    * ``abtw``: ``res(v_prevprev_conv..., see code)``
    """
    Mf = prob.full["M"]
    Af = prob.full["A"]
    JTf = prob.full["JT"]
    inv = prob.invinds
    # NOTE: products with *full* operators already account for the
    # Dirichlet columns, so only the body force is subtracted (the merged
    # rhs would double-count the bc folds)
    fv = (np.zeros(len(inv)) if prob.fv_body_full is None
          else np.asarray(prob.fv_body_full).ravel()[inv])

    def _conv(v):
        return convection_vector_host(prob.ctx, _np(v)).ravel()

    def _ptil(p_phys):
        p = _np(p_phys)
        if prob.geo.ppin is not None and len(p) == prob.np_cond:
            p = np.concatenate([p, [0.0]])
        return -dt * p

    if scheme == "eule":
        def res(v_old, v_new, p_new):
            r = (Mf @ (_np(v_new) - _np(v_old))
                 + dt * (Af @ _np(v_new))
                 + JTf @ _ptil(p_new)
                 + dt * _conv(v_old))
            return r[inv] - dt * fv
    elif scheme == "heun":
        def res(v_old, v_pred, v_new, p_new):
            vo = _np(v_old)
            vn = _np(v_new)
            r = (Mf @ (vn - vo)
                 + 0.5 * dt * (Af @ (_np(v_pred) + vo))
                 + JTf @ _ptil(p_new)
                 + 0.5 * dt * (_conv(v_old) + _conv(v_pred)))
            return r[inv] - dt * fv
    elif scheme == "abtw":
        def res(v_oldold, v_old, v_new, p_new):
            vo = _np(v_old)
            vn = _np(v_new)
            r = (Mf @ (vn - vo)
                 + 0.5 * dt * (Af @ (vn + vo))
                 + JTf @ _ptil(p_new)
                 + 0.5 * dt * (3 * _conv(v_old) - _conv(v_oldold)))
            return r[inv] - dt * fv
    else:
        raise ValueError(scheme)
    return res
