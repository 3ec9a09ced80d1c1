"""Matrix-free Krylov saddle solver for large meshes.

The dense-inverse solver is O(n^2) memory and its host factorization
O(n^3); for the time-step saddle

    [[M + theta dt A, J^T], [J, 0]]

the system is mass-dominated at CFL-scale dt, so a cheap block
preconditioner works: Jacobi with ``diag(M + theta dt A)`` on the
velocity block and the inverse of the SIMPLE-type Schur approximation
``J diag(.)^-1 J^T`` (small: ``np << nv``) on the pressure block.  Every
operator application is a hand-written kernel on the card: the affine
element matvecs (:func:`..ops.kernels.affine_mv`) and the dense Schur
inverse by :func:`..ops.kernels.vecmat`.
"""

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device
from ..ops.kernels import as_vecmat_operand, vecmat
from .krylov import device_pgmres


class KrylovSaddleSolver:
    """GMRES on the saddle with block-triangular preconditioning; drop-in
    for :class:`..solve.sadpnt.InverseSaddleSolver.solve` (returns the
    stacked raw ``[v; q]``)."""

    def __init__(self, coeff=None, jmat=None, aff=None, theta_dt=None,
                 mp=None, tol=1e-8, restart=20, maxiter=4, dtype=None,
                 device=None):
        device = resolve_device(device)
        dtype = dtype or torch.float64
        self.dtype = dtype
        self.device = device
        self.tol = tol
        self.restart = restart
        self.maxiter = maxiter
        self.nv = coeff.shape[0]
        self.np = jmat.shape[0]
        self.Kop = aff.view("ma", cm=1.0, ca=theta_dt)
        self.Jop = aff.view("j")
        dv = np.asarray(sps.csr_matrix(coeff).diagonal())
        self.dinv_v = torch.as_tensor(1.0 / dv).to(device=device,
                                                   dtype=dtype)
        # SIMPLE-type Schur approximation: Shat = J diag(K)^-1 J^T is an
        # exact sparse product; the pressure space is small (np << nv),
        # so its dense inverse is cheap to form and to apply
        J = sps.csr_matrix(jmat)
        Shat = np.asarray((J @ sps.diags(1.0 / dv) @ J.T).todense())
        # enclosed flows: Shat is singular up to the constant mode unless
        # the pressure is pinned; regularize with the mass scale
        mpd = np.asarray(sps.csr_matrix(mp).diagonal())[: self.np]
        Shat = Shat + 1e-12 * np.diag(mpd)
        # stored transposed for vecmat (y = x @ SinvT = Sinv x)
        self.SinvT = as_vecmat_operand(
            torch.as_tensor(np.linalg.inv(Shat).T), dtype, device)

    def _matvec(self, x):
        v, q = x[: self.nv], x[self.nv:]
        rv = self.Kop.matvec(v) + self.Jop.rmatvec(q)
        rp = self.Jop.matvec(v)
        return torch.cat([rv, rp])

    def _precond(self, x):
        """Block upper-triangular SIMPLE preconditioner:
        ``y_p = -Sinv x_p;  y_v = Dv^{-1} (x_v - J^T y_p)``."""
        y_p = -vecmat(x[self.nv:].contiguous(), self.SinvT)
        y_v = self.dinv_v * (x[: self.nv] - self.Jop.rmatvec(y_p))
        return torch.cat([y_v, y_p])

    def _rhs(self, rhsv, rhsp):
        return torch.cat([torch.as_tensor(rhsv).reshape(-1),
                          torch.as_tensor(rhsp).reshape(-1)]).to(
            device=self.device, dtype=self.dtype)

    def solve(self, rhsv, rhsp, x0=None, refine=None):
        """GMRES (:func:`..solve.krylov.device_pgmres`) from ``x0``
        (default 0).  ``refine``: the dense solvers' residual rounds; the
        Krylov solve has none (its ``tol`` sets the accuracy)."""
        if refine:
            raise ValueError("KrylovSaddleSolver has no refinement rounds: "
                             "its tolerance sets the accuracy")
        rhs = self._rhs(rhsv, rhsp)
        return device_pgmres(self._matvec, rhs, self._precond, x0=x0,
                             tol=self.tol, restart=self.restart,
                             maxiter=self.maxiter)

    def residual(self, rhsv, rhsp, x):
        """Relative true residual ``|b - K x| / |b|`` of a returned
        solution (one extra matvec, no host read): the convergence
        telemetry the fixed ``maxiter`` otherwise hides."""
        rhs = self._rhs(rhsv, rhsp)
        r = rhs - self._matvec(x)
        return torch.linalg.norm(r) / torch.linalg.norm(rhs)

    def solve_res(self, rhsv, rhsp, x0=None):
        """``(x, relres)`` — solve plus the true-residual telemetry."""
        x = self.solve(rhsv, rhsp, x0=x0)
        return x, self.residual(rhsv, rhsp, x)


def build_krylov_ops(prob, dt, theta=0.5, tol=1e-8, restart=20, maxiter=4,
                     dtype=None, device=None):
    """:class:`..solve.timeint.TimeIntOps` with the Krylov saddle solver
    (for meshes beyond the dense-inverse range)."""
    from .timeint import TimeIntOps

    device = resolve_device(device)
    dtype = dtype or torch.float64
    aff = prob.affine_ops(dtype, device=device)
    coeff = sps.csr_matrix(prob.Mc + theta * dt * prob.Ac)
    solver = KrylovSaddleSolver(coeff=coeff, jmat=prob.Jc, aff=aff,
                                theta_dt=theta * dt, mp=prob.MP,
                                tol=tol, restart=restart, maxiter=maxiter,
                                dtype=dtype, device=device)
    return TimeIntOps(solver=solver, M=aff.view("m"), A=aff.view("a"),
                      dt=dt, theta=theta, wdtype=dtype, device=device)
