"""Steady-state Navier-Stokes solver: Stokes init -> Picard -> Newton.

The reference's ``solve_steadystate_nse`` (stokes_navier_utils.py:212-545)
on three routes, all with the reference's M-norm update criterion and
Picard -> Newton switch (tolerances: stokes_navier_utils.py:222-223):

* ``'dense'`` (:class:`SteadySolverKernel`): per iteration the linearized
  convection element blocks (:meth:`..ops.convection.ConvectionKernel.
  element_matrices`) are added into the dense condensed saddle matrix on
  the device through a fixed-order table (the same bits on every run),
  which is LU-factorized in f64 (``torch.linalg.lu_factor``; the card has
  an f64 LU, so no refinement rounds are needed),
* ``'host-sparse'`` (:func:`_host_route`): one host convection assembly
  and one scipy ``splu`` per iteration, the reference's recipe,
* ``'krylov'`` (:class:`SteadyKrylovKernel`): matrix-free f32 flexible
  GMRES with a block-triangular (LSC) preconditioner inside f64 iterative
  refinement, at any mesh size; large meshes first march in pseudo-time
  (:func:`solve_steadystate_pseudotime`).

The returned pressure is the physical one (the raw saddle ``q`` is
flipped, as in stokes_navier_utils.py:403,:469,:503).
"""

import glob
import logging
import os
import time
import warnings

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device
from ..ops.kernels import DofTable, as_vecmat_operand, dof_slot_table, \
    ell_slot_table, elem_mv, vecmat
from .sadpnt import host_saddle_factorized, jacobi_pcg


def _m_norm_host(Mc):
    """``dv -> sqrt|dv^T Mc dv|`` with scipy (the host route)."""
    Mc = sps.csr_matrix(Mc)

    def mnorm(dv):
        dv = np.asarray(dv, np.float64).ravel()
        return float(np.sqrt(abs(dv @ (Mc @ dv))))

    return mnorm


def _m_norm_device(prob, device):
    """``dv -> sqrt|dv^T M dv|`` on ``device``: one affine ``M`` matvec
    (f64 tables) and one host read a call."""
    m = prob.affine_ops(torch.float64, device=device).view("m")

    def mnorm(dv):
        return float(torch.sqrt(torch.abs(dv @ m.matvec(dv))))

    return mnorm


def _picard_newton(stokes, linsolve, mnorm, start, only_stokes,
                   vel_pcrd_stps, vel_pcrd_tol, vel_nwtn_stps, vel_nwtn_tol,
                   verbose, log):
    """The reference's outer loop (stokes_navier_utils.py:438-525) over one
    route's solves: the Stokes solve ``stokes() -> (v, p)`` (or ``start``),
    then Picard and Newton steps ``linsolve(v, p, picard) -> (v, p)`` until
    the M-norm update ``mnorm(dv)`` falls under its tolerance.  Returns
    ``(v_inner, p, newton_norms)``."""
    v_inner, p = stokes() if start is None or only_stokes else start
    norms = []
    if only_stokes:
        return v_inner, p, norms
    for k in range(vel_pcrd_stps):
        v_new, p = linsolve(v_inner, p, True)
        upd = mnorm(v_new - v_inner)
        v_inner = v_new
        if verbose:
            log.info(f"Picard iteration {k + 1} -- update norm {upd:e}")
        if upd < vel_pcrd_tol:
            break
    for k in range(vel_nwtn_stps):
        v_new, p = linsolve(v_inner, p, False)
        upd = mnorm(v_new - v_inner)
        norms.append(upd)
        v_inner = v_new
        if verbose:
            log.info(f"Newton iteration {k + 1} -- update norm {upd:e}")
        if upd < vel_nwtn_tol:
            return v_inner, p, norms
    if vel_nwtn_stps > 0:
        warnings.warn("Steady State NSE: Newton has not converged",
                      UserWarning)
    return v_inner, p, norms


# ---------------------------------------------------------------------------
# the dense route
# ---------------------------------------------------------------------------

class SteadySolverKernel:
    """Device state of the dense steady solve for one condensed problem:
    the condensed Stokes saddle matrix ``Kbase`` (dense, f64), the table
    that adds the linearized convection element blocks into it, and the
    vectors of the right-hand side."""

    def __init__(self, prob, device=None):
        device = resolve_device(device)
        self.device = device
        nin = len(prob.invinds)
        npp = prob.np_cond
        self.nin, self.npp = nin, npp
        self.ncond = ncond = nin + npp

        # the dense condensed Stokes saddle matrix, filled on the device
        K = sps.bmat([[prob.Ac, prob.JTc], [prob.Jc, None]]).tocsr()
        K.sum_duplicates()
        K = K.tocoo()
        self.Kbase = torch.zeros((ncond, ncond), dtype=torch.float64,
                                 device=device)
        self.Kbase[torch.as_tensor(K.row, device=device),
                   torch.as_tensor(K.col, device=device)] = \
            torch.as_tensor(K.data, device=device)

        # the element blocks (nc, nvpc, dim, nvpc, dim) -> K: each distinct
        # target entry sums its element contributions in ascending element
        # order (an ELL gather and a sum, then one write per entry: no
        # atomics)
        full2cond = np.full(prob.nv_full, ncond, dtype=np.int64)
        full2cond[prob.invinds] = np.arange(nin, dtype=np.int64)
        cvd = full2cond[prob.space.vdofs_of_cells()]
        cvd = cvd.reshape(cvd.shape[0], -1)
        nd = cvd.shape[1]
        rows = np.broadcast_to(cvd[:, :, None], cvd.shape + (nd,))
        cols = np.broadcast_to(cvd[:, None, :], cvd.shape + (nd,))
        keep = ((rows < ncond) & (cols < ncond)).ravel()
        flat = (rows * ncond + cols).ravel()
        uniq, inv = np.unique(flat[keep], return_inverse=True)
        seg = np.full(flat.shape, len(uniq), dtype=np.int64)
        seg[keep] = inv
        ell = ell_slot_table(*dof_slot_table(seg, len(uniq)))
        self.k_pos = torch.as_tensor(uniq, device=device)
        self.k_ell = torch.as_tensor(
            np.where(ell >= 0, ell, len(flat)).astype(np.int64),
            device=device)

        self.kern = prob.conv_kernel_on(torch.float64, device)
        self.invinds = torch.as_tensor(prob.invinds, device=device)
        self.v_bc = torch.as_tensor(prob.bc_full_vec(), device=device)
        self.fv = torch.as_tensor(np.asarray(prob.fv, np.float64).ravel(),
                                  device=device)
        self.fp = torch.as_tensor(np.asarray(prob.fp, np.float64).ravel(),
                                  device=device)
        self.m_norm = _m_norm_device(prob, device)

    def embed(self, v_inner):
        full = self.v_bc.clone()
        full[self.invinds] = v_inner
        return full

    def rhs(self, v_full, picard):
        """fv + convection rhs + bc-folding terms on the inner dofs.

        Newton adds ``(u0.grad)u0`` (stokes_navier_utils.py:497-499); the
        Dirichlet-column folding ``-N @ u_bc`` is evaluated matrix-free via
        two-field convection vectors."""
        conbc = self.kern.vector(self.v_bc, v_full)      # (u0.grad)u_bc
        if not picard:
            conbc = conbc + self.kern.vector(v_full, self.v_bc)
        rv = self.fv - conbc[self.invinds]
        if not picard:
            rv = rv + self.kern.vector(v_full)[self.invinds]
        return rv, self.fp

    def assemble(self, v_full, picard):
        """``Kbase`` plus the linearized convection at ``v_full``."""
        elem = self.kern.element_matrices(v_full, picard_only=picard)
        vals = torch.cat([elem.reshape(-1), elem.new_zeros(1)])
        K = self.Kbase.clone()
        Kf = K.view(-1)
        Kf[self.k_pos] = Kf[self.k_pos] + vals[self.k_ell].sum(0)
        return K


    def factorize(self, v_full, picard):
        """Assemble the linearized saddle matrix on the device and
        LU-factorize it in f64 (the JAX package factors in f32 with f64
        refinement rounds on accelerators: the TPU has no f64 LU).  Returns
        ``(lu, pivots)``."""
        return torch.linalg.lu_factor(self.assemble(v_full, picard))

    def stokes_factor(self):
        return torch.linalg.lu_factor(self.Kbase)

    def solve(self, lupiv, rhsv, rhsp):
        """``(v_inner, p)`` of the factored saddle; ``p`` physical."""
        sol = torch.linalg.lu_solve(*lupiv,
                                    torch.cat([rhsv, rhsp])[:, None])[:, 0]
        return sol[: self.nin], -sol[self.nin:]


def _dense_route(prob, device):
    """The dense route's solves (:class:`SteadySolverKernel`):
    ``(stokes, linsolve, mnorm, embed, sk)`` for :func:`_picard_newton`."""
    sk = prob.steady_kernel(device)

    def linsolve(v_inner, p, picard):
        v_full = sk.embed(v_inner)
        return sk.solve(sk.factorize(v_full, picard),
                        *sk.rhs(v_full, picard))

    return (lambda: sk.solve(sk.stokes_factor(), sk.fv, sk.fp), linsolve,
            sk.m_norm, sk.embed, sk)


# ---------------------------------------------------------------------------
# the host route
# ---------------------------------------------------------------------------

def _host_route(prob):
    """The sparse-splu route: per iteration one host convection assembly
    and one ``splu`` of the sparse saddle (the reference's recipe,
    stokes_navier_utils.py:438-525); the tuple of :func:`_dense_route`."""
    from .convconts import get_v_conv_conts

    fv = np.asarray(prob.fv).ravel()
    fp = np.asarray(prob.fp).ravel()
    nin = len(fv)

    def embed(v_inner):
        full = prob.bc_full_vec()
        full[prob.invinds] = v_inner
        return full

    def solve(amat, rhsv):
        vp = host_saddle_factorized(amat, prob.Jc, prob.JTc)(rhsv, fp)
        return vp[:nin, 0], -vp[nin:, 0]

    def linsolve(v_inner, p, picard):
        convc, rhs_con, rhsv_conbc = get_v_conv_conts(
            vvec=embed(v_inner), prob=prob, Picard=picard)
        rhsv = fv + (0.0 if picard else np.asarray(rhs_con).ravel())
        return solve(prob.Ac + convc, rhsv + np.asarray(rhsv_conbc).ravel())

    return (lambda: solve(prob.Ac, fv), linsolve, _m_norm_host(prob.Mc),
            embed, None)


# ---------------------------------------------------------------------------
# the matrix-free route (linsolver='krylov')
#
# Each linearized saddle
#
#     [[A + N(v_lin), J^T], [J, 0]] [v; q] = [rhs_v; rhs_p]
#
# is solved matrix-free by f32 FLEXIBLE GMRES (the preconditioner nests
# iterative solves — plain GMRES's Arnoldi breaks on such nonlinear maps,
# solve/krylov.device_fgmres) with a block-triangular preconditioner that
# includes the CONVECTION (a Stokes-only preconditioner stalls: N ~ Re*h*A
# dominates A at benchmark Reynolds numbers):
#
# * velocity block: fixed-count Jacobi-FGMRES on F = A + N itself (one
#   element-matrix matvec of F's blocks, the stiffness's plus N's),
# * pressure block: the LSC (least-squares commutator) Schur approximation
#   S^-1 ~ L^-1 (J D_M^-1 F D_M^-1 J^T) L^-1 with L = J D_M^-1 J^T applied
#   by a dense inverse (vecmat) where it fits, Jacobi-PCG beyond,
#
# wrapped in f64 iterative refinement against the exact f64 operator
# (affine element matvecs + two-field convection vectors).
# ---------------------------------------------------------------------------

class SteadyKrylovKernel:
    """Per-problem device state of the matrix-free steady solve.

    Keywords (the JAX package's environment variables, with its
    defaults): ``f_iters`` (``DNS_TPU_STEADY_F_ITERS``; default
    ``min(f_iters_max, max(20, 0.35 sqrt(nin)))``), ``f_cycles``
    (``DNS_TPU_STEADY_F_CYCLES``; default ``ceil(max(20, 0.35 sqrt(nin))
    / f_iters_max)``), ``l_iters`` (``DNS_TPU_STEADY_L_ITERS``, 25) and
    ``linv_max`` (``DNS_TPU_STEADY_LINV_MAX``, 16000: the largest pressure
    space whose ``L^-1`` is formed densely).  ``f_iters_max`` is 56.

    ``Linv``: on the CPU the JAX package's single f32 ``L^-1`` (host
    inverse); on the card ``L^-1`` by an f64 inverse on the device, kept
    as the f32 pair ``(hi, lo)`` (``hi + lo`` ~ the f64 inverse) and
    applied by ONE :func:`..ops.kernels.vecmat` launch over the stacked
    transposed operand ``(npp, 2 npp)`` — the L-solve stays near f64,
    which keeps the outer iteration mesh-robust.

    ``elem_a32``: the stiffness's f32 element blocks on ``ell_dofs``'s
    table (``prob.elem_tensors["A"]``, as :func:`..ops.elementop.
    build_element_ops` reads them; the outflow and Robin facet terms are
    in them, and the affine stiffness takes its facet rows from them), so
    that ``F = A + N(v_lin)`` is one table (:func:`_sk_elem32`) and an
    F-matvec one :func:`..ops.kernels.elem_mv` launch, where the JAX
    package adds the affine stiffness matvec and the convection's.
    ``n_fmv`` counts the F-matvecs; ``solves`` records each linear
    solve's refinement rounds, relative residual and F-matvecs."""

    def __init__(self, prob, f_iters=None, l_iters=25, f_cycles=None,
                 f_iters_max=56, linv_max=16000, device=None):
        device = resolve_device(device)
        self.device = device
        nin = len(prob.invinds)
        self.nin, self.npp = nin, prob.np_cond
        self.nv_full = prob.nv_full
        self.aff32 = prob.affine_ops(torch.float32, device=device)
        self.aff64 = prob.affine_ops(torch.float64, device=device)
        self.kern32 = prob.conv_kernel_on(torch.float32, device)
        self.kern64 = prob.conv_kernel_on(torch.float64, device)
        nd = getattr(prob.ctx, "dim", 2) * prob.ctx.N2.shape[1]
        full2in = np.full(prob.nv_full, nin, dtype=np.int64)
        full2in[prob.invinds] = np.arange(nin, dtype=np.int64)
        vd = prob.space.vdofs_of_cells().reshape(-1, nd)
        self.ell_dofs = DofTable(torch.as_tensor(full2in[vd], device=device),
                                 nin)
        self.elem_a32 = torch.as_tensor(
            np.ascontiguousarray(prob.elem_tensors["A"])).to(
                device=device, dtype=torch.float32)

        def dev(a, dt=torch.float64):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                device=device, dtype=dt)

        self.invinds = torch.as_tensor(prob.invinds, device=device)
        self.v_bc64 = dev(prob.bc_full_vec())
        self.fv64 = dev(np.asarray(prob.fv).ravel())
        self.fp64 = dev(np.asarray(prob.fp).ravel())
        # LSC scalings: D_M^-1 (velocity mass diag) and the Jacobi
        # diagonals of F ~ diag(A) (N's diagonal is near zero) and of
        # L = J D_M^-1 J^T (exact row formula, no assembly)
        dM = np.asarray(sps.csr_matrix(prob.Mc).diagonal()).ravel()
        self.dMi = dev(1.0 / dM, torch.float32)
        da = np.asarray(sps.csr_matrix(prob.Ac).diagonal()).ravel()
        self.dinv = dev(1.0 / da, torch.float32)
        Jc = sps.csr_matrix(prob.Jc)
        dL = np.asarray(Jc.multiply(Jc) @ (1.0 / dM)).ravel()[: self.npp]
        self.dinv_l = dev(1.0 / np.where(dL > 0, dL, 1.0), torch.float32)
        # the LSC scaling matrix L is FIXED per problem and its solve
        # quality bounds the Schur block: a weak PCG L-solve floors the
        # outer iteration on fine meshes, so it is inverted densely where
        # it fits (np x np), PCG beyond
        self.LinvT = None
        if self.npp <= linv_max:
            L = np.asarray((Jc @ sps.diags(1.0 / dM)
                            @ sps.csr_matrix(prob.JTc)).tocsr()[
                                : self.npp, : self.npp].todense())
            L = L + 1e-14 * np.eye(self.npp)
            if device.type == "cpu":
                self.LinvT = as_vecmat_operand(
                    torch.as_tensor(np.linalg.inv(L).T), torch.float32,
                    device)
            else:
                Li = torch.linalg.inv(torch.as_tensor(L, device=device))
                hi = Li.to(torch.float32)
                lo = (Li - hi.to(torch.float64)).to(torch.float32)
                self.LinvT = as_vecmat_operand(
                    torch.cat([hi.T, lo.T], dim=1))
                del Li, hi, lo
        # velocity-block effort ~ sqrt(nin); the basis length is capped
        # (f_iters_max) and the rest goes into sequential restart cycles
        nin_scaled = max(20, int(0.35 * np.sqrt(nin)))
        self.f_iters = (int(f_iters) if f_iters is not None
                        else min(f_iters_max, nin_scaled))
        self.f_cycles = (int(f_cycles) if f_cycles is not None
                         else max(1, -(-nin_scaled // f_iters_max)))
        self.l_iters = int(l_iters)
        self.n_fmv = 0
        self.solves = []

    @property
    def linv_pair(self):
        """Whether ``L^-1`` is held as the (hi, lo) f32 pair."""
        return self.LinvT is not None and self.LinvT.shape[1] == 2 * self.npp


def _sk_elem32(sk, v_lin_full, picard):
    """f32 element blocks ``(nc, nd, nd)`` of ``F = A + N(v_lin)``: the
    linearized convection's plus the stiffness's (``sk.elem_a32``)."""
    elem = sk.kern32.element_matrices(v_lin_full.to(torch.float32),
                                      picard_only=picard)
    nd = elem.shape[1] * elem.shape[2]
    return elem.reshape(-1, nd, nd) + sk.elem_a32


def _sk_fmv(sk, elem, v):
    """``F @ v = (A + N(v_lin)) @ v`` on inner dofs from F's element
    blocks (one :func:`..ops.kernels.elem_mv`; the JAX package's
    ``_sk_fmv`` adds the affine ``A @ v`` and ``_sk_nmv``'s ``N @ v``)."""
    sk.n_fmv += 1
    return elem_mv(elem, v, sk.ell_dofs, sk.ell_dofs)


def _sk_lsolve(sk, rp):
    """Solve with the LSC scaling matrix ``L = J D_M^-1 J^T``: the dense
    inverse where it fits (one vecmat launch), Jacobi-PCG through the
    affine J/J^T matvecs beyond."""
    if sk.LinvT is not None:
        y = vecmat(rp.contiguous(), sk.LinvT)
        if sk.linv_pair:
            return y[: sk.npp] + y[sk.npp:]
        return y

    def lmv(q):
        return sk.aff32.j_matvec(sk.dMi * sk.aff32.jt_matvec(q))

    return jacobi_pcg(lmv, sk.dinv_l, rp, sk.l_iters)


def _sk_precond(sk, elem, r):
    """Block-triangular preconditioner (f32) for the linearized saddle.

    Pressure block: LSC Schur approximation
    ``S^-1 ~ L^-1 (J D_M^-1 F D_M^-1 J^T) L^-1`` (it tracks the
    convection in F, unlike the diag-based SIMPLE form).  Velocity block:
    one fixed-length Jacobi-FGMRES pass on F itself.  Both blocks are
    nonlinear maps — the caller must be FLEXIBLE GMRES."""
    from .krylov import device_fgmres

    rv, rp = r[: sk.nin], r[sk.nin:]
    q1 = _sk_lsolve(sk, rp)
    t = sk.aff32.j_matvec(
        sk.dMi * _sk_fmv(sk, elem, sk.dMi * sk.aff32.jt_matvec(q1)))
    q = -_sk_lsolve(sk, t)
    z = rv - sk.aff32.jt_matvec(q)
    v = device_fgmres(lambda u: _sk_fmv(sk, elem, u),
                      lambda u: sk.dinv * u, z,
                      restart=sk.f_iters, cycles=sk.f_cycles)
    return torch.cat([v, q])


def _sk_gmres(sk, elem, r, restart=20, maxiter=1, x0=None):
    """f32 FGMRES on the linearized saddle, preconditioned by
    :func:`_sk_precond`; ``maxiter`` restart cycles.  ``r`` is assumed
    O(1) (the refinement loop normalizes it)."""
    from .krylov import device_fgmres

    def matvec(x):
        v, q = x[: sk.nin], x[sk.nin:]
        rv = _sk_fmv(sk, elem, v) + sk.aff32.jt_matvec(q)
        rp = sk.aff32.j_matvec(v)
        return torch.cat([rv, rp])

    return device_fgmres(matvec, lambda y: _sk_precond(sk, elem, y),
                         r.to(torch.float32), restart=restart,
                         cycles=maxiter, x0=x0)


def _sk_residual64(sk, v_lin_full, x, rhsv, rhsp, picard):
    """f64 residual of the linearized saddle at ``x`` — the exact
    operator via affine matvecs + two-field convection vectors
    (``N1(u0)x = (u0.grad)x = vector(x, u0)``,
    ``N2(u0)x = (x.grad)u0 = vector(u0, x)``)."""
    v, q = x[: sk.nin], x[sk.nin:]
    xfull = torch.zeros(sk.nv_full, dtype=torch.float64, device=sk.device)
    xfull[sk.invinds] = v
    nx = sk.kern64.vector(xfull, v_lin_full)
    if not picard:
        nx = nx + sk.kern64.vector(v_lin_full, xfull)
    rv = rhsv - (sk.aff64.a_matvec(v) + nx[sk.invinds]
                 + sk.aff64.jt_matvec(q))
    rp = rhsp - sk.aff64.j_matvec(v)
    return torch.cat([rv, rp])


def _sk_rhs64(sk, v_lin_full, picard):
    """f64 rhs at a linearization point: body force + Dirichlet-column
    folding (``-N @ u_bc``, matrix-free) + the Newton ``(u0.grad)u0``
    term (stokes_navier_utils.py:491-499)."""
    conbc = sk.kern64.vector(sk.v_bc64, v_lin_full)
    if not picard:
        conbc = conbc + sk.kern64.vector(v_lin_full, sk.v_bc64)
    rv = sk.fv64 - conbc[sk.invinds]
    if not picard:
        rv = rv + sk.kern64.vector(v_lin_full)[sk.invinds]
    return rv, sk.fp64


def _sk_linsolve(sk, v_lin_full, picard, x0=None, rtol=1e-11,
                 max_rounds=8, restart=20, maxiter=3):
    """One linearized saddle solve: f32 FGMRES rounds (``maxiter`` restart
    cycles of ``restart``) inside f64 iterative refinement, one host read
    (the residual norm) per round.  Returns ``(x (f64 device), rel_res)``
    and appends the solve's rounds, residual and F-matvecs to
    ``sk.solves``."""
    fmv0 = sk.n_fmv
    elem = _sk_elem32(sk, v_lin_full, picard)
    rhsv, rhsp = _sk_rhs64(sk, v_lin_full, picard)
    rhs = torch.cat([rhsv, rhsp])
    bn = float(torch.linalg.norm(rhs))
    if bn == 0.0:
        sk.solves.append(dict(rounds=0, rel_res=0.0, fmv=0))
        return torch.zeros_like(rhs), 0.0
    x = (torch.zeros_like(rhs) if x0 is None
         else torch.as_tensor(x0).to(device=sk.device, dtype=torch.float64))
    rn = np.inf
    rounds = 0
    for _ in range(max_rounds):
        r = _sk_residual64(sk, v_lin_full, x, rhsv, rhsp, picard)
        rn_new = float(torch.linalg.norm(r))
        if rn_new <= rtol * bn or rn_new >= 0.7 * rn:
            # converged, or the refinement stalled
            break
        rn = rn_new
        dx = _sk_gmres(sk, elem, r / rn, restart=restart, maxiter=maxiter)
        x = x + rn * dx.to(torch.float64)
        rounds += 1
    else:
        r = _sk_residual64(sk, v_lin_full, x, rhsv, rhsp, picard)
        rn_new = float(torch.linalg.norm(r))
    sk.solves.append(dict(rounds=rounds, rel_res=rn_new / bn,
                          fmv=sk.n_fmv - fmv0))
    return x, rn_new / bn


def _krylov_route(prob, device, verbose, log, lin_rtol=1e-11,
                  kernel_kw=None):
    """The matrix-free route at any mesh size: each linearized solve by
    :func:`_sk_linsolve`, warm-started from the previous iterate; the
    tuple of :func:`_dense_route` (its state a
    :class:`SteadyKrylovKernel`)."""
    sk = SteadyKrylovKernel(prob, device=device, **(kernel_kw or {}))

    def embed(v):
        full = sk.v_bc64.clone()
        full[sk.invinds] = v
        return full

    def solve(v_lin_full, picard, x0):
        x, rres = _sk_linsolve(sk, v_lin_full, picard, x0=x0, rtol=lin_rtol)
        if verbose:
            log.info(f"steady krylov: linear solve, rel residual {rres:.1e}")
        return x[: sk.nin], -x[sk.nin:]

    def linsolve(v_inner, p, picard):
        return solve(embed(v_inner), picard, torch.cat([v_inner, -p]))

    # Stokes: N(0) = 0, so the zero linearization point gives exactly
    # [[A, J^T],[J,0]] [v;q] = [fv; fp]
    zero_full = torch.zeros(sk.nv_full, dtype=torch.float64,
                            device=sk.device)
    return (lambda: solve(zero_full, True, None), linsolve,
            _m_norm_device(prob, device), embed, sk)


def _resolve_steady_linsolver(prob, linsolver, device):
    """``'auto'``: the dense route up to 25 000 condensed rows on the card
    (6000 on the CPU), then the matrix-free route on the card and the host
    route on the CPU; ``'host-sparse'`` only when asked for by name."""
    if linsolver == "auto":
        ncond = len(prob.invinds) + prob.np_cond
        on_cpu = device.type == "cpu"
        if ncond <= 25000 and not (on_cpu and ncond > 6000):
            linsolver = "dense"
        elif on_cpu:
            linsolver = "host-sparse"
        else:
            linsolver = "krylov"
    if linsolver not in ("dense", "host-sparse", "krylov"):
        raise ValueError(f"linsolver {linsolver!r}")
    return linsolver


def solve_steadystate_nse(
    prob,
    vel_pcrd_stps=10,
    vel_pcrd_tol=1e-4,
    vel_nwtn_stps=20,
    vel_nwtn_tol=5e-15,
    vel_start_nwtn=None,
    only_stokes=False,
    return_vp=False,
    return_nwtnupd_norms=False,
    useolddata=False,
    clearprvdata=False,
    save_data=False,
    data_prfx="",
    N=None,
    verbose=True,
    linsolver="auto",
    device=None,
    pt_min=60000,
    winv=False,
    krylov_kw=None,
    stats=None,
):
    """Steady NSE on a :class:`~..models.problem.NSEProblem`.

    Returns the velocity on the *full* dof set (boundary values appended,
    like the reference's ``_appbcs``, stokes_navier_utils.py:537) as
    ``(nv_full, 1)`` and, with ``return_vp``, the physical pressure
    ``(np_cond, 1)`` (numpy); with ``return_nwtnupd_norms`` also the
    Newton update norms.

    ``linsolver``: ``'dense'`` (the dense saddle matrix assembled and
    LU-factorized in f64 on ``device`` per iteration), ``'krylov'``
    (matrix-free f32 FGMRES + LSC preconditioner inside f64 refinement
    on ``device``, at any mesh size; ``krylov_kw`` go to
    :class:`SteadyKrylovKernel`; past ``pt_min`` inner dofs
    (``DNS_TPU_STEADY_PT_MIN``) it first marches in pseudo-time,
    :func:`solve_steadystate_pseudotime` with ``winv``, ``DNS_TPU_WINV``:
    ``False`` by default, the W-less banded step; a dict ``stats``
    receives the route's ``solves`` (per linear solve: refinement rounds,
    relative residual, F-matvecs), ``n_fmv``, ``f_iters``, ``f_cycles``
    and the pseudo-time march's seconds ``pseudo_time_s``),
    ``'host-sparse'`` (scipy splu per iteration,
    the reference's recipe; only when asked for by name) or ``'auto'``
    (see :func:`_resolve_steady_linsolver`).  ``device``: ``None`` = the
    problem's device (the card unless it names another).

    ``useolddata``/``clearprvdata``/``save_data`` reproduce the
    reference's filename-keyed velocity cache
    (stokes_navier_utils.py:308-342), as the JAX package does: converged
    states are stored under ``get_datastr`` keys (``data_prfx``, ``N``)
    and reloaded when the stored Newton-update norm meets
    ``vel_nwtn_tol``.
    """
    from ..utils import io as dou

    log = logging.getLogger(__name__)
    cdatstr = dou.get_datastr(time=None, meshp=N, nu=prob.nu, Nts=None,
                              data_prfx=data_prfx)
    if clearprvdata:
        for fname in glob.glob(cdatstr + "*__vel*"):
            os.remove(fname)
    if useolddata:
        try:
            norm_nwtnupd = float(np.asarray(
                dou.load_npa(cdatstr + "__norm_nwtnupd")).ravel()[0])
            vel_k = dou.load_npa(cdatstr + "__vel")
        except (IOError, FileNotFoundError):
            norm_nwtnupd = None
            if verbose:
                log.info("no old velocity data found")
        if norm_nwtnupd is not None and norm_nwtnupd < vel_nwtn_tol:
            if verbose:
                log.info(f"loaded converged velocity from {cdatstr}")
            ret = vel_k
            if return_vp:
                from .pfromv import get_pfromv

                pdev = "cpu" if linsolver == "host-sparse" else \
                    prob._dev(device)
                ret = (vel_k, np.asarray(get_pfromv(
                    v=vel_k.ravel()[prob.invinds], prob=prob,
                    device=pdev)).reshape(-1, 1))
            return (ret, [norm_nwtnupd]) if return_nwtnupd_norms else ret
    if linsolver != "host-sparse":      # the host route needs no device
        device = prob._dev(device)
    linsolver = _resolve_steady_linsolver(prob, linsolver, device)
    t_march = time.time()
    march = (linsolver == "krylov" and vel_start_nwtn is None
             and not only_stokes and len(prob.invinds) > pt_min)
    if march:
        # large meshes first march in pseudo-time to a near-steady state,
        # then Newton polishes to the update tolerance
        if verbose:
            log.info("steady krylov: pseudo-time init "
                     f"({len(prob.invinds)} inner dofs > {pt_min})")
        vel_start_nwtn = solve_steadystate_pseudotime(
            prob, tol=1e-7, winv=winv, verbose=verbose, device=device)
        vel_pcrd_stps = 0
    t_march = time.time() - t_march if march else 0.0
    if linsolver == "host-sparse":
        route = _host_route(prob)
    elif linsolver == "krylov":
        route = _krylov_route(prob, device, verbose, log, kernel_kw=krylov_kw)
    else:
        route = _dense_route(prob, device)
    stokes, linsolve, mnorm, embed, sk = route
    start = None
    if vel_start_nwtn is not None:
        start = (np.asarray(vel_start_nwtn, np.float64).ravel()[prob.invinds],
                 np.zeros(prob.np_cond))
        if linsolver != "host-sparse":
            start = tuple(torch.as_tensor(a, device=device) for a in start)
    v, p, norms = _picard_newton(
        stokes, linsolve, mnorm, start, only_stokes, vel_pcrd_stps,
        vel_pcrd_tol, vel_nwtn_stps, vel_nwtn_tol, verbose, log)
    v = embed(v)
    if linsolver != "host-sparse":
        v, p = v.cpu().numpy(), p.cpu().numpy()
    if stats is not None and linsolver == "krylov":
        stats.update(solves=sk.solves, n_fmv=sk.n_fmv, f_iters=sk.f_iters,
                     f_cycles=sk.f_cycles, pseudo_time_s=t_march)
    vwc = np.asarray(v).reshape(-1, 1)
    if save_data:
        dou.save_npa(vwc, cdatstr + "__vel")
        # no Newton step ran (only_stokes, Picard only): inf, as the
        # reference stores, so that useolddata never takes the state for
        # a converged Newton solution
        dou.save_npa(np.atleast_1d(norms[-1] if norms else np.inf),
                     cdatstr + "__norm_nwtnupd")
    ret = (vwc, np.asarray(p).reshape(-1, 1)) if return_vp else vwc
    return (ret, norms) if return_nwtnupd_norms else ret


def solve_steadystate_pseudotime(
    prob, dt=None, tol=1e-8, chunk=400, max_rounds=60,
    inivel=None, return_vp=False, return_info=False,
    linsolver="auto", warm_refine=1, winv=None, verbose=True, device=None,
    **kw,
):
    """Steady NSE by pseudo-time marching: run the increment-form CNAB
    loop (:func:`..solve.timeint.cnab` on ``device``) to its fixed point.

    The increment solve has the steady NSE solution as its EXACT fixed
    point (``delta = 0`` iff ``A v + N(v)v = fv`` and ``J v = fp``), so the
    march inherits the time-stepper's machinery and size range; no
    factorization of the convected operator is ever formed.

    Convergence is checked every ``chunk`` steps on the M-norm rate
    ``|v_new - v_old|_M / (chunk dt |v|_M) < tol``.  On blow-up the march
    restarts from the last good state at ``dt/2``.  ``dt=None`` picks
    ``0.25 h_min / v_ref`` (CFL-style; ``h_min`` from the cell Jacobians,
    ``v_ref`` from the boundary data).

    Returns the full-dof velocity ``(nv_full, 1)`` (and with ``return_vp``
    the physical pressure of the final step; with ``return_info`` a dict
    with the rate history, ``dt`` and the round count)."""
    from .timeint import cnab

    log = logging.getLogger(__name__)
    device = prob._dev(device)
    ctx = prob.ctx
    dim = getattr(ctx, "dim", 2)
    if dt is None:
        cellvol = np.asarray(ctx.detJ) / (2.0 if dim == 2 else 6.0)
        hmin = float((2.0 * cellvol.min()) ** (1.0 / dim))
        vref = max(float(np.abs(prob.bc_full_vec()).max()), 1e-6)
        dt = 0.25 * hmin / vref
    nin = len(prob.invinds)
    if inivel is None:
        v = np.zeros(nin)
    else:
        v = np.asarray(inivel, np.float64).ravel()
        v = v[prob.invinds] if v.size == prob.nv_full else v[:nin]
    v = torch.as_tensor(v, device=device)
    mnorm = _m_norm_device(prob, device)

    ops = None
    p = None
    rates = []
    converged = False
    for rnd in range(max_rounds):
        out = cnab(trange=np.linspace(0.0, chunk * dt, chunk + 1),
                   prob=prob, inivel=v, inip=p, ops=ops,
                   linsolver=linsolver, warm_refine=warm_refine,
                   winv=winv, save_every=None, device=device, **kw)
        if bool(out["ffflag"]):
            dt *= 0.5
            ops = None
            log.warning(f"pseudotime blow-up; restarting at dt={dt:g}")
            if verbose:
                print(f"pseudotime: blow-up, dt -> {dt:g}", flush=True)
            continue
        ops = out["ops"]
        v_new = out["v"].to(torch.float64)
        p = out["p"]
        vn = mnorm(v_new) or 1.0
        rate = mnorm(v_new - v) / (chunk * dt * vn)
        rates.append(rate)
        v = v_new
        if verbose:
            print(f"pseudotime round {rnd + 1}: t+={chunk * dt:g} "
                  f"rate={rate:.3e}", flush=True)
        if rate < tol:
            converged = True
            break
    if not converged:
        warnings.warn(f"pseudotime: rate {rates[-1] if rates else np.inf:.2e}"
                      f" after {max_rounds} rounds (tol {tol:g})",
                      UserWarning)
    vwc = prob.bc_full_vec()
    vwc[prob.invinds] = v.cpu().numpy()
    vwc = vwc.reshape(-1, 1)
    info = dict(rates=rates, dt=dt, rounds=len(rates), converged=converged)
    ret = ((vwc, np.asarray(p.cpu().numpy(), np.float64).reshape(-1, 1))
           if return_vp else vwc)
    if return_info:
        return ret, info
    return ret
