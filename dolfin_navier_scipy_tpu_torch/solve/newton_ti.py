"""Fully-implicit Newton-in-time integration (trapezoidal rule).

Twin of the JAX package's ``solve/newton_ti.py``, the re-design of the
reference's sectioned Newton sweep over trajectories
(stokes_navier_utils.py:1304-1587):

* the linearization trajectory lives on the device,
* each time step solves ``[[M + dt/2 (A + N(v_lin)), J^T],[J,0]]`` by
  matrix-free preconditioned GMRES (:func:`.krylov.device_pgmres`, the
  arithmetic of the JAX package's batched GMRES) with the FIXED
  Stokes-level solver of ``[[M + dt/2 A, J^T],[J,0]]`` as preconditioner
  — the dense inverse (one :func:`..ops.kernels.vecmat` launch an
  application) or the banded block-Schur solver; the convection matvec is
  one :func:`..ops.kernels.elem_mv` launch on the per-element matrices,
  the Stokes part one :func:`..ops.kernels.affine_residual` launch,
* static low-rank feedback (``umat @ vmat``) enters the matvec directly,
* the Newton update norm is the trajectory M-norm ``sum_t dt (v -
  v_lin)^T M (v - v_lin)`` (:1557-1560), with the Picard-to-Newton switch
  of ``vel_pcrd_stps`` (:1314-1321).

The JAX package's ``lax.scan`` over the steps is a Python loop writing
into preallocated tensors.  The Krylov vectors and every matvec table
are f64 (on the card too); the preconditioner works in the solver's type
and is cast back.
"""

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kernels import DofTable, elem_mv, vecmat
from ..ops.sparse import ell_from_scipy_fast
from .krylov import device_pgmres
from .timeint import _build_ops

log = logging.getLogger(__name__)


def _make_bundle(prob, dt, inv_dtype=None, fv_extra=None, linsolver="auto",
                 device=None):
    """The solver bundle of :func:`_build_ops` (theta 1/2) and the f64
    operators of the Newton system: the convection kernel, the affine
    ``K = M + dt/2 A`` with ``J`` (one residual launch), ``E = M - dt/2
    A``, ``M``, and the inner-dof element table (``nin`` = masked) of the
    element-matrix matvec."""
    device = resolve_device(device)
    ops = _build_ops(prob, dt, theta=0.5, inv_dtype=inv_dtype,
                     linsolver=linsolver, device=device)
    nin = len(prob.invinds)
    nd = 2 * prob.ctx.N2.shape[1]
    full2in = np.full(prob.nv_full, nin, dtype=np.int64)
    full2in[prob.invinds] = np.arange(nin, dtype=np.int64)
    vd = prob.space.vdofs_of_cells().reshape(-1, nd)
    fv = np.asarray(prob.fv).ravel()
    if fv_extra is not None:
        # constant rhs additions, e.g. the static-feedback throughput
        # b_mat (b_mat.T w) (reference stokes_navier_utils.py:1377)
        fv = fv + np.asarray(fv_extra).ravel()

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    aff = prob.affine_ops(torch.float64, device=device)
    if aff is None:
        K, E = (ell_from_scipy_fast(prob.Mc + c * dt * prob.Ac,
                                    dtype=torch.float64, device=device)
                for c in (0.5, -0.5))
        M = ell_from_scipy_fast(prob.Mc, dtype=torch.float64, device=device)
        J = ell_from_scipy_fast(prob.Jc, dtype=torch.float64, device=device)
        JT = ell_from_scipy_fast(prob.JTc, dtype=torch.float64,
                                 device=device)
    else:
        K = aff.view("ma", cm=1.0, ca=0.5 * dt)
        E = aff.view("ma", cm=1.0, ca=-0.5 * dt)
        M, J, JT = aff.view("m"), aff.view("j"), None
    return dict(
        ops=ops, aff=aff, K=K, E=E, M=M, J=J, JT=JT,
        kern=prob.conv_kernel_on(torch.float64, device),
        invinds=dev(prob.invinds, torch.int64),
        cdofs=torch.zeros(0, dtype=torch.int64, device=device),
        v_bc=dev(np.asarray(prob.bc_full_vec()).ravel()),
        fv=dev(fv), fp=dev(np.asarray(prob.fp).ravel()),
        ell_dofs=DofTable(dev(full2in[vd], torch.int64), nin),
        nd=nd, nin=nin, dt=float(dt), device=device)


def _n_matvec(b, elem, x_inner):
    """``N(v_lin) @ x`` on inner dofs from element matrices ``(nc, 12,
    12)``: one :func:`..ops.kernels.elem_mv` launch on the card."""
    return elem_mv(elem, x_inner, b["ell_dofs"], b["ell_dofs"])


def _conv_data(b, v_lin_inner, picard, cvals=None):
    """Element matrices + rhs contributions at a linearization point.

    With Dirichlet control, ``cvals`` are the control-dof values at this
    time point: embedding them into the full state folds the convection
    columns of the controlled dofs into ``conbc``."""
    vbc_t = b["v_bc"]
    if cvals is not None:
        vbc_t = vbc_t.clone()
        vbc_t[b["cdofs"]] = cvals
    v_full = vbc_t.clone()
    v_full[b["invinds"]] = v_lin_inner
    kern = b["kern"]
    elem = kern.element_matrices(v_full, picard_only=picard)
    elem = elem.reshape(-1, b["nd"], b["nd"])
    # bc-column folding: -N @ u_bc (matrix-free, two-field conv vectors);
    # the boundary state includes the control values
    conbc = kern.vector(vbc_t, v_full)
    if not picard:
        conbc = conbc + kern.vector(v_full, vbc_t)
    rhs = b["fv"] - conbc[b["invinds"]]
    if not picard:
        rhs = rhs + kern.vector(v_full)[b["invinds"]]
    return elem, rhs


def _sweep(b, lin_traj, iniv, umat, vmat, ctl=None, picard=False,
           gmres_restart=20, gmres_maxiter=3, gmres_tol=1e-12,
           krylovini="old", stats=None):
    """One Newton/Picard sweep over the whole time horizon.

    ``lin_traj (Nts+1, nin)``; ``umat (nin, k)`` / ``vmat (k, nin)``
    static feedback (``None`` when unused); ``ctl`` a dict of per-step
    Dirichlet-control tensors (cvals/bfv/bfp/mbc trajectories, evaluated
    along the linearization trajectory — reference
    stokes_navier_utils.py:1434-1441).  ``stats``: a dict whose counts of
    system matvecs and preconditioner applications grow.  Returns
    ``(v_traj, p_traj[1:], update_norm)`` (the norm a 0-d tensor)."""
    ops = b["ops"]
    dt, nin = b["dt"], b["nin"]
    solver = ops.solver
    fp = b["fp"]
    npp = fp.shape[0]
    aff = b["aff"]
    nts = lin_traj.shape[0] - 1
    stats = {} if stats is None else stats
    stats.setdefault("matvecs", 0)
    stats.setdefault("preconds", 0)
    hdt = 0.5 * dt

    def sysmatvec(elem, x):
        stats["matvecs"] += 1
        v, q = x[:nin], x[nin:]
        if aff is not None:
            r = aff.saddle_residual(v, q, 1.0, hdt)
            rv, rp = r[:nin], r[nin:]
        else:
            rv = b["K"].matvec(v) + b["JT"].matvec(q)
            rp = b["J"].matvec(v)
        rv = rv + hdt * _n_matvec(b, elem, v)
        if umat is not None:
            rv = rv - hdt * (umat @ (vmat @ v))
        return torch.cat([rv, rp])

    if hasattr(solver, "KinvT"):
        def precond(x):
            stats["preconds"] += 1
            return vecmat(x.to(solver.inv_dtype), solver.KinvT).to(x.dtype)
    else:
        # block-Schur Stokes-level solve as the preconditioner: the same
        # fixed-operator role as the dense inverse, no O(n^2) object
        def precond(x):
            stats["preconds"] += 1
            return solver.solve(x[:nin], x[nin:]).to(x.dtype)

    def conv_data(n):
        return _conv_data(b, lin_traj[n], picard,
                          cvals=None if ctl is None else ctl["cvals"][n])

    elem_c, rhs_c = conv_data(0)
    vs = torch.empty((nts + 1, nin), dtype=torch.float64,
                     device=iniv.device)
    ps = torch.empty((nts, npp), dtype=torch.float64, device=iniv.device)
    vs[0] = iniv
    v_old = iniv
    x_prev = x_pprev = torch.cat([iniv, iniv.new_zeros(npp)])
    for n in range(1, nts + 1):
        elem_n, rhs_n = conv_data(n)
        fsum = rhs_c + rhs_n
        if ctl is not None:
            fsum = fsum + ctl["bfv"][n - 1] + ctl["bfv"][n]
        rhsv = b["E"].matvec(v_old) - hdt * _n_matvec(b, elem_c, v_old) \
            + hdt * fsum
        if ctl is not None:
            rhsv = rhsv - (ctl["mbc"][n] - ctl["mbc"][n - 1])
        if umat is not None:
            rhsv = rhsv + hdt * (umat @ (vmat @ v_old))
        rhsp = fp if ctl is None else fp + ctl["bfp"][n]
        rhs = torch.cat([rhsv, rhsp])
        # Krylov warm start: 'old' reuses the last solution, 'upd'
        # linearly extrapolates (reference krylovini,
        # stokes_navier_utils.py:1493-1503)
        x0g = 2.0 * x_prev - x_pprev if krylovini == "upd" else x_prev
        x = device_pgmres(lambda y, e=elem_n: sysmatvec(e, y), rhs, precond,
                          x0=x0g, tol=gmres_tol, restart=gmres_restart,
                          maxiter=gmres_maxiter, atol=0.0)
        vs[n] = x[:nin]
        ps[n - 1] = -x[nin:] / dt
        v_old, x_pprev, x_prev = x[:nin], x_prev, x
        elem_c, rhs_c = elem_n, rhs_n
    dv = vs - lin_traj
    # the trajectory M-norm: one M matvec a time point
    mdv = torch.stack([b["M"].matvec(dv[t]) for t in range(nts + 1)])
    nrm = torch.sqrt(torch.abs(dt * (dv * mdv).sum()))
    return vs, ps, nrm


def solve_nse_newton_ti(
    prob=None, trange=None, iniv=None, inip=None,
    lin_vel_point=None, stokes_flow=False,
    vel_nwtn_stps=4, vel_nwtn_tol=1e-10, vel_pcrd_stps=0,
    umat=None, vmat=None, fv_extra=None,
    nsects=1, addfullsweep=True,
    controls=None, save_every=1, verbose=False,
    gmres_restart=20, gmres_maxiter=3, krylovini="old",
    linsolver="auto", device=None, **kw,
):
    """Newton-over-trajectories entry point (reference semantics, in
    memory).

    ``lin_vel_point``: None -> linearize about the constant-in-time
    initial value; an ``(nin,)`` (or full-length) vector -> about that
    state; an ``(Nts+1, nin)`` array -> about that trajectory (the
    reference's ``dictofvelstrs`` mechanism,
    time_dep_nse_linearizations.py:35-60).  ``umat``/``vmat``: static
    feedback; ``fv_extra``: a constant rhs addition; ``controls``:
    :class:`.timeint.DirichletControl` s, evaluated on the host along the
    previous sweep's trajectory; ``nsects`` > 1: Newton on time sections
    chained through their end states, then (``addfullsweep``) over the
    whole horizon.  ``device``: where it runs (``None``: the card).

    Returns ``v``, ``p`` (last state, physical pressure), ``ffflag``,
    ``times``/``vs``/``ps`` (every ``save_every``-th point),
    ``nwtn_norms`` (the update norm of every sweep), ``v_traj`` and
    ``stats`` (sweeps, system matvecs and preconditioner applications,
    summed over the sweeps).
    """
    device = resolve_device(device)
    trange = np.asarray(trange)
    dt = float(trange[1] - trange[0])
    nts = len(trange) - 1
    b = _make_bundle(prob, dt, fv_extra=fv_extra, linsolver=linsolver,
                     device=device)
    nin = b["nin"]

    def dev(a):
        if torch.is_tensor(a):
            return a.to(device=device, dtype=torch.float64)
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=device)

    if controls:
        # Dirichlet control in the implicit path (reference
        # stokes_navier_utils.py:1434-1441): control values are evaluated
        # along the PREVIOUS sweep's trajectory; their stiffness /
        # divergence / mass contributions become per-step inputs, and the
        # convection coupling enters through the bc-embedded
        # linearization state
        cdofs = np.concatenate([np.asarray(c.dofs) for c in controls])
        b["cdofs"] = torch.as_tensor(cdofs, dtype=torch.int64,
                                     device=device)
        Afull, Jfull, Mfull = (prob.full["A"], prob.full["J"],
                               prob.full["M"])
        Abc = np.asarray(Afull[:, cdofs].todense())[prob.invinds]
        Jbc = np.asarray(Jfull[:, cdofs].todense())
        if prob.geo.ppin is not None:
            Jbc = Jbc[:-1]
        Mbc = np.asarray(Mfull[:, cdofs].todense())[prob.invinds]
        stencils = [np.asarray(c.stencil).ravel() for c in controls]

        def build_ctl(lin_traj, tloc):
            mems = [c.memory for c in controls]
            CV = np.zeros((len(tloc), len(cdofs)))
            for i, t in enumerate(tloc):
                vf = b["v_bc"].clone()
                vf[b["invinds"]] = lin_traj[i]
                vals = []
                for k, c in enumerate(controls):
                    scal, mems[k] = c.ufunc(
                        float(t), vf, None, mems[k],
                        "init" if i == 0 else "abtwo")
                    vals.append(float(scal) * stencils[k])
                CV[i] = np.concatenate(vals)
            return dict(cvals=dev(CV), bfv=dev(-(CV @ Abc.T)),
                        bfp=dev(-(CV @ Jbc.T)), mbc=dev(CV @ Mbc.T))
    else:
        build_ctl = None

    iniv = dev(iniv).reshape(-1)
    if iniv.shape[0] == prob.nv_full:
        iniv = iniv[b["invinds"]]
    if lin_vel_point is None:
        lin_traj = iniv.expand(nts + 1, nin)
    else:
        lvp = dev(lin_vel_point)
        if lvp.dim() == 1:
            if lvp.shape[0] == prob.nv_full:
                lvp = lvp[b["invinds"]]
            lin_traj = lvp.expand(nts + 1, nin)
        else:
            lin_traj = lvp

    if umat is not None:
        umat, vmat = dev(umat), dev(vmat)

    norms = []
    stats = dict(sweeps=0, matvecs=0, preconds=0)

    def sweeps(lin_traj, iniv, nwtn_stps, pcrd_stps, tloc):
        """Picard->Newton sweeps over one (sub)trajectory."""
        ps = None
        for k in range(pcrd_stps + nwtn_stps):
            picard = k < pcrd_stps
            ctl = None if build_ctl is None else build_ctl(lin_traj, tloc)
            v_traj, ps, nrm = _sweep(
                b, lin_traj, iniv, umat, vmat, ctl=ctl, picard=picard,
                gmres_restart=gmres_restart, gmres_maxiter=gmres_maxiter,
                krylovini=krylovini, stats=stats)
            stats["sweeps"] += 1
            nrm = float(nrm)
            norms.append(nrm)
            if verbose:
                log.info(f"{'Picard' if picard else 'Newton'} sweep {k}: "
                         f"update norm {nrm:e}")
            lin_traj = v_traj
            if not picard and nrm < vel_nwtn_tol:
                break
        return lin_traj, ps

    if nsects <= 1:
        lin_traj, ps = sweeps(lin_traj, iniv, vel_nwtn_stps, vel_pcrd_stps,
                              trange)
    else:
        # temporal sectioning: Newton confined to time segments
        # (reference nsects, stokes_navier_utils.py:1076-1087), chained
        # through their end states, then an optional full sweep
        bounds = np.linspace(0, nts, nsects + 1).astype(int)
        parts_v, parts_p = [], []
        seg_ini = iniv
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            seg_traj, seg_ps = sweeps(lin_traj[s0:s1 + 1], seg_ini,
                                      vel_nwtn_stps, vel_pcrd_stps,
                                      trange[s0:s1 + 1])
            # later segments drop their first state (the previous end)
            parts_v.append(seg_traj[(1 if s0 else 0):])
            parts_p.append(seg_ps)
            seg_ini = seg_traj[-1]
        lin_traj = torch.cat(parts_v)
        ps = torch.cat(parts_p)
        if addfullsweep:
            lin_traj, ps = sweeps(lin_traj, iniv, vel_nwtn_stps, 0, trange)

    p_traj = torch.cat([dev(inip).reshape(1, -1), ps])
    k = max(int(save_every or 0), 0)
    sel = np.arange(0, nts + 1, k) if k else None
    return dict(
        v=lin_traj[-1], p=p_traj[-1], ffflag=False,
        times=None if k == 0 else trange[sel],
        vs=None if k == 0 else lin_traj[torch.as_tensor(sel, device=device)],
        ps=None if k == 0 else p_traj[torch.as_tensor(sel, device=device)],
        nwtn_norms=norms, v_traj=lin_traj, stats=stats)
