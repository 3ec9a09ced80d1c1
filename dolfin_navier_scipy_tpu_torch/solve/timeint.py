"""Time integrators as device step loops.

Re-designs the reference's ``time_int_utils`` (cnab :23-145, _onestepheun
:366-477) for an accelerator:

* the steps are solved in INCREMENT form: ``v_n = v_c + delta`` with a
  saddle solve for the O(dt)-sized increment, so f32 device kernels
  deliver f64-grade trajectories against an f64 carry,
* the coefficient matrix ``[[M + theta dt A, J^T],[J, 0]]`` is factored
  ONCE (the property that makes the reference's CNAB loop fast,
  time_int_utils.py:89-91): up to 6000 condensed rows as an
  :class:`InverseSaddleSolver` whose dense inverse each step applies with
  the hand-written ``vecmat`` kernel, above that as the banded
  :class:`SchurSaddleSolver` whose applications are the hand-written
  ``banded_mv`` / ``rect_mv`` / ``rect_mv_levels`` kernels,
* plain runs take the full-dof state layout (:func:`build_full_layout`)
  — no per-step inner<->full index translation; with the Schur solver the
  state lives in its permuted order ("w-space", see :func:`cnab`),
* the convection vector is re-assembled on the device each step by the
  :class:`ConvectionKernel`,
* the loop is a Python loop over preallocated tensors; nothing in it
  reads a value back to the host — the blow-up check
  (time_int_utils.py:99-103) is a carried device flag that freezes the
  state instead of ``break``, read once after the loop.

Sign conventions: ``nfc = -N(v)v`` goes to the rhs with plus signs
(get_v_conv_conts ``semi_explicit``, stokes_navier_utils.py:103-107);
the raw saddle pressure is rescaled ``p = -q/dt`` (time_int_utils.py:137).

Ported: ``cnab`` (both state layouts; the w-space step of the block-Schur
solver), ``sbdf2`` and ``semi_implicit_euler``, on the dense and the banded
block-Schur solver, with time-dependent right-hand sides (``f_tdp``,
``g_tdp``, ``dynamic_rhs`` with memory), Dirichlet controls
(:class:`DirichletControl`), static low-rank feedback (``umat``/``vmat``,
through :class:`SMWSolver`), in-loop observables (``outfunc``/``out_bundle``)
and exact resume (``resume_carry``); ``linsolver='krylov'`` steps on the
matrix-free Krylov saddle solver (inner layout).
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device, timer
from ..ops.kernels import vecmat, vecmat_operand
from ..ops.sparse import ell_from_scipy_fast
from .sadpnt import (
    InverseSaddleSolver, SchurSaddleSolver, SMWSolver, _to_dense,
    host_saddle_factorized, solve_sadpnt_host)

# warm-started PCG iterations of the w-space step when the Schur solver has
# no W (an extrapolated start is O(dt^2) from the solution)
_NITER_WARM = 6


@dataclass
class DirichletControl:
    """Time/state-dependent Dirichlet boundary control.

    ``dofs`` are *full-space* velocity dofs (must be excluded from the
    problem's inner dofs at build time); ``stencil`` is the spatial shape
    (e.g. a rotating-cylinder tangent field);
    ``ufunc(t, v_full, p, memory, mode) -> (scalar, memory)`` scales the
    stencil (a host number or a 0-d tensor) — the analogue of the
    reference's ``diricontfuncs`` memory-dict protocol
    (stokes_navier_utils.py:164-183).  ``v_full`` and ``p`` are tensors on
    the run's device.
    """

    dofs: np.ndarray
    stencil: np.ndarray
    ufunc: Callable
    memory: object = None


class TimeIntOps:
    """Device operator bundle for the semi-explicit integrators."""

    def __init__(self, solver, M, A, dt, theta, wdtype=torch.float64,
                 device=None):
        self.solver = solver
        self.M = M
        self.A = A
        self.dt = dt
        self.theta = theta
        self.nin = M.shape[0]
        self.wdtype = wdtype   # per-step work precision (f32 on the card)
        self.device = device


def _resolve_linsolver(prob, linsolver):
    if linsolver == "auto":
        # the dense inverse is O(n^2) memory and bytes per step; above
        # this size the banded block-Schur solver streams O(n bs)
        n_all = len(prob.invinds) + prob.np_cond
        linsolver = "dense" if n_all <= 6000 else "schur"
    if linsolver not in ("dense", "schur", "krylov"):
        raise ValueError(f"linsolver {linsolver!r}")
    return linsolver


def _build_ops(prob, dt, theta, inv_dtype=None, refine=None,
               precision="accurate", linsolver="auto", work_dtype=None,
               layout="inner", winv=None, device=None):
    """Operator/solver bundle for the INCREMENT-form integrators.

    The integrators advance ``v_n = v_c + delta`` with a saddle solve for
    the O(dt)-sized increment, so per-step arithmetic only needs
    *relative* f32 accuracy on ``delta`` to deliver f64-grade
    trajectories (the carry accumulates in f64).  Work precision:

    * ``precision='fast'``: f32 operators everywhere,
    * ``precision='accurate'``: f64 operators on the CPU (the reference
      for the tests), f32 operators + the f32-stored inverse on the card
      — f64-grade trajectory via the increment form.

    ``linsolver``: 'dense' (precomputed saddle inverse; O(n^2) memory),
    'schur' (the banded block-Schur solver, :class:`SchurSaddleSolver`;
    ``winv`` goes to it), 'krylov' (matrix-free GMRES with a SIMPLE-type
    Schur preconditioner, :class:`..solve.krylov_saddle.
    KrylovSaddleSolver`; tolerance 1e-7 in f32 work, 1e-11 in f64) or
    'auto' (dense up to 6000 condensed rows).  ``layout='full'`` builds the Schur solver
    over the full velocity dof set for :func:`cnab`'s w-space step (with
    ``A`` as its banded explicit operator); the bundle then carries the
    full-dof matvecs as ``ops.full_schur``.
    """
    device = resolve_device(device)
    linsolver = _resolve_linsolver(prob, linsolver)
    if work_dtype is None:
        on_acc = device.type == "cuda"
        work_dtype = (torch.float64
                      if (precision != "fast" and not on_acc)
                      else torch.float32)
    if linsolver == "krylov":
        from .krylov_saddle import build_krylov_ops

        return build_krylov_ops(
            prob, dt, theta=theta, dtype=work_dtype, device=device,
            tol=1e-7 if work_dtype == torch.float32 else 1e-11)
    coeff = sps.csr_matrix(prob.Mc + theta * dt * prob.Ac)
    if linsolver == "schur":
        # the element values of the index pipeline, for the banded gate's
        # cost model (accepted by the solver, not read yet)
        space = getattr(prob, "space", None)
        nvals = (None if space is None
                 else int(np.prod(space.vdofs_of_cells().shape)))
        if layout == "full":
            from ..ops.affine import AffineVectorOps

            afful = AffineVectorOps.build(prob, work_dtype, full_dofs=True,
                                          device=device)
            solver = SchurSaddleSolver(
                coeff, prob.Jc, prob.JTc, dtype=work_dtype,
                full_map=(prob.invinds, prob.nv_full),
                band_extra=prob.Ac, index_nvals=nvals, winv=winv,
                device=device)
            ops = TimeIntOps(solver=solver, M=afful.view("m"),
                             A=afful.view("a"), dt=dt, theta=theta,
                             wdtype=work_dtype, device=device)
            ops.full_schur = afful
            return ops
        # the banded solver applies its own operators (the element views
        # the JAX package hands it serve only its non-banded path)
        solver = SchurSaddleSolver(coeff, prob.Jc, prob.JTc,
                                   dtype=work_dtype, index_nvals=nvals,
                                   winv=winv, device=device)
        aff = prob.affine_ops(work_dtype, device=device)
        if aff is not None:
            Mop, Aop = aff.view("m"), aff.view("a")
        else:
            Mop = ell_from_scipy_fast(prob.Mc, dtype=work_dtype,
                                      device=device)
            Aop = ell_from_scipy_fast(prob.Ac, dtype=work_dtype,
                                      device=device)
        return TimeIntOps(solver=solver, M=Mop, A=Aop, dt=dt, theta=theta,
                          wdtype=work_dtype, device=device)
    aff = prob.affine_ops(work_dtype, device=device)
    if refine is None:
        # increment solves need only relative-to-delta accuracy; one
        # residual round (in work precision, cheap) covers the rounding
        # of the inverse to f32
        refine = 1 if work_dtype == torch.float32 else 0
    if aff is not None:
        # affine-factorized fused matvecs: constant-weight matmuls
        # + per-element 2x2 geometry contractions (the fast path)
        Kop = aff.view("ma", cm=1.0, ca=theta * dt)
        solver = InverseSaddleSolver(coeff, prob.Jc, prob.JTc,
                                     dtype=work_dtype,
                                     inv_dtype=inv_dtype, refine=refine,
                                     res_ops=(Kop, aff.view("j")),
                                     device=device)
        return TimeIntOps(solver=solver, M=aff.view("m"), A=aff.view("a"),
                          dt=dt, theta=theta, wdtype=work_dtype,
                          device=device)
    solver = InverseSaddleSolver(coeff, prob.Jc, prob.JTc,
                                 dtype=work_dtype,
                                 inv_dtype=inv_dtype, refine=refine,
                                 device=device)
    return TimeIntOps(
        solver=solver,
        M=ell_from_scipy_fast(prob.Mc, dtype=work_dtype, device=device),
        A=ell_from_scipy_fast(prob.Ac, dtype=work_dtype, device=device),
        dt=dt, theta=theta, wdtype=work_dtype, device=device)


def build_full_layout(prob, dt, ops, device=None):
    """Full-dof state layout for the dense-solver CNAB loop.

    Per-step inner<->full index translation (embed scatter + extract
    gather) costs about as much as an operator application.  Instead:
    matvecs over the FULL velocity vector
    (``AffineVectorOps.build(full_dofs=True)``; bc rows carry element
    garbage) and the dense saddle inverse zero-padded onto the full dof
    set — its zero bc rows/columns mask the garbage AND pin the bc
    increments to zero.  The bc-column stiffness term ``A[:,bc] u_bc``
    moves from the folded ``fv`` back into the matvec.

    The padded inverse is stored transposed (``ZpT``, ``(nf+npp)^2``) with
    rows 16-byte aligned (:func:`..ops.kernels.vecmat_operand`): the layout
    ``vecmat`` streams.
    """
    from ..ops.affine import AffineVectorOps

    device = resolve_device(ops.device if device is None else device)
    w = ops.wdtype
    # cached ON the problem object, per step size / precision / device
    cache = getattr(prob, "_full_layouts", None)
    if cache is None:
        cache = {}
        prob._full_layouts = cache
    key = (float(dt), float(ops.theta), str(w),
           str(ops.solver.KinvT.dtype), str(device))
    if key in cache:
        return cache[key]
    aff = AffineVectorOps.build(prob, w, full_dofs=True, device=device)
    nf = prob.nv_full
    npp = prob.np_cond
    n_all = nf + npp
    ix = torch.cat([torch.as_tensor(prob.invinds, device=device),
                    nf + torch.arange(npp, device=device)])
    KinvT = ops.solver.KinvT.to(device)
    # ZpT[ix, ix] = KinvT in two index_copy_ passes (rows, then columns)
    rows = torch.zeros((n_all, len(ix)), dtype=KinvT.dtype, device=device)
    rows.index_copy_(0, ix, KinvT)
    ZpT = vecmat_operand(n_all, n_all, KinvT.dtype, device)
    ZpT.index_copy_(1, ix, rows)
    del rows
    fvbc = -np.asarray(prob.full["A"]
                       @ prob.bc_full_vec()).ravel()[prob.invinds]
    fvf = np.zeros(nf)
    fvf[prob.invinds] = np.asarray(prob.fv).ravel() - fvbc
    out = dict(aff=aff, ZpT=ZpT,
               fv=torch.as_tensor(fvf).to(device=device, dtype=w),
               nf=nf, npp=npp, w=w, nu=float(prob.nu),
               sym=bool(getattr(prob, "gradvsymmtrc", True)))
    cache[key] = out
    return out


def _kern(prob, precision, device=None):
    return prob.conv_kernel_on(
        torch.float32 if precision == "fast" else torch.float64, device)


def _control_blocks(prob, controls, device):
    """The column blocks (A, J, M)[:, control-dofs] (f64 sparse, on
    ``device``) and the stencils; None without controls.  The JAX package
    keeps the blocks dense: at wake level 3 (768 control dofs, 99 778 inner
    rows) each would be 0.6 GB streamed a step for its ~7700 entries."""
    if not controls:
        return None

    def sparse(block):
        return ell_from_scipy_fast(block, dtype=torch.float64, device=device)

    dofs = np.concatenate([np.asarray(c.dofs) for c in controls])
    inv = prob.invinds
    Jbc = sps.csr_matrix(prob.full["J"])[:, dofs]
    if prob.geo.ppin is not None:
        Jbc = Jbc[:-1]
    return dict(
        dofs=torch.as_tensor(dofs.astype(np.int64), device=device),
        Abc=sparse(sps.csr_matrix(prob.full["A"])[inv][:, dofs]),
        Jbc=sparse(Jbc),
        Mbc=sparse(sps.csr_matrix(prob.full["M"])[inv][:, dofs]),
        stencils=[torch.as_tensor(np.asarray(c.stencil, dtype=np.float64)
                                  .ravel(), device=device)
                  for c in controls])


def _consts(prob, device=None, controls=None):
    """Static per-problem device vectors (and the control blocks)."""
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(
        invinds=dev(prob.invinds),
        v_bc=dev(prob.bc_full_vec()),
        fv=dev(np.asarray(prob.fv).ravel()),
        fp=dev(np.asarray(prob.fp).ravel()),
        cb=_control_blocks(prob, controls, device),
    )


def _eval_controls(controls, cn, t, v_full, p, mems, mode):
    """-> (cvals concatenated, new memories, bfv, bfp, mbc); without
    controls ``(None, (), 0.0, 0.0, 0.0)``."""
    if not controls:
        return None, (), 0.0, 0.0, 0.0
    cb = cn["cb"]
    vals, newmems = [], []
    for c, stn, mem in zip(controls, cb["stencils"], mems):
        scal, mem = c.ufunc(t, v_full, p, mem, mode)
        if torch.is_tensor(scal):
            vals.append(scal.to(stn) * stn)
        else:
            vals.append(float(scal) * stn)
        newmems.append(mem)
    cvals = torch.cat(vals)
    bfv = -(cb["Abc"] @ cvals)
    bfp = -(cb["Jbc"] @ cvals)
    mbc = cb["Mbc"] @ cvals
    return cvals, tuple(newmems), bfv, bfp, mbc


def _embed(cn, v_inner, cvals=None):
    full = cn["v_bc"].to(v_inner.dtype, copy=True)
    full[cn["invinds"]] = v_inner
    if cvals is not None:
        full[cn["cb"]["dofs"]] = cvals.to(full.dtype)
    return full


def _zero_fns(cn, f_tdp, g_tdp, dynamic_rhs, device):
    """The right-hand-side callables of a run: the problem's constant
    ``fv``/``fp`` and a zero ``dynamic_rhs`` where the caller gave none; a
    caller's own are wrapped so that whatever array they return arrives as
    a flat tensor on ``device``."""
    fv, fp = cn["fv"], cn["fp"]

    def on_device(x):
        return torch.as_tensor(x, device=device).reshape(-1)

    if f_tdp is None:
        f_use = lambda t: fv                               # noqa: E731
    else:
        f_use = lambda t: on_device(f_tdp(t))              # noqa: E731
    if g_tdp is None:
        g_use = lambda t: fp                               # noqa: E731
    else:
        g_use = lambda t: on_device(g_tdp(t))              # noqa: E731
    if dynamic_rhs is None:
        zero = torch.zeros_like(fv)

        def d_use(t, vc=None, memory=None, mode=None):
            return zero, memory
    else:
        def d_use(t, vc=None, memory=None, mode=None):
            val, memory = dynamic_rhs(t, vc=vc, memory=memory, mode=mode)
            return on_device(val), memory
    return f_use, g_use, d_use


def ell_matvec_np(spmat, x):
    """scipy matvec on a torch/numpy vector, returning numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return spmat @ np.asarray(x)


def _dense64(m):
    return np.asarray(_to_dense(m), dtype=np.float64)


def _heun_bootstrap(prob, t0, t1, v0, p0, f_vdp, f_tdp, g_tdp, dynamic_rhs,
                    drm, controls, cn, predictor="IMEX-Euler", umat=None,
                    vmat=None):
    """One Heun (predictor/corrector) step on the host
    (time_int_utils.py:366-477); runs once, outside the loop.

    ``v0``, ``p0`` and the returned states are device tensors; the linear
    algebra is host SuperLU, only the convection terms ``f_vdp(v_full)``,
    the caller's ``dynamic_rhs(t, vc=, memory=, mode=)`` (modes 'init',
    'heunpred', 'heuncorr', in that order, threading the memory ``drm``)
    and the controls' ``ufunc`` (same modes; the initial pressure ``p0``
    is what they see first) are evaluated on the device.

    Static feedback ``A -> A - umat @ vmat`` is implicit in the predictor
    solve and explicit-trapezoidal in the corrector (mirroring how the
    viscous term is treated)."""
    dt = t1 - t0
    if umat is not None:
        U, V = _dense64(umat), _dense64(vmat)

        def fb(v):
            return U @ (V @ v)
    else:
        fb = None
    nin = len(prob.invinds)
    dev, dtp = v0.device, v0.dtype

    def host(x):
        if not torch.is_tensor(x):
            return x                      # the 0.0 of an absent term
        return x.detach().cpu().numpy().astype(np.float64)

    def todev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtp)

    mems0 = tuple(c.memory for c in (controls or []))
    zero_c = (torch.zeros(cn["cb"]["dofs"].shape[0], dtype=dtp, device=dev)
              if controls else None)
    cvals_c, cmems, bfv_c, bfp_c, mbc_c = _eval_controls(
        controls, cn, t0, _embed(cn, v0, zero_c), p0, mems0, "init")
    v0f = _embed(cn, v0, cvals_c)
    v0h = host(v0)
    fv_c = host(f_tdp(t0))
    nfc_c = f_vdp(v0f)
    nfc_ch = host(nfc_c)
    dfv_c, drm = dynamic_rhs(t0, vc=v0, memory=drm, mode="init")
    tdfv, drm = dynamic_rhs(t1, vc=v0, memory=drm, mode="heunpred")
    dfv_c, tdfv = host(dfv_c), host(tdfv)

    tcvals, cmems, tbfv, tbfp, tmbc = _eval_controls(
        controls, cn, t1, v0f, p0, cmems, "heunpred")
    fv_n, fp_n = host(f_tdp(t1)), host(g_tdp(t1))
    bfv_c, bfp_c, mbc_c_h = host(bfv_c), host(bfp_c), host(mbc_c)
    tbfv, tbfp, tmbc = host(tbfv), host(tbfp), host(tmbc)

    Mv0 = ell_matvec_np(prob.Mc, v0h)
    Av0 = ell_matvec_np(prob.Ac, v0h)
    if predictor == "IMEX-Euler":
        tfv = (Mv0 + dt * (fv_n + tbfv + tdfv) + dt * nfc_ch
               - (tmbc - mbc_c_h))
        pre_amat, pre_uscal = prob.Mc + dt * prob.Ac, dt
    else:  # IMEX-trpz
        tfv = (Mv0 - 0.5 * dt * Av0
               + 0.5 * dt * (fv_c + fv_n + tbfv + bfv_c + tdfv + dfv_c)
               + dt * nfc_ch - (tmbc - mbc_c_h))
        if fb is not None:
            tfv = tfv + 0.5 * dt * fb(v0h)
        pre_uscal = 0.5 * dt
        pre_amat = prob.Mc + 0.5 * dt * prob.Ac
    if fb is None:
        presolve = host_saddle_factorized(pre_amat, prob.Jc, prob.JTc)
        tvp = presolve(tfv, fp_n + tbfp)
    else:
        tvp = solve_sadpnt_host(
            amat=pre_amat, jmat=prob.Jc, jmatT=prob.JTc, rhsv=tfv,
            rhsp=fp_n + tbfp, umat=pre_uscal * U, vmat=V)
    tv_nh = tvp[:nin].ravel()
    tv_n = todev(tv_nh)
    tp_n = todev(-tvp[nin:].ravel() / dt)

    # corrector: explicit trapezoidal, implicit only in the projection
    dfv_n, drm = dynamic_rhs(t1, vc=tv_n, memory=drm, mode="heuncorr")
    tvf = _embed(cn, tv_n, tcvals)
    tnfc_n = host(f_vdp(tvf))
    cvals_n, cmems, bfv_n, bfp_n, mbc_n = _eval_controls(
        controls, cn, t1, tvf, tp_n, cmems, "heuncorr")
    bfv_nh, bfp_nh = host(bfv_n), host(bfp_n)
    rhs_n = (Mv0 - (host(mbc_n) - mbc_c_h)
             - 0.5 * dt * (Av0 + ell_matvec_np(prob.Ac, tv_nh))
             + 0.5 * dt * (fv_c + fv_n + bfv_nh + bfv_c + host(dfv_n)
                           + dfv_c + nfc_ch + tnfc_n))
    if fb is not None:
        rhs_n = rhs_n + 0.5 * dt * (fb(v0h) + fb(tv_nh))
    msolve = host_saddle_factorized(prob.Mc, prob.Jc, prob.JTc)
    vp = msolve(rhs_n, fp_n + bfp_nh)
    v_n = todev(vp[:nin].ravel())
    p_n = todev(-vp[nin:].ravel() / dt)
    nfc_n = f_vdp(_embed(cn, v_n, cvals_n))
    return dict(v=v_n, p=p_n, nfc_c=nfc_c, nfc_n=nfc_n, fv_n=todev(fv_n),
                dfv_n=dfv_n, drm=drm, cvals=cvals_n, cmems=cmems,
                bfv=bfv_n, mbc=mbc_n, mbc_c=mbc_c,
                gp=todev(fp_n + bfp_nh), v_pred=tv_n, p_pred=tp_n)


def _wrap_feedback(ops, umat, vmat, c, warm_refine=0):
    """Fold the static low-rank feedback ``A -> A - umat @ vmat`` into the
    reusable solver (SMW, precomputed once; its columns solved with the
    steps' ``warm_refine`` rounds) and return the device ``(umat, vmat)``
    pair (f64) for the explicit rhs half."""
    if umat is None:
        return ops, None
    U, V = _dense64(umat), _dense64(vmat)
    kw = dict(refine=warm_refine) if warm_refine else {}
    wrapped = TimeIntOps(solver=SMWSolver(base=ops.solver, umat=U, vmat=V,
                                          c=c, **kw),
                         M=ops.M, A=ops.A, dt=ops.dt, theta=ops.theta,
                         wdtype=ops.wdtype, device=ops.device)
    return wrapped, (torch.as_tensor(U, device=ops.device),
                     torch.as_tensor(V, device=ops.device))


def _continuity_rhs(prob, wdtype, device):
    """``rhs(g_n, carry)``: the pressure-block right-hand side of an inner
    step's increment system, ``g_n - J v_c`` formed in f64 before any
    work-dtype cast.  In f64 work ``J v_c`` is the previous ``g`` by
    div-free induction (the JAX package's form, ``g_n - g_c``); in f32
    work the increment solves leave a residual each step, so ``J v_c`` is
    taken from the carried state (one f64 ``J`` matvec: the affine kernel
    on f64 tables) and those residuals do not add up over the run."""
    if wdtype != torch.float32:
        return lambda g_n, c: g_n - c["gp"]
    aff = prob.affine_ops(torch.float64, device=device)
    jop = (aff.view("j") if aff is not None else ell_from_scipy_fast(
        prob.Jc, dtype=torch.float64, device=device))
    return lambda g_n, c: g_n - jop.matvec(c["v"])


def _inner_solve(solver, warm_refine):
    """The saddle solve of an inner-layout step: the solver's own, or with
    ``warm_refine`` residual rounds when that is > 0."""
    if not warm_refine:
        return solver.solve
    return lambda rv, rp: solver.solve(rv, rp, refine=warm_refine)


def _run_scan(step, bundle, carry, ts, save_every, outfunc=None):
    """The step loop with decimated trajectory output: every
    ``save_every``-th state goes into preallocated ``(nsteps//k, ...)``
    tensors.  ``outfunc(bundle, c_new, c_old)`` (optional) is evaluated
    after EVERY step and its values stacked into a preallocated
    ``(nsteps, ...)`` tensor — the in-loop observable hook (e.g. per-step
    lift/drag, models/functionals.make_inscan_liftdrag).  Returns
    ``(carry, (vs, ps) or None, times or None, outs or None)``."""
    n = len(ts)
    k = save_every if (save_every is not None and save_every > 0) else 0
    nfull = n // k if k else 0
    ys = outs = None
    if nfull:
        ys = tuple(torch.empty((nfull,) + tuple(carry[key].shape),
                               dtype=carry[key].dtype,
                               device=carry[key].device)
                   for key in ("v", "p"))
    for i, t in enumerate(ts):
        old = carry
        carry = step(bundle, old, float(t))
        if outfunc is not None:
            o = outfunc(bundle, carry, old)
            if outs is None:
                outs = torch.empty((n,) + tuple(o.shape), dtype=o.dtype,
                                   device=o.device)
            outs[i] = o
        if nfull and (i + 1) % k == 0:
            ys[0][(i + 1) // k - 1] = carry["v"]
            ys[1][(i + 1) // k - 1] = carry["p"]
    if ys is None:
        return carry, None, None, outs
    tout = np.asarray(ts[: nfull * k]).reshape(-1, k)[:, -1]
    return carry, ys, tout, outs


def _restore_carry(carry, device):
    """A stored loop carry back onto ``device``: tensor and array leaves
    become tensors there, containers are walked, anything else (None,
    Python scalars) is kept as it is."""
    if torch.is_tensor(carry):
        return carry.to(device)
    if isinstance(carry, np.ndarray):
        return torch.tensor(carry, device=device)   # a copy: may be read-only
    if isinstance(carry, dict):
        return {k: _restore_carry(v, device) for k, v in carry.items()}
    if isinstance(carry, (list, tuple)):
        return type(carry)(_restore_carry(v, device) for v in carry)
    return carry


def _make_f_vdp(stokes_flow, nin):
    if stokes_flow:
        def f_vdp(bundle, v_full):
            return torch.zeros(nin, dtype=v_full.dtype,
                               device=v_full.device)
    else:
        def f_vdp(bundle, v_full):
            cn = bundle["cn"]
            return -bundle["kern"].vector(v_full)[cn["invinds"]]
    return f_vdp


def _blowup_flag(flag, v_n, check_ff_maxv):
    nrm = torch.linalg.vector_norm(v_n)
    return flag | (nrm > check_ff_maxv) | torch.isnan(nrm)


def _host_vec(x, device):
    """A caller's initial vector as a flat f64 tensor on ``device``."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return torch.as_tensor(np.array(x, dtype=np.float64).ravel(),
                           device=device)


def _cnab_wspace(prob, ops, bs, v0, cn, dt, trange, save_every,
                 check_ff_maxv, warm_refine, outfunc, out_bundle, device,
                 lap, banded_conv=None):
    """The CNAB loop of the banded Schur solver in its PERMUTED state
    layout (w-space): ``v = [v_inner in RCM order; bc dofs]``, the pressure
    in the solver's ``pp`` order.  The solver's rhs is then the slice
    ``rhs[:nin]`` (no gather or scatter a step), the convection tables are
    re-indexed once (``with_dof_map``), and the explicit diffusion is the
    solver's banded ``A`` on the inner rows (conv/A split: the constant
    ``A_ib v_bc`` coupling cancels against the bc fold of ``fv``).  The
    warm start ``y`` of the solver is extrapolated from the last two.
    Natural order comes back at exit, in the saved rows and for
    ``outfunc``.

    The convection vector is the element kernel's (B5) or, where
    ``banded_conv`` asks for it, the banded convection tail's
    (:mod:`..ops.banded_conv`; valid exactly here: the solver reads
    ``rhs[:nin]`` and the bc tail of the state is constant through the
    loop): ``None`` lets its gate decide (on the CPU; on the card the
    element kernel), ``True`` forces it, ``False`` keeps the element
    kernel."""
    slv = ops.solver
    if slv.Eblk is None:
        raise ValueError("the w-space step needs the solver's banded "
                         "explicit operator (band_extra=prob.Ac)")
    w = ops.wdtype
    nf, nin_p = prob.nv_full, slv._nin
    inv_np = np.asarray(prob.invinds)
    wsrc = np.concatenate([
        slv.permf.cpu().numpy(),
        np.setdiff1d(np.arange(nf), inv_np)]).astype(np.int64)
    iposx = np.full(nf + 1, nf, np.int64)
    iposx[wsrc] = np.arange(nf)
    pidx = slv.pidx
    qpos = torch.argsort(pidx)                     # pp -> natural
    wsrc_t = torch.as_tensor(wsrc, device=device)
    kern_w = _kern(prob, "fast" if w == torch.float32 else "accurate",
                   device).with_dof_map(torch.as_tensor(iposx))
    fvf = np.zeros(nf)
    fvf[inv_np] = np.asarray(prob.fv).ravel()
    fv_use = torch.as_tensor(fvf).to(device=device, dtype=w)[wsrc_t]
    fp_use = cn["fp"][pidx]
    vf0 = _embed(cn, bs["v"])[wsrc_t]
    # the AB2 "previous convection" entering the first step is the one at
    # the ORIGINAL v0 (time_int_utils.py:78+:112)
    nfc0 = (-kern_w.vector(_embed(cn, v0)[wsrc_t])).to(w)
    bct = None
    # on the card the gate's constants refuse the tail at every level
    # (PERF.md, section 6): its host work runs there only when forced
    if banded_conv is True or (banded_conv is None
                               and device.type != "cuda"):
        from ..ops.banded_conv import build_banded_conv_tail

        bct = build_banded_conv_tail(kern_w, nin_p, vf0[nin_p:],
                                     force=banded_conv is True)
    conv = kern_w.vector if bct is None else bct.vector

    def fstep(b, c, t):
        vf, nfc_o = c["v"], c["nfc"]
        # the element kernel (or the banded tail) carries the convection
        # alone; the diffusion is one banded matvec in permuted inner space
        nfc_c = (-conv(vf)).to(w)
        av_i = slv.band_extra_mv(vf[:nin_p])
        rhs = (0.5 * dt) * (3.0 * nfc_c - nfc_o) + dt * b["fv"]
        rhs[:nin_p] += (-dt) * av_i.to(w)
        rp = (b["fp"] - c["gp"]).to(w)
        y0 = 2.0 * c["ysol"] - c["ysol_p"]
        dvp, q_pp, y_n = slv.solve_warm_wspace(
            rhs, rp, y0, niter=_NITER_WARM, refine=warm_refine)
        v_n = vf.clone()
        v_n[:nin_p] += dvp.to(vf.dtype)
        p_n = (-q_pp / dt).to(c["p"].dtype)
        flag = _blowup_flag(c["flag"], v_n, check_ff_maxv)
        return dict(v=torch.where(flag, vf, v_n),
                    p=torch.where(flag, c["p"], p_n),
                    nfc=nfc_c, gp=b["fp"], flag=flag,
                    ysol=torch.where(flag, c["ysol"], y_n),
                    ysol_p=torch.where(flag, c["ysol_p"], c["ysol"]))

    outfunc_use = outfunc
    if outfunc is not None:
        # outfunc reads NATURAL-ordered (v_full, p)
        ip_t = torch.as_tensor(iposx[:nf], device=device)

        def outfunc_use(b, cn_, cc, _of=outfunc):
            return _of(b, dict(cn_, v=cn_["v"][ip_t], p=cn_["p"][qpos]),
                       dict(cc, v=cc["v"][ip_t], p=cc["p"][qpos]))

    fb = dict(fv=fv_use, kern=kern_w, fp=fp_use, ob=out_bundle)
    ysz = slv.warm_size
    carry = dict(v=vf0, p=bs["p"][pidx], nfc=nfc0, gp=bs["gp"][pidx],
                 flag=torch.zeros((), dtype=torch.bool, device=device),
                 ysol=torch.zeros(ysz, dtype=w, device=device),
                 ysol_p=torch.zeros(ysz, dtype=w, device=device))
    lap("setup_s")
    carry, ys, tout, outs = _run_scan(fstep, fb, carry, trange[2:],
                                      save_every, outfunc_use)
    ffflag = bool(carry["flag"])
    lap("loop_s")
    # natural order, once at exit (and for each saved row)
    vnat = torch.as_tensor(iposx[inv_np], device=device)
    return dict(
        v=carry["v"][vnat], p=carry["p"][qpos], ffflag=ffflag, times=tout,
        vs=None if ys is None else ys[0][:, vnat],
        ps=None if ys is None else ys[1][:, qpos],
        outs=outs, out_times=np.asarray(trange[2:]),
        bootstrap=bs, ops=ops, carry=carry, bct=bct)


def cnab(trange=None, prob=None, inivel=None, inip=None,
         stokes_flow=False,
         f_tdp=None, g_tdp=None, dynamic_rhs=None, dynamic_rhs_memory=None,
         controls=None,
         check_ff_maxv=1e8, save_every=1,
         predictor="IMEX-Euler",
         inv_dtype=None, refine=None, ops=None, precision="accurate",
         linsolver="auto", state_layout="auto", warm_refine=0,
         resume_carry=None, umat=None, vmat=None,
         outfunc=None, out_bundle=None, winv=None, banded_conv=None,
         verbose=False, device=None, **kw):
    """Crank-Nicolson / Adams-Bashforth-2 (reference time_int_utils.py:23).

    ``f_tdp(t)``, ``g_tdp(t)``: time-dependent momentum / continuity
    right-hand sides over the inner / condensed pressure dofs;
    ``dynamic_rhs(t, vc=, memory=, mode=) -> (value, memory)``: a
    state-dependent forcing with threaded memory.  ``controls``: a list of
    :class:`DirichletControl` (their dofs carry ``ufunc(t, v_full, p,
    memory, mode) * stencil``; the first ``p`` they see is ``inip``);
    ``umat``/``vmat``: static feedback ``A -> A - umat @ vmat`` (implicit
    through an SMW-wrapped solver, explicit-trapezoidal on the right-hand
    side).  Any of them, like ``stokes_flow`` or ``resume_carry``, takes
    the inner state layout.

    ``outfunc(bundle, c_new, c_old)``: optional per-step observable
    evaluated INSIDE the loop (stacked into the returned ``outs``; see
    models/functionals.make_inscan_liftdrag); ``out_bundle`` is handed to
    it as ``bundle['ob']``.  It sees the natural dof order whatever the
    state layout.

    ``linsolver`` 'auto' takes the dense inverse up to 6000 condensed rows
    and the banded block-Schur solver above (``winv``: its truncated
    inverse W, see :class:`SchurSaddleSolver`).  A plain Schur run keeps
    its state in the solver's permuted order ("w-space": RCM-ordered inner
    velocity, then the bc dofs; pressure in the solver's ``pp`` order): the
    solver's right-hand side is a slice, the convection tables are
    re-indexed once, the diffusion is the banded ``A`` of the solver, and
    natural order is restored at exit and in the saved rows.
    ``warm_refine`` residual rounds follow each of its solves; on the inner
    layout ``warm_refine`` > 0 sets the residual rounds of each solve (the
    JAX package reads it on the w-space step only).  ``banded_conv``: the
    w-space step's convection through the banded tail (``None``: its gate
    decides on the CPU, the element kernel on the card, where the gate
    refuses it at every level; ``True``: forced, ``False``: the element
    kernel; the result then carries the tail, or None, as ``bct``).

    Returns a dict with the final ``(v, p)`` (inner dofs / physical
    pressure), the blow-up flag, the decimated trajectory
    ``(times, vs, ps)`` (device tensors), the final loop ``carry`` and
    ``timing`` (host seconds of setup, bootstrap and the step loop; the
    loop's ends with the read-back of the flag, so it includes the
    device's work).  Passing a stored carry of an inner-layout run back
    via ``resume_carry`` continues the AB2 recursion *exactly* (no
    re-bootstrap) with ``trange[0]`` being the carry's time point.
    """
    device = resolve_device(device if ops is None or device is not None
                            else ops.device)
    trange = np.asarray(trange)
    dt = float(trange[1] - trange[0])
    lap, timing = timer(device)

    has_dyn = dynamic_rhs is not None
    has_c = bool(controls)
    plain_rhs = f_tdp is None and g_tdp is None and not has_dyn
    want_full = (state_layout != "inner" and not has_c and plain_rhs
                 and not stokes_flow and umat is None
                 and resume_carry is None and hasattr(prob, "ctx"))
    if ops is None:
        lin_res = _resolve_linsolver(prob, linsolver)
        ops = _build_ops(prob, dt, theta=0.5, inv_dtype=inv_dtype,
                         refine=refine, precision=precision,
                         linsolver=lin_res, winv=winv,
                         layout=("full" if want_full and lin_res == "schur"
                                 else "inner"),
                         device=device)
    ops, fbk = _wrap_feedback(ops, umat, vmat, c=0.5 * dt,
                              warm_refine=warm_refine)
    nin = len(prob.invinds)
    cn = _consts(prob, device, controls)
    bundle = dict(ops=ops, kern=_kern(prob, precision, device), cn=cn,
                  fbk=fbk, ob=out_bundle)
    f_vdp_b = _make_f_vdp(stokes_flow, nin)
    f_tdp, g_tdp, dynamic_rhs = _zero_fns(cn, f_tdp, g_tdp, dynamic_rhs,
                                          device)
    lap("setup_s")

    # the initial pressure is read by the controls only (a plain run's
    # bootstrap recomputes it)
    bs = None
    if resume_carry is None:
        v0 = _host_vec(inivel, device)
        p0 = (torch.zeros(prob.np_cond, dtype=v0.dtype, device=device)
              if inip is None else _host_vec(inip, device))
        bs = _heun_bootstrap(
            prob, trange[0], trange[1], v0, p0,
            lambda vf: f_vdp_b(bundle, vf),
            f_tdp, g_tdp, dynamic_rhs, dynamic_rhs_memory, controls, cn,
            predictor=predictor, umat=umat, vmat=vmat)
        lap("bootstrap_s")

    # full-dof state layout: the fast path for plain runs (no per-step
    # inner<->full index translation; see build_full_layout) — only when
    # the ops were built on the affine element kernels of THIS problem
    # (dense) or over the full dof set (Schur, _build_ops layout='full')
    schur_full = hasattr(ops, "full_schur")
    use_full = want_full and (schur_full or (
        hasattr(ops.solver, "KinvT")
        and getattr(ops.solver, "res_ops", None) is not None))
    if use_full and schur_full:
        out = _cnab_wspace(prob, ops, bs, v0, cn, dt, trange, save_every,
                           check_ff_maxv, warm_refine, outfunc, out_bundle,
                           device, lap, banded_conv)
        out["timing"] = timing
        return out
    if use_full:
        fl = build_full_layout(prob, dt, ops, device)
        nf, w = fl["nf"], fl["w"]
        zdt = fl["ZpT"].dtype
        kern_w = _kern(prob, "fast" if w == torch.float32 else "accurate",
                       device)
        fb = dict(aff=fl["aff"], ZpT=fl["ZpT"], fv=fl["fv"], kern=kern_w,
                  fp=cn["fp"], facv=fl["aff"].fac_dofs, ob=out_bundle)
        vf0 = _embed(cn, bs["v"])
        # the AB2 "previous convection" entering the first step is the
        # one at the ORIGINAL v0, not at the bootstrapped state
        # (time_int_utils.py:78+:112)
        nfc0 = (-kern_w.vector(_embed(cn, v0))).to(w)

        def fstep(b, c, t):
            vf, nfc_o = c["v"], c["nfc"]
            # fused element kernel: convection + stiffness share the
            # gather and the reduction
            cv, av = b["kern"].vector_and_amatvec(
                vf, fl["nu"], sym=fl["sym"],
                fac_elem=b["aff"].fac_elem, fac_vdofs=b["facv"])
            nfc_c = (-cv).to(w)
            rhs = (-dt * av.to(w) + (0.5 * dt) * (3.0 * nfc_c - nfc_o)
                   + dt * b["fv"])
            rp = (b["fp"] - c["gp"]).to(w)
            # the dense apply of the zero-padded transposed inverse
            sol = vecmat(torch.cat([rhs, rp]).to(zdt), b["ZpT"])
            v_n = vf + sol[:nf].to(vf.dtype)
            p_n = (-sol[nf:] / dt).to(c["p"].dtype)
            flag = _blowup_flag(c["flag"], v_n, check_ff_maxv)
            return dict(v=torch.where(flag, vf, v_n),
                        p=torch.where(flag, c["p"], p_n),
                        nfc=nfc_c, gp=b["fp"], flag=flag)

        carry = dict(v=vf0, p=bs["p"], nfc=nfc0, gp=bs["gp"],
                     flag=torch.zeros((), dtype=torch.bool, device=device))
        lap("setup_s")
        carry, ys, tout, outs = _run_scan(fstep, fb, carry, trange[2:],
                                          save_every, outfunc)
        ffflag = bool(carry["flag"])
        lap("loop_s")
        inv = cn["invinds"]
        return dict(
            v=carry["v"][inv], p=carry["p"],
            ffflag=ffflag,
            times=tout,
            vs=None if ys is None else ys[0][:, inv],
            ps=None if ys is None else ys[1],
            outs=outs, out_times=np.asarray(trange[2:]),
            bootstrap=bs, ops=ops, carry=carry, timing=timing,
        )

    solve = _inner_solve(ops.solver, warm_refine)
    grhs = _continuity_rhs(prob, ops.wdtype, device)

    def step(b, c, t):
        # INCREMENT form: solve for delta = v_n - v_c.  With
        # K = M + dt/2 A and E = M - dt/2 A the CNAB update
        # K v_n = E v_c + w  becomes  K delta = -dt A v_c + w, where
        # every rhs term is O(dt): f32 work arithmetic then yields
        # f64-grade trajectories with the f64 carry.
        ops_, cn_ = b["ops"], b["cn"]
        w = ops_.wdtype
        nfc_o = c["nfc"]
        v_full = _embed(cn_, c["v"], c["cvals"] if has_c else None)
        nfc_c = f_vdp_b(b, v_full).to(w)
        cvals_n, cmems, bfv_n, bfp_n, mbc_n = _eval_controls(
            controls, cn_, t, v_full, c["p"], c["cmems"] if has_c else (),
            "abtwo")
        fv_n = f_tdp(t)
        fsum = c["fv"].to(w) + fv_n.to(w)
        if has_c:
            fsum = fsum + bfv_n.to(w) + c["bfv"].to(w)
        dfv_n, drm_n = c["dfv"], c["drm"]
        if has_dyn:
            dfv_n, drm_n = dynamic_rhs(t, vc=c["v"], memory=c["drm"],
                                       mode="abtwo")
            fsum = fsum + dfv_n.to(w) + c["dfv"].to(w)
        rhs_d = -dt * ops_.A.matvec(c["v"]).to(w)
        if has_c:
            rhs_d = rhs_d - (mbc_n - c["mbc"]).to(w)
        rhs_d = (rhs_d + (0.5 * dt) * (3.0 * nfc_c - nfc_o)
                 + (0.5 * dt) * fsum)
        if b["fbk"] is not None:
            # trapezoidal feedback: K' = K - dt/2 uv (in the SMW-wrapped
            # solver), E' = E + dt/2 uv, so the delta-rhs gains dt uv v_c
            fu, fvm = b["fbk"]
            rhs_d = rhs_d + dt * (fu @ (fvm @ c["v"])).to(w)
        # pressure-block rhs of the delta system: g_new - J v_c, formed in
        # f64 before the work-dtype cast (see _continuity_rhs)
        gp_n = g_tdp(t) + bfp_n
        sol = solve(rhs_d, grhs(gp_n, c).to(w))
        v_n = c["v"] + sol[:ops_.nin].to(c["v"].dtype)
        p_n = (-sol[ops_.nin:] / dt).to(c["p"].dtype)
        flag = _blowup_flag(c["flag"], v_n, check_ff_maxv)
        out = dict(v=torch.where(flag, c["v"], v_n),
                   p=torch.where(flag, c["p"], p_n),
                   nfc=nfc_c, fv=fv_n, dfv=dfv_n, drm=drm_n,
                   gp=torch.where(flag, c["gp"], gp_n), flag=flag)
        if has_c:
            out.update(cvals=cvals_n, cmems=cmems, bfv=bfv_n, mbc=mbc_n)
        return out

    if resume_carry is None:
        # the carried "previous" convection entering the first AB2 step is
        # the one at v0 (reference hands nfc_c from _onestepheun into the
        # loop, time_int_utils.py:78+:112)
        carry = dict(v=bs["v"], p=bs["p"], nfc=bs["nfc_c"].to(ops.wdtype),
                     fv=bs["fv_n"], dfv=bs["dfv_n"], drm=bs["drm"],
                     gp=bs["gp"],
                     flag=torch.zeros((), dtype=torch.bool, device=device))
        if has_c:
            # the control state (the JAX carry's cvals cmems bfv mbc)
            carry.update(cvals=bs["cvals"], cmems=bs["cmems"],
                         bfv=bs["bfv"], mbc=bs["mbc"])
        ts = trange[2:]
    else:
        carry = _restore_carry(resume_carry, device)
        ts = trange[1:]
    carry, ys, tout, outs = _run_scan(step, bundle, carry, ts, save_every,
                                      outfunc)
    ffflag = bool(carry["flag"])
    lap("loop_s")
    return dict(
        v=carry["v"], p=carry["p"], ffflag=ffflag,
        times=tout, vs=None if ys is None else ys[0],
        ps=None if ys is None else ys[1],
        outs=outs, out_times=np.asarray(ts),
        bootstrap=bs, ops=ops, carry=carry, timing=timing,
    )


def sbdf2(trange=None, prob=None, inivel=None, inip=None,
          stokes_flow=False,
          f_tdp=None, g_tdp=None, dynamic_rhs=None, dynamic_rhs_memory=None,
          controls=None,
          check_ff_maxv=1e8, save_every=1,
          inv_dtype=None, refine=None, ops=None, precision="accurate",
          linsolver="auto", state_layout="inner", warm_refine=0,
          resume_carry=None, umat=None, vmat=None,
          outfunc=None, out_bundle=None,
          verbose=False, device=None, **kw):
    """Semi-implicit BDF2 (reference ``sbdftwo``, time_int_utils.py:260):
    implicit ``M + 2/3 dt A``, extrapolated convection ``2 N(v_c)-N(v_p)``.
    Always on the inner state layout; ``warm_refine`` > 0 sets the residual
    rounds of each solve (see :func:`cnab`).  Static feedback
    (``umat``/``vmat``) is treated fully implicitly (folded into the
    SMW-wrapped solver).

    ``resume_carry`` continues the BDF2 recursion exactly from a stored
    loop carry (see :func:`cnab`).  The in-loop observable hook is
    :func:`cnab`'s only (its observables read the AB2 carry)."""
    if outfunc is not None or out_bundle is not None:
        raise NotImplementedError(
            "sbdf2: outfunc/out_bundle (in-loop observables) are evaluated "
            "by cnab only; run time_int_scheme='cnab' for the per-step "
            "series or evaluate the functionals on the saved trajectory")
    device = resolve_device(device if ops is None or device is not None
                            else ops.device)
    trange = np.asarray(trange)
    dt = float(trange[1] - trange[0])
    lap, timing = timer(device)
    if ops is None:
        ops = _build_ops(prob, dt, theta=2.0 / 3.0, inv_dtype=inv_dtype,
                         refine=refine, precision=precision,
                         linsolver=_resolve_linsolver(prob, linsolver),
                         device=device)
    # BDF2 treats the linear feedback term fully implicitly: the 2/3 dt
    # weighted update is folded into the solver
    ops, fbk = _wrap_feedback(ops, umat, vmat, c=2.0 / 3.0 * dt,
                              warm_refine=warm_refine)
    nin = len(prob.invinds)
    has_c = bool(controls)
    cn = _consts(prob, device, controls)
    bundle = dict(ops=ops, kern=_kern(prob, precision, device), cn=cn,
                  fbk=fbk)
    f_vdp_b = _make_f_vdp(stokes_flow, nin)
    has_dyn = dynamic_rhs is not None
    f_tdp, g_tdp, dynamic_rhs = _zero_fns(cn, f_tdp, g_tdp, dynamic_rhs,
                                          device)
    lap("setup_s")

    bs = None
    if resume_carry is None:
        v0 = _host_vec(inivel, device)
        p0 = (torch.zeros(prob.np_cond, dtype=v0.dtype, device=device)
              if inip is None else _host_vec(inip, device))
        bs = _heun_bootstrap(
            prob, trange[0], trange[1], v0, p0,
            lambda vf: f_vdp_b(bundle, vf),
            f_tdp, g_tdp, dynamic_rhs, dynamic_rhs_memory, controls, cn,
            umat=umat, vmat=vmat)
        lap("bootstrap_s")
    solve = _inner_solve(ops.solver, warm_refine)
    grhs = _continuity_rhs(prob, ops.wdtype, device)

    def step(b, c, t):
        # INCREMENT form: with K2 = M + 2/3 dt A, the BDF2 update
        # K2 v_n = 1/3 M (4 v_c - v_p) + w  becomes
        # K2 delta = 1/3 M delta_old - 2/3 dt A v_c + w  with
        # delta_old = v_c - v_p; all rhs terms are O(dt) (see cnab)
        ops_, cn_ = b["ops"], b["cn"]
        w = ops_.wdtype
        nfc_p = c["nfc_p"]
        v_full = _embed(cn_, c["v"], c["cvals"] if has_c else None)
        nfc_c = f_vdp_b(b, v_full).to(w)
        cvals_n, cmems, bfv_n, bfp_n, mbc_n = _eval_controls(
            controls, cn_, t, v_full, c["p"], c["cmems"] if has_c else (),
            "abtwo")
        fv_n = f_tdp(t)
        fsum = fv_n.to(w)
        dfv_n, drm_n = c["dfv"], c["drm"]
        if has_dyn:
            dfv_n, drm_n = dynamic_rhs(t, vc=c["v"], memory=c["drm"],
                                       mode="abtwo")
            fsum = fsum + dfv_n.to(w)
        rhs_d = ((1.0 / 3.0) * ops_.M.matvec(c["dv"]).to(w)
                 - (2.0 / 3.0 * dt) * ops_.A.matvec(c["v"]).to(w))
        if has_c:
            # the three-level Dirichlet mass correction
            rhs_d = (rhs_d
                     - (mbc_n - 4.0 / 3.0 * c["mbc"]
                        + 1.0 / 3.0 * c["mbc_p"]).to(w)
                     + (2.0 / 3.0 * dt) * bfv_n.to(w))
        rhs_d = (rhs_d + (2.0 / 3.0 * dt) * (2.0 * nfc_c - nfc_p)
                 + (2.0 / 3.0 * dt) * fsum)
        if b["fbk"] is not None:
            # fully-implicit feedback: K2' = K2 - 2/3 dt uv (SMW-wrapped
            # solver); the delta-rhs gains 2/3 dt uv v_c
            fu, fvm = b["fbk"]
            rhs_d = rhs_d + (2.0 / 3.0 * dt) * (fu @ (fvm @ c["v"])).to(w)
        gp_n = g_tdp(t) + bfp_n
        sol = solve(rhs_d, grhs(gp_n, c).to(w))
        dv_n = sol[:ops_.nin].to(w)
        v_n = c["v"] + dv_n.to(c["v"].dtype)
        p_n = (-sol[ops_.nin:] / dt).to(c["p"].dtype)
        flag = _blowup_flag(c["flag"], v_n, check_ff_maxv)
        out = dict(v=torch.where(flag, c["v"], v_n),
                   dv=torch.where(flag, c["dv"], dv_n),
                   p=torch.where(flag, c["p"], p_n),
                   nfc_p=nfc_c, fv=fv_n, dfv=dfv_n, drm=drm_n,
                   gp=torch.where(flag, c["gp"], gp_n), flag=flag)
        if has_c:
            out.update(cvals=cvals_n, cmems=cmems, mbc=mbc_n,
                       mbc_p=torch.where(flag, c["mbc_p"], c["mbc"]))
        return out

    if resume_carry is None:
        # previous-step control mass term of the 3-level correction: the
        # bootstrap's t0 value (mode 'init') — re-evaluating the ufuncs in
        # 'abtwo' mode here would hand stateful controllers
        # (get_heunab_lti) a negative curdt = t0 - t1 (the reference uses
        # the initial bc mass term from _onestepheun,
        # time_int_utils.py:333-345)
        carry = dict(v=bs["v"], dv=(bs["v"] - v0).to(ops.wdtype),
                     p=bs["p"], nfc_p=bs["nfc_c"].to(ops.wdtype),
                     fv=bs["fv_n"], dfv=bs["dfv_n"], drm=bs["drm"],
                     gp=bs["gp"],
                     flag=torch.zeros((), dtype=torch.bool, device=device))
        if has_c:
            carry.update(cvals=bs["cvals"], cmems=bs["cmems"],
                         mbc=bs["mbc"], mbc_p=bs["mbc_c"])
        ts = trange[2:]
    else:
        carry = _restore_carry(resume_carry, device)
        ts = trange[1:]
    carry, ys, tout, _ = _run_scan(step, bundle, carry, ts, save_every)
    ffflag = bool(carry["flag"])
    lap("loop_s")
    return dict(
        v=carry["v"], p=carry["p"], ffflag=ffflag,
        times=tout, vs=None if ys is None else ys[0],
        ps=None if ys is None else ys[1],
        bootstrap=bs, ops=ops, carry=carry, timing=timing,
    )


def semi_implicit_euler(trange=None, prob=None, inivel=None, rhs_tv=None,
                        save_every=1, inv_dtype=None, refine=None,
                        precision="accurate", linsolver="auto", device=None,
                        **kw):
    """``(M + dt A) v_n + dt J^T q = M v_c + dt rhs(t, v_c)`` with one
    reused factorization (reference time_int_utils.py:566-635).
    ``rhs_tv(t, v_inner)`` returns the whole explicit right-hand side
    (default: the problem's constant ``fv``)."""
    device = resolve_device(device)
    trange = np.asarray(trange)
    dt = float(trange[1] - trange[0])
    ops = _build_ops(prob, dt, theta=1.0, inv_dtype=inv_dtype, refine=refine,
                     precision=precision,
                     linsolver=_resolve_linsolver(prob, linsolver),
                     device=device)
    cn = _consts(prob, device)
    if rhs_tv is None:
        rhs_tv = lambda t, v: cn["fv"]                     # noqa: E731
    fp0 = cn["fp"]

    def step(b, c, t):
        # increment form of (M + dt A) v_n = M v_c + dt rhs:
        # (M + dt A) delta = -dt A v_c + dt rhs  (O(dt) rhs, see cnab)
        ops_ = b["ops"]
        w = ops_.wdtype
        rhs = torch.as_tensor(rhs_tv(t, c["v"]), device=device).reshape(-1)
        rhs_d = dt * (rhs.to(w) - ops_.A.matvec(c["v"]).to(w))
        sol = ops_.solver.solve(rhs_d, (fp0 - c["gp"]).to(w))
        v_n = c["v"] + sol[:ops_.nin].to(c["v"].dtype)
        return dict(v=v_n, p=(-sol[ops_.nin:] / dt).to(c["p"].dtype),
                    gp=fp0)

    v0 = _host_vec(inivel, device)
    carry = dict(v=v0,
                 p=torch.zeros(prob.np_cond, dtype=v0.dtype, device=device),
                 gp=torch.as_tensor(prob.Jc @ v0.cpu().numpy(),
                                    device=device))
    carry, ys, tout, _ = _run_scan(step, dict(ops=ops), carry, trange[1:],
                                   save_every)
    return dict(v=carry["v"], p=carry["p"], times=tout,
                vs=None if ys is None else ys[0],
                ps=None if ys is None else ys[1], ops=ops)
