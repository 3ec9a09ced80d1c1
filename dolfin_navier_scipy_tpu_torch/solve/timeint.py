"""Time integrators as device step loops.

Re-designs the reference's ``time_int_utils`` (cnab :23-145, _onestepheun
:366-477) for an accelerator:

* the steps are solved in INCREMENT form: ``v_n = v_c + delta`` with a
  saddle solve for the O(dt)-sized increment, so f32 device kernels
  deliver f64-grade trajectories against an f64 carry,
* the coefficient matrix ``[[M + theta dt A, J^T],[J, 0]]`` is inverted
  ONCE (the property that makes the reference's CNAB loop fast,
  time_int_utils.py:89-91) as an :class:`InverseSaddleSolver`; each step
  applies the dense inverse with the hand-written ``vecmat`` kernel,
* plain runs take the full-dof state layout (:func:`build_full_layout`)
  — no per-step inner<->full index translation,
* the convection vector is re-assembled on the device each step by the
  :class:`ConvectionKernel`,
* the loop is a Python loop over preallocated tensors; nothing in it
  reads a value back to the host — the blow-up check
  (time_int_utils.py:99-103) is a carried device flag that freezes the
  state instead of ``break``, read once after the loop.

Sign conventions: ``nfc = -N(v)v`` goes to the rhs with plus signs
(get_v_conv_conts ``semi_explicit``, stokes_navier_utils.py:103-107);
the raw saddle pressure is rescaled ``p = -q/dt`` (time_int_utils.py:137).

Ported so far, all on the dense solver: ``cnab`` (both state layouts),
``sbdf2`` and ``semi_implicit_euler``, with time-dependent right-hand sides
(``f_tdp``, ``g_tdp``, ``dynamic_rhs`` with memory), in-loop observables
(``outfunc``/``out_bundle``) and exact resume (``resume_carry``).
Dirichlet controls, static feedback (``umat``/``vmat``) and the block-Schur
and Krylov solvers raise ``NotImplementedError``.
"""

import time

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device
from ..ops.kernels import vecmat
from ..ops.sparse import ell_from_scipy_fast
from .sadpnt import InverseSaddleSolver, host_saddle_factorized


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
        # this size the JAX package switches to its block-Schur solver
        n_all = len(prob.invinds) + prob.np_cond
        linsolver = "dense" if n_all <= 6000 else "schur"
    if linsolver in ("schur", "krylov"):
        raise NotImplementedError(
            f"linsolver={linsolver!r}: the banded block-Schur and Krylov "
            "saddle solvers are not ported yet; pass linsolver='dense'")
    if linsolver != "dense":
        raise ValueError(f"linsolver {linsolver!r}")
    return linsolver


def _build_ops(prob, dt, theta, inv_dtype=None, refine=None,
               precision="accurate", linsolver="auto", work_dtype=None,
               device=None):
    """Operator/solver bundle for the INCREMENT-form integrators.

    The integrators advance ``v_n = v_c + delta`` with a saddle solve for
    the O(dt)-sized increment, so per-step arithmetic only needs
    *relative* f32 accuracy on ``delta`` to deliver f64-grade
    trajectories (the carry accumulates in f64).  Work precision:

    * ``precision='fast'``: f32 operators everywhere,
    * ``precision='accurate'``: f64 operators on the CPU (the reference
      for the tests), f32 operators + the f32-stored inverse on the card
      — f64-grade trajectory via the increment form.

    ``linsolver``: 'dense' (precomputed saddle inverse; O(n^2) memory) or
    'auto' (dense up to 6000 condensed rows); 'schur' and 'krylov' are
    not ported yet.
    """
    device = resolve_device(device)
    _resolve_linsolver(prob, linsolver)
    if work_dtype is None:
        on_acc = device.type == "cuda"
        work_dtype = (torch.float64
                      if (precision != "fast" and not on_acc)
                      else torch.float32)
    coeff = sps.csr_matrix(prob.Mc + theta * dt * prob.Ac)
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

    The padded inverse is stored transposed and contiguous (``ZpT``,
    ``(nf+npp)^2``, unpadded beyond that): the layout ``vecmat`` streams.
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
    ZpT = torch.zeros((n_all, n_all), dtype=KinvT.dtype, device=device)
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


def _consts(prob, device=None):
    """Static per-problem device vectors."""
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(
        invinds=dev(prob.invinds),
        v_bc=dev(prob.bc_full_vec()),
        fv=dev(np.asarray(prob.fv).ravel()),
        fp=dev(np.asarray(prob.fp).ravel()),
    )


def _embed(cn, v_inner):
    full = cn["v_bc"].to(v_inner.dtype, copy=True)
    full[cn["invinds"]] = v_inner
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


def _not_ported(name, **given):
    """Controls and static feedback wait for the control slice."""
    given = sorted(k for k, v in given.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"{name}: {', '.join(given)} not ported yet (Dirichlet "
            "controls and static feedback follow in the control slice of "
            "the port)")


def ell_matvec_np(spmat, x):
    """scipy matvec on a torch/numpy vector, returning numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return spmat @ np.asarray(x)


def _heun_bootstrap(prob, t0, t1, v0, f_vdp, f_tdp, g_tdp, dynamic_rhs,
                    drm, predictor="IMEX-Euler"):
    """One Heun (predictor/corrector) step on the host
    (time_int_utils.py:366-477); runs once, outside the loop.

    ``v0`` and the returned states are device tensors; the linear
    algebra is host SuperLU, only the convection terms ``f_vdp(v_inner)``
    and the caller's ``dynamic_rhs(t, vc=, memory=, mode=)`` (modes
    'init', 'heunpred', 'heuncorr', in that order, threading the memory
    ``drm``) are evaluated on the device."""
    dt = t1 - t0
    nin = len(prob.invinds)
    dev, dtp = v0.device, v0.dtype

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    def todev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtp)

    v0h = host(v0)
    fv_c = host(f_tdp(t0))
    nfc_c = f_vdp(v0)
    nfc_ch = host(nfc_c)
    dfv_c, drm = dynamic_rhs(t0, vc=v0, memory=drm, mode="init")
    tdfv, drm = dynamic_rhs(t1, vc=v0, memory=drm, mode="heunpred")
    dfv_c, tdfv = host(dfv_c), host(tdfv)
    fv_n, fp_n = host(f_tdp(t1)), host(g_tdp(t1))

    Mv0 = ell_matvec_np(prob.Mc, v0h)
    Av0 = ell_matvec_np(prob.Ac, v0h)
    if predictor == "IMEX-Euler":
        tfv = Mv0 + dt * (fv_n + tdfv) + dt * nfc_ch
        pre_amat = prob.Mc + dt * prob.Ac
    else:  # IMEX-trpz
        tfv = (Mv0 - 0.5 * dt * Av0
               + 0.5 * dt * (fv_c + fv_n + tdfv + dfv_c) + dt * nfc_ch)
        pre_amat = prob.Mc + 0.5 * dt * prob.Ac
    presolve = host_saddle_factorized(pre_amat, prob.Jc, prob.JTc)
    tvp = presolve(tfv, fp_n)
    tv_n = todev(tvp[:nin].ravel())
    tp_n = todev(-tvp[nin:].ravel() / dt)

    # corrector: explicit trapezoidal, implicit only in the projection
    dfv_n, drm = dynamic_rhs(t1, vc=tv_n, memory=drm, mode="heuncorr")
    tnfc_n = host(f_vdp(tv_n))
    rhs_n = (Mv0
             - 0.5 * dt * (Av0 + ell_matvec_np(prob.Ac, tvp[:nin].ravel()))
             + 0.5 * dt * (fv_c + fv_n + host(dfv_n) + dfv_c
                           + nfc_ch + tnfc_n))
    msolve = host_saddle_factorized(prob.Mc, prob.Jc, prob.JTc)
    vp = msolve(rhs_n, fp_n)
    v_n = todev(vp[:nin].ravel())
    p_n = todev(-vp[nin:].ravel() / dt)
    nfc_n = f_vdp(v_n)
    return dict(v=v_n, p=p_n, nfc_c=nfc_c, nfc_n=nfc_n, fv_n=todev(fv_n),
                dfv_n=dfv_n, drm=drm, gp=todev(fp_n), v_pred=tv_n,
                p_pred=tp_n)


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


def _timer(device):
    """``(lap, timing)``: ``lap(name)`` adds the host seconds since the
    last lap — taken after the device has finished — to ``timing[name]``
    (a few calls per run, never inside the loop)."""
    tick = [time.perf_counter()]
    timing = {}

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timing[name] = timing.get(name, 0.0) + now - tick[0]
        tick[0] = now

    return lap, timing


def cnab(trange=None, prob=None, inivel=None, inip=None,
         stokes_flow=False,
         f_tdp=None, g_tdp=None, dynamic_rhs=None, dynamic_rhs_memory=None,
         controls=None,
         check_ff_maxv=1e8, save_every=1,
         predictor="IMEX-Euler",
         inv_dtype=None, refine=None, ops=None, precision="accurate",
         linsolver="auto", state_layout="auto", warm_refine=0,
         resume_carry=None, umat=None, vmat=None,
         outfunc=None, out_bundle=None, winv=None,
         verbose=False, device=None, **kw):
    """Crank-Nicolson / Adams-Bashforth-2 (reference time_int_utils.py:23).

    ``f_tdp(t)``, ``g_tdp(t)``: time-dependent momentum / continuity
    right-hand sides over the inner / condensed pressure dofs;
    ``dynamic_rhs(t, vc=, memory=, mode=) -> (value, memory)``: a
    state-dependent forcing with threaded memory.  Any of them, like
    ``stokes_flow`` or ``resume_carry``, takes the inner state layout.

    ``outfunc(bundle, c_new, c_old)``: optional per-step observable
    evaluated INSIDE the loop (stacked into the returned ``outs``; see
    models/functionals.make_inscan_liftdrag); ``out_bundle`` is handed to
    it as ``bundle['ob']``.

    Returns a dict with the final ``(v, p)`` (inner dofs / physical
    pressure), the blow-up flag, the decimated trajectory
    ``(times, vs, ps)`` (device tensors), the final loop ``carry`` and
    ``timing`` (host seconds of setup, bootstrap and the step loop; the
    loop's ends with the read-back of the flag, so it includes the
    device's work).  Passing a stored carry of an inner-layout run back
    via ``resume_carry`` continues the AB2 recursion *exactly* (no
    re-bootstrap) with ``trange[0]`` being the carry's time point.
    """
    _not_ported("cnab", controls=controls or None, umat=umat, vmat=vmat,
                winv=winv)
    device = resolve_device(device if ops is None or device is not None
                            else ops.device)
    trange = np.asarray(trange)
    dt = float(trange[1] - trange[0])
    lap, timing = _timer(device)

    has_dyn = dynamic_rhs is not None
    plain_rhs = f_tdp is None and g_tdp is None and not has_dyn
    want_full = (state_layout != "inner" and plain_rhs and not stokes_flow
                 and resume_carry is None and hasattr(prob, "ctx"))
    if ops is None:
        ops = _build_ops(prob, dt, theta=0.5, inv_dtype=inv_dtype,
                         refine=refine, precision=precision,
                         linsolver=_resolve_linsolver(prob, linsolver),
                         device=device)
    nin = len(prob.invinds)
    cn = _consts(prob, device)
    bundle = dict(ops=ops, kern=_kern(prob, precision, device), cn=cn,
                  ob=out_bundle)
    f_vdp_b = _make_f_vdp(stokes_flow, nin)
    f_tdp, g_tdp, dynamic_rhs = _zero_fns(cn, f_tdp, g_tdp, dynamic_rhs,
                                          device)
    lap("setup_s")

    # a plain run never reads ``inip``: the bootstrap recomputes the
    # pressure (only controls consume the initial one)
    bs = None
    if resume_carry is None:
        v0 = _host_vec(inivel, device)
        bs = _heun_bootstrap(
            prob, trange[0], trange[1], v0,
            lambda v: f_vdp_b(bundle, _embed(cn, v)),
            f_tdp, g_tdp, dynamic_rhs, dynamic_rhs_memory,
            predictor=predictor)
        lap("bootstrap_s")

    # full-dof state layout: the fast path for plain runs (no per-step
    # inner<->full index translation; see build_full_layout) — only when
    # the ops were built on the affine element kernels of THIS problem
    use_full = (want_full and hasattr(ops.solver, "KinvT")
                and getattr(ops.solver, "res_ops", None) is not None)
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

    def step(b, c, t):
        # INCREMENT form: solve for delta = v_n - v_c.  With
        # K = M + dt/2 A and E = M - dt/2 A the CNAB update
        # K v_n = E v_c + w  becomes  K delta = -dt A v_c + w, where
        # every rhs term is O(dt): f32 work arithmetic then yields
        # f64-grade trajectories with the f64 carry.
        ops_, cn_ = b["ops"], b["cn"]
        w = ops_.wdtype
        nfc_o = c["nfc"]
        v_full = _embed(cn_, c["v"])
        nfc_c = f_vdp_b(b, v_full).to(w)
        fv_n = f_tdp(t)
        fsum = c["fv"].to(w) + fv_n.to(w)
        dfv_n, drm_n = c["dfv"], c["drm"]
        if has_dyn:
            dfv_n, drm_n = dynamic_rhs(t, vc=c["v"], memory=c["drm"],
                                       mode="abtwo")
            fsum = fsum + dfv_n.to(w) + c["dfv"].to(w)
        rhs_d = (-dt * ops_.A.matvec(c["v"]).to(w)
                 + (0.5 * dt) * (3.0 * nfc_c - nfc_o)
                 + (0.5 * dt) * fsum)
        # pressure-block rhs of the delta system: g_new - J v_c; by
        # div-free induction J v_c equals the PREVIOUS g, so the exact
        # O(dt) difference is formed in f64 before any work-dtype cast
        gp_n = g_tdp(t)
        sol = ops_.solver.solve(rhs_d, (gp_n - c["gp"]).to(w))
        v_n = c["v"] + sol[:ops_.nin].to(c["v"].dtype)
        p_n = (-sol[ops_.nin:] / dt).to(c["p"].dtype)
        flag = _blowup_flag(c["flag"], v_n, check_ff_maxv)
        return dict(v=torch.where(flag, c["v"], v_n),
                    p=torch.where(flag, c["p"], p_n),
                    nfc=nfc_c, fv=fv_n, dfv=dfv_n, drm=drm_n,
                    gp=torch.where(flag, c["gp"], gp_n), flag=flag)

    if resume_carry is None:
        # the carried "previous" convection entering the first AB2 step is
        # the one at v0 (reference hands nfc_c from _onestepheun into the
        # loop, time_int_utils.py:78+:112)
        carry = dict(v=bs["v"], p=bs["p"], nfc=bs["nfc_c"].to(ops.wdtype),
                     fv=bs["fv_n"], dfv=bs["dfv_n"], drm=bs["drm"],
                     gp=bs["gp"],
                     flag=torch.zeros((), dtype=torch.bool, device=device))
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
          linsolver="auto", state_layout="inner",
          resume_carry=None, umat=None, vmat=None,
          outfunc=None, out_bundle=None,
          verbose=False, device=None, **kw):
    """Semi-implicit BDF2 (reference ``sbdftwo``, time_int_utils.py:260):
    implicit ``M + 2/3 dt A``, extrapolated convection ``2 N(v_c)-N(v_p)``.
    Always on the inner state layout.

    ``resume_carry`` continues the BDF2 recursion exactly from a stored
    loop carry (see :func:`cnab`).  The in-loop observable hook is
    :func:`cnab`'s only (its observables read the AB2 carry)."""
    _not_ported("sbdf2", controls=controls or None, umat=umat, vmat=vmat)
    if outfunc is not None or out_bundle is not None:
        raise NotImplementedError(
            "sbdf2: outfunc/out_bundle (in-loop observables) are evaluated "
            "by cnab only; run time_int_scheme='cnab' for the per-step "
            "series or evaluate the functionals on the saved trajectory")
    device = resolve_device(device if ops is None or device is not None
                            else ops.device)
    trange = np.asarray(trange)
    dt = float(trange[1] - trange[0])
    lap, timing = _timer(device)
    if ops is None:
        ops = _build_ops(prob, dt, theta=2.0 / 3.0, inv_dtype=inv_dtype,
                         refine=refine, precision=precision,
                         linsolver=_resolve_linsolver(prob, linsolver),
                         device=device)
    nin = len(prob.invinds)
    cn = _consts(prob, device)
    bundle = dict(ops=ops, kern=_kern(prob, precision, device), cn=cn)
    f_vdp_b = _make_f_vdp(stokes_flow, nin)
    has_dyn = dynamic_rhs is not None
    f_tdp, g_tdp, dynamic_rhs = _zero_fns(cn, f_tdp, g_tdp, dynamic_rhs,
                                          device)
    lap("setup_s")

    bs = None
    if resume_carry is None:
        v0 = _host_vec(inivel, device)
        bs = _heun_bootstrap(
            prob, trange[0], trange[1], v0,
            lambda v: f_vdp_b(bundle, _embed(cn, v)),
            f_tdp, g_tdp, dynamic_rhs, dynamic_rhs_memory)
        lap("bootstrap_s")

    def step(b, c, t):
        # INCREMENT form: with K2 = M + 2/3 dt A, the BDF2 update
        # K2 v_n = 1/3 M (4 v_c - v_p) + w  becomes
        # K2 delta = 1/3 M delta_old - 2/3 dt A v_c + w  with
        # delta_old = v_c - v_p; all rhs terms are O(dt) (see cnab)
        ops_, cn_ = b["ops"], b["cn"]
        w = ops_.wdtype
        nfc_p = c["nfc_p"]
        v_full = _embed(cn_, c["v"])
        nfc_c = f_vdp_b(b, v_full).to(w)
        fv_n = f_tdp(t)
        fsum = fv_n.to(w)
        dfv_n, drm_n = c["dfv"], c["drm"]
        if has_dyn:
            dfv_n, drm_n = dynamic_rhs(t, vc=c["v"], memory=c["drm"],
                                       mode="abtwo")
            fsum = fsum + dfv_n.to(w)
        rhs_d = ((1.0 / 3.0) * ops_.M.matvec(c["dv"]).to(w)
                 - (2.0 / 3.0 * dt) * ops_.A.matvec(c["v"]).to(w)
                 + (2.0 / 3.0 * dt) * (2.0 * nfc_c - nfc_p)
                 + (2.0 / 3.0 * dt) * fsum)
        gp_n = g_tdp(t)
        sol = ops_.solver.solve(rhs_d, (gp_n - c["gp"]).to(w))
        dv_n = sol[:ops_.nin].to(w)
        v_n = c["v"] + dv_n.to(c["v"].dtype)
        p_n = (-sol[ops_.nin:] / dt).to(c["p"].dtype)
        flag = _blowup_flag(c["flag"], v_n, check_ff_maxv)
        return dict(v=torch.where(flag, c["v"], v_n),
                    dv=torch.where(flag, c["dv"], dv_n),
                    p=torch.where(flag, c["p"], p_n),
                    nfc_p=nfc_c, fv=fv_n, dfv=dfv_n, drm=drm_n,
                    gp=torch.where(flag, c["gp"], gp_n), flag=flag)

    if resume_carry is None:
        carry = dict(v=bs["v"], dv=(bs["v"] - v0).to(ops.wdtype),
                     p=bs["p"], nfc_p=bs["nfc_c"].to(ops.wdtype),
                     fv=bs["fv_n"], dfv=bs["dfv_n"], drm=bs["drm"],
                     gp=bs["gp"],
                     flag=torch.zeros((), dtype=torch.bool, device=device))
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
