"""``solve_nse`` — the time-dependent orchestrator.

Facade over the step-loop integrators mirroring the reference's big
kwargs-driven entry point (stokes_navier_utils.py:548-1599):

* initial value: steady Stokes solve (``start_ssstokes``,
  reference :836-911) or a provided ``iniv``,
* initial pressure via :func:`get_pfromv` (reference :921-940),
* semi-explicit dispatch to ``cnab`` / ``sbdf2`` (reference :1218-1221),
* trajectories returned in device memory instead of the reference's
  per-step ``.npy`` files (``dictofvelstrs``, :1057-1070).

Ported so far: both integrators on the dense, the banded block-Schur
and the Krylov solver (``krylov`` / ``linsolver='krylov'``), with
time-dependent right-hand sides, Dirichlet controls, static feedback
(``umat``/``vmat``), closed-loop feedback (dynamic LTI observers and
``feedbackthroughdict``), in-loop observables (``outfunc``/
``out_bundle``, CNAB) and ``resume_carry`` passed through to them; and
the fully implicit Newton-in-time scheme (``treat_nonl_explicit=False``
or ``lin_vel_point``, :func:`.newton_ti.solve_nse_newton_ti`, reference
:1304-1587).  Checkpoints and Paraview output raise
``NotImplementedError``.
"""

import numpy as np
import torch

from ..device import resolve_device
from .pfromv import get_pfromv
from .steady import solve_steadystate_nse
from . import timeint


def _dense(m):
    return np.asarray(m.todense() if hasattr(m, "todense") else m,
                      dtype=np.float64)


def _load_npa(arr):
    """A ``feedbackthroughdict`` entry: an array, or the path of an
    ``.npy`` file (with or without its suffix)."""
    if not isinstance(arr, str):
        return arr
    return np.load(arr if arr.endswith(".npy") else arr + ".npy")


def solve_nse(
    prob=None,
    trange=None,
    t0=None, tE=None, Nts=None,
    iniv=None, inip=None,
    start_ssstokes=False,
    stokes_flow=False,
    time_int_scheme="cnab",
    treat_nonl_explicit=True,
    lin_vel_point=None,
    f_tdp=None, g_tdp=None,
    dynamic_rhs=None, dynamic_rhs_memory=None,
    controls=None,
    closed_loop=False, dynamic_feedback=False, dyn_fb_dict=None,
    dyn_fb_disc="AB2", static_feedback=False, feedbackthroughdict=None,
    b_mat=None, cv_mat=None, umat=None, vmat=None,
    check_ff_maxv=1e8,
    save_every=1,
    return_vp_dict=False,
    return_dictofvelstrs=False,
    data_prfx="data/traj",
    save_data=False, useolddata=False, clearprvdata=False,
    checkpoint_every=None,
    return_final_vp=True,
    vel_nwtn_stps=4, vel_nwtn_tol=1e-10, vel_pcrd_stps=2,
    paraviewoutput=False, vfileprfx="results/vel", prvoutpnts=None,
    krylov=None, krpslvprms=None,
    linsolver="auto", state_layout="auto",
    verbose=False,
    device=None,
    **kw,
):
    """Solve the time-dependent incompressible NSE.

    Key kwargs beyond the reference's (stokes_navier_utils.py:548-741):

    * ``closed_loop`` + ``dynamic_feedback``/``dyn_fb_dict``/
      ``dyn_fb_disc`` ('AB2' | 'trapezoidal' | 'linear_implicit') or
      ``static_feedback``/``feedbackthroughdict`` — LTI observer or
      low-rank state feedback (reference :1224-1263, :1367-1384) through
      ``b_mat``/``cv_mat``; ``umat``/``vmat`` for direct static feedback;
      ``controls`` (:class:`.timeint.DirichletControl`) for Dirichlet
      boundary control,
    * ``linsolver`` ('auto' | 'dense' | 'schur' | 'krylov') — per-step
      saddle solver: the dense inverse, the banded block-Schur solver
      ('auto': dense up to 6000 condensed rows, Schur above) or the
      matrix-free Krylov solver; ``krylov`` (reference kwarg, any true
      value) selects the latter,
    * ``state_layout`` ('auto' | 'full' | 'inner') — the full-dof fast
      layout for plain runs (see timeint.build_full_layout),
    * ``precision`` ('accurate' | 'fast') — f64 vs f32 element kernels on
      the CPU; on the card both run f32 kernels under an f64 carry via
      the increment formulation,
    * ``device`` — where the time loop runs; ``None`` is the CUDA card,
    * further keywords go to the integrator: ``outfunc``/``out_bundle``
      (per-step observables of ``cnab``, e.g.
      models/functionals.make_inscan_liftdrag), ``resume_carry``, and for
      ``cnab`` on the Schur solver ``warm_refine`` (residual rounds a step)
      and ``winv`` (its truncated inverse W; default by size).

    Returns a dict with final ``(v, p)`` (inner dofs / physical pressure,
    device tensors), the blow-up flag, and the decimated trajectory.
    """
    unported = dict(
        save_data=save_data, useolddata=useolddata,
        clearprvdata=clearprvdata, checkpoint_every=checkpoint_every,
        return_dictofvelstrs=return_dictofvelstrs,
        paraviewoutput=paraviewoutput)
    given = sorted(k for k, v in unported.items() if v)
    if given:
        raise NotImplementedError(
            f"solve_nse: {', '.join(given)} not ported yet (checkpoints "
            "and Paraview output follow in a later slice of the port: "
            "ROADMAP A10)")
    if krylov:
        # reference kwarg parity (solve_nse docstring
        # stokes_navier_utils.py:651-664): the per-step saddle solves go
        # through the matrix-free Krylov path
        linsolver = "krylov"
    schemes = {"cnab": timeint.cnab, "sbdf2": timeint.sbdf2}
    if time_int_scheme not in schemes:
        raise ValueError(f"time_int_scheme={time_int_scheme!r}: one of "
                         f"{sorted(schemes)}")
    device = resolve_device(device)

    if trange is None:
        trange = np.linspace(t0, tE, Nts + 1)
    trange = np.asarray(trange)

    if iniv is None:
        if start_ssstokes:
            # the host SuperLU Stokes solve on every device
            vss, pss = solve_steadystate_nse(
                prob, only_stokes=True, return_vp=True, verbose=verbose,
                linsolver="host-sparse", device=device)
            iniv = vss.ravel()[prob.invinds]
            inip = pss.ravel()
        else:
            raise ValueError("provide `iniv` or set `start_ssstokes`")
    else:
        iniv = np.asarray(iniv).ravel()
        if len(iniv) == prob.nv_full:
            iniv = iniv[prob.invinds]
    if inip is None:
        inip = np.asarray(
            get_pfromv(v=iniv, prob=prob, stokes_flow=stokes_flow,
                       device=device)
        ).ravel()

    fv_extra = None
    if closed_loop:
        # closed-loop feedback wiring (reference
        # stokes_navier_utils.py:1224-1263 dynamic, :1367-1384 static)
        if dynamic_feedback:
            dfb = dict(dyn_fb_dict)
            b_ = _dense(b_mat)
            cv_ = _dense(cv_mat)
            if dyn_fb_disc == "linear_implicit":
                # monolithic augmentation: integrate the extended
                # (flow + controller) system (time_int_utils.py:492-563)
                from ..control.augment import nse_include_lnrcntrllr

                if f_tdp is not None or controls:
                    raise NotImplementedError(
                        "linear_implicit feedback with extra forcing")
                ext = nse_include_lnrcntrllr(
                    prob=prob, hA=dfb["ha"], hB=dfb["hb"], hC=dfb["hc"],
                    B=b_, C=cv_, hM=dfb.get("hm"),
                    hiniv=dfb.get("inihx"), hf_tdp=dfb.get("drift"))
                nin = len(prob.invinds)
                eout = schemes[time_int_scheme](
                    trange=trange, prob=ext,
                    inivel=ext.extend_state(iniv),
                    inip=inip, check_ff_maxv=check_ff_maxv,
                    save_every=save_every, verbose=verbose, device=device,
                    linsolver=linsolver, **kw)
                eout["hx"] = eout["v"][nin:]
                eout["v"] = eout["v"][:nin]
                if eout["vs"] is not None:
                    eout["hxs"] = eout["vs"][:, nin:]
                    eout["vs"] = eout["vs"][:, :nin]
                eout["iniv"], eout["inip"] = iniv, inip
                return eout
            from ..control.lti import get_heunab_lti, get_heuntrpz_lti

            if dyn_fb_disc == "trapezoidal":
                fbk, mem0 = get_heuntrpz_lti(
                    hb=dfb["hb"], ha=dfb["ha"], hc=dfb["hc"],
                    inihx=dfb["inihx"], drift=dfb.get("drift"),
                    constdt=float(trange[1] - trange[0]), device=device)
            elif dyn_fb_disc == "AB2":
                fbk, mem0 = get_heunab_lti(
                    hb=dfb["hb"], ha=dfb["ha"], hc=dfb["hc"],
                    inihx=dfb["inihx"], drift=dfb.get("drift"),
                    device=device)
            else:
                raise ValueError(dyn_fb_disc)
            b_t = torch.as_tensor(b_, device=device)
            cv_t = torch.as_tensor(cv_, device=device)

            def dynamic_rhs(t, vc=None, memory=None, mode=None):
                u, memory = fbk(t, vc=cv_t @ vc, memory=memory, mode=mode)
                return b_t @ u, memory

            dynamic_rhs_memory = mem0
        elif static_feedback or feedbackthroughdict is not None:
            # time-constant low-rank feedback: A -> A - b_mat @ mtxtb.T,
            # rhs += b_mat (b_mat.T w)  (reference :1367-1384)
            fbd = feedbackthroughdict[None]
            mtxtb = _load_npa(fbd["mtxtb"])
            w = _load_npa(fbd["w"])
            b_ = _dense(b_mat)
            umat = b_
            vmat = _dense(mtxtb).T
            fv_extra = (b_ @ (b_.T @ np.asarray(w))).ravel()
            fv_fb = torch.as_tensor(fv_extra, device=device)
            prev_f_tdp = f_tdp
            if prev_f_tdp is None:
                fv0 = torch.as_tensor(np.asarray(prob.fv).ravel(),
                                      device=device)
                f_tdp = lambda t: fv0 + fv_fb                 # noqa: E731
            else:
                f_tdp = lambda t: (                           # noqa: E731
                    torch.as_tensor(prev_f_tdp(t), device=device)
                    .reshape(-1) + fv_fb)

    if not treat_nonl_explicit or lin_vel_point is not None:
        from .newton_ti import solve_nse_newton_ti

        return solve_nse_newton_ti(
            prob=prob, trange=trange, iniv=iniv, inip=inip,
            lin_vel_point=lin_vel_point, stokes_flow=stokes_flow,
            vel_nwtn_stps=vel_nwtn_stps, vel_nwtn_tol=vel_nwtn_tol,
            vel_pcrd_stps=vel_pcrd_stps, umat=umat, vmat=vmat,
            fv_extra=fv_extra, linsolver=linsolver,
            controls=controls, save_every=save_every, verbose=verbose,
            device=device, **kw)

    out = schemes[time_int_scheme](
        trange=trange, prob=prob, inivel=iniv, inip=inip,
        stokes_flow=stokes_flow,
        f_tdp=f_tdp, g_tdp=g_tdp,
        dynamic_rhs=dynamic_rhs, dynamic_rhs_memory=dynamic_rhs_memory,
        controls=controls, check_ff_maxv=check_ff_maxv,
        umat=umat, vmat=vmat, linsolver=linsolver,
        state_layout=state_layout,
        save_every=save_every, verbose=verbose, device=device, **kw)
    out["iniv"], out["inip"] = iniv, inip
    if return_vp_dict and out["times"] is not None:
        out["vp_dict"] = {
            float(t): dict(v=out["vs"][i].cpu().numpy(),
                           p=out["ps"][i].cpu().numpy())
            for i, t in enumerate(out["times"])
        }
    return out
