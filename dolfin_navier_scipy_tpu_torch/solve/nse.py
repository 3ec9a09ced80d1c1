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
:1304-1587); the checkpoint store (``save_data``/``useolddata``/
``clearprvdata``/``checkpoint_every``), the file-backed trajectory
(``return_dictofvelstrs``) and the Paraview series (``paraviewoutput``)
of the semi-explicit schemes.  As in the JAX package, the Newton-in-time
path takes none of the last three groups.
"""

import glob
import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..utils.io import get_datastr, host, save_npa
from .pfromv import get_pfromv
from .steady import solve_steadystate_nse
from . import timeint


# the control terms a JAX carry holds in a run without controls too, with
# the JAX package's empty values
_JAX_CONTROL_KEYS = dict(cnab=dict(cvals=None, cmems=(), bfv=0.0, mbc=0.0),
                         sbdf2=dict(cvals=None, cmems=(), mbc=0.0,
                                    mbc_p=0.0))


def _carry_to_host(carry, scheme):
    """A loop carry -> the ``.npz`` payload of a checkpoint: one pickled
    tree of host arrays under ``carry_pkl``, with the JAX carry's key
    names (the control terms a run without controls leaves out are added
    with the JAX package's empty values) — the JAX package's format (its
    ``solve/nse.py: _carry_to_host``), so a file either package writes is
    one the other resumes.  Checkpoints are trusted files: load only the
    ones the package wrote."""
    carry = {**_JAX_CONTROL_KEYS[scheme], **carry}

    def to_host(x):
        if torch.is_tensor(x):
            return host(x)
        if isinstance(x, dict):
            return {k: to_host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_host(v) for v in x)
        return x

    return {"carry_pkl": np.frombuffer(pickle.dumps(to_host(carry)),
                                       dtype=np.uint8)}


def _carry_from_npz(path, device):
    """The port's ``resume_carry`` from an ``.npz`` checkpoint of either
    package (the pickled tree of host arrays)."""
    from ..utils.convert import carry_from_jax

    dat = np.load(path)
    return carry_from_jax(pickle.loads(dat["carry_pkl"].tobytes()), device)


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
    * ``save_data``/``useolddata``/``clearprvdata``/``checkpoint_every``
      — ``get_datastr``-keyed loop-carry checkpoints (``data_prfx``) with
      EXACT resume: the horizon runs in sections on the inner state layout,
      each section's final carry stored (``save_data``), the run resumed
      from the latest stored one (``useolddata``); ``return_dictofvelstrs``
      — the saved states as ``.npy`` files, ``{t: path}``;
      ``paraviewoutput``/``vfileprfx``/``prvoutpnts`` — the saved states
      as a PVD series,
    * ``device`` — where the time loop runs; ``None`` is the CUDA card,
    * further keywords go to the integrator: ``outfunc``/``out_bundle``
      (per-step observables of ``cnab``, e.g.
      models/functionals.make_inscan_liftdrag), ``resume_carry``, and for
      ``cnab`` on the Schur solver ``warm_refine`` (residual rounds a step)
      and ``winv`` (its truncated inverse W; default by size).

    Returns a dict with final ``(v, p)`` (inner dofs / physical pressure,
    device tensors), the blow-up flag, and the decimated trajectory.
    """
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

    ckpt = save_data or useolddata or clearprvdata

    def integrate(tpiece, resume_carry=None):
        return schemes[time_int_scheme](
            trange=tpiece, prob=prob, inivel=iniv, inip=inip,
            stokes_flow=stokes_flow,
            f_tdp=f_tdp, g_tdp=g_tdp,
            dynamic_rhs=dynamic_rhs, dynamic_rhs_memory=dynamic_rhs_memory,
            controls=controls, check_ff_maxv=check_ff_maxv,
            umat=umat, vmat=vmat, linsolver=linsolver,
            # checkpoint carries are stored in the inner layout; every
            # section runs on it, so resumed sections match
            state_layout="inner" if ckpt else state_layout,
            save_every=save_every, resume_carry=resume_carry,
            verbose=verbose, device=device, **kw)

    if ckpt:
        # the checkpoint store keyed like the reference's per-step cache
        # (get_datastr_snu, stokes_navier_utils.py:21-37, :950-1070);
        # checkpoints hold the whole loop carry, so a resumed run gives
        # the uninterrupted trajectory EXACTLY (the reference re-bootstraps
        # from the last stored velocity)
        nts = len(trange) - 1

        def ckpt_path(t):
            key = get_datastr(time=None if t is None else float(t),
                              meshp=prob.nv_full, nu=prob.nu, Nts=nts,
                              data_prfx=data_prfx, semiexpl=True)
            return key + "__carry.npz"

        if clearprvdata:
            pat = ckpt_path(None).replace("timeNone", "time*")
            for f in glob.glob(pat):
                os.remove(f)
        k_ck = checkpoint_every or max(1, nts // 4)
        # checkpoint indices: multiples of k_ck (past 0 and 1, where the
        # bootstrap lives) and the final step
        ckinds = [i for i in range(k_ck, nts, k_ck) if i >= 2] + [nts]
        i_start, carry = 0, None
        if useolddata:
            for i in sorted(ckinds, reverse=True):
                if os.path.exists(ckpt_path(trange[i])):
                    carry = _carry_from_npz(ckpt_path(trange[i]), device)
                    i_start = i
                    break
        bounds = [i for i in ckinds if i > i_start]
        if not bounds:
            # the stored final checkpoint covers the horizon already
            return dict(v=carry["v"], p=carry["p"],
                        ffflag=bool(carry["flag"]), times=None, vs=None,
                        ps=None, carry=carry, iniv=iniv, inip=inip,
                        resumed_from=float(trange[i_start]))
        # each section builds its operators from its own step (as the JAX
        # package does), so a resumed section repeats the bits of the
        # uninterrupted run's
        pieces, lo = [], i_start
        for hi in bounds:
            out = integrate(trange[lo:hi + 1], resume_carry=carry)
            carry = out["carry"]
            if save_data:
                path = ckpt_path(trange[hi])
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                np.savez(path, **_carry_to_host(carry, time_int_scheme))
            pieces.append(out)
            lo = hi
        out = pieces[-1]
        saved = [p for p in pieces if p["times"] is not None]
        if len(pieces) > 1 and out["times"] is not None:
            out["times"] = np.concatenate([p["times"] for p in saved])
            out["vs"] = torch.cat([p["vs"] for p in saved])
            out["ps"] = torch.cat([p["ps"] for p in saved])
            out["ffflag"] = any(p["ffflag"] for p in pieces)
    else:
        out = integrate(trange)
    out["iniv"], out["inip"] = iniv, inip
    if return_vp_dict and out["times"] is not None:
        out["vp_dict"] = {
            float(t): dict(v=out["vs"][i].cpu().numpy(),
                           p=out["ps"][i].cpu().numpy())
            for i, t in enumerate(out["times"])
        }
    if return_dictofvelstrs and out["times"] is not None:
        # the file-backed trajectory {t: path}: the reference's way of
        # handing linearization points between runs
        # (stokes_navier_utils.py:1057-1070)
        os.makedirs(os.path.dirname(data_prfx) or ".", exist_ok=True)
        out["dictofvelstrs"] = {}
        for i, t in enumerate(out["times"]):
            pth = f"{data_prfx}__vel_t{float(t):.6f}"
            save_npa(out["vs"][i], pth)
            out["dictofvelstrs"][float(t)] = pth + ".npy"
    if paraviewoutput and out["times"] is not None:
        # the saved states as a PVD series, written after the loop from
        # host copies (the reference writes inside its loop)
        from ..utils.vtk import PVDWriter

        pvd = PVDWriter(vfileprfx, prob, tfilter=prvoutpnts)
        for i, t in enumerate(out["times"]):
            pvd.write(v_full=prob.embed(out["vs"][i]), p=out["ps"][i],
                      t=float(t))
        pvd.close()
        out["pvdfile"] = vfileprfx + ".pvd"
    return out
