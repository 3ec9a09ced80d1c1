"""``solve_nse`` — the time-dependent orchestrator.

Facade over the step-loop integrators mirroring the reference's big
kwargs-driven entry point (stokes_navier_utils.py:548-1599):

* initial value: steady Stokes solve (``start_ssstokes``,
  reference :836-911) or a provided ``iniv``,
* initial pressure via :func:`get_pfromv` (reference :921-940),
* semi-explicit dispatch to ``cnab`` / ``sbdf2`` (reference :1218-1221),
* trajectories returned in device memory instead of the reference's
  per-step ``.npy`` files (``dictofvelstrs``, :1057-1070).

Ported so far: both integrators on the dense solver, with time-dependent
right-hand sides, in-loop observables (``outfunc``/``out_bundle``, CNAB)
and ``resume_carry`` passed through to them.  Closed-loop feedback,
checkpoints, Newton-in-time, Krylov solves and Paraview output raise
``NotImplementedError``.
"""

import numpy as np

from ..device import resolve_device
from .pfromv import get_pfromv
from .steady import solve_steadystate_nse
from . import timeint


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

    * ``linsolver`` ('auto' | 'dense') — per-step saddle solver choice
      ('schur' and 'krylov' are not ported yet; 'auto' resolves to 'schur'
      above 6000 condensed rows, so larger problems pass 'dense'),
    * ``state_layout`` ('auto' | 'full' | 'inner') — the full-dof fast
      layout for plain runs (see timeint.build_full_layout),
    * ``precision`` ('accurate' | 'fast') — f64 vs f32 element kernels on
      the CPU; on the card both run f32 kernels under an f64 carry via
      the increment formulation,
    * ``device`` — where the time loop runs; ``None`` is the CUDA card,
    * further keywords go to the integrator: ``outfunc``/``out_bundle``
      (per-step observables of ``cnab``, e.g.
      models/functionals.make_inscan_liftdrag) and ``resume_carry``.

    Returns a dict with final ``(v, p)`` (inner dofs / physical pressure,
    device tensors), the blow-up flag, and the decimated trajectory.
    """
    unported = dict(
        closed_loop=closed_loop, dynamic_feedback=dynamic_feedback,
        static_feedback=static_feedback,
        feedbackthroughdict=feedbackthroughdict,
        lin_vel_point=lin_vel_point, krylov=krylov,
        save_data=save_data, useolddata=useolddata,
        clearprvdata=clearprvdata, checkpoint_every=checkpoint_every,
        return_dictofvelstrs=return_dictofvelstrs,
        paraviewoutput=paraviewoutput,
        newton_in_time=not treat_nonl_explicit)
    given = sorted(k for k, v in unported.items() if v)
    if given:
        raise NotImplementedError(
            f"solve_nse: {', '.join(given)} not ported yet (closed loop, "
            "checkpoints, Newton-in-time, Krylov and Paraview output "
            "follow in later slices of the port)")
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
            vss, pss = solve_steadystate_nse(
                prob, only_stokes=True, return_vp=True, verbose=verbose)
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
