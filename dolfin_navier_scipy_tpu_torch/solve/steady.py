"""Steady-state solves.

Only the Stokes start of the time-dependent solver is ported so far:
``solve_steadystate_nse(prob, only_stokes=True, return_vp=True)``.  The
Picard/Newton iterations, the Krylov path and the pseudo-time solver
follow in the steady slice of the port.
"""

import numpy as np

from .sadpnt import solve_sadpnt_host


def solve_steadystate_nse(prob, only_stokes=False, return_vp=False,
                          verbose=True, **kw):
    """Steady Stokes on a :class:`~..models.problem.NSEProblem` (host
    SuperLU).

    Returns the velocity on the *full* dof set (boundary values appended,
    like the reference's ``_appbcs``, stokes_navier_utils.py:537) as
    ``(nv_full, 1)`` and, with ``return_vp``, the physical pressure
    ``(np_cond, 1)``.
    """
    if not only_stokes or kw:
        raise NotImplementedError(
            "solve_steadystate_nse: only `only_stokes=True` (with "
            "`return_vp`, `verbose`) is ported so far; Picard/Newton, data "
            "caching and the linsolver choices follow in the steady slice"
            + (f" (got {sorted(kw)})" if kw else ""))
    nin = len(prob.invinds)
    vp = solve_sadpnt_host(amat=prob.Ac, jmat=prob.Jc, jmatT=prob.JTc,
                           rhsv=np.asarray(prob.fv).ravel(),
                           rhsp=np.asarray(prob.fp).ravel())
    vwc = prob.bc_full_vec()
    vwc[prob.invinds] = vp[:nin, 0]
    vwc = vwc.reshape(-1, 1)
    if return_vp:
        return vwc, -vp[nin:, :]
    return vwc
