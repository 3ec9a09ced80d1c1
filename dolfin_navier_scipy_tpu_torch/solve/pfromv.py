"""Pressure recovery from a velocity field.

Twin of the reference's ``get_pfromv`` (stokes_navier_utils.py:1602-1634):
solve ``[[M, J^T],[J,0]][w;q] = [fv - A v - N(v)v; 0]`` and return the
physical pressure ``p = -q``.  Only valid for a constant rhs in the
continuity equation (same caveat as the reference).
"""

import numpy as np

from .sadpnt import solve_sadpnt_host


def get_pfromv(v=None, prob=None, stokes_flow=False, device=None, **kw):
    """``v`` is the *inner* (condensed) velocity; returns ``p (np_cond, 1)``.

    A one-off setup solve -> host SuperLU; only the convection vector is
    evaluated on ``device``.
    """
    v = np.asarray(v).ravel()
    if stokes_flow:
        rhs_con = 0.0
    else:
        kern = prob.conv_kernel_on(device=device)
        v_full = prob.embed(v, device=kern.device)
        rhs_con = kern.vector(v_full).cpu().numpy()[prob.invinds]
    rhsv = prob.fv.ravel() - prob.Ac @ v - rhs_con
    vp = solve_sadpnt_host(amat=prob.Mc, jmat=prob.Jc, jmatT=prob.JTc,
                           rhsv=rhsv)
    return -vp[prob.Jc.shape[1]:, :]
