"""LTI controller discretizations as functions with explicit memory.

Twins of the reference's ``get_heunab_lti`` / ``get_heuntrpz_lti``
(time_int_utils.py:148-257): step a linear observer

    hx' = hA hx + hb y,    u = hc hx   (+ drift)

alongside the flow with matched Heun/AB2 or Heun/implicit-trapezoidal
schemes.  The reference's mutable ``memory`` dicts become explicit state
threaded through the integrators' ``dynamic_rhs`` protocol (modes: init /
heunpred / heuncorr / abtwo): a dict of tensors on the caller's device
(and host floats for the time points), returned anew at every call.
"""

import numpy as np
import torch

from ..device import resolve_device


def _dev(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float64), device=device)


def _vec(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float64).reshape(-1)
    return _dev(x, device).reshape(-1)


def get_heunab_lti(hb=None, ha=None, hc=None, inihx=None, drift=None,
                   device=None):
    """Heun/AB2 observer stepping (time_int_utils.py:148-196).

    Returns ``(fn, memory0)`` with
    ``fn(t, vc=None, memory=..., mode=...) -> (hc @ hx, memory)``; the
    tensors live on ``device`` (``None`` = the card).
    """
    device = resolve_device(device)
    ha, hb, hc = (_dev(m, device) for m in (ha, hb, hc))
    inihx = _vec(inihx, device)
    if drift is None:
        zero = torch.zeros_like(inihx)
        drift = lambda t: zero                     # noqa: E731

    mem0 = dict(lastt=0.0, lasthx=inihx, lastrhs=torch.zeros_like(inihx),
                lastdt=0.0, hphx=inihx)

    def fn(t, vc=None, memory=None, mode="abtwo"):
        m = dict(memory)
        vc = _vec(vc, device) if vc is not None else None
        if mode == "init":
            m.update(lastt=t, lasthx=inihx)
            return hc @ inihx, m
        if mode == "heunpred":
            curdt = t - m["lastt"]
            currhs = ha @ inihx + hb @ vc + drift(m["lastt"])
            chx = inihx + curdt * currhs
            m.update(lastrhs=currhs, hphx=chx)
            return hc @ chx, m
        if mode == "heuncorr":
            curdt = t - m["lastt"]
            currhs = ha @ m["hphx"] + hb @ vc + drift(t)
            chx = inihx + 0.5 * curdt * (currhs + m["lastrhs"])
            m.update(lastt=t, lasthx=chx, lastdt=curdt)
            return hc @ chx, m
        # abtwo
        curdt = t - m["lastt"]
        currhs = ha @ m["lasthx"] + hb @ vc + drift(m["lastt"])
        chx = (m["lasthx"] + 1.5 * curdt * currhs
               - 0.5 * m["lastdt"] * m["lastrhs"])
        m.update(lastt=t, lasthx=chx, lastrhs=currhs, lastdt=curdt)
        return hc @ chx, m

    return fn, mem0


def get_heuntrpz_lti(hb=None, ha=None, hc=None, inihx=None, drift=None,
                     constdt=None, device=None):
    """Heun bootstrap + implicit-trapezoidal observer stepping
    (time_int_utils.py:199-257); requires a uniform time grid."""
    if constdt is None:
        raise NotImplementedError("uniform time grid required (reference "
                                  "raises too, time_int_utils.py:217)")
    device = resolve_device(device)
    hN = np.asarray(ha).shape[0]
    cdt = constdt
    obsitmat = _dev(np.linalg.inv(np.eye(hN)
                                  - constdt / 2.0 * np.asarray(ha)), device)
    ha, hb, hc = (_dev(m, device) for m in (ha, hb, hc))
    inihx = _vec(inihx, device)
    if drift is None:
        zero = torch.zeros_like(inihx)
        drift = lambda t: zero                     # noqa: E731

    mem0 = dict(lastt=0.0, lasthx=inihx, lastrhs=torch.zeros_like(inihx),
                hphx=inihx)

    def fn(t, vc=None, memory=None, mode="abtwo"):
        m = dict(memory)
        vc = _vec(vc, device) if vc is not None else None
        if mode == "init":
            m.update(lastt=t, lasthx=inihx)
            return hc @ inihx, m
        if mode == "heunpred":
            currhs = hb @ vc + drift(t)
            chx = inihx + cdt * (ha @ inihx + currhs)
            m.update(lastrhs=currhs, lasthx=inihx, hphx=chx)
            return hc @ chx, m
        if mode == "heuncorr":
            currhs = hb @ vc + drift(t)
            chx = inihx + 0.5 * cdt * (
                ha @ (m["hphx"] + m["lasthx"]) + currhs + m["lastrhs"])
            m.update(lastt=t, lasthx=chx, lastrhs=currhs)
            return hc @ chx, m
        # implicit trapezoidal
        crhs = hb @ vc + drift(t)
        chx = obsitmat @ (m["lasthx"] + 0.5 * cdt * (
            ha @ m["lasthx"] + crhs + m["lastrhs"]))
        m.update(lasthx=chx, lastrhs=crhs)
        return hc @ chx, m

    return fn, mem0
