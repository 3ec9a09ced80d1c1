"""Output functionals: lift/drag/torque via the residual trick and the
pressure drop.

The reference evaluates drag/lift with the Babuska-Miller residual trick
(problem_setups.py:1107-1197 ``LiftDragSurfForce``; also
residual_checks.py:42-56): test the momentum residual with an indicator
function that is 1 on the body surface.  With our own full-dof operators
this collapses to *summing the discrete momentum residual over the body
dofs* — no extra assembly:

    R(v, p) = A_full v + N(v)v - JT_full p - fv_full
    drag = sum_{x-dofs on body} R,   lift = sum_{y-dofs on body} R

(A_full already carries the symmetrized-gradient outflow correction,
dolfin_to_sparrays.py:246-248.)  ``p`` is the physical pressure.

``observation_operator`` waits for the control slice of the port.
"""

import numpy as np
import torch

from ..device import resolve_device


def _host(x):
    """A flat f64 numpy copy of a tensor or array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64).ravel()


def _body_dofs(prob):
    if prob.ldsbcinds is None:
        raise ValueError("problem has no lift/drag surface")
    lds = np.asarray(prob.ldsbcinds)
    dim = getattr(prob.space, "dim", 2)
    return lds[lds % dim == 0], lds[lds % dim == 1]


class LiftDragSurfForce:
    """Drag/lift/torque evaluator bound to one problem.

    Matches the reference class of the same name
    (problem_setups.py:1107).  ``cdclfac = 2/(rho L Um^2)`` converts the
    forces to the DFG coefficients.  Host arithmetic (numpy/scipy); only
    the convection vector is evaluated on the problem's device.
    """

    def __init__(self, prob, rho=1.0, charvel=None):
        self.prob = prob
        self.xdofs, self.ydofs = _body_dofs(prob)
        self.rho = rho

    def momentum_residual(self, v_full, p):
        """Full-dof steady momentum residual (numpy, host)."""
        prob = self.prob
        v_full, p = _host(v_full), _host(p)
        kern = prob.conv_kernel
        conv = kern.vector(
            torch.as_tensor(v_full, device=kern.device)).cpu().numpy()
        fv = (np.zeros_like(v_full) if prob.fv_body_full is None
              else np.asarray(prob.fv_body_full).ravel())
        return prob.full["A"] @ v_full + conv - prob.full["JT"] @ p - fv

    def evaliftdragforce(self, v_full, p):
        """Returns ``(lift, drag)`` forces on the body (reference ordering,
        problem_setups.py:1134).

        The discrete momentum residual summed over the body dofs is the
        force the body exerts on the fluid; the benchmark force on the
        body is its negative.
        """
        res = self.momentum_residual(v_full, p) * self.rho
        drag = -res[self.xdofs].sum()
        lift = -res[self.ydofs].sum()
        return lift, drag

    def coefficients(self, v_full, p, charvel, charlen):
        """DFG coefficients ``(Cl, Cd)``."""
        lift, drag = self.evaliftdragforce(v_full, p)
        fac = 2.0 / (self.rho * charlen * charvel ** 2)
        return fac * lift, fac * drag

    def evatorque(self, v_full, p, center, radius=None):
        """Torque about ``center`` via the residual trick with the
        rotational test field ``phi = e_z x (x - c)`` on the body
        (problem_setups.py:1183-1197)."""
        res = self.momentum_residual(v_full, p) * self.rho
        coords = self.prob.space.p2_coords
        nodes_x = self.xdofs // 2
        arm = coords[nodes_x] - np.asarray(center)
        # phi_x = -(y - cy), phi_y = (x - cx); force on body = -residual
        tq = (-arm[:, 1] * res[self.xdofs]).sum() \
            + (arm[:, 0] * res[self.ydofs]).sum()
        return -tq


def make_inscan_liftdrag(prob, dt, charvel, theta=0.5, rho=1.0,
                         pdrop=((0.15, 0.2), (0.25, 0.2)), device=None):
    """In-loop per-step DFG coefficients for the full-layout CNAB loop.

    Returns ``(outfunc, out_bundle)`` for :func:`..solve.timeint.cnab`'s
    ``outfunc``/``out_bundle`` hooks: each step emits
    ``[Cl, Cd, Delta-p]`` evaluated from quantities the loop already
    carries.  Unlike the steady residual trick (and unlike the
    reference, whose per-step observables drop the unsteady term —
    tests/tdp_2D_simu.py:68-130 reuses the steady ``LiftDragSurfForce``),
    the force here is the CONSISTENT flux of the CNAB discretization:
    the body-row sum of

        M (v_n - v_c)/dt + A (theta v_n + (1-theta) v_c)
          + 0.5 (3 N(v_c)v_c - N(v_p)v_p) - J^T p_n - fv

    which is the exact discrete counterpart of the surface traction
    for the unsteady Schaefer-Turek benchmarks (2D-2/2D-3), including
    the M dv/dt contribution.  All pieces pre-sum to six body-row
    vectors (f32 tensors on ``device``, ``None`` = the problem's), so the
    per-step cost is a handful of length-nf dots.
    """
    device = resolve_device(prob.device if device is None else device)
    xdofs, ydofs = _body_dofs(prob)
    Mf, Af, JTf = prob.full["M"], prob.full["A"], prob.full["JT"]

    def rowsum(mat, idx):
        return np.asarray(mat[idx].sum(axis=0)).ravel()

    jtx, jty = rowsum(JTf, xdofs), rowsum(JTf, ydofs)
    if prob.geo.ppin is not None:          # condensed p drops the pinned
        jtx, jty = jtx[:-1], jty[:-1]      # (last) dof, models/problem.py
    fvb = (np.zeros(prob.nv_full) if prob.fv_body_full is None
           else np.asarray(prob.fv_body_full).ravel())
    # Delta-p interpolation row over the condensed pressure dofs
    pts = np.asarray(pdrop, dtype=float)
    cells_, bary = prob.space.mesh.locate(pts)
    if np.any(cells_ < 0):
        raise ValueError("pressure-drop point outside mesh")
    wp = np.zeros(JTf.shape[1])
    np.add.at(wp, prob.space.p1_dofmap[cells_[0]], bary[0])
    np.add.at(wp, prob.space.p1_dofmap[cells_[1]], -bary[1])
    if prob.geo.ppin is not None:
        wp = wp[:-1]

    f32 = torch.float32

    def dev(a, dt_=f32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dt_)

    # coefficient = 2 (rho res) / (rho L U^2): the density cancels
    fac = 2.0 / (prob.geo.charlen * charvel ** 2)
    ob = dict(
        mx=dev(rowsum(Mf, xdofs)), my=dev(rowsum(Mf, ydofs)),
        ax=dev(rowsum(Af, xdofs)), ay=dev(rowsum(Af, ydofs)),
        jtx=dev(jtx), jty=dev(jty), wp=dev(wp),
        xsel=dev(xdofs, torch.int64), ysel=dev(ydofs, torch.int64),
        fvx=torch.tensor(fvb[xdofs].sum(), dtype=f32, device=device),
        fvy=torch.tensor(fvb[ydofs].sum(), dtype=f32, device=device),
    )

    def outfunc(b, cn, co):
        o = b["ob"]
        vn, vc = cn["v"], co["v"]
        # exact O(dt) difference in the carry dtype, THEN cast (the f32
        # cast of v itself would put ~1e-4/dt noise on the M dv/dt term)
        dvv = (vn - vc).to(f32)
        vc32 = vc.to(f32)
        vmid = vc32 + theta * dvv
        dvdt = dvv / dt
        # convection at the AB2 extrapolant; nfc = -N(v)v in the carry
        conv = -(0.5 * (3.0 * cn["nfc"] - co["nfc"])).to(f32)
        p32 = cn["p"].to(f32)
        rx = (o["mx"] @ dvdt + o["ax"] @ vmid + conv[o["xsel"]].sum()
              - o["jtx"] @ p32 - o["fvx"])
        ry = (o["my"] @ dvdt + o["ay"] @ vmid + conv[o["ysel"]].sum()
              - o["jty"] @ p32 - o["fvy"])
        return torch.stack([-fac * ry, -fac * rx, o["wp"] @ p32])

    return outfunc, ob


def pressure_drop(prob, p, a1=(0.15, 0.2), a2=(0.25, 0.2)):
    """``p(a1) - p(a2)`` — the DFG pressure-drop functional
    (steadystate_schaefer-turek_2D-1.py:104-106)."""
    p = _host(p)
    if prob.geo.ppin is not None:
        p = np.concatenate([p, [0.0]])
    vals = prob.space.eval_pressure(p, np.array([a1, a2]))
    return float(vals[0] - vals[1])
