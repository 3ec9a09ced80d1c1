"""Quadratic-form representation of the convection: ``N(v)v = H (v (x) v)``.

Twin of the JAX package's ``ops/quadform.py`` (the reference's
``ass_convmat_asmatquad``, dolfin_to_sparrays.py:86-164, which assembles
the third-order tensor H column by column through FEniCS).  H exists in
its element-local form — one small constant tensor per element,

    hel[e, a, b, (c,k)] = int_e  N_a  dN_b/dx_k  N_c  dx,

so that ``((u.grad) w)`` tested with ``phi_(a,i)`` is ``sum hel[e,a,b,(c,k)]
w_(b,i) u_(c,k)``.  :class:`QuadConvOp` applies it on a device (an
analysis operator for quadratic model reduction and eigenvalue studies,
not on the time loop: plain torch); :func:`ass_convmat_asmatquad` exports
the scipy matrix.
"""

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device
from .kernels import dof_slot_table, ell_slot_table


def quad_tensor_elements(ctx):
    """Element tensors ``hel (nc, 6, 6, 12)`` with the last axis packing
    ``(c, k) -> 2*c + k`` (node c, derivative direction k)."""
    hel = np.einsum("eq,qa,eqbk,qc->eabck",
                    ctx.wdet, ctx.N2, ctx.gphi2, ctx.N2)
    nc = hel.shape[0]
    return hel.reshape(nc, 6, 6, 12)


class QuadConvOp:
    """Device quadratic-convection operator from element tensors.

    ``hel (nc, 6, 6, 12)``, ``nodes (nc, 6)`` P2 node ids, ``ell (width,
    nv_full)`` the fixed-order slot table of the element loads (each dof's
    slots in ascending order, ``len(slots)`` past its count): the sums of
    :meth:`vector` are the same bits on every run and every device."""

    def __init__(self, hel, nodes, ell, nv_full):
        self.hel = hel
        self.nodes = nodes
        self.ell = ell
        self.nv_full = nv_full

    @classmethod
    def from_ctx(cls, ctx, dtype=torch.float64, device=None):
        device = resolve_device(device)
        space = ctx.space
        vd = space.vdofs_of_cells().reshape(-1)
        ell = ell_slot_table(*dof_slot_table(vd, space.nv_full)).astype(
            np.int64)
        ell[ell < 0] = len(vd)
        return cls(
            torch.as_tensor(quad_tensor_elements(ctx), dtype=dtype,
                            device=device),
            torch.as_tensor(np.asarray(space.p2_dofmap), dtype=torch.int64,
                            device=device),
            torch.as_tensor(ell, device=device), space.nv_full)

    def _sum(self, fe):
        """Each dof's element loads added in its slots' order."""
        vals = torch.cat([fe.reshape(-1), fe.new_zeros(1)])
        out = vals[self.ell[0]]
        for row in self.ell[1:]:
            out = out + vals[row]
        return out

    def vector(self, w_full, u_full=None):
        """``int ((u.grad) w) . phi`` — equal to ``ConvectionKernel.vector(w,
        u)``; full-dof output."""
        if u_full is None:
            u_full = w_full
        we = w_full.to(self.hel.dtype).reshape(-1, 2)[self.nodes]
        ue = u_full.to(self.hel.dtype).reshape(-1, 2)[self.nodes]
        uck = ue.reshape(-1, 12)                        # (c,k) packed
        # f[e,a,i] = sum_b,ck hel[e,a,b,ck] w[e,b,i] u[e,ck]
        hu = torch.einsum("eabm,em->eab", self.hel, uck)
        fe = torch.einsum("eab,ebi->eai", hu, we)
        return self._sum(fe)

    def linearized(self, v_full):
        """Element matrices ``(nc, 6, 2, 6, 2)`` of the Newton linearization
        ``N1(v) + N2(v)`` from H alone: d/dw [H(w (x) w)] at w=v."""
        ve = v_full.to(self.hel.dtype).reshape(-1, 2)[self.nodes]
        vck = ve.reshape(-1, 12)
        # N1 part: hel . v over the u-slot -> scalar (a,b) blocks x delta_ij
        hv = torch.einsum("eabm,em->eab", self.hel, vck)
        eye = torch.eye(2, dtype=hv.dtype, device=hv.device)
        n1 = torch.einsum("eab,ij->eaibj", hv, eye)
        # N2 part: hel . v over the w-slot
        hw = torch.einsum("eabm,ebi->eaim", self.hel, ve)   # m=(c,k)
        n2 = hw.reshape(hw.shape[0], 6, 2, 6, 2)            # (a,i,c,k)
        return n1 + n2


def ass_convmat_asmatquad(ctx, space=None, invinds=None):
    """Exported sparse ``H (NV, NV*NV)`` with ``N(v)v = H (v (x) v)`` on
    the full dof set — API parity with dolfin_to_sparrays.py:86.

    Kronecker layout: column index ``b_dof * NV + c_dof`` multiplies
    ``w[b_dof] * u[c_dof]`` (matching ``np.kron(v, v)``).
    """
    space = space or ctx.space
    hel = quad_tensor_elements(ctx)          # (nc,6,6,12)
    nc = hel.shape[0]
    NV = space.nv_full
    vd = space.vdofs_of_cells()              # (nc,6,2)
    hel5 = hel.reshape(nc, 6, 6, 6, 2)       # (a, b, c, k)

    rows, cols, vals = [], [], []
    for a in range(6):
        for b in range(6):
            for c in range(6):
                for i in range(2):
                    for k in range(2):
                        rows.append(vd[:, a, i])
                        cols.append(vd[:, b, i] * NV + vd[:, c, k])
                        vals.append(hel5[:, a, b, c, k])
    H = sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(NV, NV * NV)).tocsr()
    H.eliminate_zeros()
    return H
