"""Element-level (assembly-free) operator application.

A global FEM operator is a sum of per-element dense blocks; applying it
as ``scatter(elem @ gather(x))`` needs only the ~12 gathered values of
each element and one small dense product per element.  Every matvec here
is one call of :func:`..ops.kernels.elem_mv`: the hand-written kernel of
``csrc/elemmv.cu`` on the card, its plain PyTorch version on the CPU.
"""

import numpy as np
import torch

from ..device import resolve_device
from .kernels import DofTable, elem_mv


def _table(ids, n):
    return ids if isinstance(ids, DofTable) else DofTable(ids, n)


class ElementOp:
    """Velocity-space operator from element tensors, masked to inner dofs.

    ``elem (nc, nd, nd)``, ``dofs (nc, nd)`` (``nd`` 12 in 2D, 30 in 3D; a
    tensor or its
    :class:`..ops.kernels.DofTable`) mapping each element dof to its
    *inner* index, with ``n`` (= trash) for Dirichlet dofs: columns at
    boundary dofs read 0, rows there go to a dropped slot — the
    element-level realization of BC condensation
    (dolfin_to_sparrays.py:548-552).
    """

    def __init__(self, elem, dofs, n):
        self.elem = elem
        self.tab = _table(dofs, n)
        self.dofs = self.tab.vd
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return elem_mv(self.elem, x, self.tab, self.tab)

    def scale(self, alpha):
        return ElementOp(alpha * self.elem, self.tab, self.n)

    def axpy(self, alpha, other: "ElementOp"):
        """``self + alpha * other`` (same mesh/dof layout)."""
        return ElementOp(self.elem + alpha * other.elem, self.tab, self.n)


class DivElementOp:
    """Divergence block ``J`` (pressure rows x velocity cols) and its
    transpose, from element tensors ``(nc, pnpc, nd)``."""

    def __init__(self, elem, pdofs, vdofs, n_p, n_v):
        self.elem = elem                    # (nc, pnpc, nd)
        self.ptab = _table(pdofs, n_p)      # (nc, pnpc) -> [0, n_p] (trash)
        self.vtab = _table(vdofs, n_v)      # (nc, nd) -> [0, n_v]
        self.pdofs, self.vdofs = self.ptab.vd, self.vtab.vd
        self.n_p = n_p
        self.n_v = n_v

    @property
    def shape(self):
        return (self.n_p, self.n_v)

    def matvec(self, v):
        """``J @ v``: velocity (inner) -> pressure."""
        return elem_mv(self.elem, v, self.vtab, self.ptab)

    def rmatvec(self, q):
        """``J^T @ q``: pressure -> velocity (inner)."""
        return elem_mv(self.elem, q, self.ptab, self.vtab, transpose=True)


def build_element_ops(prob, dtype=torch.float64, device=None):
    """Element-level (M, A, J) ops condensed to a problem's inner dofs on
    ``device`` (``None`` = the card), from the element tensors kept at
    assembly time (:func:`..ops.assemble.assemble_stokes`)."""
    device = resolve_device(device)
    tens = prob.elem_tensors
    space = prob.space
    nin = len(prob.invinds)
    full2in = np.full(prob.nv_full + 1, nin, dtype=np.int64)
    full2in[prob.invinds] = np.arange(nin, dtype=np.int64)
    vd = space.vdofs_of_cells()
    vd = vd.reshape(vd.shape[0], -1)                   # (nc, nd)
    vtab = DofTable(torch.as_tensor(full2in[vd], device=device), nin)

    npc = prob.np_cond
    p_full2c = np.full(space.np_full, npc, dtype=np.int64)
    # pressure dofs are not condensed (only possibly pinned at the last)
    p_full2c[np.arange(npc)] = np.arange(npc, dtype=np.int64)
    ptab = DofTable(torch.as_tensor(p_full2c[space.p1_dofmap],
                                    device=device), npc)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    M = ElementOp(dev(tens["M"]), vtab, nin)
    A = ElementOp(dev(tens["A"]), vtab, nin)
    J = DivElementOp(dev(tens["J"]), ptab, vtab, npc, nin)
    return M, A, J
