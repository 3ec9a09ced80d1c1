"""Affine-geometry-factorized operator application for P2/P1 operators on
straight triangles.

On affine elements every FEM operator factorizes as
``sum_r geo_r[e] * (constant reference matrix)``: applying M/A/J/J^T
reduces to per-element geometry contractions against constant reference
tables around one gather and one fixed-order reduction.  Each matvec is
one call of :func:`..ops.kernels.affine_mv` (the saddle residual ``[K v +
J^T q ; J v]`` one of :func:`..ops.kernels.affine_residual`): the
hand-written kernel of
``csrc/affine.cu`` on the card, its plain PyTorch version (constant-weight
matmuls, einsums, segment sums over the tables built here) on the CPU.

Dirichlet condensation is realized by index masking (a dropped extra
segment for rows + zero-padded columns).
"""

import numpy as np
import torch

from ..device import resolve_device
from .convection import reference_weight_matrices
from .kernels import DofTable, affine_mv, affine_residual, dof_slot_table


def _volume_a_elements(ctx, nu, gradvsymmtrc=True):
    """Volume part of the stiffness element tensors (nc,dn,dn) — used to
    split the assembled element tensors into volume + facet corrections."""
    nc = ctx.wdet.shape[0]
    nvpc = ctx.N2.shape[1]
    dim = getattr(ctx, "dim", 2)
    K1 = np.einsum("eq,eqad,eqbd->eab", ctx.wdet, ctx.gphi2, ctx.gphi2)
    Avec = np.zeros((nc, nvpc, dim, nvpc, dim))
    for c in range(dim):
        Avec[:, :, c, :, c] += K1
    if gradvsymmtrc:
        Avec += np.einsum("eq,eqbi,eqaj->eaibj", ctx.wdet, ctx.gphi2,
                          ctx.gphi2)
    return nu * Avec.reshape(nc, dim * nvpc, dim * nvpc)


def _segment_table(ids, nseg, dtype, device):
    """Gather form of a scatter-add into ``nseg`` segments: ``pos (nseg,
    width)`` flat positions of each segment's summands (ascending) and
    ``mask`` (1 for a summand, 0 for padding), so that the segment sum is
    ``(vals[pos] * mask).sum(1)`` — no atomic adds, hence the same bits
    from run to run on the card.  Ids outside ``[0, nseg)`` are dropped."""
    rowptr, slots = dof_slot_table(ids, nseg)
    cnt = np.diff(rowptr)
    pos = np.zeros((nseg, max(1, int(cnt.max(initial=0)))), dtype=np.int64)
    mask = np.zeros(pos.shape)
    rows = np.repeat(np.arange(nseg), cnt)
    cols = np.arange(len(slots)) - rowptr[:-1][rows]
    pos[rows, cols] = slots
    mask[rows, cols] = 1.0
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(mask).to(device=device, dtype=dtype))


class AffineVectorOps:
    """Fused device matvecs for (M, A, J, J^T) on the inner dofs (or, with
    ``full_dofs``, on the full velocity dof vector)."""

    def __init__(self, **kw):
        # tensors: W1 W2 W2T MrefI2 (the plain version's) N2 dN2 qw N1q
        # JinvT wdet detJ vdofs pdofs fac_elem fac_vdofs; DofTables (what
        # the kernels take): vtab (vdofs), ptab (pdofs), fac_dofs
        # (fac_vdofs, also the fused convection kernel's); (pos, mask)
        # segment tables of the plain version: vseg pseg fseg;
        # scalars: nin npc Q nu nc nvpc pnpc sym dim
        self.__dict__.update(kw)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, prob, dtype=torch.float64, full_dofs=False, device=None):
        """``full_dofs=True`` builds matvecs over the FULL velocity dof
        vector (bc dofs included): no inner<->full index translation per
        application — the fast state layout for time stepping, where a
        zero-padded solver masks the bc rows (outputs carry element
        contributions at bc rows; callers must ignore them)."""
        device = resolve_device(device)
        ctx = prob.ctx
        space = prob.space
        Q = ctx.N2.shape[0]
        nvpc = ctx.N2.shape[1]          # velocity nodes per cell
        pnpc = ctx.N1.shape[1]          # pressure nodes per cell
        dim = getattr(ctx, "dim", 2)
        nd = dim * nvpc
        W1, W2, _ = reference_weight_matrices(ctx)
        Mref = np.einsum("q,qa,qb->ab", ctx.qwts, ctx.N2, ctx.N2)
        MrefI2 = np.kron(Mref, np.eye(dim))

        vd = space.vdofs_of_cells().reshape(-1, nd)
        if full_dofs:
            nin = prob.nv_full
            vdofs = vd
        else:
            nin = len(prob.invinds)
            full2in = np.full(prob.nv_full + 1, nin, dtype=np.int64)
            full2in[prob.invinds] = np.arange(nin, dtype=np.int64)
            vdofs = full2in[vd]

        npc = prob.np_cond
        p_full2c = np.full(space.np_full, npc, dtype=np.int64)
        p_full2c[np.arange(npc)] = np.arange(npc, dtype=np.int64)
        pdofs = p_full2c[space.p1_dofmap]

        # facet corrections folded into the assembled A (outflow + Robin):
        # recovered as (stored element A) - (volume A)
        sym = bool(getattr(prob, "gradvsymmtrc", True))
        volA = _volume_a_elements(ctx, prob.nu, sym)
        corr = prob.elem_tensors["A"] - volA
        nrm = np.abs(corr).sum(axis=(1, 2))
        fsel = np.flatnonzero(nrm > 1e-15)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        fac_vdofs = dev(vdofs[fsel], torch.int64)
        vdofs_t, pdofs_t = dev(vdofs, torch.int64), dev(pdofs, torch.int64)
        return cls(
            W1=dev(W1), W2=dev(W2), W2T=dev(W2.T), MrefI2=dev(MrefI2),
            N2=dev(ctx.N2), dN2=dev(ctx.dN2), qw=dev(ctx.qwts),
            N1q=dev(ctx.N1), JinvT=dev(ctx.JinvT), wdet=dev(ctx.wdet),
            detJ=dev(ctx.detJ),
            vdofs=vdofs_t, pdofs=pdofs_t,
            vtab=DofTable(vdofs_t, nin), ptab=DofTable(pdofs_t, npc),
            fac_elem=dev(corr[fsel]),
            fac_vdofs=fac_vdofs, fac_dofs=DofTable(fac_vdofs, nin),
            vseg=_segment_table(vdofs, nin, dtype, device),
            pseg=_segment_table(pdofs, npc, dtype, device),
            fseg=_segment_table(vdofs[fsel], nin, dtype, device),
            nin=nin, npc=npc, Q=Q, nu=float(prob.nu),
            nc=ctx.wdet.shape[0], nvpc=nvpc, pnpc=pnpc, sym=sym, dim=dim,
            _plans={},
        )

    # -- matvecs: each one call of the hand-written kernel ------------------
    def m_matvec(self, x):
        return affine_mv("m", x, self)

    def a_matvec(self, x):
        return affine_mv("a", x, self)

    def ma_matvec(self, x, cm, ca):
        """Fused ``cm * M @ x + ca * A @ x`` sharing gather/scatter."""
        return affine_mv("ma", x, self, cm, ca)

    def j_matvec(self, x):
        """``J @ x``: q-weighted divergence."""
        return affine_mv("j", x, self)

    def jt_matvec(self, q):
        """``J^T @ q``."""
        return affine_mv("jt", q, self)

    def saddle_residual(self, v, q, cm, ca):
        """``[cm M v + ca A v + J^T q ; J v]``: the three matvecs of the
        dense solver's refinement round in one call (:func:`..ops.kernels.
        affine_residual`)."""
        return affine_residual(v, q, self, cm, ca)

    def view(self, kind, cm=1.0, ca=0.0):
        """A matvec-interface view: kind in {'m','a','ma','j'}; 'ma' is
        the fused ``cm*M + ca*A``; 'j' also exposes ``rmatvec = J^T``."""
        return OpView(self, kind, cm, ca)


class OpView:
    """Matvec view over an :class:`AffineVectorOps` bundle."""

    def __init__(self, aff, kind, cm=1.0, ca=0.0):
        self.aff = aff
        self.kind = kind
        self.cm = cm
        self.ca = ca

    @property
    def shape(self):
        n = self.aff.nin
        if self.kind == "j":
            return (self.aff.npc, n)
        return (n, n)

    def matvec(self, x):
        if self.kind == "m":
            return self.aff.m_matvec(x)
        if self.kind == "a":
            return self.aff.a_matvec(x)
        if self.kind == "ma":
            return self.aff.ma_matvec(x, self.cm, self.ca)
        if self.kind == "j":
            return self.aff.j_matvec(x)
        raise ValueError(self.kind)

    def rmatvec(self, q):
        assert self.kind == "j"
        return self.aff.jt_matvec(q)
