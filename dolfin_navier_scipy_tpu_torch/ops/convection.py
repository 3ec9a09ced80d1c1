"""Convection operators: the per-step hot path.

The reference re-assembles the convection terms through FEniCS at *every*
linearization point / time step (dolfin_to_sparrays.py:325-472).  Here the
same operators are computed on the device with static-shape tensor code:

* ``convection_vector``:  ``c[(a,i)] = int ((u2 . grad) u1)_i phi_a dx``
  matching ``dts.get_convvec(uone=u1, utwo=u2)`` (UFL ``grad(u1)*u2``),
* ``convection_matrices``: ``N1(u0) ~ (u0 . grad) u`` and
  ``N2(u0) ~ (u . grad) u0``  (dolfin_to_sparrays.py:325-376).

Host (numpy) twins are provided as correctness oracles for the tests.
"""

import copy

import numpy as np
import torch

from ..device import resolve_device
from .assemble import AssemblyContext
from .kernels import (ConvTables, _fields_at_quad, conv_vector,
                      conv_vector_amatvec, weight_matrices)


# ---------------------------------------------------------------------------
# host reference implementations (oracles)
# ---------------------------------------------------------------------------

def _u_at_quad(ctx: AssemblyContext, u_full: np.ndarray):
    """values and gradients of a velocity field at the quad points."""
    space = ctx.space
    dim = getattr(ctx, "dim", 2)
    ue = u_full.reshape(-1, dim)[space.p2_dofmap]        # (nc,n,dim)
    uq = np.einsum("qa,eac->eqc", ctx.N2, ue)            # (nc,Q,dim)
    guq = np.einsum("eqad,eac->eqcd", ctx.gphi2, ue)     # dU_c/dx_d
    return ue, uq, guq


def convection_vector_host(ctx, u1_full, u2_full=None):
    """``int ((u2.grad)u1) . phi dx`` over the full dof set; numpy oracle."""
    space = ctx.space
    if u2_full is None:
        u2_full = u1_full
    _, u1q, gu1q = _u_at_quad(ctx, np.asarray(u1_full))
    _, u2q, _ = _u_at_quad(ctx, np.asarray(u2_full))
    conv = np.einsum("eqd,eqcd->eqc", u2q, gu1q)
    fe = np.einsum("eq,qa,eqc->eac", ctx.wdet, ctx.N2, conv)
    out = np.zeros(space.nv_full)
    np.add.at(out, space.vdofs_of_cells().ravel(), fe.ravel())
    return out.reshape(-1, 1)


def convection_matrices_host(ctx, u0_full):
    """N1, N2 (scipy CSR over full dofs) and ``fv = N(u0)u0``; numpy oracle."""
    space = ctx.space
    _, u0q, gu0q = _u_at_quad(ctx, np.asarray(u0_full))

    # N1[(a,i),(b,j)] = delta_ij int (u0 . grad phi_b) phi_a
    u0gradb = np.einsum("eqd,eqbd->eqb", u0q, ctx.gphi2)
    n1e = np.einsum("eq,qa,eqb->eab", ctx.wdet, ctx.N2, u0gradb)
    nc, nvpc = n1e.shape[0], n1e.shape[1]
    dim = getattr(ctx, "dim", 2)
    N1vec = np.zeros((nc, nvpc, dim, nvpc, dim))
    for c in range(dim):
        N1vec[:, :, c, :, c] = n1e

    # N2[(a,i),(b,j)] = int phi_b dU0_i/dx_j phi_a
    N2vec = np.einsum("eq,qa,qb,eqij->eaibj", ctx.wdet, ctx.N2, ctx.N2, gu0q)

    from .assemble import _vec_coo

    fv = convection_vector_host(ctx, u0_full)
    return _vec_coo(space, N1vec), _vec_coo(space, N2vec), fv


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def reference_weight_matrices(ctx):
    """Constant weight matrices of the element pipelines, from the
    reference-element tables (``nd = dim*nvpc``):

    * ``W1 (nd, dim*Q)``: element dofs ``ue(a,c)`` -> values at quad
      points ``(q,c)``,
    * ``W2 (nd, dim*dim*Q)``: ``ue(a,c)`` -> reference-gradient components
      ``(q,k,c)``,
    * ``W3 (dim*Q, nd)``: weighted quad values ``(q,c)`` -> element load
      ``(a,c)``.
    """
    return weight_matrices(np.asarray(ctx.N2), np.asarray(ctx.dN2))


class ConvectionKernel:
    """Static-shape device pipelines bound to one FEM space.

    Holds the element tables (:class:`..ops.kernels.ConvTables`) on
    ``device``; ``dtype`` is the arithmetic type of the pipeline.  The
    element pipeline itself — gather, quadrature, reduction into the dof
    vector — is :func:`..ops.kernels.conv_vector` /
    :func:`..ops.kernels.conv_vector_amatvec`: the hand-written CUDA
    kernel on the card, its plain PyTorch version on the CPU.
    """

    def __init__(self, ctx: AssemblyContext, dtype=None, device=None):
        device = resolve_device(device)
        space = ctx.space
        dtype = dtype or torch.float64
        self.device = device
        self.nv_full = space.nv_full
        Q, nvpc = ctx.N2.shape
        dim = getattr(ctx, "dim", 2)
        self.dim = dim
        self.Q = Q
        self.nvpc = nvpc
        self.nc = ctx.wdet.shape[0]
        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        # vd: (nc,nd) full velocity-dof ids; slot nv_full is a dropped
        # extra segment (re-indexed layouts may point there)
        self.tables = ConvTables(
            N2=dev(ctx.N2), dN2=dev(ctx.dN2),
            JinvT=dev(ctx.JinvT),                            # (nc,d,k)
            wdet=dev(ctx.wdet),                              # (nc,Q)
            vd=dev(space.vdofs_of_cells().reshape(-1, dim * nvpc),
                   torch.int64),
            nv_full=space.nv_full, nc=self.nc, Q=Q, nvpc=nvpc, dim=dim)

    @property
    def wdet(self):
        return self.tables.wdet

    @property
    def vd(self):
        return self.tables.vd

    def with_dof_map(self, dofmap):
        """Clone with the element velocity-dof tables re-indexed.

        ``dofmap (nv_full+1,) int``: old full dof id -> new position (a
        permuted state layout; slot ``nv_full`` stays the dropped
        segment).  Gathers and the reduction then read/write the permuted
        state directly — no per-step translation."""
        new = copy.copy(self)
        dofmap = torch.as_tensor(dofmap, dtype=torch.int64,
                                 device=self.device)
        new.tables = self.tables.with_vd(
            dofmap[self.vd.clamp(max=self.nv_full)])
        return new

    def with_element_order(self, eorder):
        """Clone with the elements permuted (``eorder (nc,)``: new row k
        is old row ``eorder[k]``).  Dof ids are unchanged — only the
        per-element tables (geometry, weights, dof lists) move, and the
        tables the kernel keeps for them (the ELL slot table, the launch
        plans) are rebuilt for the new order.  Used by the banded
        convection tail, which needs elements sorted along the RCM state
        order so that its gather/scatter matrices are banded
        (:mod:`.banded_conv`)."""
        new = copy.copy(self)
        new.tables = self.tables.with_element_order(eorder)
        return new

    def vector(self, u1_full, u2_full=None):
        """Device ``N(u1)u2``-style vector: ``int ((u2.grad)u1).phi dx``."""
        return conv_vector(u1_full, u2_full, self.tables)

    def vector_and_amatvec(self, u_full, nu, sym=True,
                           fac_elem=None, fac_vdofs=None):
        """Fused ``(N(u)u, A u)`` over the FULL dof vector in ONE element
        pipeline: the convection quadrature already interpolates the
        gradients the stiffness needs, so both share the gather and the
        reduction.  ``fac_elem/fac_vdofs``: optional facet-correction
        blocks (outflow terms folded into A) and the
        :class:`..ops.kernels.DofTable` of their full-dof ids.

        Returns ``(conv (nv_full,), av (nv_full,))``.
        """
        return conv_vector_amatvec(u_full, nu, sym, self.tables,
                                   fac_elem=fac_elem, fac_vdofs=fac_vdofs)

    def element_matrices(self, u0_full, picard_only=False):
        """Per-element linearized convection blocks ``(nc, nvpc, dim, nvpc,
        dim)`` in ``u0_full``'s type: ``N1 + N2`` by default (Newton),
        ``N1`` only for Picard (stokes_navier_utils.py:114-118).  Plain
        torch einsums on every device (they run once per linearization)."""
        t = self.tables
        uq, guq = _fields_at_quad(t, u0_full)
        gphi = torch.einsum("edk,qak->eqad", t.JinvT, t.dN2)
        u0gradb = torch.einsum("eqd,eqbd->eqb", uq, gphi)
        n1e = torch.einsum("eq,qa,eqb->eab", t.wdet, t.N2, u0gradb)
        eye = torch.eye(self.dim, dtype=n1e.dtype, device=n1e.device)
        out = torch.einsum("eab,ij->eaibj", n1e, eye)
        if not picard_only:
            out = out + torch.einsum("eq,qa,qb,eqij->eaibj", t.wdet, t.N2,
                                     t.N2, guq)
        return out.to(u0_full.dtype)
