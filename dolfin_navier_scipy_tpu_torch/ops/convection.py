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
    Q, nvpc = ctx.N2.shape
    dim = getattr(ctx, "dim", 2)
    nd = dim * nvpc
    W1 = np.zeros((nd, dim * Q))
    W2 = np.zeros((nd, dim * dim * Q))
    W3 = np.zeros((dim * Q, nd))
    for q in range(Q):
        for a in range(nvpc):
            for c in range(dim):
                W1[dim * a + c, dim * q + c] = ctx.N2[q, a]
                W3[dim * q + c, dim * a + c] = ctx.N2[q, a]
                for k in range(dim):
                    W2[dim * a + c,
                       dim * dim * q + dim * k + c] = ctx.dN2[q, a, k]
    return W1, W2, W3


class ConvectionKernel:
    """Static-shape device pipelines bound to one FEM space.

    The per-quad-point interpolation/gradient contractions are cast as
    two large matmuls with *constant* weight matrices (built from the
    reference-element tables) around one gather and one scatter-add, with
    small per-element geometry contractions in between.  Plain tensors on
    ``device``; ``dtype`` is the arithmetic type of the pipeline.
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
        nd = dim * nvpc
        self.Q = Q
        self.nvpc = nvpc
        self.nc = ctx.wdet.shape[0]
        W1, W2, W3 = reference_weight_matrices(ctx)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        self.W1 = dev(W1)
        self.W2 = dev(W2)
        self.W2T = dev(W2.T)
        self.W3 = dev(W3)
        self.JinvT = dev(ctx.JinvT)                          # (nc,d,k)
        self.wdet = dev(ctx.wdet)                            # (nc,Q)
        # (nc,nd) full velocity-dof ids; slot nv_full of the scatter buffer
        # is a dropped extra segment (re-indexed layouts may point there)
        self.vd = dev(space.vdofs_of_cells().reshape(-1, nd), torch.int64)
        self.vdofs_flat = self.vd.reshape(-1)

    def with_dof_map(self, dofmap):
        """Clone with the element velocity-dof tables re-indexed.

        ``dofmap (nv_full+1,) int``: old full dof id -> new position (a
        permuted state layout; slot ``nv_full`` stays the dropped
        segment).  Gathers and the scatter then read/write the permuted
        state directly — no per-step translation."""
        new = copy.copy(self)
        dofmap = torch.as_tensor(dofmap, dtype=torch.int64,
                                 device=self.device)
        new.vd = dofmap[self.vd.clamp(max=self.nv_full)]
        new.vdofs_flat = new.vd.reshape(-1)
        return new

    def _fields_at_quad(self, u_full, grads=True):
        """-> ``(ue (nc,nd), uq (nc,Q,2), guq (nc,Q,2,2) or None)``."""
        Q, dim = self.Q, self.dim
        dt = self.wdet.dtype
        upad = torch.cat([u_full.to(dt), u_full.new_zeros(1, dtype=dt)])
        ue = upad[self.vd]                                   # (nc,nd)
        uq = (ue @ self.W1).reshape(self.nc, Q, dim)
        if not grads:
            return ue, uq, None
        rg = (ue @ self.W2).reshape(self.nc, Q, dim, dim)
        guq = torch.einsum("edk,eqkc->eqcd", self.JinvT, rg)
        return ue, uq, guq

    def _scatter(self, vals, ids, nseg):
        """Scatter-add ``vals`` into ``nseg`` segments (``index_add_``; on
        the card the adds are atomic, so the summation order — not the
        set of summands — varies from run to run)."""
        out = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, ids, vals)

    def vector(self, u1_full, u2_full=None):
        """Device ``N(u1)u2``-style vector: ``int ((u2.grad)u1).phi dx``."""
        _, u1q, gu1q = self._fields_at_quad(u1_full)
        if u2_full is None:
            u2q = u1q
        else:
            _, u2q, _ = self._fields_at_quad(u2_full, grads=False)
        conv = torch.einsum("eqd,eqcd->eqc", u2q, gu1q)
        wconv = (self.wdet[:, :, None]
                 * conv).reshape(self.nc, self.dim * self.Q)
        fe = wconv @ self.W3
        out = self._scatter(fe.reshape(-1), self.vdofs_flat,
                            self.nv_full + 1)
        return out[: self.nv_full].to(u1_full.dtype)

    def vector_and_amatvec(self, u_full, nu, sym=True,
                           fac_elem=None, fac_vdofs=None):
        """Fused ``(N(u)u, A u)`` over the FULL dof vector in ONE element
        pipeline: the convection quadrature already interpolates the
        gradients the stiffness needs, so both share the gather and one
        stacked scatter.  ``fac_elem/fac_vdofs``: optional
        facet-correction blocks (outflow terms folded into A, full-dof
        ids).

        Returns ``(conv (nv_full,), av (nv_full,))``.
        """
        dt = self.wdet.dtype
        _, uq, guq = self._fields_at_quad(u_full)
        # convection load
        conv = torch.einsum("eqd,eqcd->eqc", uq, guq)
        wconv = (self.wdet[:, :, None]
                 * conv).reshape(self.nc, self.dim * self.Q)
        fe_c = wconv @ self.W3
        # stiffness load: F = nu (grad u (+ grad u^T)), pulled back
        F = guq + guq.transpose(2, 3) if sym else guq
        G = torch.einsum("edk,eqcd->eqkc", self.JinvT, F)
        G = (float(nu) * self.wdet[:, :, None, None]
             * G).reshape(self.nc, self.dim * self.dim * self.Q)
        fe_a = G @ self.W2T

        off = self.nv_full + 1
        vals = [fe_c.reshape(-1), fe_a.reshape(-1)]
        ids = [self.vdofs_flat,
               self.vdofs_flat.clamp(max=self.nv_full) + off]
        if fac_elem is not None and fac_elem.shape[0]:
            xfe = torch.cat(
                [u_full.to(dt), u_full.new_zeros(1, dtype=dt)])[fac_vdofs]
            ffe = torch.einsum("fab,fb->fa", fac_elem.to(dt), xfe)
            vals.append(ffe.reshape(-1))
            ids.append(fac_vdofs.reshape(-1).clamp(max=self.nv_full) + off)
        out = self._scatter(torch.cat(vals), torch.cat(ids), 2 * off)
        return (out[: self.nv_full].to(u_full.dtype),
                out[off: off + self.nv_full].to(u_full.dtype))

    def element_matrices(self, u0_full, picard_only=False):
        raise NotImplementedError(
            "ConvectionKernel.element_matrices belongs to the steady/Newton "
            "slice of the port and is not ported yet")
