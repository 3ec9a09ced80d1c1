"""Monolithic controller-in-the-loop augmentation.

Twin of ``nse_include_lnrcntrllr`` (time_int_utils.py:492-563): block-
extend (M, A, J) with an LTI observer/controller

    M v' + A v + N(v)v + J^T p = B u + f,   u = hC x
    x' = hA x + hB C v

so the linear-implicit integrators treat the coupled system
monolithically:

    Aext = [[A, -B hC], [-hB C, -hA]],  Mext = blkdiag(M, hM).

Returns an :class:`ExtendedProblem` that quacks like an
:class:`~..models.problem.NSEProblem` for the semi-explicit integrators.
It has no element tables (``affine_ops`` is None), so the integrators
apply its M and A as sparse matrices.
"""

import numpy as np
import scipy.sparse as sps
import torch


class ExtendedConvKernel:
    """Convection kernel on the velocity block of an extended state;
    zero on the controller states."""

    def __init__(self, base=None, nv_full=None, hNV=None):
        self.base = base
        self.nv_full = nv_full
        self.hNV = hNV

    def vector(self, v_ext, u2_ext=None):
        v = v_ext[: self.nv_full]
        u2 = None if u2_ext is None else u2_ext[: self.nv_full]
        conv = self.base.vector(v, u2)
        return torch.cat([conv, conv.new_zeros(self.hNV)])


class ExtendedProblem:
    """NSEProblem-compatible bundle over the state [v_inner; hx]."""

    def __init__(self, prob, hM=None, hA=None, hB=None, hC=None,
                 B=None, C=None, hiniv=None, hf_tdp=None):
        hNV = hA.shape[0]
        self.base = prob
        self.hNV = hNV
        BhC = sps.csr_matrix(sps.csr_matrix(B) @ np.asarray(hC))
        hBC = sps.csr_matrix(np.asarray(hB) @ sps.csr_matrix(C))
        self.Ac = sps.vstack([
            sps.hstack([sps.csr_matrix(prob.Ac), -BhC]),
            sps.hstack([-hBC, sps.csr_matrix(-np.asarray(hA))]),
        ]).tocsr()
        hMm = sps.eye(hNV) if hM is None else sps.csr_matrix(hM)
        self.Mc = sps.block_diag(
            [sps.csr_matrix(prob.Mc), hMm]).tocsr()
        self.Jc = sps.hstack(
            [sps.csr_matrix(prob.Jc), sps.csr_matrix((prob.np_cond, hNV))]
        ).tocsr()
        self.JTc = sps.csr_matrix(self.Jc.T)
        self.fv = np.concatenate(
            [np.asarray(prob.fv).ravel(), np.zeros(hNV)]).reshape(-1, 1)
        self.fp = prob.fp
        self.np_cond = prob.np_cond
        self.nv_full = prob.nv_full + hNV
        self.invinds = np.concatenate(
            [prob.invinds, prob.nv_full + np.arange(hNV)])
        self.hiniv = np.zeros(hNV) if hiniv is None else np.asarray(hiniv)
        self.hf_tdp = hf_tdp
        self.geo = prob.geo
        self.full = prob.full
        self.device = prob.device
        self._kerns = {}
        self._bcv = np.concatenate([prob.bc_full_vec(), np.zeros(hNV)])

    def conv_kernel_on(self, dtype=None, device=None):
        """The base problem's convection kernel, extended by zeros."""
        key = (str(dtype), str(device))
        if key not in self._kerns:
            self._kerns[key] = ExtendedConvKernel(
                self.base.conv_kernel_on(dtype, device),
                self.base.nv_full, self.hNV)
        return self._kerns[key]

    @property
    def conv_kernel(self):
        return self.conv_kernel_on(torch.float64)

    def affine_ops(self, dtype=None, device=None):
        """None: the extended operators have no element form."""
        return None

    def bc_full_vec(self):
        return self._bcv

    def extend_state(self, v_inner, hx=None):
        hx = self.hiniv if hx is None else np.asarray(hx)
        return np.concatenate([np.asarray(v_inner).ravel(), hx.ravel()])

    def split_state(self, vext):
        nin = len(self.base.invinds)
        vext = (vext.detach().cpu().numpy() if torch.is_tensor(vext)
                else np.asarray(vext)).ravel()
        return vext[:nin], vext[nin:]


def nse_include_lnrcntrllr(prob=None, hM=None, hA=None, hB=None, hC=None,
                           B=None, C=None, hiniv=None, hf_tdp=None, **kw):
    """Build the extended problem; use with the semi-explicit
    integrators: ``cnab(prob=ext, inivel=ext.extend_state(v0), ...)``."""
    return ExtendedProblem(prob, hM=hM, hA=hA, hB=hB, hC=hC, B=B, C=C,
                           hiniv=hiniv, hf_tdp=hf_tdp)
