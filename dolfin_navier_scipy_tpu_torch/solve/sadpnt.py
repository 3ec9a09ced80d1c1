"""Saddle-point solvers: the replacement for the reference's external
``sadptprj_riclyap_adi.lin_alg_utils`` ("lau") package.

Solves

    [[A, J^T], [J, 0]] [v; q] = [rhs_v; rhs_p]

Backends of this slice (reusable across time steps — the property that
makes the reference's CNAB loop fast, time_int_utils.py:89-91):

* :class:`InverseSaddleSolver` — explicit dense inverse, applied by the
  hand-written kernel :func:`..ops.kernels.vecmat`; optional residual
  refinement on the sparse/element operators.
* ``host`` — scipy SuperLU (:func:`host_saddle_factorized`), the
  correctness oracle and the one-off setup solver.

The LU, Sherman-Morrison-Woodbury and banded block-Schur solvers of the
JAX package are not ported yet.

Sign convention: the raw saddle solution ``q`` relates to the physical
pressure as ``p = -q`` (the reference flips it too:
stokes_navier_utils.py:403).  These low-level routines return the *raw*
``[v; q]``; high-level solvers flip.
"""

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spsla
import torch

from ..device import resolve_device
from ..ops.kernels import vecmat
from ..ops.sparse import ell_from_scipy_fast


def _to_dense(mat):
    if sps.issparse(mat):
        return np.asarray(mat.todense())
    return np.asarray(mat)


class InverseSaddleSolver:
    """Reusable saddle solver: explicit dense inverse plus iterative
    refinement with *sparse* residuals.

    * setup (one-time): form ``K = [[A, J^T],[J, 0]]`` densely and invert
      it in f64 — ``inv_method="host"`` with ``numpy.linalg.inv``,
      ``"device"`` with ``torch.linalg.inv`` on ``device`` (``"auto"``:
      the device when it is a CUDA card).  The inverse is stored
      TRANSPOSED and contiguous in ``inv_dtype`` (``KinvT``): the layout
      the apply kernel streams.
    * per solve: ``x0 = Kinv @ rhs`` — one :func:`vecmat` launch — then
      ``refine`` rounds of ``x += Kinv @ (rhs - K x)`` with the residual
      computed from the sparse/element operators, recovering accuracy
      beyond ``inv_dtype``.
    """

    def __init__(self, amat=None, jmat=None, jmatT=None, refine=None,
                 inv_dtype=None, dtype=None, res_ops=None,
                 inv_method="auto", device=None, _KinvT=None):
        device = resolve_device(device)
        self.device = device
        # optional element-level (Kop, Jop) pair for the refinement residual
        self.res_ops = res_ops
        dtype = dtype or torch.float64
        nv, npp = amat.shape[0], jmat.shape[0]
        self.nv, self.np = nv, npp
        jT = jmat.T if jmatT is None else jmatT
        n_all = nv + npp
        if inv_dtype is None:
            inv_dtype = torch.float32 if device.type == "cuda" else dtype
        self.inv_dtype = inv_dtype

        if _KinvT is not None:
            # a ready inverse (utils.convert.inverse_solver_from_numpy)
            KinvT = torch.as_tensor(_KinvT)
        else:
            if inv_method == "auto":
                inv_method = "device" if device.type == "cuda" else "host"
            K = np.zeros((n_all, n_all))
            K[:nv, :nv] = _to_dense(amat)
            K[:nv, nv:] = _to_dense(jT)
            K[nv:, :nv] = _to_dense(jmat)
            if inv_method == "device":
                # a one-off O(n^3) setup outside any hand-written kernel:
                # the library's f64 LU inverse on the device is right here
                Kd = torch.as_tensor(K, device=device)
                KinvT = torch.linalg.inv(Kd).T
                del Kd
            elif inv_method == "host":
                KinvT = torch.from_numpy(np.linalg.inv(K).T)
            else:
                raise ValueError(f"inv_method {inv_method!r}")
        assert KinvT.shape == (n_all, n_all), KinvT.shape
        # cast before the transfer/copy: never stage a second f64 copy
        self.KinvT = KinvT.to(inv_dtype).to(device).contiguous()
        if refine is None:
            refine = 3 if inv_dtype == torch.float32 else 0
        self.refine = refine
        self.dtype = dtype
        # sparse twins, for residual refinement and matrix-free callers
        self.A_ell = ell_from_scipy_fast(amat, dtype=dtype, device=device)
        self.J_ell = ell_from_scipy_fast(jmat, dtype=dtype, device=device)
        self.JT_ell = ell_from_scipy_fast(jT, dtype=dtype, device=device)

    @property
    def Kinv(self):
        """The inverse as a (non-contiguous) view of the stored transpose."""
        return self.KinvT.T

    def _apply_inv(self, r):
        """``Kinv @ r`` in ``inv_dtype`` — on the card always the kernel."""
        return vecmat(r.to(self.inv_dtype), self.KinvT)

    def _K_matvec(self, x):
        v, q = x[: self.nv], x[self.nv:]
        if self.res_ops is not None:
            Kop, Jop = self.res_ops
            rv = Kop.matvec(v) + Jop.rmatvec(q)
            rp = Jop.matvec(v)
        else:
            rv = self.A_ell.matvec(v) + self.JT_ell.matvec(q)
            rp = self.J_ell.matvec(v)
        return torch.cat([rv, rp])

    def solve(self, rhsv, rhsp):
        """Stacked raw solution ``[v; q] (nv+np,)`` in ``dtype``."""
        rhs = torch.cat([rhsv.reshape(-1), rhsp.reshape(-1)])
        x = self._apply_inv(rhs).to(self.dtype)
        for _ in range(self.refine):
            r = rhs - self._K_matvec(x)
            x = x + self._apply_inv(r).to(self.dtype)
        return x


# ---------------------------------------------------------------------------
# host oracle / baseline
# ---------------------------------------------------------------------------

def host_saddle_factorized(amat, jmat, jmatT=None):
    """scipy ``splu``-backed reusable solver (baseline twin of the
    reference's ``spsla.factorized`` pattern, time_int_utils.py:89-91)."""
    npp = jmat.shape[0]
    jT = jmat.T if jmatT is None else jmatT
    K = sps.vstack([
        sps.hstack([sps.csc_matrix(amat), sps.csc_matrix(jT)]),
        sps.hstack([sps.csc_matrix(jmat), sps.csc_matrix((npp, npp))]),
    ]).tocsc()
    lu = spsla.splu(K)

    def solve(rhsv, rhsp=None):
        if rhsp is None:
            rhsp = np.zeros((npp,))
        rhs = np.concatenate([np.asarray(rhsv).ravel(),
                              np.asarray(rhsp).ravel()])
        return lu.solve(rhs).reshape(-1, 1)

    return solve


def solve_sadpnt_host(amat=None, jmat=None, jmatT=None, rhsv=None, rhsp=None,
                      umat=None, vmat=None):
    """One-shot host solve; returns the stacked raw ``(nv+np, 1)``."""
    if umat is not None or vmat is not None:
        raise NotImplementedError(
            "low-rank (Sherman-Morrison-Woodbury) updates belong to the "
            "control slice of the port and are not ported yet")
    return host_saddle_factorized(amat, jmat, jmatT)(rhsv, rhsp)
