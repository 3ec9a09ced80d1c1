"""Saddle-point solvers: the replacement for the reference's external
``sadptprj_riclyap_adi.lin_alg_utils`` ("lau") package.

Solves

    [[A, J^T], [J, 0]] [v; q] = [rhs_v; rhs_p]

Backends (reusable across time steps — the property that makes the
reference's CNAB loop fast, time_int_utils.py:89-91):

* :class:`InverseSaddleSolver` — explicit dense inverse, applied by the
  hand-written kernel :func:`..ops.kernels.vecmat`; optional residual
  refinement on the sparse/element operators.
* :class:`SchurSaddleSolver` — the banded block-Schur solver: RCM-banded
  ``F``, static-window ``J``/``J^T``, banded ``X = F^-1 J^T`` (from a host
  ``splu`` or, ``setup="device"``, by block PCG on the device), dense
  ``S^-1`` and the truncated inverse ``W ~ F^-1``; every per-step
  application is one of the hand-written kernels
  :func:`..ops.kernels.banded_mv`, :func:`..ops.kernels.rect_mv`,
  :func:`..ops.kernels.rect_mv_levels`.
* :class:`SMWSolver` — Sherman-Morrison-Woodbury wrap of any of them for
  static low-rank feedback updates.
* :class:`SaddleSolver` — dense LU on the device; small systems and
  one-shot solves (:func:`solve_sadpnt`).
* ``host`` — scipy SuperLU (:func:`host_saddle_factorized`), the
  correctness oracle and the one-off setup solver.

Not ported yet (raise ``NotImplementedError``): the non-banded
(element-operator) Schur path and the Krylov solver.

Sign convention: the raw saddle solution ``q`` relates to the physical
pressure as ``p = -q`` (the reference flips it too:
stokes_navier_utils.py:403).  These low-level routines return the *raw*
``[v; q]``; high-level solvers flip.
"""

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spsla
import torch

from ..device import resolve_device, timer
from ..ops.kernels import (
    as_band_operand, as_vecmat_operand, band_operand, banded_mv, pair_stack,
    rect_mv, rect_mv_levels, vecmat)
from ..ops.sparse import ell_from_scipy_fast


def _to_dense(mat):
    if sps.issparse(mat):
        return np.asarray(mat.todense())
    return np.asarray(mat)


def _fused_residual(res_ops):
    """The 'ma' view of ``res_ops = (Kop, Jop)`` when the two are the
    'ma' and 'j' views of one :class:`..ops.affine.AffineVectorOps` (the
    residual then takes one call), else None."""
    if res_ops is None:
        return None
    Kop, Jop = res_ops
    if (getattr(Kop, "kind", None) == "ma" and getattr(Jop, "kind", None)
            == "j" and getattr(Kop, "aff", None) is not None
            and Kop.aff is getattr(Jop, "aff", None)):
        return Kop
    return None


class InverseSaddleSolver:
    """Reusable saddle solver: explicit dense inverse plus iterative
    refinement with *sparse* residuals.

    * setup (one-time): form ``K = [[A, J^T],[J, 0]]`` densely and invert
      it in f64 — ``inv_method="host"`` with ``numpy.linalg.inv``,
      ``"device"`` with ``torch.linalg.inv`` on ``device`` (``"auto"``:
      the device when it is a CUDA card).  The inverse is stored
      TRANSPOSED in ``inv_dtype`` (``KinvT``), rows 16-byte aligned
      (:func:`..ops.kernels.vecmat_operand`): the layout the apply kernel
      streams.
    * per solve: ``x0 = Kinv @ rhs`` — one :func:`vecmat` launch — then
      ``refine`` rounds of ``x += Kinv @ (rhs - K x)`` with the residual
      computed from the sparse/element operators, recovering accuracy
      beyond ``inv_dtype``.  When ``res_ops`` are the 'ma' and 'j' views
      of one :class:`..ops.affine.AffineVectorOps`, ``K x`` is one call of
      its :meth:`saddle_residual` (one kernel launch for ``K v``, ``J^T
      q`` and ``J v``; the same function).
    """

    def __init__(self, amat=None, jmat=None, jmatT=None, refine=None,
                 inv_dtype=None, dtype=None, res_ops=None,
                 inv_method="auto", device=None, _KinvT=None):
        device = resolve_device(device)
        self.device = device
        # optional element-level (Kop, Jop) pair for the refinement residual
        self.res_ops = res_ops
        self._res_fused = _fused_residual(res_ops)
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
        # cast before a transfer (never stage a second f64 copy), then one
        # copy into storage whose rows the kernel's bulk copies can stream
        if KinvT.device != device:
            KinvT = KinvT.to(inv_dtype)
        self.KinvT = as_vecmat_operand(KinvT, inv_dtype, device)
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
        if self._res_fused is not None:
            Kop = self._res_fused
            return Kop.aff.saddle_residual(v, q, Kop.cm, Kop.ca)
        if self.res_ops is not None:
            Kop, Jop = self.res_ops
            rv = Kop.matvec(v) + Jop.rmatvec(q)
            rp = Jop.matvec(v)
        else:
            rv = self.A_ell.matvec(v) + self.JT_ell.matvec(q)
            rp = self.J_ell.matvec(v)
        return torch.cat([rv, rp])

    def solve(self, rhsv, rhsp, refine=None):
        """Stacked raw solution ``[v; q] (nv+np,)`` in ``dtype``, with
        ``refine`` residual rounds (default: the solver's ``refine``)."""
        rhs = torch.cat([rhsv.reshape(-1), rhsp.reshape(-1)])
        x = self._apply_inv(rhs).to(self.dtype)
        for _ in range(self.refine if refine is None else refine):
            r = rhs - self._K_matvec(x)
            x = x + self._apply_inv(r).to(self.dtype)
        return x


# ---------------------------------------------------------------------------
# the banded block-Schur solver
# ---------------------------------------------------------------------------

def jacobi_pcg(fmv, dinv, b, niter, x0=None):
    """Jacobi-preconditioned CG with a FIXED iteration count (no host
    read-back in the loop: the division guards replace the convergence
    test).  The carry stays in ``b``'s dtype whatever ``fmv`` computes in;
    on the card ``fmv`` is a hand-written matvec (:func:`..ops.kernels.
    banded_mv` in the banded solver)."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0.to(b.dtype)
        r = b - fmv(x).to(b.dtype)
    z = (dinv * r).to(b.dtype)
    p = z
    rz = r @ z
    for _ in range(niter):
        Ap = fmv(p).to(b.dtype)
        pAp = p @ Ap
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = (dinv * r).to(b.dtype)
        rz_n = r @ z
        beta = rz_n / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_n
    return x


def _build_banded(F, lane=128):
    """RCM-banded dense-block form of a sparse matrix (host, one-time).

    Returns ``(blocks (nblk, bs, 3bs) f32, perm, bs, nblk)`` with
    ``F[perm][:, perm]`` contained in the block tridiagonal of block size
    ``bs >= bandwidth``, rounded up to ``lane``.  The matvec then needs no
    gather: neighbours are contiguous block shifts (:func:`..ops.kernels.
    banded_mv`).  Memory is O(n 3 bs) instead of O(nnz); at 2D FEM
    bandwidths that is tens to hundreds of MB streamed at the memory rate.
    ``lane=128`` keeps the JAX package's blocks (a Hopper choice is a
    measurement still to make)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    Fc = sps.csr_matrix(F)
    n = Fc.shape[0]
    perm = np.asarray(reverse_cuthill_mckee(Fc, symmetric_mode=True))
    Fp = sps.csr_matrix(Fc[perm][:, perm])
    co = Fp.tocoo()
    bw = int(np.abs(co.row - co.col).max()) if co.nnz else 1
    bs = max(lane, int(np.ceil(bw / lane)) * lane)
    nblk = max(1, int(np.ceil(n / bs)))
    return _fold_banded_blocks(Fp, n, bs, nblk), perm, bs, nblk


def _banded_bandwidth_gb(F, lane=128):
    """Estimated band storage (GB) of :func:`_build_banded` without folding
    the blocks — the RCM pass only; gates the banded mode (3D RCM
    bandwidths grow like n^(2/3) and would blow the block-tridiagonal
    storage past device memory)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    Fc = sps.csr_matrix(F)
    n = Fc.shape[0]
    perm = np.asarray(reverse_cuthill_mckee(Fc, symmetric_mode=True))
    Fp = sps.coo_matrix(Fc[perm][:, perm])
    bw = int(np.abs(Fp.row - Fp.col).max()) if Fp.nnz else 1
    bs = max(lane, int(np.ceil(bw / lane)) * lane)
    nblk = max(1, int(np.ceil(n / bs)))
    return nblk * bs * 3 * bs * 4 / 1e9


def _fold_banded_blocks(Fp, n, bs, nblk):
    """Fold an (already permuted) sparse matrix into the block-tridiagonal
    dense layout ``(nblk, bs, 3bs)`` f32 (f32 whatever the work type: the
    f64 work path promotes in the product).  Entries outside the window
    (|row - col| > bs) would be dropped — callers guarantee the
    bandwidth."""
    blocks = np.zeros((nblk, bs, 3 * bs), np.float32)
    for k in range(nblk):
        r0, c0 = k * bs, (k - 1) * bs
        rows = slice(r0, min(r0 + bs, n))
        cols = slice(max(c0, 0), min(c0 + 3 * bs, n))
        sub = np.asarray(Fp[rows, cols].todense(), np.float32)
        blocks[k, : sub.shape[0],
               max(c0, 0) - c0: max(c0, 0) - c0 + sub.shape[1]] = sub
    return blocks


def _build_banded_rect(A, row_order, col_order, bs_r, lane=128):
    """Static-window dense-block form of a RECTANGULAR sparse matrix.

    Under locality-consistent row/column orders, row block ``k`` of
    ``A[row_order][:, col_order]`` touches one contiguous column window:
    store ``blocks (nblk, bs_r, w)`` f32 and each block's window start
    (:func:`..ops.kernels.rect_mv`).  Returns ``(blocks, bases (tuple of
    int), w, ncols_pad)``."""
    Ap = sps.csr_matrix(sps.csr_matrix(A)[row_order][:, col_order])
    nr, ncl = Ap.shape
    nblk = max(1, (nr + bs_r - 1) // bs_r)
    spans = []
    for k in range(nblk):
        sub = Ap[k * bs_r: min((k + 1) * bs_r, nr)].tocoo()
        spans.append((int(sub.col.min()), int(sub.col.max()) + 1)
                     if sub.nnz else (0, 1))
    w = max(hi - lo for lo, hi in spans)
    w = max(lane, int(np.ceil(w / lane)) * lane)
    ncl_pad = max(ncl, w)
    bases = []
    blocks = np.zeros((nblk, bs_r, w), np.float32)
    for k, (lo, hi) in enumerate(spans):
        b = min(max(lo, 0), ncl_pad - w)
        bases.append(int(b))
        sub = np.asarray(
            Ap[k * bs_r: min((k + 1) * bs_r, nr),
               b: min(b + w, ncl)].todense(), np.float32)
        blocks[k, : sub.shape[0], : sub.shape[1]] = sub
    return blocks, tuple(bases), w, ncl_pad


def _tridiag_bmm(blks, P):
    """``F_perm @ P`` for a block of columns ``P (nblk bs, k)``, with
    ``blks (nblk, bs, 3bs)`` F's block-tridiagonal form (no neighbour past
    either end): the three neighbour slices side by side, one
    ``torch.bmm`` over the row blocks."""
    nblk, bs = blks.shape[0], blks.shape[1]
    Pb = P.reshape(nblk, bs, -1)
    zero = Pb.new_zeros((1, *Pb.shape[1:]))
    win = torch.cat([torch.cat([zero, Pb[:-1]]), Pb,
                     torch.cat([Pb[1:], zero])], dim=1)
    return torch.bmm(blks, win).reshape(nblk * bs, -1)


def _block_pcg(fmv, dinv, B, niter):
    """Jacobi-PCG on ``F X = B`` for a block of right-hand sides ``B (n,
    k)``: per-column step sizes, a FIXED count, the 0/0 guards of
    :func:`jacobi_pcg` (an all-zero column stays exactly zero).  ``fmv``
    applies F to an ``(n, k)`` block (:func:`_tridiag_bmm` in the Schur
    setup: one-off work that the JAX package left to XLA, so a library
    product; TF32 is off package-wide)."""
    X = torch.zeros_like(B)
    R = B
    Z = dinv[:, None] * R
    P = Z
    rz = (R * Z).sum(dim=0)
    for _ in range(niter):
        AP = fmv(P)
        pAp = (P * AP).sum(dim=0)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = dinv[:, None] * R
        rz_n = (R * Z).sum(dim=0)
        beta = rz_n / torch.where(rz == 0, 1.0, rz)
        P = Z + beta[None, :] * P
        rz = rz_n
    return X


def _xt_parts_to_banded(parts, bases, bs, nblk, wx, nin, start=0,
                        out=None):
    """Fold row-parts of ``X^T`` (pressure rows ``start ...``, permuted
    velocity columns; a part may be a transposed view of a solved column
    chunk) into the banded layout ``(nblk, bs, wx)`` at the windows
    ``bases``: static slices, each entry written once (copies, no
    accumulation: the result does not depend on the order).  ``out``
    (:func:`..ops.kernels.band_operand` storage, f32, zero where nothing
    lands) is made on the first part's device when not given."""
    if out is None:
        out = band_operand((nblk, bs, wx), torch.float32, parts[0].device)
    lo = start
    for p in parts:
        hi = lo + int(p.shape[0])
        for kb in range(nblk):
            b = bases[kb]
            s, e = max(b, lo), min(b + wx, hi)
            r0, ce = kb * bs, min(kb * bs + bs, nin)
            if s >= e or r0 >= ce:
                continue
            out[kb, : ce - r0, s - b: e - b] = p[s - lo: e - lo, r0: ce].T
        lo = hi
    return out


def _build_x_banded(Bblk, dinv_perm, jTp, xbases, wx, niter, chunk=256):
    """``X = F^{-1} J^T`` built on ``Bblk``'s device, straight into its
    banded form: column chunks of ``jTp`` (``J^T`` with RCM rows and
    pressure columns in ``pp`` order, scipy) are uploaded as triplets,
    solved by :func:`_block_pcg` over the banded F in f32, and folded into
    X's windows as soon as they are solved (no dense ``X``: 5.2 GB at
    level 3).  Returns ``(Xb (nblk, bs, wx) f32, f64 sum of squares of the
    solved X)`` — the latter for the truncation check."""
    dev = Bblk.device
    nblk, bs = Bblk.shape[0], Bblk.shape[1]
    nin, npp = jTp.shape
    dpad = torch.zeros(nblk * bs, dtype=torch.float32, device=dev)
    dpad[:nin] = torch.as_tensor(np.asarray(dinv_perm, np.float32),
                                 device=dev)
    co = sps.csc_matrix(jTp).tocoo()
    order = np.argsort(co.col, kind="stable")
    rows = torch.as_tensor(co.row[order].astype(np.int64), device=dev)
    cols = torch.as_tensor(co.col[order].astype(np.int64), device=dev)
    vals = torch.as_tensor(co.data[order].astype(np.float32), device=dev)
    bounds = np.searchsorted(co.col[order], np.arange(0, npp + chunk, chunk))
    Xb = band_operand((nblk, bs, wx), torch.float32, dev)
    tot = torch.zeros((), dtype=torch.float64, device=dev)
    for k, c0 in enumerate(range(0, npp, chunk)):
        c1 = min(c0 + chunk, npp)
        s, e = int(bounds[k]), int(bounds[k + 1])
        B = torch.zeros((nblk * bs, c1 - c0), dtype=torch.float32,
                        device=dev)
        # CSC entries are unique: a plain store, no accumulation
        B[rows[s:e], cols[s:e] - c0] = vals[s:e]
        Xc = _block_pcg(lambda P: _tridiag_bmm(Bblk, P), dpad, B, niter)
        tot += Xc.double().square().sum()
        _xt_parts_to_banded((Xc.T,), xbases, bs, nblk, wx, nin, start=c0,
                            out=Xb)
    return Xb, float(tot)


def _build_winv_banded(Bblk, dinv_perm, bs, nblk, nin, wbases, ww, niter):
    """Localized banded build of the truncated inverse ``W ~ F^{-1}``
    (static windows ``wbases``, width ``ww``) on ``Bblk``'s device.

    ``F^{-1}`` decays exponentially off the diagonal, so each ``bs``-column
    identity chunk is solved on a local window of ``ww + 4 bs`` rows by a
    fixed-count Jacobi block-PCG whose operator is the block-tridiagonal
    product of the local blocks (one ``torch.bmm`` per iteration, f32, TF32
    off: a one-off setup product outside any kernel, as the JAX package
    left it to XLA); the couplings leaving the local window are cut
    (Dirichlet truncation, the same order as W's own band cut).  The
    solution is folded into W's window layout; columns outside a row
    block's window are dropped by a mask.  Returns ``W (nblk, bs, ww)``
    f32 in :func:`..ops.kernels.band_operand` storage."""
    dev = Bblk.device
    f32 = torch.float32
    nlocb = min(nblk, (ww + 4 * bs + bs - 1) // bs)
    nloc = nlocb * bs
    dpad = torch.zeros(nblk * bs, dtype=f32, device=dev)
    dpad[:nin] = torch.as_tensor(np.asarray(dinv_perm, np.float32),
                                 device=dev)
    wb = torch.as_tensor(np.asarray(wbases, np.int64), device=dev)
    W = band_operand((nblk, bs, ww), f32, dev)
    ar = torch.arange(bs, device=dev)
    for kc in range(nblk):
        kb0 = min(max(kc - (nlocb - 1) // 2, 0), nblk - nlocb)
        blks = Bblk[kb0:kb0 + nlocb].to(f32).contiguous().clone()
        # the local operator stays a principal submatrix of F (SPD)
        blks[0, :, :bs] = 0.0
        blks[nlocb - 1, :, 2 * bs:] = 0.0
        gcol = kc * bs + ar
        B = torch.zeros((nloc, bs), dtype=f32, device=dev)
        B[(kc - kb0) * bs + ar, ar] = (gcol < nin).to(f32)
        X = _block_pcg(lambda P: _tridiag_bmm(blks, P),
                       dpad[kb0 * bs: kb0 * bs + nloc], B, niter)
        # X[t bs + i, c] = F^-1[(kb0+t) bs + i, kc bs + c] goes to
        # W[kb0+t, i, kc bs + c - wbases[kb0+t]] where that is in [0, ww)
        Xb3 = X.reshape(nlocb, bs, bs)
        for t in range(nlocb):
            j = gcol - wb[kb0 + t]
            keep = (j >= 0) & (j < ww)
            W[kb0 + t][:, j[keep]] += Xb3[t][:, keep]
    return W


def _build_winv_banded_subproc(Bblk_host, dinv_perm, bs, nblk, nin, wbases,
                               ww, niter):
    """The JAX package ran the W build in a throwaway process, around a TPU
    runtime fault; here it is :func:`_build_winv_banded` on the host
    blocks, in this process."""
    return _build_winv_banded(torch.as_tensor(np.asarray(Bblk_host)),
                              dinv_perm, bs, nblk, nin, wbases, ww, niter)


def _cg_count(F, b, tol, Mdiag):
    """Host Jacobi-CG iterations to ``tol`` from a zero start."""
    it = [0]

    def cb(_):
        it[0] += 1

    spsla.cg(F, b, rtol=tol, atol=0.0, maxiter=400, M=Mdiag, callback=cb)
    return it[0]


def _sinv_tri(hi, lo):
    """Three bf16 levels of the f32 hi/lo pair of ``S^-1``: ``s1 = bf16(hi)``,
    ``s2 = bf16((hi - s1) + lo)``, ``s3 = bf16(((hi - s1) - s2) + lo)``."""
    s1 = hi.to(torch.bfloat16)
    r1 = hi - s1.to(torch.float32)
    s2 = (r1 + lo).to(torch.bfloat16)
    r2 = (r1 - s2.to(torch.float32)) + lo
    return s1, s2, r2.to(torch.bfloat16)


def _schur_of_banded(JTb, jtbases, Xb, xbases, npp):
    """``S = J X`` in f64 on the blocks' device, from the operators as the
    solve applies them: ``JTb (nblk, bs, wjt)`` the f32 ``J^T`` blocks at
    ``jtbases`` and ``Xb`` the stored X (``(nblk, bs, wx)`` or its bf16
    levels ``(nblk, L, bs, wx)``, summed in f64 in level order) at
    ``xbases``.  Row block k adds ``JTb[k]^T Xb[k]`` into the tile of S at
    ``(jtbases[k], xbases[k])``, in block order; nothing of size ``nv x
    np`` is formed."""
    nblk, _, wjt = JTb.shape
    wx = Xb.shape[-1]
    npad = max(npp, max(jtbases) + wjt, max(xbases) + wx)
    S = torch.zeros((npad, npad), dtype=torch.float64, device=Xb.device)
    for k in range(nblk):
        xk = Xb[k].double()
        if Xb.dim() == 4:
            xk = xk.sum(0)
        jb, xbk = jtbases[k], xbases[k]
        S[jb: jb + wjt, xbk: xbk + wx] += JTb[k].double().T @ xk
    return S[:npp, :npp]


class SchurSaddleSolver:
    """Block-Schur saddle solver for ``[[F, J^T],[J, 0]]`` with SPD ``F = M
    + theta dt A`` (mass-dominated at CFL-scale dt), banded mode — the JAX
    package's default route above 6000 condensed rows.

    * setup: host probes (the fixed PCG count ``ncg``, X's and W's
      windows, by host CG), the RCM order ``perm`` of ``F`` and the
      pressure order ``pp`` (rows of ``J`` sorted by the mean RCM position
      of their couplings), banded ``F`` (``Bblk``, and ``Eblk`` for
      ``band_extra``), static-window ``J`` / ``J^T`` (``Jb``, ``JTb``),
      then the factors: the banded ``X = F^{-1} J^T`` (``Xb``), ``S = J
      X``, the dense ``S^{-1}`` (f32 hi/lo pair under f32 work) from an
      f64 inverse, and where it pays the truncated inverse ``W ~ F^{-1}``
      (``Wb``) built on the device.  ``setup="host"`` takes X from one
      ``splu(F)``; ``setup="device"`` solves it on the device by a
      fixed-count block PCG over the banded F, 256 pressure columns at a
      time, folded into the band as each chunk is solved ('auto': the
      device on the card at nv > 12000 or np > 1500, np <= 16000 — level
      2 and 3 of the DFG wake).  On the card (``lowbit``) W, X and
      ``S^{-1}`` are stored as 3, 2 and 3 row-stacked bf16 levels
      (:func:`..ops.kernels.pair_stack`).  S is formed from the stored X
      on the device (:func:`_schur_of_banded`) except on the host setup
      in f32 storage, which keeps the JAX package's exact S: then an
      unrefined solve keeps ``J v = g`` to f32 grade.  ``setup`` says which
      setup ran, ``setup_timing`` the seconds of each part.
    * per solve, all in permuted space: ``y = W b`` (or a fixed-count
      :func:`jacobi_pcg` on the banded F), ``q = S^{-1}(J y - g)``, ``v = y
      - X q``, then ``refine`` residual rounds against the exact banded F —
      each application one launch of :func:`..ops.kernels.banded_mv`,
      :func:`..ops.kernels.rect_mv` or :func:`..ops.kernels.rect_mv_levels`.

    Keywords and their defaults are the JAX package's; where that package
    read an environment variable, this one takes a keyword and reads none:
    ``winv`` (None: W when ``nv > 5000`` or the F band is over 120 MB; never
    on the CPU above nv 4000), ``wtol`` (3e-3, W's truncation), ``xband_k``
    (4, X's window floor in blocks), ``banded_maxgb`` (3) and
    ``winv_maxgb`` (4), ``lowbit`` ('auto': on a CUDA device).  The
    cost-model half of the JAX package's banded gate waits for a
    measurement on the card: ``banded="auto"`` takes the banded form
    whenever its band fits ``banded_maxgb``; ``index_nvals`` is accepted
    for it and not read.  A failure anywhere in the device setup raises;
    nothing falls back to the host.

    Not ported (``NotImplementedError``): the non-banded element-operator
    path.
    """

    def __init__(self, coeff=None, jmat=None, jmatT=None, res_ops=None,
                 dtype=None, ncg=None, cg_tol=None, refine=None,
                 full_map=None, setup="auto", banded="auto",
                 band_extra=None, index_nvals=None, winv=None,
                 lowbit="auto", wtol=3e-3, xband_k=4, banded_maxgb=3.0,
                 winv_maxgb=4.0, device=None):
        device = resolve_device(device)
        self.device = device
        lap, self.setup_timing = timer(device)
        dtype = dtype or torch.float32
        self.dtype = dtype
        self.res_ops = res_ops
        F = sps.csc_matrix(coeff)
        J = sps.csr_matrix(jmat)
        jT = sps.csc_matrix(J.T if jmatT is None else jmatT)
        nv, npp = F.shape[0], J.shape[0]
        self.nv, self.np = nv, npp
        on_card = device.type == "cuda"

        dv = F.diagonal()
        Mdiag = sps.diags(1.0 / dv)
        if ncg is None:
            # host Jacobi-PCG iterations to the work-precision tolerance,
            # counted once and frozen (the loop's fixed count)
            if cg_tol is None:
                cg_tol = 1e-7 if dtype == torch.float32 else 1e-13
            b = np.random.default_rng(0).standard_normal(nv)
            ncg = _cg_count(F, b, cg_tol, Mdiag) + 3
        self.ncg = int(ncg)

        if setup == "auto":
            # the JAX package's rule; its npp ceiling is a TPU LU limit,
            # still to re-derive on the card (ROADMAP F3)
            setup = ("device" if on_card and npp <= 16000
                     and (nv > 12000 or npp > 1500) else "host")
        if setup not in ("host", "device"):
            raise ValueError(f"setup {setup!r}")
        self.setup = setup
        if banded == "auto":
            banded = _banded_bandwidth_gb(F) <= banded_maxgb
        if not banded:
            raise NotImplementedError(
                "SchurSaddleSolver: the non-banded (element-operator) "
                "block-Schur path is not ported yet (ROADMAP A11); the "
                "banded form needs its F band within "
                f"banded_maxgb={banded_maxgb}")
        lap("probes_s")

        # ---- banded forms, all in RCM-permuted velocity / pp pressure order
        blocks, perm, bs, nblk = _build_banded(F)
        pf = perm if full_map is None else np.asarray(full_map[0])[perm]
        self.Bblk = as_band_operand(blocks, device=device)
        self.Eblk = None
        if band_extra is not None:
            # the explicit operator of the conv/A split, in F's window (F =
            # M + theta dt band_extra guarantees the sparsity)
            Ep = sps.csr_matrix(sps.csr_matrix(band_extra)[perm][:, perm])
            eco = Ep.tocoo()
            if eco.nnz and int(np.abs(eco.row - eco.col).max()) > bs:
                raise ValueError("band_extra exceeds F's band window")
            self.Eblk = as_band_operand(
                _fold_banded_blocks(Ep, nv, bs, nblk), device=device)
        self.permf = torch.as_tensor(np.asarray(pf, np.int64), device=device)
        self.dinv_b = torch.as_tensor((1.0 / dv)[perm]).to(device=device,
                                                           dtype=dtype)
        self._bs, self._nblk, self._nin = int(bs), int(nblk), nv
        ipos = np.empty(nv, np.int64)
        ipos[perm] = np.arange(nv)
        Jcsr = sps.csr_matrix(J)
        mpos = np.zeros(npp)
        for i in range(npp):
            s0, e0 = Jcsr.indptr[i], Jcsr.indptr[i + 1]
            if e0 > s0:
                mpos[i] = ipos[Jcsr.indices[s0:e0]].mean()
        pp = np.argsort(mpos, kind="stable")
        self.pidx = torch.as_tensor(pp.astype(np.int64), device=device)

        def bases_t(bases):
            return torch.as_tensor(np.asarray(bases, np.int32),
                                   device=device)

        bsp = 128
        jb, jbases, wj, njpad = _build_banded_rect(J, pp, perm, bsp)
        self.Jb = as_band_operand(jb, device=device)
        self._bsp, self._nblkp = bsp, int(jb.shape[0])
        self._wj, self._jbases, self._ncolpad_j = int(wj), jbases, int(njpad)
        jtb, jtbases, wjt, njtpad = _build_banded_rect(jT, perm, pp, bs)
        self.JTb = as_band_operand(jtb, device=device)
        self._wjt, self._jtbases, self._ncolpad_jt = (
            int(wjt), jtbases, int(njtpad))
        lap("banded_s")

        # banded X: F^{-1} decays exponentially off the diagonal, so X = F^-1
        # J^T is banded to the f32 floor within a few F bandwidths; the
        # window is measured by probing a few exact columns with host CG
        # (the JAX package's calls, in its order: the windows must match)
        ncols_probe = min(8, npp)
        pcols = np.unique(np.linspace(0, npp - 1, ncols_probe).astype(int))
        jTc = sps.csc_matrix(jT)
        hw = 0
        for c in pcols:
            col = np.asarray(jTc[:, int(pp[c])].todense()).ravel()
            xc, _ = spsla.cg(F, col, rtol=1e-10, atol=0.0, maxiter=400,
                             M=Mdiag)
            xn = np.abs(xc[perm])
            big = np.nonzero(xn > 1e-7 * xn.max())[0]
            if len(big):
                hw = max(hw, int(np.abs(big - mpos[pp[c]]).max()))
        wx = (int(3 * hw) * npp // nv + wjt
              + 2 * int(xband_k) * bs * npp // nv)
        wx = min(int(np.ceil(wx / 128)) * 128, njtpad)
        xbases = tuple(min(max(b + (wjt - wx) // 2, 0), njtpad - wx)
                       for b in jtbases)
        self._wx, self._xbases, self._ncolpad_x = int(wx), xbases, int(njtpad)

        # the truncated inverse W ~ F^-1: ONE wide static-window matvec in
        # place of the fixed-count PCG; window probed like X's
        self._ww, self._ncolpad_w, self._wbases = 0, 0, ()
        use_winv = ((nv > 5000 or nblk * bs * 3 * bs * 4 > 1.2e8)
                    if winv is None else bool(winv))
        if use_winv and not (device.type == "cpu" and nv > 4000):
            rngw = np.random.default_rng(1)
            hwf = 0
            for j in rngw.choice(nv, min(8, nv), replace=False):
                e = np.zeros(nv)
                e[j] = 1.0
                xc, _ = spsla.cg(F, e, rtol=1e-10, atol=0.0, maxiter=400,
                                 M=Mdiag)
                xn = np.abs(xc[perm])
                big = np.nonzero(xn > wtol * xn.max())[0]
                if len(big):
                    hwf = max(hwf, int(np.abs(big - ipos[j]).max()))
            ww = bs + 2 * int(np.ceil(1.3 * hwf))
            ww = min(int(np.ceil(ww / 128)) * 128, max(nv, 128))
            if nblk * bs * ww * 4 <= winv_maxgb * 1e9:
                ncpw = max(nv, ww)
                self._ww, self._ncolpad_w = int(ww), int(ncpw)
                self._wbases = tuple(
                    min(max(k * bs + (bs - ww) // 2, 0), ncpw - ww)
                    for k in range(nblk))
        lap("probes_s")

        # ---- the factors, in permuted layout: banded X, S = J X, S^-1.
        # Host: one splu, X from its backsolves.  Device: X by block PCG
        # on the banded F, folded chunk by chunk (X comes first because S
        # is formed from it; the JAX package's S-before-X order staged TPU
        # memory).  Low-bit storage on the card: the solve factors as bf16
        # row-stacked levels (W and S^-1 three, X two), f32-grade in the
        # full stack, half the f32 bytes in the hi rows alone; the residual
        # operators (banded F, J, J^T, E) stay f32
        use_lb = (on_card if lowbit == "auto" else bool(lowbit)) and \
            dtype == torch.float32
        S = None
        if setup == "device":
            xb, tot = _build_x_banded(
                self.Bblk, (1.0 / dv)[perm],
                sps.csc_matrix(jT)[perm][:, pp], xbases, wx,
                max(40, self.ncg + 12))
            # f64 sums, one block at a time
            kept = sum(float(b.double().square().sum()) for b in xb)
        else:
            lu = spsla.splu(F)
            X = lu.solve(np.asarray(sps.csc_matrix(jT)[:, pp].todense()))
            if not use_lb:
                # the exact S: the f32 path's parity with the JAX package
                S = np.asarray(sps.csr_matrix(J)[pp] @ X)
            Xp = np.asarray(X, np.float32)[perm]
            del X
            xb = np.zeros((nblk, bs, wx), np.float32)
            for kb, b in enumerate(xbases):
                r0 = kb * bs
                sub = Xp[r0: min(r0 + bs, nv), b: min(b + wx, npp)]
                xb[kb, : sub.shape[0], : sub.shape[1]] = sub
            # f64 sums: the two are nearly equal, f32 noise would read as a
            # spurious truncation
            tot = float((Xp.astype(np.float64) ** 2).sum())
            kept = float((xb.astype(np.float64) ** 2).sum())
            xb = torch.from_numpy(xb)
        trunc = np.sqrt(max(tot - kept, 0.0) / (tot or 1.0))
        if trunc > 1e-4:
            import warnings

            warnings.warn(f"banded-X truncation {trunc:.1e} above 1e-4; "
                          "raise xband_k")
        if full_map is not None:
            self.nv = full_map[1]
        self.Xb = as_band_operand(pair_stack(xb, parts=2) if use_lb else xb,
                                  device=device)
        del xb
        lap("x_s")
        if S is None:
            # S from the X the solve applies (its levels summed), not from
            # the exact one: then J v = g holds to f32 grade in every solve
            # (v = y - X S^-1 (J y - g)), where the exact S leaves a 16-bit
            # divergence residual in every unrefined solve (2.5e-6 of
            # |J||v| after 300 level-1 steps on the card; the JAX package
            # forms S from the exact X)
            S = _schur_of_banded(self.JTb, jtbases, self.Xb, xbases, npp)
        elif on_card and npp > 3000:
            # the host's single-core inv takes minutes at these sizes
            S = torch.as_tensor(S, device=device)
        lap("s_s")
        # an f64 LU inverse on S's device (the JAX package's f32 LU +
        # Newton-Schulz construction stood in for the TPU's missing f64 LU)
        Sinv64 = (torch.linalg.inv(S) if torch.is_tensor(S) else
                  torch.as_tensor(np.linalg.inv(S))).to(device)
        del S
        if dtype == torch.float32:
            hi = Sinv64.to(torch.float32)
            lo = (Sinv64 - hi.to(torch.float64)).to(torch.float32)
            levels = _sinv_tri(hi, lo) if use_lb else (hi, lo)
        else:
            levels = (Sinv64.to(dtype),)
        del Sinv64
        # S^-1 as one static window (block 0, base 0) of stacked levels
        self.Sinv = band_operand((1, len(levels), npp, npp), levels[0].dtype,
                                 device)
        for i, lev in enumerate(levels):
            self.Sinv[0, i] = lev
        self._sbase = torch.zeros(1, dtype=torch.int32, device=device)
        del levels
        lap("sinv_s")

        self.Wb = None
        if self._ww:
            # W columns need only the truncation tolerance
            niter_w = _cg_count(F, np.random.default_rng(2).standard_normal(
                nv), wtol, Mdiag) + 3
            lap("probes_s")
            self.Wb = _build_winv_banded(self.Bblk, (1.0 / dv)[perm], bs,
                                         nblk, nv, self._wbases, self._ww,
                                         niter_w)
            if use_lb:
                self.Wb = pair_stack(self.Wb, parts=3)
        self._jbases_t, self._jtbases_t = bases_t(jbases), bases_t(jtbases)
        self._xbases_t = bases_t(xbases)
        self._wbases_t = bases_t(self._wbases) if self._ww else None
        lap("w_s")

        # refine stays 0 here: the integrators pass warm_refine per call
        self.refine = int(refine or 0)

    # ---- permuted banded core: every application one kernel launch ----

    @property
    def warm_size(self):
        """Length of the warm-start vector ``y`` threaded through
        :meth:`solve_warm` (the permuted inner size)."""
        return self._nin

    @property
    def ncg_warm(self):
        # warm starts begin O(dt) away in relative residual: two thirds of
        # the cold count holds the same tolerance
        return max(6, (2 * self.ncg) // 3)

    def _fmv_perm(self, xp):
        return banded_mv(self.Bblk, xp)

    def band_extra_mv(self, xp):
        """``band_extra_perm @ xp`` (permuted inner space) — the explicit
        operator registered at construction (conv/A split)."""
        return banded_mv(self.Eblk, xp.to(self.dtype))

    def _jmv_perm(self, xp):
        return rect_mv(self.Jb, self._jbases_t, xp, self.np)

    def _jtmv_perm(self, qp):
        return rect_mv(self.JTb, self._jtbases_t, qp, self._nin)

    def _wapply(self, bp, hi_only=False):
        """``W @ bp``; over the bf16 levels ``hi_only`` streams level 0
        alone (the predictor of a refined solve)."""
        if self.Wb.dim() == 4:
            return rect_mv_levels(self.Wb, self._wbases_t, bp, self._nin,
                                  hi_only)
        return rect_mv(self.Wb, self._wbases_t, bp, self._nin)

    def _xapply(self, q):
        if self.Xb.dim() == 4:
            return rect_mv_levels(self.Xb, self._xbases_t, q, self._nin)
        return rect_mv(self.Xb, self._xbases_t, q, self._nin)

    def _sapply(self, g):
        """``S^{-1} g``: the stacked levels, row dots added in level
        order."""
        return rect_mv_levels(self.Sinv, self._sbase, g, self.np)

    def _solve_core_perm(self, bvp, bpp, y0p=None, niter=None, refine=0,
                         niter_ref=None):
        """All-permuted solve (RCM velocity order, pp pressure order).
        Returns ``(v_perm, q_perm, y_perm)``.  With W the velocity-block
        solves are one wide banded matvec (warm starts unused); the refine
        residuals always use the exact banded F."""
        # the predictor reads W's level 0 alone when a refine round
        # follows (without W the PCG refine cannot absorb that rounding);
        # X it applies whole: X's level-0 rounding (~4e-3 of X q) outlives
        # one refine round when the pressure increments are large (static
        # feedback switched on at level 1: 1.3e-6 from the f64 run after
        # 300 refined steps against 1.1e-7, H100; the JAX package reads X's
        # level 0 alone here, sadpnt.py:1859)
        hi_only = refine > 0 and self.Wb is not None
        if self.Wb is not None:
            y = self._wapply(bvp, hi_only=hi_only)
        else:
            y = jacobi_pcg(self._fmv_perm, self.dinv_b, bvp,
                           niter or self.ncg, x0=y0p)
        q = self._sapply(self._jmv_perm(y) - bpp)
        v = y - self._xapply(q)
        for _ in range(refine):
            rv = bvp - (self._fmv_perm(v) + self._jtmv_perm(q))
            rp = bpp - self._jmv_perm(v)
            # the correction solved at O(1) scale
            s = torch.sqrt(torch.mean(rv * rv) + torch.mean(rp * rp)
                           + 1e-30)
            if self.Wb is not None:
                y2 = self._wapply(rv / s)
            else:
                y2 = jacobi_pcg(self._fmv_perm, self.dinv_b, rv / s,
                                niter_ref or niter or self.ncg)
            q2 = self._sapply(self._jmv_perm(y2) - rp / s)
            v = v + s * (y2 - self._xapply(q2))
            q = q + s * q2
        return v, q, y

    def solve_warm_wspace(self, rhs_w, bpp, y0, niter=None, refine=0,
                          niter_ref=None):
        """Warm solve for the PERMUTED state layout: ``rhs_w``'s first
        ``_nin`` entries are the permuted inner rhs (a slice, no gather),
        ``bpp`` is pp-ordered.  Returns ``(dv_perm (nin,), q_pp (np,),
        y_perm)``."""
        bvp = rhs_w[: self._nin].to(self.dtype)
        return self._solve_core_perm(
            bvp, bpp.to(self.dtype), y0p=y0, niter=niter or self.ncg_warm,
            refine=refine, niter_ref=niter_ref)

    def _perm_in(self, rhsv, rhsp):
        bv = rhsv.reshape(-1).to(self.dtype)
        bp = rhsp.reshape(-1).to(self.dtype)
        return bv[self.permf], bp[self.pidx]

    def _perm_out(self, v, q):
        vo = torch.zeros(self.nv, dtype=v.dtype, device=v.device)
        vo[self.permf] = v
        qo = torch.zeros(self.np, dtype=q.dtype, device=q.device)
        qo[self.pidx] = q
        return torch.cat([vo, qo])

    def solve(self, rhsv, rhsp, refine=None):
        """Raw stacked ``[v; q]`` like :class:`InverseSaddleSolver`;
        ``refine`` residual rounds (default: the solver's ``refine``)."""
        bvp, bpp = self._perm_in(rhsv, rhsp)
        v, q, _ = self._solve_core_perm(
            bvp, bpp, refine=self.refine if refine is None else refine)
        return self._perm_out(v, q)

    def solve_warm(self, rhsv, rhsp, y0, niter=None, refine=0,
                   niter_ref=None):
        """Warm-started solve for time stepping: ``y0`` is the previous
        velocity-block solve (or an extrapolation of the last two) in
        permuted inner space (length :attr:`warm_size`); ``refine``
        residual rounds follow.  Returns ``([v; q], y)``."""
        bvp, bpp = self._perm_in(rhsv, rhsp)
        v, q, y = self._solve_core_perm(
            bvp, bpp, y0p=y0, niter=niter or self.ncg_warm, refine=refine,
            niter_ref=niter_ref)
        return self._perm_out(v, q), y


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
    """One-shot host solve; returns the stacked raw ``(nv+np, 1)``.  A
    low-rank update ``A -> A - umat @ vmat`` is handled by an explicit
    dense Sherman-Morrison-Woodbury correction."""
    solve = host_saddle_factorized(amat, jmat, jmatT)
    x0 = solve(rhsv, rhsp)
    if umat is None:
        return x0
    nv, npp = amat.shape[0], jmat.shape[0]
    k = umat.shape[1]
    uh = np.vstack([_to_dense(umat), np.zeros((npp, k))])
    W = np.hstack([solve(uh[: nv, i], uh[nv:, i]) for i in range(k)])
    vh = np.hstack([_to_dense(vmat), np.zeros((vmat.shape[0], npp))])
    coef = np.linalg.solve(np.eye(k) - vh @ W, vh @ x0)
    return x0 + W @ coef


# ---------------------------------------------------------------------------
# low-rank updates and the one-shot LU solver
# ---------------------------------------------------------------------------

class SMWSolver:
    """Wrap any reusable saddle solver with the implicit low-rank update
    ``A -> A - c * umat @ vmat`` via Sherman-Morrison-Woodbury.

    The k base solves for the update columns (``W``, on the base solver's
    device, in its work type) and the k-by-k capacitance inverse (from an
    f64 inverse on the host) are computed ONCE; each wrapped solve costs
    the base solve plus two small dense matvecs — the property that lets
    static feedback ride the step loops (the reference supports feedback
    only in its per-step-LU implicit loop,
    stokes_navier_utils.py:1505-1512).  ``solve_kw`` (e.g. the block-Schur
    solver's ``refine``) go to the base solves of the columns, and
    keywords of :meth:`solve` to the base solve of each right-hand side.
    """

    def __init__(self, base=None, umat=None, vmat=None, c=1.0, **solve_kw):
        self.base = base
        self.nv, self.np = base.nv, base.np
        U = np.asarray(_to_dense(umat), dtype=np.float64)
        V = np.asarray(_to_dense(vmat), dtype=np.float64)
        k = U.shape[1]
        dev = base.device
        zp = torch.zeros(self.np, dtype=torch.float64, device=dev)
        cols = [base.solve(torch.as_tensor(c * U[:, i], device=dev), zp,
                           **solve_kw)
                for i in range(k)]
        W = torch.stack(cols, dim=1)                      # (nv+np, k)
        cap = np.eye(k) - V @ W[: self.nv].double().cpu().numpy()
        self.W = W
        self.capinv = torch.as_tensor(np.linalg.inv(cap)).to(
            device=dev, dtype=W.dtype)
        self.vmat = torch.as_tensor(V).to(device=dev, dtype=W.dtype)

    def solve(self, rhsv, rhsp, **kw):
        x0 = self.base.solve(rhsv, rhsp, **kw)
        coef = self.capinv @ (self.vmat @ x0[: self.nv].to(self.W.dtype))
        return x0 + (self.W @ coef).to(x0.dtype)


class SaddleSolver:
    """Reusable LU factorization of one dense saddle matrix on ``device``
    (``None`` = the card): small systems and one-shot solves.

    The JAX package factors in f32 with f64 iterative refinement on a TPU
    (which has no f64 LU); the card and the CPU both factor in ``dtype``
    (default f64) directly, so no refinement is needed.
    """

    def __init__(self, amat, jmat, jmatT=None, dtype=None, device=None):
        device = resolve_device(device)
        self.device = device
        dtype = dtype or torch.float64
        nv = amat.shape[0]
        npp = jmat.shape[0]
        jT = jmat.T if jmatT is None else jmatT
        K = np.zeros((nv + npp, nv + npp))
        K[:nv, :nv] = _to_dense(amat)
        K[:nv, nv:] = _to_dense(jT)
        K[nv:, :nv] = _to_dense(jmat)
        self.nv, self.np = nv, npp
        self.dtype = dtype
        self.lu, self.piv = torch.linalg.lu_factor(
            torch.as_tensor(K).to(device=device, dtype=dtype))

    def _backsolve(self, B):
        """LU backsolve; ``B`` is (n,) or (n, k)."""
        vec = B.dim() == 1
        X = torch.linalg.lu_solve(self.lu, self.piv,
                                  (B[:, None] if vec else B).to(self.dtype))
        return X[:, 0] if vec else X

    def solve(self, rhsv, rhsp):
        """Solve for stacked ``[v; q] (nv+np,)``."""
        rhs = torch.cat([torch.as_tensor(rhsv, device=self.device)
                         .reshape(-1).to(self.dtype),
                         torch.as_tensor(rhsp, device=self.device)
                         .reshape(-1).to(self.dtype)])
        return self._backsolve(rhs)

    def solve_smw(self, rhsv, rhsp, umat, vmat):
        """Solve with the rank-k update ``A -> A - umat @ vmat``.

        SMW around the base factorization:
        ``x = x0 + W (I - V W)^{-1} V x0`` with ``W = K^{-1} U_hat``.
        """
        x0 = self.solve(rhsv, rhsp)
        umat = torch.as_tensor(umat, device=self.device).to(self.dtype)
        vmat = torch.as_tensor(vmat, device=self.device).to(self.dtype)
        k = umat.shape[1]
        uhat = torch.cat([umat, umat.new_zeros((self.np, k))])
        W = self._backsolve(uhat)
        vhat = torch.cat([vmat, vmat.new_zeros((vmat.shape[0], self.np))],
                         dim=1)
        small = torch.eye(k, dtype=self.dtype, device=self.device) - vhat @ W
        coef = torch.linalg.solve(small, vhat @ x0)
        return x0 + W @ coef


def solve_sadpnt(amat=None, jmat=None, jmatT=None, rhsv=None, rhsp=None,
                 umat=None, vmat=None, return_solver=False,
                 krylov=None, krpslvprms=None, krplsprms=None, device=None):
    """Functional one-shot API mirroring ``lau.solve_sadpnt_smw``.

    Returns the stacked raw solution ``(nv+np, 1)`` (numpy); with
    ``return_solver=True`` also the reusable :class:`SaddleSolver` (on
    ``device``, ``None`` = the card).  ``krylov`` (the Krylov path) is not
    ported yet.
    """
    if krylov:
        raise NotImplementedError(
            "solve_sadpnt(krylov=...): the Krylov saddle solver is not "
            "ported yet (ROADMAP A8)")
    solver = SaddleSolver(amat, jmat, jmatT, device=device)
    if rhsp is None:
        rhsp = np.zeros((solver.np,))
    if umat is not None:
        out = solver.solve_smw(np.asarray(rhsv), np.asarray(rhsp),
                               _to_dense(umat), _to_dense(vmat))
    else:
        out = solver.solve(np.asarray(rhsv), np.asarray(rhsp))
    out = out.cpu().numpy().reshape(-1, 1)
    if return_solver:
        return out, solver
    return out


def apply_massinv(massmat, rhsa, output=None):
    """``M^{-1} rhs`` on the host — parity with ``lau.apply_massinv``
    (used e.g. in tests/time_dep_nse_bigchannel.py:33)."""
    rhs = np.asarray(_to_dense(rhsa))
    out = spsla.spsolve(sps.csc_matrix(massmat), rhs)
    return np.asarray(out).reshape(rhs.shape)
