"""Krylov saddle-point solves.

Parity with the reference's optional krypy-GMRES path
(``lau.solve_sadpnt_smw(krylov='gmres', krpslvprms=..., krplsprms=...)``,
solve_nse docstring stokes_navier_utils.py:651-664) on the host, plus two
device GMRES twins of the JAX package's:

* :func:`device_pgmres` — the arithmetic of
  ``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")``
  (left-preconditioned restarted GMRES, normal-equation least squares),
* :func:`device_fgmres` — the JAX package's flexible GMRES.

Neither reads a value back to the host inside an Arnoldi cycle;
:func:`device_pgmres` reads one residual norm per restart cycle (its
stopping test), :func:`device_fgmres` none.  ``KrylovCounter`` mirrors
``SpslaKrylovCounter`` (residual-callback statistics,
stokes_navier_utils.py:724,:861-874).
"""

import warnings

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spsla
import torch


class KrylovCounter:
    """Residual-callback counter for scipy Krylov solvers."""

    def __init__(self, store=None):
        self.niter = 0
        self.resnorms = []
        self.store = store

    def __call__(self, res):
        self.niter += 1
        r = float(np.linalg.norm(res)) if np.ndim(res) else float(res)
        self.resnorms.append(r)
        if self.store is not None:
            self.store.append(r)


def solve_sadpnt_krylov(amat=None, jmat=None, jmatT=None, rhsv=None,
                        rhsp=None, umat=None, vmat=None,
                        krpslvprms=None, krplsprms=None, precond=None):
    """Host GMRES on the saddle system with optional preconditioner.

    ``krpslvprms`` keys (matching the reference's kwargs bag):
    ``tol``, ``maxiter``, ``x0``, ``restart``, ``convstatsl`` (a list that
    collects per-iteration residual norms).  ``krplsprms`` carries
    linear-*system* side parameters the reference forwards to krypy
    (stokes_navier_utils.py:661, :1511): the supported key is ``Ml`` — a
    left preconditioner ((nv+np,) vector -> vector callable, sparse
    matrix, or ``LinearOperator``); it takes precedence over ``precond``.
    The low-rank feedback update ``A -> A - umat @ vmat`` enters the
    Krylov operator directly.  Returns ``(x (nv+np, 1), counter)``.
    """
    p = dict(krpslvprms or {})
    lp = dict(krplsprms or {})
    if "Ml" in lp and lp["Ml"] is not None:
        Ml = lp["Ml"]
        if callable(Ml) and not isinstance(Ml, spsla.LinearOperator):
            n = amat.shape[0] + jmat.shape[0]
            precond = spsla.LinearOperator((n, n), matvec=Ml)
        else:
            precond = spsla.aslinearoperator(Ml)
    nv = amat.shape[0]
    npp = jmat.shape[0]
    jT = jmat.T if jmatT is None else jmatT
    K = sps.vstack([
        sps.hstack([sps.csr_matrix(amat), sps.csr_matrix(jT)]),
        sps.hstack([sps.csr_matrix(jmat), sps.csr_matrix((npp, npp))]),
    ]).tocsr()
    if rhsp is None:
        rhsp = np.zeros((npp,))
    b = np.concatenate([np.asarray(rhsv).ravel(), np.asarray(rhsp).ravel()])
    counter = KrylovCounter(store=p.get("convstatsl"))
    if umat is not None:
        U = np.asarray(umat.todense() if sps.issparse(umat) else umat)
        V = np.asarray(vmat.todense() if sps.issparse(vmat) else vmat)

        def upd_matvec(x):
            y = K @ x
            y[:nv] -= U @ (V @ x[:nv])
            return y

        Kop = spsla.LinearOperator(K.shape, matvec=upd_matvec)
    else:
        Kop = K
    x, info = spsla.gmres(
        Kop, b, x0=p.get("x0"),
        rtol=p.get("tol", 1e-10), atol=0.0,
        restart=p.get("restart", 150),
        maxiter=p.get("maxiter", 200),
        M=precond, callback=counter, callback_type="pr_norm",
    )
    if info != 0:
        warnings.warn(f"gmres: info={info} (not converged)")
    return x.reshape(-1, 1), counter


# ---------------------------------------------------------------------------
# device GMRES (torch twins of the JAX package's)
# ---------------------------------------------------------------------------

def _norm(x):
    return torch.sqrt(x @ x)


def _safe_normalize(x, thresh=None):
    """``(x / |x|, |x|)``, or ``(0, 0)`` where ``|x|`` is not above
    ``thresh`` (default: the type's machine epsilon)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _spd_solve(a, b):
    """``a^-1 b`` by Cholesky; NaN where ``a`` is not positive definite
    (what JAX's ``solve(assume_a='pos')`` returns there)."""
    L, info = torch.linalg.cholesky_ex(a)
    y = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, y, torch.full_like(y, float("nan")))


def _pgmres_cycle(A, M, b, x0, unit_residual, residual_norm, restart):
    """One restart of JAX's batched GMRES (``_gmres_batched``): Arnoldi on
    ``M(A(.))`` with one classical Gram-Schmidt pass (JAX's
    ``_iterative_classical_gram_schmidt`` with ``max_iterations=2`` stops
    after its first pass), stopped at a breakdown (``|w| <= eps |w_0|``),
    then the least-squares problem by its normal equations.  The stop is
    a mask (no host read); the columns after a breakdown stay zero and
    the rows of ``H`` stay those of the identity, as there."""
    n = b.shape[0]
    dt = b.dtype
    eps = torch.finfo(dt).eps
    V = torch.zeros((restart + 1, n), dtype=dt, device=b.device)
    V[0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=dt, device=b.device)
    alive = torch.ones((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        w = M(A(V[k]))
        _, w_norm0 = _safe_normalize(w)
        h = V @ w
        w = w - h @ V
        unit_w, w_norm1 = _safe_normalize(w, thresh=eps * w_norm0)
        h[k + 1] = w_norm1
        V[k + 1] = torch.where(alive, unit_w, V[k + 1])
        H[k] = torch.where(alive, h, H[k])
        alive = alive & (w_norm1 != 0)
    beta = torch.zeros(restart + 1, dtype=dt, device=b.device)
    beta[0] = residual_norm
    y = _spd_solve(H @ H.T, H @ beta)
    x = x0 + y @ V[:-1]
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def device_pgmres(matvec, b, precond, x0=None, tol=1e-12, restart=20,
                  maxiter=3, atol=0.0):
    """Preconditioned restarted GMRES: the arithmetic of
    ``jax.scipy.sparse.linalg.gmres(matvec, b, x0, M=precond, tol,
    atol, restart, maxiter, solve_method="batched")``.

    Left-preconditioned: the Krylov space is that of ``M(A(.))`` and the
    residual ``M(b - A x)``; a new restart cycle runs while that
    preconditioned residual's norm is above ``max(tol |b|, atol)`` (one
    host read per cycle, none inside it) and fewer than ``maxiter`` cycles
    ran (``None``: ``10 n``)."""
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    restart = min(int(restart), n)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    stop = torch.clamp(tol * _norm(b), min=atol)
    unit, rnorm = _safe_normalize(precond(b - matvec(x)))
    for _ in range(int(maxiter)):
        if not bool(rnorm > stop):
            break
        x, unit, rnorm = _pgmres_cycle(matvec, precond, b, x, unit, rnorm,
                                       restart)
    return x


def device_fgmres(matvec, precond, b, restart=30, cycles=3, x0=None):
    """FLEXIBLE GMRES (FGMRES, right-preconditioned), the JAX package's
    ``device_fgmres``.

    The preconditioner may be a NONLINEAR map — e.g. an inner iterative
    solve, whose effective operator depends on its input; FGMRES stores
    the preconditioned basis ``Z_j = M(v_j)`` and forms the update from
    it (Saad 1993).  A fixed count: ``cycles`` restarts of ``restart``
    iterations, no host read.  Its arithmetic is the JAX package's, whose
    choices were made for the TPU and are kept because they fix the
    numbers: classical Gram-Schmidt over the basis built so far (the
    JAX package masks a full-basis product; its rows past ``j`` are
    zeros, so the values are the same), the small least-squares problem
    by the normal equations with a ridge relative to their scale
    (``1e-6 tr(G) / m``), and a non-finite update dropped.

    Returns the approximate solution of ``matvec(x) = b`` from ``x0``
    (default 0)."""
    m = int(restart)
    n = b.shape[0]
    dt, dev = b.dtype, b.device
    tiny = 1e-30
    eye = torch.eye(m, dtype=dt, device=dev)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    for _ in range(int(cycles)):
        r = b - matvec(x)
        beta = _norm(r)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / (beta + tiny)
        Z = torch.zeros((m, n), dtype=dt, device=dev)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        for j in range(m):
            z = precond(V[j])
            w = matvec(z)
            h = V[: j + 1] @ w
            w = w - h @ V[: j + 1]
            nw = _norm(w)
            V[j + 1] = w / (nw + tiny)
            H[: j + 1, j] = h
            H[j + 1, j] = nw
            Z[j] = z
        G = H.T @ H
        reg = 1e-6 * torch.trace(G) / m + tiny
        y = _spd_solve(G + reg * eye, H[0] * beta)
        y = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
        x = x + y @ Z
    return x
