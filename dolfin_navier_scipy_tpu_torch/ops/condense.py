"""Dirichlet-BC resolution by condensation (host side).

Mirrors the semantics of the reference's ``condense_sysmatsbybcs`` /
``condense_velmatsbybcs`` (dolfin_to_sparrays.py:475-642): split dofs
into inner/boundary index sets, fold boundary values into right-hand
sides (``fvbc = -A @ u_bc``, ``fpbc = -J @ u_bc``), and slice matrices to
the inner dofs.  On device the same splitting becomes static
gathers/scatters (``NSEProblem.embed``).
"""

import numpy as np
import scipy.sparse as sps


def unroll_dbcs(dbcinds, dbcvals):
    """Flatten possibly-nested (list-of-lists) bc index/value specs."""
    if dbcinds is None:
        return np.array([], dtype=np.int64), np.array([])
    flat_i, flat_v = [], []
    for i, v in zip(dbcinds, dbcvals):
        if np.isscalar(i):
            flat_i.append(int(i))
            flat_v.append(float(v))
        else:
            flat_i.extend(int(k) for k in np.asarray(i).ravel())
            vv = np.asarray(v).ravel()
            if vv.size == 1:
                flat_v.extend([float(vv[0])] * len(np.asarray(i).ravel()))
            else:
                flat_v.extend(float(k) for k in vv)
    return np.asarray(flat_i, dtype=np.int64), np.asarray(flat_v)


def condense_sysmats(stms, dbcinds, dbcvals, invinds=None, rhsdict=None,
                     get_rhs_only=False):
    """Condense the Stokes matrix family to the inner velocity dofs.

    Returns ``(matsc, rhsbc, invinds, bcinds, bcvals)`` exactly as the
    reference (dolfin_to_sparrays.py:475-573).
    """
    bcinds, bcvals = unroll_dbcs(dbcinds, dbcvals)
    nv = stms["A"].shape[0]
    if invinds is None:
        invinds = np.setdiff1d(np.arange(nv), bcinds).astype(np.int64)
    auxu = np.zeros((nv, 1))
    auxu[bcinds, 0] = bcvals

    fvbc = -(stms["A"] @ auxu)[invinds]
    fpbc = -(stms["J"] @ auxu)

    if get_rhs_only:
        if rhsdict is not None:
            return {"fv": rhsdict["fv"][invinds] + fvbc,
                    "fp": rhsdict["fp"] + fpbc}
        return {"fv": fvbc, "fp": fpbc}

    matsc = {
        "M": stms["M"][invinds, :][:, invinds],
        "A": stms["A"][invinds, :][:, invinds],
        "J": stms["J"][:, invinds],
        "JT": stms["JT"][invinds, :],
        "MP": stms["MP"],
    }
    rhsbc = {"fv": fvbc, "fp": fpbc}
    return matsc, rhsbc, invinds, bcinds, bcvals


def condense_velmat(A, invinds=None, dbcinds=None, dbcvals=None,
                    vwithbcs=None, get_rhs_only=False, columnsonly=False):
    """Condense one velocity matrix; per-time-step variant
    (dolfin_to_sparrays.py:576-642)."""
    nv = A.shape[1]
    if vwithbcs is not None:
        bcsv = np.asarray(vwithbcs).reshape(-1, 1).copy()
        bcsv[invinds] = 0.0
        ininds = invinds
    else:
        bcinds, bcvals = unroll_dbcs(dbcinds, dbcvals)
        bcsv = np.zeros((nv, 1))
        bcsv[bcinds, 0] = bcvals
        ininds = (np.setdiff1d(np.arange(nv), bcinds).astype(np.int64)
                  if invinds is None else invinds)

    fvbc = -(A @ bcsv)
    if get_rhs_only:
        return fvbc[ininds]
    if columnsonly:
        return sps.csr_matrix(A)[:, ininds]
    return sps.csr_matrix(A)[ininds, :][:, ininds], fvbc[ininds]


def append_bcs_vec(vvec, nv_full=None, invinds=None, dbcinds=None,
                   dbcvals=None, **kw):
    """Full dof vector from inner values + boundary values (numpy),
    reference dolfin_to_sparrays.py:49-63."""
    bcinds, bcvals = unroll_dbcs(dbcinds, dbcvals)
    vwbcs = np.zeros((nv_full, 1))
    vwbcs[invinds] = np.asarray(vvec).reshape(-1, 1)
    vwbcs[bcinds, 0] = bcvals
    return vwbcs
