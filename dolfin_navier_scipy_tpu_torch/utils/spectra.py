"""Spectral studies of the linearized flow (DAE pencil).

Twin of the JAX package's ``utils/spectra.py`` (parity with the
reference's tests/lilchecks/check_evals.py): eigenvalues of the
generalized pencil of the linearized Navier-Stokes DAE

    [[M, 0],[0, 0]] lam [v;p] = [[-(A + N1 + N2), -J^T],[-J, 0]] [v;p],

assembled and solved on the host (scipy), from the port's host
convection matrices.
"""

import numpy as np
import scipy.sparse as sps


def linearized_dae_pencil(prob, v_lin_full):
    """Returns ``(E, Apen)`` scipy matrices of the linearized DAE about
    ``v_lin_full`` (full-dof velocity with boundary values; a tensor on any
    device or an array)."""
    from ..ops.condense import condense_velmat
    from ..ops.convection import convection_matrices_host
    from .io import host

    N1, N2, _ = convection_matrices_host(prob.ctx,
                                         host(v_lin_full).ravel())
    Nc, _ = condense_velmat(N1 + N2, invinds=prob.invinds,
                            dbcinds=[prob.bcinds], dbcvals=[prob.bcvals])
    npc = prob.np_cond
    E = sps.block_diag([sps.csr_matrix(prob.Mc),
                        sps.csr_matrix((npc, npc))]).tocsr()
    Apen = sps.vstack([
        sps.hstack([-(prob.Ac + Nc), -sps.csr_matrix(prob.JTc)]),
        sps.hstack([-sps.csr_matrix(prob.Jc), sps.csr_matrix((npc, npc))]),
    ]).tocsr()
    return E, Apen


def leading_evals(prob, v_lin_full, k=10, sigma=0.0):
    """Leading (rightmost near ``sigma``) eigenvalues of the pencil via
    shift-invert Arnoldi (the reference's eigenvalue studies,
    tests/lilchecks/check_evals.py)."""
    import scipy.sparse.linalg as spsla

    E, Apen = linearized_dae_pencil(prob, v_lin_full)
    return spsla.eigs(Apen, k=k, M=E, sigma=sigma,
                      return_eigenvectors=False)
