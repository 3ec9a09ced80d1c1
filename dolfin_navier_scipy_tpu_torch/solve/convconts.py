"""``get_v_conv_conts`` — API parity with the reference's linearized
convection helper (stokes_navier_utils.py:40-133): the Newton/Picard/
semi-explicit convection contributions condensed to the inner dofs, as
scipy matrices and numpy vectors for host callers.
"""

import numpy as np
import scipy.sparse as sps
import torch

from ..ops.condense import condense_velmat
from ..ops.convection import convection_matrices_host


def _embed_host(prob, v_inner):
    full = prob.bc_full_vec()
    full[prob.invinds] = np.asarray(v_inner).ravel()
    return full


def get_v_conv_conts(vvec=None, prob=None, semi_explicit=False,
                     Picard=False, retparts=False, device=None, **kw):
    """``vvec``: inner (condensed) or full velocity vector.  The matrices
    are assembled on the host; ``semi_explicit`` evaluates the convection
    vector with the device kernel on ``device`` (``None``: the problem's
    device, the card unless it names another)."""
    vvec = np.asarray(vvec).ravel()
    v_full = vvec if len(vvec) == prob.nv_full else _embed_host(prob, vvec)
    inv = prob.invinds

    if semi_explicit:
        kern = prob.conv_kernel_on(torch.float64, device)
        vec = kern.vector(torch.as_tensor(v_full, device=kern.device))
        rhs_con = vec.cpu().numpy()[inv].reshape(-1, 1)
        return 0.0, -rhs_con, 0.0

    N1, N2, rhs_con = convection_matrices_host(prob.ctx, v_full)
    dbc = dict(invinds=inv, dbcinds=[prob.bcinds], dbcvals=[prob.bcvals])

    if Picard:
        convc_mat, rhsv_conbc = condense_velmat(N1, **dbc)
        return convc_mat, None, rhsv_conbc
    if retparts:
        m1, b1 = condense_velmat(N1, **dbc)
        m2, b2 = condense_velmat(N2, **dbc)
        return (m1, m2), rhs_con[inv], (b1, b2)
    convc_mat, rhsv_conbc = condense_velmat(
        sps.csr_matrix(N1 + N2), **dbc)
    return convc_mat, rhs_con[inv], rhsv_conbc


def expand_vp(prob, vc=None, pc=None, vp=None):
    """Reference ``expand_vp_dolfunc`` semantics without dolfin: inner
    (condensed) vectors -> full-dof velocity (+ pinned-pressure padding).
    Returns ``(v_full (nv_full,1), p_full or None)``."""
    if vp is not None:
        nin = len(prob.invinds)
        vp = np.asarray(vp).ravel()
        vc, pc = vp[:nin], -vp[nin:]     # raw saddle: flip to physical p
    v_full = None
    if vc is not None:
        vc = np.asarray(vc).ravel()
        if len(vc) == prob.nv_full:
            v_full = vc.reshape(-1, 1)
        else:
            v_full = _embed_host(prob, vc).reshape(-1, 1)
    p_full = None
    if pc is not None:
        pc = np.asarray(pc).ravel()
        if prob.geo.ppin is not None and len(pc) == prob.np_cond:
            pc = np.concatenate([pc, [0.0]])
        p_full = pc.reshape(-1, 1)
    return v_full, p_full


def get_bcinds(prob, tag):
    """Velocity dof indices on a tagged boundary (reference
    ``get_bcinds``, problem_setups.py)."""
    nodes = prob.space.boundary_nodes(tag)
    dim = getattr(prob.space, "dim", 2)
    return np.sort(np.concatenate(
        [dim * nodes + c for c in range(dim)]))
