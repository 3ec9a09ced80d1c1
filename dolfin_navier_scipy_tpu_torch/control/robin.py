"""Robin-penalization boundary control.

The reference's driver pattern (tests/time_dep_nse_bcrob.py:26-31,
tests/steadystate_nse_brob.py:26-27):

    A <- A + 1/palpha * Arob,     B = 1/palpha * Brob

with ``Arob``/``Brob`` the boundary mass/input operators assembled over
the control boundaries (dolfin_to_sparrays.py:277-320).  The control
``u(t)`` then enters through the time-dependent rhs ``f_tdp``.
"""

import numpy as np
import scipy.sparse as sps

from ..ops.assemble import robin_facet_elements


def apply_robin_penalty(prob, palpha):
    """In-place: fold the Robin penalization into the problem's stiffness.

    Returns ``Brob_scaled = 1/palpha * Brob`` (inner dofs x n_controls).
    The element tensors get the same boundary-mass blocks, so the facet
    rows of :class:`..ops.affine.AffineVectorOps` carry the penalty; the
    problem's cached affine ops and full-dof layouts (built from the old
    ``A``) are dropped.
    """
    if prob.Arob is None:
        raise ValueError("problem was not built with bccontrol=True")
    prob.Ac = sps.csr_matrix(prob.Ac + 1.0 / palpha * prob.Arob)
    if prob.elem_tensors is not None:
        Ael = prob.elem_tensors["A"]
        for tag in prob.geo.control_tags:
            cells, elem = robin_facet_elements(prob.ctx, tag)
            np.add.at(Ael, cells,
                      1.0 / palpha * elem.reshape(len(cells), 12, 12))
        prob._affine_ops = {}
        prob._full_layouts = {}
    return 1.0 / palpha * prob.Brob
