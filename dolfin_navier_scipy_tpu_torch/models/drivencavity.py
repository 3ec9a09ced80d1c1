"""Lid-driven cavity setup (reference: problem_setups.py:223-318).

Unit square, no-slip on left/right/bottom, lid velocity (1,0) on top
(lid wins at the corners, matching dolfin's apply-in-order semantics),
pressure pinned at the last dof (enclosed flow).
"""

from ..mesh.generators import unit_square
from .problem import GeoSetup, build_problem


def drivencavity_problem(N=10, nu=None, Re=None, scheme="TH",
                         gradvsymmtrc=True, device=None):
    mesh = unit_square(N)
    geo = GeoSetup(
        charlen=1.0,
        wall_tags=[1, 2, 3],            # left, right, bottom
        inflow_tag=4,                   # the lid plays the "inflow" role
        inflow_fn=lambda x: (1.0, 0.0),
        outflow_tag=None,
        ppin=-1,
        odcoo=dict(xmin=0.45, xmax=0.55, ymin=0.5, ymax=0.7),
    )
    return build_problem(mesh, geo, nu=nu, Re=Re, charvel=1.0,
                         gradvsymmtrc=gradvsymmtrc, scheme=scheme,
                         device=device)
