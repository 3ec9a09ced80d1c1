"""Reference elements, quadrature and dof maps (the host-side FEM compiler)."""

from .reference import (  # noqa: F401
    tri_quadrature,
    edge_quadrature,
    shape_p1,
    dshape_p1,
    shape_p2,
    dshape_p2,
)
from .dofmap import (  # noqa: F401
    TaylorHoodSpace,
    TaylorHoodSpace3D,
    interpolate_velocity,
)
