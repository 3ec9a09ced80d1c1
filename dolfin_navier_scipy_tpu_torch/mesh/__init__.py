"""Meshes: triangle and tetrahedral mesh containers, the native
generators and the dolfin-XML reader and writer."""

from .trimesh import TriMesh  # noqa: F401
from .generators import unit_square, channel_with_cylinder  # noqa: F401
from .tetmesh import TetMesh, extrude_trimesh  # noqa: F401
from .dolfinxml import (  # noqa: F401
    read_dolfin_xml,
    read_facet_region,
    write_dolfin_xml,
)
