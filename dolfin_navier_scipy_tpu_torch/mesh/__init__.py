"""Meshes: triangle mesh container and the native generators."""

from .trimesh import TriMesh  # noqa: F401
from .generators import unit_square, channel_with_cylinder  # noqa: F401
