"""3D cylinder-wake setups: extruded DFG channel on tetrahedra.

Parity with the reference's ``cyl3D_fems`` / ``gen_bccont_fems_3D``
(problem_setups.py:630-770, :1200-1417): inflow paraboloid
(``InflowParabola3D``, :1044-1080), no-slip side walls and cylinder,
z-slip walls (only the z-component constrained), natural outflow.
Boundary control and lift/drag raise NotImplementedError in the
reference (:1362, :1375); here the lift/drag residual trick works in 3D
as well, so the functionals are available.
"""


from ..mesh.generators import channel_with_cylinder
from ..mesh.tetmesh import extrude_trimesh
from .problem import GeoSetup, build_problem

ZWALL_BOT, ZWALL_TOP = 8, 9


def parabola_inflow_3d(height_y, height_z, inflowvel, paraboloid=False):
    """Inflow profile along +x.

    ``paraboloid=False``: parabolic in y, constant in z (consistent with
    z-slip walls); ``True``: the reference's 36 sx(1-sx) sy(1-sy)
    paraboloid (problem_setups.py:1067-1076)."""

    def fn(x):
        sy = x[1] / height_y
        prof = 6.0 * sy * (1.0 - sy)
        if paraboloid:
            sz = x[2] / height_z
            prof *= 6.0 * sz * (1.0 - sz)
        return (inflowvel * prof, 0.0, 0.0)

    return fn


def cylinderwake3d_problem(
    level=0,
    nz=3,
    height_z=0.41,
    nu=None,
    Re=None,
    charvel=0.2,
    paraboloid_inflow=False,
    zslip=True,
    mesh=None,
    length=2.2,
    center=(0.2, 0.2),
    device=None,
):
    """Extruded DFG cylinder wake on tets.

    ``zslip=True`` constrains only the z-velocity on the z-walls (the
    reference's slip walls); otherwise they are no-slip.
    ``mesh``: pass a pre-built/tagged :class:`TetMesh` (e.g. a
    gmsh-converted dolfin XML mesh read via
    :func:`~..mesh.dolfinxml.read_dolfin_xml`) instead of the native
    extrusion; its facet tags must follow the DFG convention
    (1 inflow, 2 outflow, 3/4 side walls, 5 cylinder, 8/9 z-walls).
    ``device`` is recorded on the problem (``None``: the card).
    """
    if mesh is None:
        # the Schaefer-Turek 3D-Z geometry is length=2.5,
        # center=(0.5, 0.2) (the default 2.2/(0.2, 0.2) extrudes the 2D
        # benchmark channel, the reference's cyl3D configuration)
        mesh2d = channel_with_cylinder(level=level, length=length,
                                       center=center, split_allbdry=True)
        mesh = extrude_trimesh(mesh2d, nz=nz, height=height_z,
                               ztags=(ZWALL_BOT, ZWALL_TOP))
    geo = GeoSetup(
        charlen=0.1,
        inflow_tag=1,
        inflow_fn=parabola_inflow_3d(0.41, height_z, charvel,
                                     paraboloid=paraboloid_inflow),
        wall_tags=[3, 4, 5],          # side walls + cylinder
        outflow_tag=2,
        liftdrag_tag=5,
    )
    if zslip:
        geo.slip_walls = {ZWALL_BOT: (2,), ZWALL_TOP: (2,)}
    else:
        geo.wall_tags += [ZWALL_BOT, ZWALL_TOP]
    return build_problem(mesh, geo, nu=nu, Re=Re, charvel=charvel,
                         gradvsymmtrc=True, scheme="TH", device=device)
