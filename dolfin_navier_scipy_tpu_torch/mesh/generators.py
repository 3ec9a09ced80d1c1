"""Native mesh generators.

The reference ships pre-built gmsh meshes (tests/mesh/*.xml.gz) and uses
``dolfin.UnitSquareMesh`` for the driven cavity (problem_setups.py:223).
Here meshes are generated natively: a structured unit square, and a
body-fitted O-grid + Delaunay channel-with-cylinder for the DFG benchmark
geometry (cf. tests/mesh/karman2D-rotcyl-bm_geo_cntrlbc.json).
"""

import numpy as np

from .trimesh import TriMesh

# physical-entity convention used by the bundled geometry descriptors:
INFLOW, OUTFLOW, WALL_BOT, WALL_TOP, CYLINDER = 1, 2, 3, 4, 5


def unit_square(n: int, tag_boundaries: bool = True) -> TriMesh:
    """Structured ``n x n`` unit-square mesh, each square split in two.

    Tags: 1 left, 2 right, 3 bottom, 4 top (lid).
    """
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (n + 1) + j

    cells = []
    for i in range(n):
        for j in range(n):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            cells.append([a, b, c])
            cells.append([a, c, d])
    cells = np.array(cells, dtype=np.int64)

    tags = {}
    if tag_boundaries:
        left = [[vid(0, j), vid(0, j + 1)] for j in range(n)]
        right = [[vid(n, j), vid(n, j + 1)] for j in range(n)]
        bottom = [[vid(i, 0), vid(i + 1, 0)] for i in range(n)]
        top = [[vid(i, n), vid(i + 1, n)] for i in range(n)]
        tags = {1: np.array(left), 2: np.array(right),
                3: np.array(bottom), 4: np.array(top)}
    return TriMesh(verts, cells, tags)


def channel_with_cylinder(
    level: int = 1,
    length: float = 2.2,
    height: float = 0.41,
    center=(0.2, 0.2),
    radius: float = 0.05,
    control_arcs=None,
    split_allbdry: bool = False,
) -> TriMesh:
    """Body-fitted mesh of the DFG cylinder-wake channel.

    A graded O-grid annulus hugs the cylinder (polygonal approximation of
    the circle, like the reference's gmsh meshes), embedded in a graded
    background grid via Delaunay triangulation.  ``level`` doubles the
    resolution per increment, mirroring the reference's ``lvl1..lvl4``
    mesh families.

    Physical tags follow the bundled geometry JSONs: 1 inflow (x=0),
    2 outflow (x=length), 3 bottom wall, 4 top wall, 5 cylinder surface.

    ``control_arcs``: optional list of ``(center_angle_deg, width_deg)``
    marking cylinder-surface arcs as control boundaries (tags 6, 7, ...) —
    the native analogue of the reference's karman2D-outlets control
    segments (problem_setups.py:925-941).
    """
    from scipy.spatial import Delaunay

    cx, cy = center
    scale = 2.0 ** (level - 1)       # level 0 = extra-coarse (tests)

    # --- O-grid around the cylinder ---------------------------------------
    n_theta = int(48 * scale)
    n_rad = int(4 + 2 * scale)
    r_out = min(2.8 * radius, cy * 0.95)
    ratio = (r_out / radius) ** (1.0 / n_rad)
    radii = radius * ratio ** np.arange(n_rad + 1)
    ring_pts = []
    for k, r in enumerate(radii):
        th = np.arange(n_theta) * (2 * np.pi / n_theta)
        if k % 2 == 1:
            th = th + np.pi / n_theta  # stagger rings for quality triangles
        ring_pts.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1))
    ring_pts = np.concatenate(ring_pts, axis=0)

    # --- graded background grid -------------------------------------------
    h0 = 0.05 / scale          # coarse far-field spacing
    nx = int(round(length / h0))
    ny = int(round(height / h0))
    xs = np.linspace(0.0, length, nx + 1)
    ys = np.linspace(0.0, height, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    bg = np.stack([X.ravel(), Y.ravel()], axis=1)

    # refine a box around the cylinder + near wake with an extra fine grid
    # (linspace with snapped endpoints: arange would overshoot the channel
    # boundary at some levels and break the boundary tagging)
    fine_h = h0 / 2
    fx0, fx1 = cx - 3.2 * radius, cx + 9 * radius
    nfx = int(round((fx1 - fx0) / fine_h))
    nfy = int(round(height / fine_h))
    fxs = np.linspace(fx0, fx0 + nfx * fine_h, nfx + 1)
    fys = np.linspace(0.0, height, nfy + 1)
    FX, FY = np.meshgrid(fxs, fys, indexing="ij")
    fine = np.stack([FX.ravel(), FY.ravel()], axis=1)
    # drop fine points that coincide with coarse grid lines (dedupe later)
    bg = np.concatenate([bg, fine], axis=0)

    # drop background points inside / too close to the o-grid
    d = np.hypot(bg[:, 0] - cx, bg[:, 1] - cy)
    bg = bg[d > r_out + 0.55 * fine_h]

    pts = np.concatenate([ring_pts, bg], axis=0)
    # dedupe (fine/coarse overlap)
    pts = np.unique(np.round(pts / 1e-9) * 1e-9, axis=0)

    tri = Delaunay(pts)
    cells = tri.simplices.astype(np.int64)
    centroids = pts[cells].mean(axis=1)
    dcent = np.hypot(centroids[:, 0] - cx, centroids[:, 1] - cy)
    keep = dcent > radius
    # also drop degenerate slivers
    v = pts[cells]
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    keep &= area > 1e-14
    cells = cells[keep]

    if split_allbdry:
        # Split triangles whose three vertices ALL lie on the domain
        # boundary (centroid insertion, 1 -> 3).  Extruded to 3D, such a
        # cell can leave a corner-vertex pressure dof with an entirely
        # Dirichlet-constrained velocity patch — a zero continuity row
        # that makes the saddle matrix exactly singular (seen at the
        # Schaefer-Turek 3D-1Z corner (0,0,0)).  Off by default so the
        # established 2D benchmark meshes keep their dof counts.
        btol = 1e-9
        onb = ((np.abs(pts[:, 0]) < btol)
               | (np.abs(pts[:, 0] - length) < btol)
               | (np.abs(pts[:, 1]) < btol)
               | (np.abs(pts[:, 1] - height) < btol)
               | (np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
                  < radius * (1 + 1e-6)))
        bad = onb[cells].all(axis=1)
        if bad.any():
            cents = pts[cells[bad]].mean(axis=1)
            new0 = len(pts)
            pts = np.concatenate([pts, cents], axis=0)
            sub = []
            for k, t in enumerate(cells[bad]):
                c = new0 + k
                sub += [[t[0], t[1], c], [t[1], t[2], c], [t[2], t[0], c]]
            cells = np.concatenate(
                [cells[~bad], np.asarray(sub, dtype=np.int64)], axis=0)

    mesh = TriMesh(pts, cells)
    edges, _, _ = mesh.boundary_edges()
    mids = 0.5 * (pts[edges[:, 0]] + pts[edges[:, 1]])
    tol = 1e-9
    tags = {}
    on_circle = (
        np.hypot(pts[edges[:, 0], 0] - cx, pts[edges[:, 0], 1] - cy)
        < radius * (1 + 1e-6)
    ) & (
        np.hypot(pts[edges[:, 1], 0] - cx, pts[edges[:, 1], 1] - cy)
        < radius * (1 + 1e-6)
    )
    tags[INFLOW] = edges[np.abs(mids[:, 0]) < tol]
    tags[OUTFLOW] = edges[np.abs(mids[:, 0] - length) < tol]
    tags[WALL_BOT] = edges[(np.abs(mids[:, 1]) < tol) & (mids[:, 0] > tol)]
    tags[WALL_TOP] = edges[np.abs(mids[:, 1] - height) < tol]
    cyl_edges = edges[on_circle]
    if control_arcs:
        ang = np.degrees(np.arctan2(
            0.5 * (pts[cyl_edges[:, 0], 1] + pts[cyl_edges[:, 1], 1]) - cy,
            0.5 * (pts[cyl_edges[:, 0], 0] + pts[cyl_edges[:, 1], 0]) - cx))
        taken = np.zeros(len(cyl_edges), dtype=bool)
        for i, (ca, wa) in enumerate(control_arcs):
            d = (ang - ca + 180.0) % 360.0 - 180.0
            sel = (np.abs(d) <= wa / 2.0) & ~taken
            tags[6 + i] = cyl_edges[sel]
            taken |= sel
        tags[CYLINDER] = cyl_edges[~taken]
    else:
        tags[CYLINDER] = cyl_edges
    ntagged = sum(len(v) for v in tags.values())
    if ntagged != len(edges):
        raise RuntimeError(
            f"untagged boundary edges: {len(edges) - ntagged} of {len(edges)}"
        )
    mesh.facet_tags = tags
    return mesh
