"""Taylor-Hood (P2/P1) dof maps and boundary-dof classification.

This is the host-side "geometry compiler": from a :class:`TriMesh` it
produces static index arrays that drive all device kernels.  It replaces
dolfin's FunctionSpace/DirichletBC machinery used in the reference
(problem_setups.py:818-825 builds CG2/CG1 spaces; :850-923 extracts
Dirichlet dofs via ``DirichletBC.get_boundary_values()``).

Velocity dof numbering: ``vdof = 2 * p2node + component`` (interleaved).
Pressure dofs are the P1 vertex indices.
"""

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from .reference import LOCAL_EDGES


@dataclass
class TaylorHoodSpace:
    """P2 velocity / P1 pressure function spaces on a triangle mesh.

    Attribute names keep the P2/P1 convention (``p2_dofmap`` = velocity
    node map, ``p1_dofmap`` = pressure node map), so all assembly/ops
    code is element-agnostic.
    """

    scheme = "TH"
    dim = 2
    mesh: "object"
    # filled by __post_init__:
    p2_dofmap: np.ndarray = field(init=False)   # (nc, 6) P2 node ids
    p1_dofmap: np.ndarray = field(init=False)   # (nc, 3) = mesh.cells
    p2_coords: np.ndarray = field(init=False)   # (n_p2, 2)
    n_p2: int = field(init=False)
    edge_to_node: dict = field(init=False)

    def __post_init__(self):
        from .native import build_edges

        mesh = self.mesh
        cells = mesh.cells
        nc, nv = mesh.num_cells, mesh.num_verts

        # unique edges -> midpoint nodes (native C++ compiler when built)
        uniq, cell_edges, _ = build_edges(cells)
        n_edges = len(uniq)
        self.n_p2 = nv + n_edges
        edge_nodes = nv + cell_edges                 # (nc, 3)

        self.p2_dofmap = np.concatenate([cells, edge_nodes], axis=1)
        self.p1_dofmap = cells
        mids = 0.5 * (mesh.verts[uniq[:, 0]] + mesh.verts[uniq[:, 1]])
        self.p2_coords = np.concatenate([mesh.verts, mids], axis=0)
        self.edge_to_node = {tuple(e): nv + i for i, e in enumerate(uniq.tolist())}

    # -- sizes --------------------------------------------------------------
    @property
    def nv_full(self) -> int:
        """Number of velocity dofs (2 components per P2 node)."""
        return 2 * self.n_p2

    @property
    def np_full(self) -> int:
        """Number of pressure dofs."""
        return self.mesh.num_verts

    # -- velocity dof helpers -------------------------------------------------
    def vdofs_of_cells(self) -> np.ndarray:
        """Velocity dof map per cell: ``(nc, 6, 2)`` with interleaved dofs."""
        nodes = self.p2_dofmap  # (nc, 6)
        return np.stack([2 * nodes, 2 * nodes + 1], axis=2)

    def boundary_nodes(self, tag: int) -> np.ndarray:
        """P2 nodes (vertices + edge midpoints) on facets tagged ``tag``."""
        mesh = self.mesh
        cells_, locs = mesh.tagged_facets(tag)
        nodes = set()
        for c, le in zip(cells_, locs):
            a, b = mesh.cells[c, LOCAL_EDGES[le]]
            nodes.add(int(a))
            nodes.add(int(b))
            key = (min(a, b), max(a, b))
            nodes.add(self.edge_to_node[key])
        return np.array(sorted(nodes), dtype=np.int64)

    def dirichlet_dofs(self, tag: int, value_fn) -> Dict[int, float]:
        """Dirichlet dofs+values on a tagged boundary.

        ``value_fn(x) -> (2,)`` is evaluated at the P2 node coordinates
        (matching dolfin's CG2 interpolation of boundary expressions).
        Returns {vdof: value}.
        """
        out = {}
        for node in self.boundary_nodes(tag):
            val = np.asarray(value_fn(self.p2_coords[node]))
            out[2 * node] = float(val[0])
            out[2 * node + 1] = float(val[1])
        return out

    # -- evaluation (host) -----------------------------------------------------
    def eval_pressure(self, p: np.ndarray, points) -> np.ndarray:
        """Point-evaluate a P1 pressure field (e.g. the DFG Delta-p)."""
        cells_, bary = self.mesh.locate(np.atleast_2d(points))
        if np.any(cells_ < 0):
            raise ValueError("point outside mesh")
        vals = (np.asarray(p)[self.p1_dofmap[cells_]] * bary).sum(axis=1)
        return vals

    def eval_velocity(self, v: np.ndarray, points) -> np.ndarray:
        """Point-evaluate a P2 velocity field; ``v`` is interleaved (nv_full,)."""
        from .reference import shape_p2

        pts = np.atleast_2d(points)
        cells_, bary = self.mesh.locate(pts)
        if np.any(cells_ < 0):
            raise ValueError("point outside mesh")
        ref = np.stack([bary[:, 1], bary[:, 2]], axis=1)
        out = np.zeros((len(pts), 2))
        v2 = np.asarray(v).reshape(-1, 2)
        for i, (c, rp) in enumerate(zip(cells_, ref)):
            N = shape_p2(rp[None, :])[0]  # (6,)
            out[i] = N @ v2[self.p2_dofmap[c]]
        return out


# -- mesh-continuation interpolation (host, one-time setup) -----------------

@dataclass
class TaylorHoodSpace3D:
    """P2/P1 Taylor-Hood on tetrahedra (reference 3D setups,
    problem_setups.py:630-770, :1200-1417).

    Velocity dof = ``3 * p2node + component``.
    """

    scheme = "TH"
    dim = 3
    mesh: "object"
    p2_dofmap: np.ndarray = field(init=False)
    p1_dofmap: np.ndarray = field(init=False)
    p2_coords: np.ndarray = field(init=False)
    n_p2: int = field(init=False)
    edge_to_node: dict = field(init=False)

    def __post_init__(self):
        from ..mesh.tetmesh import LOCAL_EDGES_TET

        mesh = self.mesh
        cells = mesh.cells
        nc, nv = mesh.num_cells, mesh.num_verts
        all_edges = np.concatenate(
            [np.sort(cells[:, e], axis=1) for e in LOCAL_EDGES_TET], 0)
        uniq, inv = np.unique(all_edges, axis=0, return_inverse=True)
        self.n_p2 = nv + len(uniq)
        edge_nodes = nv + inv.reshape(6, nc).T
        self.p2_dofmap = np.concatenate([cells, edge_nodes], axis=1)
        self.p1_dofmap = cells
        mids = 0.5 * (mesh.verts[uniq[:, 0]] + mesh.verts[uniq[:, 1]])
        self.p2_coords = np.concatenate([mesh.verts, mids], axis=0)
        self.edge_to_node = {tuple(e): nv + i
                             for i, e in enumerate(uniq.tolist())}

    @property
    def nv_full(self):
        return 3 * self.n_p2

    @property
    def np_full(self):
        return self.mesh.num_verts

    def vdofs_of_cells(self):
        nodes = self.p2_dofmap
        return np.stack([3 * nodes, 3 * nodes + 1, 3 * nodes + 2], axis=2)

    def boundary_nodes(self, tag):
        from ..mesh.tetmesh import LOCAL_FACES

        mesh = self.mesh
        cells_, locs = mesh.tagged_facets(tag)
        nodes = set()
        for c, lf in zip(cells_, locs):
            tri = mesh.cells[c, LOCAL_FACES[lf]]
            for v in tri:
                nodes.add(int(v))
            for a, b in ((0, 1), (0, 2), (1, 2)):
                key = (min(tri[a], tri[b]), max(tri[a], tri[b]))
                nodes.add(self.edge_to_node[key])
        return np.array(sorted(nodes), dtype=np.int64)

    def dirichlet_dofs(self, tag, value_fn, components=(0, 1, 2)):
        """{vdof: value}; ``components`` restricts to selected velocity
        components (z-slip walls constrain only one component,
        problem_setups.py 3D setups)."""
        out = {}
        for node in self.boundary_nodes(tag):
            val = np.asarray(value_fn(self.p2_coords[node]))
            for c in components:
                out[3 * node + c] = float(val[c])
        return out

    def eval_pressure(self, p, points):
        cells_, bary = self.mesh.locate(np.atleast_2d(points))
        if np.any(cells_ < 0):
            raise ValueError("point outside mesh")
        return (np.asarray(p)[self.p1_dofmap[cells_]] * bary).sum(axis=1)

    def eval_velocity(self, v, points):
        from .reference3d import shape_p2_3d

        pts = np.atleast_2d(points)
        cells_, bary = self.mesh.locate(pts)
        if np.any(cells_ < 0):
            raise ValueError("point outside mesh")
        ref = bary[:, 1:4]
        out = np.zeros((len(pts), 3))
        v3 = np.asarray(v).reshape(-1, 3)
        for i, (c, rp) in enumerate(zip(cells_, ref)):
            N = shape_p2_3d(rp[None, :])[0]
            out[i] = N @ v3[self.p2_dofmap[c]]
        return out


def _locate_clipped(mesh, points, k=32, tol=1e-10):
    """Containing (or nearest) cell + barycentric coords per point.

    Candidate cells come from a KD-tree over cell centroids; among the
    candidates the cell maximizing ``min(bary)`` is chosen.  Points that
    fall outside the mesh (e.g. nodes on a finer level's curved-boundary
    approximation) get the best candidate with the barycentric
    coordinates clipped to the element — a continuous nearest-cell
    extension adequate for warm starts.  Returns ``(cells, bary,
    inside)`` with ``bary`` of shape ``(n, d+1)``.
    """
    from scipy.spatial import cKDTree

    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    n, d = pts.shape
    v = mesh.verts[mesh.cells]                       # (nc, d+1, d)
    kk = min(k, len(v))
    _, cand = cKDTree(v.mean(axis=1)).query(pts, k=kk)
    cand = cand.reshape(n, kk)
    v0 = v[cand, 0]                                  # (n, kk, d)
    r = pts[:, None, :] - v0
    if d == 2:
        e1, e2 = v[cand, 1] - v0, v[cand, 2] - v0

        def _x2(a, b):
            return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

        det = _x2(e1, e2)
        b1 = _x2(r, e2) / det
        b2 = _x2(e1, r) / det
        bary = np.stack([1.0 - b1 - b2, b1, b2], axis=2)
    else:
        E = np.stack([v[cand, j] - v0 for j in (1, 2, 3)], axis=3)
        xi = np.linalg.solve(E, r[..., None])[..., 0]
        bary = np.concatenate([1.0 - xi.sum(-1, keepdims=True), xi],
                              axis=2)
    score = bary.min(axis=2)                         # (n, kk)
    best = score.argmax(axis=1)
    rows = np.arange(n)
    cells = cand[rows, best]
    b = np.clip(bary[rows, best], 0.0, None)
    b /= b.sum(axis=1, keepdims=True)
    return cells, b, score[rows, best] >= -tol


def interpolate_velocity(v_from, space_from, space_to):
    """P2-interpolate a velocity field between Taylor-Hood spaces.

    The mesh-continuation device: solve on a coarse level,
    interpolate, and hand the result to ``solve_steadystate_nse(...,
    vel_start_nwtn=...)`` on the fine level — Newton then converges in
    a couple of iterations where a cold start needs a full
    Picard+Newton sweep.  (The reference only has parameter
    continuation: Re-continuation in tests/steadystate_generic.py:16-50
    and nu-continuation in tests/steadystate_rotcyl.py:90-102; mesh
    continuation has no counterpart there.)

    ``v_from`` is the interleaved full-dof velocity on ``space_from``;
    returns the interleaved full-dof velocity on ``space_to`` (evaluate
    at every target P2 node).  Works for 2D and 3D spaces; target nodes
    outside the source mesh (curved-boundary refinement mismatch) take
    clipped nearest-cell values (see :func:`_locate_clipped`).
    """
    from .reference import shape_p2
    from .reference3d import shape_p2_3d

    pts = np.asarray(space_to.p2_coords, dtype=np.float64)
    d = pts.shape[1]
    cells, bary, _ = _locate_clipped(space_from.mesh, pts)
    if d == 2:
        N = shape_p2(bary[:, 1:3])                   # (n, 6)
    else:
        N = shape_p2_3d(bary[:, 1:4])                # (n, 10)
    vloc = np.asarray(v_from, dtype=np.float64).reshape(-1, d)[
        space_from.p2_dofmap[cells]]                 # (n, nloc, d)
    return np.einsum("nl,nld->nd", N, vloc).ravel()
