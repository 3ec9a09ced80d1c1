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

def _locate_clipped(mesh, points, k=32, tol=1e-10):
    """Containing (or nearest) cell + barycentric coords per point.

    Candidate cells come from a KD-tree over cell centroids; among the
    candidates the cell maximizing ``min(bary)`` is chosen.  Points that
    fall outside the mesh (e.g. nodes on a finer level's curved-boundary
    approximation) get the best candidate with the barycentric
    coordinates clipped to the element — a continuous nearest-cell
    extension adequate for warm starts.  Returns ``(cells, bary,
    inside)`` with ``bary`` of shape ``(n, 3)``.
    """
    from scipy.spatial import cKDTree

    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    n = pts.shape[0]
    v = mesh.verts[mesh.cells]                       # (nc, 3, 2)
    kk = min(k, len(v))
    _, cand = cKDTree(v.mean(axis=1)).query(pts, k=kk)
    cand = cand.reshape(n, kk)
    v0 = v[cand, 0]                                  # (n, kk, 2)
    r = pts[:, None, :] - v0
    e1, e2 = v[cand, 1] - v0, v[cand, 2] - v0

    def _x2(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    det = _x2(e1, e2)
    b1 = _x2(r, e2) / det
    b2 = _x2(e1, r) / det
    bary = np.stack([1.0 - b1 - b2, b1, b2], axis=2)
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
    at every target P2 node).  2D spaces only so far; target nodes
    outside the source mesh (curved-boundary refinement mismatch) take
    clipped nearest-cell values (see :func:`_locate_clipped`).
    """
    from .reference import shape_p2

    pts = np.asarray(space_to.p2_coords, dtype=np.float64)
    cells, bary, _ = _locate_clipped(space_from.mesh, pts)
    N = shape_p2(bary[:, 1:3])                       # (n, 6)
    vloc = np.asarray(v_from, dtype=np.float64).reshape(-1, 2)[
        space_from.p2_dofmap[cells]]                 # (n, 6, 2)
    return np.einsum("nl,nld->nd", N, vloc).ravel()
