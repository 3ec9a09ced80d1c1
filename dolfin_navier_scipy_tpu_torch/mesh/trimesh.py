"""Triangle mesh container and geometry utilities (host side).

The mesh is the input to the geometry compiler
(:mod:`dolfin_navier_scipy_tpu_torch.fem.dofmap`); it plays the role of
``dolfin.Mesh`` + facet ``MeshFunction`` in the reference
(problem_setups.py:816-827) but is a plain numpy structure.
"""

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


def _cross2(a, b):
    """z-component of the cross product of 2D vectors (numpy 2.0 dropped
    ``np.cross`` for 2D operands)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


@dataclass
class TriMesh:
    """An unstructured straight-edged triangle mesh.

    Attributes
    ----------
    verts : (nv, 2) float array of vertex coordinates
    cells : (nc, 3) int array of vertex indices (counter-clockwise)
    facet_tags : dict mapping a physical-entity id to an (nf, 2) int array
        of boundary-edge vertex pairs (the analogue of the reference's
        ``_facet_region.xml`` MeshFunction).
    """

    verts: np.ndarray
    cells: np.ndarray
    facet_tags: Dict[int, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        self.verts = np.asarray(self.verts, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=np.int64)
        self._orient_ccw()

    # -- basic quantities -------------------------------------------------
    @property
    def num_verts(self):
        return self.verts.shape[0]

    @property
    def num_cells(self):
        return self.cells.shape[0]

    def _orient_ccw(self):
        """Flip cells with negative area so all are counter-clockwise."""
        v = self.verts[self.cells]
        det = _cross2(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        flip = det < 0
        if np.any(flip):
            self.cells[flip] = self.cells[flip][:, [0, 2, 1]]

    def cell_jacobians(self):
        """Affine maps: returns ``(J (nc,2,2), detJ (nc,), JinvT (nc,2,2))``."""
        v = self.verts[self.cells]
        J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        inv = np.empty_like(J)
        inv[:, 0, 0] = J[:, 1, 1]
        inv[:, 0, 1] = -J[:, 0, 1]
        inv[:, 1, 0] = -J[:, 1, 0]
        inv[:, 1, 1] = J[:, 0, 0]
        inv = inv / det[:, None, None]
        JinvT = np.transpose(inv, (0, 2, 1))
        return J, det, JinvT

    # -- boundary topology -------------------------------------------------
    def boundary_edges(self):
        """All boundary edges as (ne, 2) vertex pairs plus owning cell info.

        Returns ``(edges (ne,2), cell (ne,), local_edge (ne,))``, where
        ``local_edge`` indexes :data:`fem.reference.LOCAL_EDGES` of the
        owning cell. Edge vertex pairs are sorted ascending.
        """
        from ..fem.native import boundary_facets, build_edges

        uniq, cell_edges, counts = build_edges(self.cells)
        bcell, bloc, bedge = boundary_facets(cell_edges, counts)
        return uniq[bedge], bcell, bloc

    def tagged_facets(self, tag: int):
        """Boundary facets carrying a physical-entity ``tag``.

        Returns ``(cells (nf,), local_edges (nf,))`` of the owning cells.
        """
        if tag not in self.facet_tags:
            raise KeyError(f"no facets tagged {tag}; have {list(self.facet_tags)}")
        want = {tuple(e) for e in np.sort(self.facet_tags[tag], axis=1).tolist()}
        edges, cells, locs = self.boundary_edges()
        mask = np.array([tuple(e) in want for e in edges.tolist()])
        return cells[mask], locs[mask]

    # -- point location ----------------------------------------------------
    def locate(self, points: np.ndarray, tol: float = 1e-12):
        """Find containing cells for ``points (np,2)``.

        Returns ``(cell_ids (np,), bary (np,3))``; cell id is -1 if outside.
        Brute force (host-side, only used for point functionals like the
        reference's pressure-drop evaluation,
        steadystate_schaefer-turek_2D-1.py:104-106).
        """
        points = np.atleast_2d(points)
        v = self.verts[self.cells]  # (nc,3,2)
        out_cells = np.full(len(points), -1, dtype=np.int64)
        out_bary = np.zeros((len(points), 3))
        d = _cross2(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])  # (nc,)
        for ip, p in enumerate(points):
            b0 = _cross2(v[:, 1] - p, v[:, 2] - p) / d
            b1 = _cross2(v[:, 2] - p, v[:, 0] - p) / d
            b2 = 1.0 - b0 - b1
            ok = (b0 >= -tol) & (b1 >= -tol) & (b2 >= -tol)
            idx = np.flatnonzero(ok)
            if len(idx):
                out_cells[ip] = idx[0]
                out_bary[ip] = [b0[idx[0]], b1[idx[0]], b2[idx[0]]]
        return out_cells, out_bary

    def facet_normal(self, cell: int, local_edge: int):
        """Outward unit normal of a boundary facet of ``cell``."""
        from ..fem.reference import LOCAL_EDGES

        a, b = self.cells[cell, LOCAL_EDGES[local_edge]]
        t = self.verts[b] - self.verts[a]
        n = np.array([t[1], -t[0]])
        n /= np.linalg.norm(n)
        # orient outward: away from the opposite vertex
        opp = self.cells[cell, local_edge]
        mid = 0.5 * (self.verts[a] + self.verts[b])
        if np.dot(n, mid - self.verts[opp]) < 0:
            n = -n
        return n
