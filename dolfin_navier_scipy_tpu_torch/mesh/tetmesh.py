"""Tetrahedral mesh container (3D problems).

Supports the reference's 3D setups (problem_setups.py:630-770
``cyl3D_fems`` and :1200-1417 ``gen_bccont_fems_3D``): extruded
cylinder-wake channels with tagged boundary faces.
"""

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

LOCAL_FACES = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
"""Local face k is opposite vertex k."""

LOCAL_EDGES_TET = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)


@dataclass
class TetMesh:
    """Straight-sided tetrahedral mesh.

    ``facet_tags``: physical-entity id -> (nf, 3) arrays of boundary-face
    vertex triples (sorted).
    """

    verts: np.ndarray
    cells: np.ndarray
    facet_tags: Dict[int, np.ndarray] = field(default_factory=dict)
    dim = 3

    def __post_init__(self):
        self.verts = np.asarray(self.verts, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=np.int64)
        self._orient_positive()

    @property
    def num_verts(self):
        return self.verts.shape[0]

    @property
    def num_cells(self):
        return self.cells.shape[0]

    def _orient_positive(self):
        v = self.verts[self.cells]
        d = np.linalg.det(
            np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 3] - v[:, 0]], axis=1))
        flip = d < 0
        if np.any(flip):
            self.cells[flip] = self.cells[flip][:, [0, 1, 3, 2]]

    def cell_jacobians(self):
        """``(J (nc,3,3), detJ (nc,), JinvT (nc,3,3))`` with
        ``x = x0 + J xi`` (columns = edge vectors)."""
        v = self.verts[self.cells]
        J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 3] - v[:, 0]], axis=2)
        det = np.linalg.det(J)
        JinvT = np.transpose(np.linalg.inv(J), (0, 2, 1))
        return J, det, JinvT

    def boundary_faces(self):
        """``(faces (nf,3) sorted triples, cell (nf,), local_face (nf,))``."""
        c = self.cells
        all_faces = np.concatenate(
            [np.sort(c[:, LOCAL_FACES[k]], axis=1) for k in range(4)], 0)
        owner_cell = np.tile(np.arange(self.num_cells), 4)
        owner_loc = np.repeat(np.arange(4), self.num_cells)
        uniq, first_idx, counts = np.unique(
            all_faces, axis=0, return_index=True, return_counts=True)
        bnd = counts == 1
        return (uniq[bnd], owner_cell[first_idx[bnd]],
                owner_loc[first_idx[bnd]])

    def tagged_facets(self, tag):
        if tag not in self.facet_tags:
            raise KeyError(f"no faces tagged {tag}; have "
                           f"{list(self.facet_tags)}")
        want = {tuple(f) for f in
                np.sort(self.facet_tags[tag], axis=1).tolist()}
        faces, cells, locs = self.boundary_faces()
        mask = np.array([tuple(f) in want for f in faces.tolist()])
        return cells[mask], locs[mask]

    def facet_normal(self, cell, local_face):
        a, b, c = self.cells[cell, LOCAL_FACES[local_face]]
        n = np.cross(self.verts[b] - self.verts[a],
                     self.verts[c] - self.verts[a])
        n = n / np.linalg.norm(n)
        opp = self.cells[cell, local_face]
        mid = self.verts[[a, b, c]].mean(0)
        if np.dot(n, mid - self.verts[opp]) < 0:
            n = -n
        return n

    def locate(self, points, tol=1e-12):
        """Containing cells + barycentric coords (brute force, host)."""
        points = np.atleast_2d(points)
        v = self.verts[self.cells]
        J, det, _ = self.cell_jacobians()
        Jinv = np.linalg.inv(J)
        out_cells = np.full(len(points), -1, dtype=np.int64)
        out_bary = np.zeros((len(points), 4))
        for ip, p in enumerate(points):
            xi = np.einsum("eij,ej->ei", Jinv, p - v[:, 0])
            b0 = 1 - xi.sum(1)
            ok = (b0 >= -tol) & np.all(xi >= -tol, axis=1) \
                & np.all(xi <= 1 + tol, axis=1)
            idx = np.flatnonzero(ok)
            if len(idx):
                out_cells[ip] = idx[0]
                out_bary[ip] = np.concatenate([[b0[idx[0]]], xi[idx[0]]])
        return out_cells, out_bary


def extrude_trimesh(mesh2d, nz=4, height=0.41, ztags=(8, 9)):
    """Extrude a 2D triangle mesh into tetrahedra (3 tets per prism).

    2D boundary-edge tags become side-face tags; the bottom/top z-planes
    get ``ztags`` (the reference's z-slip walls, problem_setups.py:700s).
    Uses the classic vertex-ordering-consistent prism split so adjacent
    prisms produce conforming tetrahedra.
    """
    from .trimesh import TriMesh  # noqa: F401

    nv2 = mesh2d.num_verts
    zs = np.linspace(0.0, height, nz + 1)
    verts = np.concatenate(
        [np.concatenate([mesh2d.verts,
                         np.full((nv2, 1), z)], axis=1) for z in zs], 0)

    def vid(layer, v2):
        return layer * nv2 + v2

    tets = []
    for lay in range(nz):
        for tri in mesh2d.cells:
            # order prism corners by global vertex id for conformity
            i, j, k = sorted(int(t) for t in tri)
            i0, j0, k0 = vid(lay, i), vid(lay, j), vid(lay, k)
            i1, j1, k1 = vid(lay + 1, i), vid(lay + 1, j), vid(lay + 1, k)
            tets.append([i0, j0, k0, i1])
            tets.append([j0, k0, i1, j1])
            tets.append([k0, i1, j1, k1])
    cells = np.array(tets, dtype=np.int64)
    m = TetMesh(verts, cells)

    # tags: side faces from 2D edge tags
    faces, fcells, flocs = m.boundary_faces()
    fverts = m.verts[faces]          # (nf,3,3)
    tags = {}
    zmid = fverts[:, :, 2].mean(1)
    onbot = np.all(np.abs(fverts[:, :, 2]) < 1e-12, axis=1)
    ontop = np.all(np.abs(fverts[:, :, 2] - height) < 1e-12, axis=1)
    tags[ztags[0]] = faces[onbot]
    tags[ztags[1]] = faces[ontop]
    side = ~(onbot | ontop)
    # classify side faces by their 2D footprint edge
    e2tag = {}
    for tag, edges in mesh2d.facet_tags.items():
        for e in np.sort(edges, axis=1).tolist():
            e2tag[tuple(e)] = tag
    for f in faces[side]:
        foot = sorted(set(int(v) % nv2 for v in f))
        assert len(foot) == 2, "side face must sit over a 2D edge"
        tag = e2tag[tuple(foot)]
        tags.setdefault(tag, []).append(f)
    for t in list(tags):
        tags[t] = np.asarray(tags[t])
    m.facet_tags = tags
    return m
