"""Reference elements and quadrature on tetrahedra (P2/P1 Taylor-Hood).

Conventions: reference tet vertices ``(0,0,0),(1,0,0),(0,1,0),(0,0,1)``;
barycentric ``L0 = 1-x-y-z, L1 = x, L2 = y, L3 = z``.  P2 node order:
``[v0..v3, e01, e02, e03, e12, e13, e23]`` (edges as in
:data:`..mesh.tetmesh.LOCAL_EDGES_TET`).
"""

import numpy as np

from ..mesh.tetmesh import LOCAL_EDGES_TET, LOCAL_FACES


def tet_quadrature(degree: int = 5):
    """Duffy-collapsed Gauss tensor rule on the reference tet.

    Exact for polynomials up to ``degree`` (the collapse adds jacobian
    degree <= 2 per axis; the per-axis Gauss order covers it).  Weights
    sum to 1/6 (the reference-tet volume).
    """
    n = max(3, (degree + 3) // 2 + 1)
    gp, gw = np.polynomial.legendre.leggauss(n)
    gp = 0.5 * (gp + 1.0)
    gw = 0.5 * gw
    pts, wts = [], []
    for iu, u in enumerate(gp):
        for iv, v in enumerate(gp):
            for iw, w in enumerate(gp):
                # Duffy: x=u, y=v(1-u), z=w(1-u)(1-v)
                x = u
                y = v * (1 - u)
                z = w * (1 - u) * (1 - v)
                jac = (1 - u) ** 2 * (1 - v)
                pts.append([x, y, z])
                wts.append(gw[iu] * gw[iv] * gw[iw] * jac)
    return np.asarray(pts), np.asarray(wts)


def shape_p1_3d(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([1 - x - y - z, x, y, z], axis=1)


def dshape_p1_3d(pts):
    d = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    return np.broadcast_to(d, (len(pts), 4, 3)).copy()


def _bary(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([1 - x - y - z, x, y, z], axis=1)


def shape_p2_3d(pts):
    L = _bary(pts)
    out = [L[:, i] * (2 * L[:, i] - 1) for i in range(4)]
    for a, b in LOCAL_EDGES_TET:
        out.append(4 * L[:, a] * L[:, b])
    return np.stack(out, axis=1)                    # (Q,10)


def dshape_p2_3d(pts):
    L = _bary(pts)
    dL = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    q = len(pts)
    d = np.zeros((q, 10, 3))
    for i in range(4):
        d[:, i, :] = (4 * L[:, i, None] - 1) * dL[i]
    for m, (a, b) in enumerate(LOCAL_EDGES_TET):
        d[:, 4 + m, :] = 4 * (L[:, a, None] * dL[b] + L[:, b, None] * dL[a])
    return d


def face_points_on_tet(local_face: int, pts2d):
    """Map 2D reference-triangle points to tet reference coords on a face."""
    verts = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    a, b, c = LOCAL_FACES[local_face]
    r, s = pts2d[:, 0:1], pts2d[:, 1:2]
    return verts[a] * (1 - r - s) + verts[b] * r + verts[c] * s
