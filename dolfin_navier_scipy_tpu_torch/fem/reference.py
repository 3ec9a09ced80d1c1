"""Reference-element shape functions and quadrature on triangles.

All computations are host-side numpy (one-time geometry compilation); the
resulting tables are shipped to the device as constant tensors.

Conventions
-----------
Reference triangle: vertices ``(0,0), (1,0), (0,1)``; barycentric
coordinates ``L0 = 1-x-y, L1 = x, L2 = y``.

P2 node ordering: ``[v0, v1, v2, e0, e1, e2]`` where edge ``k`` is the edge
*opposite* vertex ``k``: ``e0=(v1,v2), e1=(v0,v2), e2=(v0,v1)``.

Quadrature weights include the reference-triangle area (they sum to 1/2),
so an integral is ``sum_q w_q * f(x_q) * |det J|`` with the affine map
Jacobian determinant.
"""

import numpy as np

LOCAL_EDGES = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int64)
"""Local edge -> local vertex pair; edge k is opposite vertex k."""


def tri_quadrature(degree: int):
    """Symmetric Gauss rules on the reference triangle.

    Returns ``(points (Q,2), weights (Q,))`` with weights summing to 1/2,
    exact for polynomials up to ``degree``.
    """
    if degree <= 1:
        pts = np.array([[1 / 3, 1 / 3]])
        wts = np.array([1.0])
    elif degree == 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        wts = np.array([1 / 3, 1 / 3, 1 / 3])
    elif degree in (3, 4):
        # Dunavant degree-4, 6 points
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        pts = np.array([
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
        ])
        wts = np.array([w1, w1, w1, w2, w2, w2])
    elif degree == 5:
        # Dunavant degree-5, 7 points (exact closed forms)
        s15 = np.sqrt(15.0)
        b1 = (6 + s15) / 21
        b2 = (6 - s15) / 21
        w1 = (155 + s15) / 1200
        w2 = (155 - s15) / 1200
        pts = np.array([
            [1 / 3, 1 / 3],
            [b1, b1], [1 - 2 * b1, b1], [b1, 1 - 2 * b1],
            [b2, b2], [1 - 2 * b2, b2], [b2, 1 - 2 * b2],
        ])
        wts = np.array([9 / 40, w1, w1, w1, w2, w2, w2])
    elif degree <= 7:
        # Gauss-tensor rule collapsed onto the triangle (Duffy), exact >= 7.
        # 8x8 tensor rule is plenty; used only for verification, not hot.
        gp, gw = np.polynomial.legendre.leggauss(8)
        gp = 0.5 * (gp + 1.0)
        gw = 0.5 * gw
        X, Y = np.meshgrid(gp, gp, indexing="ij")
        W = np.outer(gw, gw)
        # Duffy: (u, v) in unit square -> (u, v(1-u)), jacobian (1-u)
        px = X
        py = Y * (1 - X)
        pw = W * (1 - X)
        pts = np.stack([px.ravel(), py.ravel()], axis=1)
        wts = pw.ravel() * 2.0  # normalize so that wts sum to 1
    else:
        raise NotImplementedError(f"triangle quadrature degree {degree}")
    return pts, wts * 0.5


def edge_quadrature(npoints: int = 3):
    """Gauss-Legendre rule on [0,1]: ``(points (Q,), weights (Q,))``.

    Weights sum to 1; exact for degree ``2*npoints - 1``.
    """
    gp, gw = np.polynomial.legendre.leggauss(npoints)
    return 0.5 * (gp + 1.0), 0.5 * gw


def shape_p1(pts):
    """P1 shape functions at reference points ``pts (Q,2)`` -> ``(Q,3)``."""
    x, y = pts[:, 0], pts[:, 1]
    return np.stack([1 - x - y, x, y], axis=1)


def dshape_p1(pts):
    """P1 reference gradients -> ``(Q,3,2)`` (constant in the point)."""
    q = len(pts)
    d = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    return np.broadcast_to(d, (q, 3, 2)).copy()


def shape_p2(pts):
    """P2 shape functions at reference points -> ``(Q,6)``."""
    x, y = pts[:, 0], pts[:, 1]
    l0, l1, l2 = 1 - x - y, x, y
    return np.stack(
        [
            l0 * (2 * l0 - 1),
            l1 * (2 * l1 - 1),
            l2 * (2 * l2 - 1),
            4 * l1 * l2,   # edge opposite v0
            4 * l0 * l2,   # edge opposite v1
            4 * l0 * l1,   # edge opposite v2
        ],
        axis=1,
    )


def dshape_p2(pts):
    """P2 reference gradients -> ``(Q,6,2)``."""
    x, y = pts[:, 0], pts[:, 1]
    l0 = 1 - x - y
    zeros = np.zeros_like(x)
    # d l0 = (-1,-1), d l1 = (1,0), d l2 = (0,1)
    d = np.empty((len(pts), 6, 2))
    d[:, 0, 0] = -(4 * l0 - 1)
    d[:, 0, 1] = -(4 * l0 - 1)
    d[:, 1, 0] = 4 * x - 1
    d[:, 1, 1] = zeros
    d[:, 2, 0] = zeros
    d[:, 2, 1] = 4 * y - 1
    d[:, 3, 0] = 4 * y
    d[:, 3, 1] = 4 * x
    d[:, 4, 0] = -4 * y
    d[:, 4, 1] = 4 * (l0 - y)
    d[:, 5, 0] = 4 * (l0 - x)
    d[:, 5, 1] = -4 * x
    return d


def edge_points_on_tri(local_edge: int, s):
    """Map edge parameters ``s in [0,1]`` to reference-triangle coords.

    The edge runs from ``LOCAL_EDGES[e][0]`` to ``LOCAL_EDGES[e][1]``.
    Returns ``(Q,2)``.
    """
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    a, b = LOCAL_EDGES[local_edge]
    s = np.asarray(s)[:, None]
    return verts[a] * (1 - s) + verts[b] * s
