"""ctypes binding for the native (C++) geometry compiler.

Compiles ``native/geomc.cpp`` on first use (cached as a shared library
next to the source — the same library the JAX package loads, so both
packages number the mesh edges identically); every entry point has a
numpy fallback, so the framework works without a toolchain.
"""

import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_TRIED = False


def _srcdir():
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "native"))


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_srcdir(), "geomc.cpp")
    lib = os.path.join(_srcdir(), "libgeomc.so")
    try:
        if (not os.path.exists(lib)
                or os.path.getmtime(lib) < os.path.getmtime(src)):
            # build beside the target and rename: concurrent processes
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_srcdir())
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        L = ctypes.CDLL(lib)
        L.build_edges.restype = ctypes.c_int64
        L.boundary_facets.restype = ctypes.c_int64
        _LIB = L
        logging.getLogger(__name__).info("native geometry compiler loaded")
    except Exception as e:                      # pragma: no cover
        logging.getLogger(__name__).info(
            f"native geomc unavailable ({e}); using numpy fallback")
        _LIB = None
    return _LIB


def _cptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_edges(cells: np.ndarray):
    """Unique sorted edges + per-cell edge ids + per-edge cell counts.

    Returns ``(edge_verts (ne,2), cell_edges (nc,3), edge_count (ne,))``.
    Edge ordering is first-appearance (native) or lexicographic (numpy
    fallback) — consumers must not rely on a specific order beyond
    consistency within one call.
    """
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    nc = len(cells)
    L = _load()
    if L is not None:
        edge_verts = np.empty((3 * nc, 2), dtype=np.int64)
        cell_edges = np.empty((nc, 3), dtype=np.int64)
        edge_count = np.empty(3 * nc, dtype=np.int32)
        ne = L.build_edges(_cptr(cells), ctypes.c_int64(nc),
                           _cptr(edge_verts), _cptr(cell_edges),
                           _cptr(edge_count))
        return edge_verts[:ne].copy(), cell_edges, edge_count[:ne].copy()

    # numpy fallback
    from .reference import LOCAL_EDGES

    all_edges = np.concatenate(
        [np.sort(cells[:, LOCAL_EDGES[k]], axis=1) for k in range(3)], 0)
    uniq, inv, counts = np.unique(all_edges, axis=0, return_inverse=True,
                                  return_counts=True)
    cell_edges = inv.reshape(3, nc).T.copy()
    return uniq, cell_edges, counts.astype(np.int32)


def boundary_facets(cell_edges, edge_count):
    """Owning cell + local edge index of each boundary edge."""
    cell_edges = np.ascontiguousarray(cell_edges, dtype=np.int64)
    edge_count = np.ascontiguousarray(edge_count, dtype=np.int32)
    nc = len(cell_edges)
    L = _load()
    if L is not None:
        cap = int((edge_count == 1).sum())
        bcell = np.empty(cap, dtype=np.int64)
        bloc = np.empty(cap, dtype=np.int64)
        bedge = np.empty(cap, dtype=np.int64)
        nb = L.boundary_facets(_cptr(cell_edges), _cptr(edge_count),
                               ctypes.c_int64(nc), _cptr(bcell),
                               _cptr(bloc), _cptr(bedge))
        return bcell[:nb], bloc[:nb], bedge[:nb]
    mask = edge_count[cell_edges] == 1
    cc, ll = np.nonzero(mask)
    return cc.astype(np.int64), ll.astype(np.int64), cell_edges[cc, ll]
