"""Paraview output: an XML VTU writer and a PVD time series.

Twin of the JAX package's ``utils/vtk.py`` (the reference's
``output_paraview``, data_output_utils.py:14-71, which defers to
``dolfin.File``): the P2 velocity at the mesh vertices and the P1
pressure on the triangle mesh.  Tensors on any device are written from
host copies.  Only the Taylor-Hood space is ported (the port has no
Crouzeix-Raviart space yet).
"""

import os
import xml.sax.saxutils as sax

import numpy as np

from .io import host


def write_vtu(fname, mesh, pointdata=None, celldata=None):
    """Write a triangle (or tetrahedron) mesh with named point-data arrays
    to ASCII VTU.

    ``pointdata``: dict name -> (nverts,) scalars or (nverts, 2/3) vectors.
    ``celldata``: dict name -> (ncells,) scalars.
    """
    verts = np.asarray(mesh.verts)
    cells = np.asarray(mesh.cells)
    nv, nc = len(verts), len(cells)
    gdim = verts.shape[1]
    npc = cells.shape[1] if nc else 3          # 3 = triangle, 4 = tet
    with open(fname, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{nv}" NumberOfCells="{nc}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        for row in verts:
            z = 0.0 if gdim == 2 else row[2]
            f.write(f"{row[0]} {row[1]} {z}\n")
        f.write("</DataArray></Points>\n<Cells>\n")
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        for c in cells:
            f.write(" ".join(str(int(ci)) for ci in c) + "\n")
        f.write('</DataArray>\n<DataArray type="Int32" Name="offsets" '
                'format="ascii">\n')
        for k in range(1, nc + 1):
            f.write(f"{npc * k}\n")
        f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(("5\n" if npc == 3 else "10\n") * nc)
        f.write("</DataArray>\n</Cells>\n")
        f.write("<PointData>\n")
        for name, arr in (pointdata or {}).items():
            arr = host(arr)
            if arr.ndim == 1:
                f.write(f'<DataArray type="Float64" Name="{sax.escape(name)}"'
                        ' format="ascii">\n')
                for v in arr:
                    f.write(f"{v}\n")
            else:
                f.write(f'<DataArray type="Float64" Name="{sax.escape(name)}"'
                        ' NumberOfComponents="3" format="ascii">\n')
                for row in arr:
                    z = 0.0 if arr.shape[1] == 2 else row[2]
                    f.write(f"{row[0]} {row[1]} {z}\n")
            f.write("</DataArray>\n")
        f.write("</PointData>\n")
        f.write("<CellData>\n")
        for name, arr in (celldata or {}).items():
            f.write(f'<DataArray type="Float64" Name="{sax.escape(name)}"'
                    ' format="ascii">\n')
            for v in host(arr).ravel():
                f.write(f"{v}\n")
            f.write("</DataArray>\n")
        f.write("</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


class PVDWriter:
    """``.pvd`` time-series writer with time filtering (the reference's
    ``tfilter`` subsampling, data_output_utils.py:29-35)."""

    def __init__(self, prefix, prob, tfilter=None):
        if getattr(prob.space, "scheme", "TH") != "TH":
            raise NotImplementedError(
                "PVDWriter: only the Taylor-Hood space is ported")
        self.prefix = prefix
        self.prob = prob
        self.tfilter = None if tfilter is None else list(tfilter)
        self.entries = []
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    def write(self, v_full=None, p=None, t=0.0):
        if self.tfilter is not None:
            if not self.tfilter or t < self.tfilter[0]:
                return
            self.tfilter.pop(0)
        prob = self.prob
        data = {}
        if v_full is not None:
            dim = getattr(prob.space, "dim", 2)
            # P2: the vertex dofs lead the node numbering
            data["velocity"] = host(v_full).reshape(-1, dim)[
                :prob.space.mesh.num_verts]
        if p is not None:
            p = host(p).ravel()
            if prob.geo.ppin is not None and len(p) == prob.np_cond:
                p = np.concatenate([p, [0.0]])
            data["pressure"] = p
        fname = f"{self.prefix}_{len(self.entries):06d}.vtu"
        write_vtu(fname, prob.space.mesh, data)
        self.entries.append((t, os.path.basename(fname)))

    def close(self):
        with open(self.prefix + ".pvd", "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                    'version="0.1">\n<Collection>\n')
            for t, fn in self.entries:
                f.write(f'<DataSet timestep="{t}" part="0" file="{fn}"/>\n')
            f.write("</Collection>\n</VTKFile>\n")


def output_paraview(prob=None, vp=None, vc=None, pc=None, t=None,
                    vfile=None, pfile=None, writeoutput=True, **kw):
    """Loose API-parity shim over :class:`PVDWriter`
    (reference data_output_utils.py:14-71)."""
    if not writeoutput or vfile is None:
        return
    vfile.write(v_full=vc, p=pc, t=t or 0.0)
