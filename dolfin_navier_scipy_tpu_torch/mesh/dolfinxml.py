"""Reader for legacy dolfin XML meshes and facet-region MeshFunctions.

Parity feature: users of the reference load gmsh meshes converted to
dolfin XML (problem_setups.py:816, :827 — ``dolfin.Mesh(file)`` and
``MeshFunction('size_t', mesh, facetregionfile)``).  This module reads the
same files (optionally gzipped) into :class:`TriMesh` or
:class:`~.tetmesh.TetMesh`.
"""

import gzip
import xml.etree.ElementTree as ET

import numpy as np

from .trimesh import TriMesh


def _open_maybe_gz(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_dolfin_xml(path):
    """Read a dolfin XML mesh (``.xml`` or ``.xml.gz``).

    ``celltype='triangle'`` -> :class:`TriMesh`,
    ``celltype='tetrahedron'`` -> :class:`~.tetmesh.TetMesh` (the
    reference's general 3D path loads gmsh-converted tet meshes the same
    way, problem_setups.py:676-690)."""
    with _open_maybe_gz(path) as f:
        root = ET.parse(f).getroot()
    mesh = root.find("mesh")
    celltype = None if mesh is None else mesh.get("celltype")
    if celltype not in ("triangle", "tetrahedron"):
        raise ValueError(f"{path}: not a dolfin triangle/tet mesh")
    dim = 2 if celltype == "triangle" else 3
    vxml = mesh.find("vertices")
    nverts = int(vxml.get("size"))
    verts = np.zeros((nverts, dim))
    for v in vxml:
        i = int(v.get("index"))
        verts[i] = [float(v.get("x")), float(v.get("y"))][: dim] + (
            [float(v.get("z", 0.0))] if dim == 3 else [])
    cxml = mesh.find("cells")
    ncells = int(cxml.get("size"))
    cells = np.zeros((ncells, dim + 1), dtype=np.int64)
    vkeys = ["v0", "v1", "v2", "v3"][: dim + 1]
    for c in cxml:
        i = int(c.get("index"))
        cells[i] = [int(c.get(k)) for k in vkeys]
    if dim == 3:
        from .tetmesh import TetMesh

        return TetMesh(verts, cells)
    return TriMesh(verts, cells)


def write_dolfin_xml(mesh, path, facet_path=None):
    """Write a mesh (and optionally its facet tags as a ``mesh_function``)
    in legacy dolfin XML — interop with the reference's tooling
    (``dolfin.Mesh(file)``, problem_setups.py:816)."""
    dim = getattr(mesh, "dim", 2)
    celltype = "triangle" if dim == 2 else "tetrahedron"
    lines = ['<?xml version="1.0"?>', "<dolfin>",
             f'  <mesh celltype="{celltype}" dim="{dim}">',
             f'    <vertices size="{len(mesh.verts)}">']
    for i, v in enumerate(np.asarray(mesh.verts)):
        coords = " ".join(f'{ax}="{float(v[k])!r}"'
                          for k, ax in enumerate("xyz"[:dim]))
        lines.append(f'      <vertex index="{i}" {coords}/>')
    lines.append("    </vertices>")
    lines.append(f'    <cells size="{len(mesh.cells)}">')
    for i, c in enumerate(np.asarray(mesh.cells)):
        vs = " ".join(f'v{k}="{c[k]}"' for k in range(dim + 1))
        lines.append(f'      <{celltype} index="{i}" {vs}/>')
    lines.append("    </cells>")
    lines.extend(["  </mesh>", "</dolfin>"])
    with open(path, "w") as f:
        f.write("\n".join(lines))
    if facet_path is None:
        return
    facets = (dolfin_edge_numbering(mesh.cells) if dim == 2
              else dolfin_face_numbering(mesh.cells))
    lookup = {tuple(f): i for i, f in enumerate(facets)}
    vals = np.zeros(len(facets), dtype=np.int64)
    for tag, fl in getattr(mesh, "facet_tags", {}).items():
        for f in np.asarray(fl):
            vals[lookup[tuple(np.sort(f))]] = tag
    # self-describing ordering marker: files WE write declare the
    # lexicographic facet numbering, so the 3D reader can accept them
    # without trusting the (unvalidated-for-foreign-files) assumption;
    # dolfin itself ignores unknown attributes on read
    lines = ['<?xml version="1.0"?>', "<dolfin>",
             f'  <mesh_function type="uint" dim="{dim - 1}" '
             f'size="{len(facets)}" ordering="lexicographic">']
    for i, v in enumerate(vals):
        lines.append(f'    <entity index="{i}" value="{v}"/>')
    lines.extend(["  </mesh_function>", "</dolfin>"])
    with open(facet_path, "w") as f:
        f.write("\n".join(lines))


def dolfin_edge_numbering(cells):
    """Reconstruct the facet (edge) numbering of the reference's
    ``*_facet_region`` files.

    The bundled files (written by the gmsh→dolfin conversion pipeline the
    reference used, consumed at problem_setups.py:827) index facets in
    **lexicographic order of their ascending vertex pairs** — verified
    geometrically against every bundled mesh: all inflow edges land on
    the inlet plane, all lift-drag edges on the cylinder circle, etc.
    (see tests/test_reference_meshes.py).

    Returns ``(nedges, 2)`` vertex pairs, row ``i`` = facet ``i``.
    """
    tris = np.sort(np.asarray(cells), axis=1)
    e = np.concatenate([tris[:, [1, 2]], tris[:, [0, 2]], tris[:, [0, 1]]])
    return np.unique(e, axis=0)


def dolfin_face_numbering(cells):
    """3D analogue of :func:`dolfin_edge_numbering`: facet (triangle)
    numbering in lexicographic order of ascending vertex triples (the
    same entity-ordering rule dolfin uses in 2D, verified there against
    every bundled reference mesh)."""
    tets = np.sort(np.asarray(cells), axis=1)
    f = np.concatenate([tets[:, [1, 2, 3]], tets[:, [0, 2, 3]],
                        tets[:, [0, 1, 3]], tets[:, [0, 1, 2]]])
    return np.unique(f, axis=0)


def read_facet_region(mesh, path, lex_facets=False):
    """Attach facet tags from a dolfin facet-region ``MeshFunction`` XML.

    Handles both on-disk variants:

    * ``mesh_function`` over facets (what all of the reference's bundled
      ``*_facet_region.xml.gz`` files are): per-facet values indexed by
      dolfin's internal facet numbering, reconstructed from the mesh
      topology via :func:`dolfin_edge_numbering` (2D) /
      :func:`dolfin_face_numbering` (3D);
    * ``mesh_value_collection``: ``(cell_index, local_entity, value)``
      triples.

    Tags land in ``mesh.facet_tags``: value -> ``(k, dim)`` sorted vertex
    tuples.  The untagged value 0 is kept out (interior facets).
    """
    dim = getattr(mesh, "dim", 2)
    with _open_maybe_gz(path) as f:
        root = ET.parse(f).getroot()
    tags = {}
    mf = root.find("mesh_function")
    if mf is not None:
        if (dim == 3 and mf.get("ordering") != "lexicographic"
                and not lex_facets):
            # the lexicographic facet numbering is verified against every
            # bundled 2D reference mesh, but in 3D only against this
            # package's own writer (which stamps ordering="lexicographic");
            # a dolfin-written 3D file could number its facets otherwise
            # and silently mis-tag boundaries
            raise ValueError(
                f"{path}: a 3D facet mesh_function without an ordering "
                "declaration is refused: dolfin's 3D facet numbering is not "
                "validated against this reader's lexicographic "
                "reconstruction.  Convert the file to the (ordering-free) "
                "mesh_value_collection format, re-write it with "
                "write_dolfin_xml, or pass lex_facets=True to accept the "
                "lexicographic numbering")
        if mf.get("dim") not in (None, str(dim - 1)):
            raise ValueError(
                f"{path}: facet mesh_function must have dim={dim - 1}")
        facets = (dolfin_edge_numbering(mesh.cells) if dim == 2
                  else dolfin_face_numbering(mesh.cells))
        size = int(mf.get("size", len(facets)))
        if size != len(facets):
            raise ValueError(
                f"{path}: {size} entities vs {len(facets)} mesh facets — "
                "facet file does not match this mesh")
        for item in mf:
            val = int(item.get("value"))
            if val == 0:
                continue
            tags.setdefault(val, []).append(facets[int(item.get("index"))])
    else:
        mvc = root.find("mesh_value_collection")
        if mvc is None:
            raise ValueError(
                f"{path}: neither mesh_function nor mesh_value_collection")
        if dim == 2:
            from ..fem.reference import LOCAL_EDGES as LOCAL_FACETS
        else:
            from ..mesh.tetmesh import LOCAL_FACES as LOCAL_FACETS

        for item in mvc:
            cell = int(item.get("cell_index"))
            loc = int(item.get("local_entity"))
            val = int(item.get("value"))
            facet = mesh.cells[cell, LOCAL_FACETS[loc]]
            tags.setdefault(val, []).append(np.sort(facet))
    mesh.facet_tags = {k: np.array(v) for k, v in tags.items()}
    return mesh
