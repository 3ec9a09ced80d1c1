"""Host-side (numpy, vectorized-over-elements) assembly of the static
Stokes operators for 2D Taylor-Hood elements.

Produces the same operator set as the reference's
``dolfin_to_sparrays.get_stokessysmats`` (dolfin_to_sparrays.py:167-322):

* ``M``  velocity mass,
* ``A``  stiffness ``nu * int (grad u + grad u^T) : grad v dx`` with the
  outflow do-nothing correction ``- nu * int (grad u^T n) . v ds_out``
  (dolfin_to_sparrays.py:245-248),
* ``J``  divergence ``int q div(u) dx``, ``JT = J.T`` the gradient,
* ``MP`` pressure mass,
* optional Robin boundary-control operators ``amatrob``/``bmatrob``
  (dolfin_to_sparrays.py:277-320).

These are one-time setup costs; matrices are returned as scipy CSR and
converted to device formats by :mod:`.sparse`.  3D and Crouzeix-Raviart
elements are not ported yet.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sps

from ..fem.reference import (
    LOCAL_EDGES,
    dshape_p1,
    dshape_p2,
    edge_points_on_tri,
    edge_quadrature,
    shape_p1,
    shape_p2,
    tri_quadrature,
)


@dataclass
class AssemblyContext:
    """Precomputed per-element geometry + shape tables (quadrature deg 5).

    Everything needed by both host assembly and the device kernels;
    plain numpy, frozen after construction.  ``N2`` = velocity element
    values, ``N1`` = pressure element values.
    """

    space: "object"

    def __post_init__(self):
        space = self.space
        mesh = space.mesh
        scheme = getattr(space, "scheme", "TH")
        self.dim = getattr(space, "dim", 2)
        if (scheme, self.dim) != ("TH", 2):
            raise NotImplementedError(
                f"scheme {scheme!r} in {self.dim}D: only 2D Taylor-Hood is "
                "ported so far (3D and CR follow in a later slice)")
        self.vel_shape, self.vel_dshape = shape_p2, dshape_p2
        self.qpts, self.qwts = tri_quadrature(5)
        self.N2 = shape_p2(self.qpts)            # (Q,nvpc)
        self.dN2 = dshape_p2(self.qpts)          # (Q,nvpc,2)
        self.N1 = shape_p1(self.qpts)            # (Q,pnpc)
        self.dN1 = dshape_p1(self.qpts)          # (Q,pnpc,2)
        self.Jm, self.detJ, self.JinvT = mesh.cell_jacobians()
        # physical gradients at quad points
        self.gphi2 = np.einsum("edk,qak->eqad", self.JinvT, self.dN2)
        self.gphi1 = np.einsum("edk,qak->eqad", self.JinvT, self.dN1)
        self.wdet = self.qwts[None, :] * self.detJ[:, None]     # (nc,Q)
        # physical quad-point coordinates (for rhs functions)
        v0 = mesh.verts[mesh.cells[:, 0]]
        self.xq = v0[:, None, :] + np.einsum(
            "eij,qj->eqi", self.Jm, self.qpts
        )


def _vec_coo(space, elemtensor):
    """Scatter a per-element tensor ``(nc, 6, 2, 6, 2)`` into vector-dof COO."""
    vd = space.vdofs_of_cells()                      # (nc,6,2)
    rows = np.broadcast_to(vd[:, :, :, None, None], elemtensor.shape)
    cols = np.broadcast_to(vd[:, None, None, :, :], elemtensor.shape)
    n = space.nv_full
    return sps.coo_matrix(
        (elemtensor.ravel(), (rows.ravel(), cols.ravel())), shape=(n, n)
    ).tocsr()


def assemble_stokes(
    ctx: AssemblyContext,
    nu: float = 1.0,
    gradvsymmtrc: bool = True,
    outflow_tag=None,
    control_tags=None,
    control_shapefuns=None,
    keep_elements: bool = True,
):
    """Assemble the Stokes operator family; see module docstring.

    Notes
    -----
    With ``gradvsymmtrc=False`` we assemble the standard ``nu grad(u):grad(v)``
    (the reference assembles ``2 nu grad(u):grad(v)`` in that branch,
    dolfin_to_sparrays.py:239-245, which doubles the viscosity; we treat
    that as a quirk, not behavior to preserve).
    """
    space, mesh = ctx.space, ctx.space.mesh
    nc = mesh.num_cells
    wdet = ctx.wdet

    nvpc = ctx.N2.shape[1]
    dim = ctx.dim

    # ---- scalar velocity mass ---------------------------------------------
    Mref = np.einsum("q,qa,qb->ab", ctx.qwts, ctx.N2, ctx.N2)
    Me = ctx.detJ[:, None, None] * Mref[None]            # (nc,n,n)
    Mvec = np.zeros((nc, nvpc, dim, nvpc, dim))
    for c in range(dim):
        Mvec[:, :, c, :, c] = Me
    M = _vec_coo(space, Mvec)

    # ---- stiffness -------------------------------------------------------
    K1 = np.einsum("eq,eqad,eqbd->eab", wdet, ctx.gphi2, ctx.gphi2)
    Avec = np.zeros((nc, nvpc, dim, nvpc, dim))
    for c in range(dim):
        Avec[:, :, c, :, c] += K1
    if gradvsymmtrc:
        # nu * int (grad u + grad u^T):grad v
        Avec += np.einsum("eq,eqbi,eqaj->eaibj", wdet, ctx.gphi2,
                          ctx.gphi2)
    Avec *= nu

    # outflow do-nothing correction for the symmetrized gradient, folded
    # directly into the owning cells' element tensors
    if gradvsymmtrc and outflow_tag is not None:
        fcells, felem = gradT_normal_facet_elements(ctx, outflow_tag)
        np.add.at(Avec, fcells, -nu * felem)
    A = _vec_coo(space, Avec)

    # ---- divergence / gradient -------------------------------------------
    Je = np.einsum("eq,qa,eqbj->eabj", wdet, ctx.N1, ctx.gphi2)  # (nc,3,6,2)
    vd = space.vdofs_of_cells()
    prow = np.broadcast_to(space.p1_dofmap[:, :, None, None], Je.shape)
    vcol = np.broadcast_to(vd[:, None, :, :], Je.shape)
    J = sps.coo_matrix(
        (Je.ravel(), (prow.ravel(), vcol.ravel())),
        shape=(space.np_full, space.nv_full),
    ).tocsr()

    # ---- pressure mass -----------------------------------------------------
    MPref = np.einsum("q,qa,qb->ab", ctx.qwts, ctx.N1, ctx.N1)
    MPe = ctx.detJ[:, None, None] * MPref[None]
    prow2 = np.broadcast_to(space.p1_dofmap[:, :, None], MPe.shape)
    pcol2 = np.broadcast_to(space.p1_dofmap[:, None, :], MPe.shape)
    MP = sps.coo_matrix(
        (MPe.ravel(), (prow2.ravel(), pcol2.ravel())),
        shape=(space.np_full, space.np_full),
    ).tocsr()

    out = {"M": M, "A": A, "J": J, "JT": sps.csr_matrix(J.T), "MP": MP}
    if keep_elements:
        pnpc = ctx.N1.shape[1]
        out["_elem"] = {
            "M": Mvec.reshape(nc, dim * nvpc, dim * nvpc),
            "A": Avec.reshape(nc, dim * nvpc, dim * nvpc),
            "J": Je.reshape(nc, pnpc, dim * nvpc),
        }

    # ---- Robin boundary control ops ---------------------------------------
    if control_tags:
        amats, bvecs = [], []
        for tag, sfun in zip(control_tags, control_shapefuns):
            am, bm = assemble_robin_facets(ctx, tag, sfun)
            amats.append(am)
            bvecs.append(bm)
        amatrob = amats[0]
        for am in amats[1:]:
            amatrob = amatrob + am
        out["amatrob"] = amatrob
        out["bmatrob"] = np.hstack(bvecs)
    return out


# ---------------------------------------------------------------------------
# facet (boundary-edge) assembly helpers
# ---------------------------------------------------------------------------

def facet_quad_data(ctx: AssemblyContext, tag: int, nq: int = 3):
    """Per-facet quadrature tables for boundary integrals on ``tag``.

    Returns a dict with (nf = number of facets, Q = nq):
      ``cells (nf,)``, ``N (nf,Q,n)`` velocity traces, ``gphi`` physical
      gradients, ``w (nf,Q)`` physical weights (sum = facet measure),
      ``normal (nf,dim)`` outward normals, ``xq`` physical points.
    """
    mesh = ctx.space.mesh
    fcells, flocs = mesh.tagged_facets(tag)
    s, ws = edge_quadrature(nq)
    nvpc = ctx.N2.shape[1]
    N = np.empty((len(fcells), nq, nvpc))
    dN = np.empty((len(fcells), nq, nvpc, 2))
    xq = np.empty((len(fcells), nq, 2))
    w = np.empty((len(fcells), nq))
    normal = np.empty((len(fcells), 2))
    for le in range(3):
        sel = np.flatnonzero(flocs == le)
        if len(sel) == 0:
            continue
        refpts = edge_points_on_tri(le, s)
        N[sel] = ctx.vel_shape(refpts)[None]
        dref = ctx.vel_dshape(refpts)
        dN[sel] = np.einsum("edk,qak->eqad", ctx.JinvT[fcells[sel]], dref)
        a, b = LOCAL_EDGES[le]
        va = mesh.verts[mesh.cells[fcells[sel], a]]
        vb = mesh.verts[mesh.cells[fcells[sel], b]]
        lens = np.linalg.norm(vb - va, axis=1)
        w[sel] = ws[None, :] * lens[:, None]
        xq[sel] = va[:, None, :] * (1 - s[None, :, None]) + \
            vb[:, None, :] * s[None, :, None]
        for f in sel:
            normal[f] = mesh.facet_normal(fcells[f], le)
    return dict(cells=fcells, N=N, gphi=dN, w=w, normal=normal, xq=xq)


def gradT_normal_facet_elements(ctx: AssemblyContext, tag: int):
    """Per-facet element blocks of ``int_Gamma (grad(u)^T n) . v ds``.

    Entry ``[(a,i),(b,j)] = int d(phi_b)/dx_i * n_j * phi_a ds`` — the
    outflow correction term of dolfin_to_sparrays.py:246-248.
    Returns ``(owning_cells (nf,), elem (nf,6,2,6,2))``.
    """
    fq = facet_quad_data(ctx, tag)
    elem = np.einsum(
        "fq,fqa,fqbi,fj->faibj", fq["w"], fq["N"], fq["gphi"], fq["normal"]
    )
    return fq["cells"], elem


def _boundary_mass_elements(fq):
    """``(nf, 6, 2, 6, 2)`` vector boundary-mass blocks ``delta_ij int
    phi_a phi_b ds`` from :func:`facet_quad_data` tables."""
    me = np.einsum("fq,fqa,fqb->fab", fq["w"], fq["N"], fq["N"])
    nvpc = me.shape[1]
    elem = np.zeros(me.shape[:1] + (nvpc, 2, nvpc, 2))
    elem[:, :, 0, :, 0] = me
    elem[:, :, 1, :, 1] = me
    return elem


def robin_facet_elements(ctx: AssemblyContext, tag: int):
    """Per-facet vector boundary-mass blocks ``(cells, elem (nf,6,2,6,2))``
    — the element form of ``amatrob`` for folding into element tensors."""
    fq = facet_quad_data(ctx, tag)
    return fq["cells"], _boundary_mass_elements(fq)


def assemble_robin_facets(ctx: AssemblyContext, tag: int, shapefun):
    """Robin control operators on a tagged boundary.

    ``amatrob[(a,i),(b,j)] = delta_ij int phi_a phi_b ds`` and
    ``bmatrob[(a,i)] = int phi_a g_i(x) ds`` for the control shape
    function ``g`` (dolfin_to_sparrays.py:303-313).
    """
    space = ctx.space
    fq = facet_quad_data(ctx, tag)
    elem = _boundary_mass_elements(fq)
    vd = space.vdofs_of_cells()[fq["cells"]]
    rows = np.broadcast_to(vd[:, :, :, None, None], elem.shape)
    cols = np.broadcast_to(vd[:, None, None, :, :], elem.shape)
    n = space.nv_full
    amat = sps.coo_matrix(
        (elem.ravel(), (rows.ravel(), cols.ravel())), shape=(n, n)
    ).tocsr()

    gq = np.apply_along_axis(shapefun, -1, fq["xq"])
    be = np.einsum("fq,fqa,fqi->fai", fq["w"], fq["N"], gq)
    bvec = np.zeros(n)
    np.add.at(bvec, vd.ravel(), be.ravel())
    return amat, bvec.reshape(-1, 1)


def assemble_rhs(ctx: AssemblyContext, fv_fn=None, fp_fn=None, t=None):
    """Body-force right-hand sides (dolfin_to_sparrays.py:379-405).

    ``fv_fn(x, t) -> (2,)`` and ``fp_fn(x, t) -> float``; ``None`` means 0.
    Returns ``(fv (nv_full,1), fp (np_full,1))``.
    """
    space = ctx.space
    fv = np.zeros((space.nv_full, 1))
    fp = np.zeros((space.np_full, 1))
    if fv_fn is not None:
        vals = np.empty(ctx.xq.shape[:2] + (ctx.dim,))
        for e in range(ctx.xq.shape[0]):
            for q in range(ctx.xq.shape[1]):
                vals[e, q] = fv_fn(ctx.xq[e, q], t) if t is not None \
                    else fv_fn(ctx.xq[e, q])
        fe = np.einsum("eq,qa,eqi->eai", ctx.wdet, ctx.N2, vals)
        np.add.at(fv[:, 0], space.vdofs_of_cells().ravel(), fe.ravel())
    if fp_fn is not None:
        vals = np.empty(ctx.xq.shape[:2])
        for e in range(ctx.xq.shape[0]):
            for q in range(ctx.xq.shape[1]):
                vals[e, q] = fp_fn(ctx.xq[e, q], t) if t is not None \
                    else fp_fn(ctx.xq[e, q])
        fe = np.einsum("eq,qa,eq->ea", ctx.wdet, ctx.N1, vals)
        np.add.at(fp[:, 0], space.p1_dofmap.ravel(), fe.ravel())
    return fv, fp
