"""The port's 3D Taylor-Hood layer (tet meshes, the dolfin-XML files, the
125-point tet rule, 3D assembly, the plain versions of B5, B9 and B10 in
3D, and ``solve_nse`` on all three saddle routes) against the JAX package
on the CPU in f64: the box of ``tests/test_3d.py`` (``unit_square(3)``
extruded to nz=3) and the Schaefer-Turek 3D-2Z wake at nz=1."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import dolfin_navier_scipy_tpu.solve.sadpnt as jsp

import dolfin_navier_scipy_tpu.fem.reference3d as jref
import dolfin_navier_scipy_tpu_torch.fem.reference3d as tref
from dolfin_navier_scipy_tpu.mesh import unit_square as jax_square
from dolfin_navier_scipy_tpu.mesh.tetmesh import (
    extrude_trimesh as jax_extrude)
from dolfin_navier_scipy_tpu.models import (
    cylinderwake3d_problem as jax_wake3d)
from dolfin_navier_scipy_tpu.models.problem import (
    GeoSetup as JaxGeo, build_problem as jax_build)
from dolfin_navier_scipy_tpu.ops.affine import AffineVectorOps as JaxAffine
from dolfin_navier_scipy_tpu.ops.assemble import (
    gradT_normal_facet_elements as jax_facet_elems)
from dolfin_navier_scipy_tpu.ops.banded_conv import (
    banded_wins as jax_banded_wins)
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu_torch.mesh import (
    extrude_trimesh, read_dolfin_xml, read_facet_region, unit_square,
    write_dolfin_xml)
from dolfin_navier_scipy_tpu_torch.models import cylinderwake3d_problem
from dolfin_navier_scipy_tpu_torch.models.problem import (
    GeoSetup, build_problem)
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.assemble import (
    gradT_normal_facet_elements)
from dolfin_navier_scipy_tpu_torch.ops.elementop import build_element_ops
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    _ELEM30_STAGE, _SMEM_PER_BLOCK, DofTable, _elem_layout, affine_fit,
    affine_element_terms, affine_mv_ref, affine_plan,
    affine_reference_matrices, affine_residual_ref, affine_slots3d,
    affine_smem3d,
    elem_fit, elem_mv_ref, elem_staged)
from dolfin_navier_scipy_tpu_torch.solve import SchurSaddleSolver, solve_nse

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-12
NU = 0.85
WAKE = dict(level=0, nz=1, nu=1e-3, charvel=1.0, paraboloid_inflow=True,
            zslip=False, length=2.5, center=(0.5, 0.2))


def _box(square, extrude, geo_cls, build, **kw):
    mesh = extrude(square(3), nz=3, height=1.0)
    exact = lambda x: (x[1] ** 2, x[2] ** 2, x[0] ** 2)  # noqa: E731
    geo = geo_cls(charlen=1.0, ppin=-1,
                  moving_wall_tags=[1, 2, 3, 4, 8, 9])
    geo.moving_wall_fns = {t: exact for t in geo.moving_wall_tags}
    return build(mesh, geo, nu=NU, charvel=1.0, **kw)


@pytest.fixture(scope="module")
def box():
    align_native()
    return (_box(jax_square, jax_extrude, JaxGeo, jax_build),
            _box(unit_square, extrude_trimesh, GeoSetup, build_problem,
                 device="cpu"))


@pytest.fixture(scope="module")
def wake():
    align_native()
    return jax_wake3d(**WAKE), cylinderwake3d_problem(device="cpu", **WAKE)


@pytest.fixture(scope="module")
def wake_affine(wake):
    """Both packages' full-dof affine tables of the wake (f64)."""
    jp, tp = wake
    return (JaxAffine.build(jp, jnp.float64, full_dofs=True),
            AffineVectorOps.build(tp, torch.float64, full_dofs=True,
                                  device="cpu"))


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_reference_elements_and_quadrature():
    for deg in (3, 5):
        for a, b in zip(tref.tet_quadrature(deg), jref.tet_quadrature(deg)):
            assert np.array_equal(a, b)
    pts, wts = tref.tet_quadrature(5)
    assert len(wts) == 125 and np.isclose(wts.sum(), 1.0 / 6.0)
    for name in ("shape_p1_3d", "dshape_p1_3d", "shape_p2_3d",
                 "dshape_p2_3d"):
        assert np.array_equal(getattr(tref, name)(pts),
                              getattr(jref, name)(pts)), name
    assert np.allclose(tref.shape_p2_3d(pts).sum(1), 1.0)
    tri = np.array([[0.2, 0.3], [0.5, 0.1]])
    for lf in range(4):
        assert np.array_equal(tref.face_points_on_tet(lf, tri),
                              jref.face_points_on_tet(lf, tri))


def test_extrusion_tags_jacobians_and_dolfin_xml(tmp_path):
    align_native()
    mj = jax_extrude(jax_square(3), nz=3, height=1.0)
    mt = extrude_trimesh(unit_square(3), nz=3, height=1.0)
    assert np.array_equal(mt.verts, mj.verts)
    assert np.array_equal(mt.cells, mj.cells)
    assert sorted(mt.facet_tags) == sorted(mj.facet_tags) == [
        1, 2, 3, 4, 8, 9]
    for tag in mt.facet_tags:
        assert np.array_equal(mt.facet_tags[tag], mj.facet_tags[tag])
        for a, b in zip(mt.tagged_facets(tag), mj.tagged_facets(tag)):
            assert np.array_equal(a, b)
    for a, b in zip(mt.cell_jacobians(), mj.cell_jacobians()):
        assert np.array_equal(a, b)
    assert np.all(mt.cell_jacobians()[1] > 0)
    cells, bary = mt.locate(np.array([[0.3, 0.4, 0.5]]))
    assert cells[0] >= 0 and np.isclose(bary.sum(), 1.0)
    # the dolfin-XML files: write, then read back the same mesh and tags
    mesh_f, facet_f = tmp_path / "box.xml", tmp_path / "box_facets.xml"
    write_dolfin_xml(mt, mesh_f, facet_f)
    back = read_facet_region(read_dolfin_xml(mesh_f), facet_f)
    assert np.array_equal(back.verts, mt.verts)
    assert np.array_equal(back.cells, mt.cells)
    for tag in mt.facet_tags:
        assert np.array_equal(np.sort(back.facet_tags[tag], axis=0),
                              np.sort(np.sort(mt.facet_tags[tag], 1), 0))
    # a 3D facet file without an ordering declaration is refused unless
    # the caller accepts the lexicographic numbering
    text = facet_f.read_text().replace(' ordering="lexicographic"', "")
    bare = tmp_path / "bare.xml"
    bare.write_text(text)
    with pytest.raises(ValueError, match="ordering"):
        read_facet_region(read_dolfin_xml(mesh_f), bare)
    again = read_facet_region(read_dolfin_xml(mesh_f), bare, lex_facets=True)
    assert sorted(again.facet_tags) == sorted(mt.facet_tags)


def test_assembly_3d_matches_jax(box, wake):
    for jp, tp in (box, wake):
        assert tp.space.dim == 3 and tp.ctx.N2.shape == (125, 10)
        assert np.array_equal(tp.invinds, jp.invinds)
        assert np.array_equal(tp.bcvals, jp.bcvals)
        for k in ("M", "A", "J", "JT", "MP"):
            d = abs(tp.full[k] - jp.full[k]).max()
            assert d <= RTOL * abs(jp.full[k]).max(), k
        for k in ("Mc", "Ac", "Jc"):
            d = abs(getattr(tp, k) - getattr(jp, k)).max()
            assert d <= RTOL * abs(getattr(jp, k)).max(), k
        assert np.abs(np.asarray(tp.fv) - np.asarray(jp.fv)).max() <= 1e-12
    # the outflow's gradient-transpose facet blocks (30 x 30)
    jp, tp = wake
    cj, ej = jax_facet_elems(jp.ctx, 2)
    ct, et = gradT_normal_facet_elements(tp.ctx, 2)
    assert np.array_equal(ct, cj) and et.shape == (len(ct), 10, 3, 10, 3)
    assert np.abs(et - ej).max() <= RTOL * np.abs(ej).max()
    # the block-Schur gate takes the JAX package's route on the wake: its
    # 0.03 GB band wins over the element pipeline (the JAX package's
    # constants, jsp._banded_bandwidth_gb and its banded_wins)
    F = sps.csr_matrix(tp.Mc + 0.5e-3 * tp.Ac)
    nvals = int(np.prod(tp.space.vdofs_of_cells().shape))
    est = jsp._banded_bandwidth_gb(F)
    want = est <= 3.0 and jax_banded_wins(est * 1e9, nvals=nvals,
                                          ndofs=F.shape[0])
    slv = SchurSaddleSolver(F, tp.Jc, tp.JTc, dtype=torch.float64,
                            index_nvals=nvals, winv=False, device="cpu")
    assert want and slv.banded


def test_convection_3d_matches_jax(wake, wake_affine):
    jp, tp = wake
    jaff, taff = wake_affine
    rng = np.random.default_rng(30)
    u1, u2 = rng.normal(size=(2, jp.nv_full))
    ref = jp.conv_kernel.vector(jnp.asarray(u1), jnp.asarray(u2))
    out = tp.conv_kernel.vector(torch.from_numpy(u1), torch.from_numpy(u2))
    assert _rel(out, ref) <= RTOL
    assert taff.fac_elem.shape == jaff.fac_elem.shape
    assert taff.fac_elem.shape[1:] == (30, 30)
    cj, aj = jp.conv_kernel.vector_and_amatvec(
        jnp.asarray(u1), jp.nu, sym=True, fac_elem=jaff.fac_elem,
        fac_vdofs=jaff.fac_vdofs)
    ct, at = tp.conv_kernel.vector_and_amatvec(
        torch.from_numpy(u1), tp.nu, sym=True, fac_elem=taff.fac_elem,
        fac_vdofs=taff.fac_dofs)
    assert _rel(ct, cj) <= RTOL and _rel(at, aj) <= RTOL
    # on the inner rows the fused stiffness load is the assembled A
    assert _rel(at.numpy()[tp.invinds], (tp.full["A"] @ u1)[tp.invinds]) \
        <= RTOL
    ej = jp.conv_kernel.element_matrices(jnp.asarray(u1))
    et = tp.conv_kernel.element_matrices(torch.from_numpy(u1))
    assert et.shape == (tp.space.mesh.num_cells, 10, 3, 10, 3)
    assert _rel(et, ej) <= RTOL


def test_affine_and_element_ops_3d_match_jax(wake, wake_affine):
    jp, tp = wake
    jaff, taff = wake_affine
    rng = np.random.default_rng(31)
    x, q = rng.normal(size=taff.nin), rng.normal(size=taff.npc)
    for kind in ("ma", "j"):
        ref = jaff.view(kind, 1.0, 0.3).matvec(jnp.asarray(x))
        out = taff.view(kind, 1.0, 0.3).matvec(torch.from_numpy(x))
        assert _rel(out, ref) <= RTOL, kind
    assert _rel(taff.jt_matvec(torch.from_numpy(q)),
                jaff.jt_matvec(jnp.asarray(q))) <= RTOL
    res = taff.saddle_residual(torch.from_numpy(x), torch.from_numpy(q),
                               1.0, 0.3)
    comp = np.concatenate([
        taff.ma_matvec(torch.from_numpy(x), 1.0, 0.3).numpy()
        + taff.jt_matvec(torch.from_numpy(q)).numpy(),
        taff.j_matvec(torch.from_numpy(x)).numpy()])
    assert _rel(res, comp) <= RTOL
    # on the inner rows 'ma' is the assembled M + 0.3 A
    inner = taff.ma_matvec(torch.from_numpy(x), 1.0, 0.3).numpy()
    full = (tp.full["M"] + 0.3 * tp.full["A"]) @ x
    assert _rel(inner[tp.invinds], full[tp.invinds]) <= RTOL
    # the 3D kernel's arithmetic (csrc/affine.cu: block_body_3d: exact
    # reference matrices contracted with JinvT and detJ) replayed in numpy
    # against the plain version's quadrature
    ref = affine_reference_matrices(taff).numpy()
    Mr, Sr, Br = ref[:100].reshape(10, 10), ref[100:1000].reshape(
        3, 3, 10, 10), ref[1000:].reshape(4, 3, 10)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    xe = torch.cat([xt, xt.new_zeros(1)])[taff.vdofs].numpy().reshape(
        -1, 10, 3)
    qe = torch.cat([qt, qt.new_zeros(1)])[taff.pdofs].numpy()
    Ji, dj = taff.JinvT.numpy(), taff.detJ.numpy()[:, None, None]
    Z = np.einsum("klab,ebd->eklad", Sr, xe)
    a = (np.einsum("edk,edl,eklac->eac", Ji, Ji, Z)
         + np.einsum("ecl,edk,eklad->eac", Ji, Ji, Z))
    fe = 0.3 * taff.nu * dj * a + dj * np.einsum("ab,ebc->eac", Mr, xe)
    want = affine_element_terms("ma", xt, taff, 1.0, 0.3).numpy()
    assert _rel(fe.reshape(want.shape), want) <= RTOL
    fj = dj[:, :, 0] * np.einsum("eck,pkb,ebc->ep", Ji, Br, xe)
    assert _rel(fj, affine_element_terms("j", xt, taff).numpy()) <= RTOL
    fjt = dj * np.einsum("eck,pka,ep->eac", Ji, Br, qe)
    want = affine_element_terms("jt", qt, taff).numpy()
    assert _rel(fjt.reshape(want.shape), want) <= RTOL
    # ElementOp at 30 dofs, DivElementOp (4 x 30) and its transpose, against
    # the JAX package's assembled operators (its build_element_ops is 2D)
    tM, tA, tJ = build_element_ops(tp, device="cpu")
    assert tM.elem.shape[1:] == (30, 30) and tJ.elem.shape[1:] == (4, 30)
    v = rng.normal(size=tM.n)
    for mat, to in ((jp.Mc, tM), (jp.Ac, tA), (jp.Jc, tJ)):
        assert _rel(to.matvec(torch.from_numpy(v)), mat @ v) <= RTOL
    p = rng.normal(size=tJ.n_p)
    assert _rel(tJ.rmatvec(torch.from_numpy(p)), jp.JTc @ p) <= RTOL


@pytest.mark.parametrize("route,refine", [("dense", 0), ("banded", 0),
                                          ("element", 1)])
def test_solve_nse_3d_box_matches_jax(box, route, refine, monkeypatch):
    jp, tp = box
    kw = dict(t0=0.0, tE=0.01, Nts=10, start_ssstokes=True)
    lin = "dense" if route == "dense" else "schur"
    if route == "element":
        # the JAX package's switch for its element path (nothing edited)
        monkeypatch.setenv("DNS_TPU_BANDED", "0")
    banded = dict(dense="auto", banded=True, element=False)[route]
    oj = jax_solve_nse(prob=jp, linsolver=lin, warm_refine=refine, **kw)
    ot = solve_nse(prob=tp, linsolver=lin, warm_refine=refine,
                   banded=banded, device="cpu", **kw)
    if route != "dense":
        assert ot["ops"].solver.banded == (route == "banded")
    assert not ot["ffflag"]
    assert _rel(ot["v"], oj["v"]) <= 1e-10, route
    assert _rel(ot["p"], oj["p"]) <= 1e-10, route


# -- the 3D kernels' schedules (csrc/elemmv.cu's staged 30-column form,
# csrc/affine.cu: block_body_3d), replayed in numpy on their plans ---------

H100_SMS = 132


def _elem_rows(part, layout):
    """Each block's tables of ``csrc/elemmv.cu`` as the kernel reads them,
    its rows in the block's element order (the order the warps take):
    ``(dids, entry in E, value position, first input position, dof row
    pointers, dofs, input positions)``."""
    for b in range(part["nblk"]):
        off, nb, nrows, nown = (int(v) for v in part["hdr"][b])
        tab = part["blob"][16 * off: 16 * off + nb]
        word = tab[: 8 * nrows].view(np.uint32).astype(np.int64)
        rp = tab[8 * nrows: 8 * nrows + 4 * (nown + 1)].view(np.int32)
        own = tab[8 * nrows + 4 * (nown + 1): 8 * (nrows + nown) + 4].view(
            np.int32)
        lin = tab[8 * (nrows + nown + 1):].view(np.uint16)
        yield (part["dids"][b], word[0::2], word[1::2] & 0xffff,
               word[1::2] >> 16, rp, own, lin)


def _elem_staged_replayed(E, x, tin, tout, tr):
    """The staged 30-column schedule in numpy (f64): the plan of an
    ``elem_mv`` of these operands on a 132-SM card; per block the
    gathered inputs, then for each warp (8 a block) its rows ``r0 + lane``
    (``r0 = 32 warp + 256 i``): the rows' 15 two-entry pieces copied into
    the warp's stage of 32 rows (row stride 30), each lane's dot from its
    stage row and its element's inputs, c ascending; each dof's rows
    summed in order.  Returns ``y`` (each dof stored once) and the plan."""
    R, C, _, sr, sc = _elem_layout(E, tr)
    layout = (R, C, sr, sc)
    assert elem_staged(layout)
    item = E.element_size()
    part, _, smem = elem_fit(
        tin.vd.numpy(), tin.nseg, tout.vd.numpy(), tout.nseg, layout,
        x.element_size(), affine_plan("elem30", E.shape[0], H100_SMS),
        stage_bytes=_ELEM30_STAGE * item)
    # the warps' stages at the end of the block's 16-byte aligned memory
    assert smem % 16 == 0 and smem <= _SMEM_PER_BLOCK
    assert smem >= 16 + part["blob_bytes"] + _ELEM30_STAGE * item
    flat, xv = E.contiguous().numpy().ravel(), x.numpy()
    y = np.full(tout.nseg, np.nan)
    for dids, entry, dst, lb, rp, own, lin in _elem_rows(part, layout):
        xs = np.where(dids >= 0, xv[np.maximum(dids, 0)], 0.0)
        sv = np.full(len(entry), np.nan)
        for warp in range(8):
            for r0 in range(32 * warp, len(entry), 256):
                nr = min(32, len(entry) - r0)
                stage = np.full((32, C), np.nan)
                i = np.arange(nr * 15)          # a warp's pieces, lane-wise
                rr, k = i // 15, i % 15
                for h in (0, 1):
                    stage[rr, 2 * k + h] = flat[entry[r0 + rr] + 2 * k + h]
                d = np.zeros(nr)
                for c in range(C):
                    d = d + stage[:nr, c] * xs[lin[lb[r0:r0 + nr] + c]]
                assert np.isnan(sv[dst[r0:r0 + nr]]).all()
                sv[dst[r0:r0 + nr]] = d
        acc, cnt = np.zeros(len(own)), np.diff(rp)
        for s in range(int(cnt.max(initial=0))):
            m = cnt > s
            acc[m] = acc[m] + sv[rp[:-1][m] + s]
        assert np.isnan(y[own]).all()
        y[own] = acc
    return y, part


@pytest.mark.parametrize("kind", ["F", "J", "JT"])
def test_elem_kernel_3d_schedule_replayed(wake, kind):
    """B10 on the 3D operands (the wake at nz=1): the 30-column operands
    (F's 30 x 30 blocks on the full velocity dofs, J's 4 x 30) take the
    staged schedule (each warp's rows copied into its stage, then a dot a
    lane), replayed in numpy on the plan's tables to 1e-15 of the plain
    version, every row and dof once; J^T (4 columns) keeps the
    row-a-thread schedule (``_replayed``)."""
    from test_torch_kernels import _replayed

    _, tp = wake
    rng = np.random.default_rng(17)
    _, _, J = build_element_ops(tp, device="cpu")
    if kind == "F":
        vd = tp.space.vdofs_of_cells()
        tab = DofTable(torch.as_tensor(vd.reshape(vd.shape[0], -1)),
                       tp.nv_full)
        E, tin, tout, tr = (torch.from_numpy(rng.normal(
            size=(vd.shape[0], 30, 30))), tab, tab, False)
    else:
        E, (tin, tout, tr) = J.elem, ((J.vtab, J.ptab, False) if kind == "J"
                                      else (J.ptab, J.vtab, True))
    x = torch.from_numpy(rng.normal(size=tin.nseg))
    R, C, _, sr, sc = _elem_layout(E, tr)
    if kind == "JT":
        assert not elem_staged((R, C, sr, sc))
        y = _replayed(E, x, tin, tout, tr, "plan")
    else:
        y, part = _elem_staged_replayed(E, x, tin, tout, tr)
        assert part["rows"] == int((tout.vd.numpy() < tout.nseg).sum())
    ref = elem_mv_ref(E, x, tin, tout, tr).numpy()
    assert np.abs(y - ref).max() <= 1e-15 * np.abs(ref).max()


def _affine3d_replayed(t, mode, x, q, cm, ca):
    """``block_body_3d``'s schedule in numpy (f64) on the plan's partition
    of a 132-SM card: per block the staged ids and geometry rows, the
    gathered values (``i = l * 36 + j``), the velocity slots a warp an
    element and lane (a, c) its slot — Z[k][m][a][c] formed by the lane,
    Z[k][m][a][d] read from lane 3 a + d (the shuffles) —, the pressure
    slots a thread an (element, node), the facet rows, the dofs' sums
    through the block's slot table (``affine_slots3d``).  Returns the
    output, each dof stored once."""
    kind = {"j": "p", "res": "res"}.get(mode, "v")
    nd, pn, nin, npc = 30, 4, t.nin, t.npc
    part, _, smem = affine_fit(
        t, kind, affine_plan(mode, t.nc, H100_SMS))
    assert smem <= _SMEM_PER_BLOCK
    ns = pn if mode == "j" else nd
    per_elem = {"j": pn, "res": 2 * nd + pn}.get(mode, nd)
    sinfo, slots, smax = affine_slots3d(part)
    assert smem == affine_smem3d(part["emax"], part["fmax"], smax, per_elem,
                                 8)
    r = affine_reference_matrices(t).numpy()
    Mr, Sr = r[:100].reshape(10, 10), r[100:1000].reshape(3, 3, 10, 10)
    Br = r[1000:].reshape(4, 3, 10)
    vd, pd = t.vtab.vd.numpy(), t.ptab.vd.numpy()
    ids = np.concatenate([vd, pd, np.full((t.nc, 2), -1)], 1)
    geo = np.concatenate([t.JinvT.numpy().reshape(t.nc, 9),
                          t.detJ.numpy()[:, None]], 1)
    kcm, kca = dict(m=(1.0, 0.0), a=(0.0, 1.0)).get(mode, (cm, ca))
    facets = mode in ("a", "ma", "res") and kca != 0.0 and t.fac_elem.shape[0]
    fv = t.fac_dofs.vd.numpy()
    fco = t.fac_elem.numpy().reshape(-1, nd)
    xv, qv = x.numpy(), q.numpy()
    xp, qp = np.append(xv, 0.0), np.append(qv, 0.0)
    lane = np.arange(32)
    a, c = np.minimum(lane, nd - 1) // 3, lane % 3
    nout = dict(j=npc, res=nin + npc).get(mode, nin)
    y = np.full(nout, np.nan)
    cnt, own = part["cnt"], part["own"]
    for b in range(part["nblk"]):
        els = part["elem"][part["eptr"][b]:part["eptr"][b + 1]]
        ne, nfac = len(els), int(cnt[b, 1])
        bid, g = ids[els], geo[els]
        xs = np.zeros((ne, 36))
        if mode != "jt":
            v = bid[:, :nd]
            xs[:, :nd] = xp[np.where((v >= 0) & (v < nin), v, nin)]
        if mode in ("jt", "res"):
            src = xp if mode == "jt" else qp
            v = bid[:, nd:nd + pn]
            xs[:, nd:nd + pn] = src[np.where((v >= 0) & (v < npc), v, npc)]
        Ji, dj = g[:, :9].reshape(ne, 3, 3), g[:, 9]
        xe = xs[:, :nd].reshape(ne, 10, 3)
        sk = np.full((ne, ns), np.nan)
        st = np.full((ne, nd), np.nan)
        sj = np.full((ne, pn), np.nan)
        if mode in ("m", "a", "ma", "res"):
            xc = xe[:, :, c]                              # (ne, 10, lane)
            fe = np.zeros((ne, 32))
            if kca != 0.0:
                zo = np.zeros((ne, 3, 3, 32))             # the lane's Z
                for bb in range(10):
                    zo = zo + Sr[:, :, a, bb][None] * xc[:, None, None, bb]
                s1, s2 = np.zeros((ne, 32)), np.zeros((ne, 32))
                for k in range(3):
                    for m in range(3):
                        kg = np.zeros(ne)
                        for d in range(3):
                            kg = kg + Ji[:, d, k] * Ji[:, d, m]
                        s1 = s1 + kg[:, None] * zo[:, k, m]
                        jz = np.zeros((ne, 32))
                        for d in range(3):
                            jz = jz + Ji[:, d, k, None] * zo[:, k, m,
                                                            3 * a + d]
                        s2 = s2 + Ji[:, c, m] * jz
                fe = kca * t.nu * dj[:, None] * (s1 + s2 if t.sym else s1)
            if kcm != 0.0:
                s = np.zeros((ne, 32))
                for bb in range(10):
                    s = s + Mr[a, bb] * xc[:, bb]
                fe = fe + kcm * dj[:, None] * s
            sk[:, :] = fe[:, :nd]
        if mode in ("jt", "res"):
            s = np.zeros((ne, 32))
            for k in range(3):
                z = np.zeros((ne, 32))
                for pp in range(pn):
                    z = z + Br[pp, k, a] * xs[:, nd + pp, None]
                s = s + Ji[:, c, k] * z
            (st if mode == "res" else sk)[:, :] = (dj[:, None] * s)[:, :nd]
        if mode in ("j", "res"):
            # thread tid takes node tid % 4 of elements tid // 4 + 64 i
            out = sk if mode == "j" else sj
            tid = np.arange(256)
            ls = (tid // pn + 64 * np.arange(-(-ne // 64))[:, None]).ravel()
            ps = np.tile(tid % pn, -(-ne // 64))
            ls, ps = ls[ls < ne], ps[ls < ne]
            s = np.zeros(len(ls))
            for k in range(3):
                for cc in range(3):
                    z = np.zeros(len(ls))
                    for bb in range(10):
                        z = z + Br[ps, k, bb] * xe[ls, bb, cc]
                    s = s + Ji[ls, cc, k] * z
            assert np.isnan(out[ls, ps]).all()
            out[ls, ps] = dj[ls] * s
        fr = part["frow"][part["fptr"][b]:part["fptr"][b + 1]]
        fvals = np.zeros(nfac)
        if facets:
            fx = xp[np.where(fv[fr // nd] < nin, fv[fr // nd], nin)]
            fvals = kca * (fco[fr] * fx).sum(1)
        vals = np.concatenate([fvals, sk.ravel()] + (
            [st.ravel(), sj.ravel()] if mode == "res" else []))
        # the block's slot table: a dof's slots in its column, in order
        nk = int(cnt[b, 3])
        tab = slots[sinfo[b, 0]:sinfo[b, 0] + sinfo[b, 1] * nk].reshape(
            -1, nk)
        for k in range(nk):
            i, col = int(own[cnt[b, 2] + k]), [int(s) for s in tab[:, k]
                                                if s >= 0]
            vel = mode != "j" and (mode != "res" or i < nin)
            acc = acc_t = 0.0
            for s in col:
                if s >= nfac:
                    acc += vals[s]
                    if mode == "res" and vel:
                        acc_t += vals[s + ne * ns]
            if vel and facets:
                for s in col:
                    if s < nfac:
                        acc += vals[s]
            assert np.isnan(y[i])
            y[i] = acc + acc_t
    return y


@pytest.mark.parametrize("mode", ["m", "a", "ma", "j", "jt", "res"])
def test_affine_kernel_3d_schedule_replayed(wake_affine, mode):
    """``csrc/affine.cu: block_body_3d``'s thread mapping replayed in numpy
    on the plan's partition (blocks never split: a 3D block's threads loop
    over its dofs) and its staging order, on the wake's full-dof tables
    (its outflow facet rows): within 1e-12 of the plain version, every
    dof and every pressure slot taken once, the block's shared memory
    within the card's."""
    _, t = wake_affine
    rng = np.random.default_rng(23)
    n = t.npc if mode == "jt" else t.nin
    x = torch.from_numpy(rng.normal(size=n))
    q = torch.from_numpy(rng.normal(size=t.npc))
    cm, ca = 1.0, 0.3
    y = _affine3d_replayed(t, mode, x, q, cm, ca)
    if mode == "res":
        ref = affine_residual_ref(x, q, t, cm, ca)
    else:
        ref = affine_mv_ref(mode, x, t, cm, ca)
    assert _rel(y, ref.numpy()) <= 1e-12
