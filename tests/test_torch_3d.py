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
    affine_element_terms, affine_reference_matrices)
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
