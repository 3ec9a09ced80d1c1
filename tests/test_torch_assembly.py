"""Host layer of the port vs the JAX package: same meshes, same operators."""

import numpy as np
import pytest
import torch

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)

from torch_parity import align_native

torch.set_num_threads(1)

_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            _CACHE[name] = (jax_cavity(N=6, Re=100), torch_cavity(N=6, Re=100))
        else:
            _CACHE[name] = (jax_wake(level=0, Re=100), torch_wake(level=0, Re=100))
    return _CACHE[name]


def _same_sparse(a, b, tol=1e-14):
    a, b = a.tocsr(), b.tocsr()
    a.sum_duplicates(), b.sum_duplicates()
    a.sort_indices(), b.sort_indices()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.abs(a.data - b.data).max() <= tol


@pytest.mark.parametrize("name", ["cavity", "wake0"])
@pytest.mark.parametrize("mat", ["M", "A", "J", "JT", "MP"])
def test_full_operators_equal(name, mat):
    jp, tp = _pair(name)
    _same_sparse(jp.full[mat], tp.full[mat])


@pytest.mark.parametrize("name", ["cavity", "wake0"])
@pytest.mark.parametrize("mat", ["Mc", "Ac", "Jc", "JTc", "MP"])
def test_condensed_operators_equal(name, mat):
    jp, tp = _pair(name)
    _same_sparse(getattr(jp, mat), getattr(tp, mat))


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_index_sets_and_rhs_equal(name):
    jp, tp = _pair(name)
    for k in ("invinds", "bcinds"):
        assert np.array_equal(getattr(jp, k), getattr(tp, k)), k
    for k in ("bcvals", "fv", "fp"):
        a, b = np.asarray(getattr(jp, k)), np.asarray(getattr(tp, k))
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-14, k
    assert jp.nv_full == tp.nv_full and jp.np_cond == tp.np_cond
    assert abs(jp.nu - tp.nu) <= 1e-18


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_mesh_dofmaps_and_element_tables_equal(name):
    jp, tp = _pair(name)
    assert np.array_equal(jp.space.mesh.cells, tp.space.mesh.cells)
    assert np.abs(jp.space.mesh.verts - tp.space.mesh.verts).max() == 0.0
    assert np.array_equal(jp.space.p2_dofmap, tp.space.p2_dofmap)
    for k in ("N2", "dN2", "N1", "JinvT", "wdet", "gphi2"):
        assert np.abs(getattr(jp.ctx, k) - getattr(tp.ctx, k)).max() <= 1e-14
    for k in ("M", "A", "J"):
        assert np.abs(jp.elem_tensors[k] - tp.elem_tensors[k]).max() <= 1e-14


def test_unported_discretisations_raise():
    from dolfin_navier_scipy_tpu_torch.mesh import unit_square
    from dolfin_navier_scipy_tpu_torch.models import GeoSetup, build_problem

    with pytest.raises(NotImplementedError, match="Taylor-Hood"):
        build_problem(unit_square(2), GeoSetup(), nu=1.0, scheme="CR")
    with pytest.raises(NotImplementedError, match="Robin"):
        torch_wake(level=0, Re=50, bccontrol=True)


def test_interpolate_velocity_matches():
    from dolfin_navier_scipy_tpu.fem import interpolate_velocity as ji
    from dolfin_navier_scipy_tpu_torch.fem import interpolate_velocity as ti

    jf, tf = _pair("cavity")
    jc, tc = jax_cavity(N=4, Re=10), torch_cavity(N=4, Re=10)
    v = np.random.default_rng(3).normal(size=jc.nv_full)
    a = ji(v, jc.space, jf.space)
    b = ti(v, tc.space, tf.space)
    assert np.abs(a - b).max() <= 1e-14


def test_point_evaluation_and_condense_helpers_match():
    from dolfin_navier_scipy_tpu.ops import condense as jc
    from dolfin_navier_scipy_tpu_torch.ops import condense as tc

    jp, tp = _pair("cavity")
    rng = np.random.default_rng(5)
    v = rng.normal(size=jp.nv_full)
    p = rng.normal(size=jp.space.np_full)
    pts = rng.uniform(0.05, 0.95, size=(7, 2))
    assert np.array_equal(jp.space.eval_velocity(v, pts),
                          tp.space.eval_velocity(v, pts))
    assert np.array_equal(jp.space.eval_pressure(p, pts),
                          tp.space.eval_pressure(p, pts))
    vin = v[jp.invinds]
    kw = dict(nv_full=jp.nv_full, dbcinds=[jp.bcinds], dbcvals=[jp.bcvals])
    assert np.array_equal(
        jc.append_bcs_vec(vin, invinds=jp.invinds, **kw),
        tc.append_bcs_vec(vin, invinds=tp.invinds, **kw))
    ja, jf = jc.condense_velmat(jp.full["A"], invinds=jp.invinds,
                                dbcinds=[jp.bcinds], dbcvals=[jp.bcvals])
    ta, tf = tc.condense_velmat(tp.full["A"], invinds=tp.invinds,
                                dbcinds=[tp.bcinds], dbcvals=[tp.bcvals])
    _same_sparse(ja, ta)
    assert np.array_equal(jf, tf)
    assert abs(ta - tp.Ac).max() <= 1e-14


def test_native_edge_builder_agrees_with_its_numpy_fallback():
    """The port's own loader: whichever of the two it ends up with, the
    edges are the same set and every cell points at its own three."""
    import dolfin_navier_scipy_tpu_torch.fem.native as native
    from dolfin_navier_scipy_tpu_torch.fem.reference import LOCAL_EDGES
    from dolfin_navier_scipy_tpu_torch.mesh import unit_square

    cells = unit_square(3).cells
    saved = native._LIB, native._TRIED
    try:
        native._LIB, native._TRIED = None, False
        loaded = native._load()               # builds/loads, or None
        results = [native.build_edges(cells)]
        native._LIB, native._TRIED = None, True
        results.append(native.build_edges(cells))   # numpy fallback
    finally:
        native._LIB, native._TRIED = saved
    assert loaded is None or hasattr(loaded, "build_edges")
    for uniq, cell_edges, counts in results:
        assert len(np.unique(uniq, axis=0)) == len(uniq) == 33
        for k in range(3):
            want = np.sort(cells[:, LOCAL_EDGES[k]], axis=1)
            assert np.array_equal(uniq[cell_edges[:, k]], want)
        assert counts.sum() == 3 * len(cells)
    a, b = (set(map(tuple, r[0].tolist())) for r in results)
    assert a == b
