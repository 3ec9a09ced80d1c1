"""Element pipelines of the port vs the JAX package on random fields
(f64 on the CPU; the two sum in another order, hence 1e-12 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.ops.affine import AffineVectorOps as JaxAffine
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.convection import (
    convection_matrices_host, convection_vector_host)
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    conv_vector_amatvec_ref, conv_vector_ref)

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-12
_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            _CACHE[name] = (jax_cavity(N=6, Re=100),
                            torch_cavity(N=6, Re=100, device="cpu"))
        else:
            _CACHE[name] = (jax_wake(level=0, Re=100),
                            torch_wake(level=0, Re=100, device="cpu"))
    return _CACHE[name]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_convection_vector(name):
    jp, tp = _pair(name)
    rng = np.random.default_rng(10)
    u1, u2 = rng.normal(size=(2, jp.nv_full))
    for args in ((u1,), (u1, u2)):
        ref = jp.conv_kernel.vector(*[jnp.asarray(a) for a in args])
        out = tp.conv_kernel.vector(*[_t(a) for a in args])
        assert out.dtype == torch.float64
        assert _rel(out.numpy(), ref) <= RTOL
    host = convection_vector_host(tp.ctx, u1, u2).ravel()
    assert _rel(tp.conv_kernel.vector(_t(u1), _t(u2)).numpy(), host) <= RTOL


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_convection_matrices_host_consistent(name):
    _, tp = _pair(name)
    u0 = np.random.default_rng(11).normal(size=tp.nv_full)
    N1, N2, fv = convection_matrices_host(tp.ctx, u0)
    # N1(u0) u0 = (u0.grad)u0 = N2(u0) u0 = the convection vector
    assert _rel(N1 @ u0, fv.ravel()) <= RTOL
    assert _rel(N2 @ u0, fv.ravel()) <= RTOL


@pytest.mark.parametrize("name", ["cavity", "wake0"])
@pytest.mark.parametrize("sym", [True, False])
def test_vector_and_amatvec_with_facet_blocks(name, sym):
    jp, tp = _pair(name)
    u = np.random.default_rng(12).normal(size=jp.nv_full)
    jaff = JaxAffine.build(jp, jnp.float64, full_dofs=True)
    taff = AffineVectorOps.build(tp, torch.float64, full_dofs=True,
                                 device="cpu")
    assert taff.fac_elem.shape == jaff.fac_elem.shape
    if name == "wake0":
        assert taff.fac_elem.shape[0] > 0      # outflow correction blocks
    cj, aj = jp.conv_kernel.vector_and_amatvec(
        jnp.asarray(u), jp.nu, sym=sym, fac_elem=jaff.fac_elem,
        fac_vdofs=jaff.fac_vdofs)
    ct, at = tp.conv_kernel.vector_and_amatvec(
        _t(u), tp.nu, sym=sym, fac_elem=taff.fac_elem,
        fac_vdofs=taff.fac_dofs)
    assert _rel(ct.numpy(), cj) <= RTOL
    assert _rel(at.numpy(), aj) <= RTOL
    if sym:
        # on the inner rows the fused stiffness load is the assembled A
        ref = (tp.full["A"] @ u)[tp.invinds]
        assert _rel(at.numpy()[tp.invinds], ref) <= RTOL


@pytest.mark.parametrize("name", ["cavity", "wake0"])
@pytest.mark.parametrize("kind", ["m", "a", "ma", "j", "jt"])
@pytest.mark.parametrize("full_dofs", [False, True])
def test_affine_matvecs(name, kind, full_dofs):
    jp, tp = _pair(name)
    jaff = JaxAffine.build(jp, jnp.float64, full_dofs=full_dofs)
    taff = AffineVectorOps.build(tp, torch.float64, full_dofs=full_dofs,
                                 device="cpu")
    assert taff.nin == jaff.nin and taff.npc == jaff.npc
    rng = np.random.default_rng(13)
    x = rng.normal(size=taff.nin)
    q = rng.normal(size=taff.npc)
    if kind == "m":
        ref, out = jaff.m_matvec(jnp.asarray(x)), taff.m_matvec(_t(x))
    elif kind == "a":
        ref, out = jaff.a_matvec(jnp.asarray(x)), taff.a_matvec(_t(x))
    elif kind == "ma":
        ref = jaff.ma_matvec(jnp.asarray(x), 1.0, 0.005)
        out = taff.view("ma", cm=1.0, ca=0.005).matvec(_t(x))
    elif kind == "j":
        ref, out = jaff.j_matvec(jnp.asarray(x)), taff.view("j").matvec(_t(x))
    else:
        ref = jaff.jt_matvec(jnp.asarray(q))
        out = taff.view("j").rmatvec(_t(q))
    assert _rel(out.numpy(), ref) <= RTOL
    if not full_dofs:
        # and against the assembled condensed matrices
        mats = dict(m=tp.Mc @ x, a=tp.Ac @ x,
                    ma=tp.Mc @ x + 0.005 * (tp.Ac @ x), j=tp.Jc @ x,
                    jt=tp.JTc @ q)
        assert _rel(out.numpy(), mats[kind]) <= 1e-11


def test_opview_shapes_and_f32_pipeline():
    _, tp = _pair("cavity")
    aff = tp.affine_ops(torch.float32, device="cpu")
    nin, npc = len(tp.invinds), tp.np_cond
    assert aff.view("m").shape == (nin, nin)
    assert aff.view("j").shape == (npc, nin)
    x = np.random.default_rng(14).normal(size=nin)
    y = aff.view("a").matvec(_t(x))           # f64 in, f64 out, f32 inside
    assert y.dtype == torch.float64
    assert _rel(y.numpy(), tp.Ac @ x) <= 1e-5  # f32 arithmetic
    k32 = tp.conv_kernel_f32
    assert k32.wdet.dtype == torch.float32 and k32 is tp.conv_kernel_f32


def test_with_dof_map_permutes_the_state_layout():
    _, tp = _pair("cavity")
    rng = np.random.default_rng(15)
    nv = tp.nv_full
    perm = rng.permutation(nv)                 # new position of old dof i
    dofmap = np.concatenate([perm, [nv]])
    u = rng.normal(size=nv)
    up = np.empty(nv)
    up[perm] = u
    kern = tp.conv_kernel
    ref = kern.vector(_t(u)).numpy()
    out = kern.with_dof_map(dofmap).vector(_t(up)).numpy()
    assert _rel(out[perm], ref) <= RTOL


@pytest.mark.parametrize("name", ["cavity", "wake0"])
@pytest.mark.parametrize("sym", [True, False])
def test_plain_versions_match_jax_in_a_permuted_layout(name, sym):
    """``conv_vector_ref`` / ``conv_vector_amatvec_ref`` (what the CUDA
    kernel is held against on the card) vs the JAX kernel, natural and
    under a ``with_dof_map`` permutation with re-indexed facet blocks."""
    jp, tp = _pair(name)
    rng = np.random.default_rng(16)
    nv = tp.nv_full
    u, u2 = rng.normal(size=(2, nv))
    jaff = JaxAffine.build(jp, jnp.float64, full_dofs=True)
    taff = AffineVectorOps.build(tp, torch.float64, full_dofs=True,
                                 device="cpu")
    cj, aj = jp.conv_kernel.vector_and_amatvec(
        jnp.asarray(u), jp.nu, sym=sym, fac_elem=jaff.fac_elem,
        fac_vdofs=jaff.fac_vdofs)
    c2j = jp.conv_kernel.vector(jnp.asarray(u), jnp.asarray(u2))
    t = tp.conv_kernel.tables
    ct, at = conv_vector_amatvec_ref(_t(u), tp.nu, sym, t, taff.fac_elem,
                                     taff.fac_dofs)
    assert _rel(ct.numpy(), cj) <= RTOL and _rel(at.numpy(), aj) <= RTOL
    assert _rel(conv_vector_ref(_t(u), _t(u2), t).numpy(), c2j) <= RTOL

    perm = rng.permutation(nv)                 # new position of old dof i
    dofmap = torch.from_numpy(np.append(perm, nv))
    up, u2p = np.empty(nv), np.empty(nv)
    up[perm], u2p[perm] = u, u2
    tperm = tp.conv_kernel.with_dof_map(dofmap).tables
    cp, ap = conv_vector_amatvec_ref(_t(up), tp.nu, sym, tperm,
                                     taff.fac_elem,
                                     taff.fac_dofs.with_dof_map(dofmap))
    assert _rel(cp.numpy()[perm], cj) <= RTOL
    assert _rel(ap.numpy()[perm], aj) <= RTOL
    c2p = conv_vector_ref(_t(up), _t(u2p), tperm)
    assert _rel(c2p.numpy()[perm], c2j) <= RTOL
    # the same in the JAX package's own permuted kernel
    jperm = jp.conv_kernel.with_dof_map(jnp.asarray(dofmap.numpy()))
    assert _rel(c2p.numpy(), jperm.vector(jnp.asarray(up),
                                          jnp.asarray(u2p))) <= RTOL


def test_a_dof_map_may_send_dofs_to_the_dropped_slot():
    _, tp = _pair("cavity")
    nv = tp.nv_full
    u = np.random.default_rng(17).normal(size=nv)
    dropped = tp.bcinds[:7]
    dofmap = np.arange(nv + 1)
    dofmap[dropped] = nv                       # reads 0, contributes nowhere
    uz = u.copy()
    uz[dropped] = 0.0
    kern = tp.conv_kernel
    ref = kern.vector(_t(uz)).numpy()
    out = kern.with_dof_map(dofmap).vector(_t(u)).numpy()
    keep = np.setdiff1d(np.arange(nv), dropped)
    assert _rel(out[keep], ref[keep]) <= RTOL
    assert np.abs(out[dropped]).max() == 0.0


def test_element_matrices_wait_for_the_steady_slice():
    """Ported with the steady slice: the element blocks assemble into the
    host oracle's N1 (Picard) and N1 + N2 (Newton)."""
    _, tp = _pair("cavity")
    u = np.random.default_rng(1).normal(size=tp.nv_full)
    N1, N2, _ = convection_matrices_host(tp.ctx, u)
    vd = tp.space.vdofs_of_cells().reshape(-1, 12)
    for picard, ref in ((True, N1), (False, N1 + N2)):
        el = tp.conv_kernel.element_matrices(
            _t(u), picard_only=picard).reshape(-1, 12, 12).numpy()
        D = np.zeros((tp.nv_full, tp.nv_full))
        for e in range(el.shape[0]):
            D[np.ix_(vd[e], vd[e])] += el[e]
        assert np.abs(D - ref.toarray()).max() <= 1e-12 * np.abs(D).max()
