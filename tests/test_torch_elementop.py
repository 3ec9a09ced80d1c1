"""The element-matrix operators of the port vs the JAX package's on the
CPU in f64: ``ConvectionKernel.element_matrices`` (Picard and Newton),
``ElementOp`` / ``DivElementOp`` (the plain version of ``elem_mv``, the
counterpart of the CUDA kernel of ``csrc/elemmv.cu``) and ``elem_mv_ref``
itself, with the Dirichlet trash slot in every table; the wrapper's
checks."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops.elementop import (
    DivElementOp, ElementOp, build_element_ops)
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    DofTable, elem_mv, elem_mv_ref)

from torch_parity import align_native

torch.set_num_threads(1)
_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            jp, tp = (jax_cavity(N=4, nu=1e-2),
                      torch_cavity(N=4, nu=1e-2, device="cpu"))
        else:
            jp, tp = (jax_wake(level=0, Re=40, charvel=0.2),
                      torch_wake(level=0, Re=40, charvel=0.2, device="cpu"))
        _CACHE[name] = (jp, tp, jp.element_ops(),
                        build_element_ops(tp, device="cpu"))
    return _CACHE[name]


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _field(tp, seed):
    """A velocity field with the problem's boundary values."""
    v = np.random.default_rng(seed).normal(size=tp.nv_full)
    v[tp.bcinds] = tp.bcvals
    return v


@pytest.mark.parametrize("picard", [True, False])
@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_element_matrices_match_jax(name, picard):
    jp, tp, _, _ = _pair(name)
    v = _field(tp, 3)
    jk = jp.conv_kernel
    ref = jax.jit(lambda x: jk.element_matrices(x, picard_only=picard))(
        jnp.asarray(v))
    out = tp.conv_kernel.element_matrices(torch.as_tensor(v),
                                          picard_only=picard)
    assert tuple(out.shape) == (tp.ctx.wdet.shape[0], 6, 2, 6, 2)
    assert out.dtype == torch.float64
    assert _rel(out, ref) <= 1e-12


@pytest.mark.parametrize("op", ["M", "A", "J", "JT"])
@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_element_ops_match_jax_and_the_assembled_matrices(name, op):
    jp, tp, (jM, jA, jJ), (M, A, J) = _pair(name)
    assert isinstance(M, ElementOp) and isinstance(J, DivElementOp)
    nin, npc = len(tp.invinds), tp.np_cond
    # the trash slot is in use: some element dofs are Dirichlet dofs
    assert int((M.dofs == nin).sum()) > 0
    rng = np.random.default_rng(5)
    if op == "JT":
        q = rng.normal(size=npc)
        out, ref = J.rmatvec(torch.as_tensor(q)), jJ.rmatvec(jnp.asarray(q))
        host = sps.csr_matrix(tp.JTc) @ q
    else:
        x = rng.normal(size=nin)
        top, jop, mat = {"M": (M, jM, tp.Mc), "A": (A, jA, tp.Ac),
                         "J": (J, jJ, tp.Jc)}[op]
        out = top.matvec(torch.as_tensor(x))
        ref = jop.matvec(jnp.asarray(x))
        host = sps.csr_matrix(mat) @ x
    assert _rel(out, ref) <= 1e-13
    assert _rel(out, host) <= 1e-12


def test_scale_and_axpy():
    _, _, (jM, jA, _), (M, A, _) = _pair("cavity")
    x = np.random.default_rng(6).normal(size=M.n)
    out = M.axpy(0.25, A.scale(2.0)).matvec(torch.as_tensor(x))
    ref = jM.axpy(0.25, jA.scale(2.0)).matvec(jnp.asarray(x))
    assert _rel(out, ref) <= 1e-13


def _dense_of(E, in_ids, n_in, out_ids, n_out, transpose):
    """The assembled matrix of the element blocks (numpy, dropped ids
    skipped)."""
    Ed = E.double().numpy()
    if transpose:
        Ed = Ed.transpose(0, 2, 1)
    D = np.zeros((n_out + 1, n_in + 1))
    oi, ii = out_ids.numpy(), in_ids.numpy()
    for e in range(Ed.shape[0]):
        np.add.at(D, (oi[e][:, None], ii[e][None, :]), Ed[e])
    return D[:n_out, :n_in]


@pytest.mark.parametrize("edtype, xdtype",
                         [(torch.float64, torch.float64),
                          (torch.float32, torch.float32),
                          (torch.float64, torch.float32)])
@pytest.mark.parametrize("transpose", [False, True])
def test_elem_mv_ref_is_the_assembled_product(transpose, edtype, xdtype):
    """Random blocks on random ids with trash entries on both sides: the
    plain version is the assembled matrix's product, in ``x``'s type (the
    blocks rounded to it first)."""
    rng = np.random.default_rng(8)
    nc, r, c, n_in, n_out = 40, 3, 12, 50, 17
    if transpose:
        n_in, n_out = n_out, n_in
    E = torch.as_tensor(rng.normal(size=(nc, r, c))).to(edtype)
    ids_r = torch.as_tensor(rng.integers(0, (n_out if not transpose
                                             else n_in) + 1, size=(nc, r)))
    ids_c = torch.as_tensor(rng.integers(0, (n_in if not transpose
                                             else n_out) + 1, size=(nc, c)))
    if transpose:
        in_ids, out_ids = ids_r, ids_c
    else:
        in_ids, out_ids = ids_c, ids_r
    x = torch.as_tensor(rng.normal(size=n_in)).to(xdtype)
    y = elem_mv(E, x, DofTable(in_ids, n_in), DofTable(out_ids, n_out),
                transpose=transpose)
    assert y.dtype == xdtype and tuple(y.shape) == (n_out,)
    D = _dense_of(E.to(xdtype), in_ids, n_in, out_ids, n_out, transpose)
    ref = D @ x.double().numpy()
    tol = 1e-6 if xdtype == torch.float32 else 1e-14
    assert _rel(y.double(), ref) <= tol
    assert torch.equal(y, elem_mv_ref(E, x, DofTable(in_ids, n_in),
                                      DofTable(out_ids, n_out), transpose))


def test_elem_mv_checks_its_arguments():
    E = torch.zeros(4, 12, 12)
    tab = DofTable(torch.zeros(4, 12, dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="input table"):
        elem_mv(E, torch.zeros(6), tab, tab)
    bad = DofTable(torch.zeros(4, 3, dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="E"):
        elem_mv(E, torch.zeros(5), tab, bad)
