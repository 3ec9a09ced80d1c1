"""Tests that need a CUDA card and ``nvcc``; they skip elsewhere.

This file imports torch and the port only, so it also runs on a machine
without jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``chip_smoke.py`` makes the same comparisons at full size.)
"""

import numpy as np
import pytest
import torch

from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem, drivencavity_problem)
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    conv_vector, conv_vector_amatvec, conv_vector_amatvec_ref,
    conv_vector_ref, vecmat)
from dolfin_navier_scipy_tpu_torch.solve import sbdf2, solve_nse

NEEDS_CARD = ("needs a CUDA card: a CUDA kernel has no interpret mode; "
              "chip_smoke.py holds it against its plain version on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vecmat_kernel_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(4)
    # vector widths 4, 2 and 1; one slab and many; a single column
    for m, n in [(512, 1024), (2049, 1022), (700, 1501), (5000, 1), (3, 7)]:
        KT = torch.from_numpy(rng.normal(size=(m, n))).to(dtype).cuda()
        x = torch.from_numpy(rng.normal(size=(m,))).to(dtype).cuda()
        before = vecmat.launches
        y = vecmat(x, KT)
        torch.cuda.synchronize()
        assert vecmat.launches == before + 1
        ref = x.double() @ KT.double()
        tol = 1e-3 if dtype == torch.float32 else 1e-10
        assert torch.allclose(y.double(), ref, atol=tol, rtol=1e-4), (m, n)
    with pytest.raises(ValueError, match="contiguous"):
        vecmat(x, torch.zeros(7, 3, dtype=dtype, device="cuda").T)
    with pytest.raises(TypeError):
        vecmat(x.half(), KT.half())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["auto", "inner"])
def test_solve_nse_on_the_card_matches_the_cpu(layout):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = drivencavity_problem(N=8, Re=100)
    kw = dict(prob=prob, t0=0.0, tE=0.2, Nts=20, start_ssstokes=True,
              linsolver="dense", save_every=5, state_layout=layout)
    before = vecmat.launches
    out = solve_nse(**kw)                       # device=None: the card
    # full layout: one apply a step; inner: one plus one refinement round
    assert vecmat.launches - before == 19 * (1 if layout == "auto" else 2)
    ref = solve_nse(device="cpu", **kw)
    assert out["v"].is_cuda and out["ffflag"] is False
    err = (torch.linalg.vector_norm(out["v"].cpu() - ref["v"])
           / torch.linalg.vector_norm(ref["v"]))
    assert float(err) <= 1e-6


def _conv_tol(ref, tables, eps):
    # kernel and plain version sum the same products in another order:
    # 50 eps of the largest entry for each of a dof's (at most) slots
    _, rowptr, _ = tables.kernel_tables()
    most = int((rowptr[1:] - rowptr[:-1]).max())
    return 50 * eps * float(ref.abs().max()) * most


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_convection_kernel_on_the_card(name, wdtype):
    """f32 and f64 tables under an f64 and an f32 state; the cavity has no
    facet blocks, the wake has; natural and permuted dof map; two launches
    give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = (drivencavity_problem(N=8, Re=100) if name == "cavity"
            else cylinderwake_problem(level=0, Re=100))
    kern = prob.conv_kernel_on(wdtype)
    aff = AffineVectorOps.build(prob, wdtype, full_dofs=True)
    assert (aff.fac_elem.shape[0] == 0) == (name == "cavity")
    rng = np.random.default_rng(8)
    nv = prob.nv_full
    perm = rng.permutation(nv)
    dofmap = torch.from_numpy(np.append(perm, nv)).cuda()
    for udtype in (torch.float64, torch.float32):
        # the result is rounded to the state's type when that is narrower
        eps = max(torch.finfo(wdtype).eps, torch.finfo(udtype).eps)
        u, u2 = (torch.from_numpy(a).to(udtype).cuda()
                 for a in rng.normal(size=(2, nv)))
        for k, facv, x, x2 in (
                (kern, aff.fac_dofs, u, u2),
                (kern.with_dof_map(dofmap), aff.fac_dofs.with_dof_map(dofmap),
                 torch.empty_like(u).index_copy_(0, dofmap[:nv], u),
                 torch.empty_like(u2).index_copy_(0, dofmap[:nv], u2))):
            t = k.tables
            before = conv_vector.launches, conv_vector_amatvec.launches
            for sym in (True, False):
                got = conv_vector_amatvec(x, prob.nu, sym, t, aff.fac_elem,
                                          facv)
                ref = conv_vector_amatvec_ref(x, prob.nu, sym, t,
                                              aff.fac_elem, facv)
                again = conv_vector_amatvec(x, prob.nu, sym, t, aff.fac_elem,
                                            facv)
                torch.cuda.synchronize()
                for g, r, a in zip(got, ref, again):
                    assert g.dtype == udtype and torch.equal(g, a)
                    assert float((g - r).abs().max()) <= _conv_tol(r, t, eps)
            for args in ((x, None), (x, x2)):
                g, r = conv_vector(*args, t), conv_vector_ref(*args, t)
                assert torch.equal(g, conv_vector(*args, t))
                assert float((g - r).abs().max()) <= _conv_tol(r, t, eps)
            assert conv_vector.launches == before[0] + 4
            assert conv_vector_amatvec.launches == before[1] + 4
    with pytest.raises(TypeError):
        conv_vector(u.half(), None, kern.tables)
    with pytest.raises(ValueError, match="is on"):
        conv_vector(u.cpu(), None, kern.tables)


@pytest.mark.cuda
def test_sbdf2_on_the_card_matches_the_cpu_and_resumes_exactly():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = drivencavity_problem(N=8, Re=100)
    kw = dict(prob=prob, t0=0.0, tE=0.2, Nts=20, start_ssstokes=True,
              linsolver="dense", save_every=5, time_int_scheme="sbdf2")
    counts = vecmat.launches, conv_vector.launches
    out = solve_nse(**kw)                       # device=None: the card
    # inner layout, f32 work: one apply plus one refinement round a step;
    # one convection vector a step and three in the Heun bootstrap (the
    # Stokes start brings its own pressure: no pressure recovery)
    assert vecmat.launches - counts[0] == 19 * 2
    assert conv_vector.launches - counts[1] == 19 + 3
    ref = solve_nse(device="cpu", **kw)
    assert out["v"].is_cuda and out["ffflag"] is False
    err = (torch.linalg.vector_norm(out["v"].cpu() - ref["v"])
           / torch.linalg.vector_norm(ref["v"]))
    assert float(err) <= 1e-6
    trange = np.linspace(0.0, 0.2, 21)
    first = sbdf2(trange=trange[:11], prob=prob, inivel=out["iniv"],
                  linsolver="dense", save_every=0)
    second = sbdf2(trange=trange[10:], prob=prob, resume_carry=first["carry"],
                   ops=first["ops"], save_every=0)
    assert torch.equal(second["v"], out["v"])
    assert torch.equal(second["p"], out["p"])
