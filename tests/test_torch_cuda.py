"""Tests that need a CUDA card and ``nvcc``; they skip elsewhere.

This file imports torch and the port only, so it also runs on a machine
without jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``chip_smoke.py`` makes the same comparisons at full size.)
"""

import numpy as np
import pytest
import torch

from dolfin_navier_scipy_tpu_torch.models import drivencavity_problem
from dolfin_navier_scipy_tpu_torch.ops.kernels import vecmat
from dolfin_navier_scipy_tpu_torch.solve import solve_nse

NEEDS_CARD = ("needs a CUDA card: a CUDA kernel has no interpret mode; "
              "chip_smoke.py holds it against vecmat_ref on the card")


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
