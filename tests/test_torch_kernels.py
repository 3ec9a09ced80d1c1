"""The dense inverse apply: plain version vs the Pallas kernel (interpret
mode) and numpy; the CPU route of the wrapper; the launch plan."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.ops.pallas_kernels import vecmat_pallas
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    vecmat, vecmat_plan, vecmat_ref)

torch.set_num_threads(1)


def test_vecmat_ref_matches_pallas_interpret():
    # same inputs and tolerance as tests/test_pallas.py: f32 sums of 2048
    # terms taken in another order
    rng = np.random.default_rng(0)
    m, n = 2048, 1024
    KT = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(m,)).astype(np.float32)
    y_jax = np.asarray(vecmat_pallas(jnp.asarray(x), jnp.asarray(KT),
                                     interpret=True))
    y = vecmat_ref(torch.from_numpy(x), torch.from_numpy(KT)).numpy()
    assert y.dtype == np.float32 and y.shape == (n,)
    assert np.allclose(y, y_jax, atol=2e-2, rtol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-2), (np.float64, 1e-11)])
def test_vecmat_ragged_shape_matches_numpy(dtype, atol):
    rng = np.random.default_rng(1)
    m, n = 1500, 700                      # no tile multiple anywhere
    KT = rng.normal(size=(m, n)).astype(dtype)
    x = rng.normal(size=(m,)).astype(dtype)
    ref = x.astype(np.float64) @ KT.astype(np.float64)
    y = vecmat(torch.from_numpy(x), torch.from_numpy(KT)).numpy()
    assert y.dtype == dtype and y.shape == (n,)
    assert np.allclose(y, ref, atol=atol, rtol=1e-4)


def test_vecmat_on_cpu_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(2)
    KT = torch.from_numpy(rng.normal(size=(33, 17)))
    x = torch.from_numpy(rng.normal(size=(33,)))
    before = vecmat.launches
    y = vecmat(x, KT)
    assert vecmat.launches == before
    assert torch.equal(y, vecmat_ref(x, KT))
    assert not kernels._LIBS            # nothing was built or loaded


@pytest.mark.parametrize("bad", ["shape", "dtype", "rank"])
def test_vecmat_rejects_mismatched_operands(bad):
    x, KT = torch.zeros(8), torch.zeros(8, 4)
    if bad == "shape":
        x = torch.zeros(7)
    elif bad == "dtype":
        x = x.double()
    else:
        KT = torch.zeros(8)
    with pytest.raises(ValueError):
        vecmat(x, KT)


@pytest.mark.parametrize("m,n", [(8794, 8794), (2049, 1023), (1, 1),
                                 (31, 100000), (300000, 8), (8016, 8016),
                                 (4097, 257)])
def test_vecmat_plan_covers_every_row_within_shared_memory(m, n):
    splits, rows = vecmat_plan(m, n, sm_count=132)
    assert splits >= 1 and rows >= 1
    assert splits * rows >= m                 # every row has a slab
    assert (splits - 1) * rows < m            # no slab is empty
    assert rows % 8 == 0 and rows <= 4096     # unrolled groups, 32 KB of f64
    assert splits <= 65535                    # gridDim.y


def test_vecmat_plan_fills_the_card_at_the_main_path_shape():
    splits, rows = vecmat_plan(8794, 8794, sm_count=132)
    col_tiles = -(-8794 // 256)
    assert splits * col_tiles >= 4 * 132      # several blocks per SM
    assert rows >= 64                         # slabs amortise the x staging
