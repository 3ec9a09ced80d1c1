"""The banded block-Schur solver's host builders and matvec forms of the
port vs the JAX package on the CPU: the RCM band, the static-window
rectangles, the plain versions of ``banded_mv`` / ``rect_mv`` /
``rect_mv_levels`` (the CUDA kernels' references), the bf16 level stacks,
``jacobi_pcg`` and the localized W build."""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import sadpnt as jsp
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    as_band_operand, band_operand, banded_mv, pair_stack, rect_mv,
    rect_mv_levels)
from dolfin_navier_scipy_tpu_torch.solve import sadpnt as tsp

torch.set_num_threads(1)
DT = 1e-3
# plain products vs the JAX einsums: f64 work differs by summation order
# alone; f32 by f32 rounding of sums of a few thousand terms
TOL = {torch.float64: 1e-13, torch.float32: 2e-6}
_CACHE = {}


def _saddle(name):
    """``(F, J, JT)`` of the CNAB step matrix, ``F = M + dt/2 A``."""
    if name not in _CACHE:
        prob = (jax_cavity(N=8, Re=100) if name == "cavity"
                else jax_wake(level=0, Re=100, charvel=0.2))
        _CACHE[name] = (sps.csr_matrix(prob.Mc + 0.5 * DT * prob.Ac),
                        sps.csr_matrix(prob.Jc), sps.csr_matrix(prob.JTc),
                        sps.csr_matrix(prob.Ac))
    return _CACHE[name]


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_host_builders_equal_the_jax_package(name):
    F, J, JT, A = _saddle(name)
    blocks, perm, bs, nblk = tsp._build_banded(F)
    jb, jperm, jbs, jnblk = jsp._build_banded(F)
    assert (bs, nblk) == (jbs, jnblk) and np.array_equal(perm, jperm)
    assert blocks.dtype == np.float32 and np.array_equal(blocks, jb)
    assert tsp._banded_bandwidth_gb(F) == jsp._banded_bandwidth_gb(F)
    Ap = sps.csr_matrix(A[perm][:, perm])
    assert np.array_equal(tsp._fold_banded_blocks(Ap, F.shape[0], bs, nblk),
                          jsp._fold_banded_blocks(Ap, F.shape[0], bs, nblk))
    rows = np.random.default_rng(1).permutation(J.shape[0])
    for mat, ro, co, b in ((J, rows, perm, 128), (JT, perm, rows, bs)):
        got = tsp._build_banded_rect(mat, ro, co, b)
        ref = jsp._build_banded_rect(mat, ro, co, b)
        assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]


def _seeded_blocks(rng, shape, fill=0.3):
    B = rng.standard_normal(shape) * (rng.random(shape) < fill)
    return B.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [9 * 64, 9 * 64 - 37])
def test_banded_mv_plain_matches_jax(dtype, n):
    rng = np.random.default_rng(5)
    bs, nblk = 64, 9
    blocks = _seeded_blocks(rng, (nblk, bs, 3 * bs))
    x = rng.standard_normal(n).astype(_np_dtype(dtype))
    ref = np.asarray(jsp._banded_mv(jnp.asarray(blocks), jnp.asarray(x), bs,
                                    nblk, n))
    got = banded_mv(as_band_operand(blocks), torch.from_numpy(x))
    assert got.dtype == dtype and got.shape == (n,)
    assert _rel(got, ref) <= TOL[dtype]


def _rect_case(rng, nblk=6, bs=32, w=100, ncl=300, nx=None):
    blocks = _seeded_blocks(rng, (nblk, bs, w))
    bases = tuple(int(b) for b in
                  np.minimum(np.arange(nblk) * 40, ncl - w))
    return blocks, bases, ncl if nx is None else nx


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx", [300, 271])
def test_rect_mv_plain_matches_jax(dtype, nx):
    rng = np.random.default_rng(6)
    blocks, bases, ncl = _rect_case(rng)
    nrows = blocks.shape[0] * blocks.shape[1] - 5
    x = rng.standard_normal(nx).astype(_np_dtype(dtype))
    # the JAX form zero-pads x to ncl; the port reads past len(x) as zero
    ref = np.asarray(jsp._rect_mv(jnp.asarray(blocks), bases,
                                  blocks.shape[2], nrows, ncl,
                                  jnp.asarray(x)))
    got = rect_mv(as_band_operand(blocks),
                  torch.tensor(bases, dtype=torch.int32),
                  torch.from_numpy(x), nrows)
    assert got.dtype == dtype and _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("parts", [2, 3])
def test_pair_stack_equals_jax_bitwise(parts):
    rng = np.random.default_rng(7)
    blocks = rng.standard_normal((5, 16, 40)).astype(np.float32)
    ref = np.asarray(jsp._pair_stack(jnp.asarray(blocks), parts=parts)
                     .astype(jnp.float32))
    got = pair_stack(torch.from_numpy(blocks), parts=parts)
    assert got.dtype == torch.bfloat16 and got.shape == (5, parts, 16, 40)
    # the padded storage: rows 16-byte aligned
    assert got.stride(-2) * got.element_size() % 16 == 0
    flat = got.float().reshape(5, parts * 16, 40).numpy()
    assert np.array_equal(flat, ref)
    # the residual levels are not folded away (level p is ~2^-8p of level
    # 0), and the levels sum to the f32 blocks to ~8 more bits a level
    lev = got.double()
    hi = float(lev[:, 0].abs().max())
    for p in range(1, parts):
        assert float(lev[:, p].abs().max()) > 2.0 ** -(8 * p + 4) * hi, p
    err = float((lev.sum(1) - torch.from_numpy(blocks).double()).abs().max())
    assert err <= hi * 2.0 ** -(8 * parts)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("hi_only", [False, True])
def test_rect_mv_levels_plain_matches_jax(parts, hi_only):
    rng = np.random.default_rng(8)
    blocks, bases, ncl = _rect_case(rng, w=90)
    nblk, bs, w = blocks.shape
    stack = jsp._pair_stack(jnp.asarray(blocks), parts=parts)
    x = rng.standard_normal(ncl - 13).astype(np.float32)
    ref = np.asarray(jsp._rect_mv_pair(stack, bases, w, nblk * bs - 3, ncl,
                                       jnp.asarray(x), hi_only, bs))
    st = as_band_operand(torch.from_numpy(np.array(
        stack.astype(jnp.float32))).reshape(nblk, parts, bs, w),
        torch.bfloat16)
    got = rect_mv_levels(st, torch.tensor(bases, dtype=torch.int32),
                         torch.from_numpy(x), nblk * bs - 3, hi_only)
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= TOL[torch.float32]


@pytest.mark.parametrize("levels", ["f64", "f32_pair", "bf16_tri"])
def test_sapply_plain_matches_jax(levels):
    """``S^-1 g`` as one static window (base 0) of stacked levels vs the
    JAX package's ``SchurSaddleSolver._sapply``."""
    rng = np.random.default_rng(9)
    npp = 77
    S = rng.standard_normal((npp, npp))
    if levels == "f64":
        parts, g = [S], rng.standard_normal(npp)
    else:
        hi = S.astype(np.float32)
        lo = (S - hi).astype(np.float32)
        parts = [hi, lo]
        if levels == "bf16_tri":
            parts = [p.float().numpy() for p in tsp._sinv_tri(
                torch.from_numpy(hi), torch.from_numpy(lo))]
        g = rng.standard_normal(npp).astype(np.float32)
    stack = np.concatenate(parts)
    jdt = {"f64": jnp.float64, "f32_pair": jnp.float32,
           "bf16_tri": jnp.bfloat16}[levels]
    me = SimpleNamespace(Sinv=jnp.asarray(stack, jdt), np=npp)
    ref = np.asarray(jsp.SchurSaddleSolver._sapply(me, jnp.asarray(g)))
    tdt = {"f64": torch.float64, "f32_pair": torch.float32,
           "bf16_tri": torch.bfloat16}[levels]
    st = band_operand((1, len(parts), npp, npp), tdt)
    st.copy_(torch.from_numpy(stack).reshape(1, len(parts), npp, npp))
    got = rect_mv_levels(st, torch.zeros(1, dtype=torch.int32),
                         torch.from_numpy(g), npp)
    tol = TOL[torch.float64 if levels == "f64" else torch.float32]
    assert _rel(got, ref) <= tol


def test_jacobi_pcg_matches_jax():
    F, _, _, _ = _saddle("wake0")
    blocks, perm, bs, nblk = tsp._build_banded(F)
    n = F.shape[0]
    dinv = (1.0 / F.diagonal())[perm]
    rng = np.random.default_rng(10)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    jb = jnp.asarray(blocks)
    tb = as_band_operand(blocks)
    for start in (None, x0):
        ref = np.asarray(jsp.jacobi_pcg(
            lambda x: jsp._banded_mv(jb, x, bs, nblk, n), jnp.asarray(dinv),
            jnp.asarray(b), 25,
            x0=None if start is None else jnp.asarray(start)))
        got = tsp.jacobi_pcg(
            lambda x: banded_mv(tb, x), torch.from_numpy(dinv),
            torch.from_numpy(b), 25,
            x0=None if start is None else torch.from_numpy(start))
        assert _rel(got, ref) <= 1e-12
        # 25 iterations reach the solution of the permuted F
        Fp = F[perm][:, perm]
        assert np.linalg.norm(Fp @ got.numpy() - b) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("nin_off", [0, 37])
def test_winv_localized_build_matches_dense_inverse(nin_off):
    """Twin of the JAX package's test of the same name: on a synthetic
    block-tridiagonal F whose local windows are a proper subset of the
    space, the port's localized W build equals the dense inverse inside the
    window (and the JAX package's build) far below the truncation level;
    identity columns past ``nin`` stay zero."""
    rng = np.random.default_rng(3)
    bs, nblk = 128, 12
    npad = bs * nblk
    nin = npad - nin_off
    F = np.eye(npad)
    A = np.zeros((npad, npad))
    for k in range(nblk):
        d = rng.standard_normal((bs, bs)) * 0.02
        A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = d + d.T
        if k + 1 < nblk:
            o = rng.standard_normal((bs, bs)) * 0.05
            A[k * bs:(k + 1) * bs, (k + 1) * bs:(k + 2) * bs] = o
            A[(k + 1) * bs:(k + 2) * bs, k * bs:(k + 1) * bs] = o.T
    F = F * (1.0 + np.abs(A).sum(1).max()) + A
    Bblk = np.zeros((nblk, bs, 3 * bs), np.float32)
    for k in range(nblk):
        r = slice(k * bs, (k + 1) * bs)
        if k > 0:
            Bblk[k, :, :bs] = F[r, (k - 1) * bs:k * bs]
        Bblk[k, :, bs:2 * bs] = F[r, k * bs:(k + 1) * bs]
        if k + 1 < nblk:
            Bblk[k, :, 2 * bs:] = F[r, (k + 1) * bs:(k + 2) * bs]
    dinv = 1.0 / np.diag(F)
    ww = 384
    ncpw = max(npad, ww)
    wbases = tuple(min(max(k * bs + (bs - ww) // 2, 0), ncpw - ww)
                   for k in range(nblk))
    assert min(nblk, (ww + 4 * bs + bs - 1) // bs) < nblk
    W = tsp._build_winv_banded(as_band_operand(Bblk), dinv[:nin], bs, nblk,
                               nin, wbases, ww, 80)
    assert W.shape == (nblk, bs, ww) and W.dtype == torch.float32
    W = W.numpy()
    Wj = np.asarray(jsp._build_winv_banded(
        jnp.asarray(Bblk), dinv[:nin], bs, nblk, nin, wbases, ww, 80))
    assert np.abs(W - Wj).max() <= 1e-6
    Finv = np.zeros((npad, npad))
    Finv[:nin, :nin] = np.linalg.inv(F[:nin, :nin])
    err = 0.0
    for k in range(nblk):
        b = wbases[k]
        sl = Finv[k * bs:(k + 1) * bs, b:b + ww].copy()
        sl[:, max(nin - b, 0):] = 0.0
        sl[max(nin - k * bs, 0):, :] = 0.0
        Wk = W[k].copy()
        Wk[max(nin - k * bs, 0):, :] = 0.0
        err = max(err, np.abs(Wk - sl).max())
    assert err < 1e-6, err
    # the thin alias of the JAX package's subprocess build is this build
    Ws = tsp._build_winv_banded_subproc(Bblk, dinv[:nin], bs, nblk, nin,
                                        wbases, ww, 80)
    assert np.array_equal(Ws.numpy(), W)


def test_band_operand_storage():
    B = band_operand((3, 2, 5, 13), torch.bfloat16)
    assert B.shape == (3, 2, 5, 13) and B.stride(-1) == 1
    item = B.element_size()
    assert all(s * item % 16 == 0 for s in B.stride()[:-1])
    assert int(B.abs().max()) == 0
    A = torch.randn(4, 6, 7)
    C = as_band_operand(A)
    assert torch.equal(C, A) and C.stride(1) * 4 % 16 == 0
