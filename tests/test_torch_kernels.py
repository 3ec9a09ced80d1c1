"""The dense inverse apply: plain version vs the Pallas kernel (interpret
mode) and numpy; the CPU route of the wrapper; the launch plan.  The
convection wrappers: the fixed-order reduction table, the kernel's index
tables, the argument checks and the CPU route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.ops.pallas_kernels import vecmat_pallas
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    conv_vector, conv_vector_amatvec, conv_vector_amatvec_ref,
    conv_vector_ref, dof_slot_table, reduce_slots_ref, vecmat, vecmat_plan,
    vecmat_ref)

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


# -- the convection wrappers --------------------------------------------------

_WAKE = {}


def _wake():
    """Wake level 0 on the CPU: ``(problem, f64 tables, full-dof affine ops
    with the outflow facet blocks)``."""
    if not _WAKE:
        prob = cylinderwake_problem(level=0, Re=100, device="cpu")
        _WAKE["v"] = (prob, prob.conv_kernel.tables,
                      AffineVectorOps.build(prob, torch.float64,
                                            full_dofs=True, device="cpu"))
    return _WAKE["v"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dof_slot_table_is_a_fixed_order_add_at(dtype):
    _, t, _ = _wake()
    rng = np.random.default_rng(5)
    ids = t.vd.numpy().copy()
    ids[rng.random(ids.shape) < 0.05] = t.nv_full     # dropped padding slot
    rowptr, slots = dof_slot_table(ids, t.nv_full)
    assert rowptr.dtype == np.int32 and slots.dtype == np.int32
    assert rowptr[0] == 0 and rowptr[-1] == len(slots)
    assert len(slots) == int((ids < t.nv_full).sum())
    flat = ids.ravel()
    for i in rng.integers(0, t.nv_full, size=50):
        mine = slots[rowptr[i]:rowptr[i + 1]]
        assert np.array_equal(mine, np.flatnonzero(flat == i))  # ascending
    vals = rng.normal(size=flat.shape).astype(dtype)
    out = reduce_slots_ref(torch.from_numpy(vals), torch.from_numpy(rowptr),
                           torch.from_numpy(slots))
    ref = np.zeros(t.nv_full + 1, dtype)
    np.add.at(ref, flat, vals)             # sequential, in index order
    assert np.array_equal(out.numpy(), ref[: t.nv_full])        # bitwise
    again = reduce_slots_ref(torch.from_numpy(vals),
                             torch.from_numpy(rowptr),
                             torch.from_numpy(slots))
    assert torch.equal(out, again)


def test_kernel_tables_index_the_scratch_buffer():
    _, t, aff = _wake()
    vd32, rowptr, slots = t.kernel_tables()
    assert all(a.dtype == torch.int32 for a in (vd32, rowptr, slots))
    assert torch.equal(vd32.long(), t.vd) and vd32.is_contiguous()
    # slot k of dof i is the flat position e*nd + j with vd[e, j] == i
    owner = t.vd.reshape(-1)[slots.long()]
    assert torch.equal(owner, torch.repeat_interleave(
        torch.arange(t.nv_full), (rowptr[1:] - rowptr[:-1]).long()))
    assert t.kernel_tables()[2] is slots                    # built once
    # the facet blocks' table is built once too, on the object that the
    # operator bundle keeps
    f1 = aff.fac_dofs.kernel_tables()
    assert aff.fac_dofs.kernel_tables()[0] is f1[0]
    assert torch.equal(f1[0].long(), aff.fac_vdofs)
    assert int(f1[1][-1]) == aff.fac_vdofs.numel()
    # the plain version's weight matrices appear at its first call only
    fresh = t.with_vd(t.vd)
    fresh._plain = None
    conv_vector(torch.zeros(t.nv_full, dtype=torch.float64), None, fresh)
    assert fresh._plain is not None and fresh.plain_weights()[0].shape == (
        t.nd, t.dim * t.Q)
    # a re-indexed layout gets tables of its own
    perm = np.random.default_rng(6).permutation(t.nv_full)
    t2 = t.with_vd(torch.from_numpy(np.append(perm, t.nv_full))[t.vd])
    assert not torch.equal(t2.kernel_tables()[2], slots)
    assert torch.equal(t.kernel_tables()[2], slots)


def test_conv_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    prob, t, aff = _wake()
    rng = np.random.default_rng(7)
    u1, u2 = (torch.from_numpy(a) for a in rng.normal(size=(2, t.nv_full)))
    before = conv_vector.launches, conv_vector_amatvec.launches
    assert torch.equal(conv_vector(u1, None, t), conv_vector_ref(u1, None, t))
    assert torch.equal(conv_vector(u1, u2, t), conv_vector_ref(u1, u2, t))
    out = conv_vector_amatvec(u1, prob.nu, True, t, aff.fac_elem,
                              aff.fac_dofs)
    ref = conv_vector_amatvec_ref(u1, prob.nu, True, t, aff.fac_elem,
                                  aff.fac_dofs)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    # the fused form's convection half is the plain convection vector
    assert torch.equal(out[0], conv_vector(u1, None, t))
    assert (conv_vector.launches,
            conv_vector_amatvec.launches) == before
    assert "convection" not in kernels._LIBS    # nothing built or loaded
    # f32 tables under an f64 state: f32 arithmetic, f64 result
    t32 = prob.conv_kernel_f32.tables
    y = conv_vector(u1, None, t32)
    assert y.dtype == torch.float64
    err = (y - out[0]).abs().max() / out[0].abs().max()
    assert 0 < float(err) <= 1e-5


@pytest.mark.parametrize("bad", ["length", "rank", "u2_dtype", "u2_length",
                                 "facet_shape", "facet_ids", "not_a_tensor"])
def test_conv_wrappers_reject_mismatched_operands(bad):
    prob, t, aff = _wake()
    u = torch.zeros(t.nv_full, dtype=torch.float64)
    fe, fv = aff.fac_elem, aff.fac_dofs
    with pytest.raises(ValueError):
        if bad == "length":
            conv_vector(u[:-1], None, t)
        elif bad == "rank":
            conv_vector_amatvec(u[:, None], prob.nu, True, t)
        elif bad == "u2_dtype":
            conv_vector(u, u.float(), t)
        elif bad == "u2_length":
            conv_vector(u, u[:-2], t)
        elif bad == "facet_shape":
            conv_vector_amatvec(u, prob.nu, True, t, fe[:, :-1], fv)
        elif bad == "facet_ids":
            conv_vector_amatvec(u, prob.nu, True, t, fe, None)
        else:
            conv_vector(u.numpy(), None, t)


def test_conv_amatvec_wants_the_facet_dofs_as_a_table():
    """A bare index tensor would have its kernel tables rebuilt per call:
    the wrapper refuses it and names the wrapper class."""
    prob, t, aff = _wake()
    u = torch.zeros(t.nv_full, dtype=torch.float64)
    with pytest.raises(TypeError, match="DofTable"):
        conv_vector_amatvec(u, prob.nu, True, t, aff.fac_elem, aff.fac_vdofs)
    inner = AffineVectorOps.build(prob, torch.float64, device="cpu")
    with pytest.raises(ValueError):        # a table over the inner dofs
        conv_vector_amatvec(u, prob.nu, True, t, inner.fac_elem,
                            inner.fac_dofs)
