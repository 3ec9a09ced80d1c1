"""The banded convection tail of the port (``ops/banded_conv.py``) vs the
JAX package on the CPU: the element order, the windows and the 0/1
patterns of S and G, the tail's vector in f32 and f64, the gate, the
element-permuted kernel, and a w-space ``cnab`` that takes the tail; the
card's slot form (``_slot_tail``, built on the CPU): its slot table against S's band, its
ordered sum against an emulation of the int8 band product it replaces
(bit for bit), its vector against the JAX tail."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.ops import banded_conv as jax_bc
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops import banded_conv as bc
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    conv_tail, conv_tail_ref, rect_mv_ref, tail_sum_ref)
from dolfin_navier_scipy_tpu_torch.solve import cnab

from torch_parity import align_native

torch.set_num_threads(1)
_CACHE = {}


def _wspace(name):
    """Both packages' problems, w-space-mapped kernels (f32 and f64) and
    the w-space bc values, as the JAX package's own test builds them."""
    if name in _CACHE:
        return _CACHE[name]
    align_native()
    if name == "cavity":
        jp, tp = (jax_cavity(N=12, nu=1e-2),
                  torch_cavity(N=12, nu=1e-2, device="cpu"))
    else:
        jp, tp = (jax_wake(level=0, Re=100, charvel=0.2),
                  torch_wake(level=0, Re=100, charvel=0.2, device="cpu"))
    F = sps.csr_matrix(jp.Mc + 0.5 * 1e-3 * jp.Ac)
    perm = np.asarray(reverse_cuthill_mckee(F, symmetric_mode=True))
    nin, nv_full = F.shape[0], jp.nv_full
    bcdofs = np.setdiff1d(np.arange(nv_full), np.asarray(jp.invinds))
    wsrc = np.concatenate([np.asarray(jp.invinds)[perm],
                           bcdofs]).astype(np.int64)
    iposx = np.full(nv_full + 1, nv_full, np.int32)
    iposx[wsrc] = np.arange(nv_full, dtype=np.int32)
    out = dict(
        jp=jp, tp=tp, nin=nin,
        vbc=np.asarray(jp.bc_full_vec()).ravel()[wsrc],
        j32=jp.conv_kernel_f32.with_dof_map(jnp.asarray(iposx)),
        j64=jp.conv_kernel.with_dof_map(jnp.asarray(iposx)),
        t32=tp.conv_kernel_f32.with_dof_map(torch.as_tensor(iposx)),
        t64=tp.conv_kernel.with_dof_map(torch.as_tensor(iposx)))
    _CACHE[name] = out
    return out


def _state(w, seed=3):
    """A w-space state: a random interior and the real constant bc tail."""
    v = w["vbc"].copy()
    v[:w["nin"]] = np.random.default_rng(seed).standard_normal(w["nin"])
    return v


def _tails(name):
    key = ("tails", name)
    if key not in _CACHE:
        w = _wspace(name)
        tail = w["vbc"][w["nin"]:]
        _CACHE[key] = (
            jax_bc.build_banded_conv_tail(w["j32"], w["nin"], tail,
                                          force=True),
            bc.build_banded_conv_tail(w["t32"], w["nin"], tail, force=True))
    return _CACHE[key]


def _slot_tail(name):
    """The card's form of the tail, built on the CPU."""
    key = ("slots", name)
    if key not in _CACHE:
        w = _wspace(name)
        _CACHE[key] = bc._slot_tail(w["t32"], w["nin"],
                                    w["vbc"][w["nin"]:])
    return _CACHE[key]


def _band_rows(tt):
    """S's f32 band as rows ``(nin, w)`` and each row's window start."""
    nin, bs = tt.nin, tt.Sb.shape[1]
    B = tt.Sb.numpy().reshape(-1, tt.Sb.shape[2])[:nin]
    base = np.asarray(tt.windows[0])[np.arange(nin) // bs]
    return B, base


def _int8_product(B, base, fe):
    """A numpy f32 emulation of the int8 S product the slot form replaced
    (``csrc/bandmv.cu`` of commit 292ccd0, warp-per-row kernel): each row's
    window column ``j`` goes to lane ``(j // 16) % 32``; each lane runs
    ``fmaf(b, x, acc)`` from ``0.f`` over its columns in ascending ``j``
    (``b`` 0 or 1: one rounding of ``acc + b x``); the xor butterfly (16,
    8, 4, 2, 1) joins the lanes, read at lane 0."""
    nrows, w = B.shape
    cols = base[:, None] + np.arange(w)[None, :]
    inside = (cols >= 0) & (cols < fe.shape[0])
    X = np.where(inside, fe[np.clip(cols, 0, fe.shape[0] - 1)],
                 np.float32(0))
    acc = np.zeros((nrows, 32), np.float32)
    for j in range(w):
        lane = (j // 16) % 32
        acc[:, lane] = acc[:, lane] + B[:, j] * X[:, j]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, np.arange(32) ^ off]
    return acc[:, 0]


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_order_windows_and_patterns_equal_jax(name):
    jt, tt = _tails(name)
    w = _wspace(name)
    # the JAX tail's kernel is its element-sorted one
    assert np.array_equal(np.asarray(w["j32"].vd)[tt.eorder],
                          np.asarray(jt.kern.vd))
    assert np.array_equal(tt.kern.vd.numpy(), np.asarray(jt.kern.vd))
    assert np.array_equal(tt.kern.wdet.numpy(), np.asarray(jt.kern.wdet))
    assert tt.windows == (tuple(jt.Sbases), jt.wS, jt.Spad,
                          tuple(jt.Gbases), jt.wG, jt.Gpad)
    assert torch.equal(tt.Sb.to(torch.float32),
                       torch.from_numpy(np.array(jt.Sb, np.float32)))
    assert torch.equal(tt.Gb.to(torch.float32),
                       torch.from_numpy(np.array(jt.Gb, np.float32)))
    assert tt.nbytes == jt.nbytes and tt.slots is None
    assert np.array_equal(tt.ue_bc.numpy(), np.asarray(jt.ue_bc))
    # the predicted bytes are the stored ones
    _, rows, cols, keep = bc.tail_patterns(w["t32"].vd.numpy(), w["nin"])
    nvals = rows.shape[0]
    assert (bc._window_bytes(rows[keep], cols[keep], -(-w["nin"] // 256), 256)
            + bc._window_bytes(cols[keep], rows[keep], -(-nvals // 256), 256)
            == tt.nbytes)


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_f32_vector_matches_jax(name):
    jt, tt = _tails(name)
    w = _wspace(name)
    v = _state(w)
    ref = np.asarray(jax.jit(jt.vector)(jnp.asarray(v)))
    out = tt.vector(torch.from_numpy(v)).clone()
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    assert not out[w["nin"]:].any()
    # the card's form: the same windows, no blocks, the gather as an
    # indexed load; its vector within the same bar of the JAX tail
    ts = _slot_tail(name)
    assert ts.slots is not None and ts.Sb is None and ts.Gb is None
    assert ts.windows == tt.windows
    assert ts.nbytes == 4 * (ts.slots.numel() + ts.nvals) < tt.nbytes
    assert torch.equal(ts.kern.vd, tt.kern.vd)
    assert torch.equal(ts.ue_bc, tt.ue_bc)
    got = ts.vector(torch.from_numpy(v)).clone()
    assert got.dtype == torch.float32 and not got[w["nin"]:].any()
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    # G's band product is the indexed load, bit for bit
    x = torch.from_numpy(v[:w["nin"]]).float()
    assert torch.equal(kernels._tail_gather(torch.from_numpy(v),
                                            ts.kern.tables, w["nin"]),
                       rect_mv_ref(tt.Gb, tt.Gbases, x, tt.nvals))


def test_f64_tail_matches_the_jax_index_pipeline():
    w = _wspace("wake0")
    nin = w["nin"]
    tail = w["vbc"][nin:]
    # f64 tables: the gate refuses them (as the JAX package's), force
    # builds them
    assert bc.build_banded_conv_tail(w["t64"], nin, tail) is None
    t64 = bc.build_banded_conv_tail(w["t64"], nin, tail, force=True)
    v = _state(w, seed=5)
    ref = np.asarray(jax.jit(w["j64"].vector)(jnp.asarray(v)))
    out = t64.vector(torch.from_numpy(v))
    assert out.dtype == torch.float64 and not out[nin:].any()
    assert (np.abs(out[:nin].numpy() - ref[:nin]).max()
            <= 1e-12 * np.abs(ref[:nin]).max())


def test_the_element_order_moves_tables_and_plans():
    """The permuted kernel's vector equals the unpermuted one, and its
    reduction table is its own."""
    w = _wspace("wake0")
    kern = w["t64"]
    v = torch.from_numpy(_state(w, seed=7))
    ref = kern.vector(v)
    eo = np.random.default_rng(1).permutation(kern.tables.nc)
    perm = kern.with_element_order(eo)
    assert torch.equal(perm.vd, kern.vd[torch.from_numpy(eo)])
    assert torch.equal(perm.wdet, kern.wdet[torch.from_numpy(eo)])
    assert torch.equal(perm.tables.JinvT,
                       kern.tables.JinvT[torch.from_numpy(eo)])
    kern.tables.kernel_tables()
    assert perm.tables.dofs is not kern.tables.dofs
    assert perm.tables._plans == {} and perm.tables._plain is not None
    assert not torch.equal(perm.tables.kernel_tables()[1],
                           kern.tables.kernel_tables()[1])
    assert ((perm.vector(v) - ref).abs().max()
            <= 1e-12 * ref.abs().max())


def test_the_gate():
    w = _wspace("cavity")
    nin, tail = w["nin"], w["vbc"][w["nin"]:]
    assert bc.build_banded_conv_tail(w["t32"], nin, tail,
                                     max_gb=1e-9) is None
    assert jax_bc.build_banded_conv_tail(w["j32"], nin, tail,
                                         max_gb=1e-9) is None
    # the CPU's constants are the JAX package's, and decide alike
    c = bc.gate_constants("cpu")
    assert c["max_gb"] == 1.0
    for by, nv in ((1e5, 22104), (5e6, 22104), (4e8, 80136)):
        assert bc.banded_stream_us(by, c["stream_floor_gbps"]) == \
            pytest.approx(jax_bc.banded_stream_us(by), rel=1e-15)
        assert bc.index_pipeline_us(c["index_us_per_1k_vals"], nvals=nv) == \
            pytest.approx(jax_bc.index_pipeline_us(nvals=nv), rel=1e-15)
        assert bc.banded_wins(by, nvals=nv) == jax_bc.banded_wins(by,
                                                                   nvals=nv)
    assert (bc.build_banded_conv_tail(w["t32"], nin, tail) is None) == (
        jax_bc.build_banded_conv_tail(w["j32"], nin, tail) is None)
    # the card's constants: the slot form rated per element value
    c = bc.gate_constants("cuda")
    assert c["win_margin"] == 0.8 and c["max_gb"] == 1.0
    assert "stream_floor_gbps" not in c and c["tail_us_per_1k_vals"] > 0


@pytest.mark.parametrize("nvals", [22104, 80136])
def test_the_cards_gate(nvals):
    """The card's gate (level-1 and level-2 element values): the tail's
    measured rate per element value against B5's, under the margin; the
    predicted bytes do not enter; the CPU's decision stays the JAX
    package's."""
    c = bc.gate_constants("cuda")
    tail = bc.tail_us(1e12, c, nvals=nvals)
    assert tail == pytest.approx(c["tail_us_per_1k_vals"] * nvals / 1e3)
    assert bc.banded_wins(1e12, nvals=nvals, consts=c) == (
        c["tail_us_per_1k_vals"] <= 0.8 * c["index_us_per_1k_vals"])
    assert bc.banded_wins(1.0, nvals=nvals, consts=c) == \
        bc.banded_wins(1e12, nvals=nvals, consts=c)
    cpu = bc.gate_constants("cpu")
    assert bc.tail_us(4e8, cpu, nvals=nvals) == \
        bc.banded_stream_us(4e8, cpu["stream_floor_gbps"])
    assert bc.banded_wins(4e8, nvals=nvals) == jax_bc.banded_wins(
        4e8, nvals=nvals)


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_slot_table_lists_S_columns_in_lane_order(name):
    """Each interior row's slots are exactly S's nonzero columns (read from
    the f32 band), ordered by the reversed lane of their window column,
    then the column; the codes mark each new lane with the highest bit in
    which its leaf position differs from the last; the window starts are
    ``_build_banded_rect``'s."""
    _, tt = _tails(name)
    ts = _slot_tail(name)
    B, base = _band_rows(tt)
    r_band, j_band = np.nonzero(B)
    slots = ts.slots.numpy()
    k, r_tab = np.nonzero(slots >= 0)
    ent = slots[k, r_tab]
    p = ent >> 3
    order = np.lexsort((p, r_tab))
    assert np.array_equal(r_tab[order], r_band)
    assert np.array_equal(p[order], base[r_band] + j_band)
    # in each row: (reversed lane, column) ascending, codes as the tree
    j = np.where(slots >= 0, (slots >> 3) - base[None, :], 0)
    leaf = kernels._reverse5((j // 16) % 32)
    key = leaf * (1 << 20) + j
    both = (slots[1:] >= 0) & (slots[:-1] >= 0)
    assert (key[1:][both] > key[:-1][both]).all()
    code = slots & 7
    assert (code[0] == 7).all()
    step = (leaf[1:] ^ leaf[:-1])[both]
    want = np.where(step == 0, 7, kernels._MSB5[step])
    assert np.array_equal(code[1:][both], want)
    # every row has a slot; padding only past a row's count
    assert (slots[0] >= 0).all()
    assert not ((slots[1:] >= 0) & (slots[:-1] < 0)).any()


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_slot_sum_is_the_int8_product_bitwise(name):
    """The slot form's plain ordered sum equals, bit for bit, a numpy f32
    emulation of the int8 band product it replaces, on seeded f32 element
    loads; the CPU wrapper takes the plain version and counts nothing."""
    _, tt = _tails(name)
    ts = _slot_tail(name)
    B, base = _band_rows(tt)
    fe = np.random.default_rng(17).standard_normal(tt.nvals).astype(
        np.float32)
    want = _int8_product(B, base, fe)
    got = tail_sum_ref(torch.from_numpy(fe), ts.slots).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # the vector through the wrapper on the CPU
    w = _wspace(name)
    v = torch.from_numpy(_state(w, seed=9))
    before = kernels.conv_tail.launches
    y = conv_tail(v, ts.ue_bc, ts.kern.tables, ts.slots)
    assert kernels.conv_tail.launches == before
    assert torch.equal(y, conv_tail_ref(v, ts.ue_bc, ts.kern.tables,
                                        ts.slots))
    out = torch.full((w["nin"],), float("nan"))
    assert conv_tail(v, ts.ue_bc, ts.kern.tables, ts.slots, out=out) is out
    assert torch.equal(out, y)


def test_tail_plan_points_at_the_slot_table():
    """The tail's form of the convection plan (made on the CPU here): the
    sorted element ids, the slot table with the interior rows as its rows,
    one load a slot of scratch, no facet blocks; one plan a slot table."""
    ts = _slot_tail("wake0")
    t = ts.kern.tables
    form = kernels._CONV_FORMS["tail"]
    plan = t.kernel_plan(form, torch.float64, slots=ts.slots)
    assert t.kernel_plan(form, torch.float64, slots=ts.slots) is plan
    c = plan.c
    assert (c.fused, c.work_f64, c.u_f64, c.nfac) == (form, 0, 1, 0)
    assert (c.nc, c.nv_full, c.width) == (t.nc, ts.nin, ts.slots.shape[0])
    assert c.ell == ts.slots.data_ptr()
    assert torch.equal(plan.keep[0], t.vd.to(torch.int32))
    assert plan.scratch.numel() == t.nc * t.nd


def test_wspace_cnab_takes_the_tail_and_keeps_the_trajectory():
    """A wake level-0 w-space ``cnab`` (Schur solver, CPU f64) with the
    tail forced equals the run on the index pipeline; without the keyword
    the gate keeps the index pipeline (f64 tables), as with ``False``."""
    tp = _wspace("wake0")["tp"]
    kw = dict(trange=np.linspace(0.0, 0.05, 11), prob=tp,
              inivel=np.zeros(len(tp.invinds)), linsolver="schur",
              save_every=5, device="cpu")
    off = cnab(banded_conv=False, **kw)
    # the same solver for the other two runs (its setup is the run's cost)
    kw["ops"] = off["ops"]
    on = cnab(banded_conv=True, **kw)
    assert off["bct"] is None and on["bct"] is not None
    assert cnab(**kw)["bct"] is None
    assert on["carry"]["v"].shape == (tp.nv_full,)
    for k in ("v", "p", "vs"):
        a, b = on[k].numpy(), off[k].numpy()
        assert np.linalg.norm(a - b) <= 1e-10 * np.linalg.norm(b), k
