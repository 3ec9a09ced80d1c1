"""The banded convection tail of the port (``ops/banded_conv.py``) vs the
JAX package on the CPU: the element order, the windows and the 0/1
patterns of S and G, the tail's vector in f32 and f64, the gate, the
element-permuted kernel, and a w-space ``cnab`` that takes the tail."""

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
from dolfin_navier_scipy_tpu_torch.ops.kernels import rect_mv, rect_mv_ref
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
    assert tt.nbytes == jt.nbytes and tt.store == "f32"
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
    # the card's storage: int8 blocks under the f64 state, the same sums
    i8 = bc.BandedConvTail(tt.kern, tt.Sb.to(torch.int8), tt.Sbases,
                           tt.Gb.to(torch.int8), tt.Gbases, tt.ue_bc,
                           tt.nin, tt.nvals, "int8")
    assert i8.Sb.dtype == torch.int8 and i8.nbytes * 4 == tt.nbytes
    assert torch.equal(i8.vector(torch.from_numpy(v)), out)


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


def test_int8_blocks_give_the_f32_product():
    _, tt = _tails("cavity")
    w = _wspace("cavity")
    x = torch.from_numpy(_state(w)[:w["nin"]].astype(np.float32))
    i8 = tt.Gb.to(torch.int8)
    y = rect_mv(i8, tt.Gbases, x, tt.nvals)
    assert y.dtype == torch.float32
    assert torch.equal(y, rect_mv_ref(tt.Gb, tt.Gbases, x, tt.nvals))
    out = torch.empty(tt.nvals, dtype=torch.float32)
    assert rect_mv(i8, tt.Gbases, x, tt.nvals, out=out) is out
    assert torch.equal(out, y)


def test_the_gate():
    w = _wspace("cavity")
    nin, tail = w["nin"], w["vbc"][w["nin"]:]
    assert bc.build_banded_conv_tail(w["t32"], nin, tail,
                                     max_gb=1e-9) is None
    assert jax_bc.build_banded_conv_tail(w["j32"], nin, tail,
                                         max_gb=1e-9) is None
    # the CPU's constants are the JAX package's, and decide alike
    c = bc.gate_constants("cpu")
    assert c["store"] == "f32" and c["max_gb"] == 1.0
    for by, nv in ((1e5, 22104), (5e6, 22104), (4e8, 80136)):
        assert bc.banded_stream_us(by, c["stream_floor_gbps"]) == \
            pytest.approx(jax_bc.banded_stream_us(by), rel=1e-15)
        assert bc.index_pipeline_us(c["index_us_per_1k_vals"], nvals=nv) == \
            pytest.approx(jax_bc.index_pipeline_us(nvals=nv), rel=1e-15)
        assert bc.banded_wins(by, nvals=nv) == jax_bc.banded_wins(by,
                                                                   nvals=nv)
    assert (bc.build_banded_conv_tail(w["t32"], nin, tail) is None) == (
        jax_bc.build_banded_conv_tail(w["j32"], nin, tail) is None)
    # the card's defaults: int8 blocks
    assert bc.GATE["cuda"]["store"] == "int8"
    assert bc.gate_constants("cuda")["store"] == "int8"


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
