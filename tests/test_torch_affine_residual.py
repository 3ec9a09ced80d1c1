"""The affine kernel's schedule and its saddle-residual mode
(``ops.kernels.affine_residual``: the CUDA kernel of ``csrc/affine.cu`` on
the card, its plain version here): the plain version against the dense
solver's three-call composition, the fused dense solver against the JAX
package's, the kernel's schedule replayed in torch against the plain
version, the launch plan at the wake's level-1 to level-3 shapes, and the
wrapper's checks.  The card's side is ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.control import apply_robin_penalty as jax_robin
from dolfin_navier_scipy_tpu.models import cylinderwake_problem as jax_wake
from dolfin_navier_scipy_tpu.models import drivencavity_problem as jax_cavity
from dolfin_navier_scipy_tpu.ops.affine import AffineVectorOps as JaxAffine
from dolfin_navier_scipy_tpu.solve.sadpnt import (
    InverseSaddleSolver as JaxInverseSaddleSolver)
from dolfin_navier_scipy_tpu_torch.control import apply_robin_penalty
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    _AFFINE_PLAN, _AFFINE_SMEM, affine_element_terms, affine_fit, affine_mv,
    affine_mv_ref, affine_partition, affine_plan, affine_residual,
    affine_residual_ref, dof_slot_table, ell_slot_table)
from dolfin_navier_scipy_tpu_torch.solve.sadpnt import InverseSaddleSolver
from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops

from torch_parity import align_native

torch.set_num_threads(1)
DT = 0.01
CA = 0.5 * DT
H100_SMS = 132
_CACHE = {}


def _probs(name):
    """``(jax problem, port problem)``: the driven cavity (N 8) or the
    wake at level 0 with Robin control arcs (facet rows)."""
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            jp = jax_cavity(N=8, Re=100)
            tp = torch_cavity(N=8, Re=100, device="cpu")
        else:
            kw = dict(level=0, Re=100, charvel=0.2, bccontrol=True)
            jp, tp = jax_wake(**kw), torch_wake(device="cpu", **kw)
            jax_robin(jp, palpha=1e-3)
            apply_robin_penalty(tp, palpha=1e-3)
        _CACHE[name] = (jp, tp)
    return _CACHE[name]


def _vectors(aff, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=aff.nin)).to(dtype),
            torch.from_numpy(rng.normal(size=aff.npc)).to(dtype))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["cavity", "wake0_robin"])
def test_residual_plain_version_is_the_three_call_composition(name, dtype):
    """Bitwise, in the tables' type, on vectors of that type: the plain
    version of the fused form is exactly what the dense solver's residual
    computed before (K v + J^T q, then J v, then the concatenation)."""
    _, tp = _probs(name)
    aff = tp.affine_ops(dtype, device="cpu")
    if name != "cavity":
        assert aff.fac_elem.shape[0] > 0      # outflow and Robin rows
    v, q = _vectors(aff, dtype)
    Kop, Jop = aff.view("ma", cm=1.0, ca=CA), aff.view("j")
    before = torch.cat([Kop.matvec(v) + Jop.rmatvec(q), Jop.matvec(v)])
    n0 = affine_residual.launches
    got = aff.saddle_residual(v, q, 1.0, CA)
    assert got.dtype == dtype and got.shape == (aff.nin + aff.npc,)
    assert torch.equal(got, before)
    assert torch.equal(affine_residual_ref(v, q, aff, 1.0, CA), before)
    assert affine_residual.launches == n0     # the CPU launches nothing


@pytest.mark.parametrize("inv", ["f64", "f32_refined"])
def test_fused_dense_solver_matches_jax(inv):
    """The port's dense solver with element residual operators (fused into
    one call) against the JAX package's on the same inputs, CPU f64: an
    f64 inverse, and an f32 inverse with three f64 refinement rounds."""
    jp, tp = _probs("wake0_robin")
    coeff = sps.csr_matrix(tp.Mc + CA * tp.Ac)
    aff = tp.affine_ops(torch.float64, device="cpu")
    jaff = JaxAffine.build(jp, jnp.float64)
    kw = dict(inv_dtype=torch.float32, refine=3) if inv != "f64" else {}
    jkw = dict(inv_dtype=jnp.float32, refine=3) if inv != "f64" else {}
    sol = InverseSaddleSolver(
        coeff, tp.Jc, tp.JTc, device="cpu",
        res_ops=(aff.view("ma", cm=1.0, ca=CA), aff.view("j")), **kw)
    assert sol._res_fused is not None
    jsol = JaxInverseSaddleSolver(
        sps.csr_matrix(jp.Mc + CA * jp.Ac), jp.Jc, jp.JTc,
        res_ops=(jaff.view("ma", cm=1.0, ca=CA), jaff.view("j")), **jkw)
    rng = np.random.default_rng(8)
    rv, rp = rng.normal(size=aff.nin), rng.normal(size=aff.npc)
    x = sol.solve(torch.from_numpy(rv), torch.from_numpy(rp))
    xj = jsol.solve(jnp.asarray(rv), jnp.asarray(rp))
    assert _rel(x.numpy(), xj) <= 1e-10
    # on the CPU the fused residual is the composition: the same bits
    sol._res_fused = None
    assert torch.equal(sol.solve(torch.from_numpy(rv), torch.from_numpy(rp)),
                       x)


def test_dense_inner_ops_take_the_fused_residual():
    _, tp = _probs("cavity")
    ops = _build_ops(tp, DT, theta=0.5, linsolver="dense", layout="inner",
                     device="cpu")
    Kop = ops.solver._res_fused
    assert Kop is not None and Kop.kind == "ma" and Kop.ca == 0.5 * DT
    assert Kop.aff is ops.solver.res_ops[1].aff


# -- the kernel's schedules, replayed --------------------------------------

def _facet_rows(t, x, ca):
    """Each facet row's value (flat ``f * nd + a``) and the dof -> facet
    slot table of the kernel."""
    xp = torch.cat([x.to(t.wdet.dtype), x.new_zeros(1, dtype=t.wdet.dtype)])
    rows = torch.einsum("fab,fb->fa", t.fac_elem, xp[t.fac_vdofs]) * ca
    return rows.reshape(-1), t.fac_dofs.kernel_tables()[1].long()


def _sum_in_order(vals, slots):
    """``out[i]`` adds ``vals[slots[k, i]]`` for ``k`` ascending, one after
    the other, skipping ``-1`` (the kernel's order within a dof)."""
    out = torch.zeros(slots.shape[1], dtype=vals.dtype)
    for k in range(slots.shape[0]):
        m = slots[k] >= 0
        out[m] += vals[slots[k][m]]
    return out


def _ell_cols(lists):
    """A list of int lists as an ELL table ``(width, len(lists))``, -1
    padded."""
    width = max([1] + [len(x) for x in lists])
    out = np.full((width, len(lists)), -1, np.int64)
    for c, x in enumerate(lists):
        out[: len(x), c] = x
    return torch.from_numpy(out)


def _block_schedule(part, kinds):
    """Each owned entry of a block partition as the kernel takes it: for
    each kind ``(name, base, n, ns, offset)`` (output ids ``base + dof``,
    element slot positions ``nf + offset * ne + l * ns + j``), ``(dofs,
    element slots e * ns + j in order, facet rows in order)``."""
    eptr, elem = part["eptr"].astype(np.int64), part["elem"].astype(np.int64)
    fptr, frow = part["fptr"].astype(np.int64), part["frow"].astype(np.int64)
    assert (part["cnt"][:, 2] == part["optr"][:-1]).all()
    out = {name: ([], [], []) for name, *_ in kinds}
    for b in range(part["nblk"]):
        ne, nf = eptr[b + 1] - eptr[b], fptr[b + 1] - fptr[b]
        for k in range(part["optr"][b], part["optr"][b + 1]):
            own = int(part["own"][k])
            name, base, n, ns, off = next(
                kd for kd in kinds if kd[1] <= own < kd[1] + kd[2])
            col = [int(x) for x in part["lell"][:, k] if x >= 0]
            els = [x for x in col if x >= nf]
            fac = [x for x in col if x < nf]
            assert col == els + fac         # element slots, then facet rows
            glob = []
            for x in els:
                le = x - nf - off * ne
                assert 0 <= le < ne * ns
                glob.append(int(elem[eptr[b] + le // ns]) * ns + le % ns)
            out[name][0].append(own - base)
            out[name][1].append(glob)
            out[name][2].append([int(frow[fptr[b] + x]) for x in fac])
    return {name: (torch.tensor(d), _ell_cols(sl), _ell_cols(fr))
            for name, (d, sl, fr) in out.items()}


def _schedule(mode, t, chunk):
    """``{kind: (dofs, slots, rows)}`` for kinds 'v' (velocity outputs) and
    'p' (pressure outputs) of ``mode``: the order in which the kernel's
    threads take the output dofs; for each the global element slots ``e *
    ns + j`` it adds, in its order, as an ELL table; and the global facet
    rows ``f * nd + a`` it adds after them, alike."""
    nd = t.nvpc * t.dim
    vids, pids = t.vtab.vd.numpy(), t.ptab.vd.numpy()
    fac = t.fac_vdofs.numpy()
    if mode == "res":
        part = affine_partition(vids, t.nin, chunk, fac, pids, t.npc)
        return _block_schedule(part, [("v", 0, t.nin, nd, 0),
                                      ("p", t.nin, t.npc, t.pnpc, 2 * nd)])
    if mode == "j":
        part = affine_partition(pids, t.npc, chunk)
        return _block_schedule(part, [("p", 0, t.npc, t.pnpc, 0)])
    part = affine_partition(vids, t.nin, chunk, fac)
    return _block_schedule(part, [("v", 0, t.nin, nd, 0)])


@pytest.mark.parametrize("chunk", ["plan", 1])
@pytest.mark.parametrize("mode", ["m", "a", "ma", "j", "jt", "res"])
def test_kernel_schedule_replayed_matches_the_plain_version(mode, chunk):
    """The kernel's schedule in f64 on the Robin wake, on the plan's chunk
    and on chunks of one element: every output dof taken once, its slots
    exactly the ascending ELL column of ``dof_slot_table`` (so the sum's
    order is the fixed one), its facet rows after them in ``fell``'s
    order, the residual's two velocity sums added last (its joint
    partition); the result within 1e-13 of the plain version."""
    _, tp = _probs("wake0_robin")
    t = tp.affine_ops(torch.float64, device="cpu")
    v, q = _vectors(t, torch.float64, seed=13)
    cm, ca = dict(m=(1.0, 0.0), a=(0.0, 1.0)).get(mode, (1.0, CA))
    if chunk == "plan":
        chunk = affine_plan(mode, t.nc, H100_SMS)
    sched = _schedule(mode, t, chunk)
    outs = []
    if "v" in sched:
        dofs, slots, frows = sched["v"]
        assert torch.equal(dofs.sort().values, torch.arange(t.nin))
        want = torch.from_numpy(ell_slot_table(*dof_slot_table(
            t.vtab.vd.numpy(), t.nin))).long()[:, dofs]
        assert torch.equal(slots, want[: slots.shape[0]])
        assert (want[slots.shape[0]:] < 0).all()
        rows, fell = _facet_rows(t, v, ca)
        fell = fell[:, dofs]
        # the block's facet rows: the dof's rows of fell, in its order
        assert torch.equal(frows[: fell.shape[0]], fell)
        assert (frows[fell.shape[0]:] < 0).all()
        xin = q if mode == "jt" else v
        fe = affine_element_terms("ma" if mode == "res" else mode, xin, t,
                                  cm, ca)
        y = _sum_in_order(fe.reshape(-1), slots)
        if mode in ("a", "ma", "res"):
            y = y + _sum_in_order(rows, fell)
        if mode == "res":
            ft = affine_element_terms("jt", q, t)
            y = y + _sum_in_order(ft.reshape(-1), slots)
        outs.append(torch.empty_like(y).index_copy_(0, dofs, y))
    if "p" in sched:
        dofs, slots, frows = sched["p"]
        assert torch.equal(dofs.sort().values, torch.arange(t.npc))
        want = torch.from_numpy(ell_slot_table(*dof_slot_table(
            t.ptab.vd.numpy(), t.npc))).long()[:, dofs]
        assert torch.equal(slots, want[: slots.shape[0]])
        assert (frows < 0).all()
        fe = affine_element_terms("j", v, t)
        y = _sum_in_order(fe.reshape(-1), slots)
        outs.append(torch.empty_like(y).index_copy_(0, dofs, y))
    got = torch.cat(outs)
    ref = (affine_residual_ref(v, q, t, cm, CA) if mode == "res" else
           affine_mv_ref(mode, q if mode == "jt" else v, t, cm, ca))
    assert _rel(got.numpy(), ref.numpy()) <= 1e-13


def test_partition_splits_blocks_past_max_own():
    """A block of more dofs than the kernel has threads is split, its dofs
    in ascending order; every dof still takes its slots in the fixed
    order (the joint partition of the residual, chunks of 64 elements)."""
    _, tp = _probs("wake0_robin")
    t = tp.affine_ops(torch.float64, device="cpu")
    vids, pids = t.vtab.vd.numpy(), t.ptab.vd.numpy()
    fac = t.fac_vdofs.numpy()
    whole = affine_partition(vids, t.nin, 64, fac, pids, t.npc)
    part = affine_partition(vids, t.nin, 64, fac, pids, t.npc, max_own=16)
    assert whole["cnt"][:, 3].max() > 16 >= part["cnt"][:, 3].max()
    assert part["nblk"] > whole["nblk"]
    assert sorted(part["own"].tolist()) == list(range(t.nin + t.npc))
    # a split block's dofs ascending across its pieces
    for b in range(part["nblk"]):
        own = part["own"][part["optr"][b]:part["optr"][b + 1]]
        assert (np.diff(own) > 0).all()
    sched = _block_schedule(part, [("v", 0, t.nin, 12, 0),
                                   ("p", t.nin, t.npc, 3, 24)])
    for k, ids, n in (("v", vids, t.nin), ("p", pids, t.npc)):
        dofs, slots, _ = sched[k]
        want = torch.from_numpy(ell_slot_table(*dof_slot_table(
            ids, n))).long()[:, dofs]
        assert torch.equal(slots, want[: slots.shape[0]])


def test_fit_halves_the_chunk_until_a_block_fits():
    """A partition whose largest block would take more shared memory than
    allowed is made anew on chunks half as large, down to one element:
    each fitted partition is :func:`affine_partition`'s on the chunk it
    reports, within the limit, every dof owned once."""
    _, tp = _probs("wake0_robin")
    t = tp.affine_ops(torch.float64, device="cpu")
    whole, c0, smem0 = affine_fit(t, "res", 16)
    assert c0 == 16 and smem0 <= _AFFINE_SMEM
    part, c, smem = affine_fit(t, "res", 16, smem_max=smem0 // 2)
    assert c < 16 and smem <= smem0 // 2
    again = affine_partition(t.vtab.vd.numpy(), t.nin, c,
                             t.fac_vdofs.numpy(), t.ptab.vd.numpy(), t.npc)
    for k in ("eptr", "elem", "own", "lell"):
        assert np.array_equal(part[k], again[k]), k
    assert sorted(part["own"].tolist()) == list(range(t.nin + t.npc))
    # a limit no block can meet stops at chunks of one element
    _, c1, smem1 = affine_fit(t, "v", 16, smem_max=1)
    assert c1 == 1 and smem1 > 1


# the plan's chunk at the wake's inner tables on a 132-SM card
_WAKE_CHUNKS = {1: 7, 2: 26, 3: 96}


@pytest.mark.parametrize("level", [1, 2, 3])
def test_affine_plan_at_the_wake_shapes(level):
    """The plan's chunk for every mode at the level-1 to level-3 inner
    tables (with the Robin arcs' facet rows) on a 132-SM card, and the
    partitions there: every dof owned once, a block's elements (f64
    tables, both value sets of the residual) within its shared memory on
    that chunk, with no halving, a grid of one to a few blocks an SM.  A
    dof's slots (elements, then facet rows) may outnumber the kernel's
    registers for them: the kernel reads the rest from its table."""
    tp = torch_wake(level=level, Re=100, charvel=0.2, bccontrol=True,
                    device="cpu")
    apply_robin_penalty(tp, palpha=1e-3)
    t = tp.affine_ops(torch.float64, device="cpu")
    chunks = {m: affine_plan(m, t.nc, H100_SMS)
              for m in ("m", "a", "ma", "j", "jt", "res")}
    assert set(chunks.values()) == {_WAKE_CHUNKS[level]}, chunks
    assert _WAKE_CHUNKS[level] >= _AFFINE_PLAN["MIN_CHUNK"]
    for kind, n in (("v", t.nin), ("p", t.npc), ("res", t.nin + t.npc)):
        part, chunk, smem = affine_fit(t, kind, _WAKE_CHUNKS[level])
        assert chunk == _WAKE_CHUNKS[level] and smem <= _AFFINE_SMEM, (
            kind, chunk, smem)
        assert sorted(part["own"].tolist()) == list(range(n))
        assert H100_SMS <= part["nblk"] <= 8 * H100_SMS
        # each block computes its chunk and a halo: under 3x the elements
        # (level 3: a chunk's ~96 elements own more dofs than a block has
        # threads, and each half of a split block computes its own halo)
        assert part["eptr"][-1] <= (4 if level == 3 else 3) * t.nc
    with pytest.raises(ValueError, match="mode"):
        affine_plan("mt", t.nc, H100_SMS)


def test_affine_residual_wrapper_checks():
    _, tp = _probs("wake0_robin")
    aff = tp.affine_ops(torch.float64, device="cpu")
    v, q = _vectors(aff, torch.float64)
    with pytest.raises(ValueError, match="v must be a 1-D tensor"):
        affine_residual(v[:-1], q, aff)
    with pytest.raises(ValueError, match="q must be a 1-D tensor"):
        affine_residual(v, v, aff)              # q takes pressures
    with pytest.raises(ValueError, match="1-D tensor"):
        affine_residual(v.numpy(), q, aff)
    with pytest.raises(ValueError, match="1-D tensor"):
        affine_residual(v[None], q, aff)
    with pytest.raises(TypeError, match="float32"):
        affine_residual(v, q.float(), aff)
    # the matvec wrapper: a pressure vector for J x, and what is not a
    # tensor
    with pytest.raises(ValueError, match="1-D tensor"):
        affine_mv("j", q, aff)
    with pytest.raises(ValueError, match="1-D tensor"):
        affine_mv("m", list(v), aff)
