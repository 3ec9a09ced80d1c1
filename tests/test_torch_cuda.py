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
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    affine_mv, affine_mv_ref, affine_residual, affine_residual_ref,
    as_band_operand, as_vecmat_operand,
    band_operand, banded_mv, banded_mv_ref, conv_vector, conv_vector_amatvec,
    conv_quad, conv_quad_ref, conv_vector_amatvec_ref, conv_vector_ref,
    rect_mv, rect_mv_levels, rect_mv_levels_ref, rect_mv_ref, vecmat)
from dolfin_navier_scipy_tpu_torch.solve import sbdf2, solve_nse

torch.set_num_threads(1)

NEEDS_CARD = ("needs a CUDA card: a CUDA kernel has no interpret mode; "
              "chip_smoke.py holds it against its plain version on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vecmat_kernel_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(4)
    # padded and unpadded rows; fewer rows than SMs; a single column; a
    # width past one shared-memory tile of partial sums
    for m, n in [(512, 1024), (2049, 1022), (700, 1501), (5000, 1), (3, 7),
                 (40, 30001)]:
        KT = as_vecmat_operand(
            torch.from_numpy(rng.normal(size=(m, n))).to(dtype), device="cuda")
        x = torch.from_numpy(rng.normal(size=(m,))).to(dtype).cuda()
        before = vecmat.launches
        y = vecmat(x, KT)
        torch.cuda.synchronize()
        assert vecmat.launches == before + 1
        ref = x.double() @ KT.double()
        tol = 1e-3 if dtype == torch.float32 else 1e-10
        assert torch.allclose(y.double(), ref, atol=tol, rtol=1e-4), (m, n)
        assert torch.equal(y, vecmat(x, KT)), (m, n)
    # rows that are not 16-byte aligned raise (never copied)
    odd = torch.zeros(7, 3, dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match="vecmat_operand"):
        vecmat(torch.zeros(7, dtype=dtype, device="cuda"), odd)
    with pytest.raises(ValueError, match="vecmat_operand"):
        vecmat(x, KT.T.contiguous().T)
    with pytest.raises(TypeError):
        vecmat(x.half(), KT.half())


def _captured(run):
    """``run`` captured once in a CUDA graph on a side stream that ran it
    first, the graph's nodes read through libcuda (``cuGraphGetNodes``,
    type 0 a kernel), then replayed: ``(node types, the replay's output)``.
    (Counts what a call launches without the profiler, which on an H100
    host sometimes records no device event late in a process.)"""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        out = run()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                     ctypes.byref(kind)) == 0
        types.append(kind.value)
    graph.replay()
    torch.cuda.synchronize()
    return types, out


def _card_calls():
    """``name -> call`` of each wrapper on level-0 wake operands."""
    prob = cylinderwake_problem(level=0, Re=100)
    kern = prob.conv_kernel_on(torch.float32)
    aff = AffineVectorOps.build(prob, torch.float32, full_dofs=True)
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.normal(size=prob.nv_full)).cuda()
    KT = as_vecmat_operand(
        torch.from_numpy(rng.normal(size=(1001, 1001))).float(),
        device="cuda")
    x = torch.from_numpy(rng.normal(size=1001)).float().cuda()
    t = kern.tables
    E = as_band_operand(rng.normal(size=(9, 256, 768)).astype(np.float32),
                        device="cuda")
    stack = _band_stack(rng, 9, 3, 256, 1021)
    single = _band_stack(rng, 9, 1, 256, 1021, torch.float32)[:, 0]
    bases = torch.arange(9, dtype=torch.int32, device="cuda") * 200
    xe = torch.from_numpy(rng.normal(size=2058)).float().cuda()
    ain = prob.affine_ops(torch.float32, device="cuda")
    xa = torch.from_numpy(rng.normal(size=ain.nin)).float().cuda()
    qa = torch.from_numpy(rng.normal(size=ain.npc)).float().cuda()
    i8 = _int8_blocks(rng, 9, 256, 1021)
    x64 = torch.from_numpy(rng.normal(size=2058)).cuda()
    ue = torch.from_numpy(rng.normal(size=(t.nc * t.nd))).float().cuda()
    ue_bc = torch.from_numpy(rng.normal(size=(t.nc, t.nd))).float().cuda()
    return {
        "rect_mv_int8": lambda: (rect_mv(i8, bases, x64, 2058),),
        "conv_quad": lambda: (conv_quad(ue, ue_bc, t),),
        "vecmat": lambda: (vecmat(x, KT),),
        "conv_vector": lambda: (conv_vector(u, None, t),),
        "conv_vector_amatvec": lambda: conv_vector_amatvec(
            u, prob.nu, True, t, aff.fac_elem, aff.fac_dofs),
        "banded_mv": lambda: (banded_mv(E, xe),),
        "rect_mv": lambda: (rect_mv(single, bases, xe, 2058),),
        "rect_mv_levels": lambda: (rect_mv_levels(stack, bases, xe, 2058),),
        "affine_mv": lambda: (affine_mv("ma", xa, ain, 1.0, 5e-3),),
        "affine_residual": lambda: (affine_residual(xa, qa, ain, 1.0,
                                                    5e-3),),
    }


def _band_stack(rng, nblk, levels, bs, w, dtype=torch.bfloat16):
    """Seeded ``(nblk, levels, bs, w)`` in band-operand storage on the card,
    its padding columns filled with NaN (the kernel must never use them)."""
    st = band_operand((nblk, levels, bs, w), dtype, "cuda")
    st.copy_(torch.from_numpy(rng.normal(size=(nblk, levels, bs, w))))
    full = st.as_strided((nblk, levels, bs, st.stride(2)), st.stride())
    full[..., w:] = float("nan")
    return st


# the level-1 shapes of the Schur route (F/E band, J, J^T, W, X, S^-1)
# and ragged ones: w not a multiple of 8, a last row block cut short by
# nrows, x shorter than the last window
_BAND_CASES = {
    "banded_mv": [(19, 384, 6994), (9, 256, 2058), (3, 40, 101)],
    "rect_mv": [(8, 128, 1408, 1022, 6994), (19, 384, 256, 6994, 1022),
                (5, 48, 77, 230, 150)],
    "rect_mv_levels": [(19, 3, 384, 1664, 6994, 6994),
                       (19, 2, 384, 1022, 6994, 1022),
                       (1, 3, 1022, 1022, 1022, 1022),
                       (1, 2, 1022, 1022, 1022, 1022),
                       (5, 3, 48, 77, 230, 150), (5, 2, 48, 77, 230, 150)],
}


_WRAPPERS = ["vecmat", "conv_vector", "conv_vector_amatvec", "banded_mv",
             "rect_mv", "rect_mv_levels", "affine_mv", "affine_residual",
             "rect_mv_int8", "conv_quad"]


def _int8_blocks(rng, nblk, bs, w):
    """Seeded 0/1 int8 ``(nblk, bs, w)`` blocks in band-operand storage on
    the card, their padding columns filled with ones (never to be used)."""
    B = band_operand((nblk, bs, w), torch.int8, "cuda")
    B.copy_(torch.from_numpy(rng.integers(0, 2, size=(nblk, bs, w))))
    full = B.as_strided((nblk, bs, B.stride(1)), B.stride())
    full[..., w:] = 1
    return B


@pytest.mark.cuda
@pytest.mark.parametrize("name", _WRAPPERS)
def test_each_wrapper_is_one_device_kernel(name):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    call = _card_calls()[name]
    call()
    torch.cuda.synchronize()
    # the kernel nodes of one call captured in a graph (the profiler on an
    # H100 host sometimes records no device event late in a process)
    types, _ = _captured(call)
    assert types.count(0) == 1, types


@pytest.mark.cuda
@pytest.mark.parametrize("name", _WRAPPERS)
def test_each_wrapper_replays_from_a_cuda_graph(name):
    """Captured and replayed: the same bits as eager calls, which give the
    same bits launch to launch."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    call = _card_calls()[name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [call() for _ in range(3)]      # the stream's plan/scratch
    torch.cuda.synchronize()
    for a in eager[1:]:
        assert all(torch.equal(g, h) for g, h in zip(eager[0], a))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, h) for g, h in zip(got, eager[0]))


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
    most = tables.kernel_tables()[1].shape[0]
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


def _windows_bases(nblk, w, nx, rng):
    """Window starts that run past the end of x (read as zero)."""
    b = np.sort(rng.integers(0, max(nx - w // 2, 1), size=nblk))
    return torch.from_numpy(b.astype(np.int32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_BAND_CASES))
def test_band_kernels_on_the_card(name):
    """Each banded matvec against its plain version at the level-1 shapes
    of the Schur route and at ragged ones, one launch counted a call, the
    same bits twice; bf16 and f32 levels, ``hi_only``."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(12)
    wrapper = {"banded_mv": banded_mv, "rect_mv": rect_mv,
               "rect_mv_levels": rect_mv_levels}[name]
    for case in _BAND_CASES[name]:
        if name == "banded_mv":
            nblk, bs, n = case
            B = _band_stack(rng, nblk, 1, bs, 3 * bs, torch.float32)[:, 0]
            x = torch.from_numpy(rng.normal(size=n)).float().cuda()
            calls = [(lambda: banded_mv(B, x), lambda: banded_mv_ref(B, x),
                      3 * bs)]
        elif name == "rect_mv":
            nblk, bs, w, nrows, nx = case
            B = _band_stack(rng, nblk, 1, bs, w, torch.float32)[:, 0]
            x = torch.from_numpy(rng.normal(size=nx)).float().cuda()
            bases = _windows_bases(nblk, w, nx, rng)
            calls = [(lambda: rect_mv(B, bases, x, nrows),
                      lambda: rect_mv_ref(B, bases, x, nrows), w)]
        else:
            nblk, lev, bs, w, nrows, nx = case
            x = torch.from_numpy(rng.normal(size=nx)).float().cuda()
            bases = _windows_bases(nblk, w, nx, rng)
            calls = []
            for dt in (torch.bfloat16, torch.float32):
                S = _band_stack(rng, nblk, lev, bs, w, dt)
                for hi in (False, True):
                    calls.append((
                        lambda S=S, hi=hi: rect_mv_levels(S, bases, x, nrows,
                                                          hi),
                        lambda S=S, hi=hi: rect_mv_levels_ref(
                            S, bases, x, nrows, hi), w * lev))
        for run, plain, terms in calls:
            before = wrapper.launches
            got = run()
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            ref = plain()
            assert got.dtype == torch.float32 and got.shape == ref.shape
            assert bool(torch.isfinite(got).all()), (name, case)
            # f32 sums of `terms` products in another order
            tol = 1e-6 * terms ** 0.5 * float(ref.abs().max()) + 1e-6
            assert float((got - ref).abs().max()) <= tol, (name, case)
            assert torch.equal(got, run()), (name, case)


def _band_edge_case(name, rng):
    """``(wrapper, call, plain, plain over |B| and |x|)`` of one edge
    operand of the ring kernel (single-level f32 blocks, NaN padding)."""
    def vec(n):
        return torch.from_numpy(rng.normal(size=n)).float().cuda()

    def rect(nblk, bs, w, nrows, nx, bases):
        B = _band_stack(rng, nblk, 1, bs, w, torch.float32)[:, 0]
        b = torch.tensor(bases, dtype=torch.int32, device="cuda")
        x = vec(nx)
        return (rect_mv, lambda: rect_mv(B, b, x, nrows),
                lambda: rect_mv_ref(B, b, x, nrows),
                lambda: rect_mv_ref(B.abs(), b, x.abs(), nrows))

    if name == "windows_past_both_ends":
        # banded: the first window starts at -bs, the last runs past x
        B = _band_stack(rng, 5, 1, 96, 288, torch.float32)[:, 0]
        x = vec(5 * 96 - 50)
        return (banded_mv, lambda: banded_mv(B, x),
                lambda: banded_mv_ref(B, x),
                lambda: banded_mv_ref(B.abs(), x.abs()))
    if name == "nan_padding":               # w = 253: 3 NaN columns a row
        return rect(19, 384, 253, 19 * 384, 7000,
                    list(range(0, 19 * 300, 300)))
    if name == "ragged_last_block":
        return rect(7, 128, 300, 7 * 128 - 77, 1000,
                    [100 * k for k in range(7)])
    if name == "rect_bases_at_edges":       # before 0, at 0, at and past nx
        return rect(5, 64, 120, 5 * 64, 400, [-5, 0, 280, 397, 410])
    if name == "jt_short_rows":             # J^T's 256 columns
        return rect(19, 384, 256, 6994, 1022,
                    [min(54 * k, 766) for k in range(19)])
    if name == "very_short_rows":           # 6 columns, bs 1
        return rect(50, 1, 6, 50, 60, list(range(50)))
    return _stack_edge_case(name, rng, vec)


def _stack_edge_case(name, rng, vec):
    """The level-stack edge operands (NaN padding in every level)."""
    def stack(nblk, lev, bs, w, nrows, nx, bases, dtype, hi=False):
        S = _band_stack(rng, nblk, lev, bs, w, dtype)
        b = torch.tensor(bases, dtype=torch.int32, device="cuda")
        x = vec(nx)
        return (rect_mv_levels, lambda: rect_mv_levels(S, b, x, nrows, hi),
                lambda: rect_mv_levels_ref(S, b, x, nrows, hi),
                lambda: rect_mv_levels_ref(S.abs(), b, x.abs(), nrows, hi))

    bf16, f32 = torch.bfloat16, torch.float32
    spread = list(range(0, 19 * 300, 300))
    if name == "stack_nan_padding_3_levels":     # w = 253: 3 NaN columns
        return stack(19, 3, 384, 253, 19 * 384, 7000, spread, bf16)
    if name == "stack_nan_padding_hi_only":
        return stack(19, 3, 384, 253, 19 * 384, 7000, spread, bf16, hi=True)
    if name == "stack_ragged_last_block_f32":
        return stack(7, 2, 128, 300, 7 * 128 - 77, 1000,
                     [100 * k for k in range(7)], f32)
    if name == "stack_bases_at_edges":       # before 0, at 0, at and past nx
        return stack(5, 3, 64, 120, 5 * 64, 400, [-5, 0, 280, 397, 410],
                     bf16)
    if name == "stack_one_block_bf16":           # S^-1 at level 1
        return stack(1, 3, 1022, 1022, 1022, 1022, [0], bf16)
    if name == "stack_one_block_f32":
        return stack(1, 3, 1022, 1022, 1022, 1022, [0], f32)
    raise KeyError(name)


_BAND_EDGES = ["windows_past_both_ends", "nan_padding", "ragged_last_block",
               "rect_bases_at_edges", "jt_short_rows", "very_short_rows",
               "stack_nan_padding_3_levels", "stack_nan_padding_hi_only",
               "stack_ragged_last_block_f32", "stack_bases_at_edges",
               "stack_one_block_bf16", "stack_one_block_f32"]


# each edge operand as the shipped plans run it and forced onto each form
# that takes it (the share kernel takes level stacks only)
_BAND_EDGE_FORMS = [(name, form) for name in _BAND_EDGES
                    for form in ("shipped", "ring", "rows")
                    + (("share",) if name.startswith("stack") else ())]


@pytest.fixture
def band_kernel(request, monkeypatch):
    """Each product as the shipped plans run it, and forced onto one kernel
    form whatever the plan would pick: the ring kernel (single-level f32
    blocks and level stacks), the warp-per-row kernel, the share kernel
    (level stacks only)."""
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    form = request.param
    if form == "ring":
        monkeypatch.setitem(kernels._BANDMV_PLAN, "RING_GRID_BELOW", 1 << 30)
    if form == "rows":
        monkeypatch.setitem(kernels._BANDMV_PLAN, "RING_GRID_BELOW", 0)
    if form != "shipped":
        monkeypatch.setitem(kernels._STACK_PLAN, "FORM", form)
    kernels._bandmv_plan_on.cache_clear()
    kernels._stack_plan_on.cache_clear()
    yield form
    kernels._bandmv_plan_on.cache_clear()
    kernels._stack_plan_on.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("name,band_kernel", _BAND_EDGE_FORMS,
                         indirect=["band_kernel"])
def test_band_edge_operands_on_the_card(name, band_kernel):
    """Single-level f32 products and level stacks on edge operands: within
    the row bar (1e-5 of the row's sum of |B||x|), the same bits twice, one
    launch counted (on the forced form), one device kernel a call, and the
    same bits from a CUDA-graph replay."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    wrapper, run, plain, absplain = _band_edge_case(
        name, np.random.default_rng(21))
    before = wrapper.launches
    by_form = dict(wrapper.kernel_launches)
    got = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    if band_kernel != "shipped":
        assert wrapper.kernel_launches[band_kernel] == by_form[band_kernel] + 1
    ref = plain()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 1e-5 * absplain() + 1e-30).all())
    assert torch.equal(got, run())
    types, replayed = _captured(run)
    assert types == [0], types
    assert torch.equal(replayed, got)


@pytest.mark.cuda
def test_band_kernels_refuse_what_they_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    x = torch.zeros(100, device="cuda")
    bases = torch.zeros(2, dtype=torch.int32, device="cuda")
    odd = torch.zeros((2, 3, 16, 13), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="band_operand"):
        rect_mv_levels(odd, bases, x, 32)
    with pytest.raises(ValueError, match="band_operand"):
        banded_mv(torch.zeros((2, 5, 15), device="cuda"), x[:10])
    ok = band_operand((2, 16, 13), torch.float32, "cuda")
    with pytest.raises(TypeError):
        rect_mv(ok, bases, x.double(), 32)
    with pytest.raises(ValueError, match="int32"):
        rect_mv(ok, bases.long(), x, 32)
    with pytest.raises(ValueError):
        rect_mv(ok, bases, x, 33)               # past nblk * bs rows
    # level stacks: the type, the level count, a misaligned start, the
    # rows, the bases, a window past a block's shared memory on every form
    st = band_operand((2, 3, 16, 13), torch.bfloat16, "cuda")
    with pytest.raises(TypeError):
        rect_mv_levels(st.half(), bases, x, 32)
    with pytest.raises(ValueError):
        rect_mv_levels(band_operand((2, 4, 16, 13), torch.bfloat16, "cuda"),
                       bases, x, 32)
    with pytest.raises(ValueError, match="band_operand"):
        rect_mv_levels(band_operand((2, 3, 16, 14), torch.bfloat16,
                                    "cuda")[..., 1:], bases, x, 32)
    with pytest.raises(ValueError):
        rect_mv_levels(st, bases, x, 33)
    with pytest.raises(ValueError, match="int32"):
        rect_mv_levels(st, bases.long(), x, 32)
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    wide = band_operand((1, 1, 8, 60000), torch.bfloat16, "cuda")
    for form in ("share", "ring", "rows"):
        kernels._STACK_PLAN["FORM"] = form
        try:
            with pytest.raises(ValueError, match="shared memory"):
                rect_mv_levels(wide, bases[:1], x, 8)
        finally:
            kernels._STACK_PLAN["FORM"] = None


@pytest.mark.cuda
def test_schur_route_on_the_card_matches_the_cpu():
    """The cavity on linsolver='schur' with W (forced) and its bf16 level
    stacks: the w-space loop launches only the banded kernels for the
    solve, and lands within 1e-6 (one refine round) of the CPU f64 run."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = drivencavity_problem(N=8, Re=100)
    kw = dict(prob=prob, t0=0.0, tE=0.2, Nts=20, start_ssstokes=True,
              linsolver="schur", winv=True, save_every=5, warm_refine=1)
    wr = (banded_mv, rect_mv, rect_mv_levels)
    before = [w.launches for w in wr]
    out = solve_nse(**kw)
    got = [w.launches - b for w, b in zip(wr, before)]
    assert got == [19 * 2, 19 * 4, 19 * 6], got
    slv = out["ops"].solver
    assert slv.Wb.dtype == torch.bfloat16 and slv.Wb.shape[1] == 3
    ref = solve_nse(device="cpu", **kw)
    err = (torch.linalg.vector_norm(out["v"].cpu() - ref["v"])
           / torch.linalg.vector_norm(ref["v"]))
    assert float(err) <= 1e-6


@pytest.mark.cuda
def test_device_setup_on_the_card_matches_host_and_cpu(monkeypatch):
    """Wake level 0 on the card: the factors of ``setup="device"`` (X by
    block PCG) against those of the host's splu — X to 1e-5 of its largest
    entry, solves to 1e-5, two builds bitwise equal — and a short default
    (w-space) run on device-setup factors within 1e-6 of the same run on
    the CPU in f64."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    import scipy.sparse as sps

    import dolfin_navier_scipy_tpu_torch.solve.timeint as tti
    from dolfin_navier_scipy_tpu_torch.solve import SchurSaddleSolver

    prob = cylinderwake_problem(level=0, Re=100)
    F = sps.csr_matrix(prob.Mc + 0.5 * 1e-2 * prob.Ac)
    host, dev = (SchurSaddleSolver(F, prob.Jc, prob.JTc, setup=s,
                                   lowbit=False, winv=True)
                 for s in ("host", "device"))
    assert dev.setup == "device" and dev.Xb.is_cuda
    assert float((dev.Xb - host.Xb).abs().max()) <= 1e-5 * float(
        host.Xb.abs().max())
    rng = np.random.default_rng(12)
    bv = torch.from_numpy(rng.normal(size=dev.nv)).float().cuda()
    bp = torch.from_numpy(rng.normal(size=dev.np)).float().cuda()
    for refine in (0, 1):
        host.refine = dev.refine = refine
        a, b = dev.solve(bv, bp), host.solve(bv, bp)
        assert float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b)) <= 1e-5, refine
    one, two = (SchurSaddleSolver(F, prob.Jc, prob.JTc, setup="device",
                                  winv=True) for _ in range(2))
    for k in ("Xb", "Sinv", "Wb"):
        assert getattr(one, k).dtype == torch.bfloat16, k
        assert torch.equal(getattr(one, k), getattr(two, k)), k

    class DeviceSetup(SchurSaddleSolver):
        def __init__(self, *args, **kw):
            super().__init__(*args, setup="device", **kw)

    monkeypatch.setattr(tti, "SchurSaddleSolver", DeviceSetup)
    kw = dict(prob=prob, t0=0.0, tE=0.2, Nts=20, start_ssstokes=True,
              linsolver="schur", winv=True, save_every=5, warm_refine=1)
    out = solve_nse(**kw)
    assert out["ops"].solver.setup == "device" and out["v"].is_cuda
    ref = solve_nse(device="cpu", **kw)
    err = (torch.linalg.vector_norm(out["v"].cpu() - ref["v"])
           / torch.linalg.vector_norm(ref["v"]))
    assert float(err) <= 1e-6


_AFFINE_PLAN_SHIPPED = dict(kernels._AFFINE_PLAN)
_AFFINE_FIT = kernels.affine_fit
# plan settings that give chunks of one element and of 64 (blocks past
# the kernel's threads, split); "slots16": the plan's chunk with every
# dof's slot table padded to 16 rows (-1), past the 12 the kernel holds in
# registers, so that it reads them from the table
_AFFINE_CHUNKS = {"plan": {}, "one": dict(MIN_CHUNK=1, BLOCKS_PER_SM=10**6),
                  "wide": dict(MIN_CHUNK=64), "slots16": {}}


def _padded_fit(t, kind, chunk, smem_max=None):
    part, chunk, smem = _AFFINE_FIT(t, kind, chunk, smem_max)
    lell = part["lell"]
    pad = np.full((16 - lell.shape[0], lell.shape[1]), -1, lell.dtype)
    return dict(part, lell=np.concatenate([lell, pad])), chunk, smem


@pytest.fixture(params=list(_AFFINE_CHUNKS))
def affine_chunk(request, monkeypatch):
    """The affine kernel on the chunk its plan picks, on chunks of one
    element and of 64, and with slot tables wider than the kernel's
    registers (plans made on the tables' first call)."""
    for k, v in _AFFINE_CHUNKS[request.param].items():
        monkeypatch.setitem(kernels._AFFINE_PLAN, k, v)
    if request.param == "slots16":
        monkeypatch.setattr(kernels, "affine_fit", _padded_fit)
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("full_dofs", [False, True])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float64])
def test_affine_kernel_on_the_card(wdtype, full_dofs, affine_chunk):
    """The affine kernel in every mode and its fused residual against their
    plain versions on a Robin-penalized wake (outflow and arc facet rows),
    f32 and f64 vectors: within 1e-5 of each row's sum of absolute
    products, the same bits twice, one launch counted a call; every chunk
    gives the plan's bits."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from dolfin_navier_scipy_tpu_torch.control import apply_robin_penalty

    prob = cylinderwake_problem(level=0, Re=100, bccontrol=True)
    apply_robin_penalty(prob, palpha=1e-3)
    import copy

    aff = AffineVectorOps.build(prob, wdtype, full_dofs=full_dofs)
    # the rounding scale of each row: the plain version over the absolute
    # tables and |x| (the sum of the absolute products the row adds)
    absaff = copy.copy(aff)
    for k in ("W2", "W2T", "MrefI2", "N1q", "JinvT", "wdet", "detJ",
              "fac_elem"):
        setattr(absaff, k, getattr(aff, k).abs())
    rng = np.random.default_rng(19)
    for mode, cm, ca in (("m", 1.0, 0.0), ("a", 0.0, 1.0), ("ma", 1.0, 5e-3),
                         ("j", 1, 0), ("jt", 1, 0), ("res", 1.0, 5e-3)):
        n = aff.npc if mode == "jt" else aff.nin
        for xdt in (torch.float32, torch.float64):
            x = torch.from_numpy(rng.normal(size=n)).to(xdt).cuda()
            q = torch.from_numpy(rng.normal(size=aff.npc)).to(xdt).cuda()
            if mode == "res":
                wrapper = affine_residual

                def call(t=aff):
                    return affine_residual(x, q, t, cm, ca)
                ref = affine_residual_ref(x, q, aff, cm, ca)
                bar = 1e-5 * affine_residual_ref(
                    x.double().abs(), q.double().abs(), absaff, cm, ca)
            else:
                wrapper = affine_mv

                def call(t=aff):
                    return affine_mv(mode, x, t, cm, ca)
                ref = affine_mv_ref(mode, x, aff, cm, ca)
                bar = 1e-5 * affine_mv_ref(mode, x.double().abs(), absaff,
                                           cm, ca)
            before = wrapper.launches
            y = call()
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            err = (y.double() - ref.double()).abs()
            assert bool((err <= bar + 1e-30).all()), (
                mode, xdt, float((err / (bar + 1e-30)).max()))
            assert y.dtype == xdt
            assert torch.equal(y, call()), mode
            if affine_chunk != "plan":
                # the bits of the plan's own chunk
                with pytest.MonkeyPatch.context() as mp:
                    for k in _AFFINE_CHUNKS[affine_chunk]:
                        mp.setitem(kernels._AFFINE_PLAN, k,
                                   _AFFINE_PLAN_SHIPPED[k])
                    mp.setattr(kernels, "affine_fit", _AFFINE_FIT)
                    fresh = copy.copy(aff)
                    fresh._plans = {}
                    assert torch.equal(y, call(fresh)), (mode, xdt)


@pytest.mark.cuda
def test_affine_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = cylinderwake_problem(level=0, Re=100)
    aff = prob.affine_ops(torch.float32, device="cuda")
    v = torch.zeros(aff.nin, device="cuda")
    q = torch.zeros(aff.npc, device="cuda")
    with pytest.raises(ValueError, match="is on"):
        affine_residual(v, q.cpu(), aff)
    with pytest.raises(ValueError, match="is on"):
        affine_mv("m", v.cpu(), aff)
    with pytest.raises(TypeError):
        affine_residual(v.half(), q.half(), aff)
    with pytest.raises(TypeError):
        affine_mv("m", v.half(), aff)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme, per_step", [("cnab", 3), ("sbdf2", 4)])
def test_dense_inner_step_affine_launches(scheme, per_step):
    """The dense solver on the inner layout: a CNAB step makes 3 affine
    launches (A v, the continuity rhs's J v, and the refinement round's
    fused residual), an sbdf2 step 4 (M dv too); within 1e-6 of the CPU
    f64 run."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = drivencavity_problem(N=8, Re=100)
    kw = dict(prob=prob, t0=0.0, tE=0.2, Nts=20, start_ssstokes=True,
              linsolver="dense", save_every=5, state_layout="inner",
              time_int_scheme=scheme)
    solve_nse(**kw)                             # the plans, the inverse
    a0, r0 = affine_mv.launches, affine_residual.launches
    out = solve_nse(**kw)
    nsteps = 19
    assert affine_residual.launches - r0 == nsteps
    assert (affine_mv.launches - a0) + (affine_residual.launches - r0) == \
        per_step * nsteps
    ref = solve_nse(device="cpu", **kw)
    err = (torch.linalg.vector_norm(out["v"].cpu() - ref["v"])
           / torch.linalg.vector_norm(ref["v"]))
    assert float(err) <= 1e-6


@pytest.mark.cuda
def test_controlled_run_on_the_card_matches_the_cpu():
    """The rotating-cylinder control on the Schur route (inner layout, one
    refine round): two affine launches a step (A v, and J v for the
    continuity rhs), and within 1e-6 of the CPU f64 run on the exact
    solver; the control dofs carry the prescribed values."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    import math

    from dolfin_navier_scipy_tpu_torch.solve import DirichletControl

    prob = cylinderwake_problem(level=0, Re=100, movingwallcntrl=True)
    dofs, stencil = prob.dircntrl[0]
    ctl = [DirichletControl(dofs, stencil, lambda t, v, p, mem, mode: (
        math.sin(20.0 * t), mem))]
    kw = dict(prob=prob, t0=0.0, tE=0.02, Nts=20, start_ssstokes=True,
              save_every=5, controls=ctl)
    before = affine_mv.launches
    out = solve_nse(linsolver="schur", warm_refine=1, **kw)
    assert affine_mv.launches - before == 2 * 19
    ref = solve_nse(device="cpu", linsolver="dense", **kw)
    err = (torch.linalg.vector_norm(out["v"].cpu() - ref["v"])
           / torch.linalg.vector_norm(ref["v"]))
    assert float(err) <= 1e-6
    assert torch.equal(out["carry"]["cvals"].cpu(), math.sin(20.0 * 0.02)
                       * torch.from_numpy(np.asarray(stencil).ravel()))


# plan settings that give the element-matrix matvec chunks of one element
# and of 64 (its plan shares _AFFINE_PLAN with the affine kernel's)
_ELEM_CHUNKS = {"plan": {},
                "one": dict(MIN_CHUNK=1, ELEM_BLOCKS_PER_SM=10**6),
                "wide": dict(MIN_CHUNK=64)}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", list(_ELEM_CHUNKS))
@pytest.mark.parametrize("edtype, xdtype", [
    (torch.float32, torch.float32), (torch.float64, torch.float64),
    (torch.float64, torch.float32)])
def test_elem_mv_kernel_on_the_card(edtype, xdtype, chunk, monkeypatch):
    """B10 (csrc/elemmv.cu) against its plain version on the element
    operators of the wake (level 0): M, J and J^T with the Dirichlet trash
    slot, and with f32 tables the steady route's F blocks
    (``_sk_elem32``), on the plan's chunk and on chunks of one element and
    of 64: one kernel node a call, the same bits twice, on a graph replay
    and on the plan's chunk."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from dolfin_navier_scipy_tpu_torch.ops.elementop import (
        build_element_ops)
    from dolfin_navier_scipy_tpu_torch.ops.kernels import (
        DofTable, elem_mv, elem_mv_ref)
    from dolfin_navier_scipy_tpu_torch.solve.steady import (
        SteadyKrylovKernel, _sk_elem32)
    prob = cylinderwake_problem(level=0, Re=40, charvel=0.2)
    M, _, J = build_element_ops(prob, dtype=edtype, device="cuda")
    gen = torch.Generator().manual_seed(3)
    cases = [(M.elem, M.tab, M.tab, False), (J.elem, J.vtab, J.ptab, False),
             (J.elem, J.ptab, J.vtab, True)]
    if edtype == xdtype == torch.float32:
        sk = SteadyKrylovKernel(prob, device="cuda")
        v = torch.randn(prob.nv_full, generator=gen, dtype=torch.float64)
        cases.append((_sk_elem32(sk, v.cuda(), False), sk.ell_dofs,
                      sk.ell_dofs, False))
    for k, val in _ELEM_CHUNKS[chunk].items():
        monkeypatch.setitem(kernels._AFFINE_PLAN, k, val)
    for E, tin, tout, tr in cases:
        x = torch.randn(tin.nseg, generator=gen, dtype=torch.float64).to(
            device="cuda", dtype=xdtype)
        before = elem_mv.launches
        y = elem_mv(E, x, tin, tout, transpose=tr)
        assert elem_mv.launches == before + 1
        ref = elem_mv_ref(E, x, tin, tout, transpose=tr)
        assert y.dtype == xdtype and y.shape == ref.shape
        tol = 1e-6 if xdtype == torch.float32 else 1e-12
        err = (y.double() - ref.double()).norm() / ref.double().norm()
        assert float(err) <= tol, (tr, float(err))
        assert torch.equal(y, elem_mv(E, x, tin, tout, transpose=tr))
        types, replayed = _captured(
            lambda: elem_mv(E, x, tin, tout, transpose=tr))
        assert types.count(0) == 1, types
        assert torch.equal(replayed, y)
        # the shipped plan's chunk, on tables of its own: the same bits
        fout = DofTable(tout.vd, tout.nseg)
        fin = fout if tin is tout else DofTable(tin.vd, tin.nseg)
        with monkeypatch.context() as m:
            for k, val in _AFFINE_PLAN_SHIPPED.items():
                m.setitem(kernels._AFFINE_PLAN, k, val)
            assert torch.equal(elem_mv(E, x, fin, fout, transpose=tr), y)
    with pytest.raises(ValueError):
        elem_mv(M.elem, torch.zeros(3, device="cuda"), M.tab, M.tab)


@pytest.mark.cuda
def test_steady_routes_on_the_card_match_the_cpu():
    """Wake level 0, Re 40: the dense route and the matrix-free route on
    the card against the CPU's dense route (the fixed points agree to the
    Newton tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from dolfin_navier_scipy_tpu_torch.ops.kernels import elem_mv
    from dolfin_navier_scipy_tpu_torch.solve import solve_steadystate_nse
    prob = cylinderwake_problem(level=0, Re=40, charvel=0.2)
    kw = dict(return_vp=True, return_nwtnupd_norms=True, verbose=False,
              vel_pcrd_stps=2, vel_nwtn_stps=8, vel_nwtn_tol=1e-12)
    (vc, pc), _ = solve_steadystate_nse(prob, linsolver="dense",
                                        device="cpu", **kw)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    (vd, pd), nd = solve_steadystate_nse(prob, linsolver="dense", **kw)
    assert nd[-1] < 1e-12 and rel(vd, vc) <= 1e-10 and rel(pd, pc) <= 1e-8
    stats = {}
    before = elem_mv.launches
    (vk, pk), nk = solve_steadystate_nse(prob, linsolver="krylov",
                                         stats=stats, **kw)
    assert elem_mv.launches - before == stats["n_fmv"] > 0
    assert nk[-1] < 1e-12 and rel(vk, vc) <= 1e-10 and rel(pk, pc) <= 1e-8


@pytest.mark.cuda
def test_int8_rect_mv_on_the_card():
    """The banded tail's 0/1 products: int8 blocks under an f32 or an f64
    x against the plain version (exact products, f32 sums), at the tail's
    shapes at wake level 0 and at ragged ones (w not a multiple of 16,
    windows past x's end, a short last row block); the plan picks the
    warp-per-row kernel for every int8 shape; ``out`` is written in place;
    the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(21)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nblk, bs, w, nrows, nx in [(9, 256, 384, 2058, 12072),
                                   (48, 256, 256, 12072, 2058),
                                   (5, 48, 77, 230, 150), (2, 256, 16, 300,
                                                           40)]:
        assert kernels.bandmv_plan(nblk, bs, w, kernels.vecmat_ld(w, 1), 1,
                                   sms).kernel == "rows"
        B = _int8_blocks(rng, nblk, bs, w)
        bases = _windows_bases(nblk, w, nx, rng)
        for xdt in (torch.float32, torch.float64):
            x = torch.from_numpy(rng.normal(size=nx)).to(xdt).cuda()
            before = rect_mv.launches, rect_mv.storage_launches["int8"]
            got = rect_mv(B, bases, x, nrows)
            torch.cuda.synchronize()
            assert (rect_mv.launches, rect_mv.storage_launches["int8"]) == (
                before[0] + 1, before[1] + 1)
            ref = rect_mv_ref(B, bases, x.float(), nrows)
            assert got.dtype == torch.float32 and got.shape == ref.shape
            tol = 1e-6 * w ** 0.5 * float(ref.abs().max()) + 1e-6
            assert float((got - ref).abs().max()) <= tol, (nblk, bs, w)
            out = torch.full((nrows,), float("nan"), device="cuda")
            assert rect_mv(B, bases, x, nrows, out=out) is out
            assert torch.equal(out, got)
    with pytest.raises(TypeError):
        rect_mv(B, bases, x.half(), nrows)


@pytest.mark.cuda
def test_conv_quad_on_the_card():
    """The tail's quadrature against its plain version (the JAX package's
    einsum chain) within 1e-5 of each row's sum of absolute products."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    prob = cylinderwake_problem(level=0, Re=100)
    t = prob.conv_kernel_on(torch.float32).tables
    rng = np.random.default_rng(22)
    ue = torch.from_numpy(rng.normal(size=t.nc * t.nd)).float().cuda()
    ue_bc = torch.from_numpy(rng.normal(size=(t.nc, t.nd))).float().cuda()
    before = conv_quad.launches
    got = conv_quad(ue, ue_bc, t)
    torch.cuda.synchronize()
    assert conv_quad.launches == before + 1
    ref = conv_quad_ref(ue.double(), ue_bc.double(),
                        prob.conv_kernel_on(torch.float64).tables)
    # the same chain with every factor made positive bounds each row's
    # sum of absolute products
    t64 = prob.conv_kernel_on(torch.float64).tables
    scale = _abs_chain(ue.double().abs(), ue_bc.double().abs(), t64)
    assert float(((got.double() - ref).abs() / (scale + 1e-30)).max()) \
        <= 1e-5
    assert torch.equal(got, conv_quad(ue, ue_bc, t))
    with pytest.raises(TypeError):
        conv_quad(ue.double(), ue_bc.double(),
                  prob.conv_kernel_on(torch.float64).tables)


def _abs_chain(ue, ue_bc, t):
    """:func:`conv_quad_ref` with the absolute values of every factor: a
    bound on each row's sum of absolute products."""
    import copy
    ta = copy.copy(t)
    ta.JinvT, ta.wdet = t.JinvT.abs(), t.wdet.abs()
    W1, W2, W2T, W3 = t.plain_weights()
    ta._plain = tuple(w.abs() for w in (W1, W2, W2T, W3))
    return conv_quad_ref(ue, ue_bc, ta)


def _wspace_kernel(prob, dt=1e-3):
    """The w-space kernel and bc tail of a Schur solver's order."""
    from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops
    ops = _build_ops(prob, dt, theta=0.5, linsolver="schur", layout="full",
                     device="cuda")
    slv = ops.solver
    nf, nin = prob.nv_full, slv._nin
    wsrc = np.concatenate([slv.permf.cpu().numpy(), np.setdiff1d(
        np.arange(nf), np.asarray(prob.invinds))]).astype(np.int64)
    iposx = np.full(nf + 1, nf, np.int64)
    iposx[wsrc] = np.arange(nf)
    kern = prob.conv_kernel_on(torch.float32).with_dof_map(
        torch.as_tensor(iposx, device="cuda"))
    vbc = np.asarray(prob.bc_full_vec()).ravel()[wsrc]
    return kern, nin, vbc


@pytest.mark.cuda
def test_banded_tail_on_the_card_matches_b5():
    """Wake level 0: the forced tail (int8 blocks) against the element
    kernel on the same w-space state within 1e-5 of max|B5|, zero bc rows;
    three launches a vector (G, the quadrature, S), one kernel node each in
    a captured graph, and a replay equal to the eager call."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from dolfin_navier_scipy_tpu_torch.ops.banded_conv import (
        build_banded_conv_tail)
    prob = cylinderwake_problem(level=0, Re=100)
    kern, nin, vbc = _wspace_kernel(prob)
    bct = build_banded_conv_tail(kern, nin, vbc[nin:], force=True)
    assert bct.store == "int8" and bct.Sb.dtype == torch.int8
    v = vbc.copy()
    v[:nin] = np.random.default_rng(23).normal(size=nin)
    vt = torch.from_numpy(v).cuda()
    ref = kern.vector(vt)
    before = rect_mv.launches, conv_quad.launches
    got = bct.vector(vt).clone()
    torch.cuda.synchronize()
    assert (rect_mv.launches, conv_quad.launches) == (before[0] + 2,
                                                      before[1] + 1)
    assert float((got[:nin] - ref[:nin].float()).abs().max()) <= \
        1e-5 * float(ref.abs().max())
    assert not got[nin:].any()
    types, replayed = _captured(lambda: bct.vector(vt))
    assert types.count(0) == 3, types
    assert torch.equal(replayed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("linsolver", ["dense", "schur"])
def test_newton_in_time_on_the_card_matches_the_cpu(linsolver):
    """Wake level 0, Re 40, a perturbed steady start: Newton-in-time on the
    card (f64 Krylov vectors and tables, the preconditioner in f32) against
    the port's CPU f64 run within 1e-8; launches from the sweep counts."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from dolfin_navier_scipy_tpu_torch.ops.kernels import (
        affine_residual, elem_mv)
    from dolfin_navier_scipy_tpu_torch.solve import (
        solve_nse_newton_ti, solve_steadystate_nse)
    prob = cylinderwake_problem(level=0, Re=40, charvel=0.2)
    vss = solve_steadystate_nse(prob, linsolver="host-sparse",
                                vel_nwtn_tol=1e-10, device="cpu")
    v0 = vss.ravel()[prob.invinds]
    v0 = v0 + 0.01 * np.random.default_rng(2).normal(size=len(v0))
    kw = dict(trange=np.linspace(0.0, 0.004, 5), iniv=v0,
              inip=np.zeros(prob.np_cond), vel_nwtn_stps=3,
              vel_nwtn_tol=1e-11, save_every=None, linsolver=linsolver)
    cpu = solve_nse_newton_ti(prob=prob, device="cpu", **kw)
    before = (conv_vector.launches, elem_mv.launches,
              affine_residual.launches, vecmat.launches)
    out = solve_nse_newton_ti(prob=prob, **kw)
    st = out["stats"]
    nts = 4
    assert out["v"].is_cuda and out["v"].dtype == torch.float64
    assert (conv_vector.launches - before[0]
            == 3 * (nts + 1) * st["sweeps"])
    assert elem_mv.launches - before[1] == st["matvecs"] + nts * st[
        "sweeps"]
    assert affine_residual.launches - before[2] == st["matvecs"]
    if linsolver == "dense":
        assert vecmat.launches - before[3] == st["preconds"]
    for k in ("v", "v_traj"):
        a, b = out[k].cpu().numpy(), cpu[k].numpy()
        assert np.linalg.norm(a - b) <= 1e-8 * np.linalg.norm(b), k
    assert out["nwtn_norms"][-1] < 1e-8
