"""The dense inverse apply: plain version vs the Pallas kernel (interpret
mode) and numpy; the CPU route of the wrapper; the launch plan.  The
banded matvecs' ring kernel: its launch plan and its schedule, replayed in
numpy.  The convection wrappers: the fixed-order reduction table, the
kernel's index tables, the argument checks and the CPU route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.ops.pallas_kernels import vecmat_pallas
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    band_operand, banded_mv_ref, bandmv_plan, conv_vector,
    conv_vector_amatvec, conv_vector_amatvec_ref, conv_vector_ref,
    dof_slot_table, rect_mv_ref, reduce_slots_ref, vecmat, vecmat_plan,
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


def _units(m, n, plan):
    """The kernel's units in ticket order, ``(row0, row1, col0, col1)``:
    unit ``u`` is row slab ``u // tiles``, column tile ``u % tiles``."""
    tiles = -(-n // plan.box_cols)
    return [(r * plan.box_rows, min(m, (r + 1) * plan.box_rows),
             c * plan.box_cols, min(n, (c + 1) * plan.box_cols))
            for r in range(plan.slabs) for c in range(tiles)]


@pytest.mark.parametrize("m,n", [(8794, 8794), (2049, 1023), (1, 1),
                                 (31, 100000), (300000, 8), (8016, 8016),
                                 (4097, 257)])
def test_vecmat_plan_covers_every_row_within_shared_memory(m, n):
    # the kernel is built from the same geometry the plan reads
    flags = kernels._SOURCE_FLAGS["vecmat"]
    for itemsize in (4, 8):
        per = 16 // itemsize
        plan = vecmat_plan(m, n, sm_count=132, itemsize=itemsize)
        assert f"-DVECMAT_BOX_ROWS={plan.box_rows}" in flags
        assert f"-DVECMAT_GROUPS={plan.box_cols * itemsize // 16}" in flags
        assert f"-DVECMAT_STAGES={plan.stages}" in flags
        assert plan.blocks == 132
        assert plan.ld >= n and plan.ld * itemsize % 16 == 0
        assert plan.ld - n < per                     # padding < 16 bytes
        # a box is one tensor copy: at most 256 per side, 16-byte rows
        assert plan.box_rows <= 256 and plan.box_cols <= 256
        assert plan.box_cols * itemsize % 16 == 0
        assert plan.smem_bytes <= 232448             # 227 KB a block
        assert plan.smem_bytes >= (plan.stages * plan.box_rows
                                   * plan.box_cols * itemsize)
        # the (slabs, n) scratch holds one row per slab, and the slabs
        # cover the rows exactly: none is left out, none runs past m
        assert (plan.slabs - 1) * plan.box_rows < m <= plan.slabs * plan.box_rows
        # the units tile rows x columns exactly once, slab by slab
        units = _units(m, n, plan)
        ntiles = len(units) // plan.slabs
        for r in range(plan.slabs):
            tiles = units[r * ntiles:(r + 1) * ntiles]
            assert all(u[:2] == (r * plan.box_rows,
                                 min(m, (r + 1) * plan.box_rows))
                       for u in tiles)
            assert tiles[0][2] == 0 and tiles[-1][3] == n
            assert all(a[3] == b[2] for a, b in zip(tiles, tiles[1:]))
        assert units[-1][1] == m
        covered = sum((u[1] - u[0]) * (u[3] - u[2]) for u in units)
        assert covered == m * n


@pytest.mark.parametrize("m,n", [(8794, 8794), (8016, 8016), (2049, 1023)])
def test_vecmat_plan_fills_the_card_at_the_main_path_shape(m, n):
    """One block per SM, and work in units small against an SM's share.

    Equal bytes per SM are not equal time on the card (the SMs of such a
    split finish far apart), so the kernel hands out units from a counter:
    an SM then carries its mean share plus at most the unit it took last.
    A unit is at most 64 KB; at the main-path shapes that is under 4 % of
    an SM's mean share, and the units outnumber the SMs 30 to 1."""
    for itemsize in (4, 8):
        plan = vecmat_plan(m, n, sm_count=132, itemsize=itemsize)
        assert plan.blocks == 132
        units = _units(m, n, plan)
        size = [(u[1] - u[0]) * (u[3] - u[2]) * itemsize for u in units]
        assert plan.box_rows * plan.box_cols * itemsize == 64 * 1024
        assert max(size) <= 64 * 1024
        if m > 4000:
            assert max(size) <= 0.04 * m * n * itemsize / plan.blocks
            assert len(units) >= 30 * plan.blocks


# -- the banded matvecs' ring kernel (csrc/bandmv.cu) -------------------------

def _ring_units(plan, nblk, bs, nrows):
    """The ring kernel's units, ``block -> [(row, k, i, rows), ...]``: the
    row blocks cut into runs of ``plan.unit_rows`` rows (the last at
    ``bs``), all cut at ``nrows``, split in order into equal shares of the
    blocks (the first ``units % blocks`` one more)."""
    upb = -(-bs // plan.unit_rows)
    units = []
    for u in range(nblk * upb):
        k, i = divmod(u, upb)
        i *= plan.unit_rows
        row = k * bs + i
        if row >= nrows:
            break
        units.append((row, k, i, min(plan.unit_rows, bs - i, nrows - row)))
    per, rem = divmod(len(units), plan.blocks)
    out = {}
    for b in range(plan.blocks):
        u0 = b * per + min(b, rem)
        out[b] = units[u0:u0 + per + (b < rem)]
    return out


# (nblk, bs, w, nrows): the main path's E/F bands, J and J^T at levels 1
# and 2; ragged: nrows < nblk*bs, w not a multiple of 4, one block, bs 1
_RING_SHAPES = {
    "E_L1": (19, 384, 1152, 6994), "E_L2": (51, 512, 1536, 25966),
    "J_L1": (8, 128, 1408, 1022), "J_L2": (28, 128, 2048, 3541),
    "JT_L1": (19, 384, 256, 6994), "JT_L2": (51, 512, 256, 25966),
    "ragged": (3, 40, 101, 101), "one_block": (1, 1022, 77, 1000),
    "bs_1": (50, 1, 9, 50), "short_rows": (5, 48, 6, 230),
}


def _ring_plan(monkeypatch, nblk, bs, w, ld, sm_count=132):
    """The ring kernel's plan for a shape, whichever kernel the shipped
    plan picks for it."""
    monkeypatch.setitem(kernels._BANDMV_PLAN, "RING_GRID_BELOW", 1 << 30)
    plan = bandmv_plan(nblk, bs, w, ld, 4, sm_count=sm_count)
    assert plan.kernel == "ring"
    return plan


@pytest.mark.parametrize("shape", list(_RING_SHAPES.values()),
                         ids=list(_RING_SHAPES))
def test_bandmv_plan_covers_every_row_within_shared_memory(shape,
                                                           monkeypatch):
    nblk, bs, w, nrows = shape
    for key, value in kernels._BANDMV_GEOMETRY.items():
        assert f"-DBANDMV_{key}={value}" in kernels._SOURCE_FLAGS["bandmv"]
    ld = -(-w // 4) * 4                          # band_operand's rows
    nvec = -(-w // 4)
    plan = _ring_plan(monkeypatch, nblk, bs, w, ld)
    # the kernel's layout: two mbarriers a slot, the x window, the ring
    assert plan.slot_bytes == plan.unit_rows * ld * 4
    # per slot: two mbarriers, a header, the x window, the rows
    assert plan.smem_bytes == plan.stages * (32 + 16 * nvec + plan.slot_bytes)
    assert plan.smem_bytes <= 232448                 # 227 KB a block
    shares = _ring_units(plan, nblk, bs, nrows)
    units = [u for share in shares.values() for u in share]
    # every row exactly once, each unit whole rows of one row block
    covered = sorted(r for row, _, _, n in units
                     for r in range(row, row + n))
    assert covered == list(range(nrows))
    for row, k, i, n in units:
        assert row == k * bs + i and 1 <= n <= plan.unit_rows
        assert i + n <= bs
        # one bulk copy: 16-byte aligned, a multiple of 16 bytes, in a slot
        start, nbytes = 4 * (k * bs * ld + i * ld), 4 * ((n - 1) * ld + 4 * nvec)
        assert start % 16 == 0 and nbytes % 16 == 0
        assert nbytes <= plan.slot_bytes
    # equal shares; the ring holds a block's share where RING_BYTES allows
    sizes = [len(share) for share in shares.values()]
    assert max(sizes) - min(sizes) <= 1
    assert plan.stages >= min(max(sizes),
                              kernels._BANDMV_PLAN["RING_BYTES"]
                              // plan.slot_bytes)
    if nblk * bs >= 1000:
        # a small operand still spreads over the card: a block an SM, every
        # one with units, two copies in flight where it has two units
        assert plan.blocks == 132 and min(sizes) >= 1
        assert plan.stages >= min(2, max(sizes))


@pytest.mark.parametrize("form,shape", [
    ("banded", (3, 40, 120, 101)), ("banded", (1, 64, 192, 50)),
    ("rect", (5, 48, 77, 230)), ("rect", (8, 128, 1408, 1022)),
    ("rect", (50, 1, 9, 50)), ("rect", (6, 16, 6, 90))])
def test_bandmv_ring_schedule_replays_the_product(form, shape, monkeypatch):
    """The ring kernel's schedule replayed in numpy on the operand's flat
    storage, its padding filled with NaN: each unit's bulk copy (whole rows
    but the last, which stops at its last vector inside w), the x window
    of its row block, the masked padding — every row written once, equal
    to the plain version, and no copy reads past the storage."""
    nblk, bs, w, n = shape
    rng = np.random.default_rng(7)
    B = band_operand((nblk, bs, w), torch.float32)
    B.copy_(torch.from_numpy(rng.normal(size=(nblk, bs, w))))
    ld, sblk = B.stride(1), B.stride(0)
    flat = B.as_strided((nblk * sblk,), (1,)).clone().numpy()
    flat.reshape(nblk, bs, ld)[..., w:] = np.nan
    if form == "banded":
        nx = nrows = n
        base = (np.arange(nblk) - 1) * bs
        x = rng.normal(size=nx).astype(np.float32)
        ref = banded_mv_ref(B, torch.from_numpy(x)).numpy()
    else:
        nrows, nx = n, w + 40
        # window starts at both edges of x and past them
        base = np.sort(rng.integers(-w // 2, nx - w // 2, size=nblk))
        base[0], base[-1] = -3, nx - 2
        x = rng.normal(size=nx).astype(np.float32)
        ref = rect_mv_ref(B, torch.from_numpy(base.astype(np.int32)),
                          torch.from_numpy(x), nrows).numpy()
    plan = _ring_plan(monkeypatch, nblk, bs, w, ld, sm_count=4)
    nvec = -(-w // 4)
    y = np.full(nrows, np.nan)
    for row, k, i, m in (u for share in _ring_units(plan, nblk, bs,
                                                    nrows).values()
                         for u in share):
        start, count = k * sblk + i * ld, (m - 1) * ld + 4 * nvec
        assert start + count <= flat.size
        slab = np.zeros(m * ld, np.float32)
        slab[:count] = flat[start:start + count]
        rows = slab.reshape(m, ld)[:, :4 * nvec].copy()
        rows[:, w:] = 0.0                        # the masked padding
        g = base[k] + np.arange(4 * nvec)
        inside = (np.arange(4 * nvec) < w) & (g >= 0) & (g < nx)
        xs = np.where(inside, x[np.clip(g, 0, nx - 1)], 0.0)
        assert np.isnan(y[row:row + m]).all()    # written once
        y[row:row + m] = rows.astype(np.float64) @ xs
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


def test_bandmv_plan_refuses_rows_past_shared_memory():
    # one row block of 8 rows would take the ring kernel, but a row of
    # 30000 f32 and its window do not fit a block: the warp-per-row kernel
    # (its window alone) takes it; past 227 KB of window neither can
    plan = bandmv_plan(1, 8, 30000, 30000, 4, sm_count=132)
    assert plan.kernel == "rows"
    assert bandmv_plan(1, 8, 20000, 20000, 4, sm_count=132).kernel == "ring"
    with pytest.raises(ValueError, match="shared memory"):
        bandmv_plan(1, 8, 60000, 60000, 4, sm_count=132)
    with pytest.raises(ValueError):
        bandmv_plan(2, 8, 30, 31, 4, sm_count=132)   # rows not 16-byte apart


@pytest.mark.parametrize("name,shape,kernel", [
    ("J_L1", _RING_SHAPES["J_L1"], "ring"),
    ("E_L1", _RING_SHAPES["E_L1"], "rows"),
    ("E_L2", _RING_SHAPES["E_L2"], "rows"),
    ("J_L2", _RING_SHAPES["J_L2"], "rows"),
    ("JT_L1", _RING_SHAPES["JT_L1"], "rows"),
    ("JT_L2", _RING_SHAPES["JT_L2"], "rows"),
    ("one_block", _RING_SHAPES["one_block"], "ring")])
def test_bandmv_plan_takes_the_ring_where_row_blocks_cannot_fill_the_card(
        name, shape, kernel):
    """A single-level f32 product takes the ring kernel where the
    warp-per-row kernel's grid (a block of ROWS rows) has fewer blocks than
    the card has SMs; elsewhere the warp-per-row kernel was as fast or
    faster on an H100 (PERF.md)."""
    nblk, bs, w, _ = shape
    plan = bandmv_plan(nblk, bs, w, -(-w // 4) * 4, 4, sm_count=132)
    rows = kernels._BANDMV_GEOMETRY["ROWS"]
    assert plan.kernel == kernel
    assert (nblk * -(-bs // rows) < 132) == (kernel == "ring")
    if kernel == "rows":
        assert plan.blocks == nblk * -(-bs // rows)


# -- the level stacks of rect_mv_levels (csrc/bandmv.cu: stack_plan) ---------

# (nblk, levels, bs, w): W, X and S^-1 of the default route at levels 1-3
_STACK_SHAPES = {
    "W_L1": (19, 3, 384, 1664), "X_L1": (19, 2, 384, 1022),
    "S_L1": (1, 3, 1022, 1022), "W_L2": (51, 3, 512, 2688),
    "X_L2": (51, 2, 512, 2048), "S_L2": (1, 3, 3541, 3541),
    "W_L3": (112, 3, 896, 5248), "X_L3": (112, 2, 896, 3456),
    "S_L3": (1, 3, 13062, 13062),
}


def _share_rows(plan, nrows):
    """The share kernel's rows, ``block -> range``: ``nrows`` cut into
    ``plan.blocks`` equal contiguous shares, the first ``nrows % blocks``
    one row longer."""
    per, rem = divmod(nrows, plan.blocks)
    return {b: range(b * per + min(b, rem), b * per + min(b, rem) + per
                     + (b < rem)) for b in range(plan.blocks)}


def _stack_forms(nblk, levels, bs, w, ld, itemsize, sm_count):
    out = {}
    for form in ("rows", "share", "ring"):
        try:
            out[form] = kernels.stack_plan(nblk, levels, bs, w, ld, itemsize,
                                           sm_count, form)
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("shape", list(_STACK_SHAPES.values()),
                         ids=list(_STACK_SHAPES))
def test_stack_plan_covers_every_row_of_every_level_within_shared_memory(
        shape):
    """Each form a level stack can take, from its shape alone: every row of
    every level read exactly once, each bulk copy 16-byte aligned and
    inside its slot, each block within 227 KB of shared memory."""
    nblk, levels, bs, w = shape
    item, vec = 2, 8
    ld = -(-w // vec) * vec                       # band_operand's rows
    sblk, slev, nvec = levels * bs * ld, bs * ld, -(-w // vec)
    nrows = nblk * bs - (bs // 3 if nblk > 1 else 0)     # a ragged end
    forms = _stack_forms(nblk, levels, bs, w, ld, item, 132)
    assert set(forms) >= {"rows", "share"}
    chosen = kernels.stack_plan(nblk, levels, bs, w, ld, item, 132)
    assert chosen.kernel in forms
    window = 4 * (-(-w // 8) * 8)
    rows = forms["rows"]
    assert rows.blocks == nblk * -(-bs // kernels._BANDMV_GEOMETRY["ROWS"])
    assert rows.smem_bytes == window <= 232448
    # the forced share grid and, where the plan picks it, the plan's
    for share in {forms["share"], chosen} - {rows, forms.get("ring")}:
        assert share.kernel == "share"
        assert share.smem_bytes == window <= 232448
        shares = _share_rows(share, nrows)
        assert [r for b in range(share.blocks) for r in shares[b]] == \
            list(range(nrows))
        sizes = [len(r) for r in shares.values()]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    ring = forms.get("ring")
    if ring is None:
        # one row of every level beside its window is past 227 KB
        assert 32 + 4 * vec * nvec + levels * ld * item > 232448
        return
    assert ring.slot_bytes == ring.unit_rows * levels * ld * item
    assert ring.smem_bytes == ring.stages * (32 + 4 * vec * nvec
                                             + ring.slot_bytes) <= 232448
    units = [u for share in _ring_units(ring, nblk, bs, nrows).values()
             for u in share]
    covered = sorted(r for row, _, _, n in units
                     for r in range(row, row + n))
    assert covered == list(range(nrows))
    for row, k, i, n in units:
        assert row == k * bs + i and 1 <= n <= ring.unit_rows and i + n <= bs
        for lev in range(levels):
            # one bulk copy a level: whole rows, the last to its last vector
            start = item * (k * sblk + lev * slev + i * ld)
            nbytes = item * ((n - 1) * ld + vec * nvec)
            assert start % 16 == 0 and nbytes % 16 == 0
            assert nbytes <= ring.slot_bytes // levels
            assert start + nbytes <= item * nblk * sblk


def _replay_stack(form, plan, B, base, x, nrows):
    """The kernel form's schedule replayed in numpy on the stack's flat
    storage (its padding NaN): the share kernel's row shares, each row
    block's window staged once a share; or the ring's units, one copy a
    level.  Every row written once, the level dots added in order."""
    nblk, levels, bs, w = B.shape
    sblk, slev, ld = B.stride(0), B.stride(1), B.stride(2)
    vec = 16 // B.element_size()
    nvec = -(-w // vec)
    flat = B.as_strided((nblk * sblk,), (1,)).float().numpy().copy()
    flat.reshape(nblk, -1, bs, ld)[..., w:] = np.nan
    nx = len(x)
    y = np.full(nrows, np.nan)

    def window(k):
        g = base[k] + np.arange(vec * nvec)
        inside = (np.arange(vec * nvec) < w) & (g >= 0) & (g < nx)
        return np.where(inside, x[np.clip(g, 0, nx - 1)], 0.0)

    def rows_of(k, i, m, lev_rows):
        # lev_rows[l]: the m rows of level l as read (ld apart), masked
        xs = window(k)
        tot = 0.0
        for lev in range(levels):
            r = lev_rows[lev].reshape(m, ld)[:, :vec * nvec].copy()
            r[:, w:] = 0.0
            tot = tot + r.astype(np.float64) @ xs
        assert np.isnan(y[k * bs + i:k * bs + i + m]).all()   # once
        y[k * bs + i:k * bs + i + m] = tot

    if form == "share":
        for rows in _share_rows(plan, nrows).values():
            for row in rows:
                k, i = divmod(row, bs)
                start = k * sblk + i * ld
                rows_of(k, i, 1, [flat[start + lev * slev:
                                       start + lev * slev + ld]
                                  for lev in range(levels)])
    else:
        for row, k, i, m in (u for share in _ring_units(plan, nblk, bs,
                                                        nrows).values()
                             for u in share):
            count = (m - 1) * ld + vec * nvec
            slabs = []
            for lev in range(levels):
                start = k * sblk + lev * slev + i * ld
                assert start + count <= flat.size
                slab = np.zeros(m * ld, np.float32)
                slab[:count] = flat[start:start + count]
                slabs.append(slab)
            rows_of(k, i, m, slabs)
    return y


@pytest.mark.parametrize("form", ["share", "ring"])
@pytest.mark.parametrize("case", [
    (3, 5, 40, 101, 200, False, torch.bfloat16),   # ragged end, 3 levels
    (2, 4, 48, 77, 192, True, torch.bfloat16),     # hi_only
    (1, 3, 90, 90, 90, False, torch.bfloat16),     # one row block, base 0
    (1, 6, 16, 30, 80, False, torch.bfloat16),     # one level
    (3, 3, 32, 45, 90, False, torch.float32)])     # f32 levels
def test_stack_schedule_replays_the_product(form, case):
    """The share kernel's and the ring's schedules over a level stack,
    replayed in numpy on the storage with NaN padding, window starts
    before 0 and past the end of x: equal to ``rect_mv_levels_ref``."""
    levels, nblk, bs, w, n, hi, dtype = case
    rng = np.random.default_rng(11)
    S = band_operand((nblk, levels, bs, w), dtype)
    S.copy_(torch.from_numpy(rng.normal(size=(nblk, levels, bs, w))))
    nx = w + 40
    if nblk == 1:
        base = np.zeros(1, np.int64)
        nx = w
    else:
        base = np.sort(rng.integers(-w // 2, nx - w // 2, size=nblk))
        base[0], base[-1] = -3, nx - 2
    x = rng.normal(size=nx).astype(np.float32)
    nrows = min(n, nblk * bs)
    ref = kernels.rect_mv_levels_ref(
        S, torch.from_numpy(base.astype(np.int32)), torch.from_numpy(x),
        nrows, hi).numpy()
    St = S[:, :1] if hi else S
    plan = kernels.stack_plan(nblk, St.shape[1], bs, w, S.stride(2),
                              S.element_size(), 4, form)
    assert plan.kernel == form
    y = _replay_stack(form, plan, St, base, x, nrows)
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,levels,kernel", [
    ("W_L1", 3, "ring"), ("W_L1", 1, "rows"), ("X_L1", 2, "rows"),
    ("S_L1", 3, "share"), ("W_L2", 3, "rows"), ("W_L2", 1, "rows"),
    ("X_L2", 2, "rows"), ("S_L2", 3, "share"), ("W_L3", 3, "share"),
    ("W_L3", 1, "rows"), ("X_L3", 2, "rows"), ("S_L3", 3, "share")])
def test_stack_plan_picks_the_form_measured_fastest(name, levels, kernel):
    """The form the plan picks for each level stack of the default route
    (W's level 0 alone: levels 1), the fastest of the three on an H100 in
    turns (PERF.md): the share kernel for the one row block of S^-1 and for
    W's 3 levels under a window of 16 KB or more, the ring for W at level 1
    (its warp-per-row grid runs a wave and a bit), the warp-per-row kernel
    elsewhere."""
    nblk, _, bs, w = _STACK_SHAPES[name]
    plan = kernels.stack_plan(nblk, levels, bs, w, -(-w // 8) * 8, 2, 132)
    assert plan.kernel == kernel
    if kernel == "share" and nblk == 1:
        assert plan.blocks == 2 * 132            # persistent, two an SM
    elif kernel == "share":
        assert plan.blocks == -(-nblk * bs // 8)   # 8 rows a block


def test_stack_plan_fills_every_sm_for_the_level_1_schur_inverse():
    """``S^-1`` at level 1 is one row block of 1022 rows: the warp-per-row
    grid (64 blocks of 16 rows) leaves half of 132 SMs idle; the plan's
    form gives every SM rows."""
    nblk, levels, bs, w = _STACK_SHAPES["S_L1"]
    plan = kernels.stack_plan(nblk, levels, bs, w, 1024, 2, 132)
    assert plan.kernel != "rows" and plan.blocks >= 132
    if plan.kernel == "ring":
        per = _ring_units(plan, nblk, bs, bs).values()
    else:
        per = _share_rows(plan, bs).values()
    assert min(len(p) for p in per) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vecmat_operand_rows_are_16_byte_aligned(dtype):
    rng = np.random.default_rng(3)
    m, n = 37, 8794 // 2 + 1                      # odd width: padding
    A = torch.from_numpy(rng.normal(size=(m, n))).to(dtype)
    KT = kernels.as_vecmat_operand(A)
    assert KT.shape == (m, n) and KT.dtype == dtype and KT.stride(1) == 1
    assert KT.stride(0) * KT.element_size() % 16 == 0
    assert KT.stride(0) - n < 16 // KT.element_size()
    assert torch.equal(KT, A)
    z = kernels.vecmat_operand(m, n, dtype)
    assert torch.equal(z, torch.zeros(m, n, dtype=dtype))
    assert z.stride() == KT.stride()
    x = torch.from_numpy(rng.normal(size=(m,))).to(dtype)
    assert torch.equal(vecmat(x, KT), x @ A)
    assert torch.equal(vecmat(x, KT), vecmat_ref(x, KT))

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
    vd32, ell = t.kernel_tables()
    rowptr, slots = t.dofs.slot_table()
    assert vd32.dtype == torch.int32 and ell.dtype == torch.int32
    assert torch.equal(vd32.long(), t.vd) and vd32.is_contiguous()
    # slot k of dof i is the flat position e*nd + j with vd[e, j] == i
    owner = t.vd.reshape(-1)[torch.from_numpy(slots).long()]
    assert torch.equal(owner, torch.repeat_interleave(
        torch.arange(t.nv_full), torch.from_numpy(np.diff(rowptr)).long()))
    # the ELL table holds the same slots, dof-major, -1 past each count
    assert ell.shape == (int(np.diff(rowptr).max()), t.nv_full)
    assert ell.is_contiguous()
    assert int((ell >= 0).sum()) == len(slots)
    assert t.kernel_tables()[1] is ell                      # built once
    # the facet blocks' table is built once too, on the object that the
    # operator bundle keeps
    f1 = aff.fac_dofs.kernel_tables()
    assert aff.fac_dofs.kernel_tables()[0] is f1[0]
    assert torch.equal(f1[0].long(), aff.fac_vdofs)
    assert int((f1[1] >= 0).sum()) == aff.fac_vdofs.numel()
    # the plain version's weight matrices appear at its first call only
    fresh = t.with_vd(t.vd)
    fresh._plain = None
    conv_vector(torch.zeros(t.nv_full, dtype=torch.float64), None, fresh)
    assert fresh._plain is not None and fresh.plain_weights()[0].shape == (
        t.nd, t.dim * t.Q)
    # a re-indexed layout gets tables of its own
    perm = np.random.default_rng(6).permutation(t.nv_full)
    t2 = t.with_vd(torch.from_numpy(np.append(perm, t.nv_full))[t.vd])
    assert not torch.equal(t2.kernel_tables()[1], ell)
    assert torch.equal(t.kernel_tables()[1], ell)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_slot_table_keeps_the_fixed_order(dtype):
    """The kernel sums each dof's slots from the ELL table; in the order of
    the CSR table, so the CSR reduction stays its reference: bitwise."""
    _, t, aff = _wake()
    rng = np.random.default_rng(9)
    for table in (t.dofs, aff.fac_dofs):
        ids = table.vd.numpy().copy()
        ids[rng.random(ids.shape) < 0.05] = table.nseg   # dropped slots
        rowptr, slots = dof_slot_table(ids, table.nseg)
        ell = kernels.ell_slot_table(rowptr, slots)
        assert ell.dtype == np.int32 and ell.shape[1] == table.nseg
        vals = torch.from_numpy(rng.normal(size=ids.size).astype(dtype))
        by_ell = kernels.reduce_ell_ref(vals, torch.from_numpy(ell))
        by_csr = reduce_slots_ref(vals, torch.from_numpy(rowptr),
                                  torch.from_numpy(slots))
        assert torch.equal(by_ell, by_csr)


def test_conv_plan_is_built_once_per_table_set():
    prob, t, aff = _wake()
    fe, fv = aff.fac_elem, aff.fac_dofs
    p1 = t.kernel_plan(True, torch.float64, fe, fv)
    assert t.kernel_plan(True, torch.float64, fe, fv) is p1      # kept
    assert t.kernel_plan(False, torch.float64) is not p1          # form
    assert t.kernel_plan(True, torch.float32, fe, fv) is not p1   # state
    assert t.kernel_plan(True, torch.float64, fe, fv, stream=7) is not p1
    # what the C structure points at: the tables, the facet blocks in the
    # tables' type, a scratch for both loads and the facet rows
    vd32, ell = t.kernel_tables()
    c = p1.c
    assert (c.vd, c.ell, c.JinvT) == (vd32.data_ptr(), ell.data_ptr(),
                                      t.JinvT.data_ptr())
    assert (c.nc, c.nv_full, c.nfac, c.width) == (
        t.nc, t.nv_full, fe.shape[0], ell.shape[0])
    assert (c.fused, c.work_f64, c.u_f64) == (1, 1, 1)
    assert p1.scratch.numel() == 2 * t.nc * t.nd + fe.shape[0] * t.nd
    assert torch.equal(p1.bar, torch.zeros(2, dtype=torch.int32))
    # a permuted dof map: new tables, new ELL table, new plan
    perm = np.random.default_rng(10).permutation(t.nv_full)
    dofmap = torch.from_numpy(np.append(perm, t.nv_full))
    k2 = prob.conv_kernel.with_dof_map(dofmap)
    fv2 = fv.with_dof_map(dofmap)
    p2 = k2.tables.kernel_plan(True, torch.float64, fe, fv2)
    assert p2 is not p1 and p2.c.ell != c.ell and p2.c.fell != c.fell
    assert not torch.equal(k2.tables.kernel_tables()[1], ell)
    assert not torch.equal(fv2.kernel_tables()[1], fv.kernel_tables()[1])


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
