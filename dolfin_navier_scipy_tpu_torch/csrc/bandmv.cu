// Banded and static-window block matvecs for Hopper (sm_90a).
//
//   y[k*bs + i] = sum_{l < L} sum_{j < w} B[k, l, i, j] * x[base_k + j]
//
// for row blocks k < nblk, rows i < bs with k*bs + i < nrows; x is read as
// zero outside [0, nx) (no host padding), the L level dots of a row are
// reduced each on its own and added in level order.  Three forms (bound in
// ops/kernels.py), three kernels:
//
//   * banded_mv: L = 1, f32, w = 3 bs, base_k = (k - 1) bs — the block-
//     tridiagonal F_perm @ x of the RCM-banded saddle solver.  Replaces the
//     XLA einsum `_banded_mv` of dolfin_navier_scipy_tpu/solve/sadpnt.py
//     (no Pallas kernel there: eager torch would need a pad, two shifted
//     concatenations, a bmm and a slice).
//   * rect_mv: L = 1, f32, base_k = bases[k] — the static-window
//     rectangular product `_rect_mv` of the same file (J, J^T, and W / X
//     when stored in f32).
//   * rect_mv on int8 blocks (L = 1, x f32 or f64): the 0/1 gather G and
//     scatter S of the banded convection tail, BandedConvTail.vector of
//     dolfin_navier_scipy_tpu/ops/banded_conv.py:154 (XLA there), with the
//     f64 state rounded to f32 as the window is staged (the JAX package's
//     astype before its product).  A 16-byte vector carries 16 entries,
//     0/1 times an f32 x is exact; on bandmv_kernel only (bandmv_plan never
//     picks the ring for them: its consumers read f32 rows).
//   * rect_mv_levels: L in {1, 2, 3} row-stacked levels of bf16 (or f32),
//     base_k = bases[k] — `_rect_mv_pair` over the `_pair_stack`-ed W and X
//     (hi_only = level 0 alone) and `SchurSaddleSolver._sapply` over the
//     stacked S^-1 (one block, base 0).
//
// Bound: bytes.  Every stored entry is read once and used for one multiply-
// add (2 flops per 2 or 4 bytes), far below the card's operations-per-byte
// line; x and y are a few KB.  The least time is the blocks' bytes over the
// memory rate.  What keeps a kernel from it is not the rate at which an SM
// streams (1-D bulk copies, 16-byte cp.async and plain loads all reach
// 3.16-3.2 TB/s with one or two blocks an SM) but how the rows fall on the
// card: SMs left idle by a small grid, a last partial wave of blocks, the
// launch and first round trip, and a window staged before any row load.
//
// The kernels, and which operand each serves (ops/kernels.py: bandmv_plan
// for the single-level f32 products, stack_plan for the level stacks; what
// they measured on an H100 80GB HBM3 at 700 W, graph replay over L2-cold
// copies, tools_torch/band_variants.py: PERF.md, section 6):
//
//   * bandmv_kernel, a warp per row on the grid (nblk, ceil(bs / ROWS)):
//     every single-level product but J at level 1, bf16 rect_mv, and the
//     level stacks whose grid fills whole waves (X, W's level 0 alone, W
//     at level 2).  It streams at 2.9-3.1 TB/s while it runs (E
//     112x896x2688 0.343 ms, 94 % of its bound).
//   * share_kernel, a warp per row over equal contiguous row shares of a
//     grid sized from the plan: the stack of one row block (S^-1, dense:
//     its rows fill no grid of ROWS-row blocks evenly — 64 blocks on 132
//     SMs at level 1 — and each ROWS-row block restaged all of x, 52 KB at
//     level 3, by a chain of round trips) on two blocks an SM, every block
//     staging all of x once; and W's three levels under a window of 16 KB
//     or more (level 3) on blocks of 8 rows.  It stages a window by 4-byte
//     cp.async, every copy in flight at once, and keeps kLoads 16-byte
//     vectors a lane in flight whatever the level count.  S^-1: 0.0062 ->
//     0.0055 ms at level 1, 0.0300 -> 0.0289 at level 2, 0.351 -> 0.338 at
//     level 3; W at level 3 0.993 -> 0.979.  A static split is safe there:
//     two resident blocks an SM take the whole grid in one wave, and the
//     8-row grid is scheduled by the hardware.
//   * ring_kernel, bulk copies into a shared-memory ring: single-level f32
//     operands too short in rows for bandmv_kernel to fill the card (J at
//     level 1: 0.0070 -> 0.0054 ms), and W's three bf16 levels at level 1,
//     whose 456 warp-per-row blocks run a wave and a bit at three resident
//     blocks an SM (0.0292 -> 0.0270 ms):
//       - one block an SM; the units (runs of at most unit_rows rows of one
//         row block: rows are ld apart there, so a unit is one contiguous
//         16-byte aligned range of each level, up to the last row's last
//         vector inside w) split in order into equal shares of the blocks
//         — a static schedule, no counter; each block gets a unit where
//         rows allow.
//       - a producer warp: lane 0 starts each unit as one 1-D
//         `cp.async.bulk` a level into the next free slot of a ring of
//         `stages` slots (the whole share of a block in flight at once
//         where the ring holds it; L2::evict_first: the operand is read
//         once), completing on the slot's `full` mbarrier; the 32 lanes
//         copy the unit's x window (zero outside [0, nx) and past w) into
//         the slot by 4-byte cp.async that complete on the same mbarrier,
//         so the consumers never stop to stage a window.
//       - CONSUMERS threads take the rows of a unit in turn (row r of the
//         block's units goes to warp r % WARPS).  Single-level f32: lane t
//         adds the 16-byte vectors t, t+64, ... and t+32, t+96, ... of a
//         row each in ascending order, then the two sums, and a fixed
//         xor-shuffle tree joins the lanes (short rows, 512 columns or
//         fewer: a group of 8 or 16 lanes a row, a fixed tree inside the
//         group); a warp takes two rows at a time where it has two.  Level
//         stacks: a warp a row through row_levels.  A warp releases the
//         slot on its `empty` mbarrier.
//     Where the warp-per-row grid fills the card the ring loses (the
//     barrier set-up, the copy's round trip, the reduction of the last
//     units after they land: E at level 3 0.370 against 0.343 ms; a level
//     stack with one row a unit keeps one warp of eight busy: W at level 3
//     2.13 against 0.99 ms).
//
// Rejected on the same card: a ticket counter instead of a static split
// (an atomic round trip on the critical path of small operands: J at level
// 1 7.7 against 5.4 us); the share kernel with each warp's first row in
// flight before the window wait (it spilled at two blocks an SM and lost:
// S^-1 at level 1 0.0059 against 0.0055 ms).
//
// Every kernel: a warp per row reads the 16-byte vectors t, t+32, ... (or
// the ring's f32 split above) of each level in ascending order and a fixed
// xor-shuffle tree joins the lanes, so the sums do not depend on the
// schedule (the three kernels give level stacks the same bits); bitwise
// reproducible launch to launch; no atomics, no scratch, no grid barrier:
// one CUDA-graph node a call.  Entries in a row's padding (columns >= w)
// are masked, so padding of any content (NaN included) is never used.
//
// bandmv_kernel: a block of 8 warps owns ROWS rows of one row block; it
// stages that block's x window once into shared memory (zero fill outside
// [0, nx) and past w), so rows never touch x in device memory; one warp a
// row through row_levels, kUnroll vectors of every level in flight.
//
// Operands: rows `ld` elements apart, level and block strides `slev`,
// `sblk`; all three and the base pointer 16-byte aligned (the wrapper
// checks; ops/kernels.py: band_operand allocates so).
//
// Plain C interface, loaded with ctypes (no PyTorch headers: seconds to
// build).  The caller allocates y and passes raw device pointers and the
// stream; nothing is synchronised here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the geometry, from ops/kernels.py: _BANDMV_GEOMETRY
#if !defined(BANDMV_CONSUMERS) || !defined(BANDMV_ROWS)
#error "build through ops/kernels.py: the blocks' geometry comes from its plan"
#endif
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = BANDMV_ROWS;               // rows of one block
constexpr int kRowsPerWarp = kRows / kWarps;
static_assert(kRows % kWarps == 0, "whole rows a warp");
constexpr int kUnroll = 4;                       // vectors in flight a lane
// row_levels: 16-byte vectors in flight a lane, over all L levels
constexpr int kLoads = 12;

struct F32 {
    using T = float;
    static constexpr int VEC = 4;
};
struct BF16 {
    using T = uint16_t;
    static constexpr int VEC = 8;
};
struct I8 {
    using T = int8_t;
    static constexpr int VEC = 16;
};

// entries of x a window holds: w rounded up to a whole 16-byte vector of
// S's entries, 8 at least
template <typename S>
__host__ __device__ constexpr int window_len(int w) {
    constexpr int R = S::VEC > 8 ? S::VEC : 8;
    return (w + R - 1) / R * R;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
    return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
}

// entries of one 16-byte vector as floats; entries at columns >= w are 0
template <typename S>
__device__ __forceinline__ void unpack(uint4 v, int c, int w, float* b);

template <>
__device__ __forceinline__ void unpack<F32>(uint4 v, int c, int w,
                                            float* b) {
    b[0] = __uint_as_float(v.x);
    b[1] = __uint_as_float(v.y);
    b[2] = __uint_as_float(v.z);
    b[3] = __uint_as_float(v.w);
    if (c + 4 > w) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (c + e >= w) b[e] = 0.f;
    }
}

template <>
__device__ __forceinline__ void unpack<BF16>(uint4 v, int c, int w,
                                             float* b) {
    b[0] = bf16_lo(v.x);
    b[1] = bf16_hi(v.x);
    b[2] = bf16_lo(v.y);
    b[3] = bf16_hi(v.y);
    b[4] = bf16_lo(v.z);
    b[5] = bf16_hi(v.z);
    b[6] = bf16_lo(v.w);
    b[7] = bf16_hi(v.w);
    if (c + 8 > w) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (c + e >= w) b[e] = 0.f;
    }
}

// the 16 int8 entries of a vector as floats (0/1 patterns: exact)
template <>
__device__ __forceinline__ void unpack<I8>(uint4 v, int c, int w,
                                           float* b) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            b[4 * i + j] = static_cast<float>(
                static_cast<int8_t>((u[i] >> (8 * j)) & 0xffu));
    if (c + 16 > w) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
            if (c + e >= w) b[e] = 0.f;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The L level dots of one row against the window xs (rp: the row's level
// 0, levels slev apart; LDG: the row in device memory, read through the
// read-only path, else in shared memory): lane t reads the 16-byte vectors
// t, t+32, ... of the row (4 f32 or 8 bf16 values; bf16 -> f32 is a 16-bit
// shift in registers), U vectors of every level in flight before the
// multiply-adds, and adds them in ascending order, so the sums do not
// depend on U; a fixed xor-shuffle tree joins the lanes of each level, and
// the levels are added in order.  Every lane gets the sum.  Padding
// columns are masked.
template <typename S, int L, bool LDG, int U = kLoads / L>
__device__ __forceinline__ float row_levels(const typename S::T* rp,
                                            long long slev, int nvec, int w,
                                            const float* xs, int lane) {
    float acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.f;
    for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
        uint4 buf[L][U];
#pragma unroll
        for (int l = 0; l < L; ++l)
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int v = v0 + 32 * u;
                const uint4* p = reinterpret_cast<const uint4*>(
                    rp + l * slev) + v;
                buf[l][u] = v < nvec ? (LDG ? __ldg(p) : *p)
                                     : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int v = v0 + 32 * u;
            if (v >= nvec) break;
            const int c = v * S::VEC;
#pragma unroll
            for (int l = 0; l < L; ++l) {
                float b[S::VEC];
                unpack<S>(buf[l][u], c, w, b);
#pragma unroll
                for (int e = 0; e < S::VEC; ++e)
                    acc[l] = fmaf(b[e], xs[c + e], acc[l]);
            }
        }
    }
    float tot = warp_sum(acc[0]);
#pragma unroll
    for (int l = 1; l < L; ++l) tot += warp_sum(acc[l]);
    return tot;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one float of x into shared memory, or a zero where `inside` is false
// (src-size 0: nothing is read)
__device__ __forceinline__ void copy_x(float* dst, const float* src,
                                       bool inside) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(inside ? 4 : 0)
                 : "memory");
}

// the window x[base + j] of a row block into xs, zero outside [0, nx) and
// past w up to a whole 8-vector: every thread's 4-byte copies in flight at
// once (one round trip, not one a loop turn), then the block waits for all
__device__ __forceinline__ void stage_window(float* xs, const float* x,
                                             long long base, int w, int nx) {
    const int nxs = (w + 7) & ~7;
    for (int j = threadIdx.x; j < nxs; j += blockDim.x) {
        const long long g = base + j;
        const bool in = j < w && g >= 0 && g < nx;
        copy_x(xs + j, in ? x + g : x, in);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
}

// XT: x's type (f64 only under int8 blocks: the f64 state is rounded to
// f32 as the window is staged)
template <typename S, int L, typename XT = float>
__global__ void __launch_bounds__(kThreads)
bandmv_kernel(const typename S::T* __restrict__ B, long long sblk,
              long long slev, long long ld, const int* __restrict__ bases,
              const XT* __restrict__ x, float* __restrict__ y, int bs,
              int w, int nx, long long nrows) {
    extern __shared__ float xs[];
    const int k = blockIdx.x;
    const long long base = bases ? (long long)bases[k]
                                 : (long long)(k - 1) * bs;
    // the window, zero outside [0, nx) and past w up to a whole vector
    const int nxs = window_len<S>(w);
    for (int j = threadIdx.x; j < nxs; j += kThreads) {
        const long long g = base + j;
        xs[j] = (j < w && g >= 0 && g < nx) ? static_cast<float>(x[g])
                                            : 0.f;
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nvec = (w + S::VEC - 1) / S::VEC;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int i = blockIdx.y * kRows + rr * kWarps + warp;
        const long long row = (long long)k * bs + i;
        if (i >= bs || row >= nrows) continue;        // the whole warp
        const float tot = row_levels<S, L, true, kUnroll>(
            B + k * sblk + i * ld, slev, nvec, w, xs, lane);
        if (lane == 0) y[row] = tot;
    }
}

// share_kernel: the rows [0, nrows) (row k*bs + i of row block k) cut into
// gridDim.x equal contiguous shares, the first nrows % gridDim.x one row
// longer; a block stages the window of each row block its share touches
// once, then its warps take the share's rows of that row block in turn
// (row r to warp r % kWarps), one warp a row through row_levels.
template <typename S, int L>
__global__ void __launch_bounds__(kThreads)
share_kernel(const typename S::T* __restrict__ B, long long sblk,
             long long slev, long long ld, const int* __restrict__ bases,
             const float* __restrict__ x, float* __restrict__ y, int bs,
             int w, int nx, long long nrows) {
    extern __shared__ float xs[];
    const long long b = blockIdx.x, per = nrows / gridDim.x,
                    rem = nrows % gridDim.x;
    long long r = b * per + min(b, rem);
    const long long r1 = r + per + (b < rem);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nvec = (w + S::VEC - 1) / S::VEC;
    while (r < r1) {
        const int k = static_cast<int>(r / bs);
        const long long end = min(r1, (long long)(k + 1) * bs);
        const typename S::T* rk = B + k * sblk - (long long)k * bs * ld;
        __syncthreads();            // the last row block's rows are done
        stage_window(xs, x, bases ? (long long)bases[k]
                                  : (long long)(k - 1) * bs, w, nx);
        for (long long row = r + warp; row < end; row += kWarps) {
            const float tot = row_levels<S, L, true>(rk + row * ld, slev,
                                                     nvec, w, xs, lane);
            if (lane == 0) y[row] = tot;
        }
        r = end;
    }
}

// bandmv_kernel on its grid (nblk, ceil(bs / ROWS)), or share_kernel on
// share_blocks blocks where that is positive
template <typename S, int L>
cudaError_t launch(const void* B, long long sblk, long long slev,
                   long long ld, const int* bases, const float* x, float* y,
                   int nblk, int bs, int w, int nx, long long nrows,
                   int share_blocks, cudaStream_t stream) {
    const size_t smem = (size_t)((w + 7) & ~7) * sizeof(float);
    auto kern = share_blocks > 0 ? share_kernel<S, L> : bandmv_kernel<S, L>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid = share_blocks > 0 ? dim3(share_blocks)
                                       : dim3(nblk, (bs + kRows - 1) / kRows);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const typename S::T*>(B), sblk, slev, ld, bases, x, y,
        bs, w, nx, nrows);
    return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(int levels, const void* B, long long sblk,
                     long long slev, long long ld, const int* bases,
                     const float* x, float* y, int nblk, int bs, int w,
                     int nx, long long nrows, int share_blocks,
                     cudaStream_t stream) {
    switch (levels) {
        case 1: return launch<S, 1>(B, sblk, slev, ld, bases, x, y, nblk,
                                    bs, w, nx, nrows, share_blocks, stream);
        case 2: return launch<S, 2>(B, sblk, slev, ld, bases, x, y, nblk,
                                    bs, w, nx, nrows, share_blocks, stream);
        case 3: return launch<S, 3>(B, sblk, slev, ld, bases, x, y, nblk,
                                    bs, w, nx, nrows, share_blocks, stream);
        default: return cudaErrorInvalidValue;
    }
}

// single-level int8 blocks on bandmv_kernel, under an f32 or f64 x
template <typename XT>
cudaError_t launch_i8(const void* B, long long sblk, long long ld,
                      const int* bases, const void* x, float* y, int nblk,
                      int bs, int w, int nx, long long nrows,
                      cudaStream_t stream) {
    const size_t smem = (size_t)window_len<I8>(w) * sizeof(float);
    auto kern = bandmv_kernel<I8, 1, XT>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kern<<<dim3(nblk, (bs + kRows - 1) / kRows), kThreads, smem, stream>>>(
        static_cast<const int8_t*>(B), sblk, 0, ld, bases,
        static_cast<const XT*>(x), y, bs, w, nx, nrows);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ring_kernel: blocks through a bulk-copy ring
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = BANDMV_CONSUMERS;
constexpr int WARPS = CONSUMERS / 32;          // consumer warps
constexpr int RING_THREADS = CONSUMERS + 32;   // and one producer warp
static_assert(CONSUMERS % 32 == 0 && CONSUMERS >= 32 && RING_THREADS <= 1024,
              "whole consumer warps");
constexpr long long kMaxSmem = 232448;        // 227 KB a block (sm_90)

// shared memory of a block, per slot: its full and empty mbarriers, its
// header (the unit's number), its f32 x window (w rounded up to whole
// 16-byte vectors of `item`-byte entries), its rows of L levels
__host__ __device__ constexpr long long ring_smem(int w, long long ld,
                                                  int item, int L,
                                                  int unit_rows, int stages) {
    return (long long)stages *
           (32LL + 4LL * (16 / item) * ((w + 16 / item - 1) / (16 / item)) +
            (long long)L * unit_rows * ld * item);
}


__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

// the arrival of this thread's cp.async copies so far, when they land
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
           "l"(policy)
        : "memory");
}


// unit u: rows [row, row + n) of row block k; the units run through the
// row blocks in order, upb a block, the last cut at nrows (32-bit: the
// wrapper keeps nblk * bs below 2^31)
__device__ __forceinline__ int unit_rows_of(int u, int bs, int unit_rows,
                                            int upb, int nrows, int* k,
                                            int* row) {
    *k = u / upb;
    const int i = (u - *k * upb) * unit_rows;
    *row = *k * bs + i;
    return min(unit_rows, min(bs - i, nrows - *row));
}

template <bool MASK>
__device__ __forceinline__ float dot4(float acc, float4 b, float4 x, int c,
                                      int w) {
    if (MASK && c + 4 > w) {    // the row's last vector: mask the padding
        if (c + 1 >= w) b.y = 0.f;
        if (c + 2 >= w) b.z = 0.f;
        if (c + 3 >= w) b.w = 0.f;
    }
    acc = fmaf(b.x, x.x, acc);
    acc = fmaf(b.y, x.y, acc);
    acc = fmaf(b.z, x.z, acc);
    return fmaf(b.w, x.w, acc);
}

// R rows, `rs` vectors apart, against the window: lane t adds the vectors
// t, t+64, ... and t+32, t+96, ... of a row each in ascending order, then
// the two sums, then the fixed xor-shuffle tree joins the lanes (MASK:
// entries past w are zeroed, for w not a multiple of 4)
template <int R, bool MASK>
__device__ __forceinline__ void row_dots(const float4* b, long long rs,
                                         const float4* xv, int nvec, int w,
                                         int lane, float* d) {
    float a[R], c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = c[r] = 0.f;
    int v = lane;
    for (; v + 96 < nvec; v += 128) {
        const float4 x0 = xv[v], x1 = xv[v + 32], x2 = xv[v + 64],
                     x3 = xv[v + 96];
        float4 p[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            p[r][0] = b[r * rs + v];
            p[r][1] = b[r * rs + v + 32];
            p[r][2] = b[r * rs + v + 64];
            p[r][3] = b[r * rs + v + 96];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            a[r] = dot4<MASK>(a[r], p[r][0], x0, 4 * v, w);
            c[r] = dot4<MASK>(c[r], p[r][1], x1, 4 * (v + 32), w);
            a[r] = dot4<MASK>(a[r], p[r][2], x2, 4 * (v + 64), w);
            c[r] = dot4<MASK>(c[r], p[r][3], x3, 4 * (v + 96), w);
        }
    }
    if (v + 32 < nvec) {
        const float4 x0 = xv[v], x1 = xv[v + 32];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            a[r] = dot4<MASK>(a[r], b[r * rs + v], x0, 4 * v, w);
            c[r] = dot4<MASK>(c[r], b[r * rs + v + 32], x1, 4 * (v + 32), w);
        }
        v += 64;
    }
    if (v < nvec) {
        const float4 x0 = xv[v];
#pragma unroll
        for (int r = 0; r < R; ++r)
            a[r] = dot4<MASK>(a[r], b[r * rs + v], x0, 4 * v, w);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] += c[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
            a[r] += __shfl_xor_sync(0xffffffffu, a[r], off);
#pragma unroll
    for (int r = 0; r < R; ++r) d[r] = a[r];
}

// one row a group of G lanes (G < 32: short rows, 32 / G rows a warp at a
// time): lane q of the group adds the vectors q, q+2G, ... and q+G, q+3G,
// ... of its row each in ascending order, then the two sums, then a fixed
// xor-shuffle tree inside the group
template <int G, bool MASK>
__device__ __forceinline__ float group_dot(const float4* b,
                                           const float4* xv, int nvec,
                                           int w, int q) {
    float a = 0.f, c = 0.f;
    int v = q;
    for (; v + 3 * G < nvec; v += 4 * G) {
        const float4 p0 = b[v], p1 = b[v + G], p2 = b[v + 2 * G],
                     p3 = b[v + 3 * G];
        const float4 x0 = xv[v], x1 = xv[v + G], x2 = xv[v + 2 * G],
                     x3 = xv[v + 3 * G];
        a = dot4<MASK>(a, p0, x0, 4 * v, w);
        c = dot4<MASK>(c, p1, x1, 4 * (v + G), w);
        a = dot4<MASK>(a, p2, x2, 4 * (v + 2 * G), w);
        c = dot4<MASK>(c, p3, x3, 4 * (v + 3 * G), w);
    }
    if (v + G < nvec) {
        a = dot4<MASK>(a, b[v], xv[v], 4 * v, w);
        c = dot4<MASK>(c, b[v + G], xv[v + G], 4 * (v + G), w);
        v += 2 * G;
    }
    if (v < nvec) a = dot4<MASK>(a, b[v], xv[v], 4 * v, w);
    a += c;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
    return a;
}

// the rows of a unit that fall to this warp, 32 / G at a time
template <int G, bool MASK>
__device__ __forceinline__ void group_rows(const float4* slab, long long ld4,
                                           const float4* xv, int nvec, int w,
                                           int rows, int j0, int lane,
                                           float* yrow) {
    constexpr int RP = 32 / G;
    const int g = lane / G, q = lane % G;
    for (int j = j0; j < rows; j += RP * WARPS) {
        const int jr = j + g * WARPS;
        const bool mine = jr < rows;
        const float d = group_dot<G, MASK>(slab + (mine ? jr : j) * ld4, xv,
                                           nvec, w, q);
        if (q == 0 && mine) yrow[jr] = d;
    }
}

// STACK: the consumers of a level stack (bf16 or f32, L levels), a warp a
// row through row_levels; else those of single-level f32 blocks below
template <typename S, int L, bool STACK>
__global__ void __launch_bounds__(RING_THREADS)
ring_kernel(const typename S::T* __restrict__ B, long long sblk,
            long long slev, long long ld, const int* __restrict__ bases,
            const float* __restrict__ x, float* __restrict__ y, int nblk,
            int bs, int w, int nx, long long nrows, int unit_rows,
            int stages) {
    using T = typename S::T;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + stages;
    int* hdr = reinterpret_cast<int*>(empty + stages);   // 16 bytes a slot
    const int nvec = (w + S::VEC - 1) / S::VEC;          // vectors a row
    const int wv = S::VEC * nvec;                        // window floats
    float* win = reinterpret_cast<float*>(hdr + 4 * stages);
    T* ring = reinterpret_cast<T*>(win + (long long)stages * wv);
    const long long lev = (long long)unit_rows * ld;     // a level's rows
    const long long slot = L * lev;                      // entries a slot
    const int upb = (bs + unit_rows - 1) / unit_rows;    // units a row block
    const int nr = static_cast<int>(nrows);
    const int units = (nr / bs) * upb + (nr % bs + unit_rows - 1) / unit_rows;
    const int t = threadIdx.x, lane = t & 31;

    if (t == 0) {
        for (int s = 0; s < stages; ++s) {
            // the bulk copy's arrival and the producer warp's 32 x copies
            mbar_init(full + s, 33);
            mbar_init(empty + s, WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();

    if (t >= CONSUMERS) {
        // the producer warp: a unit's rows by one bulk copy (lane 0) and
        // its x window by 4-byte copies (every lane), into the next free
        // slot
        uint64_t policy;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                     : "=l"(policy));
        // block b's units: an equal share, the first units % gridDim.x
        // blocks one more
        const int per = units / gridDim.x, rem = units % gridDim.x;
        const int b = blockIdx.x;
        const int u0 = b * per + min(b, rem), u1 = u0 + per + (b < rem);
        int n = 0;
        for (int u = u0; u < u1; ++u, ++n) {
            const int s = n % stages;
            if (n >= stages) mbar_wait(empty + s, ((n / stages) - 1) & 1);
            int k, row;
            const int rows = unit_rows_of(u, bs, unit_rows, upb, nr, &k, &row);
            if (lane == 0) {
                hdr[4 * s] = u;
                // each level: whole rows, the last one up to its last
                // vector inside w
                const uint32_t bytes = static_cast<uint32_t>(
                    ((long long)(rows - 1) * ld + wv) * sizeof(T));
                mbar_expect_tx(full + s, L * bytes);
                const T* src = B + k * sblk + (long long)(row - k * bs) * ld;
#pragma unroll
                for (int l = 0; l < L; ++l)
                    bulk_copy(ring + s * slot + l * lev, src + l * slev,
                              bytes, full + s, policy);
            }
            const long long base = bases ? (long long)bases[k]
                                         : (long long)(k - 1) * bs;
            float* xw = win + (long long)s * wv;
            for (int j = lane; j < wv; j += 32) {
                const long long g = base + j;
                const bool in = j < w && g >= 0 && g < nx;
                copy_x(xw + j, in ? x + g : x, in);
            }
            mbar_arrive_copies(full + s);
        }
        // a header saying there is no more, with the slot's 33 arrivals
        const int s = n % stages;
        if (n >= stages) mbar_wait(empty + s, ((n / stages) - 1) & 1);
        if (lane == 0) {
            hdr[4 * s] = -1;
            mbar_arrive(full + s);
        }
        __syncwarp();
        mbar_arrive(full + s);
        return;
    }

    // the consumers: row j of a unit goes to warp (j + rot) % WARPS, rot
    // turning with the block's units; single-level f32 rows: a warp takes
    // two of its rows at a time where it has two, or four (eight lanes a
    // row) where the rows are short
    const int warp = t >> 5;
    int rot = 0;
    for (int n = 0;; ++n) {
        const int s = n % stages;
        mbar_wait(full + s, (n / stages) & 1);
        const int u = hdr[4 * s];
        if (u < 0) break;
        int k, row;
        const int rows = unit_rows_of(u, bs, unit_rows, upb, nr, &k, &row);
        const int j0 = (warp - rot + WARPS) % WARPS;
        if constexpr (STACK) {
            // a warp a row, all L levels of it
            const T* slab = ring + s * slot;
            const float* xw = win + (long long)s * wv;
            for (int j = j0; j < rows; j += WARPS) {
                const float d = row_levels<S, L, false>(slab + j * ld, lev,
                                                        nvec, w, xw, lane);
                if (lane == 0) y[row + j] = d;
            }
        } else {
            const float4* slab =
                reinterpret_cast<const float4*>(ring + s * slot);
            const float4* xv =
                reinterpret_cast<const float4*>(win) + (long long)s * nvec;
            const long long ld4 = ld / 4;
            if (nvec <= 128) {
                // short rows (J^T): 8 or 16 lanes a row
                if (nvec <= 64) {
                    if (w & 3)
                        group_rows<8, true>(slab, ld4, xv, nvec, w, rows,
                                            j0, lane, y + row);
                    else
                        group_rows<8, false>(slab, ld4, xv, nvec, w, rows,
                                             j0, lane, y + row);
                } else {
                    if (w & 3)
                        group_rows<16, true>(slab, ld4, xv, nvec, w, rows,
                                             j0, lane, y + row);
                    else
                        group_rows<16, false>(slab, ld4, xv, nvec, w, rows,
                                              j0, lane, y + row);
                }
            }
            for (int j = j0; nvec > 128 && j < rows; j += 2 * WARPS) {
                float d[2];
                const float4* b = slab + j * ld4;
                if (j + WARPS < rows) {
                    if (w & 3)
                        row_dots<2, true>(b, WARPS * ld4, xv, nvec, w, lane,
                                          d);
                    else
                        row_dots<2, false>(b, WARPS * ld4, xv, nvec, w, lane,
                                           d);
                    if (lane == 0) {
                        y[row + j] = d[0];
                        y[row + j + WARPS] = d[1];
                    }
                } else {
                    if (w & 3)
                        row_dots<1, true>(b, 0, xv, nvec, w, lane, d);
                    else
                        row_dots<1, false>(b, 0, xv, nvec, w, lane, d);
                    if (lane == 0) y[row + j] = d[0];
                }
            }
        }
        __syncwarp();                       // the warp is done with slot s
        if (lane == 0) mbar_arrive(empty + s);
        rot = (rot + rows) % WARPS;
    }
}

template <typename S, int L, bool STACK>
cudaError_t launch_ring(const void* B, long long sblk, long long slev,
                        long long ld, const int* bases, const float* x,
                        float* y, int nblk, int bs, int w, int nx,
                        long long nrows, int blocks, int unit_rows,
                        int stages, long long smem, cudaStream_t stream) {
    constexpr int item = sizeof(typename S::T);
    if (blocks <= 0 || unit_rows <= 0 || stages <= 0 || ld < w ||
        (ld * item) % 16 != 0 || (sblk * item) % 16 != 0 ||
        (L > 1 && (slev * item) % 16 != 0) ||
        (reinterpret_cast<uintptr_t>(B) % 16) != 0 ||
        smem != ring_smem(w, ld, item, L, unit_rows, stages) ||
        smem > kMaxSmem)
        return cudaErrorInvalidValue;
    auto kern = ring_kernel<S, L, STACK>;
    // once per device: the opt-in to large shared memory
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!ready[dev]) {
        err = cudaFuncSetAttribute(kern,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(kMaxSmem));
        if (err != cudaSuccess) return err;
        ready[dev] = true;
    }
    kern<<<blocks, RING_THREADS, static_cast<size_t>(smem), stream>>>(
        static_cast<const typename S::T*>(B), sblk, slev, ld, bases, x, y,
        nblk, bs, w, nx, nrows, unit_rows, stages);
    return cudaGetLastError();
}

// a level stack on share_kernel (form 1) or on the ring (form 2)
template <typename S>
cudaError_t dispatch_stack(int form, int levels, const void* B,
                           long long sblk, long long slev, long long ld,
                           const int* bases, const float* x, float* y,
                           int nblk, int bs, int w, int nx, long long nrows,
                           int blocks, int unit_rows, int stages,
                           long long smem, cudaStream_t stream) {
    if (form == 1)
        return blocks > 0 ? dispatch<S>(levels, B, sblk, slev, ld, bases, x,
                                        y, nblk, bs, w, nx, nrows, blocks,
                                        stream)
                          : cudaErrorInvalidValue;
    if (form != 2) return cudaErrorInvalidValue;
    switch (levels) {
        case 1: return launch_ring<S, 1, true>(
            B, sblk, slev, ld, bases, x, y, nblk, bs, w, nx, nrows, blocks,
            unit_rows, stages, smem, stream);
        case 2: return launch_ring<S, 2, true>(
            B, sblk, slev, ld, bases, x, y, nblk, bs, w, nx, nrows, blocks,
            unit_rows, stages, smem, stream);
        case 3: return launch_ring<S, 3, true>(
            B, sblk, slev, ld, bases, x, y, nblk, bs, w, nx, nrows, blocks,
            unit_rows, stages, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// y (nrows,) f32 = the product above, on bandmv_kernel.  B: `storage` 0 =
// f32, 1 = bf16; `levels` 1..3; strides sblk, slev, ld in elements (each
// times the element size a multiple of 16, B 16-byte aligned).  bases:
// nblk int32 window starts on the device, or null for the banded form
// base_k = (k-1) bs.
// nblk*bs >= nrows (rows past nblk*bs would stay unwritten).  Returns the
// cudaError_t of the launch (0 = success).
int bandmv_f32x(const void* B, int storage, int levels, long long sblk,
                long long slev, long long ld, const void* bases,
                const void* x, void* y, int nblk, int bs, int w, int nx,
                long long nrows, void* stream) {
    if (nblk <= 0 || bs <= 0 || w <= 0 || nx < 0 || nrows <= 0
        || (long long)nblk * bs < nrows)
        return cudaErrorInvalidValue;
    const int* b = static_cast<const int*>(bases);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (storage == 0)
        return dispatch<F32>(levels, B, sblk, slev, ld, b, xf, yf, nblk, bs,
                             w, nx, nrows, 0, s);
    if (storage == 1)
        return dispatch<BF16>(levels, B, sblk, slev, ld, b, xf, yf, nblk,
                              bs, w, nx, nrows, 0, s);
    return cudaErrorInvalidValue;
}

// y (nrows,) f32 = the single-level f32 product above, on ring_kernel.
// Strides sblk, ld in elements (each times 4 a multiple of 16, B 16-byte
// aligned); bases as for bandmv_f32x; nblk*bs below 2^31.  blocks,
// unit_rows, stages, smem: the launch plan of ops/kernels.py: bandmv_plan
// (smem must equal the kernel's layout for them).  Returns the cudaError_t
// of the launch (0 = success).
int bandmv_ring_f32(const void* B, long long sblk, long long ld,
                    const void* bases, const void* x, void* y, int nblk,
                    int bs, int w, int nx, long long nrows, int blocks,
                    int unit_rows, int stages, long long smem, void* stream) {
    if (nblk <= 0 || bs <= 0 || w <= 0 || nx < 0 || nrows <= 0
        || (long long)nblk * bs < nrows || (long long)nblk * bs >= (1LL << 31))
        return cudaErrorInvalidValue;
    return launch_ring<F32, 1, false>(
        B, sblk, 0, ld, static_cast<const int*>(bases),
        static_cast<const float*>(x), static_cast<float*>(y), nblk, bs, w,
        nx, nrows, blocks, unit_rows, stages, smem,
        static_cast<cudaStream_t>(stream));
}

// y (nrows,) f32 = the product above for a level stack, on share_kernel
// (`form` 1, over `blocks` blocks) or ring_kernel (`form` 2; blocks,
// unit_rows, stages, smem as for bandmv_ring_f32); storage, levels,
// strides and bases as for bandmv_f32x; nblk*bs below 2^31.  The launch
// plan is ops/kernels.py: stack_plan.  Returns the cudaError_t of the
// launch (0 = success).
int bandmv_stack(const void* B, int storage, int levels, long long sblk,
                 long long slev, long long ld, const void* bases,
                 const void* x, void* y, int nblk, int bs, int w, int nx,
                 long long nrows, int form, int blocks, int unit_rows,
                 int stages, long long smem, void* stream) {
    if (nblk <= 0 || bs <= 0 || w <= 0 || nx < 0 || nrows <= 0
        || (long long)nblk * bs < nrows || (long long)nblk * bs >= (1LL << 31))
        return cudaErrorInvalidValue;
    const int* b = static_cast<const int*>(bases);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (storage == 0)
        return dispatch_stack<F32>(form, levels, B, sblk, slev, ld, b, xf, yf,
                                   nblk, bs, w, nx, nrows, blocks, unit_rows,
                                   stages, smem, s);
    if (storage == 1)
        return dispatch_stack<BF16>(form, levels, B, sblk, slev, ld, b, xf,
                                    yf, nblk, bs, w, nx, nrows, blocks,
                                    unit_rows, stages, smem, s);
    return cudaErrorInvalidValue;
}

// y (nrows,) f32 = the single-level product above for int8 blocks (the
// 0/1 gather and scatter of the banded convection tail), on bandmv_kernel:
// x is f32 (x_f64 = 0) or f64 (1, rounded to f32 as the window is
// staged); strides sblk, ld in elements (multiples of 16, B 16-byte
// aligned); bases as for bandmv_f32x.  Returns the cudaError_t of the
// launch (0 = success).
int bandmv_i8(const void* B, long long sblk, long long ld, const void* bases,
              const void* x, int x_f64, void* y, int nblk, int bs, int w,
              int nx, long long nrows, void* stream) {
    if (nblk <= 0 || bs <= 0 || w <= 0 || nx < 0 || nrows <= 0
        || (long long)nblk * bs < nrows || ld < w || ld % 16 != 0
        || sblk % 16 != 0 || (reinterpret_cast<uintptr_t>(B) % 16) != 0)
        return cudaErrorInvalidValue;
    const int* b = static_cast<const int*>(bases);
    float* yf = static_cast<float*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return x_f64 ? launch_i8<double>(B, sblk, ld, b, x, yf, nblk, bs, w, nx,
                                     nrows, s)
                 : launch_i8<float>(B, sblk, ld, b, x, yf, nblk, bs, w, nx,
                                    nrows, s);
}

const char* bandmv_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
