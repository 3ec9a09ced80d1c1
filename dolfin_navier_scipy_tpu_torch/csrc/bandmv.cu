// Banded and static-window block matvecs for Hopper (sm_90a).
//
//   y[k*bs + i] = sum_{l < L} sum_{j < w} B[k, l, i, j] * x[base_k + j]
//
// for row blocks k < nblk, rows i < bs with k*bs + i < nrows; x is read as
// zero outside [0, nx) (no host padding), the L level dots of a row are
// reduced each on its own and added in level order.  One kernel, three
// forms (bound in ops/kernels.py):
//
//   * banded_mv: L = 1, f32, w = 3 bs, base_k = (k - 1) bs — the block-
//     tridiagonal F_perm @ x of the RCM-banded saddle solver.  Replaces the
//     XLA einsum `_banded_mv` of dolfin_navier_scipy_tpu/solve/sadpnt.py
//     (no Pallas kernel there: eager torch would need a pad, two shifted
//     concatenations, a bmm and a slice).
//   * rect_mv: L = 1, f32, base_k = bases[k] — the static-window
//     rectangular product of `_rect_mv` (J, J^T, and W / X when stored in
//     f32).
//   * rect_mv_levels: L in {1, 2, 3} row-stacked levels of bf16 (or f32),
//     base_k = bases[k] — `_rect_mv_pair` over the `_pair_stack`-ed W and X
//     (hi_only = level 0 alone) and `SchurSaddleSolver._sapply` over the
//     stacked S^-1 (one block, base 0).
//
// Bound: bytes.  Every stored entry is read once and used for one multiply-
// add (2 flops per 2 or 4 bytes), far below the card's operations-per-byte
// line; x and y are a few KB.  The least time is the blocks' bytes over the
// memory rate.
//
// Design (a simple first form, right before fast):
//   * grid (nblk, ceil(bs / ROWS)): a block of 8 warps owns ROWS rows of one
//     row block; it stages that block's x window once into shared memory
//     (zero fill outside [0, nx) and past w), so rows never touch x in
//     device memory.
//   * one warp per row: lane t reads the 16-byte vectors t, t+32, ... of
//     the row (4 f32 or 8 bf16 values; bf16 -> f32 is a 16-bit shift in
//     registers), UNROLL vectors of every level in flight before the
//     multiply-adds, and adds them in ascending order; a fixed xor-shuffle
//     tree joins the lanes.  Entries in the row's padding (columns >= w)
//     are masked, so padding of any content is never used.
//   * no atomics, no scratch, no grid barrier: bitwise reproducible launch
//     to launch, and trivially captured in a CUDA graph.
//   * operands: rows `ld` elements apart, level and block strides `slev`,
//     `sblk`; all three and the base pointer 16-byte aligned (the wrapper
//     checks; ops/kernels.py: band_operand allocates so).
//
// Plain C interface, loaded with ctypes (no PyTorch headers: seconds to
// build).  The caller allocates y and passes raw device pointers and the
// stream; nothing is synchronised here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kWarps * kRowsPerWarp;     // rows of one block
constexpr int kUnroll = 4;                       // vectors in flight a lane

struct F32 {
    using T = float;
    static constexpr int VEC = 4;
};
struct BF16 {
    using T = uint16_t;
    static constexpr int VEC = 8;
};

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename S, int L>
__global__ void __launch_bounds__(kThreads)
bandmv_kernel(const typename S::T* __restrict__ B, long long sblk,
              long long slev, long long ld, const int* __restrict__ bases,
              const float* __restrict__ x, float* __restrict__ y, int bs,
              int w, int nx, long long nrows) {
    extern __shared__ float xs[];
    const int k = blockIdx.x;
    const long long base = bases ? (long long)bases[k]
                                 : (long long)(k - 1) * bs;
    // the window, zero outside [0, nx) and past w up to a whole 8-vector
    const int nxs = (w + 7) & ~7;
    for (int j = threadIdx.x; j < nxs; j += kThreads) {
        const long long g = base + j;
        xs[j] = (j < w && g >= 0 && g < nx) ? x[g] : 0.f;
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nvec = (w + S::VEC - 1) / S::VEC;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int i = blockIdx.y * kRows + rr * kWarps + warp;
        const long long row = (long long)k * bs + i;
        if (i >= bs || row >= nrows) continue;        // the whole warp
        const typename S::T* rp = B + k * sblk + i * ld;
        float acc[L];
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = 0.f;
        for (int v0 = lane; v0 < nvec; v0 += 32 * kUnroll) {
            uint4 buf[L][kUnroll];
#pragma unroll
            for (int l = 0; l < L; ++l)
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int v = v0 + 32 * u;
                    buf[l][u] = v < nvec
                        ? __ldg(reinterpret_cast<const uint4*>(
                                    rp + l * slev) + v)
                        : make_uint4(0u, 0u, 0u, 0u);
                }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
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
        if (lane == 0) y[row] = tot;
    }
}

template <typename S, int L>
cudaError_t launch(const void* B, long long sblk, long long slev,
                   long long ld, const int* bases, const float* x, float* y,
                   int nblk, int bs, int w, int nx, long long nrows,
                   cudaStream_t stream) {
    const size_t smem = (size_t)((w + 7) & ~7) * sizeof(float);
    auto kern = bandmv_kernel<S, L>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    dim3 grid(nblk, (bs + kRows - 1) / kRows);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const typename S::T*>(B), sblk, slev, ld, bases, x, y,
        bs, w, nx, nrows);
    return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(int levels, const void* B, long long sblk,
                     long long slev, long long ld, const int* bases,
                     const float* x, float* y, int nblk, int bs, int w,
                     int nx, long long nrows, cudaStream_t stream) {
    switch (levels) {
        case 1: return launch<S, 1>(B, sblk, slev, ld, bases, x, y, nblk,
                                    bs, w, nx, nrows, stream);
        case 2: return launch<S, 2>(B, sblk, slev, ld, bases, x, y, nblk,
                                    bs, w, nx, nrows, stream);
        case 3: return launch<S, 3>(B, sblk, slev, ld, bases, x, y, nblk,
                                    bs, w, nx, nrows, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// y (nrows,) f32 = the product above.  B: `storage` 0 = f32, 1 = bf16;
// `levels` 1..3; strides sblk, slev, ld in elements (each times the element
// size a multiple of 16, B 16-byte aligned).  bases: nblk int32 window
// starts on the device, or null for the banded form base_k = (k-1) bs.
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
                             w, nx, nrows, s);
    if (storage == 1)
        return dispatch<BF16>(levels, B, sblk, slev, ld, b, xf, yf, nblk,
                              bs, w, nx, nrows, s);
    return cudaErrorInvalidValue;
}

const char* bandmv_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
