// Dense inverse apply  y = x @ KT  for Hopper (sm_90a), f32 and f64.
//
//   x (m,)  @  KT (m, n) row-major  ->  y (n,)      accumulate in the
//                                                   operand type
//
// Replaces the TPU kernel `_vecmat_kernel` / `vecmat_pallas` of
// dolfin_navier_scipy_tpu/ops/pallas_kernels.py: the apply of the
// transposed dense saddle inverse, K^-1 r, once per time step.
//
// Bound: bytes.  Every entry of KT is read exactly once and used for one
// multiply-add, so the least time is sizeof(T)*m*n bytes over the memory
// rate; x, y and the scratch are O(m + splits*n) and do not matter.
//
// Design.  The TPU kernel walks the contraction as a sequential grid axis
// and accumulates in a resident output block; blocks on a GPU run in no
// order, so the contraction is split instead:
//   * a block owns THREADS*VEC adjacent columns and one slab of
//     `rows_per_split` rows.  Threads lie along n: a warp reads one
//     contiguous run of a row of KT per load, VEC values a thread (16
//     bytes where n and the base address allow it, else 8 or 4 — rows of
//     an odd-length matrix are not 16-byte aligned).  Loads carry the
//     streaming hint (__ldcs): KT is far larger than L2 and never reused
//     within a launch.  UNROLL independent row loads are in flight per
//     thread to cover the memory latency.
//   * the slab of x is staged once in shared memory and broadcast.
//   * each block writes its partial sums to scratch (splits, n); a second
//     small kernel adds the `splits` rows in a fixed order.  No atomics:
//     the result is bitwise reproducible from run to run, which keeps
//     time-stepping trajectories reproducible.
//   * tails are masked (col < n, row < m); there is no padding and no
//     tile-multiple requirement on m or n.
//
// Plain C interface, loaded with ctypes; the caller allocates y and the
// scratch, passes raw device pointers and the CUDA stream, and checks the
// returned cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

template <typename T, int VEC> struct Pack;
template <> struct Pack<float, 1> { using type = float; };
template <> struct Pack<float, 2> { using type = float2; };
template <> struct Pack<float, 4> { using type = float4; };
template <> struct Pack<double, 1> { using type = double; };
template <> struct Pack<double, 2> { using type = double2; };

template <typename T, int VEC>
__device__ __forceinline__ void load_stream(const T* p, T (&v)[VEC]) {
    using P = typename Pack<T, VEC>::type;
    const P t = __ldcs(reinterpret_cast<const P*>(p));
    const T* tp = reinterpret_cast<const T*>(&t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = tp[k];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
vecmat_partial_kernel(const T* __restrict__ x, const T* __restrict__ KT,
                      T* __restrict__ out, int m, int n, int rows_per_split) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);

    const int split = blockIdx.y;
    const int r0 = split * rows_per_split;
    const int nr = min(m - r0, rows_per_split);      // may be <= 0
    for (int i = threadIdx.x; i < nr; i += THREADS) xs[i] = x[r0 + i];
    __syncthreads();

    // VEC divides n (chosen so by the launcher), hence col < n implies
    // that the whole VEC-wide group lies inside the row
    const long long col =
        (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
    if (col >= n) return;

    T acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = T(0);

    const T* p = KT + static_cast<size_t>(r0) * n + col;
    int r = 0;
    for (; r + UNROLL <= nr; r += UNROLL) {
        T v[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            load_stream<T, VEC>(p + static_cast<size_t>(r + u) * n, v[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const T xv = xs[r + u];
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += xv * v[u][k];
        }
    }
    for (; r < nr; ++r) {
        T v[VEC];
        load_stream<T, VEC>(p + static_cast<size_t>(r) * n, v);
        const T xv = xs[r];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += xv * v[k];
    }

    T* o = out + static_cast<size_t>(split) * n + col;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = acc[k];
}

template <typename T>
__global__ void vecmat_reduce_kernel(const T* __restrict__ part,
                                     T* __restrict__ y, int n, int splits) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= n) return;
    T acc = T(0);
    for (int s = 0; s < splits; ++s)
        acc += part[static_cast<size_t>(s) * n + col];
    y[col] = acc;
}

template <typename T, int VEC>
cudaError_t launch_partial(const T* x, const T* KT, T* out, int m, int n,
                           int splits, int rows_per_split, cudaStream_t st) {
    const int cols_per_block = THREADS * VEC;
    dim3 grid((n + cols_per_block - 1) / cols_per_block, splits);
    const size_t smem = static_cast<size_t>(rows_per_split) * sizeof(T);
    vecmat_partial_kernel<T, VEC><<<grid, THREADS, smem, st>>>(
        x, KT, out, m, n, rows_per_split);
    return cudaGetLastError();
}

template <typename T>
cudaError_t vecmat(const T* x, const T* KT, T* y, T* part, int m, int n,
                   int splits, int rows_per_split, cudaStream_t st) {
    if (m <= 0 || n <= 0 || splits <= 0 || rows_per_split <= 0 ||
        static_cast<long long>(splits) * rows_per_split < m ||
        splits > 65535 ||
        static_cast<size_t>(rows_per_split) * sizeof(T) > 48 * 1024)
        return cudaErrorInvalidValue;

    // widest load that keeps every row start aligned
    const uintptr_t base = reinterpret_cast<uintptr_t>(KT);
    int vec = 1;
    if (sizeof(T) == 4 && n % 4 == 0 && base % 16 == 0) vec = 4;
    else if (n % 2 == 0 && base % (2 * sizeof(T)) == 0) vec = 2;

    T* out = splits > 1 ? part : y;
    cudaError_t err;
    if constexpr (sizeof(T) == 4) {
        if (vec == 4)
            err = launch_partial<T, 4>(x, KT, out, m, n, splits,
                                       rows_per_split, st);
        else if (vec == 2)
            err = launch_partial<T, 2>(x, KT, out, m, n, splits,
                                       rows_per_split, st);
        else
            err = launch_partial<T, 1>(x, KT, out, m, n, splits,
                                       rows_per_split, st);
    } else {
        if (vec == 2)
            err = launch_partial<T, 2>(x, KT, out, m, n, splits,
                                       rows_per_split, st);
        else
            err = launch_partial<T, 1>(x, KT, out, m, n, splits,
                                       rows_per_split, st);
    }
    if (err != cudaSuccess || splits == 1) return err;

    vecmat_reduce_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(part, y, n,
                                                            splits);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = x @ KT in f32.  `part` is scratch of splits*n floats (unused when
// splits == 1).  Returns the cudaError_t of the launches (0 = success).
int vecmat_f32(const void* x, const void* KT, void* y, void* part, int m,
               int n, int splits, int rows_per_split, void* stream) {
    return static_cast<int>(vecmat<float>(
        static_cast<const float*>(x), static_cast<const float*>(KT),
        static_cast<float*>(y), static_cast<float*>(part), m, n, splits,
        rows_per_split, static_cast<cudaStream_t>(stream)));
}

// The same in f64.
int vecmat_f64(const void* x, const void* KT, void* y, void* part, int m,
               int n, int splits, int rows_per_split, void* stream) {
    return static_cast<int>(vecmat<double>(
        static_cast<const double*>(x), static_cast<const double*>(KT),
        static_cast<double*>(y), static_cast<double*>(part), m, n, splits,
        rows_per_split, static_cast<cudaStream_t>(stream)));
}

const char* vecmat_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
