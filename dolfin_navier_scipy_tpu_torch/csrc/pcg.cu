// B7: the fused tail of a Jacobi-preconditioned CG iteration for Hopper
// (sm_90a).  After the matvec ap = F p (its own kernel: elemmv.cu, bandmv.cu
// or a library product in a setup), one launch does the rest of the
// iteration:
//
//   pAp    = p . ap
//   alpha  = rz / (pAp == 0 ? 1 : pAp)
//   x     += alpha p,   r -= alpha ap,   z = dinv r
//   rz_n   = r . z
//   beta   = rz_n / (rz == 0 ? 1 : rz)
//   p      = z + beta p,   rz = rz_n
//
// and an init entry the start of the loop (r = b - F x0 or b, z = dinv r,
// p = z, rz = r . z).  The column-blocked form runs the same iteration on
// (n, k) row-major blocks with k scalars (the Schur setups' block PCG).
//
// Replaces the JAX package's fixed-count loops
// dolfin_navier_scipy_tpu/solve/sadpnt.py:677 jacobi_pcg and :252
// _block_pcg_jit (XLA fusions there; eager PyTorch would take a dozen
// launches an iteration: two dots, the guards, three axpys, the
// preconditioner).
//
// Bound: bytes.  An iteration reads p, ap, x, r, dinv and writes x, r, p
// (8 vectors, the z pass rereads r and p): about 10 n words; at the element
// path's 65 892 dofs in f32 that is 2.6 MB, under a microsecond at the
// memory rate, so a launch is bound by its two grid-wide waits and the
// launch itself.  The design keeps those to one launch and two barriers:
//
//   * a resident grid (blocks from the occupancy query, the launch
//     cooperative: CUDA refuses a grid that cannot be resident); every
//     thread walks the same indices in every phase (grid-stride), so x, r
//     and p need no exchange between threads;
//   * each reduction: a thread's partial in index order, the block's sum by
//     a fixed xor butterfly (warps, then the warps' sums), one partial a
//     block, a grid barrier (an arrival counter that only grows, as in
//     convection.cu), then every block sums all partials in the same order
//     (lane l takes partials l, l+32, ..., then the butterfly), so every
//     block holds the same scalar, bitwise, and no atomics touch a float;
//   * z is not stored: the phase after the second barrier recomputes dinv r
//     from the r the same thread wrote;
//   * the scalars stay on the device: rz is read by every block before the
//     first barrier and written by block 0 after the second.
//
// Plain C interface, loaded with ctypes; the caller allocates the partials
// (2 x blocks x 32 work-type words) and the barrier words (zeroed once, kept
// per stream) and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Must match ops/kernels.py: _PcgArgsC field for field.
struct PcgArgs {
    void* x;                // (n) or (n, k)
    void* r;
    void* p;
    const void* ap;         // F p (step only)
    const void* dinv;       // (n)
    void* rz;               // () or (k)
    const void* b;          // init only: the right-hand side
    const void* fx0;        // init only: F x0, or null (x0 = 0)
    void* part;             // partial sums, 2 sets
    unsigned long long* bar;  // arrival counter, zero before the first
                              // launch of this (stream, shape)
    int n, k, f64;          // k = 0: the vector form
};

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;  // the block form: 8 rows x 32 columns
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.global.acquire.gpu.b64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// All blocks of the grid meet here; writes before it are visible after it
// (read them with __ldcg).  The counter only grows: each launch adds one
// arrival a block, so the arrival number names the multiple to wait for.
__device__ void grid_barrier(unsigned long long* count) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned long long nblk =
            static_cast<unsigned long long>(gridDim.x) * gridDim.y;
        __threadfence();
        const unsigned long long old = atomicAdd(count, 1ull);
        const unsigned long long target = (old / nblk + 1) * nblk;
        while (ld_acquire(count) < target) {
        }
    }
    __syncthreads();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// The block's sum of v (fixed order), valid in every thread.
template <typename T>
__device__ T block_sum(T v, T* sh) {
    v = warp_sum(v);
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) sh[w] = v;
    __syncthreads();
    v = lane < THREADS / 32 ? sh[lane] : T(0);
    return warp_sum(v);
}

// The sum of the grid's partials part[0..nblk) in a fixed order, valid in
// every thread (every block computes the same bits).
template <typename T>
__device__ T grid_sum(const T* part, int nblk, T* sh) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (w == 0) {
        T v = T(0);
        for (int j = lane; j < nblk; j += 32) v += __ldcg(part + j);
        v = warp_sum(v);
        if (lane == 0) sh[0] = v;
    }
    __syncthreads();
    return sh[0];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) vec_step(PcgArgs a) {
    __shared__ T sh[THREADS / 32];
    T* x = static_cast<T*>(a.x);
    T* r = static_cast<T*>(a.r);
    T* p = static_cast<T*>(a.p);
    const T* ap = static_cast<const T*>(a.ap);
    const T* dinv = static_cast<const T*>(a.dinv);
    T* rzp = static_cast<T*>(a.rz);
    T* part = static_cast<T*>(a.part);
    const int nblk = gridDim.x;
    const T rz = *rzp;
    const long long n = a.n;
    const long long t0 = static_cast<long long>(blockIdx.x) * THREADS +
                         threadIdx.x;
    const long long nt = static_cast<long long>(nblk) * THREADS;

    T acc = T(0);
    for (long long i = t0; i < n; i += nt) acc += p[i] * ap[i];
    T s = block_sum(acc, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
    grid_barrier(a.bar);
    const T pAp = grid_sum(part, nblk, sh);
    const T alpha = rz / (pAp == T(0) ? T(1) : pAp);

    acc = T(0);
    for (long long i = t0; i < n; i += nt) {
        const T ri = r[i] - alpha * ap[i];
        x[i] = x[i] + alpha * p[i];
        r[i] = ri;
        acc += ri * (dinv[i] * ri);
    }
    s = block_sum(acc, sh);
    if (threadIdx.x == 0) part[nblk + blockIdx.x] = s;
    grid_barrier(a.bar);
    const T rzn = grid_sum(part + nblk, nblk, sh);
    const T beta = rzn / (rz == T(0) ? T(1) : rz);
    for (long long i = t0; i < n; i += nt)
        p[i] = dinv[i] * r[i] + beta * p[i];
    if (blockIdx.x == 0 && threadIdx.x == 0) *rzp = rzn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) vec_init(PcgArgs a) {
    __shared__ T sh[THREADS / 32];
    T* r = static_cast<T*>(a.r);
    T* p = static_cast<T*>(a.p);
    const T* b = static_cast<const T*>(a.b);
    const T* fx0 = static_cast<const T*>(a.fx0);
    const T* dinv = static_cast<const T*>(a.dinv);
    T* part = static_cast<T*>(a.part);
    const int nblk = gridDim.x;
    const long long n = a.n;
    const long long t0 = static_cast<long long>(blockIdx.x) * THREADS +
                         threadIdx.x;
    const long long nt = static_cast<long long>(nblk) * THREADS;
    T acc = T(0);
    for (long long i = t0; i < n; i += nt) {
        const T ri = fx0 != nullptr ? b[i] - fx0[i] : b[i];
        const T zi = dinv[i] * ri;
        r[i] = ri;
        p[i] = zi;
        acc += ri * zi;
    }
    const T s = block_sum(acc, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
    grid_barrier(a.bar);
    const T rz = grid_sum(part, nblk, sh);
    if (blockIdx.x == 0 && threadIdx.x == 0) *static_cast<T*>(a.rz) = rz;
}

// The block form: block (bx, by) takes columns by*32 + tx of rows bx*8 + ty
// + m * gridDim.x * 8.  A column's sum: each thread's partial in row
// order, the block's 8 rows in order, then the gridDim.x blocks of its
// column tile in order (part[(by * gridDim.x + bx) * 32 + tx]).
template <typename T>
__device__ T col_sum(T v, T* part, T (&sh)[ROWS][33], unsigned long long* bar,
                     int tx, int ty) {
    sh[ty][tx] = v;
    __syncthreads();
    const int gx = gridDim.x;
    if (ty == 0) {
        T s = sh[0][tx];
#pragma unroll
        for (int j = 1; j < ROWS; ++j) s += sh[j][tx];
        part[(static_cast<size_t>(blockIdx.y) * gx + blockIdx.x) * 32 + tx] =
            s;
    }
    grid_barrier(bar);
    if (ty == 0) {
        T s = T(0);
        const T* col = part + static_cast<size_t>(blockIdx.y) * gx * 32 + tx;
        for (int j = 0; j < gx; ++j)
            s += __ldcg(col + static_cast<size_t>(j) * 32);
        sh[0][tx] = s;
    }
    __syncthreads();
    return sh[0][tx];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) blk_step(PcgArgs a) {
    __shared__ T sh[ROWS][33];
    T* X = static_cast<T*>(a.x);
    T* R = static_cast<T*>(a.r);
    T* P = static_cast<T*>(a.p);
    const T* AP = static_cast<const T*>(a.ap);
    const T* dinv = static_cast<const T*>(a.dinv);
    T* rzp = static_cast<T*>(a.rz);
    T* part = static_cast<T*>(a.part);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int k = a.k;
    const int c = blockIdx.y * 32 + tx;
    const bool col = c < k;
    const long long n = a.n;
    const long long stride = static_cast<long long>(gridDim.x) * ROWS;
    const long long i0 = static_cast<long long>(blockIdx.x) * ROWS + ty;
    const size_t half = static_cast<size_t>(gridDim.x) * gridDim.y * 32;
    const T rz = col ? rzp[c] : T(0);

    T acc = T(0);
    if (col)
        for (long long i = i0; i < n; i += stride)
            acc += P[i * k + c] * AP[i * k + c];
    const T pAp = col_sum(acc, part, sh, a.bar, tx, ty);
    const T alpha = rz / (pAp == T(0) ? T(1) : pAp);
    acc = T(0);
    if (col)
        for (long long i = i0; i < n; i += stride) {
            const size_t o = static_cast<size_t>(i) * k + c;
            const T ri = R[o] - alpha * AP[o];
            X[o] = X[o] + alpha * P[o];
            R[o] = ri;
            acc += ri * (dinv[i] * ri);
        }
    __syncthreads();
    const T rzn = col_sum(acc, part + half, sh, a.bar, tx, ty);
    const T beta = rzn / (rz == T(0) ? T(1) : rz);
    if (col) {
        for (long long i = i0; i < n; i += stride) {
            const size_t o = static_cast<size_t>(i) * k + c;
            P[o] = dinv[i] * R[o] + beta * P[o];
        }
        if (blockIdx.x == 0 && ty == 0) rzp[c] = rzn;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) blk_init(PcgArgs a) {
    __shared__ T sh[ROWS][33];
    T* R = static_cast<T*>(a.r);
    T* P = static_cast<T*>(a.p);
    const T* B = static_cast<const T*>(a.b);
    const T* dinv = static_cast<const T*>(a.dinv);
    T* part = static_cast<T*>(a.part);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int k = a.k;
    const int c = blockIdx.y * 32 + tx;
    const bool col = c < k;
    const long long n = a.n;
    const long long stride = static_cast<long long>(gridDim.x) * ROWS;
    const long long i0 = static_cast<long long>(blockIdx.x) * ROWS + ty;
    T acc = T(0);
    if (col)
        for (long long i = i0; i < n; i += stride) {
            const size_t o = static_cast<size_t>(i) * k + c;
            const T ri = B[o];
            const T zi = dinv[i] * ri;
            R[o] = ri;
            P[o] = zi;
            acc += ri * zi;
        }
    const T rz = col_sum(acc, part, sh, a.bar, tx, ty);
    if (col && blockIdx.x == 0 && ty == 0) static_cast<T*>(a.rz)[c] = rz;
}

// blocks a multiprocessor holds of both kernels of a form (so that the
// init and step launches of one shape share one grid), and the SMs
template <typename T>
cudaError_t occupancy(bool block_form, int& occ, int& sms) {
    static int cache[2] = {0, 0}, sm = 0;
    int& c = cache[block_form];
    cudaError_t err;
    if (c == 0) {
        int dev = 0, o1 = 0, o2 = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
        if ((err = cudaDeviceGetAttribute(&sm, cudaDevAttrMultiProcessorCount,
                                          dev)) != cudaSuccess)
            return err;
        if (block_form) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &o1, blk_step<T>, THREADS, 0);
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &o2, blk_init<T>, THREADS, 0);
        } else {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &o1, vec_step<T>, THREADS, 0);
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &o2, vec_init<T>, THREADS, 0);
        }
        if (err != cudaSuccess) return err;
        c = o1 < o2 ? o1 : o2;
        if (c == 0) return cudaErrorInvalidConfiguration;
    }
    occ = c;
    sms = sm;
    return cudaSuccess;
}

template <typename T>
cudaError_t grid_of(int n, int k, dim3& grid) {
    int occ = 0, sms = 0;
    const cudaError_t err = occupancy<T>(k > 0, occ, sms);
    if (err != cudaSuccess) return err;
    const long long most = static_cast<long long>(occ) * sms;
    if (k == 0) {
        long long g = (static_cast<long long>(n) + THREADS - 1) / THREADS;
        if (g > most) g = most;
        grid = dim3(static_cast<unsigned>(g < 1 ? 1 : g));
        return cudaSuccess;
    }
    const long long gy = (static_cast<long long>(k) + 31) / 32;
    if (gy > most) return cudaErrorInvalidConfiguration;
    long long gx = (static_cast<long long>(n) + ROWS - 1) / ROWS;
    if (gx > most / gy) gx = most / gy;
    grid = dim3(static_cast<unsigned>(gx < 1 ? 1 : gx),
                static_cast<unsigned>(gy));
    return cudaSuccess;
}

template <typename T>
cudaError_t launch(const PcgArgs& a, bool init, cudaStream_t st) {
    dim3 grid;
    cudaError_t err = grid_of<T>(a.n, a.k, grid);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (a.k == 0)
        err = init ? cudaLaunchKernelEx(&cfg, vec_init<T>, a)
                   : cudaLaunchKernelEx(&cfg, vec_step<T>, a);
    else
        err = init ? cudaLaunchKernelEx(&cfg, blk_init<T>, a)
                   : cudaLaunchKernelEx(&cfg, blk_step<T>, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

bool valid(const PcgArgs& a, bool init) {
    if (a.n <= 0 || a.k < 0 || a.x == nullptr || a.r == nullptr ||
        a.p == nullptr || a.dinv == nullptr || a.rz == nullptr ||
        a.part == nullptr || a.bar == nullptr)
        return false;
    if (static_cast<long long>(a.n) * (a.k > 0 ? a.k : 1) >= (1LL << 40))
        return false;
    return init ? a.b != nullptr && (a.k == 0 || a.fx0 == nullptr)
                : a.ap != nullptr;
}

int run(const PcgArgs* args, bool init, void* stream) {
    const PcgArgs& a = *args;
    if (!valid(a, init)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(a.f64 ? launch<double>(a, init, st)
                                  : launch<float>(a, init, st));
}

}  // namespace

extern "C" {

// One iteration's tail after the matvec (args->ap = F p), in place.
int pcg_step(const PcgArgs* args, void* stream) {
    return run(args, false, stream);
}

// The start of the loop: r, p and rz from b (and F x0).
int pcg_init(const PcgArgs* args, void* stream) {
    return run(args, true, stream);
}

// The blocks of the grid a launch of shape (n, k) takes (the caller sizes
// the partials from it: 2 x blocks x 32 words).
int pcg_grid(int n, int k, int f64, int* blocks) {
    dim3 grid;
    const cudaError_t err =
        f64 ? grid_of<double>(n, k, grid) : grid_of<float>(n, k, grid);
    if (err == cudaSuccess) *blocks = static_cast<int>(grid.x * grid.y);
    return static_cast<int>(err);
}

const char* pcg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
