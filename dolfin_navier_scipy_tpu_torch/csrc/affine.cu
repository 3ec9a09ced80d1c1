// The affine-geometry element matvecs of the Taylor-Hood Stokes family for
// Hopper (sm_90a): M x, A x, cm M x + ca A x, J x and J^T q, each one launch
// of gather -> per-point quadrature -> fixed-order reduction.
//
// Per element e (NVPC velocity nodes, DIM components, ND = NVPC*DIM element
// dofs, PN pressure nodes, Q quadrature points), with xe[a,c] = x[vd[e,
// DIM*a+c]] (an id outside [0, nin) reads 0):
//
//   uq[q,c]     = sum_a N2[q,a] xe[a,c]
//   rg[q,k,c]   = sum_a dN2[q,a,k] xe[a,c]
//   D[q,c,d]    = sum_k JinvT[e,d,k] rg[q,k,c]            (d x_c / d x_d)
//   mode MA (cm M + ca A; M alone is cm 1 ca 0, A alone cm 0 ca 1):
//     F[q,c,d]  = ca nu (D[q,c,d] (+ D[q,d,c] if sym))
//     G[q,k,c]  = wdet[e,q] sum_d JinvT[e,d,k] F[q,c,d]
//     fe[a,c]   = sum_{q,k} dN2[q,a,k] G[q,k,c]
//               + sum_q N2[q,a] cm detJ[e] qw[q] uq[q,c]
//     ffe[f,a]  = ca sum_b fac_elem[f,a,b] x[fac_vd[f,b]]  (facet rows:
//                 outflow and Robin terms folded into A)
//   mode J:   fe[p] = sum_q N1[q,p] wdet[e,q] sum_c D[q,c,c]
//   mode JT:  qq[q] = sum_p N1[q,p] q[pd[e,p]];
//             fe[a,c] = sum_{q,k} dN2[q,a,k] wdet[e,q] JinvT[e,c,k] qq[q]
//
// and then, per output dof i, y[i] = the fe slots that point at i in the
// ascending order of the CSR table dof_slot_table, then the facet slots.
//
// Replaces dolfin_navier_scipy_tpu_torch/ops/affine.py: AffineVectorOps, the
// twin of dolfin_navier_scipy_tpu/ops/affine.py, which the JAX package left
// to XLA (gather -> constant-weight matmuls against the Kronecker-expanded
// tables W2/W2T/MrefI2 -> 2x2 einsums -> segment_sum: ~7 tensor launches a
// matvec, five matvec kinds).  Here the reference tables N2/dN2/N1 are used
// directly and the mass matrix is its own quadrature (Mref = sum_q qw N2 N2,
// exact for P2 x P2 with the degree-5 rule).
//
// Bound: at the wake's level-2 size (6678 elements, 25 966 inner dofs) a call
// reads ~0.4 MB of tables and state and does ~4 MFLOP: neither bytes nor
// operations come near one launch's latency.  Like csrc/convection.cu, whose
// gather, butterfly and reduction it shares, it is bound by its dependent
// chain and the number of launches: one launch a matvec, where the tensor
// pipeline took ~7.
//
// Design (the convection kernel's, over one more mode argument):
//   * phase 1, one group of 8 lanes per element, lane q the quadrature point
//     q (lane 7 idle, zero weights); the group loads the element's ids and
//     values cooperatively and shares them by __shfl_sync; each lane
//     computes its point's contributions; a fixed xor-butterfly over the 8
//     lanes sums them, the same bits in every lane.  The facet rows (MA with
//     ca != 0), one thread each from the grid's end, share the phase.
//     Contributions go to a scratch buffer.
//   * a grid-wide barrier on an arrival counter that only grows; the grid is
//     sized from the occupancy query and launched cooperative, so every
//     block is resident.
//   * phase 2, one thread per output dof, its slots from a dof-major padded
//     (ELL) table, facet slots after the element slots.  No floating-point
//     atomics: reruns give the same bits.
//   * the vector may be f64 while the work type T is f32 (f64 carry, f32
//     tables): the cast happens in the gather's load and the reduction's
//     store.
//
// Written over NVPC, PN, Q, DIM as compile-time parameters (Q <= 8); only
// the 2D Taylor-Hood instantiation (6, 3, 7, 2) is built.  Plain C
// interface, loaded with ctypes; the caller allocates the scratch, the
// barrier words and the output, and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Must match ops/kernels.py: _AffinePlanC field for field.
struct AffinePlan {
    const int* vd;          // (nc, ND) velocity ids in [0, nin), else dropped
    const int* pd;          // (nc, PN) pressure ids in [0, npc), else dropped
    const void* JinvT;      // (nc, DIM, DIM) work type
    const void* wdet;       // (nc, Q)
    const void* detJ;       // (nc,)
    const void* qw;         // (Q,)
    const void* N2;         // (Q, NVPC)
    const void* dN2;        // (Q, NVPC, DIM)
    const void* N1;         // (Q, PN)
    const void* fac_elem;   // (nfac, ND, ND) or null
    const int* fac_vd;      // (nfac, ND) or null
    const int* vell;        // (vwidth, nin) element slots of the velocity
    const int* pell;        // (pwidth, npc) element slots of the pressure
    const int* fell;        // (fwidth, nin) facet slots, or null
    void* scratch;          // (nc ND + nfac ND) work type
    unsigned long long* bar;  // arrival counter, zero before the first
                              // launch of this plan (the grid is fixed)
    int nc, nin, npc, nfac, vwidth, pwidth, fwidth;
    int work_f64;
};

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 8;            // lanes per element group
constexpr int BATCH = 16;           // ELL entries loaded before adding
constexpr unsigned FULL = 0xffffffffu;

enum Mode { MODE_MA = 0, MODE_J = 1, MODE_JT = 2 };

__device__ __forceinline__ bool in_range(int id, int n) {
    return static_cast<unsigned>(id) < static_cast<unsigned>(n);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.global.acquire.gpu.b64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// All blocks of the grid meet here (csrc/convection.cu's barrier): `count`
// only grows, each launch adds gridDim.x arrivals.
__device__ void grid_barrier(unsigned long long* count) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        const unsigned long long old = atomicAdd(count, 1ull);
        const unsigned long long target = (old / gridDim.x + 1) * gridDim.x;
        while (ld_acquire(count) < target) {
        }
    }
    __syncthreads();
}

template <typename T, typename TU>
__device__ __forceinline__ T gather(const TU* x, int id, int n) {
    return in_range(id, n) ? static_cast<T>(x[id]) : T(0);
}

template <typename T, typename TU, int NVPC, int PN, int Q, int DIM,
          int MODE>
__global__ void __launch_bounds__(THREADS)
affine_kernel(const AffinePlan p, const TU* __restrict__ x,
              TU* __restrict__ y, T cm, T ca, T nu, int sym, int facets) {
    constexpr int ND = NVPC * DIM;
    constexpr int NS = MODE == MODE_J ? PN : ND;   // element slots
    static_assert(Q <= LANES && ND <= 2 * LANES && PN <= LANES,
                  "one lane per point");
    const T* __restrict__ JinvT = static_cast<const T*>(p.JinvT);
    const T* __restrict__ wdet = static_cast<const T*>(p.wdet);
    T* scratch = static_cast<T*>(p.scratch);
    const int nc = p.nc, nin = p.nin, npc = p.npc;
    const size_t nslot = static_cast<size_t>(nc) * NS;
    const long long tid =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;
    const bool want_m = MODE == MODE_MA && cm != T(0);
    const bool want_a = MODE == MODE_MA && ca != T(0);

    // -- phase 1: elements, 8 lanes each -----------------------------------
    const int lane = threadIdx.x & 31;
    const int q = lane & (LANES - 1);
    const bool point = q < Q;
    T N[NVPC], dN[NVPC][DIM], P[PN];
    T qwq;
    {
        const T* N2 = static_cast<const T*>(p.N2);
        const T* dN2 = static_cast<const T*>(p.dN2);
        const T* N1 = static_cast<const T*>(p.N1);
#pragma unroll
        for (int a = 0; a < NVPC; ++a) {
            N[a] = point ? N2[q * NVPC + a] : T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                dN[a][k] = point ? dN2[(q * NVPC + a) * DIM + k] : T(0);
        }
#pragma unroll
        for (int r = 0; r < PN; ++r) P[r] = point ? N1[q * PN + r] : T(0);
        qwq = point ? static_cast<const T*>(p.qw)[q] : T(0);
    }
    constexpr int PER_WARP = 32 / LANES;
    for (long long e0 = (tid >> 5) * PER_WARP; e0 < nc;
         e0 += (nthreads >> 5) * PER_WARP) {
        const long long e = e0 + (lane / LANES);
        const bool valid = e < nc;
        T Ji[DIM][DIM];                           // Ji[d][k] = JinvT[e,d,k]
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                Ji[d][k] = valid ? JinvT[(e * DIM + d) * DIM + k] : T(0);
        const T w = (valid && point) ? wdet[e * Q + q] : T(0);
        T fe[NS];

        if constexpr (MODE == MODE_JT) {
            // the element's pressure values, lanes 0..PN-1 load one each
            const int pid = (valid && q < PN) ? p.pd[e * PN + q] : -1;
            const T pv = gather<T>(x, pid, npc);
            T qq = T(0);
#pragma unroll
            for (int r = 0; r < PN; ++r)
                qq += P[r] * __shfl_sync(FULL, pv, r, LANES);
            const T wq = w * qq;
#pragma unroll
            for (int a = 0; a < NVPC; ++a)
#pragma unroll
                for (int c = 0; c < DIM; ++c) {
                    T s = T(0);
#pragma unroll
                    for (int k = 0; k < DIM; ++k) s += dN[a][k] * Ji[c][k];
                    fe[a * DIM + c] = s * wq;
                }
        } else {
            const int* ids = p.vd + e * ND;
            const int id0 = valid ? ids[q] : -1;
            const int id1 = (valid && q + LANES < ND) ? ids[q + LANES] : -1;
            const T a0 = gather<T>(x, id0, nin);
            const T a1 = gather<T>(x, id1, nin);
            T xe[ND];
#pragma unroll
            for (int j = 0; j < ND; ++j)
                xe[j] = __shfl_sync(FULL, j < LANES ? a0 : a1, j % LANES,
                                    LANES);
            T rg[DIM][DIM];                       // rg[k][c]
#pragma unroll
            for (int k = 0; k < DIM; ++k)
#pragma unroll
                for (int c = 0; c < DIM; ++c) rg[k][c] = T(0);
#pragma unroll
            for (int a = 0; a < NVPC; ++a)
#pragma unroll
                for (int k = 0; k < DIM; ++k)
#pragma unroll
                    for (int c = 0; c < DIM; ++c)
                        rg[k][c] += dN[a][k] * xe[a * DIM + c];
            T D[DIM][DIM];                        // D[c][d] = dx_c/dx_d
#pragma unroll
            for (int c = 0; c < DIM; ++c)
#pragma unroll
                for (int d = 0; d < DIM; ++d) {
                    T s = T(0);
#pragma unroll
                    for (int k = 0; k < DIM; ++k) s += Ji[d][k] * rg[k][c];
                    D[c][d] = s;
                }
            if constexpr (MODE == MODE_J) {
                T div = T(0);
#pragma unroll
                for (int c = 0; c < DIM; ++c) div += D[c][c];
                const T wd = w * div;
#pragma unroll
                for (int r = 0; r < PN; ++r) fe[r] = wd * P[r];
            } else {
#pragma unroll
                for (int j = 0; j < ND; ++j) fe[j] = T(0);
                if (want_a) {
                    const T cw = ca * nu * w;
                    T G[DIM][DIM];                // G[k][c]
#pragma unroll
                    for (int k = 0; k < DIM; ++k)
#pragma unroll
                        for (int c = 0; c < DIM; ++c) {
                            T s = T(0);
#pragma unroll
                            for (int d = 0; d < DIM; ++d) {
                                const T F = sym ? D[c][d] + D[d][c] : D[c][d];
                                s += Ji[d][k] * F;
                            }
                            G[k][c] = cw * s;
                        }
#pragma unroll
                    for (int a = 0; a < NVPC; ++a)
#pragma unroll
                        for (int c = 0; c < DIM; ++c) {
                            T s = T(0);
#pragma unroll
                            for (int k = 0; k < DIM; ++k)
                                s += dN[a][k] * G[k][c];
                            fe[a * DIM + c] = s;
                        }
                }
                if (want_m) {
                    const T dj = valid ? static_cast<const T*>(p.detJ)[e]
                                       : T(0);
                    const T wm = cm * dj * qwq;
                    T uq[DIM];
#pragma unroll
                    for (int c = 0; c < DIM; ++c) {
                        T s = T(0);
#pragma unroll
                        for (int a = 0; a < NVPC; ++a)
                            s += N[a] * xe[a * DIM + c];
                        uq[c] = wm * s;
                    }
#pragma unroll
                    for (int a = 0; a < NVPC; ++a)
#pragma unroll
                        for (int c = 0; c < DIM; ++c)
                            fe[a * DIM + c] += N[a] * uq[c];
                }
            }
        }
        // the sum over the group's points: a fixed butterfly
#pragma unroll
        for (int off = LANES / 2; off > 0; off /= 2) {
#pragma unroll
            for (int j = 0; j < NS; ++j)
                fe[j] += __shfl_xor_sync(FULL, fe[j], off, LANES);
        }
        if (valid) {
            // lane q stores slots q and q + 8 (statically indexed selects)
            T s0 = T(0), s1 = T(0);
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                if (j == q) s0 = fe[j];
                if (j == q + LANES) s1 = fe[j];
            }
            T* o = scratch + e * NS;
            if (q < NS) o[q] = s0;
            if (q + LANES < NS) o[q + LANES] = s1;
        }
    }
    // the facet rows, one thread each, counted from the grid's last thread
    if (MODE == MODE_MA && facets) {
        const T* fac_elem = static_cast<const T*>(p.fac_elem);
        for (long long r = nthreads - 1 - tid;
             r < static_cast<long long>(p.nfac) * ND; r += nthreads) {
            const T* row = fac_elem + r * ND;
            const int* fids = p.fac_vd + (r / ND) * ND;
            T acc = T(0);
#pragma unroll
            for (int b = 0; b < ND; ++b)
                acc += row[b] * gather<T>(x, fids[b], nin);
            scratch[nslot + r] = acc * ca;
        }
    }

    grid_barrier(p.bar);

    // -- phase 2: per output dof, its slots in the fixed order --------------
    const int nout = MODE == MODE_J ? npc : nin;
    const int* ell = MODE == MODE_J ? p.pell : p.vell;
    const int width = MODE == MODE_J ? p.pwidth : p.vwidth;
    for (long long i = tid; i < nout; i += nthreads) {
        T acc = T(0);
        for (int k0 = 0; k0 < width; k0 += BATCH) {
            int s[BATCH];
            T v[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                s[u] = k0 + u < width
                           ? ell[static_cast<size_t>(k0 + u) * nout + i]
                           : -1;
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                v[u] = s[u] >= 0 ? __ldcg(scratch + s[u]) : T(0);
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                if (s[u] >= 0) acc += v[u];
        }
        if (MODE == MODE_MA && facets) {
            for (int k = 0; k < p.fwidth; ++k) {
                const int sl = p.fell[static_cast<size_t>(k) * nin + i];
                if (sl >= 0) acc += __ldcg(scratch + nslot + sl);
            }
        }
        y[i] = static_cast<TU>(acc);
    }
}

template <typename T, typename TU, int MODE>
cudaError_t launch(const AffinePlan& p, const void* x, void* y, double cm,
                   double ca, double nu, int sym, int facets,
                   cudaStream_t st) {
    constexpr int NVPC = 6, PN = 3, Q = 7, DIM = 2, ND = NVPC * DIM;
    auto kern = affine_kernel<T, TU, NVPC, PN, Q, DIM, MODE>;
    // per instantiation: how many blocks an SM holds (a host query costs
    // more than the launch)
    static int occ = 0, sms = 0;
    cudaError_t err;
    if (occ == 0) {
        int dev = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev)) != cudaSuccess)
            return err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &occ, kern, THREADS, 0)) != cudaSuccess)
            return err;
        if (occ == 0) return cudaErrorInvalidConfiguration;
    }
    long long work = static_cast<long long>(p.nc) * LANES;
    const long long rows = facets ? static_cast<long long>(p.nfac) * ND : 0;
    const long long nout = MODE == MODE_J ? p.npc : p.nin;
    if (rows > work) work = rows;
    if (nout > work) work = nout;
    long long blocks = (work + THREADS - 1) / THREADS;
    // every block resident at once: the grid barrier needs it
    const long long most = static_cast<long long>(occ) * sms;
    if (blocks > most) blocks = most;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, p, static_cast<const TU*>(x),
                             static_cast<TU*>(y), static_cast<T>(cm),
                             static_cast<T>(ca), static_cast<T>(nu), sym,
                             facets);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, typename TU>
cudaError_t launch_mode(const AffinePlan& p, int mode, const void* x, void* y,
                        double cm, double ca, double nu, int sym, int facets,
                        cudaStream_t st) {
    switch (mode) {
        case MODE_MA:
            return launch<T, TU, MODE_MA>(p, x, y, cm, ca, nu, sym, facets,
                                          st);
        case MODE_J:
            return launch<T, TU, MODE_J>(p, x, y, cm, ca, nu, sym, 0, st);
        case MODE_JT:
            return launch<T, TU, MODE_JT>(p, x, y, cm, ca, nu, sym, 0, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// The 2D Taylor-Hood instantiation (NVPC 6, PN 3, Q 7, DIM 2).
//   plan: the tables, scratch and barrier words (see AffinePlan above);
//   mode 0 -> y (nin) = cm M x + ca A x (+ the facet rows when facets != 0),
//        1 -> y (npc) = J x, 2 -> y (nin) = J^T x with x (npc);
//   x, y in the vector type (x_f64), the work type from plan->work_f64.
// Returns the cudaError_t of the launch (0 = success).
int affine_th2d(const AffinePlan* plan, int mode, const void* x, void* y,
                int x_f64, double cm, double ca, double nu, int sym,
                int facets, void* stream) {
    const AffinePlan& p = *plan;
    if (p.nc <= 0 || p.nin <= 0 || p.npc <= 0 || p.nfac < 0 ||
        p.vwidth <= 0 || p.pwidth <= 0 || p.bar == nullptr ||
        (facets && (mode != 0 || p.nfac == 0 || p.fac_elem == nullptr ||
                    p.fac_vd == nullptr || p.fell == nullptr ||
                    p.fwidth <= 0)) ||
        static_cast<long long>(p.nc) * 12 +
                static_cast<long long>(p.nfac) * 12 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.work_f64)
        err = x_f64 ? launch_mode<double, double>(p, mode, x, y, cm, ca, nu,
                                                  sym, facets, st)
                    : launch_mode<double, float>(p, mode, x, y, cm, ca, nu,
                                                 sym, facets, st);
    else
        err = x_f64 ? launch_mode<float, double>(p, mode, x, y, cm, ca, nu,
                                                 sym, facets, st)
                    : launch_mode<float, float>(p, mode, x, y, cm, ca, nu,
                                                sym, facets, st);
    return static_cast<int>(err);
}

const char* affine_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
