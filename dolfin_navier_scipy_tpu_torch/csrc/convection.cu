// Fused gather -> quadrature -> fixed-order reduction of the convection
// vector (and, in the fused form, the stiffness load) for Hopper (sm_90a).
//
// Per element e of a Taylor-Hood mesh (NVPC velocity nodes, DIM components,
// ND = NVPC*DIM element dofs, Q quadrature points):
//
//   ue[a,c]     = u1[vd[e, DIM*a+c]]            (index >= nv_full reads 0)
//   u2q[q,d]    = sum_a N2[q,a] u2e[a,d]        (u2e = ue unless u2 given)
//   rg[q,k,c]   = sum_a dN2[q,a,k] ue[a,c]
//   guq[q,c,d]  = sum_k JinvT[e,d,k] rg[q,k,c]
//   fe_c[a,c]   = sum_q wdet[e,q] N2[q,a] sum_d u2q[q,d] guq[q,c,d]
//   fused only:
//   F[q,c,d]    = guq[q,c,d] (+ guq[q,d,c] if sym)
//   G[q,k,c]    = nu wdet[e,q] sum_d JinvT[e,d,k] F[q,c,d]
//   fe_a[a,c]   = sum_{q,k} dN2[q,a,k] G[q,k,c]
//   ffe[f,a]    = sum_b fac_elem[f,a,b] u1[fac_vd[f,b]]     (facet blocks)
//
// and then, per dof i, conv[i] = sum of the fe_c slots that point at i and
// av[i] = sum of the fe_a slots, then of the ffe slots, that point at i.
//
// Takes the place of the function the TPU toolchain probe
// tools/probe_pallas_gather.py asked for and could not have (a gather inside
// a kernel body): dolfin_navier_scipy_tpu/ops/convection.py:
// ConvectionKernel.vector / vector_and_amatvec, which the JAX package left to
// XLA as gather -> two constant-weight matmuls -> einsums -> segment_sum.
// Here the gather is an indexed load and the reference tables N2/dN2
// themselves are used (the Kronecker-expanded weight matrices only existed to
// feed a matrix unit).
//
// Bound: at the mesh sizes of the dense-solver path (a few thousand
// elements) neither bytes (~0.3 MB) nor operations (~5 MFLOP) come near one
// launch's latency.  The kernel is bound by its longest dependent chain and
// by how many launches a call costs; tensor cores buy nothing at this size.
//
// Design: one launch, two phases, grid-stride loops in both (a larger mesh
// still runs as one launch).
//   * phase 1, one group of 8 lanes per element (4 elements a warp), lane q
//     the quadrature point q (lane 7 idle, with zero weights).  The group
//     loads the ND dof ids and state values cooperatively (two loads a
//     lane) and shares them by __shfl_sync; each lane holds its point's
//     N2/dN2 rows in registers and computes its point's ND (fused: 2 ND)
//     contributions; a fixed xor-butterfly over the 8 lanes (4, 2, 1) sums
//     them, identically in every lane.  The dependent chain is one point's
//     arithmetic instead of seven in sequence.  The facet-block rows (one
//     thread each, from the grid's end) share the phase.  Loads go to a
//     scratch buffer.
//   * a grid-wide barrier: an integer arrival counter that only grows
//     (`bar`, 64 bits, zero-initialised, the plan's); the grid is sized from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor so that every block is
//     resident, and the launch carries cudaLaunchAttributeCooperative, which
//     makes the driver refuse a grid that cannot be.  Scratch written before it is read after it through
//     L2 (__ldcg), never through the non-coherent path.
//   * phase 2, one thread per dof: the dof's slots from a dof-major padded
//     (ELL) table ell[k][dof] (-1 past its count), built once on the host in
//     the ascending order of the CSR table `dof_slot_table`, facet slots
//     last: coalesced, independent loads (all indices, then all values,
//     then the sums in that order), two dependent loads deep.  No
//     floating-point atomics: the result is bitwise reproducible.
//   * the state u may be f64 while the work type T is f32 (f64 carry, f32
//     work arithmetic): the cast happens in the gather's load and the
//     reduction's store, so no separate cast launch is needed.
//   * every constant pointer and size comes in one plan (ConvPlan), built
//     once per table set by the caller; a call passes the plan, the states,
//     the outputs, nu, sym and the stream.
//
// Written over NVPC, Q, DIM as compile-time parameters (Q <= 8); only the 2D
// Taylor-Hood instantiation (6, 7, 2) is built.
//
// Plain C interface, loaded with ctypes; the caller allocates the scratch,
// the barrier words and the outputs, and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Outside the anonymous namespace: the C entry point takes it, and a
// parameter of an internal type would hide that entry point.  Must match
// ops/kernels.py: _ConvPlanC field for field.
struct ConvPlan {
    const int* vd;          // (nc, ND) full velocity-dof ids
    const void* JinvT;      // (nc, DIM, DIM) work type
    const void* wdet;       // (nc, Q)
    const void* N2;         // (Q, NVPC)
    const void* dN2;        // (Q, NVPC, DIM)
    const void* fac_elem;   // (nfac, ND, ND) or null
    const int* fac_vd;      // (nfac, ND) or null
    const int* ell;         // (width, nv_full) element slots, -1 padded
    const int* fell;        // (fwidth, nv_full) facet slots, or null
    void* scratch;          // ((1 + fused) nc ND + nfac ND) work type
    unsigned long long* bar;  // arrival counter, zero before the first
                              // launch of this plan (the grid is fixed)
    unsigned long long* trace;  // null, or 4 per block: %globaltimer at
                                // start, end of phase 1, after the
                                // barrier, end
    int nc, nv_full, nfac, width, fwidth;
    int work_f64, u_f64, fused;
};

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 8;            // lanes per element group
constexpr int BATCH = 16;           // ELL entries loaded before adding
constexpr int FBATCH = 4;           // facet ELL entries loaded up front
constexpr unsigned FULL = 0xffffffffu;

// a dof id outside [0, nv_full) is the dropped padding slot: it reads 0
__device__ __forceinline__ bool in_range(int id, int nv_full) {
    return static_cast<unsigned>(id) < static_cast<unsigned>(nv_full);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.global.acquire.gpu.b64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// All blocks of the grid meet here; writes before it are visible after it.
// `count` only grows: each launch adds gridDim.x arrivals, so a block's
// arrival number tells it which multiple of gridDim.x to wait for (64 bits:
// it never wraps).  One returning atomic per block, then polling.
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

__device__ __forceinline__ void stamp(const ConvPlan& p, int k) {
    if (p.trace != nullptr && threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
        p.trace[4 * blockIdx.x + k] = t;
    }
}

template <typename T, typename TU>
__device__ __forceinline__ T gather(const TU* u, int id, int nv_full) {
    return in_range(id, nv_full) ? static_cast<T>(u[id]) : T(0);
}

template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const ConvPlan p, const TU* __restrict__ u1,
            const TU* __restrict__ u2, TU* __restrict__ out_c,
            TU* __restrict__ out_a, T nu, int sym) {
    constexpr int ND = NVPC * DIM;
    static_assert(Q <= LANES && ND <= 2 * LANES, "one lane per point");
    const T* __restrict__ JinvT = static_cast<const T*>(p.JinvT);
    const T* __restrict__ wdet = static_cast<const T*>(p.wdet);
    T* scratch = static_cast<T*>(p.scratch);
    const int nc = p.nc, nv_full = p.nv_full;
    const size_t nslot = static_cast<size_t>(nc) * ND;
    const long long tid =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;

    stamp(p, 0);
    // -- phase 1: elements, 8 lanes each -----------------------------------
    const int lane = threadIdx.x & 31;
    const int q = lane & (LANES - 1);
    const bool point = q < Q;
    T N[NVPC], dN[NVPC][DIM];
    {
        const T* N2 = static_cast<const T*>(p.N2);
        const T* dN2 = static_cast<const T*>(p.dN2);
#pragma unroll
        for (int a = 0; a < NVPC; ++a) {
            N[a] = point ? N2[q * NVPC + a] : T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                dN[a][k] = point ? dN2[(q * NVPC + a) * DIM + k] : T(0);
        }
    }
    constexpr int PER_WARP = 32 / LANES;
    for (long long e0 = (tid >> 5) * PER_WARP; e0 < nc;
         e0 += (nthreads >> 5) * PER_WARP) {
        const long long e = e0 + (lane / LANES);
        const bool valid = e < nc;
        const int* ids = p.vd + e * ND;
        const int id0 = valid ? ids[q] : -1;
        const int id1 = (valid && q + LANES < ND) ? ids[q + LANES] : -1;
        const T a0 = gather<T>(u1, id0, nv_full);
        const T a1 = gather<T>(u1, id1, nv_full);
        T b0 = a0, b1 = a1;
        if (u2 != nullptr) {
            b0 = gather<T>(u2, id0, nv_full);
            b1 = gather<T>(u2, id1, nv_full);
        }
        T ue[ND], u2e[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            ue[j] = __shfl_sync(FULL, j < LANES ? a0 : a1, j % LANES, LANES);
            u2e[j] = __shfl_sync(FULL, j < LANES ? b0 : b1, j % LANES, LANES);
        }
        T Ji[DIM][DIM];                           // Ji[d][k] = JinvT[e,d,k]
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                Ji[d][k] = valid ? JinvT[(e * DIM + d) * DIM + k] : T(0);
        const T w = (valid && point) ? wdet[e * Q + q] : T(0);

        // this lane's point
        T uq[DIM], rg[DIM][DIM];                  // rg[k][c]
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            uq[c] = T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k) rg[k][c] = T(0);
        }
#pragma unroll
        for (int a = 0; a < NVPC; ++a) {
#pragma unroll
            for (int c = 0; c < DIM; ++c) uq[c] += N[a] * u2e[a * DIM + c];
#pragma unroll
            for (int k = 0; k < DIM; ++k)
#pragma unroll
                for (int c = 0; c < DIM; ++c)
                    rg[k][c] += dN[a][k] * ue[a * DIM + c];
        }
        T guq[DIM][DIM];                          // guq[c][d] = dU_c/dx_d
#pragma unroll
        for (int c = 0; c < DIM; ++c)
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
                T s = T(0);
#pragma unroll
                for (int k = 0; k < DIM; ++k) s += Ji[d][k] * rg[k][c];
                guq[c][d] = s;
            }
        T wc[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = T(0);
#pragma unroll
            for (int d = 0; d < DIM; ++d) s += uq[d] * guq[c][d];
            wc[c] = w * s;
        }
        T fc[ND];
#pragma unroll
        for (int a = 0; a < NVPC; ++a)
#pragma unroll
            for (int c = 0; c < DIM; ++c) fc[a * DIM + c] = N[a] * wc[c];
        T fa[FUSED ? ND : 1];
        if constexpr (FUSED) {
            const T nuw = nu * w;
            T G[DIM][DIM];                        // G[k][c]
#pragma unroll
            for (int k = 0; k < DIM; ++k)
#pragma unroll
                for (int c = 0; c < DIM; ++c) {
                    T s = T(0);
#pragma unroll
                    for (int d = 0; d < DIM; ++d) {
                        const T F = sym ? guq[c][d] + guq[d][c] : guq[c][d];
                        s += Ji[d][k] * F;
                    }
                    G[k][c] = nuw * s;
                }
#pragma unroll
            for (int a = 0; a < NVPC; ++a)
#pragma unroll
                for (int c = 0; c < DIM; ++c) {
                    T s = T(0);
#pragma unroll
                    for (int k = 0; k < DIM; ++k) s += dN[a][k] * G[k][c];
                    fa[a * DIM + c] = s;
                }
        }
        // the sum over the group's points: a fixed butterfly, the same
        // bits in every lane
#pragma unroll
        for (int off = LANES / 2; off > 0; off /= 2) {
#pragma unroll
            for (int j = 0; j < ND; ++j) {
                fc[j] += __shfl_xor_sync(FULL, fc[j], off, LANES);
                if constexpr (FUSED)
                    fa[j] += __shfl_xor_sync(FULL, fa[j], off, LANES);
            }
        }
        if (valid) {
            // lane q stores slots q and q + 8 (statically indexed selects)
            T c0 = T(0), c1 = T(0), f0 = T(0), f1 = T(0);
#pragma unroll
            for (int j = 0; j < ND; ++j) {
                if (j == q) c0 = fc[j];
                if (j == q + LANES) c1 = fc[j];
                if constexpr (FUSED) {
                    if (j == q) f0 = fa[j];
                    if (j == q + LANES) f1 = fa[j];
                }
            }
            T* oc = scratch + e * ND;
            oc[q] = c0;
            if (q + LANES < ND) oc[q + LANES] = c1;
            if (FUSED) {
                T* oa = scratch + nslot + e * ND;
                oa[q] = f0;
                if (q + LANES < ND) oa[q + LANES] = f1;
            }
        }
    }
    // the facet-block rows: ffe[f,a] = fac_elem[f,a,:] . u, one thread each,
    // counted from the grid's last thread (the last block holds the fewest
    // elements; the first would do them after a full element group)
    if (FUSED) {
        const T* fac_elem = static_cast<const T*>(p.fac_elem);
        for (long long r = nthreads - 1 - tid;
             r < static_cast<long long>(p.nfac) * ND; r += nthreads) {
            const T* row = fac_elem + r * ND;
            const int* fids = p.fac_vd + (r / ND) * ND;
            T acc = T(0);
#pragma unroll
            for (int b = 0; b < ND; ++b)
                acc += row[b] * gather<T>(u1, fids[b], nv_full);
            scratch[2 * nslot + r] = acc;
        }
    }

    stamp(p, 1);
    grid_barrier(p.bar);
    stamp(p, 2);

    // -- phase 2: per dof, its slots in the fixed order ---------------------
    // the slot indices of a batch first (element slots and the first facet
    // slots together), then their values, then the sums in order: two
    // dependent loads deep while a dof has at most BATCH element slots
    for (long long i = tid; i < nv_full; i += nthreads) {
        T c = T(0), a = T(0);
        int f[FBATCH];
        T vf[FBATCH];
        if constexpr (FUSED) {
#pragma unroll
            for (int u = 0; u < FBATCH; ++u)
                f[u] = u < p.fwidth
                           ? p.fell[static_cast<size_t>(u) * nv_full + i]
                           : -1;
        }
        for (int k0 = 0; k0 < p.width; k0 += BATCH) {
            int s[BATCH];
            T vc[BATCH], va[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                s[u] = k0 + u < p.width
                           ? p.ell[static_cast<size_t>(k0 + u) * nv_full + i]
                           : -1;
            if constexpr (FUSED) {
                if (k0 == 0) {
#pragma unroll
                    for (int u = 0; u < FBATCH; ++u)
                        vf[u] = f[u] >= 0
                                    ? __ldcg(scratch + 2 * nslot + f[u])
                                    : T(0);
                }
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                vc[u] = s[u] >= 0 ? __ldcg(scratch + s[u]) : T(0);
                if constexpr (FUSED)
                    va[u] = s[u] >= 0 ? __ldcg(scratch + nslot + s[u])
                                      : T(0);
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                if (s[u] >= 0) {
                    c += vc[u];
                    if constexpr (FUSED) a += va[u];
                }
        }
        out_c[i] = static_cast<TU>(c);
        if constexpr (FUSED) {
            // the facet slots after all element slots, in their order
#pragma unroll
            for (int u = 0; u < FBATCH; ++u)
                if (f[u] >= 0) a += vf[u];
            for (int k = FBATCH; k < p.fwidth; ++k) {
                const int sl = p.fell[static_cast<size_t>(k) * nv_full + i];
                if (sl >= 0) a += __ldcg(scratch + 2 * nslot + sl);
            }
            out_a[i] = static_cast<TU>(a);
        }
    }
    stamp(p, 3);
}

template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
cudaError_t launch(const ConvPlan& p, const void* u1, const void* u2,
                   void* out_c, void* out_a, double nu, int sym,
                   cudaStream_t st) {
    constexpr int ND = NVPC * DIM;
    auto kern = conv_kernel<T, TU, NVPC, Q, DIM, FUSED>;
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
    const long long lanes = static_cast<long long>(p.nc) * LANES;
    const long long rows = FUSED ? static_cast<long long>(p.nfac) * ND : 0;
    long long work = lanes > rows ? lanes : rows;
    if (p.nv_full > work) work = p.nv_full;
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
    err = cudaLaunchKernelEx(&cfg, kern, p, static_cast<const TU*>(u1),
                             static_cast<const TU*>(u2),
                             static_cast<TU*>(out_c), static_cast<TU*>(out_a),
                             static_cast<T>(nu), sym);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, typename TU>
cudaError_t launch_form(const ConvPlan& p, const void* u1, const void* u2,
                        void* out_c, void* out_a, double nu, int sym,
                        cudaStream_t st) {
    return p.fused
               ? launch<T, TU, 6, 7, 2, true>(p, u1, u2, out_c, out_a, nu,
                                              sym, st)
               : launch<T, TU, 6, 7, 2, false>(p, u1, u2, out_c, out_a, nu,
                                               sym, st);
}

}  // namespace

extern "C" {

// The 2D Taylor-Hood instantiation (NVPC 6, Q 7, DIM 2).
//   plan: the tables, scratch and barrier words (see ConvPlan above);
//     fused 0 -> conv only (u2 may be null: u2 = u1), 1 -> conv and A u;
//   u1, u2 (nv_full) and out_c, out_a (nv_full, out_a unused unless fused)
//     in u's type (plan->u_f64).
// Returns the cudaError_t of the launch (0 = success).
int convection_th2d(const ConvPlan* plan, const void* u1, const void* u2,
                    void* out_c, void* out_a, double nu, int sym,
                    void* stream) {
    const ConvPlan& p = *plan;
    if (p.nc <= 0 || p.nv_full <= 0 || p.nfac < 0 || p.width <= 0 ||
        (p.nfac > 0 && (!p.fused || p.fac_elem == nullptr ||
                        p.fac_vd == nullptr || p.fell == nullptr ||
                        p.fwidth <= 0)) ||
        p.bar == nullptr ||
        static_cast<long long>(p.nc) * 12 * 2 +
                static_cast<long long>(p.nfac) * 12 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.work_f64)
        err = p.u_f64 ? launch_form<double, double>(p, u1, u2, out_c, out_a,
                                                    nu, sym, st)
                      : launch_form<double, float>(p, u1, u2, out_c, out_a,
                                                   nu, sym, st);
    else
        err = p.u_f64 ? launch_form<float, double>(p, u1, u2, out_c, out_a,
                                                   nu, sym, st)
                      : launch_form<float, float>(p, u1, u2, out_c, out_a,
                                                  nu, sym, st);
    return static_cast<int>(err);
}

const char* convection_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
