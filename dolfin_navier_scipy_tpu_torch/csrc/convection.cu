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
// launch's latency; the kernel is latency-bound and its job is to be two
// launches where the tensor-op pipeline is about sixty.
//
// Design.
//   * one thread per element, the whole chain in registers (ue, fe_c, fe_a:
//     3*ND values); the inner loops over a, c, d, k are fully unrolled so
//     every register array is statically indexed; N2/dN2 sit in shared
//     memory and are read as broadcasts.
//   * the facet blocks ride the same launch: threads past the last element
//     each compute one row of one facet block.
//   * no floating-point atomics: element loads go to a scratch buffer and a
//     second kernel sums, for every dof, its slots in the fixed order of a
//     CSR table built once on the host (ascending element, then local slot,
//     facet slots last).  The result is bitwise reproducible run to run.
//   * the state u may be f64 while the work type T is f32 (f64 carry, f32
//     work arithmetic): the cast happens in the gather's load and the
//     reduction's store, so no separate cast launch is needed.
//
// Written over NVPC, Q, DIM as compile-time parameters; only the 2D
// Taylor-Hood instantiation (6, 7, 2) is built.
//
// Plain C interface, loaded with ctypes; the caller allocates the scratch
// and the outputs, passes raw device pointers and the CUDA stream, and
// checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 64;

// a dof id outside [0, nv_full) is the dropped padding slot: it reads 0
__device__ __forceinline__ bool in_range(int id, int nv_full) {
    return static_cast<unsigned>(id) < static_cast<unsigned>(nv_full);
}

template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
conv_element_kernel(const TU* __restrict__ u1, const TU* __restrict__ u2,
                    const int* __restrict__ vd, const T* __restrict__ JinvT,
                    const T* __restrict__ wdet, const T* __restrict__ N2,
                    const T* __restrict__ dN2, int nc, int nv_full, T nu,
                    int sym, const T* __restrict__ fac_elem,
                    const int* __restrict__ fac_vd, int nfac,
                    T* __restrict__ scratch) {
    constexpr int ND = NVPC * DIM;
    __shared__ T sN[Q * NVPC];
    __shared__ T sdN[Q * NVPC * DIM];
    for (int i = threadIdx.x; i < Q * NVPC; i += THREADS) sN[i] = N2[i];
    for (int i = threadIdx.x; i < Q * NVPC * DIM; i += THREADS)
        sdN[i] = dN2[i];
    __syncthreads();

    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= nc) {
        // one row (f, a) of a facet block: ffe[f,a] = fac_elem[f,a,:] . u
        if (FUSED) {
            const int r = t - nc;
            if (r < nfac * ND) {
                const T* row = fac_elem + static_cast<size_t>(r) * ND;
                const int* ids = fac_vd + (r / ND) * ND;
                T acc = T(0);
                for (int b = 0; b < ND; ++b) {
                    const int id = ids[b];
                    const T x = in_range(id, nv_full)
                                    ? static_cast<T>(u1[id]) : T(0);
                    acc += row[b] * x;
                }
                scratch[static_cast<size_t>(2) * nc * ND + r] = acc;
            }
        }
        return;
    }

    const int e = t;
    const int* ids = vd + static_cast<size_t>(e) * ND;
    T ue[ND], u2e[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
        const int id = ids[j];
        const bool in = in_range(id, nv_full);
        ue[j] = in ? static_cast<T>(u1[id]) : T(0);
        u2e[j] = (u2 == nullptr) ? ue[j]
                                 : (in ? static_cast<T>(u2[id]) : T(0));
    }
    T Ji[DIM][DIM];                               // Ji[d][k] = JinvT[e,d,k]
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
        for (int k = 0; k < DIM; ++k)
            Ji[d][k] = JinvT[(static_cast<size_t>(e) * DIM + d) * DIM + k];

    T fc[ND], fa[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) { fc[j] = T(0); fa[j] = T(0); }

#pragma unroll 1
    for (int q = 0; q < Q; ++q) {
        const T* Nq = sN + q * NVPC;
        const T* dNq = sdN + q * NVPC * DIM;
        T uq[DIM], rg[DIM][DIM];                  // rg[k][c]
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            uq[c] = T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k) rg[k][c] = T(0);
        }
#pragma unroll
        for (int a = 0; a < NVPC; ++a) {
            const T Na = Nq[a];
#pragma unroll
            for (int c = 0; c < DIM; ++c) uq[c] += Na * u2e[a * DIM + c];
#pragma unroll
            for (int k = 0; k < DIM; ++k) {
                const T dNa = dNq[a * DIM + k];
#pragma unroll
                for (int c = 0; c < DIM; ++c)
                    rg[k][c] += dNa * ue[a * DIM + c];
            }
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
        const T w = wdet[static_cast<size_t>(e) * Q + q];
        T wc[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = T(0);
#pragma unroll
            for (int d = 0; d < DIM; ++d) s += uq[d] * guq[c][d];
            wc[c] = w * s;
        }
#pragma unroll
        for (int a = 0; a < NVPC; ++a)
#pragma unroll
            for (int c = 0; c < DIM; ++c) fc[a * DIM + c] += Nq[a] * wc[c];

        if (FUSED) {
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
                for (int k = 0; k < DIM; ++k) {
                    const T dNa = dNq[a * DIM + k];
#pragma unroll
                    for (int c = 0; c < DIM; ++c)
                        fa[a * DIM + c] += dNa * G[k][c];
                }
        }
    }

    T* oc = scratch + static_cast<size_t>(e) * ND;
#pragma unroll
    for (int j = 0; j < ND; ++j) oc[j] = fc[j];
    if (FUSED) {
        T* oa = scratch + (static_cast<size_t>(nc) + e) * ND;
#pragma unroll
        for (int j = 0; j < ND; ++j) oa[j] = fa[j];
    }
}

// conv[i] = sum of scratch[slots[k]], av[i] = sum of scratch[nslot +
// slots[k]] then of scratch[2 nslot + fslots[k]], k ascending: one thread per
// dof, a fixed order, no atomics.
template <typename T, typename TU, bool FUSED>
__global__ void conv_reduce_kernel(const T* __restrict__ scratch,
                                   const int* __restrict__ rowptr,
                                   const int* __restrict__ slots,
                                   const int* __restrict__ frowptr,
                                   const int* __restrict__ fslots,
                                   int nv_full, size_t nslot,
                                   TU* __restrict__ out_c,
                                   TU* __restrict__ out_a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nv_full) return;
    T c = T(0), a = T(0);
    const int k1 = rowptr[i + 1];
    for (int k = rowptr[i]; k < k1; ++k) {
        const int s = slots[k];
        c += scratch[s];
        if (FUSED) a += scratch[nslot + s];
    }
    out_c[i] = static_cast<TU>(c);
    if (FUSED) {
        if (frowptr != nullptr) {
            const int f1 = frowptr[i + 1];
            for (int k = frowptr[i]; k < f1; ++k)
                a += scratch[2 * nslot + fslots[k]];
        }
        out_a[i] = static_cast<TU>(a);
    }
}

struct Args {
    const void *u1, *u2;
    const int* vd;
    const void *JinvT, *wdet, *N2, *dN2;
    int nc, nv_full;
    double nu;
    int sym;
    const void* fac_elem;
    const int* fac_vd;
    int nfac;
    void* scratch;
    const int *rowptr, *slots, *frowptr, *fslots;
    void *out_c, *out_a;
    cudaStream_t stream;
};

template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
cudaError_t launch(const Args& p) {
    constexpr int ND = NVPC * DIM;
    const long long rows =
        static_cast<long long>(p.nc) +
        (FUSED ? static_cast<long long>(p.nfac) * ND : 0);
    const int blocks = static_cast<int>((rows + THREADS - 1) / THREADS);
    conv_element_kernel<T, TU, NVPC, Q, DIM, FUSED>
        <<<blocks, THREADS, 0, p.stream>>>(
            static_cast<const TU*>(p.u1), static_cast<const TU*>(p.u2), p.vd,
            static_cast<const T*>(p.JinvT), static_cast<const T*>(p.wdet),
            static_cast<const T*>(p.N2), static_cast<const T*>(p.dN2), p.nc,
            p.nv_full, static_cast<T>(p.nu), p.sym,
            static_cast<const T*>(p.fac_elem), p.fac_vd, p.nfac,
            static_cast<T*>(p.scratch));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    conv_reduce_kernel<T, TU, FUSED>
        <<<(p.nv_full + 127) / 128, 128, 0, p.stream>>>(
            static_cast<const T*>(p.scratch), p.rowptr, p.slots, p.frowptr,
            p.fslots, p.nv_full, static_cast<size_t>(p.nc) * ND,
            static_cast<TU*>(p.out_c), static_cast<TU*>(p.out_a));
    return cudaGetLastError();
}

template <typename T, typename TU, int NVPC, int Q, int DIM>
cudaError_t launch_form(const Args& p, int fused) {
    return fused ? launch<T, TU, NVPC, Q, DIM, true>(p)
                 : launch<T, TU, NVPC, Q, DIM, false>(p);
}

}  // namespace

extern "C" {

// The 2D Taylor-Hood instantiation (NVPC 6, Q 7, DIM 2).
//   work_f64 / u_f64: element type of the tables+scratch / of u and outputs
//   fused: 0 -> conv only (u2 may be null: u2 = u1), 1 -> conv and A u
//   vd (nc, 12) int32; JinvT (nc, 2, 2), wdet (nc, 7), N2 (7, 6),
//   dN2 (7, 6, 2), fac_elem (nfac, 12, 12) in the work type;
//   fac_vd (nfac, 12) int32; scratch ((1 + fused) nc 12 + nfac 12) work type;
//   rowptr (nv_full + 1), slots: CSR of dof -> scratch slots < nc*12;
//   frowptr, fslots: the same for the facet slots (null when nfac == 0);
//   out_c, out_a (nv_full) in u's type (out_a unused when not fused).
// Returns the cudaError_t of the launches (0 = success).
int convection_th2d(int work_f64, int u_f64, int fused, const void* u1,
                    const void* u2, const int* vd, const void* JinvT,
                    const void* wdet, const void* N2, const void* dN2, int nc,
                    int nv_full, double nu, int sym, const void* fac_elem,
                    const int* fac_vd, int nfac, void* scratch,
                    const int* rowptr, const int* slots, const int* frowptr,
                    const int* fslots, void* out_c, void* out_a,
                    void* stream) {
    if (nc <= 0 || nv_full <= 0 || nfac < 0 || (nfac > 0 && !fused) ||
        (nfac > 0 && (fac_elem == nullptr || fac_vd == nullptr ||
                      frowptr == nullptr || fslots == nullptr)) ||
        static_cast<long long>(nc) * 12 * 2 +
                static_cast<long long>(nfac) * 12 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    Args p{u1, u2, vd, JinvT, wdet, N2, dN2, nc, nv_full, nu, sym, fac_elem,
           fac_vd, nfac, scratch, rowptr, slots,
           nfac > 0 ? frowptr : nullptr, nfac > 0 ? fslots : nullptr, out_c,
           out_a, static_cast<cudaStream_t>(stream)};
    cudaError_t err;
    if (work_f64)
        err = u_f64 ? launch_form<double, double, 6, 7, 2>(p, fused)
                    : launch_form<double, float, 6, 7, 2>(p, fused);
    else
        err = u_f64 ? launch_form<float, double, 6, 7, 2>(p, fused)
                    : launch_form<float, float, 6, 7, 2>(p, fused);
    return static_cast<int>(err);
}

const char* convection_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
