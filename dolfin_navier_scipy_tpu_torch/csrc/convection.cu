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
// conv_kernel is written over NVPC, Q, DIM as compile-time parameters
// (Q <= 8) and built for 2D Taylor-Hood (6, 7, 2); the 3D Taylor-Hood form
// (10, 125, 3) is conv_block_kernel (a block an element, a thread a point;
// see there).
//
// tail_kernel (conv_tail_th2d) is the banded convection tail's vector,
// c = S @ quad(G @ v[:nin] + ue_bc) of BandedConvTail.vector
// (dolfin_navier_scipy_tpu/ops/banded_conv.py:154-171, XLA there: two
// banded 0/1 products around the quadrature), in one launch with
// conv_kernel's structure and the bits of the three-launch form it
// replaces (int8 0/1 bands through bandmv.cu and a quadrature kernel):
//   * phase 1, conv_kernel's (element_loads) over the elements in the
//     tail's sorted order: G has one 1 in each kept row, so G's product is
//     the state at the element's interior ids rounded to f32 (0 at bc ids),
//     plus the constant bc field ue_bc, as the band product's exact adds of
//     1 x v and of zeros left it; then point_conv and the fixed butterfly,
//     loads to scratch.
//   * the grid barrier.
//   * phase 2, a thread an interior row r, in the order the int8 S product
//     summed it: the row's element-load slots p sat at window column j = p -
//     Sbases[r / 256], read by lane (j / 16) % 32 of the row's warp; each
//     lane added its entries in ascending j from 0.f, and a xor butterfly
//     (16, 8, 4, 2, 1) joined the lanes, read at lane 0.  A lane with no
//     entry gives an exact +0, so the sum is that tree over the lanes that
//     have entries.  The host table (ops/kernels.py: tail_slot_table) lists
//     a row's slots by the lane's 5-bit reversal (the butterfly's leaf
//     order), then j, each with a code: 7 continues the lane's chain, 0-4
//     starts a new lane and names the highest bit in which its leaf
//     position differs from the last one's (how late the tree joins them).
//     A thread evaluates the tree as an operator-precedence parse: pending
//     left operands by level in registers, joined in ascending level when a
//     higher separator comes, the rest at the end.  No floating-point
//     atomics; f32 work, the state f32 or f64.
// Bound: the function moves ~2 MB at wake level 2 (the tables, the state,
// the element loads written and read once), under a microsecond at the
// memory rate; like conv_kernel it is bound by the launch, the grid
// barrier and two dependent loads a phase.
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

// One quadrature point's fields (the lane's point q; N, dN its rows of N2
// and dN2): uq = N u2e, rg[k][c] = dN[.][k] ue[.][c], guq[c][d] = dU_c/dx_d
// = Ji[d][.] rg[.][c].
template <typename T, int NVPC, int DIM>
__device__ __forceinline__ void point_fields(const T (&N)[NVPC],
                                             const T (&dN)[NVPC][DIM],
                                             const T* ue, const T* u2e,
                                             const T (&Ji)[DIM][DIM],
                                             T (&uq)[DIM],
                                             T (&guq)[DIM][DIM]) {
    T rg[DIM][DIM];                               // rg[k][c]
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
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            T s = T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k) s += Ji[d][k] * rg[k][c];
            guq[c][d] = s;
        }
}

// One quadrature point's share of an element's convection load (w the
// point's weight, zero for an idle lane): the fields of point_fields and
// fc[a*DIM + c] = N[a] w (u2q . grad) U_c.
template <typename T, int NVPC, int DIM>
__device__ __forceinline__ void point_conv(const T (&N)[NVPC],
                                           const T (&dN)[NVPC][DIM],
                                           const T* ue, const T* u2e,
                                           const T (&Ji)[DIM][DIM], T w,
                                           T (&guq)[DIM][DIM], T* fc) {
    T uq[DIM];
    point_fields<T, NVPC, DIM>(N, dN, ue, u2e, Ji, uq, guq);
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
        for (int c = 0; c < DIM; ++c) fc[a * DIM + c] = N[a] * wc[c];
}

// One quadrature point's share of an element's stiffness load of the
// gradient guq: F = guq (+ guq^T with sym), G[k][c] = nuw sum_d Ji[d][k]
// F[c][d], fa[a*DIM + c] = sum_k dN[a][k] G[k][c].  The element matrix
// this applies is symmetric in both forms, so the chain is also its
// transpose.
template <typename T, int NVPC, int DIM>
__device__ __forceinline__ void point_stiff(const T (&dN)[NVPC][DIM],
                                            const T (&Ji)[DIM][DIM],
                                            const T (&guq)[DIM][DIM], T nuw,
                                            int sym, T* fa) {
    T G[DIM][DIM];                                // G[k][c]
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

// this lane's point's rows of N2 and dN2 (zeros for an idle lane)
template <typename T, int NVPC, int DIM>
__device__ __forceinline__ void point_tables(const T* N2, const T* dN2,
                                             int q, bool point,
                                             T (&N)[NVPC],
                                             T (&dN)[NVPC][DIM]) {
#pragma unroll
    for (int a = 0; a < NVPC; ++a) {
        N[a] = point ? N2[q * NVPC + a] : T(0);
#pragma unroll
        for (int k = 0; k < DIM; ++k)
            dN[a][k] = point ? dN2[(q * NVPC + a) * DIM + k] : T(0);
    }
}

// The facet-block rows: ffe[f,a] = fac_elem[f,a,:] . u, one thread each,
// counted from the grid's last thread (the last block holds the fewest
// elements; the first would do them after a full element group).
template <typename T, typename TU, int ND>
__device__ __forceinline__ void facet_rows(const ConvPlan& p,
                                           const TU* __restrict__ u1,
                                           long long tid, long long nthreads,
                                           size_t nslot) {
    const T* fac_elem = static_cast<const T*>(p.fac_elem);
    T* scratch = static_cast<T*>(p.scratch);
    const int nv_full = p.nv_full;
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

// Phase 2 of the forward kernels: per dof, its slots in the fixed order;
// the slot indices of a batch first (element slots and the first facet
// slots together), then their values, then the sums in order: two
// dependent loads deep while a dof has at most BATCH element slots.
template <typename T, typename TU, bool FUSED>
__device__ __forceinline__ void reduce_dofs(const ConvPlan& p,
                                            TU* __restrict__ out_c,
                                            TU* __restrict__ out_a,
                                            long long tid,
                                            long long nthreads,
                                            size_t nslot) {
    const T* scratch = static_cast<const T*>(p.scratch);
    const int nv_full = p.nv_full;
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
}

// Phase 1 of conv_kernel and tail_kernel: the elements, 8 lanes each (see
// the file's head), grid-stride; the element loads (fused: and the
// stiffness loads) go to scratch.  ebc, where given (the tail's constant
// bc field, (nc, ND), with u2 null), is added to the gathered state: G's
// product + ue_bc.
template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
__device__ __forceinline__ void element_loads(
    const ConvPlan& p, const TU* __restrict__ u1, const TU* __restrict__ u2,
    const T* __restrict__ ebc, T nu, int sym, long long tid,
    long long nthreads, size_t nslot) {
    constexpr int ND = NVPC * DIM;
    static_assert(Q <= LANES && ND <= 2 * LANES, "one lane per point");
    const T* __restrict__ JinvT = static_cast<const T*>(p.JinvT);
    const T* __restrict__ wdet = static_cast<const T*>(p.wdet);
    T* scratch = static_cast<T*>(p.scratch);
    const int nc = p.nc, nv_full = p.nv_full;
    const int lane = threadIdx.x & 31;
    const int q = lane & (LANES - 1);
    const bool point = q < Q;
    T N[NVPC], dN[NVPC][DIM];
    point_tables<T, NVPC, DIM>(static_cast<const T*>(p.N2),
                               static_cast<const T*>(p.dN2), q, point, N,
                               dN);
    constexpr int PER_WARP = 32 / LANES;
    for (long long e0 = (tid >> 5) * PER_WARP; e0 < nc;
         e0 += (nthreads >> 5) * PER_WARP) {
        const long long e = e0 + (lane / LANES);
        const bool valid = e < nc;
        const int* ids = p.vd + e * ND;
        const int id0 = valid ? ids[q] : -1;
        const int id1 = (valid && q + LANES < ND) ? ids[q + LANES] : -1;
        T a0 = gather<T>(u1, id0, nv_full);
        T a1 = gather<T>(u1, id1, nv_full);
        if (ebc != nullptr) {
            if (valid) a0 = a0 + ebc[e * ND + q];
            if (valid && q + LANES < ND) a1 = a1 + ebc[e * ND + q + LANES];
        }
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
        T guq[DIM][DIM], fc[ND];
        point_conv<T, NVPC, DIM>(N, dN, ue, u2e, Ji, w, guq, fc);
        T fa[FUSED ? ND : 1];
        if constexpr (FUSED)
            point_stiff<T, NVPC, DIM>(dN, Ji, guq, nu * w, sym, fa);
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
}

template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const ConvPlan p, const TU* __restrict__ u1,
            const TU* __restrict__ u2, TU* __restrict__ out_c,
            TU* __restrict__ out_a, T nu, int sym) {
    constexpr int ND = NVPC * DIM;
    const size_t nslot = static_cast<size_t>(p.nc) * ND;
    const long long tid =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;

    stamp(p, 0);
    element_loads<T, TU, NVPC, Q, DIM, FUSED>(p, u1, u2, nullptr, nu, sym,
                                              tid, nthreads, nslot);
    if (FUSED) facet_rows<T, TU, ND>(p, u1, tid, nthreads, nslot);

    stamp(p, 1);
    grid_barrier(p.bar);
    stamp(p, 2);

    reduce_dofs<T, TU, FUSED>(p, out_c, out_a, tid, nthreads, nslot);
    stamp(p, 3);
}

// The 3D Taylor-Hood form (NVPC 10, Q 125, DIM 3: the collapsed degree-5
// tet rule): 8 lanes cannot hold 125 points, so a block of 128 threads
// takes one element at a time (grid-stride over the elements), thread q its
// point q (125 active).  The element's 30 dof values (and u2's) and its
// JinvT go to shared memory; each point's thread keeps its rows of N2 and
// dN2 in registers, computes its fields (point_fields), and stores the
// point's load factors: wc[c] = w (u2q . grad) U_c and, fused, the
// stiffness factors G[k][c] of point_stiff, 3 + 9 values a point.  Then
// thread j < 30 forms the convection load of element dof j = (a, c) as
// sum_q N2[q,a] wc[q][c], and thread 32 + j the stiffness load sum_q sum_k
// dN2[q,a,k] G[q][k][c], q ascending: a fixed order, no atomics.  The
// facet rows, the grid barrier and the per-dof sums are conv_kernel's.
// Bound: operations (about 1.1e5 an element), not bytes: at 3D-2Z nz=8
// (14 208 elements) about 1.6 GFLOP a call, 24 us at the f32 rate without
// tensor cores.
template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
conv_block_kernel(const ConvPlan p, const TU* __restrict__ u1,
                  const TU* __restrict__ u2, TU* __restrict__ out_c,
                  TU* __restrict__ out_a, T nu, int sym) {
    constexpr int ND = NVPC * DIM;
    static_assert(Q <= THREADS && ND <= 32, "a thread a point, a dof");
    __shared__ T sue[ND], su2e[ND], sJi[DIM * DIM];
    __shared__ T swc[THREADS][DIM];
    __shared__ T sG[FUSED ? THREADS : 1][DIM * DIM];
    const T* __restrict__ JinvT = static_cast<const T*>(p.JinvT);
    const T* __restrict__ wdet = static_cast<const T*>(p.wdet);
    const T* __restrict__ N2 = static_cast<const T*>(p.N2);
    const T* __restrict__ dN2 = static_cast<const T*>(p.dN2);
    T* scratch = static_cast<T*>(p.scratch);
    const int nc = p.nc, nv_full = p.nv_full;
    const size_t nslot = static_cast<size_t>(nc) * ND;
    const int t = threadIdx.x;
    const long long tid = static_cast<long long>(blockIdx.x) * THREADS + t;
    const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;
    const bool point = t < Q;
    T N[NVPC], dN[NVPC][DIM];
    point_tables<T, NVPC, DIM>(N2, dN2, t, point, N, dN);

    stamp(p, 0);
    for (long long e = blockIdx.x; e < nc; e += gridDim.x) {
        if (t < ND) {
            const int id = p.vd[e * ND + t];
            sue[t] = gather<T>(u1, id, nv_full);
            su2e[t] = u2 != nullptr ? gather<T>(u2, id, nv_full) : sue[t];
        } else if (t >= 32 && t < 32 + DIM * DIM) {
            sJi[t - 32] = JinvT[e * DIM * DIM + (t - 32)];
        }
        __syncthreads();
        if (point) {
            T Ji[DIM][DIM], uq[DIM], guq[DIM][DIM];
#pragma unroll
            for (int d = 0; d < DIM; ++d)
#pragma unroll
                for (int k = 0; k < DIM; ++k) Ji[d][k] = sJi[d * DIM + k];
            point_fields<T, NVPC, DIM>(N, dN, sue, su2e, Ji, uq, guq);
            const T w = wdet[e * Q + t];
#pragma unroll
            for (int c = 0; c < DIM; ++c) {
                T s = T(0);
#pragma unroll
                for (int d = 0; d < DIM; ++d) s += uq[d] * guq[c][d];
                swc[t][c] = w * s;
            }
            if constexpr (FUSED) {
                const T nuw = nu * w;
#pragma unroll
                for (int k = 0; k < DIM; ++k)
#pragma unroll
                    for (int c = 0; c < DIM; ++c) {
                        T s = T(0);
#pragma unroll
                        for (int d = 0; d < DIM; ++d) {
                            const T F = sym ? guq[c][d] + guq[d][c]
                                            : guq[c][d];
                            s += Ji[d][k] * F;
                        }
                        sG[t][k * DIM + c] = nuw * s;
                    }
            }
        }
        __syncthreads();
        if (t < ND) {
            const int a = t / DIM, c = t % DIM;
            T s = T(0);
            for (int q = 0; q < Q; ++q) s += N2[q * NVPC + a] * swc[q][c];
            scratch[e * ND + t] = s;
        } else if (FUSED && t >= 32 && t < 32 + ND) {
            const int j = t - 32, a = j / DIM, c = j % DIM;
            T s = T(0);
            for (int q = 0; q < Q; ++q)
#pragma unroll
                for (int k = 0; k < DIM; ++k)
                    s += dN2[(q * NVPC + a) * DIM + k] * sG[q][k * DIM + c];
            scratch[nslot + e * ND + j] = s;
        }
        __syncthreads();
    }
    if (FUSED) facet_rows<T, TU, ND>(p, u1, tid, nthreads, nslot);

    stamp(p, 1);
    grid_barrier(p.bar);
    stamp(p, 2);
    reduce_dofs<T, TU, FUSED>(p, out_c, out_a, tid, nthreads, nslot);
    stamp(p, 3);
}

// The VJP in u of conv_kernel's fused outputs (conv, A u) for the
// cotangents gc (of conv) and ga (of A u; null: the VJP of conv_vector(u,
// u) alone): per element, with g_q = w sum_a N[a] gce[a] the cotangent at
// the point and grad phi_b = Ji dN[b],
//
//   out[b,d] = sum_q N[b] ((grad u_q)^T g_q)[d] + (u_q . grad phi_b) g_q[d]
//            + (the stiffness chain point_stiff applied to gae: the element
//               stiffness is symmetric, so that is its transpose)
//
// and per facet-block row (f, b): sum_a fac_elem[f,a,b] ga[fac_vd[f,a]],
// the blocks applied transposed (nothing assumes them symmetric).  Then per
// dof the sum of its element slots and then its facet slots, through the
// forward's tables (ell, fell).  B5's layout and order throughout: a group
// of 8 lanes an element, lane q the point q, the fixed xor butterfly over
// the points, a grid barrier, the dof-major slot sums; the point's fields
// come from the forward's point_fields.  No floating-point atomics.  The
// plan is the forward's structure with fused = 2: scratch of nc*ND element
// slots then nfac*ND facet slots.
//
// Bound: as the forward, launch latency and one point's dependent chain at
// the dense path's mesh sizes (reads: u, two cotangents, the tables).
template <typename T, typename TU, int NVPC, int Q, int DIM>
__global__ void __launch_bounds__(THREADS)
vjp_kernel(const ConvPlan p, const TU* __restrict__ u,
           const TU* __restrict__ gc, const TU* __restrict__ ga,
           TU* __restrict__ out, T nu, int sym) {
    constexpr int ND = NVPC * DIM;
    static_assert(Q <= LANES && ND <= 2 * LANES, "one lane per point");
    const T* __restrict__ JinvT = static_cast<const T*>(p.JinvT);
    const T* __restrict__ wdet = static_cast<const T*>(p.wdet);
    T* scratch = static_cast<T*>(p.scratch);
    const int nc = p.nc, nv_full = p.nv_full;
    const size_t nslot = static_cast<size_t>(nc) * ND;
    const bool stiff = ga != nullptr;
    const long long nfrows =
        stiff ? static_cast<long long>(p.nfac) * ND : 0;
    const long long tid =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;

    stamp(p, 0);
    const int lane = threadIdx.x & 31;
    const int q = lane & (LANES - 1);
    const bool point = q < Q;
    T N[NVPC], dN[NVPC][DIM];
    point_tables<T, NVPC, DIM>(static_cast<const T*>(p.N2),
                               static_cast<const T*>(p.dN2), q, point, N,
                               dN);
    constexpr int PER_WARP = 32 / LANES;
    for (long long e0 = (tid >> 5) * PER_WARP; e0 < nc;
         e0 += (nthreads >> 5) * PER_WARP) {
        const long long e = e0 + (lane / LANES);
        const bool valid = e < nc;
        const int* ids = p.vd + e * ND;
        const int id0 = valid ? ids[q] : -1;
        const int id1 = (valid && q + LANES < ND) ? ids[q + LANES] : -1;
        const T a0 = gather<T>(u, id0, nv_full);
        const T a1 = gather<T>(u, id1, nv_full);
        const T c0 = gather<T>(gc, id0, nv_full);
        const T c1 = gather<T>(gc, id1, nv_full);
        T s0 = T(0), s1 = T(0);
        if (stiff) {
            s0 = gather<T>(ga, id0, nv_full);
            s1 = gather<T>(ga, id1, nv_full);
        }
        T ue[ND], gce[ND], gae[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            ue[j] = __shfl_sync(FULL, j < LANES ? a0 : a1, j % LANES, LANES);
            gce[j] = __shfl_sync(FULL, j < LANES ? c0 : c1, j % LANES,
                                 LANES);
            gae[j] = __shfl_sync(FULL, j < LANES ? s0 : s1, j % LANES,
                                 LANES);
        }
        T Ji[DIM][DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                Ji[d][k] = valid ? JinvT[(e * DIM + d) * DIM + k] : T(0);
        const T w = (valid && point) ? wdet[e * Q + q] : T(0);

        T uq[DIM], guq[DIM][DIM];
        point_fields<T, NVPC, DIM>(N, dN, ue, ue, Ji, uq, guq);
        // the cotangent at the point, and (grad u_q)^T g_q
        T gq[DIM], gt[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = T(0);
#pragma unroll
            for (int a = 0; a < NVPC; ++a) s += N[a] * gce[a * DIM + c];
            gq[c] = w * s;
        }
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            T s = T(0);
#pragma unroll
            for (int c = 0; c < DIM; ++c) s += gq[c] * guq[c][d];
            gt[d] = s;
        }
        T fb[ND];
#pragma unroll
        for (int b = 0; b < NVPC; ++b) {
            T ug = T(0);                          // u_q . grad phi_b
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
                T gphi = T(0);
#pragma unroll
                for (int k = 0; k < DIM; ++k) gphi += Ji[d][k] * dN[b][k];
                ug += uq[d] * gphi;
            }
#pragma unroll
            for (int c = 0; c < DIM; ++c)
                fb[b * DIM + c] = N[b] * gt[c] + ug * gq[c];
        }
        if (stiff) {
            T gaq[DIM], gga[DIM][DIM], fa[ND];
            point_fields<T, NVPC, DIM>(N, dN, gae, gae, Ji, gaq, gga);
            point_stiff<T, NVPC, DIM>(dN, Ji, gga, nu * w, sym, fa);
#pragma unroll
            for (int j = 0; j < ND; ++j) fb[j] += fa[j];
        }
#pragma unroll
        for (int off = LANES / 2; off > 0; off /= 2)
#pragma unroll
            for (int j = 0; j < ND; ++j)
                fb[j] += __shfl_xor_sync(FULL, fb[j], off, LANES);
        if (valid) {
            T v0 = T(0), v1 = T(0);
#pragma unroll
            for (int j = 0; j < ND; ++j) {
                if (j == q) v0 = fb[j];
                if (j == q + LANES) v1 = fb[j];
            }
            T* o = scratch + e * ND;
            o[q] = v0;
            if (q + LANES < ND) o[q + LANES] = v1;
        }
    }
    // the facet-block rows transposed: slot (f, b) = column b of block f
    // against ga at the block's dofs
    {
        const T* fac_elem = static_cast<const T*>(p.fac_elem);
        for (long long r = nthreads - 1 - tid; r < nfrows; r += nthreads) {
            const long long f = r / ND;
            const int b = static_cast<int>(r % ND);
            const T* blk = fac_elem + f * ND * ND;
            const int* fids = p.fac_vd + f * ND;
            T acc = T(0);
#pragma unroll
            for (int a = 0; a < ND; ++a)
                acc += blk[a * ND + b] * gather<T>(ga, fids[a], nv_full);
            scratch[nslot + r] = acc;
        }
    }

    stamp(p, 1);
    grid_barrier(p.bar);
    stamp(p, 2);

    // per dof: its element slots in the fixed order, then its facet slots
    for (long long i = tid; i < nv_full; i += nthreads) {
        T acc = T(0);
        for (int k0 = 0; k0 < p.width; k0 += BATCH) {
            int s[BATCH];
            T v[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                s[u] = k0 + u < p.width
                           ? p.ell[static_cast<size_t>(k0 + u) * nv_full + i]
                           : -1;
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                v[u] = s[u] >= 0 ? __ldcg(scratch + s[u]) : T(0);
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                if (s[u] >= 0) acc += v[u];
        }
        if (nfrows > 0)
            for (int k = 0; k < p.fwidth; ++k) {
                const int sl = p.fell[static_cast<size_t>(k) * nv_full + i];
                if (sl >= 0) acc += __ldcg(scratch + nslot + sl);
            }
        out[i] = static_cast<TU>(acc);
    }
    stamp(p, 3);
}

// Launch a kernel that meets at grid_barrier: enough blocks for `work`
// threads, but never more than can be resident at once (occ blocks an SM,
// queried once per instantiation: a host query costs more than the
// launch), with the cooperative attribute, which makes the driver refuse a
// grid that cannot be.
template <typename... Params, typename... Args>
cudaError_t launch_resident(void (*kern)(Params...), int& occ, int& sms,
                            long long work, cudaStream_t st,
                            Args... args) {
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
    long long blocks = (work + THREADS - 1) / THREADS;
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
    err = cudaLaunchKernelEx(&cfg, kern, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// the threads a launch needs: 8 lanes an element, a facet-block row each
// (nfrows), a dof each
__host__ long long conv_work(const ConvPlan& p, long long nfrows) {
    const long long lanes = static_cast<long long>(p.nc) * LANES;
    long long work = lanes > nfrows ? lanes : nfrows;
    if (p.nv_full > work) work = p.nv_full;
    return work;
}

template <typename T, typename TU, int NVPC, int Q, int DIM, bool FUSED>
cudaError_t launch(const ConvPlan& p, const void* u1, const void* u2,
                   void* out_c, void* out_a, double nu, int sym,
                   cudaStream_t st) {
    constexpr int ND = NVPC * DIM;
    static int occ = 0, sms = 0;
    return launch_resident(
        conv_kernel<T, TU, NVPC, Q, DIM, FUSED>, occ, sms,
        conv_work(p, FUSED ? static_cast<long long>(p.nfac) * ND : 0), st,
        p, static_cast<const TU*>(u1), static_cast<const TU*>(u2),
        static_cast<TU*>(out_c), static_cast<TU*>(out_a),
        static_cast<T>(nu), sym);
}

template <typename T, typename TU>
cudaError_t launch_vjp(const ConvPlan& p, const void* u, const void* gc,
                       const void* ga, void* out, double nu, int sym,
                       cudaStream_t st) {
    constexpr int ND = 12;
    static int occ = 0, sms = 0;
    return launch_resident(
        vjp_kernel<T, TU, 6, 7, 2>, occ, sms,
        conv_work(p, ga != nullptr ? static_cast<long long>(p.nfac) * ND
                                   : 0),
        st, p, static_cast<const TU*>(u), static_cast<const TU*>(gc),
        static_cast<const TU*>(ga), static_cast<TU*>(out),
        static_cast<T>(nu), sym);
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

template <typename T, typename TU, bool FUSED>
cudaError_t launch_3d(const ConvPlan& p, const void* u1, const void* u2,
                      void* out_c, void* out_a, double nu, int sym,
                      cudaStream_t st) {
    constexpr int ND = 30;
    static int occ = 0, sms = 0;
    long long work = static_cast<long long>(p.nc) * THREADS;
    const long long rest = conv_work(p, FUSED ? static_cast<long long>(
                                                    p.nfac) * ND : 0);
    if (rest > work) work = rest;
    return launch_resident(
        conv_block_kernel<T, TU, 10, 125, 3, FUSED>, occ, sms, work, st, p,
        static_cast<const TU*>(u1), static_cast<const TU*>(u2),
        static_cast<TU*>(out_c), static_cast<TU*>(out_a),
        static_cast<T>(nu), sym);
}

template <typename T, typename TU>
cudaError_t launch_form_3d(const ConvPlan& p, const void* u1, const void* u2,
                           void* out_c, void* out_a, double nu, int sym,
                           cudaStream_t st) {
    return p.fused ? launch_3d<T, TU, true>(p, u1, u2, out_c, out_a, nu, sym,
                                            st)
                   : launch_3d<T, TU, false>(p, u1, u2, out_c, out_a, nu,
                                             sym, st);
}

// Phase 2 of tail_kernel: interior row i's slots (ell[k][i], nv_full =
// nin rows), each (p << 3) | code, -1 past the row's count; the tree of the
// int8 S product's warp (see the file's head).
__device__ __forceinline__ float tail_row(const ConvPlan& p,
                                          const float* scratch, int i) {
    constexpr int LEVELS = 5;
    float cur = 0.f, pend[LEVELS];
    int has = 0;
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) pend[l] = 0.f;
    for (int k0 = 0; k0 < p.width; k0 += BATCH) {
        int s[BATCH];
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            s[u] = k0 + u < p.width
                       ? p.ell[static_cast<size_t>(k0 + u) * p.nv_full + i]
                       : -1;
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            v[u] = s[u] >= 0 ? __ldcg(scratch + (s[u] >> 3)) : 0.f;
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            if (s[u] < 0) continue;
            const int code = s[u] & 7;
            if (code == 7) {
                cur = cur + v[u];
                continue;
            }
            // a new lane: join the pending operands that bind tighter
#pragma unroll
            for (int l = 0; l < LEVELS; ++l)
                if (l < code && ((has >> l) & 1)) {
                    cur = pend[l] + cur;
                    has &= ~(1 << l);
                }
#pragma unroll
            for (int l = 0; l < LEVELS; ++l)
                if (l == code) pend[l] = cur;
            has |= 1 << code;
            cur = 0.f + v[u];
        }
    }
#pragma unroll
    for (int l = 0; l < LEVELS; ++l)
        if ((has >> l) & 1) cur = pend[l] + cur;
    return cur;
}

// The banded convection tail's vector in one launch (see the file's head):
// p.vd the tail's sorted element ids (w-space), p.nv_full = nin (ids at or
// above it read 0), p.ell the tail's slot table, scratch nc*ND f32.
template <typename TU, int NVPC, int Q, int DIM>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const ConvPlan p, const TU* __restrict__ u,
            const float* __restrict__ uebc, float* __restrict__ out) {
    constexpr int ND = NVPC * DIM;
    float* scratch = static_cast<float*>(p.scratch);
    const int nin = p.nv_full;
    const long long tid =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;

    stamp(p, 0);
    element_loads<float, TU, NVPC, Q, DIM, false>(
        p, u, nullptr, uebc, 0.f, 0, tid, nthreads,
        static_cast<size_t>(p.nc) * ND);

    stamp(p, 1);
    grid_barrier(p.bar);
    stamp(p, 2);

    for (long long i = tid; i < nin; i += nthreads)
        out[i] = tail_row(p, scratch, static_cast<int>(i));
    stamp(p, 3);
}

template <typename TU>
cudaError_t launch_tail(const ConvPlan& p, const void* u, const void* uebc,
                        void* out, cudaStream_t st) {
    static int occ = 0, sms = 0;
    return launch_resident(tail_kernel<TU, 6, 7, 2>, occ, sms,
                           conv_work(p, 0), st, p,
                           static_cast<const TU*>(u),
                           static_cast<const float*>(uebc),
                           static_cast<float*>(out));
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
        p.fused < 0 || p.fused > 1 ||
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

// The 3D Taylor-Hood instantiation (NVPC 10, Q 125, DIM 3): the same plan
// and arguments as convection_th2d (ND 30), conv_block_kernel's layout.
int convection_th3d(const ConvPlan* plan, const void* u1, const void* u2,
                    void* out_c, void* out_a, double nu, int sym,
                    void* stream) {
    const ConvPlan& p = *plan;
    if (p.nc <= 0 || p.nv_full <= 0 || p.nfac < 0 || p.width <= 0 ||
        p.fused < 0 || p.fused > 1 ||
        (p.nfac > 0 && (!p.fused || p.fac_elem == nullptr ||
                        p.fac_vd == nullptr || p.fell == nullptr ||
                        p.fwidth <= 0)) ||
        p.bar == nullptr ||
        static_cast<long long>(p.nc) * 30 * 2 +
                static_cast<long long>(p.nfac) * 30 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.work_f64)
        err = p.u_f64 ? launch_form_3d<double, double>(p, u1, u2, out_c,
                                                       out_a, nu, sym, st)
                      : launch_form_3d<double, float>(p, u1, u2, out_c,
                                                      out_a, nu, sym, st);
    else
        err = p.u_f64 ? launch_form_3d<float, double>(p, u1, u2, out_c,
                                                      out_a, nu, sym, st)
                      : launch_form_3d<float, float>(p, u1, u2, out_c, out_a,
                                                     nu, sym, st);
    return static_cast<int>(err);
}

// The banded convection tail's vector, 2D Taylor-Hood (NVPC 6, Q 7, DIM 2),
// f32 work: plan with fused = 3, vd the tail's sorted element ids,
// nv_full = nin, ell its slot table (width, nin), scratch nc*12 floats, no
// facet blocks; u (at least nin) in the state's type (plan->u_f64), uebc
// (nc, 12) f32, out (nin) f32.  Returns the cudaError_t of the launch.
int conv_tail_th2d(const ConvPlan* plan, const void* u, const void* uebc,
                   void* out, void* stream) {
    const ConvPlan& p = *plan;
    if (p.nc <= 0 || p.nv_full <= 0 || p.width <= 0 || p.fused != 3 ||
        p.nfac != 0 || p.work_f64 != 0 || p.bar == nullptr ||
        u == nullptr || uebc == nullptr || out == nullptr ||
        static_cast<long long>(p.nc) * 12 * 8 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = p.u_f64 ? launch_tail<double>(p, u, uebc, out, st)
                                    : launch_tail<float>(p, u, uebc, out, st);
    return static_cast<int>(err);
}

// The VJP of convection_th2d's fused form in u (2D Taylor-Hood): plan with
// fused = 2 (scratch: nc*12 element slots, then nfac*12 facet slots); u,
// gc, ga (null: the VJP of the vector form, no stiffness, no facets) and
// out (nv_full) in u's type.  Returns the cudaError_t of the launch.
int conv_vjp_th2d(const ConvPlan* plan, const void* u, const void* gc,
                  const void* ga, void* out, double nu, int sym,
                  void* stream) {
    const ConvPlan& p = *plan;
    if (p.nc <= 0 || p.nv_full <= 0 || p.nfac < 0 || p.width <= 0 ||
        p.fused != 2 || u == nullptr || gc == nullptr || out == nullptr ||
        (p.nfac > 0 && (p.fac_elem == nullptr || p.fac_vd == nullptr ||
                        p.fell == nullptr || p.fwidth <= 0)) ||
        p.bar == nullptr ||
        static_cast<long long>(p.nc) * 12 +
                static_cast<long long>(p.nfac) * 12 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.work_f64)
        err = p.u_f64 ? launch_vjp<double, double>(p, u, gc, ga, out, nu,
                                                   sym, st)
                      : launch_vjp<double, float>(p, u, gc, ga, out, nu,
                                                  sym, st);
    else
        err = p.u_f64 ? launch_vjp<float, double>(p, u, gc, ga, out, nu,
                                                  sym, st)
                      : launch_vjp<float, float>(p, u, gc, ga, out, nu, sym,
                                                 st);
    return static_cast<int>(err);
}

const char* convection_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
