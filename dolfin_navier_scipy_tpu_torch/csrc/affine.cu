// The affine-geometry element matvecs of the Taylor-Hood Stokes family for
// Hopper (sm_90a): M x, A x, cm M x + ca A x, J x, J^T q, and the saddle
// residual [cm M v + ca A v + J^T q ; J v] of the dense solver's refinement
// round, each one launch of gather -> per-point quadrature -> fixed-order
// sum, with no grid-wide synchronisation.
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
//   mode RES: velocity dof i: (MA sum of i) + (JT sum of i), each cast to
//             the vector type before the add (what (K v) + (J^T q) adds);
//             pressure dof p: the J sum of p.
//
// and per output dof i, y[i] = the fe slots that point at i in the
// ascending order of the CSR table dof_slot_table (slot = e*NS + j), then
// its facet rows in ascending order.  Every sum over points is the same xor
// butterfly over 8 lanes, every multiply and add an explicit intrinsic (no
// contraction left to the compiler), so every partition of the elements
// and the fused residual give the same bits as one another.
//
// Replaces dolfin_navier_scipy_tpu_torch/ops/affine.py: AffineVectorOps, the
// twin of dolfin_navier_scipy_tpu/ops/affine.py, which the JAX package left
// to XLA (gather -> constant-weight matmuls -> 2x2 einsums -> segment_sum:
// ~7 tensor launches a matvec).
//
// Bound: at the wake's level-2 size (6678 elements, 25 966 inner dofs) a call
// reads ~0.4 MB and does ~4 MFLOP: neither bytes nor operations come near
// one launch's latency.  What a call waits for is its chain of dependent
// loads (each a trip to L2), the element arithmetic of one round of
// resident warps, and the launch itself.  The earlier design (element phase
// -> scratch -> cooperative grid barrier -> per-dof sum through an ELL
// table: six dependent trips and a grid-wide wait) took ~4-6 us on an H100.
// This design needs no grid-wide wait (ops/kernels.py: affine_plan sizes
// its chunks; a dof-owner form, one group of 8 lanes per output dof that
// recomputes each element term, was 1.6-4.2x slower and is not built):
//
//   elements in a locality order (RCM over shared dofs), cut into chunks;
//   each output dof belongs to the block of its first element in that order
//   (at most BLOCK_THREADS dofs a block: the plan splits larger ones), and
//   a block computes every element its dofs touch (its chunk and a halo,
//   ~2x the elements in all) into shared memory, 8 lanes an element (lane =
//   quadrature point, lane 7 idle with zero weights), its facet rows one a
//   thread on the threads the elements leave idle, then each thread sums
//   its owned dof's slots from shared memory through a block-local ELL
//   table that keeps the global order.  The plan stores each block's
//   elements padded and packed (ids: 12 velocity, 3 pressure; geometry:
//   JinvT, wdet, detJ) and its facet rows (ids, coefficients), so a call is
//   two dependent trips (ids, then values) before the arithmetic, one
//   __syncthreads, and the store; a dof's slot positions are loaded into
//   registers before the element phase (a partition with a dof of more
//   than MAX_SLOTS reads them all from its table after it).  The
//   point sums of 12 slots are a recursive halving over the 8 lanes (11
//   shuffles where 12 butterflies take 36), each sum with the butterfly's
//   pairs and bits.  The residual uses a joint partition: a block owns
//   velocity and pressure dofs, and each element's gather and gradient
//   serve its K, J^T and J terms at once.
//
// The vector may be f64 while the work type T is f32 (f64 carry, f32
// tables): the cast happens in the gather's load and the sum's store.
//
// block_body is written over NVPC, PN, Q, DIM as compile-time parameters
// (Q <= 8) and built for 2D Taylor-Hood (6, 3, 7, 2); the 3D Taylor-Hood
// form (10, 4, 125, 3) is block_body_3d (reference matrices, a block's
// work staged in shared memory first; see there), on the same partitions
// (never split: its threads loop over a block's dofs).  Plain C
// interface, loaded with ctypes; the caller allocates the output and checks
// the returned cudaError_t.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// A partition's tables for one kind of output dof (velocity: ND slots an
// element and the facet rows; pressure: PN slots), or for both (the
// residual's joint partition).  Must match ops/kernels.py: _AffinePartC
// field for field.
struct AffinePart {
    const int* cnt;         // (nblk, 4): elements, facet rows, first owned
                            // dof (index into own), owned dofs
    const int* ids;         // (nblk, emax, 16): 12 velocity ids, 3 pressure
                            // ids, -1 (padding rows all -1)
    const void* geo;        // (nblk, emax, 16) work type: JinvT (4), wdet
                            // (7), detJ, 0 (padding rows 0)
    const int* fids;        // (nblk, fmax, ND): a facet row's ids, or null
    const void* fco;        // (nblk, fmax, ND): its coefficients, or null
    const int* own;         // (n,): the owned dofs, block after block
    const int* lell;        // 2D (3D: null): (lwidth, nown): own[k]'s
                            // slots as positions in its block's shared
                            // memory (facet rows at
                            // [0, nf), element slot (l, j) at nf + l*ns + j;
                            // the residual's pressure slots past its two
                            // velocity value sets), element slots first,
                            // -1 past its count
    const int* sinfo;       // 3D (else null): (nblk, 2): the offset of the
                            // block's slot table in slots (ints, a multiple
                            // of 4) and its rows (the most slots of a dof
                            // of the block)
    const int* slots;       // 3D: each block's rows of lell over its dofs,
                            // row u of dof k at u * (owned dofs) + k
    int nblk, emax, fmax, lwidth;
    int nown;               // owned dofs in all (the residual's: nin + npc,
                            // pressure dof p owned as nin + p)
    int maxown;             // the most dofs a block owns (2D: at most
                            // BLOCK_THREADS; a 3D block's threads loop)
    int smax;               // 3D: the largest block's slot table (ints)
};

// The reference tables (ops/kernels.py: _AffinePlanC, field for field).
struct AffinePlan {
    const void* qw;         // (Q,) work type
    const void* N2;         // (Q, NVPC)
    const void* dN2;        // (Q, NVPC, DIM)
    const void* N1;         // (Q, PN)
    const void* ref;        // 3D only: the reference matrices Mref (NVPC,
                            // NVPC), Sref (DIM, DIM, NVPC, NVPC), Bref (PN,
                            // DIM, NVPC), in that order; null in 2D
    int nc, nin, npc, nfac;
    int work_f64;
};

// One call's constants (ops/kernels.py: _AffineCallC), made once per
// (mode, cm, ca, vector type) and kept by the plan.
struct AffineCall {
    double cm, ca, nu;
    int mode;               // 0 MA, 1 J, 2 JT, 3 RES
    int sym, facets, x_f64;
    AffinePart vb, pb;      // the velocity and pressure partitions of the
                            // mode's chunk (RES: vb the joint one)
};

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int MAX_SLOTS = 12;       // a dof's slots held in registers
constexpr int LANES = 8;            // lanes per element
constexpr int PACK = 16;            // ids and geometry an element
constexpr int SMEM_MAX = 232448;    // the most a block may take (sm_90)
constexpr unsigned FULL = 0xffffffffu;
constexpr int NVPC_ = 6, PN_ = 3, Q_ = 7, DIM_ = 2;

enum Mode { MODE_MA = 0, MODE_J = 1, MODE_JT = 2, MODE_RES = 3 };

__device__ __forceinline__ bool in_range(int id, int n) {
    return static_cast<unsigned>(id) < static_cast<unsigned>(n);
}

// explicit rounding: the same bits whatever the surrounding code
__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float fmad(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmad(double a, double b, double c) {
    return __fma_rn(a, b, c);
}

template <typename T, typename TU>
__device__ __forceinline__ T gather(const TU* x, int id, int n) {
    return in_range(id, n) ? static_cast<T>(x[id]) : T(0);
}

// The reference tables at this lane's quadrature point (zero on lane 7).
template <typename T, int NVPC, int PN, int Q, int DIM>
struct Point {
    T N[NVPC], dN[NVPC][DIM], P[PN], qw;
    bool on;

    __device__ __forceinline__ void load(const AffinePlan& p, int q) {
        on = q < Q;
        const T* N2 = static_cast<const T*>(p.N2);
        const T* dN2 = static_cast<const T*>(p.dN2);
        const T* N1 = static_cast<const T*>(p.N1);
#pragma unroll
        for (int a = 0; a < NVPC; ++a) {
            N[a] = on ? N2[q * NVPC + a] : T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                dN[a][k] = on ? dN2[(q * NVPC + a) * DIM + k] : T(0);
        }
#pragma unroll
        for (int r = 0; r < PN; ++r) P[r] = on ? N1[q * PN + r] : T(0);
        qw = on ? static_cast<const T*>(p.qw)[q] : T(0);
    }
};

// Element e's geometry at this lane's point.
template <typename T, int Q, int DIM>
struct Geo {
    T Ji[DIM][DIM];         // Ji[d][k] = JinvT[e,d,k]
    T w;                    // wdet[e,q]
    T dj;                   // detJ[e]

    // from a block's packed row (a padding row is all zeros)
    __device__ __forceinline__ void load(const T* g, int q, bool on) {
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
            for (int k = 0; k < DIM; ++k) Ji[d][k] = g[d * DIM + k];
        w = on ? g[DIM * DIM + q] : T(0);
        dj = g[DIM * DIM + Q];
    }
};

// All ND velocity values in every lane of the group: lane q loaded ids q and
// q + 8 (a0, a1); shuffles within the group.
template <typename T, int ND>
__device__ __forceinline__ void share_velocity(T a0, T a1, T (&xe)[ND]) {
    static_assert(ND <= 2 * LANES, "two loads a lane");
#pragma unroll
    for (int j = 0; j < ND; ++j)
        xe[j] = __shfl_sync(FULL, j < LANES ? a0 : a1, j % LANES, LANES);
}

// D[c][d] = d x_c / d x_d at the lane's point.
template <typename T, int NVPC, int PN, int Q, int DIM>
__device__ __forceinline__ void gradient(
    const Point<T, NVPC, PN, Q, DIM>& r, const Geo<T, Q, DIM>& g,
    const T (&xe)[NVPC * DIM], T (&D)[DIM][DIM]) {
    T rg[DIM][DIM];                               // rg[k][c]
#pragma unroll
    for (int k = 0; k < DIM; ++k)
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = mul(r.dN[0][k], xe[c]);
#pragma unroll
            for (int a = 1; a < NVPC; ++a)
                s = fmad(r.dN[a][k], xe[a * DIM + c], s);
            rg[k][c] = s;
        }
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            T s = mul(g.Ji[d][0], rg[0][c]);
#pragma unroll
            for (int k = 1; k < DIM; ++k) s = fmad(g.Ji[d][k], rg[k][c], s);
            D[c][d] = s;
        }
}

// The lane's point terms of ca A x for every element dof, from the
// gradient D.
template <typename T, int NVPC, int PN, int Q, int DIM>
__device__ __forceinline__ void a_terms(const Point<T, NVPC, PN, Q, DIM>& r,
                                        const Geo<T, Q, DIM>& g,
                                        const T (&D)[DIM][DIM], T ca, T nu,
                                        int sym, T (&fe)[NVPC * DIM]) {
    const T cw = mul(mul(ca, nu), g.w);
    T G[DIM][DIM];                                // G[k][c]
#pragma unroll
    for (int k = 0; k < DIM; ++k)
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = T(0);
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
                const T F = sym ? add(D[c][d], D[d][c]) : D[c][d];
                s = d == 0 ? mul(g.Ji[d][k], F) : fmad(g.Ji[d][k], F, s);
            }
            G[k][c] = mul(cw, s);
        }
#pragma unroll
    for (int a = 0; a < NVPC; ++a)
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = mul(r.dN[a][0], G[0][c]);
#pragma unroll
            for (int k = 1; k < DIM; ++k) s = fmad(r.dN[a][k], G[k][c], s);
            fe[a * DIM + c] = s;
        }
}

// The lane's point terms of cm M x added to fe.
template <typename T, int NVPC, int PN, int Q, int DIM>
__device__ __forceinline__ void m_add(const Point<T, NVPC, PN, Q, DIM>& r,
                                      const Geo<T, Q, DIM>& g,
                                      const T (&xe)[NVPC * DIM], T cm,
                                      T (&fe)[NVPC * DIM]) {
    const T wm = mul(mul(cm, g.dj), r.qw);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
        T s = mul(r.N[0], xe[c]);
#pragma unroll
        for (int a = 1; a < NVPC; ++a) s = fmad(r.N[a], xe[a * DIM + c], s);
        const T uq = mul(wm, s);
#pragma unroll
        for (int a = 0; a < NVPC; ++a)
            fe[a * DIM + c] = fmad(r.N[a], uq, fe[a * DIM + c]);
    }
}

// The lane's point terms of cm M x + ca A x for every element dof (the
// gradient formed here, only when ca != 0).
template <typename T, int NVPC, int PN, int Q, int DIM>
__device__ __forceinline__ void ma_terms(
    const Point<T, NVPC, PN, Q, DIM>& r, const Geo<T, Q, DIM>& g,
    const T (&xe)[NVPC * DIM], T cm, T ca, T nu, int sym,
    T (&fe)[NVPC * DIM]) {
#pragma unroll
    for (int j = 0; j < NVPC * DIM; ++j) fe[j] = T(0);
    if (ca != T(0)) {
        T D[DIM][DIM];
        gradient(r, g, xe, D);
        a_terms(r, g, D, ca, nu, sym, fe);
    }
    if (cm != T(0)) m_add(r, g, xe, cm, fe);
}

// The lane's point terms of J x for the element's pressure nodes, from
// the gradient D.
template <typename T, int NVPC, int PN, int Q, int DIM>
__device__ __forceinline__ void j_terms(const Point<T, NVPC, PN, Q, DIM>& r,
                                        const Geo<T, Q, DIM>& g,
                                        const T (&D)[DIM][DIM],
                                        T (&fe)[PN]) {
    T div = D[0][0];
#pragma unroll
    for (int c = 1; c < DIM; ++c) div = add(div, D[c][c]);
    const T wd = mul(g.w, div);
#pragma unroll
    for (int s = 0; s < PN; ++s) fe[s] = mul(wd, r.P[s]);
}

// The lane's point terms of J^T q for every element velocity dof, from the
// element's pressure values pe.
template <typename T, int NVPC, int PN, int Q, int DIM>
__device__ __forceinline__ void jt_terms(const Point<T, NVPC, PN, Q, DIM>& r,
                                         const Geo<T, Q, DIM>& g,
                                         const T (&pe)[PN],
                                         T (&fe)[NVPC * DIM]) {
    T qq = mul(r.P[0], pe[0]);
#pragma unroll
    for (int s = 1; s < PN; ++s) qq = fmad(r.P[s], pe[s], qq);
    const T wq = mul(g.w, qq);
#pragma unroll
    for (int a = 0; a < NVPC; ++a)
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
            T s = mul(r.dN[a][0], g.Ji[c][0]);
#pragma unroll
            for (int k = 1; k < DIM; ++k) s = fmad(r.dN[a][k], g.Ji[c][k], s);
            fe[a * DIM + c] = mul(s, wq);
        }
}

// The sum over the group's 8 points: the same bits in every lane.
template <typename T>
__device__ __forceinline__ T point_sum(T v) {
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2)
        v = add(v, __shfl_xor_sync(FULL, v, off, LANES));
    return v;
}

// One facet row: ca sum_b co[b] x[ids[b]], b ascending.
template <typename T, typename TU, int ND>
__device__ __forceinline__ T facet_row(const T* co, const int* ids,
                                       const TU* x, int nin, T ca) {
    T s = mul(co[0], gather<T>(x, ids[0], nin));
#pragma unroll
    for (int b = 1; b < ND; ++b) s = fmad(co[b], gather<T>(x, ids[b], nin), s);
    return mul(s, ca);
}

// -- a block: the elements of a chunk and its halo in shared memory ------

// One halving step of the group's sum over points: lanes with bit `off`
// of q clear keep the lower M/2 values of their list, the others the upper
// ones, each adding its partner's copy (self + other, as point_sum adds);
// the kept values move to the front of the list.
template <typename T, int M>
__device__ __forceinline__ void halve(T (&v)[M], int off, bool upper) {
    static_assert(M % 2 == 0, "even lists");
    constexpr int H = M / 2;
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const T send = upper ? v[k] : v[H + k];
        const T got = __shfl_xor_sync(FULL, send, off, LANES);
        v[k] = add(upper ? v[H + k] : v[k], got);
    }
}

// The point sums of an element's slots into shared memory at base + l*NS.
// NS = 12: recursive halving over the 8 lanes (6 + 3 + 2 shuffles where
// point_sum of every slot takes 36), each sum formed by the same pairs in
// the same order as point_sum's, so with its bits; lane q ends with slots
// [lo, lo + 2 - (q & 1)), lo = 6 (q>>2 & 1) + 3 (q>>1 & 1) + 2 (q & 1).
// Other NS: point_sum of each slot, lane q storing slots q and q + 8.
template <typename T, int NS>
__device__ __forceinline__ void store_sums(const T (&fe)[NS], T* base, int l,
                                           int q, bool valid) {
    if constexpr (NS == 12) {
        T v[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) v[j] = fe[j];
        halve<T, 12>(v, 4, q & 4);
        T w[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) w[j] = v[j];
        halve<T, 6>(w, 2, q & 2);
        // the last step splits three values 2 + 1
        const bool up = q & 1;
        const T send0 = up ? w[0] : w[2];
        const T got0 = __shfl_xor_sync(FULL, send0, 1, LANES);
        const T got1 = __shfl_xor_sync(FULL, w[1], 1, LANES);
        const T r0 = add(up ? w[2] : w[0], got0);
        const T r1 = add(w[1], got1);
        const int lo = 6 * ((q >> 2) & 1) + 3 * ((q >> 1) & 1) + 2 * (q & 1);
        if (valid) {
            base[l * NS + lo] = r0;
            if (!up) base[l * NS + lo + 1] = r1;
        }
    } else {
        T s0 = T(0), s1 = T(0);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const T v = point_sum(fe[j]);
            if (j == q) s0 = v;
            if (j == q + LANES) s1 = v;
        }
        if (valid) {
            if (q < NS) base[l * NS + q] = s0;
            if (q + LANES < NS) base[l * NS + q + LANES] = s1;
        }
    }
}

// Owned dof i of a block: its element slots (positions >= nfac), then (nf
// > 0) its facet rows, each in lell's order (element slots first, -1 past
// its count), taken by slot(u) for u < width; summed from the block's
// values sv (RES: the JT set at st, a pressure dof owned as nin + p),
// stored to y[i].
template <typename T, typename TU, int MODE, typename Slot>
__device__ __forceinline__ void sum_dof(Slot slot, int width, int i,
                                        const T* sv, const T* st, int nfac,
                                        int nf, int nin, TU* y) {
    constexpr bool RES = MODE == MODE_RES;
    const bool vel = MODE != MODE_J && (!RES || i < nin);
    T acc = T(0), acc_t = T(0);
#pragma unroll
    for (int u = 0; u < width; ++u) {
        const int s = slot(u);
        if (s < nfac) continue;
        acc = add(acc, sv[s]);
        if (RES && vel) acc_t = add(acc_t, st[s - nfac]);
    }
    if (vel && nf > 0) {
#pragma unroll
        for (int u = 0; u < width; ++u) {
            const int s = slot(u);
            if (s >= 0 && s < nfac) acc = add(acc, sv[s]);
        }
    }
    if (RES && vel)
        y[i] = static_cast<TU>(acc) + static_cast<TU>(acc_t);
    else
        y[i] = static_cast<TU>(acc);
}

// A dof of more than MAX_SLOTS slots: every position from lell's column
// (col, stride n); kept out of line so that the common path's registers
// are its own.
template <typename T, typename TU, int MODE>
__device__ __noinline__ void sum_wide_dof(const int* col, int n, int width,
                                          int i, const T* sv, const T* st,
                                          int nfac, int nf, int nin, TU* y) {
    sum_dof<T, TU, MODE>(
        [col, n](int u) { return col[static_cast<size_t>(u) * n]; }, width,
        i, sv, st, nfac, nf, nin, y);
}

// Block b of partition pt.  MODE_J: pressure dofs, J terms; MA, JT:
// velocity dofs; RES (the joint partition): velocity dofs (MA and JT
// values of each element, the JT set after the MA set) and pressure dofs
// (J values after both), all from one gather and one gradient an element.
template <typename T, typename TU, int MODE>
__device__ __forceinline__ void block_body(
    const AffinePlan& p, const AffinePart& pt, int b, const TU* x,
    const TU* xq, TU* y, T cm, T ca, T nu, int sym, int facets, T* sv) {
    constexpr int NVPC = NVPC_, PN = PN_, Q = Q_, DIM = DIM_;
    constexpr int ND = NVPC * DIM;
    constexpr bool PRES = MODE == MODE_J;
    constexpr bool RES = MODE == MODE_RES;
    constexpr int NS = PRES ? PN : ND;
    static_assert(ND <= LANES + 4 && PN <= LANES - 4 &&
                  DIM * DIM + Q + 1 <= PACK, "the packed element rows");
    const int4 cnt = reinterpret_cast<const int4*>(pt.cnt)[b];
    const int ne = cnt.x, nfac = cnt.y, nf = facets ? cnt.y : 0;
    const int n = pt.nown;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int q = lane & (LANES - 1);
    // the thread's owned dof and its first MAX_SLOTS slot positions, loaded
    // before the elements (used after them; a dof of more slots reads them
    // all from lell then)
    int slot[MAX_SLOTS];
#pragma unroll
    for (int u = 0; u < MAX_SLOTS; ++u)
        slot[u] = (tid < cnt.w && u < pt.lwidth)
                      ? pt.lell[static_cast<size_t>(u) * n + cnt.z + tid]
                      : -1;
    const int i0 = tid < cnt.w ? pt.own[cnt.z + tid] : 0;

    Point<T, NVPC, PN, Q, DIM> r;
    r.load(p, q);
    T* sk = sv + nfac;                                // element values
    T* st = sk + static_cast<size_t>(ne) * NS;        // JT values (RES)
    T* sj = st + static_cast<size_t>(ne) * NS;        // J values (RES)
    constexpr int PER_WARP = 32 / LANES;
    const int warps = BLOCK_THREADS / 32;
    const size_t row0 = static_cast<size_t>(b) * pt.emax;
    for (int l0 = (tid >> 5) * PER_WARP; l0 < ne; l0 += warps * PER_WARP) {
        const int l = l0 + lane / LANES;
        const bool valid = l < ne;
        const size_t row = (row0 + (valid ? l : 0)) * PACK;
        // lane q: ids q and q + 8 (velocity 0-11, then pressure 0-2)
        const int id0 = valid ? pt.ids[row + q] : -1;
        const int id1 = valid ? pt.ids[row + q + LANES] : -1;
        Geo<T, Q, DIM> geo;
        geo.load(static_cast<const T*>(pt.geo) + row, q, r.on);
        const bool vel1 = q + LANES < ND;           // id1 a velocity id
        T xe[ND], pe[PN];
        if (MODE != MODE_JT)
            share_velocity(gather<T>(x, id0, p.nin),
                           vel1 ? gather<T>(x, id1, p.nin) : T(0), xe);
        if (MODE == MODE_JT || RES) {
            const T pv = vel1 ? T(0)
                              : gather<T>(MODE == MODE_JT ? x : xq, id1,
                                          p.npc);
#pragma unroll
            for (int u = 0; u < PN; ++u)
                pe[u] = __shfl_sync(FULL, pv, ND - LANES + u, LANES);
        }
        if (MODE == MODE_JT) {
            T fe[ND];
            jt_terms(r, geo, pe, fe);
            store_sums(fe, sk, l, q, valid);
        } else if (PRES) {
            T D[DIM][DIM], fj[PN];
            gradient(r, geo, xe, D);
            j_terms(r, geo, D, fj);
            store_sums(fj, sk, l, q, valid);
        } else if (RES) {
            // one gradient for the J and the A terms
            T D[DIM][DIM], fj[PN], fe[ND];
            gradient(r, geo, xe, D);
            j_terms(r, geo, D, fj);
            store_sums(fj, sj, l, q, valid);
#pragma unroll
            for (int u = 0; u < ND; ++u) fe[u] = T(0);
            if (ca != T(0)) a_terms(r, geo, D, ca, nu, sym, fe);
            if (cm != T(0)) m_add(r, geo, xe, cm, fe);
            store_sums(fe, sk, l, q, valid);
            jt_terms(r, geo, pe, fe);
            store_sums(fe, st, l, q, valid);
        } else {
            T fe[ND];
            ma_terms(r, geo, xe, cm, ca, nu, sym, fe);
            store_sums(fe, sk, l, q, valid);
        }
    }
    // the facet rows, one a thread, first on the threads the elements leave
    // idle
    if (!PRES && nf > 0) {
        const int busy =
            min(BLOCK_THREADS, (ne + PER_WARP - 1) / PER_WARP * 32);
        int f = tid - busy;
        if (f < 0) f += BLOCK_THREADS;
        const size_t frow0 = static_cast<size_t>(b) * pt.fmax;
        for (; f < nf; f += BLOCK_THREADS)
            sv[f] = facet_row<T, TU, ND>(
                static_cast<const T*>(pt.fco) + (frow0 + f) * ND,
                pt.fids + (frow0 + f) * ND, x, p.nin, ca);
    }
    __syncthreads();

    // the owned dof (a block owns at most BLOCK_THREADS dofs: the plan
    // splits larger ones)
    if (tid < cnt.w) {
        if (pt.lwidth <= MAX_SLOTS)
            sum_dof<T, TU, MODE>([&slot](int u) { return slot[u]; },
                                 MAX_SLOTS, i0, sv, st, nfac, nf, p.nin, y);
        else
            sum_wide_dof<T, TU, MODE>(pt.lell + cnt.z + tid, n, pt.lwidth,
                                      i0, sv, st, nfac, nf, p.nin, y);
    }
}

template <typename T, typename TU, int MODE>
__global__ void __launch_bounds__(BLOCK_THREADS)
block_kernel(const AffinePlan p, const AffinePart part,
             const TU* __restrict__ x, const TU* __restrict__ xq,
             TU* __restrict__ y, T cm, T ca, T nu, int sym, int facets) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    block_body<T, TU, MODE>(p, part, blockIdx.x, x, xq, y, cm, ca, nu, sym,
                            facets, reinterpret_cast<T*>(smem_raw));
}

// -- the 3D Taylor-Hood form ----------------------------------------------
//
// On affine tets every matvec of the family is exact from constant reference
// matrices (the degree-5 rule integrates the P2 mass, stiffness and
// divergence exactly), so no 125-point loop is run: with Mref[a][b] = sum_q
// qw N2[q,a] N2[q,b], Sref[k][l][a][b] = sum_q qw dN2[q,a,k] dN2[q,b,l],
// Bref[p][k][b] = sum_q qw N1[q,p] dN2[q,b,k], Kg = Ji^T Ji and dj = detJ,
//
//   MA:  fe[a,c] = cm dj sum_b Mref[a][b] x[b,c]
//                + ca nu dj sum_{k,l} ( Kg[k][l] Z[k][l][c]
//                                      + Ji[c][l] sum_d Ji[d][k] Z[k][l][d] )
//        (the second term with sym only), Z[k][l][d] = sum_b Sref[k][l][a][b]
//        x[b,d];
//   J:   fe[p]   = dj sum_{c,k} Ji[c][k] sum_b Bref[p][k][b] x[b,c];
//   JT:  fe[a,c] = dj sum_k Ji[c][k] sum_p Bref[p][k][a] q[p].
//
// Every slot is one thread's fixed-order chain; the partition, the facet
// rows and the per-dof sums are the 2D form's (a thread loops over the
// block's dofs, so a 3D block is never split).  The first form took a warp
// an element, each element a chain of dependent trips to L2 (its ids, then
// x by those ids, its geometry) and, in MA, 90 loads of Sref and 270 of x a
// lane; it trailed one cuSPARSE matvec.  This form stages a block's work
// first and computes from shared memory and registers:
//
//   1. one thread starts the bulk copies (cp.async.bulk on two
//      mbarriers): the block's packed ids (contiguous in the plan's
//      tables), then the reference matrices, the elements' geometry rows
//      and the block's slot table (ops/kernels.py: affine_slots3d); all
//      threads wait for the ids, gather x (and q) for the slots the mode
//      reads in one pass (16 independent loads a thread in flight), and
//      compute the facet rows from global memory meanwhile;
//   2. the velocity slots, a warp an element, lane (a, c) its slot: the
//      lane keeps its rows of Sref (90 entries), Mref (10) and Bref (12)
//      in registers for the whole block; in MA it forms only Z[k][l][a][c]
//      (its own component: 90 multiply-adds where every lane formed all
//      three, 270) and takes Z[k][l][a][d] of d != c from the lanes of its
//      node by shuffles, with the same chains, so with the same bits;
//   3. the pressure slots (J, the residual's J), a thread a (element,
//      pressure node): 8 elements a warp, its Bref rows in registers;
//   4. the dof sums, a dof's element slots read 8 at a time.
//
// The bulk copies (~60 KB a block at nz=8) are about half of a light
// mode's call (tools_torch/affine_phases.py).  Bound (chip_smoke.py:
// affine3d_bound_ms): at 3D-2Z nz=8 mode a needs ~0.12 GFLOP (272 flops a
// slot in the symmetric form, operations) and the other modes' ids,
// geometry and vectors a few MB (bytes); a call also pays the partition's
// halo (elements recomputed by the blocks of their dofs).
//
// AFFINE3D_PHASES: the phases a build runs, all four unless a build
// defines it (tools_torch/affine_phases.py leaves phases out to time the
// rest).
#ifndef AFFINE3D_PHASES
#define AFFINE3D_PHASES 15
#endif
constexpr int PH_GATHER = 1, PH_FACETS = 2, PH_TERMS = 4, PH_SUMS = 8;
constexpr int PHASES = AFFINE3D_PHASES;
constexpr int PACK3 = 36;           // ids an element: 30 velocity, 4
                                    // pressure, 2 padding
constexpr int REF3 = 100 + 900 + 120;   // Mref, Sref, Bref
constexpr int WARPS = BLOCK_THREADS / 32;

// A 3D block's shared memory, in bytes (ops/kernels.py: affine_smem3d):
// two mbarriers, the reference matrices, the elements' geometry rows and
// ids, the dofs' slot table, the gathered values, the facet rows' and
// elements' values.
template <typename T>
__host__ __device__ constexpr size_t smem3d(int emax, int fmax, int smax,
                                            int per_elem) {
    return 16 +
           (static_cast<size_t>(REF3) +
            static_cast<size_t>(emax) * (PACK + PACK3 + per_elem) + fmax) *
               sizeof(T) +
           (static_cast<size_t>(emax) * PACK3 + smax) * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the arrival, announcing the bytes the copies will bring
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
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
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Owned dof i of a 3D block: sum_dof's sums in its order, the slots read
// from column col (stride m) of the block's slot table.  The element slots
// come first, then the facet rows, then -1: the element slots are read
// SLOTS3 at a time (their loads in flight together) and added one after
// the other while they last; then the facet rows one by one.
constexpr int SLOTS3 = 8;

template <typename T, typename TU, int MODE>
__device__ __forceinline__ void sum_dof3(const int* col, int m, int width,
                                         int i, const T* sv, const T* st,
                                         int nfac, int nf, int nin, TU* y) {
    constexpr bool RES = MODE == MODE_RES;
    const bool vel = MODE != MODE_J && (!RES || i < nin);
    T acc = T(0), acc_t = T(0);
    int u = 0;
    for (int got = SLOTS3; got == SLOTS3 && u < width; u += got) {
        int s[SLOTS3];
        T v[SLOTS3], w[SLOTS3];
#pragma unroll
        for (int c = 0; c < SLOTS3; ++c) {
            s[c] = u + c < width ? col[(u + c) * m] : -1;
            v[c] = s[c] >= nfac ? sv[s[c]] : T(0);
            w[c] = RES && vel && s[c] >= nfac ? st[s[c] - nfac] : T(0);
        }
        got = 0;
#pragma unroll
        for (int c = 0; c < SLOTS3; ++c)
            if (s[c] >= nfac) {
                acc = add(acc, v[c]);
                if (RES && vel) acc_t = add(acc_t, w[c]);
                ++got;
            }
    }
    // u: the first slot past the element slots
    if (vel && nf > 0)
        for (; u < width; ++u) {
            const int s = col[u * m];
            if (s < 0) break;
            acc = add(acc, sv[s]);
        }
    if (RES && vel)
        y[i] = static_cast<TU>(acc) + static_cast<TU>(acc_t);
    else
        y[i] = static_cast<TU>(acc);
}

// Block b of partition pt in 3D.  MODE and the value sets as block_body's;
// HAS_A: the A terms (ca != 0) of MA and RES.
template <typename T, typename TU, int MODE, bool HAS_A>
__device__ __forceinline__ void block_body_3d(
    const AffinePlan& p, const AffinePart& pt, int b, const TU* x,
    const TU* xq, TU* y, T cm, T ca, T nu, int sym, int facets,
    unsigned char* smem) {
    constexpr int NVPC = 10, PN = 4, DIM = 3, ND = NVPC * DIM;
    constexpr bool PRES = MODE == MODE_J;
    constexpr bool RES = MODE == MODE_RES;
    constexpr bool VEL_MA = MODE == MODE_MA || RES;
    constexpr bool VEL_JT = MODE == MODE_JT || RES;
    constexpr int NS = PRES ? PN : ND;
    const int4 cnt = reinterpret_cast<const int4*>(pt.cnt)[b];
    const int ne = cnt.x, nfac = cnt.y, nf = facets ? cnt.y : 0;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int emax = pt.emax;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);   // ids; the rest
    T* ref = reinterpret_cast<T*>(smem + 16);
    T* geo = ref + REF3;                                 // emax x PACK
    int* ids = reinterpret_cast<int*>(geo + static_cast<size_t>(emax) *
                                                PACK);   // emax x PACK3
    int* sl = ids + static_cast<size_t>(emax) * PACK3;   // the slot table
    T* xs = reinterpret_cast<T*>(sl + pt.smax);
    T* sv = xs + static_cast<size_t>(emax) * PACK3;      // the values
    T* sk = sv + nfac;
    T* st = sk + static_cast<size_t>(ne) * NS;
    T* sj = st + static_cast<size_t>(ne) * NS;
    const size_t row0 = static_cast<size_t>(b) * emax;
    const int2 si = reinterpret_cast<const int2*>(pt.sinfo)[b];
    const int soff = si.x, sw = si.y;

    // 1. the ids by a bulk copy; the reference matrices, geometry and slot
    // table by three more; the gathered values; the facet rows
    if (tid == 0) {
        mbar_init(bar, 1);
        mbar_init(bar + 1, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t ib = ne * PACK3 * sizeof(int),
                       gb = ne * PACK * sizeof(T), rb = REF3 * sizeof(T),
                       sb = (sw * cnt.w + 3) / 4 * 16;
        mbar_arrive_tx(bar, ib);
        if (ne > 0) bulk_copy(ids, pt.ids + row0 * PACK3, ib, bar);
        mbar_arrive_tx(bar + 1, rb + gb + sb);
        bulk_copy(ref, p.ref, rb, bar + 1);
        if (ne > 0)
            bulk_copy(geo, static_cast<const T*>(pt.geo) + row0 * PACK, gb,
                      bar + 1);
        if (sb > 0) bulk_copy(sl, pt.slots + soff, sb, bar + 1);
    }
    __syncthreads();
    mbar_wait(bar, 0);
    {
        // only the slots the mode reads: velocity (G0 0, GN 30), pressure
        // (JT: 30, 4) or both (RES: 0, 34)
        constexpr int G0 = MODE == MODE_JT ? ND : 0;
        constexpr int GN = MODE == MODE_JT ? PN : (RES ? ND + PN : ND);
        const TU* qv = MODE == MODE_JT ? x : xq;
        const int nx = ne * GN;
        constexpr int U = 16;
        for (int i0 = tid; i0 < nx; i0 += U * BLOCK_THREADS) {
            T v[U];
            int at[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * BLOCK_THREADS;
                const int l = i / GN, j = G0 + (i - l * GN);
                at[u] = l * PACK3 + j;
                v[u] = T(0);
                if ((PHASES & PH_GATHER) && i < nx)
                    v[u] = j < ND ? gather<T>(x, ids[at[u]], p.nin)
                                  : gather<T>(qv, ids[at[u]], p.npc);
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (i0 + u * BLOCK_THREADS < nx) xs[at[u]] = v[u];
        }
    }
    if ((PHASES & PH_FACETS) && !PRES && nf > 0)
        for (int f = tid; f < nf; f += BLOCK_THREADS) {
            const size_t fr = static_cast<size_t>(b) * pt.fmax + f;
            sv[f] = facet_row<T, TU, ND>(
                static_cast<const T*>(pt.fco) + fr * ND, pt.fids + fr * ND,
                x, p.nin, ca);
        }
    __syncthreads();
    mbar_wait(bar + 1, 0);
    const T* Mref = ref;
    const T* Sref = Mref + NVPC * NVPC;
    const T* Bref = Sref + DIM * DIM * NVPC * NVPC;

    // 2. the velocity slots: a warp an element, lane (a, c) slot a DIM + c
    // (lanes 30 and 31 compute node 9's values too, for its shuffles, and
    // store nothing)
    if constexpr ((VEL_MA || VEL_JT) && (PHASES & PH_TERMS)) {
        const int a = min(lane, ND - 1) / DIM, c = lane % DIM;
        T S[DIM * DIM][NVPC], Mr[NVPC], Bt[PN][DIM];
#pragma unroll
        for (int km = 0; km < DIM * DIM; ++km)
#pragma unroll
            for (int bb = 0; bb < NVPC; ++bb)
                S[km][bb] = HAS_A ? Sref[(km * NVPC + a) * NVPC + bb] : T(0);
#pragma unroll
        for (int bb = 0; bb < NVPC; ++bb)
            Mr[bb] = VEL_MA ? Mref[a * NVPC + bb] : T(0);
#pragma unroll
        for (int pp = 0; pp < PN; ++pp)
#pragma unroll
            for (int k = 0; k < DIM; ++k)
                Bt[pp][k] = VEL_JT ? Bref[(pp * DIM + k) * NVPC + a] : T(0);
        for (int l = warp; l < ne; l += WARPS) {
            const T* xe = xs + l * PACK3;
            const T* g = geo + l * PACK;
            T Ji[DIM][DIM];
#pragma unroll
            for (int d = 0; d < DIM; ++d)
#pragma unroll
                for (int k = 0; k < DIM; ++k) Ji[d][k] = g[d * DIM + k];
            const T dj = g[DIM * DIM];
            T Jc[DIM];                                   // Ji[c][.]
#pragma unroll
            for (int k = 0; k < DIM; ++k) Jc[k] = g[c * DIM + k];
            if constexpr (VEL_MA) {
                T xc[NVPC];                              // x[., c]
#pragma unroll
                for (int bb = 0; bb < NVPC; ++bb) xc[bb] = xe[bb * DIM + c];
                T fe = T(0);
                if constexpr (HAS_A) {
                    T zo[DIM * DIM];                     // Z[k][m][a][c]
#pragma unroll
                    for (int km = 0; km < DIM * DIM; ++km) {
                        T z = T(0);
#pragma unroll
                        for (int bb = 0; bb < NVPC; ++bb)
                            z = fmad(S[km][bb], xc[bb], z);
                        zo[km] = z;
                    }
                    T s1 = T(0), s2 = T(0);
#pragma unroll
                    for (int k = 0; k < DIM; ++k)
#pragma unroll
                        for (int m = 0; m < DIM; ++m) {
                            T kg = T(0);
#pragma unroll
                            for (int d = 0; d < DIM; ++d)
                                kg = fmad(Ji[d][k], Ji[d][m], kg);
                            s1 = fmad(kg, zo[k * DIM + m], s1);
                            if (sym) {
                                T jz = T(0);
#pragma unroll
                                for (int d = 0; d < DIM; ++d)
                                    jz = fmad(Ji[d][k],
                                              __shfl_sync(FULL,
                                                          zo[k * DIM + m],
                                                          a * DIM + d),
                                              jz);
                                s2 = fmad(Jc[m], jz, s2);
                            }
                        }
                    fe = mul(mul(mul(ca, nu), dj), sym ? add(s1, s2) : s1);
                }
                if (cm != T(0)) {
                    T s = T(0);
#pragma unroll
                    for (int bb = 0; bb < NVPC; ++bb)
                        s = fmad(Mr[bb], xc[bb], s);
                    fe = fmad(mul(cm, dj), s, fe);
                }
                if (lane < ND) sk[l * ND + lane] = fe;
            }
            if constexpr (VEL_JT) {
                const T* qe = xe + ND;
                T s = T(0);
#pragma unroll
                for (int k = 0; k < DIM; ++k) {
                    T z = T(0);
#pragma unroll
                    for (int pp = 0; pp < PN; ++pp)
                        z = fmad(Bt[pp][k], qe[pp], z);
                    s = fmad(Jc[k], z, s);
                }
                if (lane < ND) (RES ? st : sk)[l * ND + lane] = mul(dj, s);
            }
        }
    }

    // 3. the pressure slots: a thread an (element, pressure node)
    if constexpr ((PRES || RES) && (PHASES & PH_TERMS)) {
        const int pn = tid % PN;
        T Bp[DIM][NVPC];
#pragma unroll
        for (int k = 0; k < DIM; ++k)
#pragma unroll
            for (int bb = 0; bb < NVPC; ++bb)
                Bp[k][bb] = Bref[(pn * DIM + k) * NVPC + bb];
        for (int l = tid / PN; l < ne; l += BLOCK_THREADS / PN) {
            const T* xe = xs + l * PACK3;
            const T* g = geo + l * PACK;
            T s = T(0);
#pragma unroll
            for (int k = 0; k < DIM; ++k)
#pragma unroll
                for (int cc = 0; cc < DIM; ++cc) {
                    T z = T(0);
#pragma unroll
                    for (int bb = 0; bb < NVPC; ++bb)
                        z = fmad(Bp[k][bb], xe[bb * DIM + cc], z);
                    s = fmad(g[cc * DIM + k], z, s);
                }
            (RES ? sj : sk)[l * PN + pn] = mul(g[DIM * DIM], s);
        }
    }
    __syncthreads();

    // 4. the block's dofs, a thread each in turn, their slots from the
    // block's slot table (left out: one store keeps the phases before)
    if constexpr (!(PHASES & PH_SUMS)) {
        if (tid == 0) y[b % 7] = static_cast<TU>(sv[nfac]);
        return;
    }
    for (int k = tid; k < cnt.w; k += BLOCK_THREADS)
        sum_dof3<T, TU, MODE>(sl + k, cnt.w, sw, pt.own[cnt.z + k], sv, st,
                              nfac, nf, p.nin, y);
}

template <typename T, typename TU, int MODE, bool HAS_A>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
block_kernel_3d(const AffinePlan p, const AffinePart part,
                const TU* __restrict__ x, const TU* __restrict__ xq,
                TU* __restrict__ y, T cm, T ca, T nu, int sym, int facets) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    block_body_3d<T, TU, MODE, HAS_A>(p, part, blockIdx.x, x, xq, y, cm, ca,
                                      nu, sym, facets, smem_raw);
}

__global__ void empty_kernel() {}

// The grid, block and shared memory of a launch (3D: up to the most a
// block may take, opted into at its first launch).
template <typename T, bool D3>
cudaError_t geometry(const AffinePlan& p, const AffineCall& c, dim3& grid,
                     dim3& block, size_t& smem) {
    constexpr int ND = D3 ? 30 : NVPC_ * DIM_, PN = D3 ? 4 : PN_;
    const int mode = c.mode;
    const AffinePart& pt = mode == MODE_J ? c.pb : c.vb;
    const long long blocks = pt.nblk;
    const int per_elem = mode == MODE_J     ? PN
                         : mode == MODE_RES ? 2 * ND + PN
                                            : ND;
    smem = D3 ? smem3d<T>(pt.emax, pt.fmax, pt.smax, per_elem)
              : (static_cast<size_t>(pt.fmax) +
                 static_cast<size_t>(pt.emax) * per_elem) * sizeof(T);
    if (blocks <= 0 || smem > (D3 ? SMEM_MAX : 48 * 1024))
        return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(blocks));
    block = dim3(BLOCK_THREADS);
    return cudaSuccess;
}

// Above 48 KB a kernel opts in to more shared memory, once per kernel.
cudaError_t opt_in(const void* fn, size_t smem, int& opted) {
    if (smem <= 48 * 1024 || opted) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess) opted = 1;
    return err;
}

template <typename T, typename TU, int MODE, bool D3, bool HAS_A>
cudaError_t launch(const AffinePlan& p, const AffineCall& c, const void* x,
                   const void* xq, void* y, cudaStream_t st) {
    dim3 grid, block;
    size_t smem;
    cudaError_t err = geometry<T, D3>(p, c, grid, block, smem);
    if (err != cudaSuccess) return err;
    const TU* xx = static_cast<const TU*>(x);
    const TU* qq = static_cast<const TU*>(xq);
    TU* yy = static_cast<TU*>(y);
    const T cm = static_cast<T>(c.cm), ca = static_cast<T>(c.ca),
            nu = static_cast<T>(c.nu);
    if constexpr (D3) {
        static int opted = 0;
        err = opt_in(reinterpret_cast<const void*>(
                         block_kernel_3d<T, TU, MODE, HAS_A>),
                     smem, opted);
        if (err != cudaSuccess) return err;
        block_kernel_3d<T, TU, MODE, HAS_A><<<grid, block, smem, st>>>(
            p, MODE == MODE_J ? c.pb : c.vb, xx, qq, yy, cm, ca, nu, c.sym,
            c.facets);
    } else {
        block_kernel<T, TU, MODE><<<grid, block, smem, st>>>(
            p, MODE == MODE_J ? c.pb : c.vb, xx, qq, yy, cm, ca, nu, c.sym,
            c.facets);
    }
    return cudaGetLastError();
}

// The 3D form takes its A terms at compile time (HAS_A: ca != 0); the 2D
// form at run time.
template <typename T, typename TU, bool D3>
cudaError_t launch_mode(const AffinePlan& p, const AffineCall& c,
                        const void* x, const void* xq, void* y,
                        cudaStream_t st) {
    const bool has_a = D3 && c.ca != 0.0;
    switch (c.mode) {
        case MODE_MA:
            return has_a ? launch<T, TU, MODE_MA, D3, D3>(p, c, x, xq, y, st)
                         : launch<T, TU, MODE_MA, D3, false>(p, c, x, xq, y,
                                                             st);
        case MODE_J:
            return launch<T, TU, MODE_J, D3, false>(p, c, x, xq, y, st);
        case MODE_JT:
            return launch<T, TU, MODE_JT, D3, false>(p, c, x, xq, y, st);
        case MODE_RES:
            return has_a
                       ? launch<T, TU, MODE_RES, D3, D3>(p, c, x, xq, y, st)
                       : launch<T, TU, MODE_RES, D3, false>(p, c, x, xq, y,
                                                            st);
        default: return cudaErrorInvalidValue;
    }
}

// (a 2D block owns at most BLOCK_THREADS dofs; a 3D block's threads loop)
bool valid_part(const AffinePart& b, bool facets, bool d3) {
    return b.nblk > 0 && b.cnt != nullptr && b.ids != nullptr &&
           b.geo != nullptr && b.own != nullptr &&
           (d3 || b.lell != nullptr) && b.lwidth > 0 && b.emax > 0 &&
           b.nown > 0 && b.maxown > 0 && (d3 || b.maxown <= BLOCK_THREADS) &&
           (!d3 || (b.sinfo != nullptr && b.slots != nullptr &&
                    b.smax >= 0 &&
                    ((reinterpret_cast<uintptr_t>(b.ids) |
                      reinterpret_cast<uintptr_t>(b.geo) |
                      reinterpret_cast<uintptr_t>(b.slots)) & 15u) == 0)) &&
           (!facets || b.fmax == 0 || (b.fids != nullptr && b.fco != nullptr));
}

bool valid_call(const AffinePlan& p, const AffineCall& c, bool d3) {
    const long long nd = d3 ? 30 : 12;
    if (p.nc <= 0 || p.nin <= 0 || p.npc <= 0 || p.nfac < 0 ||
        p.qw == nullptr || p.N2 == nullptr || p.dN2 == nullptr ||
        p.N1 == nullptr ||
        (d3 && (p.ref == nullptr ||
                (reinterpret_cast<uintptr_t>(p.ref) & 15u) != 0)) ||
        c.mode < 0 ||
        c.mode > 3 ||
        static_cast<long long>(p.nc) * nd +
                static_cast<long long>(p.nfac) * nd >= (1LL << 31))
        return false;
    if (c.facets && (!(c.mode == MODE_MA || c.mode == MODE_RES) ||
                     p.nfac == 0))
        return false;
    return c.mode == MODE_J ? valid_part(c.pb, false, d3)
                            : valid_part(c.vb, c.facets, d3);
}

}  // namespace

namespace {

template <bool D3>
int affine_run(const AffinePlan* plan, const AffineCall* call,
               const void* x, const void* xq, void* y, void* stream) {
    const AffinePlan& p = *plan;
    const AffineCall& c = *call;
    if (!valid_call(p, c, D3))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.work_f64)
        err = c.x_f64 ? launch_mode<double, double, D3>(p, c, x, xq, y, st)
                      : launch_mode<double, float, D3>(p, c, x, xq, y, st);
    else
        err = c.x_f64 ? launch_mode<float, double, D3>(p, c, x, xq, y, st)
                      : launch_mode<float, float, D3>(p, c, x, xq, y, st);
    return static_cast<int>(err);
}

template <bool D3>
int affine_empty(const AffinePlan* plan, const AffineCall* call,
                 void* stream) {
    const AffinePlan& p = *plan;
    const AffineCall& c = *call;
    if (!valid_call(p, c, D3))
        return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid, block;
    size_t smem;
    cudaError_t err = p.work_f64
                          ? geometry<double, D3>(p, c, grid, block, smem)
                          : geometry<float, D3>(p, c, grid, block, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    static int opted = 0;
    err = opt_in(reinterpret_cast<const void*>(empty_kernel), smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    empty_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The 2D Taylor-Hood instantiation (NVPC 6, PN 3, Q 7, DIM 2).
//   plan: the reference tables (AffinePlan above); call: mode, constants
//   and the partitions;
//   mode 0 -> y (nin) = cm M x + ca A x (+ the facet rows when facets != 0),
//        1 -> y (npc) = J x, 2 -> y (nin) = J^T x with x (npc),
//        3 -> y (nin + npc) = [cm M x + ca A x (+ facet rows) + J^T xq ;
//             J x] with x (nin), xq (npc);
//   x, xq, y in the vector type (call->x_f64), the work type from
//   plan->work_f64.
// Returns the cudaError_t of the launch (0 = success).
int affine_th2d(const AffinePlan* plan, const AffineCall* call,
                const void* x, const void* xq, void* y, void* stream) {
    return affine_run<false>(plan, call, x, xq, y, stream);
}

// The 3D Taylor-Hood instantiation (NVPC 10, PN 4, DIM 3): the same modes
// and arguments; plan->ref holds the reference matrices, the packed rows
// are PACK3 ids (30 velocity, 4 pressure, padding) and PACK geometry
// (JinvT, detJ, padding) an element.
int affine_th3d(const AffinePlan* plan, const AffineCall* call,
                const void* x, const void* xq, void* y, void* stream) {
    return affine_run<true>(plan, call, x, xq, y, stream);
}

// An empty kernel on the grid, block and shared memory of the same call:
// the floor a latency-bound launch meets on this card.
int affine_th2d_empty(const AffinePlan* plan, const AffineCall* call,
                      void* stream) {
    return affine_empty<false>(plan, call, stream);
}

int affine_th3d_empty(const AffinePlan* plan, const AffineCall* call,
                      void* stream) {
    return affine_empty<true>(plan, call, stream);
}

const char* affine_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
