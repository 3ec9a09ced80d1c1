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
// Written over NVPC, PN, Q, DIM as compile-time parameters (Q <= 8); only
// the 2D Taylor-Hood instantiation (6, 3, 7, 2) is built.  Plain C
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
    const int* lell;        // (lwidth, nown): own[k]'s slots as positions
                            // in its block's shared memory (facet rows at
                            // [0, nf), element slot (l, j) at nf + l*ns + j;
                            // the residual's pressure slots past its two
                            // velocity value sets), element slots first,
                            // -1 past its count
    int nblk, emax, fmax, lwidth;
    int nown;               // owned dofs in all (the residual's: nin + npc,
                            // pressure dof p owned as nin + p)
    int maxown;             // the most dofs a block owns (<= BLOCK_THREADS)
};

// The reference tables (ops/kernels.py: _AffinePlanC, field for field).
struct AffinePlan {
    const void* qw;         // (Q,) work type
    const void* N2;         // (Q, NVPC)
    const void* dN2;        // (Q, NVPC, DIM)
    const void* N1;         // (Q, PN)
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

__global__ void empty_kernel() {}

// The grid, block and shared memory of a launch.
template <typename T>
cudaError_t geometry(const AffinePlan& p, const AffineCall& c, dim3& grid,
                     dim3& block, size_t& smem) {
    constexpr int ND = NVPC_ * DIM_;
    const int mode = c.mode;
    const AffinePart& pt = mode == MODE_J ? c.pb : c.vb;
    const long long blocks = pt.nblk;
    const int per_elem = mode == MODE_J     ? PN_
                         : mode == MODE_RES ? 2 * ND + PN_
                                            : ND;
    smem = (static_cast<size_t>(pt.fmax) +
            static_cast<size_t>(pt.emax) * per_elem) * sizeof(T);
    if (blocks <= 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(blocks));
    block = dim3(BLOCK_THREADS);
    return cudaSuccess;
}

template <typename T, typename TU, int MODE>
cudaError_t launch(const AffinePlan& p, const AffineCall& c, const void* x,
                   const void* xq, void* y, cudaStream_t st) {
    dim3 grid, block;
    size_t smem;
    cudaError_t err = geometry<T>(p, c, grid, block, smem);
    if (err != cudaSuccess) return err;
    const TU* xx = static_cast<const TU*>(x);
    const TU* qq = static_cast<const TU*>(xq);
    TU* yy = static_cast<TU*>(y);
    const T cm = static_cast<T>(c.cm), ca = static_cast<T>(c.ca),
            nu = static_cast<T>(c.nu);
    block_kernel<T, TU, MODE><<<grid, block, smem, st>>>(
        p, MODE == MODE_J ? c.pb : c.vb, xx, qq, yy, cm, ca, nu, c.sym,
        c.facets);
    return cudaGetLastError();
}

template <typename T, typename TU>
cudaError_t launch_mode(const AffinePlan& p, const AffineCall& c,
                        const void* x, const void* xq, void* y,
                        cudaStream_t st) {
    switch (c.mode) {
        case MODE_MA: return launch<T, TU, MODE_MA>(p, c, x, xq, y, st);
        case MODE_J: return launch<T, TU, MODE_J>(p, c, x, xq, y, st);
        case MODE_JT: return launch<T, TU, MODE_JT>(p, c, x, xq, y, st);
        case MODE_RES: return launch<T, TU, MODE_RES>(p, c, x, xq, y, st);
        default: return cudaErrorInvalidValue;
    }
}

bool valid_part(const AffinePart& b, bool facets) {
    return b.nblk > 0 && b.cnt != nullptr && b.ids != nullptr &&
           b.geo != nullptr && b.own != nullptr && b.lell != nullptr &&
           b.lwidth > 0 && b.emax > 0 &&
           b.nown > 0 && b.maxown > 0 && b.maxown <= BLOCK_THREADS &&
           (!facets || b.fmax == 0 || (b.fids != nullptr && b.fco != nullptr));
}

bool valid_call(const AffinePlan& p, const AffineCall& c) {
    if (p.nc <= 0 || p.nin <= 0 || p.npc <= 0 || p.nfac < 0 ||
        p.qw == nullptr || p.N2 == nullptr || p.dN2 == nullptr ||
        p.N1 == nullptr || c.mode < 0 || c.mode > 3 ||
        static_cast<long long>(p.nc) * 12 +
                static_cast<long long>(p.nfac) * 12 >= (1LL << 31))
        return false;
    if (c.facets && (!(c.mode == MODE_MA || c.mode == MODE_RES) ||
                     p.nfac == 0))
        return false;
    return c.mode == MODE_J ? valid_part(c.pb, false)
                            : valid_part(c.vb, c.facets);
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
    const AffinePlan& p = *plan;
    const AffineCall& c = *call;
    if (!valid_call(p, c)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.work_f64)
        err = c.x_f64 ? launch_mode<double, double>(p, c, x, xq, y, st)
                      : launch_mode<double, float>(p, c, x, xq, y, st);
    else
        err = c.x_f64 ? launch_mode<float, double>(p, c, x, xq, y, st)
                      : launch_mode<float, float>(p, c, x, xq, y, st);
    return static_cast<int>(err);
}

// An empty kernel on the grid, block and shared memory of the same call:
// the floor a latency-bound launch meets on this card.
int affine_th2d_empty(const AffinePlan* plan, const AffineCall* call,
                      void* stream) {
    const AffinePlan& p = *plan;
    const AffineCall& c = *call;
    if (!valid_call(p, c)) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid, block;
    size_t smem;
    cudaError_t err = p.work_f64 ? geometry<double>(p, c, grid, block, smem)
                                 : geometry<float>(p, c, grid, block, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    empty_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

const char* affine_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
