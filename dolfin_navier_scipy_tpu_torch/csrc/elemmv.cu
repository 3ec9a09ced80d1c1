// The element-matrix matvec for Hopper (sm_90a): an operator held as one
// dense block per element, applied without assembly.
//
//   y[o] = sum over the element rows (e, a) with out[e, a] == o of
//          sum_b E[e, a, b] * x[in[e, b]]
//
// E is an (nc, R, C) table whose element blocks lie whole and in order in
// 16-byte aligned memory (strides R*C, SR, SC with {SR, SC} = {C, 1} or
// {1, R}), so that one kernel applies a block table and its transpose;
// in (nc, C) holds
// each element's input ids, an id outside [0, n_in) (the Dirichlet "trash"
// slot n_in) reads 0; an output id outside [0, n_out) has no row (dropped).
//
// The uses (ops/elementop.py, solve/steady.py):
//   ElementOp.matvec        E (nc, 12, 12), in = out = the velocity ids;
//   DivElementOp.matvec     E (nc, 3, 12), in velocity, out pressure ids;
//   DivElementOp.rmatvec    the transpose of that table: R 12, C 3,
//                           SR 1, SC 12;
//   the steady solver's F-matvec, f32 (nc, 12, 12) on the inner-dof table
//   (the linearized convection plus the stiffness, solve/steady.py:
//   _sk_elem32).
// It replaces no TPU kernel: the JAX package computes these products with
// XLA (dolfin_navier_scipy_tpu/solve/steady.py:369 _sk_nmv,
// ops/elementop.py:48 and :87: gather, einsum, segment_sum).  Eager
// PyTorch has no fused form of it, and index_add_ sums with atomics, so its
// bits change from run to run.
//
// Bound: bytes.  E dominates (576 B an element for f32 12x12; the ids 48 B,
// x and y 4 B a dof): 4.9 us at 3.35 TB/s for the level-3 wake's 25 316
// elements.  The operations (2 R C an element) are far below their peak.
// At level 3 this kernel reads E at about three quarters of the memory
// rate; at level 1 the launch and the dependent trips are most of a call.
//
// The earlier design (a thread an output dof walking its up to 9 slots one
// after another, each a dependent chain slot -> element ids -> 12 gathers,
// the element row read 4 bytes at a time by 32 unrelated threads) was
// latency-bound at 3-24x its byte bound.  This one has no chain a thread
// walks (ops/kernels.py: elem_partition builds its tables once per operand
// and card):
//
//   the elements are cut into chunks in a locality order (RCM over shared
//   output dofs); an output dof belongs to the block of its first element
//   in that order (ops/kernels.py: affine_partition, shared with
//   csrc/affine.cu), and the block computes exactly the element rows of
//   its dofs, no row twice in the grid.  A block
//     1. copies its tables (rows, dof row pointers, dofs, input
//        positions) into shared memory by one 1-D bulk copy
//        (cp.async.bulk) on an mbarrier and, at the same time, gathers
//        the distinct inputs of its elements there (a trash id reads 0);
//     2. computes one element row a thread, the rows in element order, so
//        that a warp reads neighbouring rows of E: a row of 12 contiguous
//        entries by 16-byte loads straight from E, which stays in its
//        natural order (the transpose's strided rows entry by entry); the
//        C-wide dot over b ascending, each E entry rounded to x's type
//        first, one fused multiply-add a term (the earlier kernel's
//        contraction), stored to the row's place among the block's values;
//     3. sums each of its dofs a thread from its rows, which the values
//        hold in the dof's slot order, and stores it.
//   Every sum is taken in the earlier kernel's order, so y has its bits
//   for every partition; no atomics, no scratch, no grid-wide wait.  A
//   call is three dependent trips (the block's table offsets and input
//   ids; the tables and inputs; E's rows) before the arithmetic.  Copying
//   E's rows into shared memory by bulk copies first (runs of a block's
//   rows, 48-576 B each; the transpose's blocks whole) and computing
//   there was 0.5-2 us slower a call at every size on an H100, also as a
//   two-stage pipeline: it is not built (PERF.md).
//
// Plain C interface, loaded with ctypes; the caller allocates the output
// and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch plan of one operand (ops/kernels.py: _ElemPlanC, field for
// field).  Per block b (nblk of them):
//   hdr[b]      (blob offset in 16-byte units, blob bytes, rows, dofs);
//   dids[b * dmax + i]    the distinct input ids of its elements, -1 (read
//               as 0) for the trash id and past their count;
//   blob        the block's tables, in this order: rows (uint32 pairs, in
//               the order of the block's elements: the row's first entry
//               in E; its element's first input position, high 16 bits,
//               and its place among the block's values, which run dof by
//               dof and for each dof slot by slot, low 16 bits), dofs+1
//               row pointers into the values (int32), its dofs (int32,
//               ascending), 4 bytes, the input positions (uint16, C an
//               element: into the block's distinct inputs), 16-byte
//               padded.
struct ElemPlan {
    const int4* hdr;
    const int* dids;
    const unsigned char* blob;
    int nblk, dmax;
    int blob_bytes;             // the largest block's tables
    int smem;                   // shared memory a block takes, in all
    int C, SC;                  // inputs a row; E's column stride
    int e_f64, x_f64;
    int n_in;
};

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the arrival, announcing the bytes the copy will bring
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

// explicit rounding: the same bits whatever the surrounding code
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

// C entries from 16-byte (entries) or 8-byte (positions) aligned memory
template <int C>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[C]) {
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(p)[k];
        v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z,
        v[4 * k + 3] = q.w;
    }
}
template <int C>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[C]) {
#pragma unroll
    for (int k = 0; k < C / 2; ++k) {
        const double2 q = reinterpret_cast<const double2*>(p)[k];
        v[2 * k] = q.x, v[2 * k + 1] = q.y;
    }
}
template <int C>
__device__ __forceinline__ void load_vec(const unsigned short* p,
                                         unsigned short (&v)[C]) {
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
        const uint2 q = reinterpret_cast<const uint2*>(p)[k];
        v[4 * k] = q.x & 0xffffu, v[4 * k + 1] = q.x >> 16,
        v[4 * k + 2] = q.y & 0xffffu, v[4 * k + 3] = q.y >> 16;
    }
}

template <typename TE, typename TX, int C>
__global__ void __launch_bounds__(THREADS)
elemmv_kernel(const ElemPlan p, const TE* __restrict__ E,
              const TX* __restrict__ x, TX* __restrict__ y) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    unsigned char* tab = smem + 16;                 // the block's tables
    TX* xs = reinterpret_cast<TX*>(tab + p.blob_bytes);
    TX* sv = xs + p.dmax;                           // the rows' values
    const int b = blockIdx.x, tid = threadIdx.x;
    const int4 h = p.hdr[b];                        // blob, bytes, rows, dofs
    const int* dids = p.dids + static_cast<size_t>(b) * p.dmax;

    // 1. the block's tables, one bulk copy; the distinct inputs gathered
    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive_tx(bar, static_cast<uint32_t>(h.y));
        bulk_copy(tab, p.blob + static_cast<size_t>(h.x) * 16,
                  static_cast<uint32_t>(h.y), bar);
    }
    for (int i = tid; i < p.dmax; i += THREADS) {
        const int j = dids[i];
        xs[i] = static_cast<unsigned>(j) < static_cast<unsigned>(p.n_in)
                    ? x[j] : TX(0);
    }
    __syncthreads();
    mbar_wait(bar, 0);

    // 2. a row a thread, in element order: its entries read from E
    const uint2* rows = reinterpret_cast<const uint2*>(tab);
    const int* rp = reinterpret_cast<const int*>(rows + h.z);
    const int* own = rp + h.w + 1;
    const unsigned short* lin = reinterpret_cast<const unsigned short*>(
        own + h.w + 1);                             // 8-byte aligned
    for (int r = tid; r < h.z; r += THREADS) {
        const uint2 w = rows[r];
        const TE* row = E + w.x;
        const unsigned short* li = lin + (w.y >> 16);
        TE ev[C];
        unsigned short iv[C];
        if (C == 12 && p.SC == 1) {
            // a row of 12 contiguous entries starts 16-byte aligned (E
            // is), its element's 12 positions 8-byte aligned
            load_vec(row, ev);
            load_vec(li, iv);
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                ev[c] = row[c * p.SC];
                iv[c] = li[c];
            }
        }
        TX d = TX(0);
#pragma unroll
        for (int c = 0; c < C; ++c)
            d = fmad(static_cast<TX>(ev[c]), xs[iv[c]], d);
        sv[w.y & 0xffffu] = d;
    }
    __syncthreads();

    // 3. a dof a thread: its rows in its slot order
    for (int k = tid; k < h.w; k += THREADS) {
        TX acc = TX(0);
        for (int s = rp[k]; s < rp[k + 1]; ++s) acc = add(acc, sv[s]);
        y[own[k]] = acc;
    }
}

__global__ void empty_kernel() {}

template <typename TE, typename TX>
cudaError_t launch(const ElemPlan& p, const void* E, const void* x, void* y,
                   cudaStream_t st) {
    const TE* e = static_cast<const TE*>(E);
    const TX* xx = static_cast<const TX*>(x);
    TX* yy = static_cast<TX*>(y);
    const dim3 grid(p.nblk), block(THREADS);
    const size_t smem = static_cast<size_t>(p.smem);
    // above 48 KB a block opts in, once per instantiation
    static int opted[2] = {0, 0};
    void* fn = nullptr;
    int* flag = nullptr;
    if (p.C == 3) {
        fn = reinterpret_cast<void*>(elemmv_kernel<TE, TX, 3>);
        flag = opted;
    } else if (p.C == 12) {
        fn = reinterpret_cast<void*>(elemmv_kernel<TE, TX, 12>);
        flag = opted + 1;
    } else {
        return cudaErrorInvalidValue;
    }
    if (smem > 48 * 1024 && !*flag) {
        const cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (err != cudaSuccess) return err;
        *flag = 1;
    }
    if (p.C == 3)
        elemmv_kernel<TE, TX, 3><<<grid, block, smem, st>>>(p, e, xx, yy);
    else
        elemmv_kernel<TE, TX, 12><<<grid, block, smem, st>>>(p, e, xx, yy);
    return cudaGetLastError();
}

bool valid_plan(const ElemPlan& p) {
    return p.nblk > 0 && p.hdr != nullptr && p.dids != nullptr &&
           p.blob != nullptr && p.dmax > 0 && p.blob_bytes % 16 == 0 &&
           p.smem > 0 && p.smem <= 232448 && (p.C == 3 || p.C == 12) &&
           p.SC > 0 && p.n_in >= 0;
}

}  // namespace

extern "C" {

// plan: the operand's launch plan (ElemPlan above: the tables, the types,
// C and SC); E: the element blocks, 16-byte aligned, f64 if plan->e_f64
// else f32; x: (n_in) and y: (n_out), f64 if plan->x_f64 else f32 (the
// arithmetic type).  Returns the cudaError_t of the launch (0 = success).
int elemmv(const ElemPlan* plan, const void* E, const void* x, void* y,
           void* stream) {
    const ElemPlan& p = *plan;
    if (!valid_plan(p) || (reinterpret_cast<uintptr_t>(E) & 15u) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p.e_f64)
        err = p.x_f64 ? launch<double, double>(p, E, x, y, st)
                      : launch<double, float>(p, E, x, y, st);
    else
        err = p.x_f64 ? launch<float, double>(p, E, x, y, st)
                      : launch<float, float>(p, E, x, y, st);
    return static_cast<int>(err);
}

// An empty kernel on the grid, block and shared memory of the plan's
// launch: the floor a latency-bound launch meets on this card.
int elemmv_empty(const ElemPlan* plan, void* stream) {
    const ElemPlan& p = *plan;
    if (!valid_plan(p)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(p.smem);
    static int opted = 0;
    if (smem > 48 * 1024 && !opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            reinterpret_cast<void*>(empty_kernel),
            cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted = 1;
    }
    empty_kernel<<<p.nblk, THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

const char* elemmv_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
