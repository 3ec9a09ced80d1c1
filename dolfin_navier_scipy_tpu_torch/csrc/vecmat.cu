// Dense inverse apply  y = x @ KT  for Hopper (sm_90a), f32 and f64.
//
//   x (m,)  @  KT (m, n), rows ld apart  ->  y (n,)    accumulate in the
//                                                      operand type
//
// Replaces the TPU kernel `_vecmat_kernel` / `vecmat_pallas` of
// dolfin_navier_scipy_tpu/ops/pallas_kernels.py: the apply of the
// transposed dense saddle inverse, K^-1 r, once per time step.
//
// Bound: bytes.  Every entry of KT is read exactly once and used for one
// multiply-add, so the least time is sizeof(T)*m*n bytes over the memory
// rate; x, y and the partial sums are O(m + n*m/BOX_ROWS) and small.
//
// Design: one launch, one block per SM, the operand cut into boxes that
// the blocks take from a counter, each box one tensor copy.
//   * units: the operand is cut into boxes of BOX_ROWS rows x BOX_COLS
//     columns (GROUPS 16-byte column groups: 64 KB, 256 columns in f32, 128
//     in f64), unit u = (row slab u / ntiles, column tile u % ntiles).  The
//     cut is set by the build (-D flags) from ops/kernels.py's
//     _VECMAT_GEOMETRY, which also sizes the caller's scratch and the
//     block's shared memory: it is decided in that one place.  Each block's
//     producer lane takes unit after unit from an integer ticket counter, so
//     an SM that the memory system serves faster takes more of them.  (A
//     static split of equal bytes per SM left the SMs finishing far apart on
//     an H100, the slowest setting the time; units cut into one-row pieces,
//     one 1-D bulk copy each, streamed slower the more pieces there were.  A
//     box is one copy.)
//   * the producer lane (a warp of its own) loads each box into a ring of
//     STAGES shared-memory slots with cp.async.bulk.tensor.2d (TMA, a
//     tensor map over the (m, n) operand with row pitch ld: rows 16-byte
//     aligned; completion on a `full` mbarrier per slot; L2::evict_first:
//     KT never fits the 50 MB L2; rows past m and columns past n are filled
//     with zeros by the copy and never read from memory), and writes the
//     unit's number into the slot's header.
//   * eight consumer warps: thread t owns the 16-byte column group g = t %
//     GROUPS of the box and the rows l, l+LANES, ... with l = t / GROUPS,
//     adds them in ascending order in registers, releases the slot on its
//     `empty` mbarrier, and the row lanes of a column group are joined in
//     order through shared memory.  The box's partial sums go to their
//     fixed place in `part` (slabs, n): row slab, tile columns.  They are
//     the same bits whichever block takes the unit, so the result does not
//     depend on the schedule.
//   * after a grid-wide barrier, four adjacent lanes take one column of y:
//     each adds a fixed contiguous run of the slabs' partials, and the four
//     runs are joined in order.  No floating-point atomics: the result is
//     bitwise reproducible launch to launch.
//   * the barrier is an integer arrival counter that only grows (`bar`: 64
//     bits, then the 32-bit ticket counter, which block 0 resets after the
//     barrier; zero-initialised, owned by the caller, one per stream and
//     grid size).  It needs every block resident: the grid is at most one
//     block per SM, the launcher checks
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor, and the launch carries
//     cudaLaunchAttributeCooperative, which makes the driver refuse a grid
//     that cannot be co-resident (graph capture accepts it).  A counter
//     rather than cooperative_groups::grid_group::sync keeps the kernel
//     correct inside captured graphs too.
//   * any m >= 1, n >= 1; columns in [n, ld) are never read.
//
// Plain C interface, loaded with ctypes; the caller allocates y, the
// partials and the barrier words, passes raw device pointers, the block's
// shared-memory size from its plan (checked against the kernel's layout)
// and the CUDA stream, and checks the returned cudaError_t.  The tensor map
// is encoded on the host at each launch (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint: no link against the driver library).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the cut, from ops/kernels.py: _VECMAT_GEOMETRY
#if !defined(VECMAT_BOX_ROWS) || !defined(VECMAT_GROUPS) || \
    !defined(VECMAT_STAGES) || !defined(VECMAT_CONSUMERS)
#error "build through ops/kernels.py: the box geometry comes from its plan"
#endif
constexpr int CONSUMERS = VECMAT_CONSUMERS;  // threads that multiply-add
constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
constexpr int GROUPS = VECMAT_GROUPS;        // 16-byte column groups of a box
constexpr int LANES = CONSUMERS / GROUPS;    // row lanes of a column group
constexpr int BOX_ROWS = VECMAT_BOX_ROWS;
constexpr int STAGES = VECMAT_STAGES;        // boxes in the ring
static_assert(CONSUMERS % 32 == 0 && CONSUMERS % GROUPS == 0 &&
                  BOX_ROWS % LANES == 0,
              "row lanes must split the consumers and the box rows evenly");
static_assert(BOX_ROWS <= 256 && GROUPS * 4 <= 256 && STAGES >= 1,
              "a tensor-copy box is at most 256 entries a side");
constexpr int REDUCE_LANES = 4;     // lanes that share a column of y
constexpr int REDUCE_BATCH = 40;    // partial rows a lane loads at once

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ void fma_vec(float4& a, float x, const float4& s) {
    a.x += x * s.x; a.y += x * s.y; a.z += x * s.z; a.w += x * s.w;
}
__device__ __forceinline__ void fma_vec(double2& a, double x,
                                        const double2& s) {
    a.x += x * s.x; a.y += x * s.y;
}
__device__ __forceinline__ void add_vec(float4& a, const float4& s) {
    a.x += s.x; a.y += s.y; a.z += s.z; a.w += s.w;
}
__device__ __forceinline__ void add_vec(double2& a, const double2& s) {
    a.x += s.x; a.y += s.y;
}
__device__ __forceinline__ float4 zero_vec(float) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ double2 zero_vec(double) {
    return make_double2(0.0, 0.0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
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

// box (col, row) of the tensor map into shared memory, completing on bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar,
                                            uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1, {%2, %3}], [%4], %5;"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(col), "r"(row), "r"(smem_addr(bar)), "l"(policy)
        : "memory");
}

// the consumer warps alone (named barrier 1): the producer never joins
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
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

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
vecmat_kernel(const __grid_constant__ CUtensorMap map,
              const T* __restrict__ x, T* __restrict__ y,
              T* __restrict__ part, unsigned long long* bar, int m, int n,
              unsigned long long* trace) {
    using VT = typename Vec<T>::type;
    constexpr int V = Vec<T>::n;
    constexpr int BOX_COLS = GROUPS * V;
    constexpr int BOX_BYTES = BOX_ROWS * BOX_COLS * sizeof(T);
    extern __shared__ __align__(1024) unsigned char smem[];
    VT* comb = reinterpret_cast<VT*>(smem + STAGES * BOX_BYTES);
    // comb: [2][LANES][GROUPS]
    uint64_t* full = reinterpret_cast<uint64_t*>(comb + 2 * CONSUMERS);
    uint64_t* empty = full + STAGES;
    int* hdr = reinterpret_cast<int*>(empty + STAGES);
    const int t = threadIdx.x;
    unsigned* ticket_ctr = reinterpret_cast<unsigned*>(bar + 1);
    unsigned long long* tr =
        trace == nullptr ? nullptr : trace + 4 * blockIdx.x;
    if (tr != nullptr && t == 0) tr[0] = now_ns();

    const int ntiles = (n + BOX_COLS - 1) / BOX_COLS;
    const int slabs = (m + BOX_ROWS - 1) / BOX_ROWS;
    if (t == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();

    if (t >= CONSUMERS) {
        // the producer lane: a box per ticket and slot, then one header
        // saying there is no more
        if (t == CONSUMERS) {
            uint64_t policy;
            asm volatile(
                "createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                : "=l"(policy));
            const int units = slabs * ntiles;
            int s = 0;
            uint32_t round = 0;
            for (;;) {
                const int u = static_cast<int>(atomicAdd(ticket_ctr, 1u));
                if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
                hdr[s] = u < units ? u : -1;
                if (u < units) {
                    mbar_expect_tx(full + s, BOX_BYTES);
                    tensor_copy(smem + s * BOX_BYTES, &map,
                                (u % ntiles) * BOX_COLS,
                                (u / ntiles) * BOX_ROWS, full + s, policy);
                } else {
                    mbar_arrive(full + s);  // a header alone
                }
                if (u >= units) break;
                if (++s == STAGES) {
                    s = 0;
                    ++round;
                }
            }
        }
    } else {
        const int g = t % GROUPS, l = t / GROUPS;
        int s = 0, k = 0;
        uint32_t round = 0;
        for (;; ++k) {
            mbar_wait(full + s, round & 1);
            const int u = hdr[s];
            if (u < 0) break;
            const int r = u / ntiles, c = u - r * ntiles;
            const int row0 = r * BOX_ROWS;
            const VT* box = reinterpret_cast<const VT*>(smem + s * BOX_BYTES);
            // the lane's x values first, all loads in flight at once (the
            // ring leaves little L1: they come from L2)
            T xs[BOX_ROWS / LANES];
#pragma unroll
            for (int q = 0; q < BOX_ROWS / LANES; ++q) {
                const int i = row0 + l + q * LANES;
                xs[q] = i < m ? __ldg(x + i) : T(0);
            }
            VT acc = zero_vec(T());
#pragma unroll
            for (int q = 0; q < BOX_ROWS / LANES; ++q)
                fma_vec(acc, xs[q], box[(l + q * LANES) * GROUPS + g]);
            __syncwarp();               // the warp is done with slot s
            if ((t & 31) == 0) mbar_arrive(empty + s);
            // join the row lanes of each column group, in order
            VT* cb = comb + (k & 1) * CONSUMERS;
            cb[l * GROUPS + g] = acc;
            consumers_sync();
            if (l == 0) {
                VT sum = cb[g];
#pragma unroll
                for (int q = 1; q < LANES; ++q) add_vec(sum, cb[q * GROUPS + g]);
                const T* e = reinterpret_cast<const T*>(&sum);
                const int col = c * BOX_COLS + g * V;
                T* dst = part + static_cast<long long>(r) * n + col;
#pragma unroll
                for (int q = 0; q < V; ++q)
                    if (col + q < n) dst[q] = e[q];
            }
            if (++s == STAGES) {
                s = 0;
                ++round;
            }
        }
    }
    if (tr != nullptr && t == 0) tr[1] = now_ns();

    grid_barrier(bar);
    // every ticket has been taken: the counter starts the next launch at 0
    if (blockIdx.x == 0 && t == 0) *ticket_ctr = 0u;
    if (tr != nullptr && t == 0) tr[2] = now_ns();

    // y[col] = sum over the row slabs: REDUCE_LANES adjacent lanes share a
    // column, each adds a fixed contiguous run of the slabs in order, and
    // the runs are joined in order -- the same bits on every launch
    const int per = (slabs + REDUCE_LANES - 1) / REDUCE_LANES;
    const int q = t % REDUCE_LANES;
    const int lane = t & 31;
    const int base = lane & ~(REDUCE_LANES - 1);
    const unsigned lanes_mask = ((1u << REDUCE_LANES) - 1) << base;
    const long long cols_per_pass =
        static_cast<long long>(gridDim.x) * (THREADS / REDUCE_LANES);
    for (long long col =
             (static_cast<long long>(blockIdx.x) * THREADS + t) /
             REDUCE_LANES;
         col < n; col += cols_per_pass) {
        T sum = T(0);
        const int b_end = min(slabs, (q + 1) * per);
        for (int b0 = q * per; b0 < b_end; b0 += REDUCE_BATCH) {
            const int b1 = min(b_end, b0 + REDUCE_BATCH);
            T v[REDUCE_BATCH];
#pragma unroll
            for (int u = 0; u < REDUCE_BATCH; ++u)
                v[u] = b0 + u < b1
                           ? __ldcg(part + (b0 + u) * static_cast<long long>(n) + col)
                           : T(0);
#pragma unroll
            for (int u = 0; u < REDUCE_BATCH; ++u)
                if (b0 + u < b1) sum += v[u];
        }
        T total = __shfl_sync(lanes_mask, sum, base);
#pragma unroll
        for (int u = 1; u < REDUCE_LANES; ++u)
            total += __shfl_sync(lanes_mask, sum, base + u);
        if (q == 0) y[col] = total;
    }
    if (tr != nullptr && t == 0) tr[3] = now_ns();
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the block's shared memory (f32 and f64 alike): the ring, the row lanes'
// join, the full and empty mbarriers and the header of each slot
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(STAGES) * BOX_ROWS * GROUPS * 16 + 2 * CONSUMERS * 16 +
    STAGES * (2 * sizeof(uint64_t) + sizeof(int));

template <typename T>
cudaError_t launch(const T* x, const T* KT, T* y, T* part,
                   unsigned long long* bar, int m, int n, int ld, int blocks,
                   size_t smem, unsigned long long* trace, cudaStream_t st) {
    constexpr int V = Vec<T>::n;
    constexpr int BOX_COLS = GROUPS * V;
    if (m <= 0 || n <= 0 || ld < n || (ld * sizeof(T)) % 16 != 0 ||
        blocks <= 0 || smem != SMEM_BYTES ||
        (reinterpret_cast<uintptr_t>(KT) % 16) != 0)
        return cudaErrorInvalidValue;
    auto kern = vecmat_kernel<T>;
    // per instantiation: the opt-in to large shared memory, the occupancy
    // at that size, and the driver's tensor-map encoder (host queries cost
    // more than the launch)
    static int occ = -1, sms = 0;
    static EncodeTiled encode = nullptr;
    cudaError_t err;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                      cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return cudaErrorNotSupported;
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    if (occ < 0) {
        err = cudaFuncSetAttribute(kern,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        int dev = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev)) != cudaSuccess)
            return err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &occ, kern, THREADS, smem)) != cudaSuccess)
            return err;
    }
    // the grid barrier needs every block resident at once
    if (static_cast<long long>(occ) * sms < blocks)
        return cudaErrorCooperativeLaunchTooLarge;

    // the (m, n) operand, rows ld apart; a box is BOX_ROWS x BOX_COLS
    CUtensorMap map;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
    const cuuint32_t box[2] = {BOX_COLS, BOX_ROWS};
    const cuuint32_t step[2] = {1, 1};
    if (encode(&map,
               sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
               2, const_cast<T*>(KT), dims, pitch, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, map, x, y, part, bar, m, n, trace);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T>
int vecmat(const void* x, const void* KT, void* y, void* part, void* bar,
           int m, int n, int ld, int blocks, long long smem, void* trace,
           void* stream) {
    return static_cast<int>(launch<T>(
        static_cast<const T*>(x), static_cast<const T*>(KT),
        static_cast<T*>(y), static_cast<T*>(part),
        static_cast<unsigned long long*>(bar), m, n, ld, blocks,
        static_cast<size_t>(smem), static_cast<unsigned long long*>(trace),
        static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// y = x @ KT in f32.  KT: m rows of n values, rows `ld` apart (ld*4 a
// multiple of 16, base 16-byte aligned); part: ceil(m/BOX_ROWS)*n floats of
// scratch; bar: four 32-bit words, zero before the first launch with this
// grid (a 64-bit arrival counter, the ticket counter, unused).  blocks: at
// most one per SM; smem: the block's shared memory as the caller's plan
// gives it (must equal the kernel's layout).  trace: null, or 4 x blocks
// words that receive each block's %globaltimer at its start, at the end of
// its units, after the grid barrier and at its end.  Returns the
// cudaError_t of the launch (0 = success).
int vecmat_f32(const void* x, const void* KT, void* y, void* part, void* bar,
               int m, int n, int ld, int blocks, long long smem, void* trace,
               void* stream) {
    return vecmat<float>(x, KT, y, part, bar, m, n, ld, blocks, smem, trace,
                         stream);
}

// The same in f64 (ld*8 a multiple of 16).
int vecmat_f64(const void* x, const void* KT, void* y, void* part, void* bar,
               int m, int n, int ld, int blocks, long long smem, void* trace,
               void* stream) {
    return vecmat<double>(x, KT, y, part, bar, m, n, ld, blocks, smem, trace,
                          stream);
}

const char* vecmat_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
