// The element-matrix matvec for Hopper (sm_90a): an operator held as one
// dense block per element, applied without assembly.
//
//   y[o] = sum over the element rows (e, a) with out[e, a] == o of
//          sum_b E[e, a, b] * x[in[e, b]]
//
// E is an (nc, R, C) table read through strides (SE, SR, SC), so that one
// kernel applies a block table and its transpose; in (nc, C) holds each
// element's input ids, an id outside [0, n_in) (the Dirichlet "trash" slot
// n_in) reads 0; the output rows come from the ELL table of
// ops/kernels.py: dof_slot_table over out (nc, R): ell[k, o] is the k-th
// element row (slot e*R + a) of output dof o in ascending order, -1 past
// its count, and an output id outside [0, n_out) has no entry (dropped).
//
// The uses (ops/elementop.py, solve/steady.py):
//   ElementOp.matvec        E (nc, 12, 12), in = out = the velocity ids;
//   DivElementOp.matvec     E (nc, 3, 12), in velocity, out pressure ids;
//   DivElementOp.rmatvec    the transpose of that table: R 12, C 3,
//                           SR 1, SC 12;
//   the steady solver's linearized convection (_sk_nmv), f32 (nc, 12, 12)
//   on the inner-dof table.
// The JAX package leaves this function to XLA (gather, einsum,
// segment_sum); eager PyTorch has no fused form of it, and index_add_ sums
// with atomics, so its bits change from run to run.
//
// Design: one thread owns one output dof and walks its slots in the
// table's order; for each slot it takes the C-wide dot of the element row
// with the gathered inputs (in x's type, each E entry rounded to it first)
// and adds it to its sum.  An element row belongs to exactly one output
// dof, so nothing is computed twice; no scratch, no grid-wide wait, no
// atomics: every call gives the same bits.
//
// Bound: the f32 (nc, 12, 12) table dominates the bytes (576 B an
// element).  At the wake's level 2 (6678 elements) a call moves ~4 MB,
// ~1.2 us at 3.35 TB/s; the operations are far below their bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <typename TE, typename TX, int C>
__global__ void __launch_bounds__(THREADS)
elemmv_kernel(const TE* __restrict__ E, const int* __restrict__ in_ids,
              const TX* __restrict__ x, const int* __restrict__ ell,
              int width, TX* __restrict__ y, int R, long long SE, int SR,
              int SC, int n_in, int n_out) {
    const int o = blockIdx.x * THREADS + threadIdx.x;
    if (o >= n_out) return;
    TX acc = TX(0);
    for (int k = 0; k < width; ++k) {
        const int s = __ldg(ell + static_cast<long long>(k) * n_out + o);
        if (s < 0) break;                 // the slots come first, ascending
        const int e = s / R;
        const int a = s - e * R;
        const TE* row = E + e * SE + static_cast<long long>(a) * SR;
        const int* ids = in_ids + static_cast<long long>(e) * C;
        TX dot = TX(0);
#pragma unroll
        for (int b = 0; b < C; ++b) {
            const int j = __ldg(ids + b);
            const TX xv = (j >= 0 && j < n_in) ? __ldg(x + j) : TX(0);
            dot += static_cast<TX>(__ldg(row + b * SC)) * xv;
        }
        acc += dot;
    }
    y[o] = acc;
}

template <typename TE, typename TX>
cudaError_t launch(const void* E, const int* in_ids, const void* x,
                   const int* ell, int width, void* y, int R, int C,
                   long long SE, int SR, int SC, int n_in, int n_out,
                   cudaStream_t st) {
    const dim3 grid((n_out + THREADS - 1) / THREADS), block(THREADS);
    const TE* e = static_cast<const TE*>(E);
    const TX* xx = static_cast<const TX*>(x);
    TX* yy = static_cast<TX*>(y);
    switch (C) {
    case 3:
        elemmv_kernel<TE, TX, 3><<<grid, block, 0, st>>>(
            e, in_ids, xx, ell, width, yy, R, SE, SR, SC, n_in, n_out);
        break;
    case 12:
        elemmv_kernel<TE, TX, 12><<<grid, block, 0, st>>>(
            e, in_ids, xx, ell, width, yy, R, SE, SR, SC, n_in, n_out);
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// E: (nc, R, C) through strides (SE, SR, SC), f64 if e_f64 else f32;
// in_ids: (nc, C) int32; x: (n_in) and y: (n_out), f64 if x_f64 else f32
// (the arithmetic type); ell: (width, n_out) int32.  C is 3 or 12.
// Returns the cudaError_t of the launch (0 = success).
int elemmv(const void* E, int e_f64, const int* in_ids, const void* x,
           int x_f64, const int* ell, int width, void* y, int R, int C,
           long long SE, int SR, int SC, int n_in, int n_out, void* stream) {
    if (n_out <= 0 || width <= 0 || R <= 0 || (C != 3 && C != 12))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (e_f64)
        err = x_f64 ? launch<double, double>(E, in_ids, x, ell, width, y, R,
                                             C, SE, SR, SC, n_in, n_out, st)
                    : launch<double, float>(E, in_ids, x, ell, width, y, R,
                                            C, SE, SR, SC, n_in, n_out, st);
    else
        err = x_f64 ? launch<float, double>(E, in_ids, x, ell, width, y, R,
                                            C, SE, SR, SC, n_in, n_out, st)
                    : launch<float, float>(E, in_ids, x, ell, width, y, R,
                                           C, SE, SR, SC, n_in, n_out, st);
    return static_cast<int>(err);
}

const char* elemmv_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
