// The estimator's cache-share / thrash-cliff stage for Hopper, in f64.
//
// Replaces the TPU kernel src/repro/kernels/cache_share.py
// (cache_share_pallas). Per scenario row of ws (S, K) and present (S, K):
// total = sum of ws (left to right over K), nk = number of present
// members; a member with a working set keeps share 0 or 1 (the thrash
// cliff: 0 once total > cap) when nk > 1, min(1, cap / max(ws, 1)) when it
// is the lone cache user, and 1 without a working set.
//
// The scenarios are a few to a few thousand rows of 2-6 members, so the
// kernel is bound by its launch, not by bytes or operations. One thread
// owns one row and keeps its K <= 8 working sets in registers (a wider row
// is read twice from memory instead); the TPU version's padding of K to
// 128 lanes has no counterpart here. Plain IEEE f64 division (no fast
// math), so the result equals the plain version bit for bit.
#include "common.cuh"

constexpr int CS_THREADS = 128;

template <int K>
__global__ void __launch_bounds__(CS_THREADS)
cache_share_kernel(const double* __restrict__ ws, const unsigned char* __restrict__ present,
                   double cap, double* __restrict__ out, int S) {
    const int r = blockIdx.x * CS_THREADS + threadIdx.x;
    if (r >= S) return;
    const double* w_row = ws + (int64_t)r * K;
    const unsigned char* p_row = present + (int64_t)r * K;
    double w[K];
    double total = 0.0;
    int nk = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        w[k] = w_row[k];
        total += w[k];
        nk += p_row[k] != 0;
    }
    const double resident_col = total > cap ? 0.0 : 1.0;
    double* o_row = out + (int64_t)r * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        double share = 1.0;
        if (w[k] > 0.0) share = nk > 1 ? resident_col : fmin(1.0, cap / fmax(w[k], 1.0));
        o_row[k] = share;
    }
}

// Rows wider than 8 members: the same arithmetic in the same order, with
// the working sets read again from memory for the second pass.
__global__ void __launch_bounds__(CS_THREADS)
cache_share_wide_kernel(const double* __restrict__ ws, const unsigned char* __restrict__ present,
                        double cap, double* __restrict__ out, int S, int K) {
    const int r = blockIdx.x * CS_THREADS + threadIdx.x;
    if (r >= S) return;
    const double* w_row = ws + (int64_t)r * K;
    const unsigned char* p_row = present + (int64_t)r * K;
    double total = 0.0;
    int nk = 0;
    for (int k = 0; k < K; ++k) {
        total += w_row[k];
        nk += p_row[k] != 0;
    }
    const double resident_col = total > cap ? 0.0 : 1.0;
    double* o_row = out + (int64_t)r * K;
    for (int k = 0; k < K; ++k) {
        const double w = w_row[k];
        double share = 1.0;
        if (w > 0.0) share = nk > 1 ? resident_col : fmin(1.0, cap / fmax(w, 1.0));
        o_row[k] = share;
    }
}

// ws, out: (S, K) f64 contiguous; present: (S, K) bool (one byte each),
// contiguous. Returns cudaGetLastError(), or -1 for S or K below 1.
extern "C" int rt_cache_share(const void* ws, const void* present, double cap,
                              void* out, int S, int K, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (S <= 0 || K < 1) return -1;
    const int blocks = (S + CS_THREADS - 1) / CS_THREADS;
    const double* wp = static_cast<const double*>(ws);
    const unsigned char* pp = static_cast<const unsigned char*>(present);
    double* op = static_cast<double*>(out);
#define CS_LAUNCH(KK) \
    cache_share_kernel<KK><<<blocks, CS_THREADS, 0, s>>>(wp, pp, cap, op, S)
    switch (K) {
        case 1: CS_LAUNCH(1); break;
        case 2: CS_LAUNCH(2); break;
        case 3: CS_LAUNCH(3); break;
        case 4: CS_LAUNCH(4); break;
        case 5: CS_LAUNCH(5); break;
        case 6: CS_LAUNCH(6); break;
        case 7: CS_LAUNCH(7); break;
        case 8: CS_LAUNCH(8); break;
        default:
            cache_share_wide_kernel<<<blocks, CS_THREADS, 0, s>>>(wp, pp, cap, op, S, K);
    }
#undef CS_LAUNCH
    return (int)cudaGetLastError();
}
