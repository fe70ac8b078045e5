// Mamba-1 selective scan for Hopper:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = <h_t, C_t> over N,
// with the (d_inner, N) state in f32 registers that never reach device memory.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan_pallas).
// The TPU version keeps h (block_d, N) in VMEM scratch across a sequential
// grid axis of time chunks; here blocks run in parallel and in no order, so
// the time loop runs inside the kernel, over any S (the Pallas kernel's
// S % chunk == 0 is a staging rule of the TPU and is not kept). One thread
// owns one (batch, channel) pair and keeps its N <= 16 states and its row of
// A in registers; the block's 128 channels share the B_t and C_t of a run of
// SCAN_TILE time steps, staged in shared memory (every thread reads the same
// word: a broadcast). x_t and dt_t are read, and y_t written, once each, by
// neighbouring threads on neighbouring addresses; a thread loads the x and dt
// of SCAN_UNROLL steps before it computes them, so their latencies overlap.
//
// What bounds it on the card: at falcon-mamba's prefill (4 x 1024 tokens,
// d_inner 8192, N 16) it moves 10 bytes per (b, t, d) (x bf16, dt f32, y
// f32: 335 MB, about 100 us at 3.35 TB/s) and takes one exp per (b, t, d, n)
// (537 M): at 16 a clock on each SM's multi-function unit, about 128 us.
// The exps set its bound. expf, not __expf: the result must hold 1e-4
// against the plain version, and expf is one ex2 on that unit plus about
// eight FP32 instructions, so by count the issue of those (about 200 us)
// comes before the exps themselves.
//
// Beyond the Pallas kernel it takes an optional initial state h0 (Bb, di, N)
// and writes the final state hT (Bb, di, N): prefill seeds decode with it,
// and a decode step is this scan with S = 1 and h0 == hT (each thread reads
// its state before it writes it, so the two may be the same buffer). y is
// written in f32, as the model's scan returns it; the caller casts.
#include "common.cuh"

constexpr int SCAN_THREADS = 128;   // channels of one block
constexpr int SCAN_TILE = 64;       // time steps whose B and C are staged at once
constexpr int SCAN_UNROLL = 8;      // time steps whose x and dt are loaded at once

template <typename T, int N>
__global__ void __launch_bounds__(SCAN_THREADS)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* h0,
                float* __restrict__ y, float* hT, int S, int di) {
    __shared__ float sB[SCAN_TILE][N];
    __shared__ float sC[SCAN_TILE][N];
    const int b = blockIdx.y;
    const int d = blockIdx.x * SCAN_THREADS + threadIdx.x;
    const bool live = d < di;
    const int64_t state = ((int64_t)b * di + d) * N;

    float a[N], h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        a[n] = live ? A[(int64_t)d * N + n] : 0.f;
        h[n] = (live && h0 != nullptr) ? h0[state + n] : 0.f;
    }
    const float* Bb = Bm + (int64_t)b * S * N;
    const float* Cb = Cm + (int64_t)b * S * N;
    const int64_t row0 = (int64_t)b * S;

    for (int t0 = 0; t0 < S; t0 += SCAN_TILE) {
        const int nt = min(SCAN_TILE, S - t0);
        __syncthreads();                     // the previous tile is consumed
        for (int e = threadIdx.x; e < nt * N; e += SCAN_THREADS) {
            sB[e / N][e % N] = Bb[(int64_t)t0 * N + e];
            sC[e / N][e % N] = Cb[(int64_t)t0 * N + e];
        }
        __syncthreads();
        // a thread past di computes on zeros and stores nothing: skipping
        // the loop instead costs the live threads a register spill
        for (int t = 0; t < nt; t += SCAN_UNROLL) {
            float xv[SCAN_UNROLL], dv[SCAN_UNROLL];
#pragma unroll
            for (int u = 0; u < SCAN_UNROLL; ++u) {
                dv[u] = 0.f;
                xv[u] = 0.f;
                if (live && t + u < nt) {
                    const int64_t i = (row0 + t0 + t + u) * di + d;
                    dv[u] = dt[i];
                    xv[u] = to_f32(x[i]);
                }
            }
#pragma unroll
            for (int u = 0; u < SCAN_UNROLL; ++u) {
                if (t + u >= nt) break;
                const float dx = dv[u] * xv[u];
                float acc = 0.f;
#pragma unroll
                for (int n = 0; n < N; ++n) {
                    const float dA = expf(dv[u] * a[n]);
                    h[n] = dA * h[n] + dx * sB[t + u][n];
                    acc += h[n] * sC[t + u][n];
                }
                if (live) y[(row0 + t0 + t + u) * di + d] = acc;
            }
        }
    }
    if (live) {
#pragma unroll
        for (int n = 0; n < N; ++n) hT[state + n] = h[n];
    }
}

template <typename T>
static int launch_ssm_scan(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* h0, void* y, void* hT, int Bb,
                           int S, int di, int N, cudaStream_t s) {
    const dim3 grid((di + SCAN_THREADS - 1) / SCAN_THREADS, Bb);
    const T* xp = static_cast<const T*>(x);
    const float* dtp = static_cast<const float*>(dt);
    const float* ap = static_cast<const float*>(A);
    const float* bp = static_cast<const float*>(B);
    const float* cp = static_cast<const float*>(C);
    const float* h0p = static_cast<const float*>(h0);
    float* yp = static_cast<float*>(y);
    float* hTp = static_cast<float*>(hT);
#define SCAN_CASE(NN)                                                              \
    case NN:                                                                       \
        ssm_scan_kernel<T, NN><<<grid, SCAN_THREADS, 0, s>>>(xp, dtp, ap, bp, cp,  \
                                                             h0p, yp, hTp, S, di); \
        break;
    switch (N) {
        SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
        SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
        SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
        SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
        default: return -1;
    }
#undef SCAN_CASE
    return (int)cudaGetLastError();
}

// x (Bb, S, di) in `dtype`; dt (Bb, S, di), A (di, N), B and C (Bb, S, N) f32;
// h0 (Bb, di, N) f32 or null for a zero state; y (Bb, S, di) f32; hT (Bb, di,
// N) f32, which may be h0 itself. All contiguous. Returns cudaGetLastError(),
// or -1 for a shape or type it does not take (N above 16, an empty grid).
extern "C" int rt_ssm_scan(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* h0, void* y, void* hT, int Bb,
                           int S, int di, int N, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (Bb < 1 || Bb > 65535 || S < 1 || di < 1) return -1;
    if (dtype == RT_F32)
        return launch_ssm_scan<float>(x, dt, A, B, C, h0, y, hT, Bb, S, di, N, s);
    if (dtype == RT_BF16)
        return launch_ssm_scan<bf16>(x, dt, A, B, C, h0, y, hT, Bb, S, di, N, s);
    return -1;
}
