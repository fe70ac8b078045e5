// Mamba-1 selective scan for Hopper:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = <h_t, C_t> over N,
// with the (d_inner, N) state in f32 registers that never reach device memory.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan_pallas).
// The TPU version keeps h (block_d, N) in VMEM scratch across a sequential
// grid axis of time chunks; here blocks run in parallel and in no order, so
// the time loop runs inside the kernel, over any S (the Pallas kernel's
// S % chunk == 0 is a staging rule of the TPU and is not kept).
//
// What bounds it on the card: at falcon-mamba's prefill (4 x 1024 tokens,
// d_inner 8192, N 16) it moves 10 bytes per (b, t, d) (x bf16, dt f32, y
// f32: 335 MB, about 100 us at 3.35 TB/s) and takes one exp per (b, t, d, n)
// (537 M): at 16 a clock on each SM's multi-function unit (MUFU), about
// 128 us. The exps set its bound; the design keeps the rest of each state
// step small and lets the steps overlap:
//   * the exponential is one FMUL and one MUFU.EX2 (ex2.approx.ftz of
//     dt * (A log2 e), A log2 e formed once), where expf was the ex2 plus
//     about eight FP32 instructions: a state step is 5 instructions
//     (FMUL, MUFU, FMUL, FFMA, FFMA);
//   * four lanes share a group of SCAN_K = 2 channels, each lane holding
//     ceil(N / 4) states of both, so a lane's B and C reads serve two
//     channels; y is summed over the lanes four steps at a time (three
//     shfl_xor leave step q's sum in lane q), and the four steps of a group
//     are straight-line code, so their loads and exps interleave;
//   * no global latency in the time loop: x, dt, B and C of SCAN_TILE steps
//     are staged in shared memory by cp.async, two stages deep, the next
//     tile in flight while this one is computed; B and C are read as
//     16-byte broadcasts, and y goes out through shared memory in 16-byte
//     rows after each tile;
//   * the state, A and the final state move as 16-byte accesses, a warp's
//     sixteen channels 1 KB of contiguous state (N = 16): the decode step
//     (S = 1) is little more than those bytes.
// About 7 instructions a state step remain; what holds the prefill back
// from its bound is their latency at 16 warps an SM, not the MUFU (a lane
// group with part of its exps on the FMA pipes as a polynomial was slower).
//
// Beyond the Pallas kernel it takes an optional initial state h0 (Bb, di, N)
// and writes the final state hT (Bb, di, N): prefill seeds decode with it,
// and a decode step is this scan with S = 1 and h0 == hT (each thread reads
// its states before it writes them, so the two may be the same buffer). y
// is written in f32, as the model's scan returns it; the caller casts.
#include "common.cuh"

#include <initializer_list>

constexpr int SCAN_LANES = 4;                           // lanes of one channel group
constexpr int SCAN_K = 2;                               // channels of one group
constexpr int SCAN_GROUPS = 64;                         // groups of one block
constexpr int SCAN_THREADS = SCAN_GROUPS * SCAN_LANES;
constexpr int SCAN_CH = SCAN_GROUPS * SCAN_K;           // channels of one block
constexpr int SCAN_TILE = 32;                           // time steps of one stage
constexpr float SCAN_LOG2E = 1.4426950408889634f;

template <typename T, int N>
struct ScanShape {
    static constexpr int NS = (N + SCAN_LANES - 1) / SCAN_LANES;   // states a lane
    static constexpr int NP = NS * SCAN_LANES;                     // N padded
    static constexpr int X_BYTES = SCAN_TILE * SCAN_CH * (int)sizeof(T);
    static constexpr int DT_BYTES = SCAN_TILE * SCAN_CH * 4;
    static constexpr int BC_BYTES = SCAN_TILE * NP * 4;
    static constexpr int STAGE = X_BYTES + DT_BYTES + 2 * BC_BYTES;
    static constexpr int SMEM = 2 * STAGE + SCAN_TILE * SCAN_CH * 4;  // + y
};

// what the pointers and widths allow to move in 16-byte pieces
enum {
    SCAN_VEC_X = 1,      // x, dt and y rows: d_inner a multiple of 8, bases aligned
    SCAN_VEC_BC = 2,     // B and C: N a multiple of 4, bases aligned
    SCAN_VEC_STATE = 4,  // A, h0 and hT: N = 16, bases aligned
};

// Stage the x, dt, B and C of steps [t0, t0 + nt) into one stage. With
// SCAN_VEC_X, x and dt go by 16-byte cp.async, chunks past d_inner filled
// with zeros; otherwise by plain loads. B and C go by 16-byte cp.async with
// SCAN_VEC_BC, else by plain loads; the padding past N stays 0.
template <typename T, int N>
__device__ __forceinline__ void scan_stage(unsigned char* st, const T* x, const float* dt,
                                           const float* Bm, const float* Cm, int64_t row0,
                                           int t0, int nt, int d0, int di, int vec) {
    using Sh = ScanShape<T, N>;
    T* sx = reinterpret_cast<T*>(st);
    float* sdt = reinterpret_cast<float*>(st + Sh::X_BYTES);
    float* sB = reinterpret_cast<float*>(st + Sh::X_BYTES + Sh::DT_BYTES);
    float* sC = sB + SCAN_TILE * Sh::NP;
    if (vec & SCAN_VEC_X) {
        constexpr int XV = 16 / (int)sizeof(T), XC = SCAN_CH / XV;    // x chunks a row
        constexpr int DC = SCAN_CH / 4;                                // dt chunks a row
        for (int e = threadIdx.x; e < nt * (XC + DC); e += SCAN_THREADS) {
            const int t = e / (XC + DC), c = e % (XC + DC);
            const int64_t row = (row0 + t0 + t) * di;
            if (c < XC) {
                const int d = d0 + c * XV;
                cp_async16(sx + t * SCAN_CH + c * XV, x + row + (d < di ? d : 0), d < di);
            } else {
                const int d = d0 + (c - XC) * 4;
                cp_async16(sdt + t * SCAN_CH + (c - XC) * 4, dt + row + (d < di ? d : 0),
                           d < di);
            }
        }
    } else {
        for (int e = threadIdx.x; e < nt * SCAN_CH; e += SCAN_THREADS) {
            const int t = e / SCAN_CH, c = e % SCAN_CH, d = d0 + c;
            const int64_t i = (row0 + t0 + t) * di + d;
            sx[t * SCAN_CH + c] = d < di ? x[i] : T(0.f);
            sdt[t * SCAN_CH + c] = d < di ? dt[i] : 0.f;
        }
    }
    const int64_t bc0 = (row0 + t0) * N;
    if constexpr (N % 4 == 0) {
        if (vec & SCAN_VEC_BC) {
            for (int e = threadIdx.x; e < nt * N / 4; e += SCAN_THREADS) {
                const int t = e / (N / 4), c = (e % (N / 4)) * 4;
                cp_async16(sB + t * Sh::NP + c, Bm + bc0 + t * N + c, true);
                cp_async16(sC + t * Sh::NP + c, Cm + bc0 + t * N + c, true);
            }
            return;
        }
    }
    for (int e = threadIdx.x; e < nt * N; e += SCAN_THREADS) {
        const int t = e / N, n = e % N;
        sB[t * Sh::NP + n] = Bm[bc0 + e];
        sC[t * Sh::NP + n] = Cm[bc0 + e];
    }
}

// NS floats of a padded B or C row, 16 bytes at a time where they allow
template <int NS>
__device__ __forceinline__ void scan_row(const float* p, float* v) {
    if constexpr (NS % 4 == 0) {
#pragma unroll
        for (int j = 0; j < NS; j += 4) {
            const float4 f = *reinterpret_cast<const float4*>(p + j);
            v[j] = f.x; v[j + 1] = f.y; v[j + 2] = f.z; v[j + 3] = f.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) v[j] = p[j];
    }
}

// the two channels of a group from a staged row, in one access
__device__ __forceinline__ float2 scan_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 scan_pair(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sums of the four lanes of a group for four steps: lane q gets step q's
__device__ __forceinline__ float sum4_transposed(const float (&v)[4], int q) {
    const bool hi = q & 2, lo = q & 1;
    float k0 = hi ? v[2] : v[0], k1 = hi ? v[3] : v[1];
    k0 += __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
    k1 += __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
    float keep = lo ? k1 : k0;
    keep += __shfl_xor_sync(0xffffffffu, lo ? k0 : k1, 1);
    return keep;
}

// (a minimum of one block an SM: with none, ptxas held some of the N to 64
// registers and spilled)
template <typename T, int N>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* h0,
                float* __restrict__ y, float* hT, int S, int di, int vec) {
    using Sh = ScanShape<T, N>;
    constexpr int NS = Sh::NS, K = SCAN_K;
    extern __shared__ __align__(16) unsigned char scan_smem[];
    float* sy = reinterpret_cast<float*>(scan_smem + 2 * Sh::STAGE);
    const int b = blockIdx.y, d0 = blockIdx.x * SCAN_CH;
    const int g = threadIdx.x / SCAN_LANES, q = threadIdx.x % SCAN_LANES;
    const int64_t row0 = (int64_t)b * S;

    // the padding of B and C past N is never loaded: zero it once
    if constexpr (Sh::NP != N) {
        for (int e = threadIdx.x; e < 2 * SCAN_TILE * Sh::NP; e += SCAN_THREADS) {
            if (e % Sh::NP < N) continue;
#pragma unroll
            for (int s = 0; s < 2; ++s)
                reinterpret_cast<float*>(scan_smem + s * Sh::STAGE + Sh::X_BYTES +
                                         Sh::DT_BYTES)[e] = 0.f;
        }
    }
    scan_stage<T, N>(scan_smem, x, dt, Bm, Cm, row0, 0, min(SCAN_TILE, S), d0, di, vec);
    cp_async_commit();

    // channel d0 + K g + k; this lane's states n = NS q + j; states past N
    // stay 0 (B = C = 0 there)
    float a2[K][NS], h[K][NS];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int d = d0 + g * K + k;
        const bool live = d < di;
        const int64_t state = ((int64_t)b * di + d) * N + q * NS;
        bool loaded = false;
        if constexpr (N == 16) {          // four states a lane: one 16-byte piece
            if (vec & SCAN_VEC_STATE) {
                float4 av = make_float4(0.f, 0.f, 0.f, 0.f), hv = av;
                if (live) {
                    av = *reinterpret_cast<const float4*>(A + (int64_t)d * N + q * NS);
                    if (h0 != nullptr) hv = *reinterpret_cast<const float4*>(h0 + state);
                }
                a2[k][0] = av.x; a2[k][1] = av.y; a2[k][2] = av.z; a2[k][3] = av.w;
                h[k][0] = hv.x; h[k][1] = hv.y; h[k][2] = hv.z; h[k][3] = hv.w;
                loaded = true;
            }
        }
        if (!loaded) {
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const bool ok = live && q * NS + j < N;
                a2[k][j] = ok ? A[(int64_t)d * N + q * NS + j] : 0.f;
                h[k][j] = (ok && h0 != nullptr) ? h0[state + j] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) a2[k][j] *= SCAN_LOG2E;
    }

    for (int t0 = 0, tile = 0; t0 < S; t0 += SCAN_TILE, ++tile) {
        const int nt = min(SCAN_TILE, S - t0);
        unsigned char* st = scan_smem + (tile & 1) * Sh::STAGE;
        if (t0 + SCAN_TILE < S)           // the other stage was consumed last tile
            scan_stage<T, N>(scan_smem + ((tile + 1) & 1) * Sh::STAGE, x, dt, Bm, Cm, row0,
                             t0 + SCAN_TILE, min(SCAN_TILE, S - t0 - SCAN_TILE), d0, di, vec);
        cp_async_commit();
        cp_async_wait<1>();               // this tile's copies have landed
        __syncthreads();
        const T* sx = reinterpret_cast<const T*>(st);
        const float* sdt = reinterpret_cast<const float*>(st + Sh::X_BYTES);
        const float* sB = reinterpret_cast<const float*>(st + Sh::X_BYTES + Sh::DT_BYTES);
        const float* sC = sB + SCAN_TILE * Sh::NP;
        // one step: each channel's partial y over this lane's states
        auto step = [&](int t, float (&acc)[K]) {
            const float2 dv = scan_pair(sdt + t * SCAN_CH + g * K);
            const float2 xv = scan_pair(sx + t * SCAN_CH + g * K);
            float bv[NS], cv[NS];
            scan_row<NS>(sB + t * Sh::NP + q * NS, bv);
            scan_row<NS>(sC + t * Sh::NP + q * NS, cv);
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float dk = k == 0 ? dv.x : dv.y;
                const float dx = dk * (k == 0 ? xv.x : xv.y);
                acc[k] = 0.f;
#pragma unroll
                for (int j = 0; j < NS; ++j) {
                    h[k][j] = fmaf(fast_exp2(dk * a2[k][j]), h[k][j], dx * bv[j]);
                    acc[k] = fmaf(h[k][j], cv[j], acc[k]);
                }
            }
        };
        for (int t = 0; t < nt; t += 4) {
            float acc[4][K];
            if (t + 4 <= nt) {                // straight-line: the four steps interleave
#pragma unroll
                for (int r = 0; r < 4; ++r) step(t + r, acc[r]);
            } else {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    if (t + r < nt) {
                        step(t + r, acc[r]);
                    } else {
#pragma unroll
                        for (int k = 0; k < K; ++k) acc[r][k] = 0.f;
                    }
                }
            }
            float out[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float v[4] = {acc[0][k], acc[1][k], acc[2][k], acc[3][k]};
                out[k] = sum4_transposed(v, q);
            }
            if (t + q < nt)
                *reinterpret_cast<float2*>(sy + (t + q) * SCAN_CH + g * K) =
                    make_float2(out[0], out[1]);
        }
        __syncthreads();                  // y of the tile is whole; the stage is free
        const int64_t yrow = (row0 + t0) * di;
        if (vec & SCAN_VEC_X) {
            for (int e = threadIdx.x; e < nt * SCAN_CH / 4; e += SCAN_THREADS) {
                const int t = e / (SCAN_CH / 4), c = (e % (SCAN_CH / 4)) * 4;
                if (d0 + c < di)
                    *reinterpret_cast<float4*>(y + yrow + (int64_t)t * di + d0 + c) =
                        *reinterpret_cast<const float4*>(sy + t * SCAN_CH + c);
            }
        } else {
            for (int e = threadIdx.x; e < nt * SCAN_CH; e += SCAN_THREADS) {
                const int t = e / SCAN_CH, c = e % SCAN_CH;
                if (d0 + c < di) y[yrow + (int64_t)t * di + d0 + c] = sy[e];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int d = d0 + g * K + k;
        if (d >= di) continue;
        const int64_t state = ((int64_t)b * di + d) * N + q * NS;
        if constexpr (N == 16) {
            if (vec & SCAN_VEC_STATE) {
                *reinterpret_cast<float4*>(hT + state) =
                    make_float4(h[k][0], h[k][1], h[k][2], h[k][3]);
                continue;
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
            if (q * NS + j < N) hT[state + j] = h[k][j];
    }
}

template <typename T, int N>
static int launch_scan_n(const void* x, const void* dt, const void* A, const void* B,
                         const void* C, const void* h0, void* y, void* hT, int Bb, int S,
                         int di, int vec, cudaStream_t s) {
    constexpr int smem = ScanShape<T, N>::SMEM;
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((di + SCAN_CH - 1) / SCAN_CH, Bb);
    ssm_scan_kernel<T, N><<<grid, SCAN_THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const float*>(B), static_cast<const float*>(C),
        static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT),
        S, di, vec);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_ssm_scan(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* h0, void* y, void* hT, int Bb,
                           int S, int di, int N, cudaStream_t s) {
    auto aligned = [](std::initializer_list<const void*> ps) {
        uintptr_t bits = 0;
        for (const void* p : ps) bits |= reinterpret_cast<uintptr_t>(p);
        return bits % 16 == 0;
    };
    const int vec = (di % 8 == 0 && aligned({x, dt, y}) ? SCAN_VEC_X : 0)
                    | (N % 4 == 0 && aligned({B, C}) ? SCAN_VEC_BC : 0)
                    | (N == 16 && aligned({A, h0, hT}) ? SCAN_VEC_STATE : 0);
#define SCAN_CASE(NN) \
    case NN: return launch_scan_n<T, NN>(x, dt, A, B, C, h0, y, hT, Bb, S, di, vec, s);
    switch (N) {
        SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
        SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
        SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
        SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
        default: return -1;
    }
#undef SCAN_CASE
}

// x (Bb, S, di) in `dtype`; dt (Bb, S, di), A (di, N), B and C (Bb, S, N) f32;
// h0 (Bb, di, N) f32 or null for a zero state; y (Bb, S, di) f32; hT (Bb, di,
// N) f32, which may be h0 itself. All contiguous. Rows move in 16-byte
// pieces where the widths and the bases allow, else one element at a time.
// Returns cudaGetLastError(), or -1 for a shape or type it does not take
// (N above 16, an empty grid).
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
