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
//   * no global latency in the time loop: x, dt, B and C of TILE (32) steps
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
// That register body takes N up to 16 (N / 4 states a lane and channel).
// The Pallas kernel takes any N; at N 64 and above ceil(N / 4) states of
// two channels would spill, so above 16 states a second instantiation keeps
// 8 states a lane and widens the lane group instead: N is rounded up to NP
// = 32, 64, 128 or 256 and L = NP / 8 = 4, 8, 16 or 32 lanes share the two
// channels of a group (256 threads: 128, 64, 32 or 16 channels a block).
// The rounding is exact without a copy: the states past the real N have
// A = 0 and h0 = 0 (masked loads), and B = C = 0 in shared memory (zeroed
// once, never staged), so they stay 0 and add 0 to y; hT is written for the
// real N only. y's sum over a group's lanes is the four-step transposed sum
// of the quad and then shuffles across the quads. At NP 256 a stage holds
// 16 time steps (B and C of 32 steps would be 64 KB a stage).
//
// Beyond the Pallas kernel it takes an optional initial state h0 (Bb, di, N)
// and writes the final state hT (Bb, di, N): prefill seeds decode with it,
// and a decode step is this scan with S = 1 and h0 == hT (each thread reads
// its states before it writes them, so the two may be the same buffer). y
// is written in f32, as the model's scan returns it; the caller casts.
#include "common.cuh"

#include <initializer_list>

constexpr int SCAN_LANES = 4;                           // lanes of a group up to N 16
constexpr int SCAN_K = 2;                               // channels of one group
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WIDE_NS = 8;                         // states a lane above N 16
constexpr float SCAN_LOG2E = 1.4426950408889634f;

// N: the states of the body, exact up to 16, the rounded NP above (with the
// real count a kernel argument); L: lanes of a channel group
template <typename T, int N, int L = SCAN_LANES>
struct ScanShape {
    static constexpr int NS = (N + L - 1) / L;                     // states a lane
    static constexpr int NP = NS * L;                              // N padded
    static constexpr int GROUPS = SCAN_THREADS / L;                // groups of one block
    static constexpr int CH = GROUPS * SCAN_K;                     // channels of one block
    static constexpr int TILE = NP > 128 ? 16 : 32;                // time steps of one stage
    static constexpr int X_BYTES = TILE * CH * (int)sizeof(T);
    static constexpr int DT_BYTES = TILE * CH * 4;
    static constexpr int BC_BYTES = TILE * NP * 4;
    static constexpr int STAGE = X_BYTES + DT_BYTES + 2 * BC_BYTES;
    static constexpr int SMEM = 2 * STAGE + TILE * CH * 4;         // + y
    static_assert(L >= 4 && L <= 32 && (L & (L - 1)) == 0 && TILE % 4 == 0, "lane group");
};

// what the pointers and widths allow to move in 16-byte pieces
enum {
    SCAN_VEC_X = 1,      // x, dt and y rows: d_inner a multiple of 8, bases aligned
    SCAN_VEC_BC = 2,     // B and C: N a multiple of 4, bases aligned
    SCAN_VEC_STATE = 4,  // A, h0 and hT: a lane's states whole 16-byte pieces, bases aligned
};

// Stage the x, dt, B and C of steps [t0, t0 + nt) into one stage. With
// SCAN_VEC_X, x and dt go by 16-byte cp.async, chunks past d_inner filled
// with zeros; otherwise by plain loads. B and C (rows of n states) go by
// 16-byte cp.async with SCAN_VEC_BC, else by plain loads; the padding past
// n stays 0.
template <typename T, int N, int L>
__device__ __forceinline__ void scan_stage(unsigned char* st, const T* x, const float* dt,
                                           const float* Bm, const float* Cm, int64_t row0,
                                           int t0, int nt, int d0, int di, int n, int vec) {
    using Sh = ScanShape<T, N, L>;
    constexpr int CH = Sh::CH;
    T* sx = reinterpret_cast<T*>(st);
    float* sdt = reinterpret_cast<float*>(st + Sh::X_BYTES);
    float* sB = reinterpret_cast<float*>(st + Sh::X_BYTES + Sh::DT_BYTES);
    float* sC = sB + Sh::TILE * Sh::NP;
    if (vec & SCAN_VEC_X) {
        constexpr int XV = 16 / (int)sizeof(T), XC = CH / XV;         // x chunks a row
        constexpr int DC = CH / 4;                                     // dt chunks a row
        for (int e = threadIdx.x; e < nt * (XC + DC); e += SCAN_THREADS) {
            const int t = e / (XC + DC), c = e % (XC + DC);
            const int64_t row = (row0 + t0 + t) * di;
            if (c < XC) {
                const int d = d0 + c * XV;
                cp_async16(sx + t * CH + c * XV, x + row + (d < di ? d : 0), d < di);
            } else {
                const int d = d0 + (c - XC) * 4;
                cp_async16(sdt + t * CH + (c - XC) * 4, dt + row + (d < di ? d : 0),
                           d < di);
            }
        }
    } else {
        for (int e = threadIdx.x; e < nt * CH; e += SCAN_THREADS) {
            const int t = e / CH, c = e % CH, d = d0 + c;
            const int64_t i = (row0 + t0 + t) * di + d;
            sx[t * CH + c] = d < di ? x[i] : T(0.f);
            sdt[t * CH + c] = d < di ? dt[i] : 0.f;
        }
    }
    const int64_t bc0 = (row0 + t0) * n;
    if (vec & SCAN_VEC_BC) {
        for (int e = threadIdx.x; e < nt * n / 4; e += SCAN_THREADS) {
            const int t = e / (n / 4), c = (e % (n / 4)) * 4;
            cp_async16(sB + t * Sh::NP + c, Bm + bc0 + t * n + c, true);
            cp_async16(sC + t * Sh::NP + c, Cm + bc0 + t * n + c, true);
        }
        return;
    }
    for (int e = threadIdx.x; e < nt * n; e += SCAN_THREADS) {
        const int t = e / n, j = e % n;
        sB[t * Sh::NP + j] = Bm[bc0 + e];
        sC[t * Sh::NP + j] = Cm[bc0 + e];
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
// registers and spilled). N up to 16: the exact count, L = 4; above, the
// rounded count NP with the real one n_real (<= NP) and L = NP / 8.
template <typename T, int N, int L>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* h0,
                float* __restrict__ y, float* hT, int S, int di, int n_real, int vec) {
    using Sh = ScanShape<T, N, L>;
    constexpr int NS = Sh::NS, K = SCAN_K, CH = Sh::CH, TILE = Sh::TILE;
    const int n = N <= 16 ? N : n_real;             // states of a row of A, B, C, h
    extern __shared__ __align__(16) unsigned char scan_smem[];
    float* sy = reinterpret_cast<float*>(scan_smem + 2 * Sh::STAGE);
    const int b = blockIdx.y, d0 = blockIdx.x * CH;
    const int g = threadIdx.x / L, q = threadIdx.x % L;
    const int64_t row0 = (int64_t)b * S;

    // the padding of B and C past n is never loaded: zero it once
    if (Sh::NP != n) {
        for (int e = threadIdx.x; e < 2 * TILE * Sh::NP; e += SCAN_THREADS) {
            if (e % Sh::NP < n) continue;
#pragma unroll
            for (int s = 0; s < 2; ++s)
                reinterpret_cast<float*>(scan_smem + s * Sh::STAGE + Sh::X_BYTES +
                                         Sh::DT_BYTES)[e] = 0.f;
        }
    }
    scan_stage<T, N, L>(scan_smem, x, dt, Bm, Cm, row0, 0, min(TILE, S), d0, di, n, vec);
    cp_async_commit();

    // channel d0 + K g + k; this lane's states NS q + j; states past n
    // stay 0 (A = 0 and h0 = 0 there, B = C = 0)
    float a2[K][NS], h[K][NS];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int d = d0 + g * K + k;
        const bool live = d < di;
        const int64_t state = ((int64_t)b * di + d) * n + q * NS;
        bool loaded = false;
        if constexpr (NS % 4 == 0) {      // a lane's states in 16-byte pieces
            if (vec & SCAN_VEC_STATE) {
#pragma unroll
                for (int j = 0; j < NS; j += 4) {
                    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), hv = av;
                    if (live) {
                        av = *reinterpret_cast<const float4*>(A + (int64_t)d * n + q * NS + j);
                        if (h0 != nullptr) hv = *reinterpret_cast<const float4*>(h0 + state + j);
                    }
                    a2[k][j] = av.x; a2[k][j + 1] = av.y; a2[k][j + 2] = av.z; a2[k][j + 3] = av.w;
                    h[k][j] = hv.x; h[k][j + 1] = hv.y; h[k][j + 2] = hv.z; h[k][j + 3] = hv.w;
                }
                loaded = true;
            }
        }
        if (!loaded) {
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const bool ok = live && q * NS + j < n;
                a2[k][j] = ok ? A[(int64_t)d * n + q * NS + j] : 0.f;
                h[k][j] = (ok && h0 != nullptr) ? h0[state + j] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) a2[k][j] *= SCAN_LOG2E;
    }

    for (int t0 = 0, tile = 0; t0 < S; t0 += TILE, ++tile) {
        const int nt = min(TILE, S - t0);
        unsigned char* st = scan_smem + (tile & 1) * Sh::STAGE;
        if (t0 + TILE < S)                // the other stage was consumed last tile
            scan_stage<T, N, L>(scan_smem + ((tile + 1) & 1) * Sh::STAGE, x, dt, Bm, Cm, row0,
                                t0 + TILE, min(TILE, S - t0 - TILE), d0, di, n, vec);
        cp_async_commit();
        cp_async_wait<1>();               // this tile's copies have landed
        __syncthreads();
        const T* sx = reinterpret_cast<const T*>(st);
        const float* sdt = reinterpret_cast<const float*>(st + Sh::X_BYTES);
        const float* sB = reinterpret_cast<const float*>(st + Sh::X_BYTES + Sh::DT_BYTES);
        const float* sC = sB + TILE * Sh::NP;
        // one step: each channel's partial y over this lane's states
        auto step = [&](int t, float (&acc)[K]) {
            const float2 dv = scan_pair(sdt + t * CH + g * K);
            const float2 xv = scan_pair(sx + t * CH + g * K);
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
            // lane q of a quad gets step q % 4's sum over its quad, then
            // over the group's quads; the first quad writes the four steps
            float out[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float v[4] = {acc[0][k], acc[1][k], acc[2][k], acc[3][k]};
                out[k] = sum4_transposed(v, q & 3);
#pragma unroll
                for (int o = 4; o < L; o <<= 1) out[k] += __shfl_xor_sync(0xffffffffu, out[k], o);
            }
            if ((L == SCAN_LANES || q < 4) && t + q < nt)
                *reinterpret_cast<float2*>(sy + (t + q) * CH + g * K) =
                    make_float2(out[0], out[1]);
        }
        __syncthreads();                  // y of the tile is whole; the stage is free
        const int64_t yrow = (row0 + t0) * di;
        if (vec & SCAN_VEC_X) {
            for (int e = threadIdx.x; e < nt * CH / 4; e += SCAN_THREADS) {
                const int t = e / (CH / 4), c = (e % (CH / 4)) * 4;
                if (d0 + c < di)
                    *reinterpret_cast<float4*>(y + yrow + (int64_t)t * di + d0 + c) =
                        *reinterpret_cast<const float4*>(sy + t * CH + c);
            }
        } else {
            for (int e = threadIdx.x; e < nt * CH; e += SCAN_THREADS) {
                const int t = e / CH, c = e % CH;
                if (d0 + c < di) y[yrow + (int64_t)t * di + d0 + c] = sy[e];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int d = d0 + g * K + k;
        if (d >= di) continue;
        const int64_t state = ((int64_t)b * di + d) * n + q * NS;
        if constexpr (NS % 4 == 0) {
            if (vec & SCAN_VEC_STATE) {
#pragma unroll
                for (int j = 0; j < NS; j += 4)
                    *reinterpret_cast<float4*>(hT + state + j) =
                        make_float4(h[k][j], h[k][j + 1], h[k][j + 2], h[k][j + 3]);
                continue;
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
            if (q * NS + j < n) hT[state + j] = h[k][j];
    }
}

// the kernel for N states (N up to 16: exact; above: rounded up to N with
// the real count n), with what the pointers and widths allow to move in
// 16-byte pieces
template <typename T, int N, int L>
static int launch_scan_n(const void* x, const void* dt, const void* A, const void* B,
                         const void* C, const void* h0, void* y, void* hT, int Bb, int S,
                         int di, int n, int aligned_x, int aligned_bc, int aligned_state,
                         cudaStream_t s) {
    using Sh = ScanShape<T, N, L>;
    const int vec = (di % 8 == 0 && aligned_x ? SCAN_VEC_X : 0)
                    | (n % 4 == 0 && aligned_bc ? SCAN_VEC_BC : 0)
                    | (n == Sh::NP && Sh::NS % 4 == 0 && aligned_state ? SCAN_VEC_STATE : 0);
    constexpr int smem = Sh::SMEM;
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<T, N, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((di + Sh::CH - 1) / Sh::CH, Bb);
    ssm_scan_kernel<T, N, L><<<grid, SCAN_THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const float*>(B), static_cast<const float*>(C),
        static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT),
        S, di, n, vec);
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
    const int ax = aligned({x, dt, y}), abc = aligned({B, C}), ast = aligned({A, h0, hT});
#define SCAN_CASE(NN) \
    case NN: return launch_scan_n<T, NN, SCAN_LANES>(x, dt, A, B, C, h0, y, hT, Bb, S, di, \
                                                     NN, ax, abc, ast, s);
#define SCAN_WIDE(NP) \
    launch_scan_n<T, NP, NP / SCAN_WIDE_NS>(x, dt, A, B, C, h0, y, hT, Bb, S, di, N, ax, abc, \
                                            ast, s)
    switch (N) {
        SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
        SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
        SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
        SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
        default: break;
    }
    if (N <= 32) return SCAN_WIDE(32);
    if (N <= 64) return SCAN_WIDE(64);
    if (N <= 128) return SCAN_WIDE(128);
    if (N <= 256) return SCAN_WIDE(256);
    return -1;
#undef SCAN_WIDE
#undef SCAN_CASE
}

// x (Bb, S, di) in `dtype`; dt (Bb, S, di), A (di, N), B and C (Bb, S, N) f32;
// h0 (Bb, di, N) f32 or null for a zero state; y (Bb, S, di) f32; hT (Bb, di,
// N) f32, which may be h0 itself. All contiguous. Rows move in 16-byte
// pieces where the widths and the bases allow, else one element at a time.
// N from 1 to 16 runs its own instantiation, 17 to 256 the one of 32, 64,
// 128 or 256 states at or above it, the states between held at 0. Returns
// cudaGetLastError(), or -1 for a shape or type it does not take (N below 1
// or above 256, an empty grid).
extern "C" int rt_ssm_scan(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* h0, void* y, void* hT, int Bb,
                           int S, int di, int N, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (Bb < 1 || Bb > 65535 || S < 1 || di < 1 || N < 1) return -1;
    if (dtype == RT_F32)
        return launch_ssm_scan<float>(x, dt, A, B, C, h0, y, hT, Bb, S, di, N, s);
    if (dtype == RT_BF16)
        return launch_ssm_scan<bf16>(x, dt, A, B, C, h0, y, hT, Bb, S, di, N, s);
    return -1;
}
