// The expert products of a mixture-of-experts layer over its capacity buffer:
// for each expert e, the first count[e] rows x of its (cap, d) block give
// down(act(x W_gate) * (x W_up)), with act silu (or tanh-gelu).
//
// Replaces no TPU kernel: the reference leaves the three batched products
// over the (E, cap, d) buffer to XLA, and the port ran them as three
// torch.bmm calls. Those compute every one of the E x cap rows. Where the
// capacity drops nothing (cap >= the tokens, capacity_factor >= E / k) that
// is E / k times the rows the tokens were routed to: 8x for Phi-3.5-MoE's 16
// experts, top 2. Here the kept counts lie on the device (the dispatch's
// group sizes, capped), each block reads its expert's count, and no row tile
// past it is loaded or multiplied; the grid is fixed by the shapes alone, so
// the launch captures into the steps' CUDA graphs.
//
// What bounds it on the card: at a decode step (a few rows an expert) the
// bytes of every hit expert's three weight matrices, 2.5 GB a layer at
// Phi's widths, against under 1 % of the tensor cores' time; at a 512-row
// prefill chunk (about 64 rows an expert) still the bytes, with the
// products at a fifth of that. So the weights are streamed once per row
// tile, 128 rows, by cp.async into a ring of three stages, while the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 out) work on the stage that has
// landed; two blocks share an SM, so some 64 KB of weights are in flight
// on each.
//
// Two launches, one template:
// * moe_experts_gate_up_kernel: grid (f / 64, E). A block holds 64
//   columns of W_gate and the same 64 of W_up, so that the epilogue has
//   both products of an element in one thread: h = act(g) * u, each
//   rounded to bf16 where the plain version rounds it (g and u out of their
//   products, act(g), the product), written to the (E, cap, f) buffer h.
// * moe_experts_down_kernel: grid (d / 128, E) over h and W_down.
// Eight warps a block, 2 along the rows x 4 along the columns: a warp owns
// every other 16-row tile, four of them (each multiplied only where it holds
// a kept row), and 32 columns (four 8-column tiles), 64 f32 accumulators a
// thread.
// Tiles in shared memory are XOR-swizzled by 16-byte chunk so that
// ldmatrix's eight row addresses hit distinct banks: x as the A operand
// (ldmatrix), the weights' (k, n) tiles as the B operand (ldmatrix.trans).
// K and N need only be multiples of 8 (16-byte rows): edge chunks are
// zero-filled by cp.async and edge columns are not written.
#include "common.cuh"

constexpr int ME_WM = 2, ME_WN = 4;                // warps along the rows, the columns
constexpr int ME_THREADS = 32 * ME_WM * ME_WN;
constexpr int ME_BM = 128;                         // rows of a row tile
constexpr int ME_BK = 64;                          // depth of a stage
constexpr int ME_STAGES = 3;                       // stages in the cp.async ring
constexpr int ME_MT = ME_BM / 16 / ME_WM;          // 16-row tiles of a warp
constexpr int ME_NTW = 4;                          // 8-column tiles of a warp
constexpr int ME_BN_COLS = ME_WN * ME_NTW * 8;     // weight columns a stage holds
constexpr int ME_SMEM = ME_STAGES * (ME_BM * ME_BK + ME_BK * ME_BN_COLS) * 2;

enum { ME_SILU = 0, ME_GELU = 1 };

struct MoeParams {
    const bf16* a;                 // (E, cap, K): x, or h
    const bf16* b0;                // (E, K, N): W_gate, or W_down
    const bf16* b1;                // (E, K, N): W_up, or null
    bf16* c;                       // (E, cap, N): h, or the output
    const int* count;              // (E,) kept rows, at most cap
    int cap, K, N, act;
    int64_t a_se, a_sr, b_se, b_sk, c_se, c_sr;
};

// element offset of 16-byte chunk c of row r in a tile whose rows hold
// `row` elements (at least 8 chunks): chunk c of row r lands at c ^ (r % 8),
// so the eight rows that one ldmatrix matrix reads hit eight bank groups
__device__ __forceinline__ int me_swz(int r, int c, int row) {
    return r * row + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ float me_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// act(g) * u with the plain version's roundings: g and u come out of their
// products in bf16, act(g) is computed in f32 and rounded, and so is the product
__device__ __forceinline__ float me_gated(float g, float u, int act) {
    g = me_round(g);
    u = me_round(u);
    float a;
    if (act == ME_SILU) {
        a = g / (1.f + expf(-g));
    } else {
        const float k0 = 0.7978845608028654f, k1 = 0.044715f;
        a = 0.5f * g * (1.f + tanhf(k0 * (g + k1 * g * g * g)));
    }
    return me_round(a) * u;
}

template <bool GATED>
__device__ __forceinline__ void moe_experts_body(const MoeParams& p) {
    // a stage: the row tile's (BM, BK) slice of x, then the weights' (BK,
    // BN_COLS) slice: GATED, BNM columns of W_gate then the same of W_up
    constexpr int WM = ME_WM, MT = ME_MT, NTW = ME_NTW;
    constexpr int NB = GATED ? 2 : 1;
    constexpr int BNM = ME_BN_COLS / NB;           // columns a matrix
    constexpr int A_ELEMS = ME_BM * ME_BK, B_ELEMS = ME_BK * ME_BN_COLS;
    constexpr int KCH = ME_BK / 8;                 // chunks of an x row in a stage
    constexpr int NCH = BNM / 8;                   // chunks of a weight row
    constexpr int WCOLS = NTW / NB * 8;            // a warp's columns of a matrix
    extern __shared__ __align__(128) unsigned char me_smem[];
    bf16* As = reinterpret_cast<bf16*>(me_smem);   // STAGES x (BM, BK)
    bf16* Bs = As + ME_STAGES * A_ELEMS;           // STAGES x NB x (BK, BNM)

    const int e = blockIdx.y;
    const int n0 = blockIdx.x * BNM;
    const int cnt = min(p.count[e], p.cap);
    if (cnt <= 0) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;      // warp row, warp column
    const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
    const bf16* a_e = p.a + e * p.a_se;
    const bf16* b_e0 = p.b0 + e * p.b_se;
    const bf16* b_e1 = GATED ? p.b1 + e * p.b_se : b_e0;
    bf16* c_e = p.c + e * p.c_se;
    const int n_k = (p.K + ME_BK - 1) / ME_BK;

    // ldmatrix lanes: x as A (rows +0 / +8 x chunks +0 / +1); a weight tile,
    // transposed, as B (k +0 / +8 x chunks +0 / +1)
    const int l_row = (lane & 7) + ((lane >> 3) & 1) * 8, l_chunk = lane >> 4;

    for (int m0 = 0; m0 < cnt; m0 += ME_BM) {
        const int rows = min(ME_BM, cnt - m0);
        const int rows16 = (rows + 15) & ~15;      // x rows that some warp reads
        // this warp's 16-row tiles that hold a kept row: tile i of warp row
        // wm is rows 16 (WM i + wm) .., so that the warp rows share the
        // tiles evenly however few there are
        const int my_tiles = max(0, min(MT, (rows - 16 * wm + 16 * WM - 1) / (16 * WM)));

        auto load = [&](int kt) {
            const int k0 = kt * ME_BK;
            bf16* as = As + (kt % ME_STAGES) * A_ELEMS;
            bf16* bs = Bs + (kt % ME_STAGES) * B_ELEMS;
            for (int i = tid; i < rows16 * KCH; i += ME_THREADS) {
                const int r = i / KCH, c = i % KCH;
                const bool ok = r < rows && k0 + 8 * c < p.K;
                cp_async16(as + me_swz(r, c, ME_BK),
                           a_e + (int64_t)(ok ? m0 + r : 0) * p.a_sr + (ok ? k0 + 8 * c : 0), ok);
            }
#pragma unroll
            for (int j = 0; j < NB * ME_BK * NCH / ME_THREADS; ++j) {
                const int i = tid + j * ME_THREADS;
                const int mat = i / (ME_BK * NCH), r = (i / NCH) % ME_BK, c = i % NCH;
                const bool ok = k0 + r < p.K && n0 + 8 * c < p.N;
                const bf16* src = mat ? b_e1 : b_e0;
                cp_async16(bs + mat * ME_BK * BNM + me_swz(r, c, BNM),
                           src + (ok ? (int64_t)(k0 + r) * p.b_sk + n0 + 8 * c : 0), ok);
            }
        };

        float acc[MT][NTW][4];                     // [row tile][column tile][fragment]
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
        for (int s = 0; s < ME_STAGES - 1; ++s) {
            if (s < n_k) load(s);
            cp_async_commit();
        }
        for (int kt = 0; kt < n_k; ++kt) {
            cp_async_wait<ME_STAGES - 2>();        // stage kt has landed ...
            __syncthreads();                       // ... for all; stage kt - 1 is consumed
            if (kt + ME_STAGES - 1 < n_k) load(kt + ME_STAGES - 1);
            cp_async_commit();
            if (my_tiles == 0) continue;
            const bf16* as = As + (kt % ME_STAGES) * A_ELEMS;
            const bf16* bs = Bs + (kt % ME_STAGES) * B_ELEMS;
#pragma unroll
            for (int kk = 0; kk < ME_BK / 16; ++kk) {
                // the warp's column tiles in pairs, one ldmatrix.trans of 16
                // columns each: GATED, W_gate's WCOLS columns at wn WCOLS,
                // then W_up's same columns; else W_down's NTW x 8 at wn NTW x 8
                uint32_t bf[NTW / 2][4];
#pragma unroll
                for (int q = 0; q < NTW / 2; ++q) {
                    const int mat = GATED ? (2 * q) / (NTW / 2) : 0;
                    const int chunk = wn * (WCOLS / 8) + (2 * q) % (WCOLS / 8);
                    ldsm_x4_trans(bf[q], bs + mat * ME_BK * BNM
                                         + me_swz(16 * kk + l_row, chunk + l_chunk, BNM));
                }
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    if (i >= my_tiles) break;
                    uint32_t af[4];
                    ldsm_x4(af, as + me_swz(16 * (WM * i + wm) + l_row, 2 * kk + l_chunk, ME_BK));
#pragma unroll
                    for (int q = 0; q < NTW / 2; ++q) {
                        mma_bf16_16816(acc[i][2 * q], af, bf[q][0], bf[q][1]);
                        mma_bf16_16816(acc[i][2 * q + 1], af, bf[q][2], bf[q][3]);
                    }
                }
            }
        }
        cp_async_wait<0>();
        __syncthreads();                           // the ring is free for the next row tile

        // epilogue: thread (g, t) holds rows g and g + 8 of each 16-row tile,
        // columns 2t, 2t + 1 of each 8-column tile
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            if (i >= my_tiles) break;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 16 * (WM * i + wm) + g + 8 * h;
                if (r >= rows) continue;
                bf16* crow = c_e + (int64_t)(m0 + r) * p.c_sr;
#pragma unroll
                for (int j = 0; j < NTW / NB; ++j) {
                    const int col = n0 + wn * WCOLS + 8 * j + 2 * t;
                    if (col >= p.N) continue;
                    float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
                    if constexpr (GATED) {
                        v0 = me_gated(v0, acc[i][NTW / 2 + j][2 * h], p.act);
                        v1 = me_gated(v1, acc[i][NTW / 2 + j][2 * h + 1], p.act);
                    }
                    *reinterpret_cast<__nv_bfloat162*>(crow + col) = __floats2bfloat162_rn(v0, v1);
                }
            }
        }
    }
}

// the two launches, under the names the device trace finds
__global__ void __launch_bounds__(ME_THREADS, 2) moe_experts_gate_up_kernel(const MoeParams p) {
    moe_experts_body<true>(p);
}
__global__ void __launch_bounds__(ME_THREADS, 2) moe_experts_down_kernel(const MoeParams p) {
    moe_experts_body<false>(p);
}

static int launch_me(void (*kernel)(const MoeParams), const MoeParams& p, int n_cols, int E,
                     cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           ME_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.N + n_cols - 1) / n_cols, E);
    kernel<<<grid, ME_THREADS, ME_SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

// x (E, cap, d), w_gate / w_up (E, d, f) with the same strides, w_down
// (E, f, d), count (E,) int32 on the device; writes h (E, cap, f) and out
// (E, cap, d) in the first count[e] rows of each expert. Strides in elements.
extern "C" int rt_moe_experts(const void* x, const void* w_gate, const void* w_up,
                              const void* w_down, void* h, void* out, const void* count,
                              int E, int cap, int d, int f,
                              long long x_se, long long x_sr, long long wgu_se, long long wgu_sk,
                              long long wd_se, long long wd_sk, long long h_se, long long h_sr,
                              long long o_se, long long o_sr, int act, void* stream) {
    if (E < 1 || cap < 1 || d % 8 || f % 8 || (act != ME_SILU && act != ME_GELU)) return -1;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    MoeParams p{};
    p.count = static_cast<const int*>(count);
    p.cap = cap;
    p.act = act;
    // h = act(x W_gate) * (x W_up)
    p.a = static_cast<const bf16*>(x);
    p.b0 = static_cast<const bf16*>(w_gate);
    p.b1 = static_cast<const bf16*>(w_up);
    p.c = static_cast<bf16*>(h);
    p.K = d;
    p.N = f;
    p.a_se = x_se; p.a_sr = x_sr; p.b_se = wgu_se; p.b_sk = wgu_sk; p.c_se = h_se; p.c_sr = h_sr;
    int rc = launch_me(moe_experts_gate_up_kernel, p, ME_BN_COLS / 2, E, s);
    if (rc != 0) return rc;
    // out = h W_down
    p.a = static_cast<const bf16*>(h);
    p.b0 = static_cast<const bf16*>(w_down);
    p.b1 = nullptr;
    p.c = static_cast<bf16*>(out);
    p.K = f;
    p.N = d;
    p.a_se = h_se; p.a_sr = h_sr; p.b_se = wd_se; p.b_sk = wd_sk; p.c_se = o_se; p.c_sr = o_sr;
    return launch_me(moe_experts_down_kernel, p, ME_BN_COLS, E, s);
}
