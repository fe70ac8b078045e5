// Attention forward for Hopper: online-softmax attention with GQA, masks
// causal / local(window) / bidirectional, and a query offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd). At the serving path's shapes (a chunk of up to a
// few hundred queries over a prefix of up to 1k keys) the card's least time
// is set by the bytes of q, k, v and o, with the operations (4*D per
// unmasked pair and head, at the tensor cores' rate) close behind: what
// matters is that scores and weights never reach device memory. The TPU
// version makes the KV blocks a sequential grid axis and carries
// (m, l, acc) in scratch memory between grid steps; here one block owns one
// (batch, head, query tile), loops over the KV tiles itself and keeps
// m, l and the output tile in registers, so the scores never reach device
// memory. This first version runs the products as f32 FMA on shared-memory
// tiles (16x8 threads, each a BM/16 x 8 patch of the score tile and a
// BM/16 x D/8 patch of the output tile), which is far from either bound;
// the tensor cores are a later step. q, k, v and o are read
// and written in the model's layouts through strides, so a slot's slice of
// the KV cache is used in place; the reference's padding to block multiples
// becomes the edge masks q < S and k < T. KV tiles wholly outside the
// causal or local band are skipped: a fully masked tile leaves nothing
// behind once a later tile raises the running maximum (alpha = 0), so the
// result is the one the reference computes.
//
// The mask compares k_pos with q_pos + q_offset. With q_offset = 0 this is
// the reference kernel; with q_offset = pos0 the S queries are a prefill
// chunk at absolute positions pos0 .. pos0 + S - 1 over a cache prefix.
#include "common.cuh"

constexpr int FA_THREADS = 128;
constexpr int FA_BN = 64;        // keys per tile

struct AttnParams {
    const void* q;               // (B, S, H, D)
    const void* k;               // (B, T, KVH, D)
    const void* v;
    void* o;                     // (B, S, H, D)
    int S, T, H, KVH;
    int64_t q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh;
    int kind, window, q_offset;
    float scale;
};

template <int D, int BM>
constexpr int attn_smem_floats() {
    return (BM + FA_BN) * (D + 1) + FA_BN * D + BM * (FA_BN + 1);
}

template <typename TQ, typename TK, int D, int BM>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const AttnParams p) {
    constexpr int NT = FA_THREADS, BN = FA_BN;
    constexpr int RM = BM / 16;                    // query rows per thread
    constexpr int CN = BN / 8;                     // score columns per thread
    constexpr int DC = D / 8;                      // output columns per thread
    constexpr int LDQ = D + 1, LDP = BN + 1;
    static_assert(BM % 16 == 0 && D % 8 == 0, "unsupported tile");

    extern __shared__ float smem[];
    float* Qs = smem;                              // (BM, D + 1)
    float* Ks = Qs + BM * LDQ;                     // (BN, D + 1)
    float* Vs = Ks + BN * LDQ;                     // (BN, D)
    float* Ps = Vs + BN * D;                       // (BM, BN + 1)

    const int tid = threadIdx.x;
    const int tx = tid & 7, ty = tid >> 3;         // 8 x 16 threads
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (p.H / p.KVH);
    const int q0 = blockIdx.x * BM;
    const int S = p.S, T = p.T;

    const TQ* qb = static_cast<const TQ*>(p.q) + b * p.q_sb + h * p.q_sh;
    const TK* kb = static_cast<const TK*>(p.k) + b * p.k_sb + kvh * p.k_sh;
    const TK* vb = static_cast<const TK*>(p.v) + b * p.v_sb + kvh * p.v_sh;
    TQ* ob = static_cast<TQ*>(p.o) + b * p.o_sb + h * p.o_sh;

    load_tile<TQ, D, BM, NT>(Qs, LDQ, qb, p.q_ss, q0, S);

    float m[RM], l[RM], acc[RM][DC];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = RT_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    // keys that any query of this tile may see
    int n_lo = 0, n_hi = T;
    if (p.kind != RT_BIDIRECTIONAL) n_hi = min(T, q0 + BM + p.q_offset);
    if (p.kind == RT_LOCAL) {
        const int lo = q0 + p.q_offset - p.window + 1;
        if (lo > 0) n_lo = (lo / BN) * BN;
    }

    for (int n0 = n_lo; n0 < n_hi; n0 += BN) {
        __syncthreads();                           // the last tile is consumed
        load_tile<TK, D, BN, NT>(Ks, LDQ, kb, p.k_st, n0, T);
        load_tile<TK, D, BN, NT>(Vs, D, vb, p.v_st, n0, T);
        __syncthreads();

        float s[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float qv[RM], kv[CN];
#pragma unroll
            for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
            for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 8 * j) * LDQ + d];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j) s[i][j] += qv[i] * kv[j];
        }

        // mask, then the online-softmax update of each row; the 8 threads
        // that share a row are neighbouring lanes of one warp
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int row = q0 + ty + 16 * i;
            const int q_pos = row + p.q_offset;
            float mx = RT_NEG_INF;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const int col = n0 + tx + 8 * j;
                bool ok = (row < S) && (col < T);
                if (p.kind != RT_BIDIRECTIONAL) ok = ok && (col <= q_pos);
                if (p.kind == RT_LOCAL) ok = ok && (col > q_pos - p.window);
                s[i][j] = ok ? s[i][j] * p.scale : RT_NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const float pr = expf(s[i][j] - m_new);
                rs += pr;
                Ps[(ty + 16 * i) * LDP + tx + 8 * j] = round_through<TK>(pr);
            }
#pragma unroll
            for (int o = 4; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int n = 0; n < BN; ++n) {
            float pv[RM], vv[DC];
#pragma unroll
            for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + n];
#pragma unroll
            for (int c = 0; c < DC; ++c) vv[c] = Vs[n * D + tx + 8 * c];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int c = 0; c < DC; ++c) acc[i][c] += pv[i] * vv[c];
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row < S) {
            const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
            for (int c = 0; c < DC; ++c)
                from_f32(round_through<TK>(acc[i][c] / denom),
                         ob + (int64_t)row * p.o_ss + tx + 8 * c);
        }
    }
}

template <typename TQ, typename TK, int D, int BM>
static int launch_attn(const AttnParams& p, int B, cudaStream_t stream) {
    constexpr int smem = attn_smem_floats<D, BM>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<TQ, TK, D, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.S + BM - 1) / BM, p.H, B);
    flash_attention_kernel<TQ, TK, D, BM><<<grid, FA_THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// Query tiles of 64 rows do more work per byte staged in shared memory; tiles
// of 32 rows give twice the blocks, which is what fills the card when
// batch x heads x S/64 is below the number of SMs (a prefill chunk of one
// sequence). The choice is made from the shapes alone.
template <typename TQ, typename TK, int D>
static int launch_attn_bm(const AttnParams& p, int B, cudaStream_t stream) {
    static int n_sm = 0;
    if (n_sm == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    const long long blocks64 = (long long)((p.S + 63) / 64) * p.H * B;
    if (blocks64 >= n_sm) return launch_attn<TQ, TK, D, 64>(p, B, stream);
    return launch_attn<TQ, TK, D, 32>(p, B, stream);
}

template <typename TQ, typename TK>
static int dispatch_attn(const AttnParams& p, int B, int D, cudaStream_t stream) {
    switch (D) {
        case 16: return launch_attn_bm<TQ, TK, 16>(p, B, stream);
        case 32: return launch_attn_bm<TQ, TK, 32>(p, B, stream);
        case 64: return launch_attn_bm<TQ, TK, 64>(p, B, stream);
        case 128: return launch_attn_bm<TQ, TK, 128>(p, B, stream);
        default: return -1;
    }
}

// q, o: (B, S, H, D) of type q_dtype; k, v: (B, T, KVH, D) of type kv_dtype
// (the same, or a bf16 cache under f32 queries); strides in elements, unit
// stride along D, every row 16-byte aligned. kind: RT_CAUSAL, RT_LOCAL
// (with window) or RT_BIDIRECTIONAL. Returns cudaGetLastError(), or -1 for
// a shape the kernel does not take.
extern "C" int rt_flash_attention(
        const void* q, const void* k, const void* v, void* o,
        int B, int S, int T, int H, int KVH, int D,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh,
        long long o_sb, long long o_ss, long long o_sh,
        int kind, int window, int q_offset, int q_dtype, int kv_dtype,
        void* stream) {
    if (KVH <= 0 || H % KVH != 0) return -1;
    if (kind != RT_CAUSAL && kind != RT_LOCAL && kind != RT_BIDIRECTIONAL) return -1;
    AttnParams p;
    p.q = q; p.k = k; p.v = v; p.o = o;
    p.S = S; p.T = T; p.H = H; p.KVH = KVH;
    p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.kind = kind; p.window = window; p.q_offset = q_offset;
    p.scale = 1.0f / sqrtf((float)D);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (q_dtype == RT_F32 && kv_dtype == RT_F32) return dispatch_attn<float, float>(p, B, D, s);
    if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) return dispatch_attn<bf16, bf16>(p, B, D, s);
    if (q_dtype == RT_F32 && kv_dtype == RT_BF16) return dispatch_attn<float, bf16>(p, B, D, s);
    return -1;
}
