// Decode attention for Hopper: one query token per sequence against a KV
// cache with a valid length per sequence, the G query heads of one KV head
// together, online softmax over the keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (flash_decode_bkgd). Bound by bytes: each valid key and value row of the
// cache is read once; the operations per byte are far below the card's
// ratio. The TPU version walks the keys as a sequential grid axis with the
// running (m, l, acc) in scratch memory. Here that walk is a loop inside a
// block, and because batch x KV heads alone would leave most of the 132 SMs
// idle, the keys are split over blocks (grid x = split) and a second small
// kernel merges the partial (m, l, acc) of the splits. Keys at or beyond
// kv_len[b] are never read. The cache is read in the model's own layout
// (B, T, KVH, D) through strides: no transpose, no copy.
#include "common.cuh"

constexpr int DEC_THREADS = 128;
constexpr int DEC_BN = 64;       // keys per shared-memory tile
constexpr int DEC_MAXG = 16;     // most query heads per KV head

struct DecodeParams {
    const void* q;               // (B, H, D)
    const void* k;               // (B, T, KVH, D)
    const void* v;
    const int* kv_len;           // (B,)
    void* o;                     // (B, H, D)
    float* part_m;               // (B, KVH, n_splits, G)
    float* part_l;               // (B, KVH, n_splits, G)
    float* part_acc;             // (B, KVH, n_splits, G, D)
    int T, KVH, G, chunk, n_splits;
    int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
    float scale;
};

template <int D>
constexpr int decode_smem_floats() {
    return DEC_BN * (D + 1) + DEC_BN * D + DEC_MAXG * D + DEC_MAXG * DEC_BN
           + 3 * DEC_MAXG;
}

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_partial_kernel(const DecodeParams p) {
    constexpr int NT = DEC_THREADS, BN = DEC_BN, LDK = D + 1;
    constexpr int GSTEP = NT / D;                  // head groups served at once
    constexpr int NACC = DEC_MAXG * D / NT;        // accumulators per thread
    static_assert(NT % D == 0 && NACC >= 1, "unsupported head_dim");

    extern __shared__ float smem[];
    float* Ks = smem;                              // (BN, D + 1)
    float* Vs = Ks + BN * LDK;                     // (BN, D)
    float* Qs = Vs + BN * D;                       // (MAXG, D)
    float* Ss = Qs + DEC_MAXG * D;                 // (MAXG, BN)
    float* m_s = Ss + DEC_MAXG * BN;
    float* l_s = m_s + DEC_MAXG;
    float* alpha_s = l_s + DEC_MAXG;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int G = p.G;
    const int len = min(p.kv_len[b], p.T);
    const int t0 = split * p.chunk;
    const int t1 = min(t0 + p.chunk, len);

    const TQ* qb = static_cast<const TQ*>(p.q) + b * p.q_sb + (int64_t)kvh * G * p.q_sh;
    const TK* kb = static_cast<const TK*>(p.k) + b * p.k_sb + kvh * p.k_sh;
    const TK* vb = static_cast<const TK*>(p.v) + b * p.v_sb + kvh * p.v_sh;

    for (int e = tid; e < G * D; e += NT)
        Qs[e] = to_f32(qb[(e / D) * p.q_sh + (e % D)]);
    if (tid < G) { m_s[tid] = RT_NEG_INF; l_s[tid] = 0.f; }

    const int dcol = tid % D, gg = tid / D;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    __syncthreads();

    for (int n0 = t0; n0 < t1; n0 += BN) {
        load_tile<TK, D, BN, NT>(Ks, LDK, kb, p.k_st, n0, t1);
        load_tile<TK, D, BN, NT>(Vs, D, vb, p.v_st, n0, t1);
        __syncthreads();

        // scores of this tile: one (head, key) pair per thread and pass
        for (int e = tid; e < G * BN; e += NT) {
            const int g = e / BN, n = e % BN;
            float s = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) s += Qs[g * D + d] * Ks[n * LDK + d];
            Ss[e] = (n0 + n < t1) ? s * p.scale : RT_NEG_INF;
        }
        __syncthreads();

        // online softmax: one warp per head, two keys per lane
        for (int g = warp; g < G; g += NT / 32) {
            const float s0 = Ss[g * BN + lane], s1 = Ss[g * BN + lane + 32];
            const float m_prev = m_s[g];
            const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
            const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
            const float psum = warp_sum(p0 + p1);
            Ss[g * BN + lane] = round_through<TK>(p0);
            Ss[g * BN + lane + 32] = round_through<TK>(p1);
            __syncwarp();
            if (lane == 0) {
                const float alpha = expf(m_prev - m_new);
                alpha_s[g] = alpha;
                l_s[g] = l_s[g] * alpha + psum;
                m_s[g] = m_new;
            }
        }
        __syncthreads();

        // weighted sum of the values: one (head, column) pair per accumulator
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int g = gg + i * GSTEP;
            if (g < G) {
                float a = acc[i] * alpha_s[g];
#pragma unroll 8
                for (int n = 0; n < BN; ++n) a += Ss[g * BN + n] * Vs[n * D + dcol];
                acc[i] = a;
            }
        }
        __syncthreads();
    }

    const int64_t pbase = (((int64_t)b * p.KVH + kvh) * p.n_splits + split) * G;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
        const int g = gg + i * GSTEP;
        if (g < G) p.part_acc[(pbase + g) * D + dcol] = acc[i];
    }
    if (tid < G) {
        p.part_m[pbase + tid] = m_s[tid];
        p.part_l[pbase + tid] = l_s[tid];
    }
}

// Merge the splits: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
// w_s = exp(m_s - max_s m_s). A split that saw no valid key has m = -1e30
// and l = 0, so it drops out whenever another split saw one. The result
// passes through the values' type before it is stored in the queries' type,
// as the reference's product of value-typed weights and values does.
template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_merge_kernel(const DecodeParams p) {
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int G = p.G;
    const int64_t base = ((int64_t)b * p.KVH + kvh) * p.n_splits * G;
    TQ* ob = static_cast<TQ*>(p.o) + b * p.o_sb + (int64_t)kvh * G * p.o_sh;
    for (int e = threadIdx.x; e < G * D; e += DEC_THREADS) {
        const int g = e / D, d = e % D;
        float m = RT_NEG_INF;
        for (int s = 0; s < p.n_splits; ++s) m = fmaxf(m, p.part_m[base + s * G + g]);
        float l = 0.f, a = 0.f;
        for (int s = 0; s < p.n_splits; ++s) {
            const float w = expf(p.part_m[base + s * G + g] - m);
            l += w * p.part_l[base + s * G + g];
            a += w * p.part_acc[(base + s * G + g) * D + d];
        }
        from_f32(round_through<TK>(a / fmaxf(l, 1e-30f)), ob + g * p.o_sh + d);
    }
}

template <typename TQ, typename TK, int D>
static int launch_decode(const DecodeParams& p, int B, cudaStream_t stream) {
    constexpr int smem = decode_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<TQ, TK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    decode_partial_kernel<TQ, TK, D><<<dim3(p.n_splits, p.KVH, B), DEC_THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_merge_kernel<TQ, TK, D><<<dim3(p.KVH, B), DEC_THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
static int dispatch_decode(const DecodeParams& p, int B, int D, cudaStream_t stream) {
    switch (D) {
        case 16: return launch_decode<TQ, TK, 16>(p, B, stream);
        case 32: return launch_decode<TQ, TK, 32>(p, B, stream);
        case 64: return launch_decode<TQ, TK, 64>(p, B, stream);
        case 128: return launch_decode<TQ, TK, 128>(p, B, stream);
        default: return -1;
    }
}

// q, o: (B, H, D) of type q_dtype; k, v: (B, T, KVH, D) of type kv_dtype (the
// same, or a bf16 cache under f32 queries); strides in elements, unit stride
// along D, every k and v row 16-byte aligned. kv_len: (B,) int32 on the device.
// The keys are cut into n_splits pieces of `chunk` keys; part_* are scratch
// the caller allocates. Returns cudaGetLastError(), or -1 for a shape the
// kernels do not take.
extern "C" int rt_flash_decode(
        const void* q, const void* k, const void* v, const void* kv_len, void* o,
        void* part_m, void* part_l, void* part_acc,
        int B, int T, int H, int KVH, int D, int chunk, int n_splits,
        long long q_sb, long long q_sh,
        long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh,
        long long o_sb, long long o_sh,
        int q_dtype, int kv_dtype, void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > DEC_MAXG) return -1;
    if (chunk <= 0 || n_splits <= 0 || (long long)chunk * n_splits < T) return -1;
    DecodeParams p;
    p.q = q; p.k = k; p.v = v; p.kv_len = static_cast<const int*>(kv_len); p.o = o;
    p.part_m = static_cast<float*>(part_m);
    p.part_l = static_cast<float*>(part_l);
    p.part_acc = static_cast<float*>(part_acc);
    p.T = T; p.KVH = KVH; p.G = H / KVH; p.chunk = chunk; p.n_splits = n_splits;
    p.q_sb = q_sb; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
    p.o_sb = o_sb; p.o_sh = o_sh;
    p.scale = 1.0f / sqrtf((float)D);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (q_dtype == RT_F32 && kv_dtype == RT_F32) return dispatch_decode<float, float>(p, B, D, s);
    if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) return dispatch_decode<bf16, bf16>(p, B, D, s);
    if (q_dtype == RT_F32 && kv_dtype == RT_BF16) return dispatch_decode<float, bf16>(p, B, D, s);
    return -1;
}
