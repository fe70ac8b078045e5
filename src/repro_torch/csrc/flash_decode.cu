// Decode attention for Hopper: one query token per sequence against a KV
// cache with a valid length per sequence, the G query heads of one KV head
// together, online softmax over the keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (flash_decode_bkgd). Bound by bytes: each valid key and value row of the
// cache is read once (20 MB at the serving path's mix, 6 µs at 3.35 TB/s),
// and the operations per byte are far below the card's ratio. So the
// design is about keeping device memory busy; what is left above the bound
// is the partial kernel's ramp and tail and the second launch:
//
// * Splits. The TPU version walks the keys as a sequential grid axis with
//   the running (m, l, acc) in scratch memory. Here the keys are cut into
//   splits of about 128 (kernels/decode_attention.py:split_plan), one block
//   each over grid (split, KV head, batch), so that the longest serial walk
//   is short and a small batch still fills the SMs; a split past kv_len[b]
//   exits at once, and a second small kernel merges the partial (m, l, acc)
//   of the splits that saw a key. The merge is launched as a programmatic
//   dependent of the partial kernel, so its launch overlaps the partial
//   kernel's tail; each of its threads issues every split's loads at once.
// * Loads in flight. K and V tiles are staged in shared memory in the
//   cache's own type (bf16 on the path: half the bytes of f32 staging) by
//   cp.async 16-byte copies into a ring of DEC_STAGES stages: three tiles
//   are in flight while one is computed, and a 128-key split of a bf16
//   cache (64 KB) is requested at once. One barrier a tile. At head_dim 256
//   an f32 cache's ring of four 32-key stages would be 256 KB, over the
//   227 KB a block may have: it has two stages (128 KB).
// * Scores. A key row is held by LPR neighbouring lanes (a "slot"), each
//   with VPL values of d and the matching slice of the G queries in
//   registers; a row's dot product is reduced over those lanes by shuffles.
//   LPR is D / VPL rounded up to a power of two: at head_dim 80 a row is
//   ten 16-byte slices, and groups of ten lanes do not tile a warp, so a
//   slot is 16 lanes of which 6 hold no values (their queries are zeros,
//   they add nothing to a score and write nothing). The kernel is bound by
//   bytes, and the cache is neither padded nor copied. Each slot keeps its
//   own running (m, l, acc) over the rows it sees, so the key loop needs no
//   shared state at all; the slots are merged once at the end, by shuffles
//   within a warp and through shared memory across the four warps.
// * Head groups. A block takes at most GT query heads of its KV head (2, 8,
//   or 16 up to head_dim 128, llama3-405b's G; 16 heads' slices at D 256
//   would take a lane 256 registers). More heads a KV head (16 at D 80 and
//   256, 32 and 64 where the Pallas kernel takes them) are cut into
//   ceil(G / 8) head groups of 8, a grid axis beside the KV head: each
//   group's block reads the split's keys and values itself, so the cache
//   is read ceil(G / 8) times, the groups of one split side by side on the
//   card so that the later reads mostly find the rows in the L2 cache. The
//   merge and the partials carry all G heads.
//
// Keys at or beyond kv_len[b] are never read (cp.async writes zeros) and
// never weigh. kv_len is int32 or int64, as the caller has it. The cache is
// read in the model's own layout (B, T, KVH, D) through strides: no
// transpose, no copy. Scores are in the exp2 domain (q prescaled by
// scale * log2 e); the weights pass through the values' type before the
// weighted sum, as the reference's cast does.
#include "common.cuh"

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_STAGES = 4;    // K / V tiles in the cp.async ring
constexpr float DEC_LOG2E = 1.4426950408889634f;

struct DecodeParams {
    const void* q;               // (B, H, D)
    const void* k;               // (B, T, KVH, D)
    const void* v;
    const void* kv_len;          // (B,) int32 or int64
    int len_is_64;
    void* o;                     // (B, H, D)
    float* part_m;               // (B, KVH, n_splits, G), exp2 domain
    float* part_l;               // (B, KVH, n_splits, G)
    float* part_acc;             // (B, KVH, n_splits, G, D)
    int T, KVH, G, chunk, n_splits;
    int n_hg;                    // head groups of a KV head: ceil(G / GT)
    int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
    float scale_log2;
};

__device__ __forceinline__ int seq_len(const DecodeParams& p, int b) {
    const long long n = p.len_is_64 ? static_cast<const long long*>(p.kv_len)[b]
                                    : (long long)static_cast<const int*>(p.kv_len)[b];
    return (int)max(0LL, min(n, (long long)p.T));
}

// VPL values of T at p (16 or 8 bytes, aligned), widened to float
template <int VPL>
__device__ __forceinline__ void load_vals(const bf16* p, float* out) {
    if constexpr (VPL == 8) {
        load16(p, out);
    } else {
        static_assert(VPL == 4, "4 or 8 values a lane");
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
    }
}
template <int VPL>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
#pragma unroll
    for (int i = 0; i < VPL; i += 4) load16(p + i, out + i);
}

// The work of one lane, from the head dim, the padded group size GT (2, 8
// or 16 query heads) and the cache's type.
template <typename TK, int D, int GT>
struct DecShape {
    static constexpr int VPL = GT <= 8 ? 8 : 4;            // values of d a lane
    static constexpr int LPRV = D / VPL;                    // lanes of a row with values
    static constexpr int LPR = LPRV <= 2 ? LPRV : (LPRV <= 4 ? 4 : (LPRV <= 8 ? 8 :
                               (LPRV <= 16 ? 16 : 32)));    // lanes a key row (a slot)
    static constexpr int NSLOT = DEC_THREADS / LPR;         // rows read at once
    static constexpr int BN = NSLOT > 32 ? NSLOT : 32;      // keys a stage
    static constexpr int KPS = BN / NSLOT;                  // rows of a slot a stage
    static constexpr int KB = KPS < 32 / GT ? KPS : (32 / GT > 0 ? 32 / GT : 1);  // rows a batch
    static constexpr int EPC = 16 / (int)sizeof(TK);        // elements a 16-byte copy
    static constexpr int CPR = D / EPC;                     // copies a row
    static constexpr int STAGE = 2 * BN * D * (int)sizeof(TK);   // K and V of a stage
    static constexpr int STAGES = DEC_STAGES * STAGE > 200 * 1024 ? 2 : DEC_STAGES;
    static constexpr int RING = STAGES * STAGE;
    static constexpr int COMBINE = (2 * DEC_WARPS * GT + DEC_WARPS * GT * D) * (int)sizeof(float);
    static constexpr int SMEM = RING > COMBINE ? RING : COMBINE;
    static_assert(D % VPL == 0 && LPRV <= LPR && LPR <= 32 && (LPR & (LPR - 1)) == 0
                  && KPS * NSLOT == BN && KPS % KB == 0, "shape");
    static_assert(SMEM <= 232448, "shared memory of a block");
};

// GT 8: the grid's y axis is KV head x head group (ceil(G / 8) groups of
// 8); GT 2 and 16: it is the KV head, and the block takes all G <= GT heads
// (the groups' index math spilled the GT 16 body 8 bytes at head_dim 128)
template <typename TQ, typename TK, int D, int GT>
__global__ void __launch_bounds__(DEC_THREADS)
decode_partial_kernel(const DecodeParams p) {
    constexpr bool HG = GT == 8;
    using Sh = DecShape<TK, D, GT>;
    constexpr int VPL = Sh::VPL, LPRV = Sh::LPRV, LPR = Sh::LPR, NSLOT = Sh::NSLOT, BN = Sh::BN;
    constexpr int KPS = Sh::KPS, KB = Sh::KB, EPC = Sh::EPC, CPR = Sh::CPR;
    constexpr int STAGES = Sh::STAGES;

    extern __shared__ __align__(16) unsigned char dec_smem[];
    TK* ring = reinterpret_cast<TK*>(dec_smem);     // STAGES x (K (BN, D), V (BN, D))

    allow_dependents();                             // the merge may be scheduled
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int slot = tid / LPR, part = tid % LPR;   // row of a stage, slice of d
    // a lane past the row's slices reads slice 0 and holds zero queries
    const bool has = LPR == LPRV || part < LPRV;
    const int pc = has ? part : 0;
    const int split = blockIdx.x, b = blockIdx.z;
    const int kvh = HG ? blockIdx.y / p.n_hg : blockIdx.y;
    const int g0 = HG ? (blockIdx.y % p.n_hg) * GT : 0;     // this block's first head
    const int G = HG ? min(GT, p.G - g0) : p.G;              // and its number of heads
    const int len = seq_len(p, b);
    const int t0 = split * p.chunk;
    if (t0 >= len) return;                          // the merge does not read it
    const int t1 = min(t0 + p.chunk, len);
    const int n_tiles = (t1 - t0 + BN - 1) / BN;

    const TK* kb = static_cast<const TK*>(p.k) + b * p.k_sb + kvh * p.k_sh;
    const TK* vb = static_cast<const TK*>(p.v) + b * p.v_sb + kvh * p.v_sh;
    auto load_stage = [&](int tile) {
        TK* ks = ring + (tile % STAGES) * 2 * BN * D;
        TK* vs = ks + BN * D;
        const int n0 = t0 + tile * BN;
        for (int e = tid; e < BN * CPR; e += DEC_THREADS) {
            const int r = e / CPR, c = e % CPR;
            const bool ok = n0 + r < t1;
            const int64_t row = ok ? n0 + r : t0;
            cp_async16(ks + r * D + c * EPC, kb + row * p.k_st + c * EPC, ok);
            cp_async16(vs + r * D + c * EPC, vb + row * p.v_st + c * EPC, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_tiles) load_stage(s);
        cp_async_commit();
    }

    // the G queries' slice of d, prescaled into the exp2 domain; padded
    // heads (g >= G) are zeros and never written
    const TQ* qb = static_cast<const TQ*>(p.q) + b * p.q_sb + ((int64_t)kvh * p.G + g0) * p.q_sh;
    float qr[GT][VPL];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        if (g < G && has) {
            load_vals<VPL>(qb + g * p.q_sh + part * VPL, qr[g]);
#pragma unroll
            for (int i = 0; i < VPL; ++i) qr[g][i] *= p.scale_log2;
        } else {
#pragma unroll
            for (int i = 0; i < VPL; ++i) qr[g][i] = 0.f;
        }
    }

    float m[GT], l[GT], acc[GT][VPL];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        m[g] = RT_NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
    }

    for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait<STAGES - 2>();                // tile it has landed ...
        __syncthreads();                            // ... for all; tile it - 1 is consumed
        if (it + STAGES - 1 < n_tiles) load_stage(it + STAGES - 1);
        cp_async_commit();
        const TK* ks = ring + (it % STAGES) * 2 * BN * D;
        const TK* vs = ks + BN * D;
        const int n0 = t0 + it * BN;
#pragma unroll
        for (int j0 = 0; j0 < KPS; j0 += KB) {
            float s[KB][GT];
#pragma unroll
            for (int j = 0; j < KB; ++j) {
                float kv[VPL];
                load_vals<VPL>(ks + (slot + (j0 + j) * NSLOT) * D + pc * VPL, kv);
#pragma unroll
                for (int g = 0; g < GT; ++g) {
                    float a = 0.f;
#pragma unroll
                    for (int i = 0; i < VPL; ++i) a += qr[g][i] * kv[i];
                    s[j][g] = a;
                }
            }
#pragma unroll
            for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
                for (int j = 0; j < KB; ++j)
#pragma unroll
                    for (int g = 0; g < GT; ++g)
                        s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
#pragma unroll
            for (int j = 0; j < KB; ++j)
                if (n0 + slot + (j0 + j) * NSLOT >= t1)
#pragma unroll
                    for (int g = 0; g < GT; ++g) s[j][g] = -INFINITY;   // weighs nothing
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                float mx = s[0][g];
#pragma unroll
                for (int j = 1; j < KB; ++j) mx = fmaxf(mx, s[j][g]);
                const float m_new = fmaxf(m[g], mx);
                const float alpha = exp2f(m[g] - m_new);
                m[g] = m_new;
                l[g] *= alpha;
#pragma unroll
                for (int i = 0; i < VPL; ++i) acc[g][i] *= alpha;
#pragma unroll
                for (int j = 0; j < KB; ++j) {
                    const float pr = exp2f(s[j][g] - m_new);
                    l[g] += pr;
                    s[j][g] = round_through<TK>(pr);
                }
            }
#pragma unroll
            for (int j = 0; j < KB; ++j) {
                float vv[VPL];
                load_vals<VPL>(vs + (slot + (j0 + j) * NSLOT) * D + pc * VPL, vv);
#pragma unroll
                for (int g = 0; g < GT; ++g)
#pragma unroll
                    for (int i = 0; i < VPL; ++i) acc[g][i] += s[j][g] * vv[i];
            }
        }
    }

    // merge the slots of a warp: lanes part, part + LPR, ... hold one slice
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
            const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
            const float m_new = fmaxf(m[g], mo);
            const float wa = exp2f(m[g] - m_new), wb = exp2f(mo - m_new);
            m[g] = m_new;
            l[g] = l[g] * wa + lo * wb;
#pragma unroll
            for (int i = 0; i < VPL; ++i)
                acc[g][i] = acc[g][i] * wa + __shfl_xor_sync(0xffffffffu, acc[g][i], o) * wb;
        }

    // ... and the four warps through shared memory, over the ring
    cp_async_wait<0>();
    __syncthreads();
    float* cm = reinterpret_cast<float*>(dec_smem);  // (WARPS, GT)
    float* cl = cm + DEC_WARPS * GT;                  // (WARPS, GT)
    float* ca = cl + DEC_WARPS * GT;                  // (WARPS, GT, D)
    if (lane < LPRV) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            if (lane == 0) {
                cm[warp * GT + g] = m[g];
                cl[warp * GT + g] = l[g];
            }
#pragma unroll
            for (int i = 0; i < VPL; ++i) ca[(warp * GT + g) * D + part * VPL + i] = acc[g][i];
        }
    }
    __syncthreads();
    const int64_t pbase = (((int64_t)b * p.KVH + kvh) * p.n_splits + split) * p.G + g0;
    for (int e = tid; e < G * D; e += DEC_THREADS) {
        const int g = e / D, d = e % D;
        float mm = RT_NEG_INF;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) mm = fmaxf(mm, cm[w * GT + g]);
        float ll = 0.f, aa = 0.f;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) {
            const float wt = exp2f(cm[w * GT + g] - mm);
            ll += wt * cl[w * GT + g];
            aa += wt * ca[(w * GT + g) * D + d];
        }
        p.part_acc[(pbase + g) * D + d] = aa;
        if (d == 0) {
            p.part_m[pbase + g] = mm;
            p.part_l[pbase + g] = ll;
        }
    }
}

// Merge the splits: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
// w_s = 2^(m_s - max_s m_s), over the splits that saw a key (those below
// kv_len[b]). A split whose keys all lie past kv_len was never written
// and drops out as m = -1e30, l = 0 would. One thread per (head, 4
// columns); the splits are read sixteen at a time, all sixteen loads issued
// before any is used (and before kv_len is known), and folded in with a
// running maximum. The result
// passes through the values' type before it is stored in the queries' type,
// as the reference's product of value-typed weights and values does.
constexpr int DEC_MERGE_BATCH = 16;

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_merge_kernel(const DecodeParams p) {
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int G = p.G;
    const int64_t base = ((int64_t)b * p.KVH + kvh) * p.n_splits * G;
    TQ* ob = static_cast<TQ*>(p.o) + b * p.o_sb + (int64_t)kvh * G * p.o_sh;
    const int len = seq_len(p, b);
    wait_for_prerequisite();                        // the partials are written
    for (int e = threadIdx.x; e < G * D / 4; e += DEC_THREADS) {
        const int g = e / (D / 4), d = (e % (D / 4)) * 4;
        float m = RT_NEG_INF, l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s0 = 0; s0 < p.n_splits; s0 += DEC_MERGE_BATCH) {
            // the loads do not wait for kv_len: a split it rules out (never
            // written) is dropped after its load
            float ms[DEC_MERGE_BATCH], ls[DEC_MERGE_BATCH];
            float4 as[DEC_MERGE_BATCH];
#pragma unroll
            for (int j = 0; j < DEC_MERGE_BATCH; ++j) {
                const int64_t i = base + (int64_t)(s0 + j) * G + g;
                if (s0 + j < p.n_splits) {
                    ms[j] = p.part_m[i];
                    ls[j] = p.part_l[i];
                    as[j] = *reinterpret_cast<const float4*>(p.part_acc + i * D + d);
                }
            }
#pragma unroll
            for (int j = 0; j < DEC_MERGE_BATCH; ++j)
                if (s0 + j >= p.n_splits || (s0 + j) * p.chunk >= len) {
                    ms[j] = RT_NEG_INF;
                    ls[j] = 0.f;
                    as[j] = make_float4(0.f, 0.f, 0.f, 0.f);
                }
            float mb = m;
#pragma unroll
            for (int j = 0; j < DEC_MERGE_BATCH; ++j) mb = fmaxf(mb, ms[j]);
            const float alpha = exp2f(m - mb);
            l *= alpha;
#pragma unroll
            for (int c = 0; c < 4; ++c) a[c] *= alpha;
#pragma unroll
            for (int j = 0; j < DEC_MERGE_BATCH; ++j) {
                const float w = exp2f(ms[j] - mb);
                l += w * ls[j];
                a[0] += w * as[j].x; a[1] += w * as[j].y; a[2] += w * as[j].z; a[3] += w * as[j].w;
            }
            m = mb;
        }
        const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
        for (int c = 0; c < 4; ++c)
            from_f32(round_through<TK>(a[c] * inv), ob + g * p.o_sh + d + c);
    }
}

template <typename TQ, typename TK, int D, int GT>
static int launch_decode(const DecodeParams& p_in, int B, cudaStream_t stream) {
    constexpr int smem = DecShape<TK, D, GT>::SMEM;
    DecodeParams p = p_in;
    p.n_hg = (p.G + GT - 1) / GT;                   // 1 but for GT 8
    cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<TQ, TK, D, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    decode_partial_kernel<TQ, TK, D, GT><<<dim3(p.n_splits, p.KVH * p.n_hg, B), DEC_THREADS,
                                           smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_after(decode_merge_kernel<TQ, TK, D>, dim3(p.KVH, B), dim3(DEC_THREADS),
                       stream, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The group size GT of a block: 2, 8, or 16 where a lane has room for 16
// heads' slices (head_dim up to 128, but not 80, whose slots stay at 16
// lanes). More heads than that run in head groups of 8. An f32 cache at
// head_dim 80 takes GT 8 for G <= 2 too (its GT 2 body spilled 8 bytes).
template <typename TQ, typename TK, int D>
static int dispatch_group(const DecodeParams& p, int B, cudaStream_t stream) {
    constexpr int MAXG = (D > 128 || D == 80) ? 8 : 16;
    if constexpr (!(D == 80 && sizeof(TK) == 4)) {
        if (p.G <= 2) return launch_decode<TQ, TK, D, 2>(p, B, stream);
    }
    if constexpr (MAXG > 8) {
        if (p.G > 8 && p.G <= MAXG) return launch_decode<TQ, TK, D, 16>(p, B, stream);
    }
    return launch_decode<TQ, TK, D, 8>(p, B, stream);
}

template <typename TQ, typename TK>
static int dispatch_decode(const DecodeParams& p, int B, int D, cudaStream_t stream) {
    switch (D) {
        case 16: return dispatch_group<TQ, TK, 16>(p, B, stream);
        case 32: return dispatch_group<TQ, TK, 32>(p, B, stream);
        case 64: return dispatch_group<TQ, TK, 64>(p, B, stream);
        case 80: return dispatch_group<TQ, TK, 80>(p, B, stream);
        case 128: return dispatch_group<TQ, TK, 128>(p, B, stream);
        case 256: return dispatch_group<TQ, TK, 256>(p, B, stream);
        default: return -1;
    }
}

// q, o: (B, H, D) of type q_dtype; k, v: (B, T, KVH, D) of type kv_dtype (the
// same, or a bf16 cache under f32 queries); strides in elements, unit stride
// along D, every q, k and v row 16-byte aligned. kv_len: (B,) on the device,
// int32 (len_is_64 = 0) or int64 (1). The keys are cut into n_splits pieces
// of `chunk` keys (a multiple of 64); part_* are scratch the caller
// allocates. Any number of query heads a KV head. Returns
// cudaGetLastError(), or -1 for a shape the kernels do not take (a head_dim
// other than 16, 32, 64, 80, 128 and 256).
extern "C" int rt_flash_decode(
        const void* q, const void* k, const void* v, const void* kv_len, void* o,
        void* part_m, void* part_l, void* part_acc,
        int B, int T, int H, int KVH, int D, int chunk, int n_splits,
        long long q_sb, long long q_sh,
        long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh,
        long long o_sb, long long o_sh,
        int q_dtype, int kv_dtype, int len_is_64, void* stream) {
    if (KVH <= 0 || H <= 0 || H % KVH != 0) return -1;
    if (chunk <= 0 || chunk % 64 != 0 || n_splits <= 0 || (long long)chunk * n_splits < T)
        return -1;
    DecodeParams p;
    p.q = q; p.k = k; p.v = v; p.kv_len = kv_len; p.len_is_64 = len_is_64 != 0; p.o = o;
    p.part_m = static_cast<float*>(part_m);
    p.part_l = static_cast<float*>(part_l);
    p.part_acc = static_cast<float*>(part_acc);
    p.T = T; p.KVH = KVH; p.G = H / KVH; p.chunk = chunk; p.n_splits = n_splits; p.n_hg = 1;
    p.q_sb = q_sb; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
    p.o_sb = o_sb; p.o_sh = o_sh;
    p.scale_log2 = DEC_LOG2E / sqrtf((float)D);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (q_dtype == RT_F32 && kv_dtype == RT_F32) return dispatch_decode<float, float>(p, B, D, s);
    if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) return dispatch_decode<bf16, bf16>(p, B, D, s);
    if (q_dtype == RT_F32 && kv_dtype == RT_BF16) return dispatch_decode<float, bf16>(p, B, D, s);
    return -1;
}
