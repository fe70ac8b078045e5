// Attention forward for Hopper: online-softmax attention with GQA, masks
// causal / local(window) / bidirectional, and a query offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd). The TPU version makes the KV blocks a sequential
// grid axis and carries (m, l, acc) in scratch memory between grid steps;
// here one block owns one (batch, head, query tile), loops over the KV tiles
// itself and keeps m, l and the output tile in registers, so scores and
// weights never reach device memory. q, k, v and o are read and written in
// the model's layouts through strides, so a slot's slice of the KV cache is
// used in place; the reference's padding to block multiples becomes the
// edge masks q < S and k < T.
//
// Two bodies, chosen by the queries' type (an explicit dispatch in
// rt_flash_attention, not a fallback; a failed launch raises):
//
// * bf16 q, k, v (every call of the serving path and of the prefill
//   victim): the tensor-core body, FlashAttention-2's pattern. At the
//   path's shapes (a chunk of 128 queries over up to 1k keys) the card's
//   least time is set by the bytes of q, k, v and o (1 µs), with the
//   products (4 D flops per unmasked pair and head) close behind at the
//   tensor cores' rate. What bounds the kernel is neither: it is the serial
//   walk of each block over its key tiles (on an H100, a 64-key tile costs
//   a block of four warps about 1.7 µs: one warp per scheduler waits on
//   its own mma.sync, ldmatrix and exp chains) and how few blocks a chunk
//   makes (B x H x S/64: 32 at the path's chunk on 132 SMs). The design:
//   - Four warps own 16 query rows each and keep their Q fragments in
//     registers (up to head_dim 128); S = Q Kᵀ runs on mma.sync m16n8k16
//     (bf16 in, f32 out) with K read by ldmatrix; the online softmax works
//     on the accumulator fragments in the exp2 domain (row max and sum
//     over the four lanes of a quad); P is rounded to bf16 in registers
//     (the reference casts the weights to the values' type, ROADMAP C3) and
//     the m16n8 accumulator layout is reused as the A operand of O += P V,
//     with V read by ldmatrix.trans. Scores and weights never leave registers.
//   - K and V stay bf16 in shared memory, XOR-swizzled by 16-byte chunk so
//     that ldmatrix's eight row addresses hit distinct banks, and arrive
//     by cp.async into a ring of FA_MMA_STAGES stages: the next tile is in
//     flight while tile i is computed, one barrier a tile. Only tiles that
//     straddle the causal / local band or the end of the keys run the mask
//     code.
//   - Head_dim 80 (hubert-xlarge, which the Pallas kernel is written for
//     too): a row is ten 16-byte chunks, five k-steps of Q Kᵀ and ten
//     output tiles, and the XOR swizzle of the powers of two would send
//     chunks 8 and 9 past the row's end, so the 160-byte rows have a
//     swizzle of their own that stays inside the row (swz); nothing is
//     padded to 128. The merge kernel maps 20 threads to a row, 6 rows a
//     block.
//   - Head_dim 256 (the gemma families): a warp's (16, 256) f32 output tile
//     alone takes 128 registers a thread, and the Q fragments would take 64
//     more, so the Q fragments are read from shared memory by ldmatrix at
//     each k-step instead of held, and a tile is 32 keys (16 score
//     registers, not 32), FlashAttention-2's way at this size. The block's
//     shared memory is then 96 KB, so two blocks still fit on an SM.
//   - To shorten the walk and fill the card, the key range may be split
//     over blocks (`n_splits` pieces of `chunk` keys, planned from the
//     shapes by kernels/flash_attention.py:split_plan): each split writes
//     its partial (m, l, acc) in f32 and a second small kernel merges them,
//     as flash_decode does. A query tile that only one split reaches (the
//     early tiles of a causal prompt) is written by that split directly.
//     The merge is launched as a programmatic dependent of the partial
//     kernel, so its launch overlaps the partial kernel's tail.
// * f32 queries (the tiny model, the f32 tests, f32 queries over a bf16
//   cache): the scalar FMA body on the FP32 pipes. The reference holds f32
//   to 2e-5, which neither bf16 nor TF32 tensor cores can meet, so these
//   products run exactly in f32: 16 x 8 threads, each a BM/16 x BN/8 patch
//   of the score tile and a BM/16 x D/8 patch of the output tile, operands
//   widened to f32 in shared memory. Its query tile (bm = 32 or 64) comes
//   from the same plan. At head_dim 256 a 32-query tile spilled (255
//   registers and 468 bytes of spill stores over an f32 cache, 68 over a
//   bf16 one, on sm_90a: a thread's 2 x 32 output patch and the 32 values
//   of V it reads a key), so there the query tile is 16 (one row and 32
//   output columns a thread) and the key tile 32 (four score columns):
//   84 KB of shared memory, two blocks an SM.
//
// Both skip KV tiles wholly outside the causal or local band: a fully
// masked tile leaves nothing behind once a later tile raises the running
// maximum (alpha = 0), so the result is the one the reference computes.
// The mask compares k_pos with q_pos + q_offset. With q_offset = 0 this is
// the reference kernel; with q_offset = pos0 the S queries are a prefill
// chunk at absolute positions pos0 .. pos0 + S - 1 over a cache prefix.
//
// A prefill step captured into a CUDA graph cannot bake the slot, pos0 or
// the chunk's length into its launches: it passes `offsets`, a device array
// [slot, pos0, c] written before each replay (attn_resolve). The queries are
// then a chunk padded to its bucket, the keys and values are row `slot` of
// the whole cache, T = pos0 + c of them valid; the number of splits is the
// one planned at capture, their key ranges follow from this T inside the
// kernels. A padded query sits at a position >= T and sees every valid key,
// so no row is empty; its output is written and never read.
#include "common.cuh"

constexpr int FA_THREADS = 128;
constexpr int FA_BN = 64;        // keys per tile, both bodies (32 at head_dim 256, below)
constexpr int FA_MMA_BM = 64;    // queries per block of the tensor-core body
constexpr int FA_MMA_STAGES = 2;  // K / V tiles in the cp.async ring
constexpr int FA_MAX_SPLITS = 4;
constexpr float FA_LOG2E = 1.4426950408889634f;

struct AttnParams {
    const void* q;               // (B, S, H, D)
    const void* k;               // (B, T, KVH, D)
    const void* v;
    void* o;                     // (B, S, H, D)
    float* part_m;               // (B, H, n_splits, S_pad), n_splits > 1 only
    float* part_l;
    float* part_acc;             // (B, H, n_splits, S_pad, D)
    const long long* offsets;    // device [slot, pos0, c], or null
    int kv_b0;                   // the k / v row of batch 0: the slot
    int S, T, H, KVH;
    int64_t q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh;
    int kind, window, q_offset;
    int chunk, n_splits;         // keys per split, splits (tensor-core body)
    float scale;
};

// The parameters as the kernels use them: with device offsets, the slot,
// q_offset = pos0, T = pos0 + c (at most the view's length) and the keys of
// a split, whole tiles, so that n_splits of them cover T. Every kernel of one
// call reads the same offsets and so resolves the same values.
__device__ __forceinline__ AttnParams attn_resolve(const AttnParams& in) {
    AttnParams p = in;
    if (p.offsets != nullptr) {
        const long long slot = p.offsets[0], pos0 = p.offsets[1], c = p.offsets[2];
        p.kv_b0 = (int)slot;
        p.q_offset = (int)pos0;
        p.T = (int)min((long long)p.T, pos0 + c);
        const int n_tiles = max(1, (p.T + FA_BN - 1) / FA_BN);
        p.chunk = (n_tiles + p.n_splits - 1) / p.n_splits * FA_BN;
    }
    return p;
}

// keys [n_lo, n_hi) that some query of the tile q0 .. q0 + bm - 1 may see;
// n_lo is a multiple of the tile
__device__ __forceinline__ void attn_key_range(const AttnParams& p, int q0, int bm,
                                               int& n_lo, int& n_hi) {
    n_lo = 0;
    n_hi = p.T;
    if (p.kind != RT_BIDIRECTIONAL) n_hi = min(p.T, q0 + bm + p.q_offset);
    if (p.kind == RT_LOCAL) {
        const int lo = q0 + p.q_offset - p.window + 1;
        if (lo > 0) n_lo = (lo / FA_BN) * FA_BN;
    }
}

// ---------------------------------------------------------------------- //
//  f32 queries: the FMA body                                             //
// ---------------------------------------------------------------------- //
// keys a tile of the FMA body: 32 at head_dim 256 (its query tile is 16)
template <int D> __host__ __device__ constexpr int attn_fma_bn() { return D > 128 ? 32 : FA_BN; }

template <int D, int BM>
constexpr int attn_smem_floats() {
    constexpr int BN = attn_fma_bn<D>();
    return (BM + BN) * (D + 1) + BN * D + BM * (BN + 1);
}

template <typename TQ, typename TK, int D, int BM>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const AttnParams p_in) {
    const AttnParams p = attn_resolve(p_in);
    constexpr int NT = FA_THREADS, BN = attn_fma_bn<D>();
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
    const TK* kb = static_cast<const TK*>(p.k) + (b + p.kv_b0) * p.k_sb + kvh * p.k_sh;
    const TK* vb = static_cast<const TK*>(p.v) + (b + p.kv_b0) * p.v_sb + kvh * p.v_sh;
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

    int n_lo, n_hi;
    attn_key_range(p, q0, BM, n_lo, n_hi);

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

// ---------------------------------------------------------------------- //
//  bf16: the tensor-core body                                            //
// ---------------------------------------------------------------------- //
// Element offset of 16-byte chunk c of row r in a (rows, D) bf16 tile whose
// chunks are XOR-swizzled: the eight rows 8m .. 8m + 7 that one ldmatrix
// matrix reads at the same logical chunk land in eight distinct 16-byte
// bank groups, for every D from 16 (two chunks a row) to 256 (thirty-two: a
// row is four 128-byte lines, and the XOR of the chunk's low three bits with
// the row's keeps eight rows on eight bank groups). At head_dim 80 a row is
// ten chunks (160 bytes), and that XOR would reach chunks 10..15, past the
// row: there chunk c of row 8m + i starts on bank group (2 i + c) mod 8,
// so the rows pair up on four groups, and flipping the chunk's low bit on
// rows 4..7 moves those to the other four. c ^ 1 stays inside the row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
    constexpr int CH = D / 8;                      // chunks per row
    if constexpr ((CH & (CH - 1)) != 0) {
        static_assert(CH % 8 == 2, "a swizzle for this head_dim");
        return r * D + ((c ^ ((r >> 2) & 1)) << 3);
    } else {
        constexpr int RPL = CH >= 8 ? 1 : 8 / CH;  // rows per 128-byte line
        constexpr int MASK = (CH >= 8 ? 8 : CH) - 1;
        return r * D + ((c ^ ((r / RPL) & MASK)) << 3);
    }
}

// keys a tile of the tensor-core body: at head_dim 256 the output tile
// takes 128 registers a thread, so the tile is 32 keys (and Q is read from
// shared memory at each k-step, below)
template <int D> __host__ __device__ constexpr int attn_mma_bn() { return D > 128 ? 32 : FA_BN; }

template <int D>
constexpr int attn_mma_smem_bytes() {
    return (FA_MMA_BM + 2 * FA_MMA_STAGES * attn_mma_bn<D>()) * D * (int)sizeof(bf16);
}

// the keys [s_lo, s_hi) of split `split` that the query tile starting at q0
// may see (empty when s_lo >= s_hi); whole tiles, since chunk is a multiple
// of FA_BN (and so of the 32-key tile at head_dim 256)
__device__ __forceinline__ void attn_split_range(const AttnParams& p, int q0, int split,
                                                 int& s_lo, int& s_hi) {
    int n_lo, n_hi;
    attn_key_range(p, q0, FA_MMA_BM, n_lo, n_hi);
    s_lo = max(n_lo, split * p.chunk);
    s_hi = min(n_hi, split * p.chunk + p.chunk);
}

// the splits [first, last) that hold a key the query tile at q0 may see
__device__ __forceinline__ void attn_used_splits(const AttnParams& p, int q0,
                                                 int& first, int& last) {
    int n_lo, n_hi;
    attn_key_range(p, q0, FA_MMA_BM, n_lo, n_hi);
    first = n_lo / p.chunk;
    last = n_hi > n_lo ? min(p.n_splits, (n_hi + p.chunk - 1) / p.chunk) : first;
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_mma_kernel(const AttnParams p_in) {
    const AttnParams p = attn_resolve(p_in);
    constexpr int BM = FA_MMA_BM, BN = attn_mma_bn<D>(), NT = FA_THREADS;
    constexpr bool QREG = D <= 128;                // Q fragments held for the whole key loop
    constexpr int CH = D / 8;                      // 16-byte chunks per row
    constexpr int KSTEPS = D / 16;                 // k-steps of Q Kᵀ
    constexpr int NTILES = BN / 8;                 // 8-key score tiles of a warp
    constexpr int DTILES = D / 8;                  // 8-column output tiles of a warp
    static_assert(D % 16 == 0 && D <= 256 && BN % 16 == 0, "unsupported head_dim");

    extern __shared__ __align__(128) unsigned char fa_smem[];
    bf16* Qs = reinterpret_cast<bf16*>(fa_smem);  // (BM, D)
    bf16* Ks = Qs + BM * D;                        // STAGES x (BN, D)
    bf16* Vs = Ks + FA_MMA_STAGES * BN * D;        // STAGES x (BN, D)

    allow_dependents();                            // the merge may be scheduled
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
    // grid (head, query tile, batch x split), the last query tiles first:
    // under a causal mask they walk the most keys, and blocks are handed
    // out in this order, so a light tile shares an SM with a heavy one
    const int h = blockIdx.x;
    const int b = blockIdx.z / p.n_splits, split = blockIdx.z % p.n_splits;
    const int kvh = h / (p.H / p.KVH);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
    int s_lo, s_hi, first, last;
    attn_split_range(p, q0, split, s_lo, s_hi);
    attn_used_splits(p, q0, first, last);
    // a split that sees no key of this tile writes nothing: the merge skips
    // it. Without splits the block still writes its rows (zeros).
    if (p.n_splits > 1 && s_lo >= s_hi) return;
    // the only split of its tile (early causal tiles) writes the output itself
    const bool direct = last - first <= 1;
    const int n_tiles = s_hi > s_lo ? (s_hi - s_lo + BN - 1) / BN : 0;

    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* kb = static_cast<const bf16*>(p.k) + (b + p.kv_b0) * p.k_sb + kvh * p.k_sh;
    const bf16* vb = static_cast<const bf16*>(p.v) + (b + p.kv_b0) * p.v_sb + kvh * p.v_sh;

    // Q with the first K / V tile in one group, then the next STAGES - 2
    // tiles; rows past S or T are zeros
    for (int e = tid; e < BM * CH; e += NT) {
        const int r = e / CH, c = e % CH;
        const bool ok = q0 + r < p.S;
        cp_async16(Qs + swz<D>(r, c), qb + (int64_t)(ok ? q0 + r : 0) * p.q_ss + c * 8, ok);
    }
    auto load_kv = [&](int tile) {
        const int n0 = s_lo + tile * BN;
        bf16* ks = Ks + (tile % FA_MMA_STAGES) * BN * D;
        bf16* vs = Vs + (tile % FA_MMA_STAGES) * BN * D;
        for (int e = tid; e < BN * CH; e += NT) {
            const int r = e / CH, c = e % CH;
            const bool ok = n0 + r < p.T;
            const int64_t row = ok ? n0 + r : 0;
            cp_async16(ks + swz<D>(r, c), kb + row * p.k_st + c * 8, ok);
            cp_async16(vs + swz<D>(r, c), vb + row * p.v_st + c * 8, ok);
        }
    };
#pragma unroll
    for (int st = 0; st < FA_MMA_STAGES - 1; ++st) {
        if (st < n_tiles) load_kv(st);
        cp_async_commit();
    }
    cp_async_wait<FA_MMA_STAGES - 2>();            // Q has landed
    __syncthreads();

    // this warp's 16 query rows as A fragments: for the whole key loop, or
    // (head_dim 256) read again at each k-step
    const int row0 = warp * 16;
    const int q_row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8, q_chunk = lane >> 4;
    uint32_t qf[QREG ? KSTEPS : 1][4];
    if constexpr (QREG) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) ldsm_x4(qf[ks], Qs + swz<D>(q_row, 2 * ks + q_chunk));
    }

    float m[2] = {RT_NEG_INF, RT_NEG_INF}, l[2] = {0.f, 0.f};
    float acc[DTILES][4];
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
    const float scale2 = p.scale * FA_LOG2E;       // m in the exp2 domain
    const int q_pos0 = q0 + row0 + g + p.q_offset; // the rows of this lane: +0, +8
    // ldmatrix lanes: K as B (matrices: keys +0 / +8 x chunks +0 / +1),
    // V transposed as B (keys +0 / +8 x chunks +0 / +1)
    const int k_row = (lane & 7) + (lane >> 4) * 8, k_chunk = (lane >> 3) & 1;
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_chunk = lane >> 4;

    for (int i = 0; i < n_tiles; ++i) {
        cp_async_wait<FA_MMA_STAGES - 2>();        // tile i has landed ...
        __syncthreads();                           // ... for all; tile i - 1 is consumed
        if (i + FA_MMA_STAGES - 1 < n_tiles) load_kv(i + FA_MMA_STAGES - 1);
        cp_async_commit();
        const int n0 = s_lo + i * BN;
        const bf16* ks = Ks + (i % FA_MMA_STAGES) * BN * D;
        const bf16* vs = Vs + (i % FA_MMA_STAGES) * BN * D;

        float s[NTILES][4];
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            const uint32_t* qa = qf[0];
            if constexpr (QREG) {
                qa = qf[kk];
            } else {
                ldsm_x4(qf[0], Qs + swz<D>(q_row, 2 * kk + q_chunk));
            }
#pragma unroll
            for (int nt = 0; nt < NTILES; nt += 2) {
                uint32_t kf[4];
                ldsm_x4(kf, ks + swz<D>(nt * 8 + k_row, 2 * kk + k_chunk));
                mma_bf16_16816(s[nt], qa, kf[0], kf[1]);
                mma_bf16_16816(s[nt + 1], qa, kf[2], kf[3]);
            }
        }

        // the mask, on tiles that straddle the band or the end of the keys
        const bool edge = n0 + BN > p.T
            || (p.kind != RT_BIDIRECTIONAL && n0 + BN - 1 > q0 + p.q_offset)
            || (p.kind == RT_LOCAL && n0 <= q0 + BM - 1 + p.q_offset - p.window);
        if (edge) {
#pragma unroll
            for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = n0 + nt * 8 + 2 * t + (e & 1);
                    const int q_pos = q_pos0 + (e >> 1) * 8;
                    bool ok = col < p.T;
                    if (p.kind != RT_BIDIRECTIONAL) ok = ok && col <= q_pos;
                    if (p.kind == RT_LOCAL) ok = ok && col > q_pos - p.window;
                    if (!ok) s[nt][e] = -INFINITY;   // weighs exactly 0
                }
        }

        // online softmax of rows g (r = 0) and g + 8 (r = 1); the four
        // lanes of a quad hold a row's BN scores. The scale (> 0) commutes
        // with the maximum, so it is applied inside the exponent's FFMA
        // (which is why a masked score is -inf and not a large finite
        // number: the FFMA's exact product of one would not cancel m).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = RT_NEG_INF;
#pragma unroll
            for (int nt = 0; nt < NTILES; ++nt)
                mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx * scale2);
            const float alpha = fast_exp2(m[r] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
                for (int e = 2 * r; e < 2 * r + 2; ++e) {
                    s[nt][e] = fast_exp2(fmaf(s[nt][e], scale2, -m_new));
                    rs += s[nt][e];
                }
            l[r] = l[r] * alpha + rs;              // this lane's part; the quad sums at the end
            m[r] = m_new;
#pragma unroll
            for (int dt = 0; dt < DTILES; ++dt) {
                acc[dt][2 * r] *= alpha;
                acc[dt][2 * r + 1] *= alpha;
            }
        }

        // O += P V: the score tiles 2j, 2j + 1 are the A fragment of k-step j
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
            uint32_t pa[4];
            pa[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
            pa[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
            pa[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
            pa[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
            for (int dt = 0; dt < DTILES; dt += 2) {
                uint32_t vf[4];
                ldsm_x4_trans(vf, vs + swz<D>(16 * j + v_row, dt + v_chunk));
                mma_bf16_16816(acc[dt], pa, vf[0], vf[1]);
                mma_bf16_16816(acc[dt + 1], pa, vf[2], vf[3]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (direct) {
        bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = q0 + row0 + g + 8 * r;
            if (row >= p.S) continue;
            const float inv = 1.f / fmaxf(l[r], 1e-30f);
            bf16* orow = ob + (int64_t)row * p.o_ss + 2 * t;
#pragma unroll
            for (int dt = 0; dt < DTILES; ++dt)
                *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
                    __floats2bfloat162_rn(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
        }
        return;
    }
    // a split's partial (m in the exp2 domain, l, acc), rows below S
    const int s_pad = gridDim.y * BM;              // S rounded up to BM
    const int64_t base = (((int64_t)b * p.H + h) * p.n_splits + split) * s_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + row0 + g + 8 * r;
        if (row >= p.S) continue;
        if (t == 0) {
            p.part_m[base + row] = m[r];
            p.part_l[base + row] = l[r];
        }
        float* arow = p.part_acc + (base + row) * D + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt)
            *reinterpret_cast<float2*>(arow + dt * 8) = make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
}

// Merge the splits of each query row: out = sum_s w_s acc_s / max(sum_s w_s
// l_s, 1e-30), w_s = 2^(m_s - max_s m_s), over the splits that saw a key of
// the row's tile (the partial kernel's own test), rounded through bf16; a
// tile with a single such split was written by it. One thread per (row, 4
// columns), each split's loads issued before any is used; where D / 4 does
// not divide the block (20 threads a row at head_dim 80: 6 rows, threads
// 120..127 idle), the threads past the last whole row return at once.
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_merge_kernel(const AttnParams p_in) {
    const AttnParams p = attn_resolve(p_in);
    constexpr int TPR = D / 4;                     // threads a row
    constexpr int RPB = FA_THREADS / TPR;          // rows a block
    if (threadIdx.x >= RPB * TPR) return;
    const int h = blockIdx.y, b = blockIdx.z;
    const int row = blockIdx.x * RPB + threadIdx.x / TPR;
    const int d = (threadIdx.x % TPR) * 4;
    if (row >= p.S) return;
    int first, last;
    attn_used_splits(p, (row / FA_MMA_BM) * FA_MMA_BM, first, last);
    if (last - first == 1) return;                 // written by its only split
    wait_for_prerequisite();                       // the partials are written
    const int s_pad = (p.S + FA_MMA_BM - 1) / FA_MMA_BM * FA_MMA_BM;
    const int64_t base = ((int64_t)b * p.H + h) * p.n_splits * s_pad + row;
    float ms[FA_MAX_SPLITS], ls[FA_MAX_SPLITS];
    float4 as[FA_MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < FA_MAX_SPLITS; ++j) {
        const int sp = first + j;
        if (sp < last) {
            const int64_t i = base + (int64_t)sp * s_pad;
            ms[j] = p.part_m[i];
            ls[j] = p.part_l[i];
            as[j] = *reinterpret_cast<const float4*>(p.part_acc + i * D + d);
        } else {
            ms[j] = RT_NEG_INF;
            ls[j] = 0.f;
            as[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    float m = RT_NEG_INF;
#pragma unroll
    for (int j = 0; j < FA_MAX_SPLITS; ++j) m = fmaxf(m, ms[j]);
    float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < FA_MAX_SPLITS; ++j) {
        const float w = first + j < last ? exp2f(ms[j] - m) : 0.f;
        l += w * ls[j];
        a[0] += w * as[j].x; a[1] += w * as[j].y; a[2] += w * as[j].z; a[3] += w * as[j].w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + (int64_t)row * p.o_ss + d;
    *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(a[0] * inv, a[1] * inv);
    *reinterpret_cast<__nv_bfloat162*>(orow + 2) = __floats2bfloat162_rn(a[2] * inv, a[3] * inv);
}

template <int D>
static int launch_attn_mma(const AttnParams& p, int B, cudaStream_t stream) {
    constexpr int smem = attn_mma_smem_bytes<D>();
    static_assert(D % 4 == 0 && D / 4 <= FA_THREADS, "merge rows");
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int q_tiles = (p.S + FA_MMA_BM - 1) / FA_MMA_BM;
    flash_attention_mma_kernel<D><<<dim3(p.H, q_tiles, B * p.n_splits), FA_THREADS, smem,
                                    stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.n_splits == 1) return (int)err;
    constexpr int rows = FA_THREADS / (D / 4);
    err = launch_after(flash_attention_merge_kernel<D>, dim3((p.S + rows - 1) / rows, p.H, B),
                       dim3(FA_THREADS), stream, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
static int dispatch_fma(const AttnParams& p, int B, int D, int bm, cudaStream_t stream) {
    const bool wide = bm == 64;
    if (D == 256) return bm == 16 ? launch_attn<TQ, TK, 256, 16>(p, B, stream) : -1;
    if (bm != 32 && bm != 64) return -1;
    switch (D) {
        case 16: return wide ? launch_attn<TQ, TK, 16, 64>(p, B, stream) : launch_attn<TQ, TK, 16, 32>(p, B, stream);
        case 32: return wide ? launch_attn<TQ, TK, 32, 64>(p, B, stream) : launch_attn<TQ, TK, 32, 32>(p, B, stream);
        case 64: return wide ? launch_attn<TQ, TK, 64, 64>(p, B, stream) : launch_attn<TQ, TK, 64, 32>(p, B, stream);
        case 80: return wide ? launch_attn<TQ, TK, 80, 64>(p, B, stream) : launch_attn<TQ, TK, 80, 32>(p, B, stream);
        case 128: return wide ? launch_attn<TQ, TK, 128, 64>(p, B, stream) : launch_attn<TQ, TK, 128, 32>(p, B, stream);
        default: return -1;
    }
}

static int dispatch_mma(const AttnParams& p, int B, int D, cudaStream_t stream) {
    switch (D) {
        case 16: return launch_attn_mma<16>(p, B, stream);
        case 32: return launch_attn_mma<32>(p, B, stream);
        case 64: return launch_attn_mma<64>(p, B, stream);
        case 80: return launch_attn_mma<80>(p, B, stream);
        case 128: return launch_attn_mma<128>(p, B, stream);
        case 256: return launch_attn_mma<256>(p, B, stream);
        default: return -1;
    }
}

// q, o: (B, S, H, D) of type q_dtype; k, v: (B, T, KVH, D) of type kv_dtype
// (the same, or a bf16 cache under f32 queries); strides in elements, unit
// stride along D, every row 16-byte aligned. kind: RT_CAUSAL, RT_LOCAL
// (with window) or RT_BIDIRECTIONAL. The plan (kernels/flash_attention.py:
// split_plan): bf16 runs the tensor-core body with query tiles of bm = 64
// and the keys cut into n_splits pieces of `chunk` keys (a multiple of 64;
// with 1 < n_splits <= 4, part_m / part_l (B, H, n_splits, S_pad) and part_acc
// (B, H, n_splits, S_pad, D), S_pad = S rounded up to 64, are f32 scratch
// the caller allocates); f32 queries run the FMA body with bm = 32 or 64
// (16 at head_dim 256) and no split. offsets: null, or a device int64 array
// [slot, pos0, c] (q_offset 0): batch b reads k / v row slot + b, the mask takes q_offset =
// pos0 and the keys end at min(T, pos0 + c), T being the view's length (the
// cache's positions), and the plan's n_splits stays while each split's keys
// are worked out from that end. Returns cudaGetLastError(), or -1 for a shape
// or plan the kernels do not take.
extern "C" int rt_flash_attention(
        const void* q, const void* k, const void* v, void* o,
        void* part_m, void* part_l, void* part_acc, const void* offsets,
        int B, int S, int T, int H, int KVH, int D,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh,
        long long o_sb, long long o_ss, long long o_sh,
        int kind, int window, int q_offset, int q_dtype, int kv_dtype,
        int bm, int chunk, int n_splits, void* stream) {
    if (KVH <= 0 || H % KVH != 0) return -1;
    if (kind != RT_CAUSAL && kind != RT_LOCAL && kind != RT_BIDIRECTIONAL) return -1;
    if (offsets != nullptr && q_offset != 0) return -1;
    AttnParams p;
    p.q = q; p.k = k; p.v = v; p.o = o;
    p.part_m = static_cast<float*>(part_m);
    p.part_l = static_cast<float*>(part_l);
    p.part_acc = static_cast<float*>(part_acc);
    p.offsets = static_cast<const long long*>(offsets);
    p.kv_b0 = 0;
    p.S = S; p.T = T; p.H = H; p.KVH = KVH;
    p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.kind = kind; p.window = window; p.q_offset = q_offset;
    p.chunk = chunk; p.n_splits = n_splits;
    p.scale = 1.0f / sqrtf((float)D);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) {
        if (bm != FA_MMA_BM || n_splits < 1 || n_splits > FA_MAX_SPLITS
            || chunk <= 0 || chunk % FA_BN != 0
            || (long long)chunk * n_splits < T
            || (n_splits > 1 && (part_m == nullptr || part_l == nullptr || part_acc == nullptr)))
            return -1;
        return dispatch_mma(p, B, D, s);
    }
    if (n_splits != 1) return -1;
    if (q_dtype == RT_F32 && kv_dtype == RT_F32) return dispatch_fma<float, float>(p, B, D, bm, s);
    if (q_dtype == RT_F32 && kv_dtype == RT_BF16) return dispatch_fma<float, bf16>(p, B, D, bm, s);
    return -1;
}
