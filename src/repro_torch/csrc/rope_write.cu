// The attention prologue of a decode or extend step in one launch: per-head
// qk-norm where the model has it, split-half RoPE at each row's position,
// the rotated q written out, and the rotated k row and the v row written
// into the KV cache.
//
// Replaces no TPU kernel: the reference leaves this chain to XLA, which
// fuses it. Run eagerly it is some fifty small elementwise launches a layer
// (casts, products, the cos / sin tables, concatenations, index writes),
// so that a captured decode step spends more time launching them than
// computing. Bytes bound it: each value is read once and written once
// (qwen3-1.7b's 64-row decode 1.05 MB a layer, 0.31 us at 3.35 TB/s; a
// 512-row chunk 8.4 MB, 2.5 us), and in a decode step the one launch costs
// more than that, so what the design fights is latency: a block of eight
// warps owns eight heads of one row (a token; q heads, then k, then v),
// one head a warp, each lane the two elements of a rotation pair per 32
// pairs, so that every head's loads, reduction and stores run side by side
// (qwen3-1.7b's 64-row decode: 256 blocks). The block builds its row's cos
// / sin table in shared memory while its warps' loads are in flight.
//
// The numbers are the eager chain's: every product and sum that the eager
// chain rounds to f32 is rounded here too (__fmul_rn / __fadd_rn keep nvcc
// from contracting a pair into an FMA); the norm's output and its product
// with the scale are rounded to the activations' type, the scale first
// rounded to that type; cosf / sinf at full precision on pos * inv_freq;
// the rotated values rounded to the activations' type, then to the
// cache's. Only the order of the norm's sum of squares differs.
#include "common.cuh"

constexpr int RW_WARPS = 8;            // heads a block
constexpr int RW_THREADS = 32 * RW_WARPS;
constexpr int RW_MAX_HALF = 128;      // head_dim 256
constexpr int RW_PAIRS = RW_MAX_HALF / 32;

struct RopeWriteParams {
    const void* q;
    const void* k;
    const void* v;
    void* q_out;
    void* cache_k;
    void* cache_v;
    const void* pos;          // (N,) int32 or int64, stride pos_stride
    const int64_t* rows;      // (N,) flat cache rows (slot * smax + position), or null
    void* kv_len;             // (N,) min(pos + 1, smax) in pos's type, or null
    const void* q_norm;       // (D,) scales, or null: no qk-norm
    const void* k_norm;
    const float* inv_freq;    // (D / 2,)
    int H, KVH, D, n_slots, smax;
    int64_t q_row, q_head, k_row, k_head, v_row, v_head, o_row, o_head;
    int64_t ck_slot, ck_seq, ck_head, cv_slot, cv_seq, cv_head, pos_stride;
    float eps;
    int ring, norm_bf16, pos64;
};

__device__ __forceinline__ float load_scale(const void* w, int bf, int j) {
    return bf ? __bfloat162float(static_cast<const bf16*>(w)[j])
              : static_cast<const float*>(w)[j];
}

// One head's values after the norm (where w is set): lane's pairs i hold
// (x[j], x[j + half]), j = lane + 32 i, and the scales rounded to T (as
// .to(q.dtype) rounds them). The norm's output and its product with the
// scale are each rounded to T, as the eager chain rounds them.
template <typename T>
__device__ __forceinline__ void norm_head(float (&a)[RW_PAIRS], float (&b)[RW_PAIRS],
                                          const float (&wa)[RW_PAIRS],
                                          const float (&wb)[RW_PAIRS], const RopeWriteParams& p) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < RW_PAIRS; ++i) ss += a[i] * a[i] + b[i] * b[i];
    // mean(x^2) as the eager reduction takes it: the sum times 1 / D
    const float var = __fmul_rn(warp_sum(ss), __fdiv_rn(1.f, (float)p.D));
    const float inv = rsqrtf(__fadd_rn(var, p.eps));
#pragma unroll
    for (int i = 0; i < RW_PAIRS; ++i) {
        a[i] = round_through<T>(__fmul_rn(round_through<T>(__fmul_rn(a[i], inv)), wa[i]));
        b[i] = round_through<T>(__fmul_rn(round_through<T>(__fmul_rn(b[i], inv)), wb[i]));
    }
}

// The split-half rotation in f32 with the eager chain's roundings (two
// products, then their difference or sum), rounded to T and stored as O.
template <typename T, typename O>
__device__ __forceinline__ void rotate_store(const float (&a)[RW_PAIRS], const float (&b)[RW_PAIRS],
                                             const float* cs, const float* sn, O* out,
                                             int half, int lane) {
#pragma unroll
    for (int i = 0; i < RW_PAIRS; ++i) {
        const int j = lane + 32 * i;
        if (j < half) {
            const float c = cs[j], s = sn[j];
            const float o1 = __fsub_rn(__fmul_rn(a[i], c), __fmul_rn(b[i], s));
            const float o2 = __fadd_rn(__fmul_rn(a[i], s), __fmul_rn(b[i], c));
            from_f32(round_through<T>(o1), out + j);
            from_f32(round_through<T>(o2), out + j + half);
        }
    }
}

template <typename T, typename C>
__global__ void __launch_bounds__(RW_THREADS) rope_write_kernel(const RopeWriteParams p) {
    __shared__ float cs[RW_MAX_HALF], sn[RW_MAX_HALF];
    const int n = blockIdx.x;
    const int job = blockIdx.y * RW_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
    const int half = p.D / 2;
    const int64_t pi = (int64_t)n * p.pos_stride;
    const int64_t pos = p.pos64 ? static_cast<const int64_t*>(p.pos)[pi]
                                : (int64_t)static_cast<const int32_t*>(p.pos)[pi];
    int64_t slot, at;
    if (p.rows != nullptr) {                 // extend: a chunk's flat rows
        slot = p.rows[n] / p.smax;
        at = p.rows[n] % p.smax;
    } else {                                 // decode: row n of the batch
        slot = n;
        at = p.ring ? pos % p.smax : pos;
        if (p.kv_len != nullptr && blockIdx.y == 0 && threadIdx.x == 0) {
            const int64_t len = pos + 1 < p.smax ? pos + 1 : p.smax;
            if (p.pos64) static_cast<int64_t*>(p.kv_len)[n] = len;
            else static_cast<int32_t*>(p.kv_len)[n] = (int32_t)len;
        }
    }
    // a row outside the cache stops the kernel, as the eager index write's
    // bounds check does: a decode past its cache must not attend without its row
    if (slot < 0 || slot >= p.n_slots || at < 0 || at >= p.smax) __trap();
    // this warp's head: a q head, a k head or a v head of the row, or none
    const bool is_q = job < p.H, is_k = !is_q && job < p.H + p.KVH;
    const bool is_v = !is_q && !is_k && job < p.H + 2 * p.KVH;
    const bool active = is_q || is_k || is_v;
    if (is_v) {                              // v: a copy, cast to the cache's type
        const int h = job - p.H - p.KVH;
        const T* src = static_cast<const T*>(p.v) + n * p.v_row + h * p.v_head;
        C* dst = static_cast<C*>(p.cache_v) + slot * p.cv_slot + at * p.cv_seq + h * p.cv_head;
        for (int j = lane; j < p.D; j += 32) from_f32(to_f32(src[j]), dst + j);
    }
    // q and k heads: the values and scales loaded before the table is built
    const T* x = is_q ? static_cast<const T*>(p.q) + n * p.q_row + job * p.q_head
                      : static_cast<const T*>(p.k) + n * p.k_row + (job - p.H) * p.k_head;
    const void* w = is_q ? p.q_norm : p.k_norm;
    float a[RW_PAIRS], b[RW_PAIRS], wa[RW_PAIRS], wb[RW_PAIRS];
#pragma unroll
    for (int i = 0; i < RW_PAIRS; ++i) {
        const int j = lane + 32 * i;
        const bool on = (is_q || is_k) && j < half;
        a[i] = on ? to_f32(x[j]) : 0.f;
        b[i] = on ? to_f32(x[j + half]) : 0.f;
        wa[i] = on && w != nullptr ? round_through<T>(load_scale(w, p.norm_bf16, j)) : 0.f;
        wb[i] = on && w != nullptr ? round_through<T>(load_scale(w, p.norm_bf16, j + half)) : 0.f;
    }
    // the row's cos / sin table, shared by the block's heads: cosf / sinf at
    // full precision of pos * inv_freq, as the eager chain's tables
    const float posf = (float)pos;
    for (int i = threadIdx.x; i < half; i += RW_THREADS) {
        const float angle = __fmul_rn(posf, p.inv_freq[i]);
        cs[i] = cosf(angle);
        sn[i] = sinf(angle);
    }
    __syncthreads();
    if (!active || is_v) return;
    if (w != nullptr) norm_head<T>(a, b, wa, wb, p);
    if (is_q) {
        rotate_store<T>(a, b, cs, sn, static_cast<T*>(p.q_out) + n * p.o_row + job * p.o_head,
                        half, lane);
    } else {
        const int h = job - p.H;
        rotate_store<T>(a, b, cs, sn, static_cast<C*>(p.cache_k) + slot * p.ck_slot
                        + at * p.ck_seq + h * p.ck_head, half, lane);
    }
}

template <typename T, typename C>
static int launch_rope_write(const RopeWriteParams& p, int n, cudaStream_t stream) {
    const dim3 grid(n, (p.H + 2 * p.KVH + RW_WARPS - 1) / RW_WARPS);
    rope_write_kernel<T, C><<<grid, RW_THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

// q (N, H, D), k and v (N, KVH, D) in x_dtype, rows strided by *_row and
// heads by *_head (elements, unit stride along D); q_out likewise. The
// caches (n_slots, smax, KVH, D) in cache_dtype, strided by *_slot, *_seq,
// *_head; cache_dtype x_dtype's or, under f32 activations, bf16. Row n goes
// to cache row rows[n] (slot * smax + position) where rows is given, else to
// slot n at pos[n] (pos[n] % smax where ring), and then kv_len[n] =
// min(pos[n] + 1, smax) where kv_len is given; a row outside the cache
// traps. q_norm and
// k_norm (D,) f32 or bf16 (norm_dtype), or both null. Returns
// cudaGetLastError(), or -1 for a shape the kernel does not take.
extern "C" int rt_rope_write(const void* q, const void* k, const void* v, void* q_out,
                             void* cache_k, void* cache_v, const void* pos,
                             const void* rows, void* kv_len, const void* q_norm,
                             const void* k_norm, const void* inv_freq,
                             int n, int h, int kvh, int d, int n_slots, int smax,
                             long long q_row, long long q_head, long long k_row,
                             long long k_head, long long v_row, long long v_head,
                             long long o_row, long long o_head, long long ck_slot,
                             long long ck_seq, long long ck_head, long long cv_slot,
                             long long cv_seq, long long cv_head, long long pos_stride,
                             float eps, int ring, int x_dtype, int cache_dtype,
                             int norm_dtype, int pos_is_64, void* stream) {
    if (d <= 0 || d % 2 != 0 || d / 2 > RW_MAX_HALF || h <= 0 || kvh <= 0 || smax <= 0)
        return -1;
    if ((q_norm == nullptr) != (k_norm == nullptr)) return -1;
    if (n == 0) return 0;
    RopeWriteParams p;
    p.q = q; p.k = k; p.v = v; p.q_out = q_out; p.cache_k = cache_k; p.cache_v = cache_v;
    p.pos = pos; p.rows = static_cast<const int64_t*>(rows); p.kv_len = kv_len;
    p.q_norm = q_norm; p.k_norm = k_norm; p.inv_freq = static_cast<const float*>(inv_freq);
    p.H = h; p.KVH = kvh; p.D = d; p.n_slots = n_slots; p.smax = smax;
    p.q_row = q_row; p.q_head = q_head; p.k_row = k_row; p.k_head = k_head;
    p.v_row = v_row; p.v_head = v_head; p.o_row = o_row; p.o_head = o_head;
    p.ck_slot = ck_slot; p.ck_seq = ck_seq; p.ck_head = ck_head;
    p.cv_slot = cv_slot; p.cv_seq = cv_seq; p.cv_head = cv_head; p.pos_stride = pos_stride;
    p.eps = eps; p.ring = ring; p.norm_bf16 = norm_dtype == RT_BF16; p.pos64 = pos_is_64;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == RT_BF16 && cache_dtype == RT_BF16) return launch_rope_write<bf16, bf16>(p, n, s);
    if (x_dtype == RT_F32 && cache_dtype == RT_F32) return launch_rope_write<float, float>(p, n, s);
    if (x_dtype == RT_F32 && cache_dtype == RT_BF16) return launch_rope_write<float, bf16>(p, n, s);
    return -1;
}
