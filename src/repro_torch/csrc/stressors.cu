// The four resource stressors for Hopper: the paper's §4.1 benchmark suite
// (a compute kernel, an ILP sweep on the FP32 pipes, a copy kernel and a
// shared-memory bank-conflict kernel), each loading one resource of the card
// at a share set by the number of blocks its caller launches. Every block
// keeps its SM busy for the whole dispatch, so ceil(lambda * SMs) blocks
// occupy lambda of the card's SMs.
//
// Each kernel computes exactly the function of its TPU twin (and of the
// oracle in src/repro/kernels/ref.py), so the caller can check its output.
#include "common.cuh"

// --------------------------------------------------------------------- //
//  stress_mxu                                                            //
// --------------------------------------------------------------------- //
// Replaces src/repro/kernels/stressors.py:_mxu_kernel / stress_mxu. Per
// tile, `iters` times c <- c @ b, then c <- c / max(max|c|, 1); the output
// is c in the input type. One block owns one 128 x 128 tile for the whole
// loop, so a dispatch of n tiles holds n SMs.
//
// bf16 (what the calibration drives): bound by the tensor cores, 2 * 128^3
// FLOPs an iteration, about 0.56 us at one SM's share of 989 TFLOP/s. The
// products run on wgmma m64n128k16 (bf16 in, f32 out), the only way to the
// card's full tensor-core rate. Two warpgroups each own 64 rows of c, and
// c never leaves their registers: the f32 accumulator of one product is,
// fragment for fragment, the A operand of the next (columns 16s..16s+15 of
// c are k-slice s of the next product), so it is scaled and rounded to
// bf16 (cvt.rn.bf16x2, as the TPU's MXU takes its operand at default
// precision) in place. b is written once into shared memory, transposed
// to K-major in the 128-byte swizzle that the B descriptor names. Per
// iteration a warpgroup waits for its product, takes its threads' max (a
// tree of eight chains) and its warps' (one redux.sync), exchanges the
// eight warps' maxima through a double-buffered red[2][8] behind one
// barrier, converts all eight k-slices and issues the next product into
// the same accumulator.
//
// The block stays within 144 registers a thread (36 K of an SM's 64 K), so
// that a victim's blocks still fit on the SMs it holds (one block of the
// tensor-core attention body, 220 registers x 128 threads, fits exactly)
// and the stressor shares them as the other three do. Converting slice
// s + 1 while the product of slice s runs hides the conversion (0.86
// against 0.93 us an iteration on an H100), but it needs a second
// accumulator: 230 registers a thread, which leaves no victim block room,
// so the mxu axis then measures SMs withheld, not tensor cores shared.
//
// f32: the reference test holds f32 to 1e-4, which TF32 (about 1e-3 per
// product) cannot meet, so the same loop runs exactly in FFMA: each thread
// owns an 8 x 8 block of c spread over the tile (rows ty + 16 i, columns
// tx + 16 j), b and c in shared memory with an odd row length, so that both
// operand reads are free of bank conflicts. Bound by the FP32 pipes.
//
// Both scale c by one reciprocal of max(max|c|, 1) per iteration instead
// of dividing each element (within an f32 ulp of the reference's c / m): a
// division is about ten instructions, and 64 of them per thread cost more
// issue slots than the products themselves.
constexpr int MXU_T = 128;
constexpr int MXU_THREADS = 256;          // f32: 16 x 16 threads; bf16: two warpgroups
constexpr int MXU_WARPS = MXU_THREADS / 32;
constexpr int MXU_LD_F32 = MXU_T + 1;     // floats per shared row (odd: no conflicts)
constexpr int MXU_SMEM_F32 = 2 * MXU_T * MXU_LD_F32 * 4;
constexpr int MXU_B_KBLOCK = MXU_T * 128;                  // bytes of 64 k for all n
constexpr int MXU_SMEM_BF16 = 2 * MXU_B_KBLOCK + 1024;     // b, and slack to align it

// max over the block of every thread's v; the first barrier also orders
// every read of the tile in this iteration before any write of the next
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red[w]);
    __syncthreads();
    return m;
}

__global__ void __launch_bounds__(MXU_THREADS)
stress_mxu_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int iters) {
    extern __shared__ float mxu_f32_smem[];
    float* cs = mxu_f32_smem;                    // c, row-major
    float* bs = mxu_f32_smem + MXU_T * MXU_LD_F32;   // b, row-major
    __shared__ float red[MXU_THREADS / 32];
    const int64_t tile = (int64_t)blockIdx.x * MXU_T * MXU_T;
    for (int e = threadIdx.x; e < MXU_T * MXU_T; e += MXU_THREADS) {
        const int r = e / MXU_T, c = e % MXU_T;
        cs[r * MXU_LD_F32 + c] = a[tile + e];
        bs[r * MXU_LD_F32 + c] = b[e];
    }
    __syncthreads();
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][8];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < MXU_T; ++k) {
            float av[8], bv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) av[i] = cs[(ty + 16 * i) * MXU_LD_F32 + k];
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = bs[k * MXU_LD_F32 + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(acc[i][j]));
        const float inv = 1.f / fmaxf(block_max<MXU_THREADS>(m, red), 1.f);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                cs[(ty + 16 * i) * MXU_LD_F32 + tx + 16 * j] = acc[i][j] * inv;
        __syncthreads();
    }
    for (int e = threadIdx.x; e < MXU_T * MXU_T; e += MXU_THREADS)
        out[tile + e] = cs[(e / MXU_T) * MXU_LD_F32 + e % MXU_T];
}

// byte offset of b[k][n] in bᵀ (n rows of k), K-major in the 128-byte
// swizzle: two blocks of 64 k, each n rows of 128 bytes in 8-row atoms
__device__ __forceinline__ int mxu_b_offset(int k, int n) {
    const int kk = k & 63;
    return (k >> 6) * MXU_B_KBLOCK + n * 128 + ((((kk >> 3) ^ (n & 7)) << 4) | ((kk & 7) << 1));
}

// the B descriptor of k-slice s (16 values of k) from that of slice 0
__device__ __forceinline__ uint64_t mxu_b_desc(uint64_t desc0, int s) {
    return desc0 + (uint64_t)((((s >> 2) * MXU_B_KBLOCK) + (s & 3) * 32) >> 4);
}

// max |c[i]| over a thread's accumulator, as a tree of eight chains
template <int R>
__device__ __forceinline__ float max_abs(const float (&c)[R]) {
    float m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = fabsf(c[i]);
#pragma unroll
    for (int i = 8; i < R; ++i) m[i % 8] = fmaxf(m[i % 8], fabsf(c[i]));
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) m[i] = fmaxf(m[i], m[i + w]);
    return m[0];
}

// 1 / max(max|c|, 1) over the tile: the thread's 64 values, the warp's in
// one redux.sync on the bits (which order non-negative floats as integers),
// then the eight warps' through red[parity], behind one barrier. The two
// halves of red alternate, so a warp that runs ahead writes the other half
// while the rest still read this one.
__device__ __forceinline__ float mxu_inv_scale(const float (&c)[64],
                                               float (&red)[2][MXU_WARPS], int parity) {
    float m = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(max_abs(c))));
    if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = m;
    __syncthreads();
    const float4 lo = *reinterpret_cast<const float4*>(&red[parity][0]);
    const float4 hi = *reinterpret_cast<const float4*>(&red[parity][4]);
    m = fmaxf(fmaxf(fmaxf(lo.x, hi.x), fmaxf(lo.y, hi.y)),
              fmaxf(fmaxf(lo.z, hi.z), fmaxf(lo.w, hi.w)));
    return 1.f / fmaxf(m, 1.f);
}

// k-slice s of the next A operand: columns 16s..16s+15 of c, scaled and
// rounded to bf16 (accumulator n-tiles 2s and 2s + 1)
__device__ __forceinline__ void mxu_to_a(const float (&c)[64], uint32_t (&a)[32], int s,
                                         float inv) {
    a[4 * s + 0] = pack_bf16x2(c[8 * s + 0] * inv, c[8 * s + 1] * inv);
    a[4 * s + 1] = pack_bf16x2(c[8 * s + 2] * inv, c[8 * s + 3] * inv);
    a[4 * s + 2] = pack_bf16x2(c[8 * s + 4] * inv, c[8 * s + 5] * inv);
    a[4 * s + 3] = pack_bf16x2(c[8 * s + 6] * inv, c[8 * s + 7] * inv);
}

// wait for the product in c and leave it, scaled, in the A registers
__device__ __forceinline__ void mxu_scale_to_a(float (&c)[64], uint32_t (&a)[32],
                                               float (&red)[2][MXU_WARPS], int parity) {
    wgmma_wait<0>();
    wgmma_fence_operand(c);
    const float inv = mxu_inv_scale(c, red, parity);
#pragma unroll
    for (int s = 0; s < 8; ++s) mxu_to_a(c, a, s, inv);
}

// c = a b, k-slice by k-slice, on the tensor cores (asynchronous)
__device__ __forceinline__ void mxu_issue(float (&c)[64], const uint32_t (&a)[32],
                                          uint64_t desc0) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
        wgmma_m64n128k16_rs(c, &a[4 * s], mxu_b_desc(desc0, s), s > 0);
    wgmma_commit();
    wgmma_fence_operand(c);
}

__global__ void __maxnreg__(144)     // room for a victim block beside it
stress_mxu_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                       bf16* __restrict__ out, int iters) {
    extern __shared__ __align__(1024) unsigned char mxu_bf16_smem[];
    __shared__ __align__(16) float red[2][MXU_WARPS];
    const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(mxu_bf16_smem));
    unsigned char* bs = mxu_bf16_smem + ((1024 - (raw & 1023)) & 1023);
    for (int e = threadIdx.x; e < MXU_T * MXU_T; e += MXU_THREADS)
        *reinterpret_cast<bf16*>(bs + mxu_b_offset(e / MXU_T, e % MXU_T)) = b[e];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for wgmma's reads
    __syncthreads();
    // warp w (of either warpgroup) holds rows 16w + g and 16w + g + 8
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
    const int64_t tile = (int64_t)blockIdx.x * MXU_T * MXU_T;
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a + tile);
    uint32_t af[32];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            af[4 * s + q] = a32[((r0 + 8 * (q & 1)) * MXU_T + 16 * s + 8 * (q >> 1) + c0) / 2];
    }
    const uint64_t desc0 = wgmma_desc_sw128(bs);
    if (iters > 0) {
        float c[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) c[i] = 0.f;
        for (int it = 1; ; ++it) {      // one issue site: with two, ptxas serialises
            mxu_issue(c, af, desc0);
            mxu_scale_to_a(c, af, red, it & 1);
            if (it == iters) break;
        }
    }
    uint32_t* o32 = reinterpret_cast<uint32_t*>(out + tile);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            o32[((r0 + 8 * (q & 1)) * MXU_T + 16 * s + 8 * (q >> 1) + c0) / 2] = af[4 * s + q];
    }
}

// a: (n_tiles, T, T), b: (T, T), out like a, all contiguous. Only T = 128.
extern "C" int rt_stress_mxu(const void* a, const void* b, void* out, int n_tiles,
                             int T, int iters, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T != MXU_T || n_tiles <= 0 || iters < 0) return -1;
    if (dtype == RT_F32) {
        const cudaError_t err = cudaFuncSetAttribute(
            stress_mxu_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MXU_SMEM_F32);
        if (err != cudaSuccess) return (int)err;
        stress_mxu_f32_kernel<<<n_tiles, MXU_THREADS, MXU_SMEM_F32, s>>>(
            static_cast<const float*>(a), static_cast<const float*>(b),
            static_cast<float*>(out), iters);
    } else if (dtype == RT_BF16) {
        stress_mxu_bf16_kernel<<<n_tiles, MXU_THREADS, MXU_SMEM_BF16, s>>>(
            static_cast<const bf16*>(a), static_cast<const bf16*>(b),
            static_cast<bf16*>(out), iters);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------------- //
//  stress_vpu                                                            //
// --------------------------------------------------------------------- //
// Replaces src/repro/kernels/stressors.py:_vpu_kernel / stress_vpu. Per
// element, `ilp` independent chains acc_i <- acc_i * 1.000001 + 0.5 from
// x + i, `iters` steps, output (sum_i acc_i) / (4 ilp). One block per
// 256-row block of the reference's grid; a thread walks its elements one
// after the other, and for each runs the ILP chains side by side.
//
// Bound by the FP32 pipes' latency, and that is the point (the paper's
// S1..S4 ILP sweep): the chains are template-unrolled registers, each step
// one FFMA, so the SASS holds exactly `ilp` independent FFMA chains per
// element. With eight warps on an SM (two per scheduler) and a 4-cycle
// FFMA latency, ilp = 1 fills half of each scheduler's FFMA slots and
// ilp >= 2 fills them all. The element loop is not unrolled, so chains of
// two elements are never interleaved into more ILP than asked for. x and
// out are f32 or bf16 (T), the chains f32 whatever T is, as the Pallas
// kernel casts x to f32 and the result back to x's type.
constexpr int VPU_THREADS = 256;

template <typename T, int ILP>
__global__ void __launch_bounds__(VPU_THREADS)
stress_vpu_kernel(const T* __restrict__ x, T* __restrict__ out,
                  int64_t n, int64_t block_elems, int iters) {
    const int64_t begin = (int64_t)blockIdx.x * block_elems;
    const int64_t end = min(begin + block_elems, n);
#pragma unroll 1
    for (int64_t e = begin + threadIdx.x; e < end; e += VPU_THREADS) {
        const float xv = to_f32(x[e]);
        float acc[ILP];
#pragma unroll
        for (int i = 0; i < ILP; ++i) acc[i] = xv + (float)i;
#pragma unroll 8
        for (int it = 0; it < iters; ++it) {
#pragma unroll
            for (int i = 0; i < ILP; ++i) acc[i] = fmaf(acc[i], 1.000001f, 0.5f);
        }
        float s = acc[0];
#pragma unroll
        for (int i = 1; i < ILP; ++i) s += acc[i];
        from_f32(s / (float)(ILP * 4), out + e);
    }
}

template <typename T>
static int launch_vpu(const void* x, void* out, long long n, long long block_elems,
                      int n_blocks, int iters, int ilp, cudaStream_t s) {
    const T* xp = static_cast<const T*>(x);
    T* op = static_cast<T*>(out);
#define VPU_LAUNCH(L) \
    stress_vpu_kernel<T, L><<<n_blocks, VPU_THREADS, 0, s>>>(xp, op, n, block_elems, iters)
    switch (ilp) {
        case 1: VPU_LAUNCH(1); break;
        case 2: VPU_LAUNCH(2); break;
        case 3: VPU_LAUNCH(3); break;
        case 4: VPU_LAUNCH(4); break;
        case 5: VPU_LAUNCH(5); break;
        case 6: VPU_LAUNCH(6); break;
        case 7: VPU_LAUNCH(7); break;
        case 8: VPU_LAUNCH(8); break;
        default: return -1;
    }
#undef VPU_LAUNCH
    return (int)cudaGetLastError();
}

// x, out: n contiguous elements of `dtype` (RT_F32 or RT_BF16); block b
// takes elements [b * block_elems, ...).
extern "C" int rt_stress_vpu(const void* x, void* out, long long n,
                             long long block_elems, int n_blocks, int iters,
                             int ilp, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0 || block_elems <= 0 || n_blocks <= 0 || iters < 0) return -1;
    if (dtype == RT_F32) return launch_vpu<float>(x, out, n, block_elems, n_blocks, iters, ilp, s);
    if (dtype == RT_BF16) return launch_vpu<bf16>(x, out, n, block_elems, n_blocks, iters, ilp, s);
    return -1;
}

// --------------------------------------------------------------------- //
//  stress_hbm                                                            //
// --------------------------------------------------------------------- //
// Replaces src/repro/kernels/stressors.py:_copy_kernel / stress_hbm: a
// streaming copy, out == x bit for bit for any element type, so the kernel
// copies bytes. Bound by device-memory bytes. Each block streams one
// contiguous share of the buffer with 16-byte loads, four in flight per
// thread (32 KB per SM of 512 threads), which is what one SM needs to pull
// its share of the card's bandwidth; `passes` repeats the copy, so a small
// working set (the cache-polluter probes) still makes a dispatch long
// enough to overlap a victim. No __restrict__: every pass must reload.
constexpr int HBM_THREADS = 512;
constexpr int HBM_UNROLL = 4;

__global__ void __launch_bounds__(HBM_THREADS)
stress_hbm_kernel(const uint4* x, uint4* out, const unsigned char* xb,
                  unsigned char* ob, int64_t n16, int64_t per_block,
                  int64_t nbytes, int passes) {
    const int64_t begin = (int64_t)blockIdx.x * per_block;
    const int64_t end = min(begin + per_block, n16);
    for (int p = 0; p < passes; ++p) {
        for (int64_t i = begin + threadIdx.x; i < end; i += HBM_THREADS * HBM_UNROLL) {
            uint4 v[HBM_UNROLL];
#pragma unroll
            for (int u = 0; u < HBM_UNROLL; ++u) {
                const int64_t j = i + (int64_t)u * HBM_THREADS;
                if (j < end) v[u] = x[j];
            }
#pragma unroll
            for (int u = 0; u < HBM_UNROLL; ++u) {
                const int64_t j = i + (int64_t)u * HBM_THREADS;
                if (j < end) out[j] = v[u];
            }
        }
        if (blockIdx.x == gridDim.x - 1)                   // the ragged tail
            for (int64_t j = n16 * 16 + threadIdx.x; j < nbytes; j += HBM_THREADS)
                ob[j] = xb[j];
    }
}

// x, out: nbytes contiguous, both 16-byte aligned; n_blocks shares.
extern "C" int rt_stress_hbm(const void* x, void* out, long long nbytes,
                             int n_blocks, int passes, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nbytes <= 0 || n_blocks <= 0 || passes < 1) return -1;
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return -1;
    const int64_t n16 = nbytes / 16;
    const int64_t per_block = (n16 + n_blocks - 1) / n_blocks;
    stress_hbm_kernel<<<n_blocks, HBM_THREADS, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out),
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
        n16, per_block, nbytes, passes);
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------------- //
//  stress_vmem                                                           //
// --------------------------------------------------------------------- //
// Replaces src/repro/kernels/stressors.py:_vmem_kernel / stress_vmem. Per
// block of br = min(512, R) rows, `iters` times y <- y + roll(y, stride)
// along the rows, output y / 2^iters. The TPU's sublane roll becomes what a
// GPU has for real: shared-memory bank conflicts.
//
// A 512-row block of 128 f32 columns (256 KB) does not fit the 227 KB a
// block may have, but the columns are independent, so a CUDA block takes
// the br rows of a strip of 32 columns, column-major in shared memory
// (column length br + 1, so that loading a row of the strip is conflict
// free), double-buffered: each iteration reads one buffer and writes the
// other, with one barrier between iterations. Bound by the shared-memory
// pipe, and by how far `stride` serialises it: lane j of a warp takes row
// (j s + floor(j s / br)) mod br of its column (a permutation of the rows
// when s divides br), and the bank of a row is its index mod 32, so a
// warp's 32 reads fall into 32 / s banks: stride 1 is conflict free, 8 is
// 8-way, and 32 is 16-way (the wrap term moves lanes 16..31 one row on, to
// a second bank). Strides that do not divide br take the rows in order.
//
// The kernel halves y on every iteration instead of dividing by 2^iters at
// the end: scaling by a power of two commutes with rounding, so the result
// is bit for bit the reference's wherever the reference stays finite
// (iters < 128 for inputs of order one), and it stays finite beyond. x and
// out are f32 or bf16 (T); y is f32 in shared memory whatever T is, as the
// Pallas kernel computes in f32, so the bank conflicts are the same.
constexpr int VMEM_W = 32;
constexpr int VMEM_MAX_ROWS = 512;
constexpr int VMEM_THREADS = VMEM_MAX_ROWS;    // one thread per row of the block

template <typename T>
__global__ void __launch_bounds__(VMEM_THREADS)
stress_vmem_kernel(const T* __restrict__ x, T* __restrict__ out, int C,
                   int br, int iters, int shift, int permute) {
    extern __shared__ float vmem_smem[];
    const int ld = br + 1;
    const int buf_floats = VMEM_W * ld;               // two buffers of this
    const int strips = C / VMEM_W;
    const int64_t row0 = (int64_t)(blockIdx.x / strips) * br;
    const int col0 = (blockIdx.x % strips) * VMEM_W;
    const int n = br * VMEM_W;
    for (int e = threadIdx.x; e < n; e += VMEM_THREADS) {     // coalesced rows
        const int r = e / VMEM_W, c = e % VMEM_W;
        vmem_smem[c * ld + r] = to_f32(x[(row0 + r) * C + col0 + c]);
    }
    __syncthreads();
    // one row slot per thread (br <= 512 threads), the same for every
    // column and iteration: the row and its roll partner are computed once
    const int j = threadIdx.x;
    int r = j, rp = j;
    if (j < br) {
        r = permute ? (int)(((int64_t)j * shift + (int64_t)j * shift / br) % br) : j;
        rp = r >= shift ? r - shift : r - shift + br;
    }
    int cur = 0;
    for (int it = 0; it < iters; ++it) {
        const float* src = vmem_smem + cur * buf_floats;
        float* dst = vmem_smem + (cur ^ 1) * buf_floats;
        if (j < br) {
#pragma unroll 8
            for (int c = 0; c < VMEM_W; ++c)
                dst[c * ld + r] = (src[c * ld + r] + src[c * ld + rp]) * 0.5f;
        }
        __syncthreads();
        cur ^= 1;
    }
    for (int e = threadIdx.x; e < n; e += VMEM_THREADS) {
        const int r = e / VMEM_W, c = e % VMEM_W;
        from_f32(vmem_smem[cur * buf_floats + c * ld + r], out + (row0 + r) * C + col0 + c);
    }
}

template <typename T>
static int launch_vmem(const void* x, void* out, int R, int C, int br, int iters,
                       int shift, int permute, cudaStream_t s) {
    const int smem = 2 * VMEM_W * (br + 1) * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        stress_vmem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (R / br) * (C / VMEM_W);
    stress_vmem_kernel<T><<<blocks, VMEM_THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), C, br, iters, shift, permute);
    return (int)cudaGetLastError();
}

// x, out: (R, C) contiguous, of `dtype` (RT_F32 or RT_BF16); br divides R,
// C a multiple of 32.
extern "C" int rt_stress_vmem(const void* x, void* out, int R, int C, int br,
                              int iters, int stride, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (R <= 0 || br <= 0 || br > VMEM_MAX_ROWS || R % br || C <= 0 || C % VMEM_W
        || iters < 0)
        return -1;
    const int shift = ((stride % br) + br) % br;
    const int permute = shift > 0 && br % shift == 0;
    if (dtype == RT_F32) return launch_vmem<float>(x, out, R, C, br, iters, shift, permute, s);
    if (dtype == RT_BF16) return launch_vmem<bf16>(x, out, R, C, br, iters, shift, permute, s);
    return -1;
}
