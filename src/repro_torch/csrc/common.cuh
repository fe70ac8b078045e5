// Shared device helpers for the repro_torch kernels: element types, 16-byte
// global loads/stores converted to float, warp reductions and the strided
// global -> shared tile copy. No PyTorch headers: the kernels are built by
// nvcc into a plain C library and bound with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_NEG_INF (-1e30f)

// dtype codes shared with repro_torch/kernels/_build.py
enum { RT_F32 = 0, RT_BF16 = 1 };
// mask kinds shared with repro_torch/kernels/flash_attention.py
enum { RT_CAUSAL = 0, RT_LOCAL = 1, RT_BIDIRECTIONAL = 2 };

typedef __nv_bfloat16 bf16;

template <typename T> struct VecN;                       // elements in 16 bytes
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, bf16* out) { *out = __float2bfloat16_rn(x); }

// value of x after a round trip through T (the reference casts the softmax
// weights to the value type before the weighted sum, and the weighted sum
// comes out in the value type)
template <typename T> __device__ __forceinline__ float round_through(float x);
template <> __device__ __forceinline__ float round_through<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_through<bf16>(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// 16-byte aligned load of VecN<T>::N elements, widened to float
__device__ __forceinline__ void load16(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

// 16-byte aligned store of VecN<T>::N floats, narrowed to T (round to nearest even)
__device__ __forceinline__ void store16(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// Copy rows [row0, row0 + ROWS) of a strided (n_rows, D) matrix into shared
// memory as float, `ld` floats per row. Rows at or beyond n_rows are filled
// with zeros, so a masked score never multiplies an undefined value.
// `src` and `row_stride` (in elements) must keep every row 16-byte aligned.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row_stride, int row0, int n_rows) {
    constexpr int VN = VecN<T>::N;
    constexpr int VPR = D / VN;                          // vectors per row
    constexpr int ITERS = (ROWS * VPR + NT - 1) / NT;    // vectors per thread
    static_assert(D % VN == 0, "head_dim must be a multiple of 16 bytes");
    // all of a thread's loads are issued before the first is used, so their
    // latencies overlap instead of adding up
    float f[ITERS][VN];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int e = threadIdx.x + it * NT;
        const int r = e / VPR;
        const int c = (e % VPR) * VN;
        if (e < ROWS * VPR && row0 + r < n_rows) {
            load16(src + (int64_t)(row0 + r) * row_stride + c, f[it]);
        } else {
#pragma unroll
            for (int i = 0; i < VN; ++i) f[it][i] = 0.f;
        }
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int e = threadIdx.x + it * NT;
        if (e < ROWS * VPR) {
            const int r = e / VPR;
            const int c = (e % VPR) * VN;
#pragma unroll
            for (int i = 0; i < VN; ++i) dst[r * ld + c + i] = f[it][i];
        }
    }
}
