// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale, computed in
// f32 and cast back to the type of x.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm_pallas).
// Bound by bytes: every element of x is read once and of y written once,
// with a handful of operations per element. So one block owns one row,
// reads it with 16-byte loads, keeps it in registers between the sum of
// squares and the scaling (x is never read twice), and writes with 16-byte
// stores. The TPU version pads the rows to a block multiple; here the grid
// is over the real rows.
#include "common.cuh"

constexpr int RMS_THREADS = 128;

template <typename T, int NV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int d, int64_t x_stride, int64_t y_stride,
               float eps) {
    constexpr int VN = VecN<T>::N;
    const T* xr = x + (int64_t)blockIdx.x * x_stride;
    T* yr = y + (int64_t)blockIdx.x * y_stride;
    const int nvec = d / VN;

    float v[NV][VN];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int j = threadIdx.x + i * RMS_THREADS;
        if (j < nvec) {
            load16(xr + j * VN, v[i]);
#pragma unroll
            for (int k = 0; k < VN; ++k) ss += v[i][k] * v[i][k];
        }
    }

    __shared__ float red[RMS_THREADS / 32];
    ss = warp_sum(ss);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < RMS_THREADS / 32; ++w) total += red[w];
    const float inv = rsqrtf(total / (float)d + eps);

#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int j = threadIdx.x + i * RMS_THREADS;
        if (j < nvec) {
            float sc[VN], out[VN];
#pragma unroll
            for (int k = 0; k < VN; k += 4) load16(scale + j * VN + k, sc + k);
#pragma unroll
            for (int k = 0; k < VN; ++k) out[k] = v[i][k] * inv * sc[k];
            store16(yr + j * VN, out);
        }
    }
}

template <typename T>
static int launch_rmsnorm(const void* x, const void* scale, void* y, int rows,
                          int d, int64_t xs, int64_t ys, float eps,
                          cudaStream_t stream) {
    constexpr int VN = VecN<T>::N;
    if (d <= 0 || d % VN != 0) return -1;
    const int per_thread = (d / VN + RMS_THREADS - 1) / RMS_THREADS;
    const T* xp = static_cast<const T*>(x);
    const float* sp = static_cast<const float*>(scale);
    T* yp = static_cast<T*>(y);
#define RMS_LAUNCH(NV)                                                       \
    rmsnorm_kernel<T, NV><<<rows, RMS_THREADS, 0, stream>>>(xp, sp, yp, d,  \
                                                            xs, ys, eps)
    if (per_thread <= 1) RMS_LAUNCH(1);
    else if (per_thread <= 2) RMS_LAUNCH(2);
    else if (per_thread <= 4) RMS_LAUNCH(4);
    else if (per_thread <= 8) RMS_LAUNCH(8);
    else if (per_thread <= 16) RMS_LAUNCH(16);
    else return -1;
#undef RMS_LAUNCH
    return (int)cudaGetLastError();
}

// x, y: (rows, d) with row strides in elements and unit stride along d;
// scale: (d,) f32. Returns cudaGetLastError(), or -1 for a shape the kernel
// does not take (d not a multiple of 16 bytes, or a row too long to hold
// in registers).
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* y, int rows,
                          int d, long long x_stride, long long y_stride,
                          float eps, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == RT_F32)
        return launch_rmsnorm<float>(x, scale, y, rows, d, x_stride, y_stride, eps, s);
    if (dtype == RT_BF16)
        return launch_rmsnorm<bf16>(x, scale, y, rows, d, x_stride, y_stride, eps, s);
    return -1;
}
