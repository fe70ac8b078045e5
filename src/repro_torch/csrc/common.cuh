// Shared device helpers for the repro_torch kernels: element types, 16-byte
// global loads/stores converted to float, warp reductions, the strided
// global -> shared tile copy, cp.async, and the tensor-core fragments
// (mma.sync m16n8k16 bf16, ldmatrix, and wgmma with A from registers). No
// PyTorch headers: the kernels are built by nvcc into a plain C library and
// bound with ctypes.
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

// 2^x on the multi-function unit (ex2.approx.ftz: about 2 ulp, 0 for -inf
// and for very negative x)
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
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

// ---------------------------------------------------------------------- //
//  cp.async: 16-byte copies from global to shared memory that do not hold //
//  a register until they land                                            //
// ---------------------------------------------------------------------- //
// Copy 16 bytes, or write 16 zero bytes and read nothing when !ok (the
// source must still be a valid address: pass an in-bounds row).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------- //
//  tensor cores                                                          //
// ---------------------------------------------------------------------- //
// d += a b on a 16 x 8 x 16 tile: a (16 x 16, row) and b (16 x 8, col) in
// bf16, d in f32. Fragment coordinates: g = lane / 4, t = lane % 4; d[0..1]
// is row g, columns 2t, 2t + 1; d[2..3] the same columns of row g + 8.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, one row address per lane
// (lanes 8q..8q+7 give the rows of matrix q); register q holds matrix q in
// the mma fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the same, each matrix transposed on the way: rows of the tile in shared
// memory become columns of the fragment (the B operand from a row-major
// (k, n) tile)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// ---------------------------------------------------------------------- //
//  warpgroup matrix multiply (wgmma, sm_90a)                             //
// ---------------------------------------------------------------------- //
// Descriptor of a K-major bf16 operand in shared memory in the 128-byte
// swizzle: rows of 128 bytes (64 values of k), 8-row atoms of 1,024 bytes
// one after the other (the stride byte offset), the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8). The atoms must be 1,024-byte aligned; a
// k-slice of 16 further into the row starts 32 bytes on.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    return (uint64_t)((addr & 0x3FFFF) >> 4)          // start address / 16
           | ((uint64_t)1 << 16)                       // leading offset: unused here
           | ((uint64_t)(1024 >> 4) << 32)             // stride offset: one atom
           | ((uint64_t)1 << 62);                      // 128-byte swizzle
}

// orders this thread's earlier register writes before the wgmma that follow
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma
// issue or wait
template <int R>
__device__ __forceinline__ void wgmma_fence_operand(float (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= a b on a 64 x 128 x 16 tile of one warpgroup: a (64 x 16 bf16) in
// registers, in the layout of mma_bf16_16816's A for the warp's 16 rows
// (warp w of the warpgroup holds rows 16w..16w+15); b (16 x 128 bf16,
// K-major) in shared memory behind `desc`; d in f32, thread (g, t) of warp
// w holding d[4j..4j+1] at row 16w + g, columns 8j + 2t, 8j + 2t + 1 and
// d[4j+2..4j+3] the same columns of row 16w + g + 8. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a,
                                                    uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// two floats rounded to bf16 (to nearest even) in one register, the first
// in the low half: an A-operand register of mma_bf16_16816
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------- //
//  programmatic dependent launch (sm_90)                                 //
// ---------------------------------------------------------------------- //
// A kernel launched by launch_after() may be scheduled while the kernel
// before it on the stream still runs, once every block of that kernel has
// called allow_dependents() or exited; it must call wait_for_prerequisite()
// before it reads what that kernel writes (it returns when that kernel has
// finished and its writes are visible). Both are no-ops in a kernel launched
// the ordinary way. This hides the second launch of a two-pass kernel.
__device__ __forceinline__ void allow_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_prerequisite() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename Param>
static cudaError_t launch_after(void (*kernel)(Param), dim3 grid, dim3 block,
                                cudaStream_t stream, const Param& p) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, p);
}
