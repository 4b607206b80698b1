// xz-quad gradient fold: [E, 4W] -> [E, W] (kernel B4), the transpose of B3.
//
// Replaces the Pallas TPU kernel nersemble_tpu/ops/quad_pallas.py::fold
// (_make_fold_kernel, launched by fold()), which the JAX package holds equal
// to its production fold _quad_bwd_xla (nersemble_tpu/ops/hash_encoding.py).
// Quarter q of quad row r carries the gradient of the canonical entry
// off_l + (r - off_l + s_{q,l}) mod size_l, so canonical row e collects
//   g[e, q0] + g[e - s_z, q1] + g[e - s_x, q2] + g[e - s_xz, q3]
// (row indices cyclic inside level l, shifts already mod size_l), summed in
// f32 in exactly that order and rounded once to the gradient dtype (bf16 or
// f32): bit-exact against _quad_bwd_xla.
//
// What bounds it on the H100: device memory bandwidth. At the flagship table
// ([6,537,216, 256] bf16 gradient) it reads 3.35 GB and writes 0.84 GB; the
// additions are free.
//
// Design: B3's per-thread source-row arithmetic, inverted (subtract the
// shift instead of adding it). One thread per 16-byte chunk of an OUTPUT
// row: it reads the same chunk of four quarters from four rows, each a
// 128-byte contiguous run per 8 threads, and writes its chunk once. Any
// level sizes work (the tiny layout's 1024-row hashed levels included); the
// per-level layout is a by-value kernel parameter in the constant bank.
//
// Narrow quarters (the single-grid field's gradient: 4 bytes in bf16, 8 in
// f32) take quad_fold_narrow_kernel: one thread per canonical row reads its
// four quarters from four rolled rows as one 4- or 8-byte load each and
// adds them in f32, q0 + q1 + q2 + q3, rounded once (bit-exact as above).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define QF_MAX_LEVELS 32

struct FoldLayout {
    int n_levels;
    long long offset[QF_MAX_LEVELS];
    long long size[QF_MAX_LEVELS];
    long long shift[3][QF_MAX_LEVELS];  // quarters 1..3, already mod size
};

__device__ __forceinline__ float fold_to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float fold_to_f32(float v) { return v; }
__device__ __forceinline__ void fold_from_f32(float v, __nv_bfloat16& o) {
    o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void fold_from_f32(float v, float& o) { o = v; }

template <typename T>
__global__ void quad_fold_kernel(const uint4* __restrict__ g,
                                 uint4* __restrict__ out, long long n_rows,
                                 int chunks_per_quarter, FoldLayout layout) {
    constexpr int PER = 16 / sizeof(T);
    const long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    if (e >= n_rows) return;
    const int c = threadIdx.x;
    const long long row_chunks = 4LL * chunks_per_quarter;

    int l = 0;
    for (int i = 1; i < layout.n_levels; ++i)
        if (e >= layout.offset[i]) l = i;
    const long long off = layout.offset[l], size = layout.size[l];

    float acc[PER];
    {
        const uint4 v = g[e * row_chunks + c];
        const T* pv = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] = fold_to_f32(pv[i]);
    }
#pragma unroll
    for (int q = 1; q < 4; ++q) {
        long long r = e - off - layout.shift[q - 1][l];
        if (r < 0) r += size;
        const uint4 v = g[(off + r) * row_chunks + q * chunks_per_quarter + c];
        const T* pv = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] += fold_to_f32(pv[i]);
    }
    uint4 o;
    T* po = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < PER; ++i) fold_from_f32(acc[i], po[i]);
    out[e * chunks_per_quarter + c] = o;
}

// T: the element type; Q: one quarter as one value (uint32_t or uint2)
template <typename T, typename Q>
__global__ void quad_fold_narrow_kernel(const Q* __restrict__ g,
                                        Q* __restrict__ out, long long n_rows,
                                        FoldLayout layout) {
    constexpr int PER = sizeof(Q) / sizeof(T);
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_rows) return;
    int l = 0;
    for (int i = 1; i < layout.n_levels; ++i)
        if (e >= layout.offset[i]) l = i;
    const long long off = layout.offset[l], size = layout.size[l];

    float acc[PER];
    {
        const Q v = g[4 * e];
        const T* pv = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] = fold_to_f32(pv[i]);
    }
#pragma unroll
    for (int q = 1; q < 4; ++q) {
        long long r = e - off - layout.shift[q - 1][l];
        if (r < 0) r += size;
        const Q v = g[4 * (off + r) + q];
        const T* pv = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] += fold_to_f32(pv[i]);
    }
    Q o;
    T* po = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < PER; ++i) fold_from_f32(acc[i], po[i]);
    out[e] = o;
}

// g: [n_rows, 4W] device, out: [n_rows, W] device, rows contiguous;
// quarter_bytes = W * elem_bytes (4, 8, or a multiple of 16 up to 4096);
// elem_bytes 2 (bf16) or 4 (f32). meta: host int64 [n_levels, offsets...,
// sizes..., shift_z..., shift_x..., shift_xz...] (B3's layout argument).
// Returns cudaGetLastError().
extern "C" int quad_fold(const void* g, void* out, long long n_rows,
                         long long quarter_bytes, long long elem_bytes,
                         const long long* meta, void* stream) {
    FoldLayout layout;
    const int n = (int)meta[0];
    const bool narrow = quarter_bytes == 4 || quarter_bytes == 8;
    if (n < 1 || n > QF_MAX_LEVELS || (quarter_bytes % 16 != 0 && !narrow)
        || quarter_bytes > 4096 || n_rows < 0
        || (elem_bytes != 2 && elem_bytes != 4))
        return (int)cudaErrorInvalidValue;
    layout.n_levels = n;
    for (int l = 0; l < n; ++l) {
        layout.offset[l] = meta[1 + l];
        layout.size[l] = meta[1 + n + l];
        for (int q = 0; q < 3; ++q)
            layout.shift[q][l] = meta[1 + (2 + q) * n + l];
    }
    if (n_rows == 0) return (int)cudaGetLastError();
    if (narrow) {
        const unsigned grid = (unsigned)((n_rows + 255) / 256);
        cudaStream_t st = (cudaStream_t)stream;
        if (elem_bytes == 2 && quarter_bytes == 4)
            quad_fold_narrow_kernel<__nv_bfloat16, uint32_t><<<grid, 256, 0, st>>>(
                (const uint32_t*)g, (uint32_t*)out, n_rows, layout);
        else if (elem_bytes == 2)
            quad_fold_narrow_kernel<__nv_bfloat16, uint2><<<grid, 256, 0, st>>>(
                (const uint2*)g, (uint2*)out, n_rows, layout);
        else if (quarter_bytes == 4)
            quad_fold_narrow_kernel<float, uint32_t><<<grid, 256, 0, st>>>(
                (const uint32_t*)g, (uint32_t*)out, n_rows, layout);
        else
            quad_fold_narrow_kernel<float, uint2><<<grid, 256, 0, st>>>(
                (const uint2*)g, (uint2*)out, n_rows, layout);
        return (int)cudaGetLastError();
    }
    const int cpq = (int)(quarter_bytes / 16);
    const int rows_per_block = cpq >= 256 ? 1 : 256 / cpq;
    dim3 block(cpq, rows_per_block);
    dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
    if (elem_bytes == 2)
        quad_fold_kernel<__nv_bfloat16><<<grid, block, 0, (cudaStream_t)stream>>>(
            (const uint4*)g, (uint4*)out, n_rows, cpq, layout);
    else
        quad_fold_kernel<float><<<grid, block, 0, (cudaStream_t)stream>>>(
            (const uint4*)g, (uint4*)out, n_rows, cpq, layout);
    return (int)cudaGetLastError();
}
