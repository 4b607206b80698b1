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
// Wide quarters (16 to 4096 bytes), quad_fold_kernel: B3's output-major
// source-row arithmetic, inverted (subtract the shift instead of adding
// it). One thread per 16-byte chunk of an OUTPUT row: it reads the same
// chunk of four quarters from four rows, each a 128-byte contiguous run per
// 8 threads, and writes its chunk once. Unlike B3's gathers it reads each
// (row, quarter) piece exactly once, and runs at 86-92% of its bound at the
// flagship (PERF.md); it walks the levels per thread (the per-level layout
// is a by-value kernel parameter in the constant bank). Every level offset,
// size and shift is a multiple of 32 rows (quad_layout.cuh).
//
// Narrow quarters (the single-grid field's [6,184,960, 8] bf16 gradient:
// quarters of 4 bytes in bf16, 8 in f32) take quad_fold_narrow_kernel.
// Its gradient is 99 MB, an L2-sized level at a time (8 MB per hashed
// level): the blocks walk the rows in order, so each gradient row comes
// from device memory about once. A walk of the levels per row would cost
// more instructions than the row's 4 bytes are worth, so a warp takes four
// consecutive 32-row groups (lane i: rows i, i+32, i+64, i+96), finds each
// group's level with one ballot (quad_layout.cuh), and every quarter load
// of a group is coalesced: 32 consecutive rows, one 4- or 8-byte quarter
// each. Each row's four quarters are added in f32, q0 + q1 + q2 + q3,
// rounded once (bit-exact as above), and a warp's store of a group is 128
// or 256 contiguous bytes.
// What still bounds it: a quarter is a quarter of its row's 32-byte
// sectors, so the loads move four times the gradient's bytes out of L2.
//
// Quarters of 2 bytes (one bf16 feature: the gradient of the single-grid
// column that one rank of two holds, [6,184,960, 4]) take
// quad_fold_half_kernel. A warp folds two 32-row groups, each lane of a
// half the rows e and e + 1 (e even) of its group: a 32-bit store per lane,
// one 64-byte run per group. Each output group reads quarter q from one
// 32-row source group of 8-byte rows, a 256-byte span: the kernel loads the
// whole span (16 bytes per lane: both rows' four quarters) and picks the
// quarter in registers. Loading the two 2-byte quarters alone was measured
// too: a source group's span reaches the SM once per quarter, four times in
// all, either way, and the two ran alike on an H100 80GB HBM3 at 700 W
// (0.0287 ms device time each on [6,184,960, 4] bf16, chip_smoke.py phase
// 3), so only the whole-row loads are kept.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quad_layout.cuh"

#define QF_ROWS_PER_LANE 4  // the narrow kernel's 32-row groups per warp

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
                                 int chunks_per_quarter, QuadLayout layout) {
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
__global__ void __launch_bounds__(256)
quad_fold_narrow_kernel(const Q* __restrict__ g, Q* __restrict__ out,
                        int n_rows, const __grid_constant__ QuadLayout layout) {
    constexpr int PER = sizeof(Q) / sizeof(T);
    constexpr int RPL = QF_ROWS_PER_LANE;
    __shared__ LevelTable levels;
    const LaneLevel mine = lane_level(layout, levels);
    const int lane = threadIdx.x & 31;
    const int base = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * QUAD_GROUP * RPL;
    Q v[RPL][4];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
        const int row0 = base + QUAD_GROUP * i;  // warp-uniform
        if (row0 >= n_rows) break;  // n_rows is a multiple of 32
        const Group grp = group_of(mine, level_of(row0, mine));
        const int e = row0 + lane;
        v[i][0] = g[4LL * e];
#pragma unroll
        for (int q = 1; q < 4; ++q)
            v[i][q] = g[4LL * rolled_back(e, grp, grp.shift[q - 1]) + q];
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
        const int row0 = base + QUAD_GROUP * i;
        if (row0 >= n_rows) break;
        float acc[PER];
        {
            const T* pv = reinterpret_cast<const T*>(&v[i][0]);
#pragma unroll
            for (int k = 0; k < PER; ++k) acc[k] = fold_to_f32(pv[k]);
        }
#pragma unroll
        for (int q = 1; q < 4; ++q) {
            const T* pv = reinterpret_cast<const T*>(&v[i][q]);
#pragma unroll
            for (int k = 0; k < PER; ++k) acc[k] += fold_to_f32(pv[k]);
        }
        Q o;
        T* po = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int k = 0; k < PER; ++k) fold_from_f32(acc[k], po[k]);
        out[row0 + lane] = o;
    }
}

// the bf16 value in half `hi` (0: low, 1: high) of a word, in f32
__device__ __forceinline__ float fold_half(uint32_t word, int hi) {
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&word);
    return hi ? __high2float(pair) : __low2float(pair);
}

// Lanes 0-15 fold group row0 and lanes 16-31 group row0 + 32, lane j of a
// half the rows 2j and 2j + 1 of its group (e, e + 1). The rows' quarter q
// comes from source rows s and s + 1 (s even: every shift is a multiple of
// 32 rows), quarter q of each.
__global__ void __launch_bounds__(256)
quad_fold_half_kernel(const uint4* __restrict__ g, uint32_t* __restrict__ out,
                      int n_rows, const __grid_constant__ QuadLayout layout) {
    __shared__ LevelTable levels;
    const LaneLevel mine = lane_level(layout, levels);
    const int lane = threadIdx.x & 31, half = lane >> 4;
    const int row0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * 2 * QUAD_GROUP;
    if (row0 >= n_rows) return;  // warp-uniform: n_rows is a multiple of 32
    const int l0 = level_of(row0, mine), l1 = level_of(row0 + QUAD_GROUP, mine);
    const Group grp = group_of(mine, half ? l1 : l0);
    const int e = row0 + half * QUAD_GROUP + 2 * (lane & 15);
    if (e >= n_rows) return;
    // a uint4 is rows s and s + 1: quarters 0, 1 in .x / .z, 2, 3 in .y / .w
    uint4 v[4];
    v[0] = __ldg(g + (e >> 1));
#pragma unroll
    for (int q = 1; q < 4; ++q)
        v[q] = __ldg(g + (rolled_back(e, grp, grp.shift[q - 1]) >> 1));
    uint32_t lo[4], hi[4];  // quarter q of rows e and e + 1, in the low half
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t a = q < 2 ? v[q].x : v[q].y, b = q < 2 ? v[q].z : v[q].w;
        lo[q] = q & 1 ? a >> 16 : a & 0xffffu;
        hi[q] = q & 1 ? b >> 16 : b & 0xffffu;
    }
    float a = fold_half(lo[0], 0), b = fold_half(hi[0], 0);
#pragma unroll
    for (int q = 1; q < 4; ++q) {
        a += fold_half(lo[q], 0);
        b += fold_half(hi[q], 0);
    }
    const __nv_bfloat162 pair = __floats2bfloat162_rn(a, b);  // .x: row e
    out[e >> 1] = *reinterpret_cast<const uint32_t*>(&pair);
}

// g: [n_rows, 4W] device, out: [n_rows, W] device, rows contiguous;
// quarter_bytes = W * elem_bytes (2 (bf16 only), 4, 8, or a multiple of 16
// up to 4096);
// elem_bytes 2 (bf16) or 4 (f32). meta: host int64 [n_levels, offsets...,
// sizes..., shift_z..., shift_x..., shift_xz...] (B3's layout argument).
// Returns cudaGetLastError().
extern "C" int quad_fold(const void* g, void* out, long long n_rows,
                         long long quarter_bytes, long long elem_bytes,
                         const long long* meta, void* stream) {
    QuadLayout layout;
    const bool half = quarter_bytes == 2;
    const bool narrow = quarter_bytes == 4 || quarter_bytes == 8;
    if ((quarter_bytes % 16 != 0 && !narrow && !half) || quarter_bytes > 4096
        || n_rows < 0 || n_rows >= (1LL << 31) || (elem_bytes != 2 && elem_bytes != 4)
        || (half && elem_bytes != 2) || !read_layout(meta, n_rows, layout)
        || (uintptr_t)g % (half ? 16 : narrow ? quarter_bytes : 16) != 0
        || (uintptr_t)out % (half ? 4 : narrow ? quarter_bytes : 16) != 0)
        return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (half) {
        const long long per_block = 8LL * 2 * QUAD_GROUP;
        const unsigned grid = (unsigned)((n_rows + per_block - 1) / per_block);
        quad_fold_half_kernel<<<grid, 256, 0, st>>>(
            (const uint4*)g, (uint32_t*)out, (int)n_rows, layout);
        return (int)cudaGetLastError();
    }
    if (narrow) {
        const long long per_block = 8LL * QUAD_GROUP * QF_ROWS_PER_LANE;
        const unsigned grid = (unsigned)((n_rows + per_block - 1) / per_block);
        if (elem_bytes == 2 && quarter_bytes == 4)
            quad_fold_narrow_kernel<__nv_bfloat16, uint32_t><<<grid, 256, 0, st>>>(
                (const uint32_t*)g, (uint32_t*)out, (int)n_rows, layout);
        else if (elem_bytes == 2)
            quad_fold_narrow_kernel<__nv_bfloat16, uint2><<<grid, 256, 0, st>>>(
                (const uint2*)g, (uint2*)out, (int)n_rows, layout);
        else if (quarter_bytes == 4)
            quad_fold_narrow_kernel<float, uint32_t><<<grid, 256, 0, st>>>(
                (const uint32_t*)g, (uint32_t*)out, (int)n_rows, layout);
        else
            quad_fold_narrow_kernel<float, uint2><<<grid, 256, 0, st>>>(
                (const uint2*)g, (uint2*)out, (int)n_rows, layout);
        return (int)cudaGetLastError();
    }
    const int cpq = (int)(quarter_bytes / 16);
    const int rows_per_block = cpq >= 256 ? 1 : 256 / cpq;
    dim3 block(cpq, rows_per_block);
    dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
    if (elem_bytes == 2)
        quad_fold_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
            (const uint4*)g, (uint4*)out, n_rows, cpq, layout);
    else
        quad_fold_kernel<float><<<grid, block, 0, st>>>(
            (const uint4*)g, (uint4*)out, n_rows, cpq, layout);
    return (int)cudaGetLastError();
}
