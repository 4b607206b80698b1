// xz-quad gather-operand build: [E, W] -> [E, 4W] (kernel B3).
//
// Replaces the Pallas TPU kernel nersemble_tpu/ops/quad_pallas.py::build
// (_make_build_kernel, launched by build()). Row e of the output is
//   [ t(e) | t(z-succ(e)) | t(x-succ(e)) | t(xz-succ(e)) ]
// where the successor of quarter q inside level l is
//   off_l + (e - off_l + s_{q,l}) mod size_l,   s = (0, z, x, x+z) strides,
// i.e. a cyclic roll of the level segment by -s rows. A pure copy.
//
// What bounds it on the H100: device memory bandwidth. At the flagship table
// ([6,537,216, 64] bf16) it reads 0.84 GB (each source row four times, mostly
// from L2) and writes 3.35 GB; nothing is computed.
//
// Design: one thread per 16-byte chunk of an output row, a block row of
// threads per output row, so a warp writes 512 contiguous bytes and reads
// four contiguous 128-byte quarter sources. The TPU kernel needed level
// sizes padded to its 2048-row block and a per-block branch table to keep
// its in-VMEM shifts static; here every thread computes its own source row,
// so any level sizes work (the tiny test layout's 1024-row hashed levels
// included). The per-level layout (offsets, sizes, wrapped shifts; at most
// 32 levels) is a by-value kernel parameter, which lives in the constant
// bank: a warp reads the same level's entries, a broadcast.
//
// Narrow rows (the single-grid field's [6,184,960, 2] table: 4 bytes in
// bf16, 8 in f32) take quad_build_narrow_kernel: one thread per output row,
// four row-sized loads (one per quarter's rolled source row) and one 16- or
// 32-byte store, so a warp writes 512 or 1024 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define QB_MAX_LEVELS 32

struct QuadLayout {
    int n_levels;
    long long offset[QB_MAX_LEVELS];
    long long size[QB_MAX_LEVELS];
    long long shift[3][QB_MAX_LEVELS];  // quarters 1..3, already mod size
};

__global__ void quad_build_kernel(const uint4* __restrict__ table,
                                  uint4* __restrict__ out,
                                  long long n_rows, int chunks_per_quarter,
                                  QuadLayout layout) {
    const long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    if (e >= n_rows) return;
    const int q = threadIdx.x / chunks_per_quarter;
    const int c = threadIdx.x - q * chunks_per_quarter;

    long long src = e;
    if (q > 0) {
        int l = 0;
        for (int i = 1; i < layout.n_levels; ++i)
            if (e >= layout.offset[i]) l = i;
        const long long off = layout.offset[l];
        long long r = e - off + layout.shift[q - 1][l];
        if (r >= layout.size[l]) r -= layout.size[l];
        src = off + r;
    }
    out[e * 4 * chunks_per_quarter + threadIdx.x] =
        table[src * chunks_per_quarter + c];
}

__device__ __forceinline__ long long quad_source(long long e, int q,
                                                 const QuadLayout& layout) {
    int l = 0;
    for (int i = 1; i < layout.n_levels; ++i)
        if (e >= layout.offset[i]) l = i;
    const long long off = layout.offset[l];
    long long r = e - off + layout.shift[q - 1][l];
    if (r >= layout.size[l]) r -= layout.size[l];
    return off + r;
}

__device__ __forceinline__ void store_quad(uint4* out, long long e,
                                           uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d) {
    out[e] = make_uint4(a, b, c, d);
}
__device__ __forceinline__ void store_quad(uint4* out, long long e,
                                           uint2 a, uint2 b, uint2 c, uint2 d) {
    out[2 * e] = make_uint4(a.x, a.y, b.x, b.y);
    out[2 * e + 1] = make_uint4(c.x, c.y, d.x, d.y);
}

// R: the row as one value (uint32_t for 4-byte rows, uint2 for 8-byte)
template <typename R>
__global__ void quad_build_narrow_kernel(const R* __restrict__ table,
                                         uint4* __restrict__ out,
                                         long long n_rows, QuadLayout layout) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_rows) return;
    store_quad(out, e, table[e], table[quad_source(e, 1, layout)],
               table[quad_source(e, 2, layout)],
               table[quad_source(e, 3, layout)]);
}

// table/out: device pointers, rows of row_bytes (4, 8, or a multiple of 16
// up to 4096) contiguous. meta: host int64 [n_levels, offsets..., sizes...,
// shift_z..., shift_x..., shift_xz...]. Returns cudaGetLastError().
extern "C" int quad_build(const void* table, void* out, long long n_rows,
                          long long row_bytes, const long long* meta,
                          void* stream) {
    QuadLayout layout;
    const int n = (int)meta[0];
    const bool narrow = row_bytes == 4 || row_bytes == 8;
    if (n < 1 || n > QB_MAX_LEVELS || (row_bytes % 16 != 0 && !narrow)
        || row_bytes > 4096 || n_rows < 0)
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
        if (row_bytes == 4)
            quad_build_narrow_kernel<uint32_t><<<grid, 256, 0, (cudaStream_t)stream>>>(
                (const uint32_t*)table, (uint4*)out, n_rows, layout);
        else
            quad_build_narrow_kernel<uint2><<<grid, 256, 0, (cudaStream_t)stream>>>(
                (const uint2*)table, (uint4*)out, n_rows, layout);
        return (int)cudaGetLastError();
    }
    const int cpq = (int)(row_bytes / 16);
    const int per_row = 4 * cpq;
    const int rows_per_block = per_row >= 256 ? 1 : 256 / per_row;
    dim3 block(per_row, rows_per_block);
    dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
    quad_build_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (uint4*)out, n_rows, cpq, layout);
    return (int)cudaGetLastError();
}
