// The quad build's cost ladder: copy, broadcast-quarters and seven-fetch
// (kernels P2, P3, P4).
//
// Replace the Pallas TPU kernels of scripts/bench_quad_build.py::
// run_diagnostics: copy_kernel (out = x, [B, W] blocks), bcast_kernel (each
// [B, W] block written to all four quarters of a [B, 4W] block) and
// fetch7_kernel (seven [B, W] inputs fetched per block, out = [x0 | x1 | x3
// | x5]). Each rung adds one cost of the quad build (kernel B3,
// csrc/quad_build.cu) to the one before: the copy is the floor of moving
// the table, the broadcast adds the build's 4x output bytes, the seven
// fetches add the build's input fetch count; B3 itself adds the per-level
// source-row arithmetic.
//
// What bounds them on the H100: device memory bandwidth. At the flagship
// [6,537,216, 64] bf16 table (0.84 GB) the copy moves 1.67 GB (0.50 ms at
// 3.35 TB/s); the broadcast and the seven-fetch read 0.84 GB and write 3.35
// GB (1.25 ms). The seven-fetch reads all seven inputs as the rung means to,
// but the ladder passes one tensor seven times, and on this card seven
// reads of the same bytes are mostly L2 and L1 hits: the rung measures load
// instructions, not device-memory bytes, and its bound counts each distinct
// byte once.
//
// Design: a thread block takes `block_rows` consecutive rows (the Pallas
// BlockSpec block; the last block may be ragged and is masked), its 256
// threads walk the block's 16-byte input chunks, a warp reading 512
// contiguous bytes, and several loads are in flight before their stores. The
// broadcast loads a chunk once and stores it four times; the seven-fetch
// loads a chunk from each of the seven inputs with volatile loads, so that
// the compiler keeps the three inputs whose values are never stored, and
// stores four. All offsets are 64-bit: the [E, 4W] output is 3.35 GB.

#include <cuda_runtime.h>
#include <stdint.h>

#define LT 256  // threads per block
#define N_QUARTERS 4

struct Seven {
    const uint4* r[7];
};

__device__ __forceinline__ uint4 load_kept(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

__global__ void __launch_bounds__(LT)
ladder_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                   long long n_rows, int cpr, long long block_rows) {
    const long long row0 = (long long)blockIdx.x * block_rows;
    const long long rows = min(block_rows, n_rows - row0);
    const long long base = row0 * cpr, n = rows * cpr;
    for (long long j = threadIdx.x; j < n; j += 4 * LT) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (j + u * LT < n) v[u] = __ldg(x + base + j + u * LT);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (j + u * LT < n) out[base + j + u * LT] = v[u];
    }
}

__global__ void __launch_bounds__(LT)
ladder_bcast_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                    long long n_rows, int cpr, long long block_rows) {
    const long long row0 = (long long)blockIdx.x * block_rows;
    const long long rows = min(block_rows, n_rows - row0);
    const long long n = rows * cpr;
    for (long long j = threadIdx.x; j < n; j += 4 * LT) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (j + u * LT < n) v[u] = __ldg(x + row0 * cpr + j + u * LT);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const long long jj = j + u * LT;
            if (jj < n) {
                const long long row = row0 + jj / cpr;
                uint4* dst = out + row * (N_QUARTERS * cpr) + jj % cpr;
#pragma unroll
                for (int q = 0; q < N_QUARTERS; ++q) dst[q * cpr] = v[u];
            }
        }
    }
}

__global__ void __launch_bounds__(LT)
ladder_fetch7_kernel(Seven in, uint4* __restrict__ out, long long n_rows,
                     int cpr, long long block_rows) {
    const long long row0 = (long long)blockIdx.x * block_rows;
    const long long rows = min(block_rows, n_rows - row0);
    const long long n = rows * cpr;
    for (long long j = threadIdx.x; j < n; j += 2 * LT) {
        uint4 v[2][7];
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (j + u * LT < n) {
#pragma unroll
                for (int i = 0; i < 7; ++i)
                    v[u][i] = load_kept(in.r[i] + row0 * cpr + j + u * LT);
            }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const long long jj = j + u * LT;
            if (jj < n) {
                const long long row = row0 + jj / cpr;
                uint4* dst = out + row * (N_QUARTERS * cpr) + jj % cpr;
                dst[0] = v[u][0];        // quarter 0: x0
                dst[cpr] = v[u][1];      // quarters 1..3: x1, x3, x5
                dst[2 * cpr] = v[u][3];
                dst[3 * cpr] = v[u][5];
            }
        }
    }
}

static bool bad_args(long long n_rows, long long row_bytes, long long block_rows) {
    return n_rows < 0 || row_bytes < 16 || row_bytes % 16 != 0
           || row_bytes > (1LL << 20) || block_rows < 1;
}

static unsigned n_blocks(long long n_rows, long long block_rows) {
    return (unsigned)((n_rows + block_rows - 1) / block_rows);
}

// x/out: contiguous device rows of row_bytes (out rows of 4 * row_bytes for
// the broadcast and the seven-fetch); row_bytes a multiple of 16;
// block_rows rows per thread block. Each returns cudaGetLastError().
extern "C" int ladder_copy(const void* x, void* out, long long n_rows,
                           long long row_bytes, long long block_rows,
                           void* stream) {
    if (bad_args(n_rows, row_bytes, block_rows)) return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaGetLastError();
    ladder_copy_kernel<<<n_blocks(n_rows, block_rows), LT, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, (uint4*)out, n_rows, (int)(row_bytes / 16), block_rows);
    return (int)cudaGetLastError();
}

extern "C" int ladder_bcast(const void* x, void* out, long long n_rows,
                            long long row_bytes, long long block_rows,
                            void* stream) {
    if (bad_args(n_rows, row_bytes, block_rows)) return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaGetLastError();
    ladder_bcast_kernel<<<n_blocks(n_rows, block_rows), LT, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, (uint4*)out, n_rows, (int)(row_bytes / 16), block_rows);
    return (int)cudaGetLastError();
}

extern "C" int ladder_fetch7(const void* r0, const void* r1, const void* r2,
                             const void* r3, const void* r4, const void* r5,
                             const void* r6, void* out, long long n_rows,
                             long long row_bytes, long long block_rows,
                             void* stream) {
    if (bad_args(n_rows, row_bytes, block_rows)) return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaGetLastError();
    Seven in = {{(const uint4*)r0, (const uint4*)r1, (const uint4*)r2,
                 (const uint4*)r3, (const uint4*)r4, (const uint4*)r5,
                 (const uint4*)r6}};
    ladder_fetch7_kernel<<<n_blocks(n_rows, block_rows), LT, 0, (cudaStream_t)stream>>>(
        in, (uint4*)out, n_rows, (int)(row_bytes / 16), block_rows);
    return (int)cudaGetLastError();
}
