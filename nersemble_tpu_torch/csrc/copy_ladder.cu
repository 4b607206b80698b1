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
// Design of the broadcast and the seven-fetch: a thread block takes
// `block_rows` consecutive rows (the Pallas BlockSpec block; the last block
// may be ragged and is masked), its 256 threads walk the block's 16-byte
// input chunks, a warp reading 512 contiguous bytes, and several loads are
// in flight before their stores. The broadcast loads a chunk once and stores
// it four times; the seven-fetch loads a chunk from each of the seven inputs
// with volatile loads, so that the compiler keeps the three inputs whose
// values are never stored, and stores four. All offsets are 64-bit: the
// [E, 4W] output is 3.35 GB.
//
// The copy, the ladder's floor, runs differently: as bulk copies (TMA,
// cp.async.bulk), global -> shared -> global, issued by one thread per
// block through a ring of TC_STAGES 16 KB stages, each load completing on
// its stage's mbarrier and each store tracked as a bulk group. Blocks walk
// `block_rows` units with a grid stride, the grid cut to the fewest resident
// blocks that still take the same number of units each (one block per unit
// ran 3.02 waves, the last a tail of 24 blocks). It still trails clone() (a
// device-to-device copy) by ~8% at the flagship size; a version with a
// thread per 16 bytes, a persistent grid and streaming hints, and
// evict-first L2 hints on the bulk copies were no faster (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define LT 256  // threads per block
#define N_QUARTERS 4
#define TC_STAGES 4             // the copy's shared-memory ring
#define TC_STAGE_BYTES 16384

struct Seven {
    const uint4* r[7];
};

__device__ __forceinline__ uint4 load_kept(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Bulk copies in TC_STAGE_BYTES pieces; piece q uses stage q % TC_STAGES.
// Loads run TC_STAGES - 1 pieces ahead of the stores; a stage is reloaded
// once the store that read it is done reading.
__global__ void __launch_bounds__(32)
ladder_copy_kernel(const unsigned char* __restrict__ x,
                   unsigned char* __restrict__ out, long long total,
                   long long unit) {
    extern __shared__ __align__(128) unsigned char stage[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(stage + TC_STAGES * TC_STAGE_BYTES);
    if (threadIdx.x != 0) return;
    for (int i = 0; i < TC_STAGES; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

    // this block's pieces, in order: unit u = blockIdx.x + k * gridDim.x,
    // then TC_STAGE_BYTES pieces of it (the last of a unit may be short)
    const long long n_units = (total + unit - 1) / unit;
    const long long per_unit = (unit + TC_STAGE_BYTES - 1) / TC_STAGE_BYTES;
    const long long my_units = blockIdx.x < n_units
        ? (n_units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const long long n_pieces = my_units * per_unit;
    auto piece = [&](long long q, long long& off, uint32_t& bytes) {
        const long long u = blockIdx.x + (q / per_unit) * gridDim.x;
        const long long u_end = min((u + 1) * unit, total);
        off = u * unit + (q % per_unit) * TC_STAGE_BYTES;
        bytes = off < u_end ? (uint32_t)min((long long)TC_STAGE_BYTES, u_end - off) : 0;
    };
    auto load = [&](long long q) {
        long long off;
        uint32_t bytes;
        piece(q, off, bytes);
        const int st = (int)(q % TC_STAGES);
        // an empty piece still completes its phase (0 bytes expected)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem_u32(bars + st)), "r"(bytes) : "memory");
        if (bytes)
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                         "[%0], [%1], %2, [%3];\n"
                         :: "r"(smem_u32(stage + st * TC_STAGE_BYTES)), "l"(x + off),
                            "r"(bytes), "r"(smem_u32(bars + st)) : "memory");
    };
    for (long long q = 0; q < TC_STAGES - 1 && q < n_pieces; ++q) load(q);
    for (long long q = 0; q < n_pieces; ++q) {
        const int st = (int)(q % TC_STAGES);
        const uint32_t parity = (uint32_t)((q / TC_STAGES) & 1);
        uint32_t done = 0;
        while (!done)
            asm volatile("{\n .reg .pred p;\n"
                         " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                         " selp.u32 %0, 1, 0, p;\n}\n"
                         : "=r"(done) : "r"(smem_u32(bars + st)), "r"(parity) : "memory");
        long long off;
        uint32_t bytes;
        piece(q, off, bytes);
        if (bytes)
            asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                         :: "l"(out + off), "r"(smem_u32(stage + st * TC_STAGE_BYTES)),
                            "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (q + TC_STAGES - 1 < n_pieces) {
            // piece q + TC_STAGES - 1 reuses the stage of piece q - 1, whose
            // store is the one before the latest
            asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
            load(q + TC_STAGES - 1);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
    const int smem = TC_STAGES * TC_STAGE_BYTES + 8 * TC_STAGES;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        ladder_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ladder_copy_kernel,
                                                            32, smem);
    if (err != cudaSuccess) return (int)err;
    // the resident blocks, cut to the fewest that still take the same number
    // of units each
    const long long units = n_blocks(n_rows, block_rows);
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long per_block = (units + resident - 1) / resident;
    ladder_copy_kernel<<<(unsigned)((units + per_block - 1) / per_block), 32, smem,
                         (cudaStream_t)stream>>>(
        (const unsigned char*)x, (unsigned char*)out, n_rows * row_bytes,
        block_rows * row_bytes);
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
