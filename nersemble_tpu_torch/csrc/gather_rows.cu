// Row gather out[i] = table[idx[i]] (kernel P1).
//
// Replaces the Pallas TPU kernel scripts/pallas_gather_probe.py::
// make_pallas_gather. There ONE kernel instance walked the indices and
// started one HBM->HBM row DMA per index through a ring of `depth` DMA
// semaphores: `depth` was the number of row copies in flight, and the probe
// swept it (8, 16, 32, 64) to find the rate floor of DMA starts in a row
// gather.
//
// What bounds it on the H100: device memory bandwidth. Each output row is
// one random read of row_bytes (256 B for the probe's bf16 [., 128] table,
// two 128-byte lines: whole lines, no waste) plus one write; the index
// stream is 4 or 8 bytes a row. At 2^20 rows of 256 B that is 0.54 GB,
// 0.16 ms at 3.35 TB/s. Random rows leave no reuse in L2 (the table is
// 1.6 GB), so what matters is keeping enough independent reads in flight
// to cover the latency of device memory.
//
// Design (a simple, correct first version): a warp takes DEPTH consecutive
// output rows at a time. Its 32 lanes split the DEPTH rows' 16-byte chunks
// between them (16 lanes cover one 256-byte row), start ALL the loads of
// the group into registers, then all the stores. So `depth` keeps its
// meaning: the row reads each warp keeps in flight (DEPTH * row_bytes / 512
// 16-byte loads per lane); the card has that times the resident warps in
// flight. A grid-stride loop walks the groups. All byte offsets are 64-bit
// (the probe's table is 1.6 GB). Indices are read as int32 or int64 and are
// not range-checked here (the wrapper says so). A ring of TMA bulk copies
// (cp.async.bulk) with mbarriers is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define GR_THREADS 256
#define GR_MAX_CHUNKS 16  // 16-byte chunks per row: rows of at most 256 B

__device__ __forceinline__ long long row_index(const void* idx, int idx_bytes,
                                               long long i) {
    return idx_bytes == 8 ? __ldg((const long long*)idx + i)
                          : (long long)__ldg((const int*)idx + i);
}

template <int DEPTH>
__global__ void __launch_bounds__(GR_THREADS)
gather_rows_kernel(const uint4* __restrict__ table, const void* __restrict__ idx,
                   int idx_bytes, uint4* __restrict__ out, long long n_rows,
                   int chunks_per_row) {
    // DEPTH rows of at most GR_MAX_CHUNKS chunks over 32 lanes
    constexpr int PER_LANE = DEPTH * GR_MAX_CHUNKS / 32;
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * GR_THREADS + threadIdx.x) >> 5;
    const long long n_warps = ((long long)gridDim.x * GR_THREADS) >> 5;
    const int group_chunks = DEPTH * chunks_per_row;

    for (long long row0 = warp * DEPTH; row0 < n_rows; row0 += n_warps * DEPTH) {
        uint4 buf[PER_LANE];
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int j = lane + 32 * k;
            const long long row = row0 + j / chunks_per_row;
            if (j < group_chunks && row < n_rows) {
                const long long src = row_index(idx, idx_bytes, row);
                buf[k] = __ldg(table + src * chunks_per_row + j % chunks_per_row);
            }
        }
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int j = lane + 32 * k;
            const long long row = row0 + j / chunks_per_row;
            if (j < group_chunks && row < n_rows)
                out[row * chunks_per_row + j % chunks_per_row] = buf[k];
        }
    }
}

template <int DEPTH>
static void launch(const void* table, const void* idx, int idx_bytes, void* out,
                   long long n_rows, int cpr, cudaStream_t stream) {
    const long long groups = (n_rows + DEPTH - 1) / DEPTH;
    const long long warps_per_block = GR_THREADS / 32;
    long long blocks = (groups + warps_per_block - 1) / warps_per_block;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond a few waves
    gather_rows_kernel<DEPTH><<<(unsigned)blocks, GR_THREADS, 0, stream>>>(
        (const uint4*)table, idx, idx_bytes, (uint4*)out, n_rows, cpr);
}

// table: [E, row_bytes] rows, out: [n_rows, row_bytes], idx: n_rows indices
// of idx_bytes (4 or 8) each, all contiguous device memory. row_bytes is a
// multiple of 16, at most 256; depth is 8, 16, 32 or 64. Returns
// cudaGetLastError().
extern "C" int gather_rows(const void* table, const void* idx, void* out,
                           long long n_rows, long long row_bytes,
                           long long idx_bytes, long long depth, void* stream) {
    if (row_bytes % 16 != 0 || row_bytes < 16 || row_bytes > 16 * GR_MAX_CHUNKS
        || (idx_bytes != 4 && idx_bytes != 8) || n_rows < 0)
        return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaGetLastError();
    const int cpr = (int)(row_bytes / 16);
    const cudaStream_t s = (cudaStream_t)stream;
    switch (depth) {
        case 8: launch<8>(table, idx, (int)idx_bytes, out, n_rows, cpr, s); break;
        case 16: launch<16>(table, idx, (int)idx_bytes, out, n_rows, cpr, s); break;
        case 32: launch<32>(table, idx, (int)idx_bytes, out, n_rows, cpr, s); break;
        case 64: launch<64>(table, idx, (int)idx_bytes, out, n_rows, cpr, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
