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
// ([6,537,216, 64] bf16) it must read 0.84 GB and write 3.35 GB (1.249 ms
// at 3.35 TB/s); nothing is computed. Every level offset, size and shift is
// a multiple of 32 rows (quad_layout.cuh), so a 32-row group lies in one
// level and each quarter's rolled rows of a group are one contiguous run.
//
// Rows of 128 to 2048 bytes, quad_build_tma_kernel: source-major. An
// output-major build gathers row e's quarters from rows e, e+s_z, e+s_x and
// e+s_xz, so each source row is read four times, by output rows 72k-153k
// rows apart in the sweep (the flagship's hashed levels): 46-98 MB of
// traffic apart, more than the 50 MB L2, so most re-reads come from device
// memory (scripts/bench_quad_build.py --diag on an H100 80GB HBM3 at 700 W:
// 2.21-2.31 ms; the same kernel with every shift 0, 1.51-1.65). Here a
// block of one warp walks spans of consecutive
// source rows: one thread loads a span once into a ring of shared-memory
// stages with one cp.async.bulk (completing on the stage's mbarrier), then
// stores each 32-row group of it four times with 2D TMA tensor stores:
// quarter q of source row r belongs in output row off + (r - off - s_q) mod
// size at column q*W, and for a group those rows are one contiguous run, so
// each store is one [32 rows, W] box into the [E, 4W] output (at the
// flagship a box row is one whole 128-byte line), marked evict-first in L2.
// Each source byte is read once; the level is found once per group, walking
// forward from the previous one. What still bounds it: each output row is
// written in four pieces at four places; with every shift 0, where the four
// pieces land side by side, it runs a little faster, and plain stores from
// shared memory in place of the TMA stores, more stages or larger spans ran
// no faster (PERF.md section 6).
//
// Narrower rows (16 to 96 bytes; also 2064 to 4096, where a box row would
// exceed 256 8-byte elements), quad_build_rows_kernel: output-major, one
// thread per 16-byte chunk of an output row, a warp writing 512 contiguous
// bytes. A quarter piece under 128 bytes would write lines in part, and the
// source-major build ran slower there. Its table loads are marked
// evict-last and its stores streaming, so the re-read rows stay in L2
// longer; each thread finds its level by a binary search of the offsets in
// shared memory.
//
// Narrow rows (the single-grid field's [6,184,960, 2] table: 4 bytes in
// bf16, 8 in f32), quad_build_narrow_kernel: output-major, and bound by its
// instructions where each row walks the levels (three times, for 16 bytes
// written). A warp builds one 32-row group: it finds the group's level with
// one ballot (quad_layout.cuh), each quarter load reads 32 (or 16)
// consecutive rows, and each store of the warp is 512 contiguous bytes.
//
// Rows of 2 bytes (one bf16 feature: the single-grid table's column that
// one rank of two holds under the feature-sharded layout, [6,184,960, 1]),
// quad_build_half_kernel: output-major, a warp builds two 32-row groups.
// A group's output is one contiguous 256-byte run of 16 chunks of 16
// bytes, and each of 16 lanes owns one chunk: rows e and e + 1 (e even),
// whose four quarters it reads as one 4-byte word per quarter (the two
// rows' sources are neighbours: every shift is a multiple of 32 rows) and
// interleaves with byte permutes. Each quarter load of a group is one
// contiguous 64-byte run.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_layout.cuh"

#define QB_TMA_MIN_ROW_BYTES 128  // narrower quarter pieces write lines in part
#define QB_TMA_MAX_ROW_BYTES 2048  // a box row of at most 256 8-byte elements
#define QB_STAGE_BYTES 16384       // the TMA kernel's span target
#define QB_SMEM_BYTES 98304        // the TMA kernel's ring, at most

__device__ __forceinline__ uint32_t qb_smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Spans of span_rows source rows (the last may be shorter; all multiples of
// 32): span u = blockIdx.x + k * gridDim.x for k = 0, 1, ... Stage k %
// n_stages holds span k; loads run n_stages - 1 spans ahead of the stores,
// and a stage is reloaded once the stores that read it are done reading.
__global__ void __launch_bounds__(32)
quad_build_tma_kernel(const unsigned char* __restrict__ table,
                      const __grid_constant__ CUtensorMap out_map,
                      long long n_rows, int row_bytes, int span_rows,
                      int n_stages, const __grid_constant__ QuadLayout layout) {
    extern __shared__ __align__(128) unsigned char stage[];
    const long long stage_bytes = (long long)span_rows * row_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(stage + n_stages * stage_bytes);
    if (threadIdx.x != 0) return;
    for (int i = 0; i < n_stages; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(qb_smem_u32(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

    const long long n_spans = (n_rows + span_rows - 1) / span_rows;
    const long long my_spans = blockIdx.x < n_spans
        ? (n_spans - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    auto first_row = [&](long long k) {
        return (blockIdx.x + k * gridDim.x) * (long long)span_rows;
    };
    auto load = [&](long long k) {
        const long long r0 = first_row(k);
        const uint32_t bytes =
            (uint32_t)(min((long long)span_rows, n_rows - r0) * row_bytes);
        const int st = (int)(k % n_stages);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(qb_smem_u32(bars + st)), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                     "[%0], [%1], %2, [%3];\n"
                     :: "r"(qb_smem_u32(stage + st * stage_bytes)),
                        "l"(table + r0 * row_bytes), "r"(bytes),
                        "r"(qb_smem_u32(bars + st)) : "memory");
    };
    const int quarter_cols = row_bytes / 8;  // the map's 8-byte elements
    const uint64_t map = reinterpret_cast<uint64_t>(&out_map);
    uint64_t once;  // the output is written once: evict it from L2 first
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(once));
    for (long long k = 0; k < n_stages - 1 && k < my_spans; ++k) load(k);
    int l = 0;  // spans ascend, so the level only moves forward
    for (long long k = 0; k < my_spans; ++k) {
        const int st = (int)(k % n_stages);
        const uint32_t parity = (uint32_t)((k / n_stages) & 1);
        uint32_t done = 0;
        while (!done)
            asm volatile("{\n .reg .pred p;\n"
                         " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                         " selp.u32 %0, 1, 0, p;\n}\n"
                         : "=r"(done) : "r"(qb_smem_u32(bars + st)), "r"(parity)
                         : "memory");
        const long long r0 = first_row(k);
        const int rows = (int)min((long long)span_rows, n_rows - r0);
        const uint32_t src = qb_smem_u32(stage + st * stage_bytes);
        for (int g = 0; g < rows; g += QUAD_GROUP) {
            const long long row = r0 + g;
            while (l + 1 < layout.n_levels && row >= layout.offset[l + 1]) ++l;
            const long long off = layout.offset[l], size = layout.size[l];
            const uint32_t group = src + (uint32_t)(g * row_bytes);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                long long o = row;
                if (q > 0) {
                    o = row - off - layout.shift[q - 1][l];
                    if (o < 0) o += size;
                    o += off;
                }
                asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
                             ".L2::cache_hint [%0, {%1, %2}], [%3], %4;\n"
                             :: "l"(map), "r"(q * quarter_cols), "r"((int)o), "r"(group),
                                "l"(once) : "memory");
            }
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (k + n_stages - 1 < my_spans) {
            // span k + n_stages - 1 reuses the stage of span k - 1, whose
            // stores are the group before the latest
            asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
            load(k + n_stages - 1);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ROW_WORDS: a row's 4-byte words (1: 4-byte rows, 2: 8-byte rows). A warp
// builds one 32-row group: its output is 32 (4-byte rows) or 64 (8-byte
// rows) 16-byte chunks, and lane i writes chunks i (and i + 32), so each
// store of the warp is 512 contiguous bytes; each quarter load is 32 (or
// 16) consecutive rows.
template <int ROW_WORDS>
__global__ void __launch_bounds__(256)
quad_build_narrow_kernel(const uint32_t* __restrict__ table, uint4* __restrict__ out,
                         int n_rows, const __grid_constant__ QuadLayout layout) {
    __shared__ LevelTable levels;
    const LaneLevel mine = lane_level(layout, levels);
    const int lane = threadIdx.x & 31;
    const int row0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * QUAD_GROUP;
    if (row0 >= n_rows) return;  // warp-uniform: n_rows is a multiple of 32
    const Group grp = group_of(mine, level_of(row0, mine));
    if (ROW_WORDS == 1) {
        const int e = row0 + lane;
        out[e] = make_uint4(__ldg(table + e),
                            __ldg(table + rolled_forward(e, grp, grp.shift[0])),
                            __ldg(table + rolled_forward(e, grp, grp.shift[1])),
                            __ldg(table + rolled_forward(e, grp, grp.shift[2])));
    } else {
        // chunk c is half c & 1 of row c >> 1: quarters 0, 1 or 2, 3
        const uint2* rows = reinterpret_cast<const uint2*>(table);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int c = 32 * k + lane, e = row0 + (c >> 1);
            const bool hi = c & 1;
            const uint2 a = __ldg(rows + (hi ? rolled_forward(e, grp, grp.shift[1]) : e));
            const uint2 b = __ldg(rows + rolled_forward(e, grp, hi ? grp.shift[2] : grp.shift[0]));
            out[2LL * row0 + c] = make_uint4(a.x, a.y, b.x, b.y);
        }
    }
}

// Lanes 0-15 build group row0 and lanes 16-31 group row0 + 32, lane j of a
// half the rows 2j and 2j + 1 of its group. Both groups' levels are found
// by the whole warp (one ballot each) before a lane past the rows returns.
__global__ void __launch_bounds__(256)
quad_build_half_kernel(const uint32_t* __restrict__ pairs, uint4* __restrict__ out,
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
    // a word holds rows 2k (low half) and 2k + 1 (high half)
    const uint32_t q0 = __ldg(pairs + (e >> 1));
    const uint32_t q1 = __ldg(pairs + (rolled_forward(e, grp, grp.shift[0]) >> 1));
    const uint32_t q2 = __ldg(pairs + (rolled_forward(e, grp, grp.shift[1]) >> 1));
    const uint32_t q3 = __ldg(pairs + (rolled_forward(e, grp, grp.shift[2]) >> 1));
    // row e: q0, q1, q2, q3 of the low halves; row e + 1: of the high halves
    out[e >> 1] = make_uint4(__byte_perm(q0, q1, 0x5410), __byte_perm(q2, q3, 0x5410),
                             __byte_perm(q0, q1, 0x7632), __byte_perm(q2, q3, 0x7632));
}

// One thread per 16-byte chunk of an output row; block (4 * cpq, rows), at
// most 1024 threads (one 4096-byte row).
__global__ void quad_build_rows_kernel(const uint4* __restrict__ table,
                                       uint4* __restrict__ out, long long n_rows,
                                       int chunks_per_quarter,
                                       const __grid_constant__ QuadLayout layout) {
    __shared__ long long offsets[QUAD_MAX_LEVELS];
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    if (t < layout.n_levels) offsets[t] = layout.offset[t];
    __syncthreads();
    const long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    if (e >= n_rows) return;
    const int q = threadIdx.x / chunks_per_quarter;
    const int c = threadIdx.x - q * chunks_per_quarter;
    long long src = e;
    if (q > 0) {
        int lo = 0, hi = layout.n_levels - 1;  // the last level at or below e
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (offsets[mid] <= e) lo = mid; else hi = mid - 1;
        }
        const long long off = offsets[lo];
        long long r = e - off + layout.shift[q - 1][lo];
        if (r >= layout.size[lo]) r -= layout.size[lo];
        src = off + r;
    }
    // a source row is read four times, by output rows far apart: keep the
    // table in L2 ahead of the output, which is written once
    uint64_t keep;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));
    uint4 v;
    asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(table + src * chunks_per_quarter + c), "l"(keep));
    __stcs(out + e * 4 * chunks_per_quarter + threadIdx.x, v);
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda link)
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                             cudaEnableDefault, &found) == cudaSuccess
            && found == cudaDriverEntryPointSuccess)
            encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
    return encode;
}

static int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
}

// A 2D map of the [E rows, 4W] output in 8-byte elements, boxes of [box_rows, W]
static bool encode_output_map(CUtensorMap* map, void* out, long long n_rows,
                              long long row_bytes, int box_rows) {
    PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    const cuuint64_t dims[2] = {(cuuint64_t)(4 * row_bytes / 8), (cuuint64_t)n_rows};
    const cuuint64_t strides[1] = {(cuuint64_t)(4 * row_bytes)};
    const cuuint32_t box[2] = {(cuuint32_t)(row_bytes / 8), (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode != nullptr
           && encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, out, dims, strides, box,
                     unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static int launch_tma(const void* table, void* out, long long n_rows,
                      long long row_bytes, const QuadLayout& layout,
                      cudaStream_t stream) {
    CUtensorMap map;
    if (!encode_output_map(&map, out, n_rows, row_bytes, QUAD_GROUP))
        return (int)cudaErrorNotSupported;
    const int span_rows = row_bytes * QUAD_GROUP >= QB_STAGE_BYTES
        ? QUAD_GROUP : (int)(QB_STAGE_BYTES / row_bytes / QUAD_GROUP * QUAD_GROUP);
    const long long stage_bytes = span_rows * row_bytes;
    const long long fit = QB_SMEM_BYTES / stage_bytes;  // 2 to 4 stages
    const int n_stages = fit < 2 ? 2 : fit > 4 ? 4 : (int)fit;
    const int smem = (int)(n_stages * stage_bytes + n_stages * sizeof(uint64_t));
    cudaFuncSetAttribute(quad_build_tma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quad_build_tma_kernel, 32, smem);
    const long long n_spans = (n_rows + span_rows - 1) / span_rows;
    const long long resident = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(n_spans < resident ? n_spans : resident);
    quad_build_tma_kernel<<<grid, 32, smem, stream>>>(
        (const unsigned char*)table, map, n_rows, (int)row_bytes,
        span_rows, n_stages, layout);
    return (int)cudaGetLastError();
}

// table/out: device pointers (out 16-byte aligned, table aligned to 4
// bytes for 2-byte rows, to its rows for 4 and 8, else to 16 bytes), rows
// of row_bytes (2, 4, 8, or a multiple of 16 up to 4096) contiguous, under
// 2^31 rows. meta: host int64 [n_levels,
// offsets..., sizes..., shift_z..., shift_x..., shift_xz...] (read_layout's
// invariant). Returns cudaGetLastError().
extern "C" int quad_build(const void* table, void* out, long long n_rows,
                          long long row_bytes, const long long* meta,
                          void* stream) {
    QuadLayout layout;
    const bool narrow = row_bytes == 2 || row_bytes == 4 || row_bytes == 8;
    if ((row_bytes % 16 != 0 && !narrow) || row_bytes > 4096 || n_rows < 0
        || n_rows >= (1LL << 31) || !read_layout(meta, n_rows, layout)
        || (uintptr_t)table % (row_bytes == 2 ? 4 : narrow ? row_bytes : 16) != 0
        || (uintptr_t)out % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (row_bytes == 2) {
        const long long per_block = 8LL * 2 * QUAD_GROUP;
        const unsigned grid = (unsigned)((n_rows + per_block - 1) / per_block);
        quad_build_half_kernel<<<grid, 256, 0, st>>>((const uint32_t*)table, (uint4*)out,
                                                     (int)n_rows, layout);
        return (int)cudaGetLastError();
    }
    if (narrow) {
        const long long per_block = 8LL * QUAD_GROUP;
        const unsigned grid = (unsigned)((n_rows + per_block - 1) / per_block);
        if (row_bytes == 4)
            quad_build_narrow_kernel<1><<<grid, 256, 0, st>>>(
                (const uint32_t*)table, (uint4*)out, (int)n_rows, layout);
        else
            quad_build_narrow_kernel<2><<<grid, 256, 0, st>>>(
                (const uint32_t*)table, (uint4*)out, (int)n_rows, layout);
        return (int)cudaGetLastError();
    }
    if (row_bytes >= QB_TMA_MIN_ROW_BYTES && row_bytes <= QB_TMA_MAX_ROW_BYTES)
        return launch_tma(table, out, n_rows, row_bytes, layout, st);
    const int cpq = (int)(row_bytes / 16);
    const int per_row = 4 * cpq;
    const int rows_per_block = per_row >= 256 ? 1 : 256 / per_row;
    dim3 block(per_row, rows_per_block);
    dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
    quad_build_rows_kernel<<<grid, block, 0, st>>>(
        (const uint4*)table, (uint4*)out, n_rows, cpq, layout);
    return (int)cudaGetLastError();
}
