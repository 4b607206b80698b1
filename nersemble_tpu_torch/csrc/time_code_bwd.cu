// The time codes' backward: the gradient of weight[index] with respect to
// weight [T, D], a segmented row sum in a fixed order (the model layer).
//
// Replaces no Pallas kernel: the JAX package gathers the time codes with
// params["time_embedding"][timesteps] (nersemble_tpu/models/nersemble.py
// _time_codes), whose transpose XLA lowers to a scatter-add. On the card the
// port's gather (models/nersemble.py _gather_rows) ran PyTorch's indexing
// backward: a sort of the indices, then one warp walks each distinct index's
// whole run of duplicates. A batch holds at most 16 timesteps, so a handful
// of warps each walked 8k-23k samples in series: 19 ms a step at the
// flagship's 131,072 samples, 57 ms at the dense configuration's ~372k.
//
// What bounds it on the H100: device memory bandwidth. The gradient [N, D]
// f32 is read once and [T, D] written once: at N = 131,072 and the two
// codes' D = 32 + 128 that is 84 MB, 0.025 ms at 3.35 TB/s.
//
// Design (ops/time_code.py plan() gives every size; all of them follow from
// N, T and D alone, so the order of every sum does too and a run repeats bit
// for bit; no atomics):
// - Pass 1 (tc_rows_kernel), grid (blocks, row tiles). Block b takes samples
//   [b S, (b + 1) S) and splits them into G contiguous group slices; a group
//   is P lanes, lane l owns the columns [4 l, 4 l + 4) (one float4 when the
//   row is 16-byte aligned, else up to four floats). A block's second grid
//   index picks a tile of R rows, so that its shared memory, G tiles of
//   [R, 4 P] f32 (one per group, so no two threads add into one address),
//   stays bounded whatever T is; a sample outside the tile is skipped after
//   its index is read. The samples arrive in ray order, and a ray's samples
//   share one timestep, so a lane carries its sum in registers while the
//   index repeats and adds it to its group's tile when the index changes.
//   Then the block sums its G tiles, in group order, into its partial rows
//   [b, tile rows, D] of the partials buffer [blocks, T, D].
// - Pass 2 (tc_sum_kernel): out[t, d] = the sum over b of partials[b, t, d],
//   in a fixed tree: eight warps each sum a contiguous eighth of the blocks
//   in block order, then the first warp sums the eight in warp order. With
//   no block (N = 0) it writes zeros.
// Indices are int32 or int64 and are not range-checked: a sample whose index
// lies outside [0, T) adds nowhere. The gradient may have any row stride.

#include <cuda_runtime.h>
#include <stdint.h>

#define TC_THREADS 256   // ops/time_code.py THREADS
#define TC_UNROLL 8      // samples a lane loads before it adds any
#define TC_SUM_WARPS 8   // pass 2: block slices per output element

template <typename I>
__device__ __forceinline__ long long tc_index(const I* idx, long long i) {
    return (long long)__ldg(idx + i);
}

// up to four floats of row i at columns [c, c + 4), zeros past D
template <bool VEC>
__device__ __forceinline__ float4 tc_load(const float* g, long long ld, long long i,
                                          int c, int d) {
    const float* p = g + i * ld + c;
    if constexpr (VEC) return __ldcs(reinterpret_cast<const float4*>(p));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) v.x = __ldcs(p);
    if (c + 1 < d) v.y = __ldcs(p + 1);
    if (c + 2 < d) v.z = __ldcs(p + 2);
    if (c + 3 < d) v.w = __ldcs(p + 3);
    return v;
}

__device__ __forceinline__ void tc_add(float4& a, const float4& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// shared memory: [G][R][P] float4 (a group's tile, its rows, its lanes)
template <typename I, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
tc_rows_kernel(const float* __restrict__ g, long long ld, const I* __restrict__ idx,
               float* __restrict__ partials, long long n, int t_rows, int d, int lanes,
               int rows_per_tile, long long per_block, long long per_group) {
    extern __shared__ float4 tile[];
    const int groups = TC_THREADS / lanes;
    const int first = blockIdx.y * rows_per_tile;             // the tile's first row
    const int rows = min(rows_per_tile, t_rows - first);
    for (int k = threadIdx.x; k < groups * rows_per_tile * lanes; k += TC_THREADS)
        tile[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
    const int c = 4 * lane;
    const long long block_lo = (long long)blockIdx.x * per_block;
    const long long block_hi = min(block_lo + per_block, n);
    const long long lo = block_lo + grp * per_group;
    const long long hi = min(lo + per_group, block_hi);
    if (c < d) {
        float4* mine = tile + (long long)grp * rows_per_tile * lanes + lane;
        int cur = -1;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (long long i0 = lo; i0 < hi; i0 += TC_UNROLL) {
            int r[TC_UNROLL];
            float4 v[TC_UNROLL];
#pragma unroll
            for (int u = 0; u < TC_UNROLL; ++u) {
                const long long i = i0 + u;
                const long long row = i < hi ? tc_index(idx, i) - first : -1;
                r[u] = row >= 0 && row < rows ? (int)row : -1;
            }
#pragma unroll
            for (int u = 0; u < TC_UNROLL; ++u)
                if (r[u] >= 0) v[u] = tc_load<VEC>(g, ld, i0 + u, c, d);
#pragma unroll
            for (int u = 0; u < TC_UNROLL; ++u) {
                if (r[u] < 0) continue;
                if (r[u] == cur) {
                    tc_add(acc, v[u]);
                } else {
                    if (cur >= 0) tc_add(mine[cur * lanes], acc);
                    cur = r[u];
                    acc = v[u];
                }
            }
        }
        if (cur >= 0) tc_add(mine[cur * lanes], acc);
    }
    __syncthreads();

    // the block's partial rows: its groups' tiles summed in group order
    float* out = partials + ((long long)blockIdx.x * t_rows + first) * d;
    const float* flat = reinterpret_cast<const float*>(tile);
    for (int k = threadIdx.x; k < rows * d; k += TC_THREADS) {
        const int row = k / d, col = k % d;
        const float* src = flat + (long long)row * lanes * 4 + col;
        float s = src[0];
        for (int q = 1; q < groups; ++q) s += src[(long long)q * rows_per_tile * lanes * 4];
        out[k] = s;
    }
}

__global__ void __launch_bounds__(32 * TC_SUM_WARPS)
tc_sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
              long long blocks, long long elems) {
    __shared__ float part[TC_SUM_WARPS][32];
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    const long long e = (long long)blockIdx.x * 32 + l;
    const long long b0 = blocks * w / TC_SUM_WARPS, b1 = blocks * (w + 1) / TC_SUM_WARPS;
    float s = 0.f;
    if (e < elems) {
#pragma unroll 8
        for (long long b = b0; b < b1; ++b) s += __ldcs(partials + b * elems + e);
    }
    part[w][l] = s;
    __syncthreads();
    if (w == 0 && e < elems) {
        float t = part[0][l];
#pragma unroll
        for (int k = 1; k < TC_SUM_WARPS; ++k) t += part[k][l];
        out[e] = t;
    }
}

template <typename I, bool VEC>
static cudaError_t tc_launch_rows(const float* g, long long ld, const void* idx,
                                  float* partials, long long n, int t_rows, int d,
                                  int lanes, int rows_per_tile, long long blocks,
                                  long long tiles, long long per_block,
                                  long long per_group, long long smem, cudaStream_t s) {
    auto kernel = tc_rows_kernel<I, VEC>;
    static int set_device = -1;  // the device whose attribute is set
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device != set_device) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   227 * 1024);
        if (err == cudaSuccess) set_device = device;
    }
    if (err != cudaSuccess) return err;
    kernel<<<dim3((unsigned)blocks, (unsigned)tiles), TC_THREADS, (size_t)smem, s>>>(
        g, ld, (const I*)idx, partials, n, t_rows, d, lanes, rows_per_tile, per_block,
        per_group);
    return cudaGetLastError();
}

// g: [n, d] f32 rows ld floats apart; idx: n indices of idx_bytes (4 or 8);
// partials: [blocks, t_rows, d] f32 scratch; out: [t_rows, d] f32, all
// device memory. The plan (ops/time_code.py plan()): lanes a group (a power
// of two, 4 lanes >= d), rows_per_tile, blocks x tiles grid, samples
// per_block and per_group, smem bytes of pass 1; vec: the rows are whole
// 16-byte aligned float4s. Returns cudaGetLastError().
extern "C" int time_code_bwd(const void* g, long long ld, const void* idx,
                             long long idx_bytes, void* partials, void* out, long long n,
                             long long t_rows, long long d, long long lanes,
                             long long rows_per_tile, long long blocks, long long tiles,
                             long long per_block, long long per_group, long long smem,
                             long long vec, void* stream) {
    if (n < 0 || t_rows < 0 || d < 1 || lanes < 1 || TC_THREADS % lanes != 0
        || 4 * lanes < d || rows_per_tile < 1 || blocks < 0 || tiles < 0
        || tiles > 65535 || (idx_bytes != 4 && idx_bytes != 8) || smem > 227 * 1024
        || smem < (TC_THREADS / lanes) * rows_per_tile * lanes * 16LL)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const long long elems = t_rows * d;
    if (elems == 0) return (int)cudaGetLastError();
    cudaError_t err = cudaSuccess;
    if (blocks > 0 && tiles > 0) {
        const float* gf = (const float*)g;
        float* pf = (float*)partials;
        const int T = (int)t_rows, D = (int)d, P = (int)lanes, R = (int)rows_per_tile;
        if (idx_bytes == 8)
            err = vec ? tc_launch_rows<long long, true>(gf, ld, idx, pf, n, T, D, P, R, blocks,
                                                        tiles, per_block, per_group, smem, s)
                      : tc_launch_rows<long long, false>(gf, ld, idx, pf, n, T, D, P, R, blocks,
                                                         tiles, per_block, per_group, smem, s);
        else
            err = vec ? tc_launch_rows<int, true>(gf, ld, idx, pf, n, T, D, P, R, blocks,
                                                  tiles, per_block, per_group, smem, s)
                      : tc_launch_rows<int, false>(gf, ld, idx, pf, n, T, D, P, R, blocks,
                                                   tiles, per_block, per_group, smem, s);
        if (err != cudaSuccess) return (int)err;
    }
    const long long grid = (elems + 31) / 32;
    tc_sum_kernel<<<(unsigned)grid, 32 * TC_SUM_WARPS, 0, s>>>(
        (const float*)partials, (float*)out, blocks, elems);
    return (int)cudaGetLastError();
}
