// Fused MLP backward: recompute the chain per tile, then dx, dW, db (kernel B2).
//
// Replaces the Pallas TPU kernel nersemble_tpu/ops/fused_mlp.py::_bwd_kernel
// (launched by _fused_vjp_bwd). Semantics are that kernel's: the forward is
// recomputed from x and the weights with B1-fwd's rounding points (bf16
// input and hidden activations, f32 accumulation); the output activation's
// derivative uses the f32 output; then per layer, last first,
//   dW += h_in^T g   (h_in: the bf16 layer input; g: f32),
//   db += sum_rows g,
//   dh  = g W^T      with the f32 weights (not the bf16-rounded ones),
// the skip layer's last d_in columns of dh go to dx, and g for the layer
// below is dh masked by (bf16 hidden activation > 0). dx sums in f32.
//
// What bounds it on the H100. The function's floor is operations: per stem
// row 126k MACs each for the forward recompute, dW and dh. Every product
// runs on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulation). The f32 operands are split into bf16 terms, v = t0 + t1 +
// ..., each term the round-to-nearest of what the terms before it left: g
// into G terms in the epilogue that makes it, the f32 weights into W terms
// when the weight stream is packed (pack_stream_kernel, at each call). dW =
// sum_a h_in^T g_a takes G products (h_in is exact in bf16), dh the products
// g_a W_b^T with a + b <= ORDER, (G, W, ORDER) = (3, 3, 2) (ops/fused_mlp.py
// says why): 10 bf16 products per MAC of the function, 0.25 ms at the bf16
// peak for the stem at 98,304 rows. The design adds its own traffic: each
// 64-row tile adds its dW into its block's f32 partial (0.51 MB for the
// stem), 1.7 GB at 98,304 rows. Measured (PERF.md), it runs its products at
// ~15% of the bf16 peak, and the products are not what limits it: the
// partial reductions and the latency of each phase (epilogues, barriers,
// device-memory accesses) are, with one 8-warp block per SM (the tile's
// shared memory allows no second).
//
// Design. The TPU kernel adds each grid step's dW/db into one output block,
// which is race-free only because TPU grid steps run in order. Hopper blocks
// run concurrently, so a persistent grid (one block per SM) walks the 64-row
// tiles, each block adding into its OWN f32 partial of every dW and db
// (zeroed by the block at start), and a second kernel sums the partials in a
// fixed order. Within a block each partial element is always added by the
// same thread, in program order, with fire-and-forget reductions
// (red.global.add, four neighbouring columns at a time): the result is
// deterministic. A tile keeps its recomputed forward in shared memory as
// bf16 (the stem: x 64 x 184 plus 5 hidden layers 64 x 136, 110 KB) and the
// G bf16 terms of the current g (64 x 136 each); every layer's bias is
// loaded there once per block. The weights reach the tile as one stream of
// chunks, laid out in device memory exactly as they lie in shared memory
// (64 K-columns of B1-fwd's W^T for the forward; 32 out-
// columns of up to 128 rows of every W term for dh): thread 0 stages each
// with one bulk copy (cp.async.bulk, completing on an mbarrier) into one of
// two buffers while the other is computed on, across phases and tiles (the
// weights do not depend on the rows). All fragments come from ldmatrix
// (.trans for h_in^T and g^T in dW). 8 warps; in the forward and dh a warp
// owns 32 rows x 32 output columns (2 x 4 mma tiles); dh runs in passes of
// 128 input columns, the hidden part last, whose masked result stays in
// registers until every warp is done reading g, then overwrites g's terms
// in place. dW is computed in 32 x 32 blocks of [out][in]. The next tile's x
// arrives by one bulk copy into the hidden layers' space while layer 0's
// backward runs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MLP_MAX_LAYERS 8
#define BT 64             // rows per tile
#define BWARPS 8
#define BTHREADS (BWARPS * 32)
#define PAD 8             // bf16 elements of row padding in shared memory
#define KC 64             // K columns per staged forward weight chunk
#define NC 32             // out columns per staged dh weight chunk
#define PASS 128          // dh input columns per pass
#define MAX_CHUNKS 96     // staged weight chunks per tile

typedef __nv_bfloat16 bf16;

// One staged weight chunk. Its bf16 image (padding included, exactly as it
// lies in a staging buffer) sits at `off` in the weight stream, so one bulk
// copy stages it. A forward chunk is n rows x (KC + PAD) of B1-fwd's W^T,
// K columns [c0, c0 + KC); a dh chunk is `terms` blocks of `rows` x (NC +
// PAD), each block one bf16 term of W rows (packed input columns) [c0, c0 +
// rows), out columns [n0, n0 + NC).
struct Chunk {
    int off;     // element offset of the image in the stream
    int elems;   // its size in elements
    int layer;
    int kind;    // 0 forward, 1 dh
    int rows;    // dh: packed input columns of this pass
    int c0;      // forward: first K column; dh: first packed input column
    int n0;      // dh: first out column
};

struct BwdSpec {
    int n_layers;
    int d_in;
    int kx;          // d_in padded to 16
    int out_dim;
    int out_act;     // 0 none, 1 relu, 2 sigmoid
    int h_stride;    // shared row stride of a hidden buffer (elements)
    int g_stride;    // shared row stride of a g term (elements)
    int n_max;       // widest padded layer output
    int stage_elems; // bf16 elements of one staging buffer
    int w_terms;     // bf16 terms of the f32 weights
    int x_bulk;      // a whole tile's x (f32) fits where the hidden layers lie
    int bias_len;    // floats of B1-fwd's packed bias (sum of the n)
    int has_bias;
    long long part_stride;  // floats per partial
    long long total_stride; // floats of the summed output
    // B1-fwd's packing (padded widths, offsets into the bf16 W^T / bias)
    int n[MLP_MAX_LAYERS];
    int kh[MLP_MAX_LAYERS];
    int kxl[MLP_MAX_LAYERS];
    long long w_off[MLP_MAX_LAYERS];
    long long b_off[MLP_MAX_LAYERS];
    // real widths and offsets of the f32 weights / the partials
    int in_real[MLP_MAX_LAYERS];
    int out_real[MLP_MAX_LAYERS];
    int hw[MLP_MAX_LAYERS];           // hidden input width (0: layer 0)
    long long wf_off[MLP_MAX_LAYERS]; // W_i [in][out] f32 = dW_i [out][in]
    long long db_off[MLP_MAX_LAYERS];
    // a partial holds dW_i as [out][in_pad] (rows 16-byte aligned) at
    // pw_off, then every db_i at pdb_off
    int in_pad[MLP_MAX_LAYERS];
    long long pw_off[MLP_MAX_LAYERS];
    long long pdb_off[MLP_MAX_LAYERS];
    // the weight chunks one tile consumes, in order (the stream repeats
    // from tile to tile: weights do not depend on the rows)
    int n_chunks;
    Chunk chunk[MAX_CHUNKS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// Not volatile: it only reads and writes registers, and the scheduler may
// then interleave the products of independent accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)));
}

// One thread: chunk `bytes` from global `src` into shared `dst`, completing
// on `bar` (which expects exactly these bytes and this one arrival).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void red_add(float* p, float v) {
    asm volatile("red.global.add.f32 [%0], %1;\n" :: "l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void red_add4(float* p, float4 v) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n"
                 :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// v -> its T bf16 terms, each the rounding of what the ones before left.
template <int T>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           __nv_bfloat162 (&t)[T]) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
        t[i] = __floats2bfloat162_rn(v0, v1);
        v0 -= __low2float(t[i]);
        v1 -= __high2float(t[i]);
    }
}

// Column sums of a warp's 32 x 32 f32 block (acc) into dbs[col] for the
// columns below n_cols: the rows summed in registers, then across the eight
// lanes of a column.
__device__ __forceinline__ void column_sums(const float (&acc)[2][4][4],
                                            float* dbs, int col0, int n_cols,
                                            int lane) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float s0 = acc[0][j][0] + acc[0][j][2] + acc[1][j][0] + acc[1][j][2];
        float s1 = acc[0][j][1] + acc[0][j][3] + acc[1][j][1] + acc[1][j][3];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, m);
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        }
        if (lane < 4 && col0 + 8 * j < n_cols) {
            dbs[col0 + 8 * j + 2 * lane] = s0;
            dbs[col0 + 8 * j + 2 * lane + 1] = s1;
        }
    }
}

template <int G, int W, int ORDER>
__global__ void __launch_bounds__(BTHREADS, 1)
fused_mlp_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ gout,
                     float* __restrict__ dx,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ wstream,
                     float* __restrict__ partials, long long n_rows,
                     BwdSpec s) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int xs_stride = s.kx + PAD;
    const int gst = s.g_stride;
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);
    bf16* hs = xs + BT * xs_stride;                        // [n_layers - 1][BT][h_stride]
    bf16* gs = hs + (s.n_layers - 1) * BT * s.h_stride;    // [G][BT][g_stride]
    bf16* stage_buf = gs + G * BT * gst;                   // [2][stage_elems]
    float* dbs = reinterpret_cast<float*>(stage_buf + 2 * s.stage_elems);  // [2][n_max]
    // one mbarrier per staging buffer, one for the x tile
    uint64_t* bars = reinterpret_cast<uint64_t*>(dbs + 2 * s.n_max);
    float* bias_s = reinterpret_cast<float*>(bars + 3);  // every layer's bias
    float* x_stage = reinterpret_cast<float*>(hs);  // free from layer 0's backward on

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int rg = warp >> 2, cq = warp & 3;    // 32-row group, 32-column quarter
    const int i8 = lane & 7, j4 = lane >> 3;    // ldmatrix: row, matrix
    const int a_row = 8 * (j4 & 1), a_col = 8 * (j4 >> 1);  // A (and B^T .trans)
    const int b_row = 8 * (j4 >> 1), b_col = 8 * (j4 & 1);  // B (and A^T .trans)

    float* part = partials + (long long)blockIdx.x * s.part_stride;
    for (long long i = tid; i < s.part_stride / 4; i += BTHREADS)
        reinterpret_cast<float4*>(part)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __threadfence();  // the zeros reach L2 before any thread's red.add

    // the weight chunk stream: chunk c is computed while c + 1 is in
    // flight, whatever phase or tile that belongs to (weights do not depend
    // on the rows). Thread 0 issues each chunk as one bulk copy that
    // completes on its buffer's mbarrier; take() waits there, release()
    // waits for every warp to be done with the buffer and refills it.
    int buf = 0;                  // the buffer take() returns
    int parity = 0;               // bit b: the phase barrier b waits for
    int next = 2 % s.n_chunks;    // the list position to issue
    // thread 0 reads each chunk's place one issue ahead, off its critical path
    int next_off = s.chunk[next].off, next_elems = s.chunk[next].elems;
    auto issue = [&](int pos, int b) {
        const Chunk& ch = s.chunk[pos];
        bulk_load(stage_buf + b * s.stage_elems, wstream + ch.off, 2u * ch.elems,
                  bars + b);
    };
    // a whole tile's x as one bulk copy into x_stage (barrier 2)
    auto x_full = [&](long long t) { return s.x_bulk && (t + 1) * BT <= n_rows; };
    auto issue_x = [&](long long t) {
        bulk_load(x_stage, x + t * BT * s.d_in, 4u * BT * s.d_in, bars + 2);
    };
    for (int i = tid; i < s.bias_len; i += BTHREADS) bias_s[i] = bias[i];
    if (tid == 0) {
        for (int b = 0; b < 3; ++b) mbar_init(bars + b);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        issue(0, 0);
        issue(1 % s.n_chunks, 1);
        if (x_full(blockIdx.x)) issue_x(blockIdx.x);
    }
    __syncthreads();
    auto take = [&]() {
        mbar_wait(bars + buf, (parity >> buf) & 1);
        parity ^= 1 << buf;
        return stage_buf + buf * s.stage_elems;
    };
    auto release = [&]() {
        __syncthreads();
        next = next + 1 == s.n_chunks ? 0 : next + 1;
        if (tid == 0) {
            bulk_load(stage_buf + buf * s.stage_elems, wstream + next_off,
                      2u * next_elems, bars + buf);
            next_off = s.chunk[next].off;
            next_elems = s.chunk[next].elems;
        }
        buf ^= 1;
    };

    // db_layer += the two 32-row groups' column sums in dbs (after a barrier)
    auto add_db = [&](int layer) {
        if (!s.has_bias) return;
        for (int n = tid; n < s.out_real[layer]; n += BTHREADS)
            red_add(part + s.pdb_off[layer] + n, dbs[n] + dbs[s.n_max + n]);
    };

    const long long n_tiles = (n_rows + BT - 1) / BT;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long row0 = tile * BT;
        const long long left = n_rows - row0;
        const int rows_here = left < BT ? (int)left : BT;

        __syncthreads();  // the last tile is done with shared memory
        // the x tile, rounded into xs: from x_stage when it was bulk-loaded
        // (a whole tile), else from device memory
        const float* xt = x + row0 * s.d_in;
        if (x_full(tile)) {
            mbar_wait(bars + 2, (parity >> 2) & 1);
            parity ^= 4;
            xt = x_stage;
        }
        for (int r = warp; r < BT; r += BWARPS)
            for (int c = lane; c < s.kx; c += 32)
                xs[r * xs_stride + c] = __float2bfloat16_rn(
                    r < rows_here && c < s.d_in ? xt[r * s.d_in + c] : 0.f);
        // this thread's g_out values (its output columns of the last layer),
        // loaded now so that the forward hides their latency
        float gpre[2][4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = 32 * rg + 16 * i + g + 8 * (e >> 1);
            const int col = 32 * cq + 8 * j + 2 * tq + (e & 1);
            gpre[i][j][e] = (r < rows_here && col < s.out_dim)
                ? gout[(row0 + r) * s.out_dim + col] : 0.f;
        }

        // ---- forward recompute: hidden activations to shared memory, the
        // output's activation derivative times g_out split into gs
        for (int layer = 0; layer < s.n_layers; ++layer) {
            const int n_l = s.n[layer], kh = s.kh[layer];
            const int k_l = kh + s.kxl[layer];
            const bf16* hprev = hs + (layer - 1) * BT * s.h_stride;
            float acc[2][4][4] = {};
            __syncthreads();  // the x tile or the layer below is complete
            for (int c0 = 0; c0 < k_l; c0 += KC) {
                const int clen = k_l - c0 < KC ? k_l - c0 : KC;
                const bf16* wsm = take();
#pragma unroll
                for (int k0 = 0; k0 < KC; k0 += 16) {
                    if (k0 >= clen) break;
                    const int kk = c0 + k0;  // kh is a multiple of 16
                    const bf16* a = kk < kh ? hprev + kk : xs + (kk - kh);
                    const int ast = kk < kh ? s.h_stride : xs_stride;
                    uint32_t af[2][4];
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                        ldsm_x4(af[i], a + (32 * rg + 16 * i + a_row + i8) * ast + a_col);
#pragma unroll
                    for (int jp = 0; jp < 2; ++jp) {
                        const int n0 = 32 * cq + 16 * jp;
                        if (n0 >= n_l) continue;
                        uint32_t bf[4];
                        ldsm_x4(bf, wsm + (n0 + b_row + i8) * (KC + PAD) + k0 + b_col);
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            mma_16816(acc[i][2 * jp], af[i], bf[0], bf[1]);
                            mma_16816(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
                        }
                    }
                }
                release();
            }
            const bool last = layer == s.n_layers - 1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = 32 * cq + 8 * j + 2 * tq;
                const bool active = col < n_l;
                float b0 = 0.f, b1 = 0.f;
                if (s.has_bias && active) {
                    b0 = bias_s[s.b_off[layer] + col];
                    b1 = bias_s[s.b_off[layer] + col + 1];
                }
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = 32 * rg + 16 * i + g + 8 * half;
                    float v0 = acc[i][j][2 * half] + b0;
                    float v1 = acc[i][j][2 * half + 1] + b1;
                    if (!last) {
                        if (active)
                            *reinterpret_cast<__nv_bfloat162*>(
                                hs + layer * BT * s.h_stride + r * s.h_stride + col) =
                                __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
                        continue;
                    }
                    float g0 = gpre[i][j][2 * half], g1 = gpre[i][j][2 * half + 1];
                    if (s.out_act == 1) {
                        g0 = v0 > 0.f ? g0 : 0.f;
                        g1 = v1 > 0.f ? g1 : 0.f;
                    } else if (s.out_act == 2) {
                        const float o0 = 1.f / (1.f + expf(-v0));
                        const float o1 = 1.f / (1.f + expf(-v1));
                        g0 = g0 * o0 * (1.f - o0);
                        g1 = g1 * o1 * (1.f - o1);
                    }
                    acc[i][j][2 * half] = g0;  // kept for db
                    acc[i][j][2 * half + 1] = g1;
                    if (active) {
                        __nv_bfloat162 t[G];
                        split_pair<G>(g0, g1, t);
#pragma unroll
                        for (int a = 0; a < G; ++a)
                            *reinterpret_cast<__nv_bfloat162*>(
                                gs + a * BT * gst + r * gst + col) = t[a];
                    }
                }
            }
            if (last) column_sums(acc, dbs + rg * s.n_max, 32 * cq, n_l, lane);
        }
        __syncthreads();  // g's terms and dbs complete
        add_db(s.n_layers - 1);

        // ---- backward, last layer first
        bool dx_started = false;
        for (int layer = s.n_layers - 1; layer >= 0; --layer) {
            const int n_l = s.n[layer], kh = s.kh[layer];
            const int k_l = kh + s.kxl[layer];
            const int out_r = s.out_real[layer], in_r = s.in_real[layer];
            const int hw = s.hw[layer];
            const bf16* hprev = hs + (layer - 1) * BT * s.h_stride;
            // packed input column -> real input column of W_i, or -1 (padding)
            auto real_k = [&](int kp) {
                if (kp < kh) return kp < hw ? kp : -1;
                return kp - kh < s.d_in ? hw + kp - kh : -1;
            };

            // the hidden layers are free now: fetch the next tile's x there
            if (layer == 0 && tid == 0 && x_full(tile + gridDim.x))
                issue_x(tile + gridDim.x);

            // dW_i[n][k] += sum_r g[r][n] h_in[r][k]: 32 x 32 blocks of
            // [out][in], M = n, N = packed k, K = the tile's rows
            float* pw = part + s.pw_off[layer];
            const int in_p = s.in_pad[layer];
            const bool vec = hw % 4 == 0;  // 4 packed columns, 4 real ones
            const int mblocks = (n_l + 31) / 32, kblocks = (k_l + 31) / 32;
            for (int blk = warp; blk < mblocks * kblocks; blk += BWARPS) {
                const int m0 = 32 * (blk / kblocks), k0 = 32 * (blk % kblocks);
                float acc[2][4][4] = {};
#pragma unroll
                for (int r0 = 0; r0 < BT; r0 += 16) {
                    uint32_t af[G][2][4];
#pragma unroll
                    for (int a = 0; a < G; ++a)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                        if (m0 + 16 * i < n_l)
                            ldsm_x4_t(af[a][i], gs + a * BT * gst
                                      + (r0 + b_row + i8) * gst + m0 + 16 * i + b_col);
                    uint32_t bf[2][4];
#pragma unroll
                    for (int jp = 0; jp < 2; ++jp) {
                        const int kk = k0 + 16 * jp;
                        if (kk >= k_l) continue;
                        const bf16* h = kk < kh ? hprev + kk : xs + (kk - kh);
                        const int hst = kk < kh ? s.h_stride : xs_stride;
                        ldsm_x4_t(bf[jp], h + (r0 + a_row + i8) * hst + a_col);
                    }
#pragma unroll
                    for (int a = 0; a < G; ++a)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int jp = 0; jp < 2; ++jp) {
                        if (m0 + 16 * i >= n_l || k0 + 16 * jp >= k_l) continue;
                        mma_16816(acc[i][2 * jp], af[a][i], bf[jp][0], bf[jp][1]);
                        mma_16816(acc[i][2 * jp + 1], af[a][i], bf[jp][2], bf[jp][3]);
                    }
                }
                // lanes tq and tq ^ 1 swap halves: the even one then holds
                // 4 neighbouring columns of row g, the odd one of row g + 8,
                // added with one 16-byte reduction
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool odd = tq & 1;
                    const float r0 = __shfl_xor_sync(0xffffffffu,
                                                     odd ? acc[i][j][0] : acc[i][j][2], 1);
                    const float r1 = __shfl_xor_sync(0xffffffffu,
                                                     odd ? acc[i][j][1] : acc[i][j][3], 1);
                    const float4 v = odd ? make_float4(r0, r1, acc[i][j][2], acc[i][j][3])
                                         : make_float4(acc[i][j][0], acc[i][j][1], r0, r1);
                    const int n = m0 + 16 * i + g + (odd ? 8 : 0);
                    const int kp = k0 + 8 * j + 4 * (tq >> 1);
                    if (n >= out_r || kp >= k_l) continue;
                    const int k = real_k(kp);
                    if (vec && k >= 0 && real_k(kp + 3) == k + 3) {
                        red_add4(pw + (long long)n * in_p + k, v);
                        continue;
                    }
                    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int ke = real_k(kp + e);
                        if (ke >= 0) red_add(pw + (long long)n * in_p + ke, vs[e]);
                    }
                }
            }

            // dh[r][k] = sum_n g[r][n] W[k][n] in passes of PASS packed input
            // columns, the last first: pass 0 holds the hidden part, kept in
            // acc until every warp is done reading g
            const int n_pass = (k_l + PASS - 1) / PASS;
            float acc[2][4][4];
            for (int p = n_pass - 1; p >= 0; --p) {
                const int p0 = p * PASS;
                const int pw_cols = k_l - p0 < PASS ? k_l - p0 : PASS;
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
                for (int n0 = 0; n0 < n_l; n0 += NC) {
                    const int clen = n_l - n0 < NC ? n_l - n0 : NC;
                    const bf16* wsm = take();
#pragma unroll
                    for (int k0 = 0; k0 < NC; k0 += 16) {
                        if (k0 >= clen) break;
                        uint32_t af[G][2][4];
#pragma unroll
                        for (int a = 0; a < G; ++a)
#pragma unroll
                        for (int i = 0; i < 2; ++i)
                            ldsm_x4(af[a][i], gs + a * BT * gst
                                    + (32 * rg + 16 * i + a_row + i8) * gst + n0 + k0 + a_col);
                        uint32_t bf[W][2][4];
#pragma unroll
                        for (int jp = 0; jp < 2; ++jp) {
                            const int q0 = 32 * cq + 16 * jp;
                            if (q0 >= pw_cols) continue;
#pragma unroll
                            for (int b = 0; b < W; ++b)
                                ldsm_x4(bf[b][jp], wsm + (b * pw_cols + q0 + b_row + i8) * (NC + PAD)
                                        + k0 + b_col);
                        }
#pragma unroll
                        for (int a = 0; a < G; ++a)
#pragma unroll
                        for (int b = 0; b < W; ++b)
#pragma unroll
                        for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int jp = 0; jp < 2; ++jp) {
                            if (a + b > ORDER || 32 * cq + 16 * jp >= pw_cols) continue;
                            mma_16816(acc[i][2 * jp], af[a][i], bf[b][jp][0], bf[b][jp][1]);
                            mma_16816(acc[i][2 * jp + 1], af[a][i], bf[b][jp][2], bf[b][jp][3]);
                        }
                    }
                    release();
                }
                // network-input columns: dx (rows of this tile only); the
                // skip layer's earlier part is read back, all loads first
                float old[4][2][2][2] = {};
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int c = p0 + 32 * cq + 8 * j + 2 * tq + e - kh;
                    const int r = 32 * rg + 16 * i + g + 8 * half;
                    if (dx_started && c >= 0 && c < s.d_in && r < rows_here)
                        old[j][e][i][half] = dx[(row0 + r) * s.d_in + c];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int c = p0 + 32 * cq + 8 * j + 2 * tq + e - kh;
                    const int r = 32 * rg + 16 * i + g + 8 * half;
                    if (c >= 0 && c < s.d_in && r < rows_here)
                        dx[(row0 + r) * s.d_in + c] = old[j][e][i][half]
                                                      + acc[i][j][2 * half + e];
                }
            }
            if (s.kxl[layer] > 0) dx_started = true;
            if (layer == 0) break;

            // hidden columns (all in pass 0): relu mask of h_in -> g of the
            // layer below, split into gs in place (the last release() was a
            // barrier: no warp reads g any more)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = 32 * cq + 8 * j + 2 * tq;
                const bool active = col < kh;
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = 32 * rg + 16 * i + g + 8 * half;
                    float v0 = 0.f, v1 = 0.f;
                    if (active) {
                        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(
                            hprev + r * s.h_stride + col);
                        v0 = __low2float(h) > 0.f ? acc[i][j][2 * half] : 0.f;
                        v1 = __high2float(h) > 0.f ? acc[i][j][2 * half + 1] : 0.f;
                        __nv_bfloat162 t[G];
                        split_pair<G>(v0, v1, t);
#pragma unroll
                        for (int a = 0; a < G; ++a)
                            *reinterpret_cast<__nv_bfloat162*>(
                                gs + a * BT * gst + r * gst + col) = t[a];
                    }
                    acc[i][j][2 * half] = v0;
                    acc[i][j][2 * half + 1] = v1;
                }
            }
            column_sums(acc, dbs + rg * s.n_max, 32 * cq, kh, lane);
            __syncthreads();  // g's terms and dbs complete
            add_db(layer - 1);
        }
    }
    // the stream ran two chunks ahead: let them land before the block exits
    mbar_wait(bars + buf, (parity >> buf) & 1);
    mbar_wait(bars + (buf ^ 1), (parity >> (buf ^ 1)) & 1);
}

// The weight stream: every chunk's bf16 image, blockIdx.y the chunk. A
// forward chunk copies B1-fwd's W^T; a dh chunk splits the f32 W into
// w_terms bf16 terms, each the rounding of what the ones before left, in the
// packed input order (hidden columns, then the network input), zero-padded.
__global__ void pack_stream_kernel(const bf16* __restrict__ wt,
                                   const float* __restrict__ wf,
                                   bf16* __restrict__ stream, BwdSpec s) {
    const Chunk& ch = s.chunk[blockIdx.y];
    const int layer = ch.layer, n_l = s.n[layer];
    const int kh = s.kh[layer], k_l = kh + s.kxl[layer], hw = s.hw[layer];
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < ch.elems;
         idx += gridDim.x * blockDim.x) {
        bf16 v = __float2bfloat16_rn(0.f);
        if (ch.kind == 0) {
            const int r = idx / (KC + PAD), k = ch.c0 + idx % (KC + PAD);
            if (k < k_l && idx % (KC + PAD) < KC)
                v = wt[s.w_off[layer] + (long long)r * k_l + k];
        } else {
            const int block = ch.rows * (NC + PAD);
            const int t = idx / block, rem = idx % block;
            const int kp = ch.c0 + rem / (NC + PAD), n = ch.n0 + rem % (NC + PAD);
            const int k = kp < kh ? (kp < hw ? kp : -1)
                                  : (kp - kh < s.d_in ? hw + kp - kh : -1);
            if (k >= 0 && n < s.out_real[layer] && rem % (NC + PAD) < NC) {
                float w = wf[s.wf_off[layer] + (long long)k * s.out_real[layer] + n];
                for (int i = 0; i <= t; ++i) {
                    v = __float2bfloat16_rn(w);
                    w -= __bfloat162float(v);
                }
            }
        }
        stream[ch.off + idx] = v;
    }
}

// partials [n_parts][part_stride] -> out [total_stride] (every dW_i as
// [out][in], then every db_i), summed over parts in order.
__global__ void partial_sum_kernel(const float* __restrict__ partials,
                                   float* __restrict__ out, BwdSpec s,
                                   int n_parts) {
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < s.total_stride; j += (long long)gridDim.x * blockDim.x) {
        long long src = -1;
        for (int i = 0; i < s.n_layers; ++i) {
            const long long w = j - s.wf_off[i], b = j - s.db_off[i];
            if (w >= 0 && w < (long long)s.in_real[i] * s.out_real[i])
                src = s.pw_off[i] + w / s.in_real[i] * s.in_pad[i] + w % s.in_real[i];
            else if (s.has_bias && b >= 0 && b < s.out_real[i])
                src = s.pdb_off[i] + b;
        }
        float sum = 0.f;
        if (src >= 0)
            for (int p = 0; p < n_parts; ++p) sum += partials[p * s.part_stride + src];
        out[j] = sum;
    }
}

static long long bwd_smem_bytes(const BwdSpec& s, int g_terms) {
    return 2LL * BT * (s.kx + PAD) + 2LL * (s.n_layers - 1) * BT * s.h_stride
           + 2LL * g_terms * BT * s.g_stride + 2LL * 2 * s.stage_elems
           + 4LL * 2 * s.n_max + 8 * 3 + 4LL * s.bias_len;
}

template <int G, int W, int ORDER>
static int launch(const BwdSpec& s, const void* x, const void* g, void* dx,
                  const void* bias, const void* wstream,
                  void* partials, long long n_rows, long long n_parts,
                  cudaStream_t stream) {
    const long long smem = bwd_smem_bytes(s, G);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_bwd_kernel<G, W, ORDER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<G, W, ORDER><<<(unsigned)n_parts, BTHREADS, (size_t)smem,
                                        stream>>>(
        (const float*)x, (const float*)g, (float*)dx, (const float*)bias, (const bf16*)wstream, (float*)partials, n_rows, s);
    return (int)cudaGetLastError();
}

// x: [n_rows, d_in] f32; g: [n_rows, out_dim] f32 (gradient of the output);
// dx: [n_rows, d_in] f32 out; wt/bias: B1-fwd's packed bf16 W^T and f32
// bias; wf: f32 weights [in][out] per layer, concatenated; wstream: bf16
// scratch for the weight stream (stream_elems elements; packed here from
// wt and wf at each call); partials: [n_parts][part_stride] f32 scratch
// (dW_i as [out][in rounded up to 4], then every db_i); total:
// [total_stride] f32 out (every dW_i as [out][in], then every db_i). meta:
// host int64 [n_layers, d_in, kx, out_dim, out_act, h_stride, has_bias,
// total_stride, g_terms, w_terms, max_order, stream_elems, part_stride, then
// per layer: n, kh, kxl, w_off, b_off, in_real, out_real, hw, wf_off,
// db_off]. The term counts and order must be the instantiated (3, 3, 2).
// Returns cudaGetLastError().
extern "C" int fused_mlp_bwd(const void* x, const void* g, void* dx,
                             const void* wt, const void* bias, const void* wf,
                             void* wstream, void* partials, void* total,
                             const long long* meta, long long n_rows,
                             long long n_parts, void* stream) {
    BwdSpec s;
    s.n_layers = (int)meta[0];
    if (s.n_layers < 1 || s.n_layers > MLP_MAX_LAYERS || n_parts < 1)
        return (int)cudaErrorInvalidValue;
    s.d_in = (int)meta[1];
    s.kx = (int)meta[2];
    s.out_dim = (int)meta[3];
    s.out_act = (int)meta[4];
    s.h_stride = (int)meta[5];
    s.has_bias = (int)meta[6];
    s.total_stride = meta[7];
    const int g_terms = (int)meta[8];
    s.w_terms = (int)meta[9];
    const int max_order = (int)meta[10];
    if (g_terms != 3 || s.w_terms != 3 || max_order != 2) return (int)cudaErrorInvalidValue;
    const long long stream_elems = meta[11];
    s.part_stride = meta[12];
    s.n_max = 0;
    s.bias_len = 0;
    for (int i = 0; i < s.n_layers; ++i) {
        const long long* m = meta + 13 + 10 * i;
        s.n[i] = (int)m[0];
        s.kh[i] = (int)m[1];
        s.kxl[i] = (int)m[2];
        s.w_off[i] = m[3];
        s.b_off[i] = m[4];
        s.in_real[i] = (int)m[5];
        s.out_real[i] = (int)m[6];
        s.hw[i] = (int)m[7];
        s.wf_off[i] = m[8];
        s.db_off[i] = m[9];
        if (s.n[i] % 16 != 0 || s.n[i] > 128 || (s.kh[i] + s.kxl[i]) % 16 != 0
            || s.kh[i] > PASS || s.out_real[i] > s.n[i])
            return (int)cudaErrorInvalidValue;
        s.n_max = s.n[i] > s.n_max ? s.n[i] : s.n_max;
        s.bias_len += s.n[i];
    }
    long long pw = 0;
    for (int i = 0; i < s.n_layers; ++i) {
        s.in_pad[i] = (s.in_real[i] + 3) / 4 * 4;
        s.pw_off[i] = pw;
        pw += (long long)s.out_real[i] * s.in_pad[i];
    }
    for (int i = 0; i < s.n_layers; ++i) {
        s.pdb_off[i] = pw;
        if (s.has_bias) pw += s.out_real[i];
    }
    if ((pw + 3) / 4 * 4 != s.part_stride) return (int)cudaErrorInvalidValue;
    s.g_stride = s.n_max + PAD;
    s.x_bulk = 2LL * (s.n_layers - 1) * BT * s.h_stride >= 4LL * BT * s.d_in;
    const int fwd_stage = s.n_max * (KC + PAD);
    const int dh_stage = s.w_terms * PASS * (NC + PAD);
    s.stage_elems = fwd_stage > dh_stage ? fwd_stage : dh_stage;
    // the tile's weight chunks in the order the kernel takes them: the
    // forward's K chunks layer by layer, then per layer (last first) dh's
    // passes (last first) and their out-column chunks
    s.n_chunks = 0;
    long long off = 0;
    auto add_chunk = [&](int layer, int kind, int rows, int c0, int n0, int elems) {
        if (s.n_chunks == MAX_CHUNKS) return false;
        s.chunk[s.n_chunks++] = Chunk{(int)off, elems, layer, kind, rows, c0, n0};
        off += elems;
        return off < (1LL << 31);
    };
    for (int i = 0; i < s.n_layers; ++i)
        for (int c0 = 0; c0 < s.kh[i] + s.kxl[i]; c0 += KC)
            if (!add_chunk(i, 0, s.n[i], c0, 0, s.n[i] * (KC + PAD)))
                return (int)cudaErrorInvalidValue;
    for (int i = s.n_layers - 1; i >= 0; --i) {
        const int k_l = s.kh[i] + s.kxl[i];
        for (int p = (k_l + PASS - 1) / PASS - 1; p >= 0; --p) {
            const int rows = k_l - p * PASS < PASS ? k_l - p * PASS : PASS;
            for (int n0 = 0; n0 < s.n[i]; n0 += NC)
                if (!add_chunk(i, 1, rows, p * PASS, n0, s.w_terms * rows * (NC + PAD)))
                    return (int)cudaErrorInvalidValue;
        }
    }
    if (off != stream_elems) return (int)cudaErrorInvalidValue;
    if (n_rows <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;

    pack_stream_kernel<<<dim3(16, (unsigned)s.n_chunks), 256, 0, st>>>(
        (const bf16*)wt, (const float*)wf, (bf16*)wstream, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int status = launch<3, 3, 2>(s, x, g, dx, bias, wstream, partials,
                                       n_rows, n_parts, st);
    if (status != 0) return status;
    const long long threads = 256;
    long long blocks = (s.total_stride + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    partial_sum_kernel<<<(unsigned)blocks, (unsigned)threads, 0, st>>>(
        (const float*)partials, (float*)total, s, (int)n_parts);
    return (int)cudaGetLastError();
}
