// Fused MLP backward: recompute the chain per tile, then dx, dW, db (kernel B2).
//
// Replaces the Pallas TPU kernel nersemble_tpu/ops/fused_mlp.py::_bwd_kernel
// (launched by _fused_vjp_bwd). Semantics are that kernel's: the forward is
// recomputed from x and the weights with B1-fwd's rounding points (bf16
// input and hidden activations, f32 accumulation); the output activation's
// derivative uses the f32 output; then per layer, last first,
//   dW += h_in^T g   (h_in: the bf16 layer input, in f32; g: f32),
//   db += sum_rows g,
//   dh  = g W^T      with the f32 weights (not the bf16-rounded ones),
// the skip layer's last d_in columns of dh go to dx, and g for the layer
// below is dh masked by (bf16 hidden activation > 0). dx sums in f32.
//
// What bounds it on the H100: arithmetic. Per row the stem recomputes 126k
// bf16 MACs (tensor cores) and does 2 x 126k f32 MACs (dh and dW); the f32
// products run on the CUDA cores, 67 TFLOP/s at most, which is this first
// version's ceiling (a bf16-pair split onto the tensor cores is later work).
//
// Design. The TPU kernel adds each grid step's dW/db into one output block,
// which is race-free only because TPU grid steps run in order. Hopper blocks
// run concurrently, so here a persistent grid (at most one block per SM)
// walks the 64-row tiles, each block adding into its OWN f32 partial of
// every dW and db in device memory (zeroed by the block at start), and a
// second kernel sums the partials in a fixed order: the result is
// deterministic. A 64-row tile keeps its whole recomputed forward in shared
// memory as bf16 (the stem: x 64 x 184 plus 5 hidden layers 64 x 136, 110 KB)
// next to two f32 gradient buffers (64 x 132 each, 66 KB) and one staging
// area (18 KB) through which each layer's weights stream in chunks: 64
// K-columns of B1-fwd's packed bf16 W^T for the mma.sync forward, 32 input
// rows of the f32 [in][out] weights, transposed, for dh. 8 warps: in the
// forward warp w owns rows 16(w%4).. and half of the layer's column tiles;
// in dW a lane owns an input feature k and a warp 8 output columns (the
// partial is stored [out][in], so the read-modify-write is coalesced); in
// dh a lane owns an input feature and a warp 8 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MLP_MAX_LAYERS 8
#define BT 64             // rows per tile
#define BWARPS 8
#define BTHREADS (BWARPS * 32)
#define PAD 8             // bf16 elements of row padding in shared memory
#define KC 64             // K columns per staged bf16 weight chunk
#define WKC 32            // input features per staged f32 weight chunk
#define WKS (WKC + 4)     // row stride of that chunk (transposed: [n][k])
#define GS 132            // f32 row stride of the gradient buffers
#define HALF_NT 8         // 8-column mma tiles per warp: widths up to 128

struct BwdSpec {
    int n_layers;
    int d_in;
    int kx;          // d_in padded to 16
    int out_dim;
    int out_act;     // 0 none, 1 relu, 2 sigmoid
    int h_stride;    // shared row stride of a hidden buffer (elements)
    int has_bias;
    long long part_stride;  // floats per partial
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
};

__device__ __forceinline__ void bwd_mma_16816(float (&c)[4], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bwd_ld_u32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// acc[16 rows x this warp's column tiles] += A[16 x k_len] * W^T[n][k]^T,
// streaming W^T's columns [col0, col0 + k_len) through the staging area.
// a: the warp's first row of the segment. Called by every thread.
__device__ void fwd_segment(float (&acc)[HALF_NT][4],
                            const __nv_bfloat16* a, int a_stride, int k_len,
                            const __nv_bfloat16* __restrict__ wsrc, int w_ld,
                            int col0, __nv_bfloat16* ws, int n_l, int nt0,
                            int nt_count, int g, int tq, int tid) {
    const int ws_stride = KC + PAD;
    for (int c0 = 0; c0 < k_len; c0 += KC) {
        const int clen = k_len - c0 < KC ? k_len - c0 : KC;
        const int vpr = clen / 8;
        __syncthreads();  // every warp is done with the last chunk
        for (int i = tid; i < n_l * vpr; i += BTHREADS) {
            const int r = i / vpr, v = i - r * vpr;
            *reinterpret_cast<uint4*>(ws + r * ws_stride + v * 8) =
                *reinterpret_cast<const uint4*>(
                    wsrc + (long long)r * w_ld + col0 + c0 + v * 8);
        }
        __syncthreads();
        for (int k0 = 0; k0 < clen; k0 += 16) {
            const __nv_bfloat16* ap = a + g * a_stride + c0 + k0 + 2 * tq;
            const uint32_t a0 = bwd_ld_u32(ap);
            const uint32_t a1 = bwd_ld_u32(ap + 8 * a_stride);
            const uint32_t a2 = bwd_ld_u32(ap + 8);
            const uint32_t a3 = bwd_ld_u32(ap + 8 * a_stride + 8);
#pragma unroll
            for (int j = 0; j < HALF_NT; ++j) {
                if (j < nt_count) {
                    const __nv_bfloat16* bp =
                        ws + ((nt0 + j) * 8 + g) * ws_stride + k0 + 2 * tq;
                    bwd_mma_16816(acc[j], a0, a1, a2, a3, bwd_ld_u32(bp),
                                  bwd_ld_u32(bp + 8));
                }
            }
        }
    }
}

__global__ void __launch_bounds__(BTHREADS)
fused_mlp_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ gout,
                     float* __restrict__ dx,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ bias,
                     const float* __restrict__ wf,
                     float* __restrict__ partials, long long n_rows,
                     BwdSpec s) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int xs_stride = s.kx + PAD;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* hs = xs + BT * xs_stride;  // [n_layers - 1][BT][h_stride]
    float* gbuf = reinterpret_cast<float*>(hs + (s.n_layers - 1) * BT * s.h_stride);
    unsigned char* stage = reinterpret_cast<unsigned char*>(gbuf + 2 * BT * GS);
    __nv_bfloat16* ws_bf = reinterpret_cast<__nv_bfloat16*>(stage);
    float* ws_f = reinterpret_cast<float*>(stage);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int rg = warp & 3, ch = warp >> 2;

    float* part = partials + (long long)blockIdx.x * s.part_stride;
    for (long long i = tid; i < s.part_stride; i += BTHREADS) part[i] = 0.f;

    const long long n_tiles = (n_rows + BT - 1) / BT;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long row0 = tile * BT;
        const long long left = n_rows - row0;
        const int rows_here = left < BT ? (int)left : BT;

        __syncthreads();  // the last tile is done with shared memory
        const float* xt = x + row0 * s.d_in;
        for (int i = tid; i < BT * s.kx; i += BTHREADS) {
            const int r = i / s.kx, c = i - r * s.kx;
            const float v = (r < rows_here && c < s.d_in)
                ? xt[(long long)r * s.d_in + c] : 0.f;
            xs[r * xs_stride + c] = __float2bfloat16_rn(v);
        }

        // ---- forward recompute: hidden activations to shared memory, the
        // output's activation derivative times g_out to gbuf[0]
        float* gcur = gbuf;
        float* gnext = gbuf + BT * GS;
        for (int layer = 0; layer < s.n_layers; ++layer) {
            const int n_l = s.n[layer], kh = s.kh[layer], kxl = s.kxl[layer];
            const int k_l = kh + kxl;
            const bool last = layer == s.n_layers - 1;
            const int nt_count = n_l / 16;
            const int nt0 = ch * nt_count;
            float acc[HALF_NT][4];
#pragma unroll
            for (int j = 0; j < HALF_NT; ++j)
                acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
            const __nv_bfloat16* wl = wt + s.w_off[layer];
            if (kh > 0)
                fwd_segment(acc, hs + (layer - 1) * BT * s.h_stride
                                     + rg * 16 * s.h_stride,
                            s.h_stride, kh, wl, k_l, 0, ws_bf, n_l, nt0,
                            nt_count, g, tq, tid);
            if (kxl > 0)
                fwd_segment(acc, xs + rg * 16 * xs_stride, xs_stride, kxl, wl,
                            k_l, kh, ws_bf, n_l, nt0, nt_count, g, tq, tid);
#pragma unroll
            for (int j = 0; j < HALF_NT; ++j) {
                if (j >= nt_count) continue;
                const int col = (nt0 + j) * 8 + 2 * tq;
                float b0 = 0.f, b1 = 0.f;
                if (s.has_bias) {
                    b0 = bias[s.b_off[layer] + col];
                    b1 = bias[s.b_off[layer] + col + 1];
                }
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = rg * 16 + g + 8 * half;
                    float v0 = acc[j][2 * half] + b0;
                    float v1 = acc[j][2 * half + 1] + b1;
                    if (!last) {
                        v0 = v0 > 0.f ? v0 : 0.f;
                        v1 = v1 > 0.f ? v1 : 0.f;
                        *reinterpret_cast<__nv_bfloat162*>(
                            hs + layer * BT * s.h_stride + r * s.h_stride + col) =
                            __floats2bfloat162_rn(v0, v1);
                    } else {
                        float g0 = 0.f, g1 = 0.f;
                        if (r < rows_here) {
                            const float* gr = gout + (row0 + r) * s.out_dim;
                            if (col < s.out_dim) g0 = gr[col];
                            if (col + 1 < s.out_dim) g1 = gr[col + 1];
                        }
                        if (s.out_act == 1) {
                            g0 = v0 > 0.f ? g0 : 0.f;
                            g1 = v1 > 0.f ? g1 : 0.f;
                        } else if (s.out_act == 2) {
                            const float o0 = 1.f / (1.f + expf(-v0));
                            const float o1 = 1.f / (1.f + expf(-v1));
                            g0 = g0 * o0 * (1.f - o0);
                            g1 = g1 * o1 * (1.f - o1);
                        }
                        gcur[r * GS + col] = g0;
                        gcur[r * GS + col + 1] = g1;
                    }
                }
            }
            __syncthreads();  // the next layer reads the other warps' rows
        }

        // ---- backward, last layer first
        bool dx_started = false;
        for (int layer = s.n_layers - 1; layer >= 0; --layer) {
            const int out_r = s.out_real[layer], in_r = s.in_real[layer];
            const int hw = s.hw[layer];
            const __nv_bfloat16* hsrc =
                layer > 0 ? hs + (layer - 1) * BT * s.h_stride : xs;

            // dW_i[n][k] += sum_r h_in[r][k] * g[r][n]
            float* pw = part + s.wf_off[layer];
            for (int kb = 0; kb < in_r; kb += 32) {
                const int k = kb + lane;
                const bool kvalid = k < in_r;
                const __nv_bfloat16* hp = xs;
                int hstr = xs_stride;
                if (kvalid && k < hw) {
                    hp = hsrc + k;
                    hstr = s.h_stride;
                } else if (kvalid) {
                    hp = xs + (k - hw);
                }
                for (int n0 = warp * 8; n0 < out_r; n0 += BWARPS * 8) {
                    float a[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) a[j] = 0.f;
                    for (int r = 0; r < BT; ++r) {
                        const float h = __bfloat162float(hp[r * hstr]);
                        const float4 ga = *reinterpret_cast<const float4*>(
                            gcur + r * GS + n0);
                        const float4 gb = *reinterpret_cast<const float4*>(
                            gcur + r * GS + n0 + 4);
                        a[0] = fmaf(h, ga.x, a[0]);
                        a[1] = fmaf(h, ga.y, a[1]);
                        a[2] = fmaf(h, ga.z, a[2]);
                        a[3] = fmaf(h, ga.w, a[3]);
                        a[4] = fmaf(h, gb.x, a[4]);
                        a[5] = fmaf(h, gb.y, a[5]);
                        a[6] = fmaf(h, gb.z, a[6]);
                        a[7] = fmaf(h, gb.w, a[7]);
                    }
                    if (kvalid) {
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            if (n0 + j < out_r)
                                pw[(long long)(n0 + j) * in_r + k] += a[j];
                    }
                }
            }
            if (s.has_bias) {
                for (int n = tid; n < out_r; n += BTHREADS) {
                    float sum = 0.f;
                    for (int r = 0; r < BT; ++r) sum += gcur[r * GS + n];
                    part[s.db_off[layer] + n] += sum;
                }
            }

            // dh[r][k] = sum_n g[r][n] * W[k][n] in chunks of WKC inputs k
            const float* wl = wf + s.wf_off[layer];
            const bool writes_x = in_r > hw;
            for (int kb = 0; kb < in_r; kb += WKC) {
                const int klen = in_r - kb < WKC ? in_r - kb : WKC;
                __syncthreads();  // every warp is done with the staging area
                for (int i = tid; i < klen * out_r; i += BTHREADS) {
                    const int kk = i / out_r, n = i - kk * out_r;
                    ws_f[n * WKS + kk] = wl[(long long)(kb + kk) * out_r + n];
                }
                __syncthreads();
                const int kk = lane, k = kb + kk, r0 = warp * 8;
                if (kk < klen) {
                    float a[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) a[j] = 0.f;
                    // 4 columns n at a time: one 16-byte broadcast load of g
                    // per row (row stride GS keeps them aligned)
                    const int out4 = out_r & ~3;
                    for (int n = 0; n < out4; n += 4) {
                        const float w0 = ws_f[n * WKS + kk];
                        const float w1 = ws_f[(n + 1) * WKS + kk];
                        const float w2 = ws_f[(n + 2) * WKS + kk];
                        const float w3 = ws_f[(n + 3) * WKS + kk];
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            const float4 gv = *reinterpret_cast<const float4*>(
                                gcur + (r0 + j) * GS + n);
                            a[j] = fmaf(gv.x, w0, a[j]);
                            a[j] = fmaf(gv.y, w1, a[j]);
                            a[j] = fmaf(gv.z, w2, a[j]);
                            a[j] = fmaf(gv.w, w3, a[j]);
                        }
                    }
                    for (int n = out4; n < out_r; ++n) {
                        const float w = ws_f[n * WKS + kk];
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            a[j] = fmaf(gcur[(r0 + j) * GS + n], w, a[j]);
                    }
                    if (k < hw) {  // hidden input: relu mask -> g below
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            const int r = r0 + j;
                            const float h = __bfloat162float(
                                hsrc[r * s.h_stride + k]);
                            gnext[r * GS + k] = h > 0.f ? a[j] : 0.f;
                        }
                    } else {  // network input: dx (rows of this tile only)
                        const int c = k - hw;
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            const int r = r0 + j;
                            if (r < rows_here) {
                                float* p = dx + (row0 + r) * s.d_in + c;
                                *p = dx_started ? *p + a[j] : a[j];
                            }
                        }
                    }
                }
            }
            if (writes_x) dx_started = true;
            __syncthreads();  // gnext and dx complete before the next layer
            float* t = gcur;
            gcur = gnext;
            gnext = t;
        }
    }
}

// partials [n_parts][stride] -> out [stride], summed over parts in order.
__global__ void partial_sum_kernel(const float* __restrict__ partials,
                                   float* __restrict__ out, long long stride,
                                   int n_parts) {
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < stride; j += (long long)gridDim.x * blockDim.x) {
        float sum = 0.f;
        for (int b = 0; b < n_parts; ++b) sum += partials[(long long)b * stride + j];
        out[j] = sum;
    }
}

static long long bwd_smem_bytes(const BwdSpec& s) {
    int n_max = 0;
    for (int i = 0; i < s.n_layers; ++i) n_max = s.n[i] > n_max ? s.n[i] : n_max;
    long long stage = 2LL * n_max * (KC + PAD);
    if (4LL * n_max * WKS > stage) stage = 4LL * n_max * WKS;
    return 2LL * BT * (s.kx + PAD) + 2LL * (s.n_layers - 1) * BT * s.h_stride
           + 4LL * 2 * BT * GS + stage;
}

// x: [n_rows, d_in] f32; g: [n_rows, out_dim] f32 (gradient of the output);
// dx: [n_rows, d_in] f32 out; wt/bias: B1-fwd's packed bf16 W^T and f32
// bias; wf: f32 weights [in][out] per layer, concatenated; partials:
// [n_parts][part_stride] f32 scratch; total: [part_stride] f32 out (every
// dW_i as [out][in], then every db_i). meta: host int64 [n_layers, d_in,
// kx, out_dim, out_act, h_stride, has_bias, part_stride, then per layer: n,
// kh, kxl, w_off, b_off, in_real, out_real, hw, wf_off, db_off].
// Returns cudaGetLastError().
extern "C" int fused_mlp_bwd(const void* x, const void* g, void* dx,
                             const void* wt, const void* bias, const void* wf,
                             void* partials, void* total,
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
    s.part_stride = meta[7];
    for (int i = 0; i < s.n_layers; ++i) {
        const long long* m = meta + 8 + 10 * i;
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
        if (s.n[i] % 16 != 0 || s.n[i] > 16 * HALF_NT
            || (s.kh[i] + s.kxl[i]) % 16 != 0 || s.out_real[i] > s.n[i]
            || s.n[i] > GS - 4)
            return (int)cudaErrorInvalidValue;
    }
    if (n_rows <= 0) return (int)cudaGetLastError();
    const long long smem = bwd_smem_bytes(s);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<<<(unsigned)n_parts, BTHREADS, (size_t)smem,
                           (cudaStream_t)stream>>>(
        (const float*)x, (const float*)g, (float*)dx,
        (const __nv_bfloat16*)wt, (const float*)bias, (const float*)wf,
        (float*)partials, n_rows, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long threads = 256;
    long long blocks = (s.part_stride + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    partial_sum_kernel<<<(unsigned)blocks, (unsigned)threads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)partials, (float*)total, s.part_stride, (int)n_parts);
    return (int)cudaGetLastError();
}
