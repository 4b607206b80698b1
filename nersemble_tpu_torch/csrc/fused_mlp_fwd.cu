// Fused MLP forward: the whole layer chain per tile of rows (kernel B1-fwd).
//
// Replaces the Pallas TPU kernel nersemble_tpu/ops/fused_mlp.py::_fwd_kernel
// (launched by _fused_fwd_impl). Rounding points are JAX's: the input is
// rounded to bf16; bf16 x bf16 products accumulate in f32; the f32 bias is
// added; hidden layers apply relu and round to bf16 before the next layer;
// a skip layer takes [h, x_in] (h first); the last layer's activation
// (none / relu / sigmoid) is applied in f32 and the output is f32.
//
// What bounds it on the H100: per row the stem does ~252 kFLOP against 692 B
// of input and 512 B of output, so it is compute-bound on paper; with
// mma.sync, one block per SM at the stem's shared-memory footprint and no
// overlap of weight staging with math, latency of the fragment loads is what
// bounds this first version.
//
// Design: a block takes TILE_ROWS = 128 rows with 8 warps; warp w owns rows
// [16w, 16w+16) for the whole chain, so activations never leave shared
// memory and a warp only syncs with itself between layers. Activations are
// bf16 in shared memory: the input tile x_in (kept for the skip layer) and
// one hidden buffer, overwritten in place after each layer's products are in
// registers. The stem's weights (126,208 bf16 = 252 KB) do not fit next to
// the activations, so weights are staged ONE LAYER AT A TIME (largest: the
// skip layer, 128 x 304 padded = 78 KB), all warps sharing the stage. The
// wrapper hands them over transposed ([out][in], bf16, zero-padded: K to 16
// for the m16n8k16 bf16 mma.sync, N to 16), so every fragment is a 32-bit
// shared load. Rows are padded by 8 elements, which makes the fragment loads
// bank-conflict free. Ragged K (173, 18, 32 inputs) is zero-padded in shared
// memory; the ragged last tile is zero-filled on load and masked on store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MLP_MAX_LAYERS 8
#define TILE_ROWS 128
#define WARPS (TILE_ROWS / 16)
#define PAD 8        // bf16 elements of row padding in shared memory
#define MAX_NT 16    // 8-column mma tiles per warp: layer widths up to 128

struct MlpSpec {
    int n_layers;
    int d_in;       // input features
    int kx;         // d_in padded to 16
    int out_dim;    // output features
    int out_act;    // 0 none, 1 relu, 2 sigmoid
    int h_stride;   // shared row stride of the hidden buffer (elements)
    int has_bias;
    int n[MLP_MAX_LAYERS];     // padded output width of layer i (16..128)
    int kh[MLP_MAX_LAYERS];    // K taken from the hidden buffer (0: none)
    int kxl[MLP_MAX_LAYERS];   // K taken from x_in (0: none)
    long long w_off[MLP_MAX_LAYERS];  // element offset of W_i^T [n][kh+kxl]
    long long b_off[MLP_MAX_LAYERS];  // element offset of bias_i [n]
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// acc[16 rows x 8*n_tiles cols] += A[16 x k_len] * W^T[n][k]^T.
// a: the warp's first row; w: W^T row 0 at this segment's first K column.
__device__ __forceinline__ void mma_segment(float (&acc)[MAX_NT][4],
                                            const __nv_bfloat16* a,
                                            int a_stride, int k_len,
                                            const __nv_bfloat16* w,
                                            int w_stride, int n_tiles,
                                            int g, int tq) {
    for (int k0 = 0; k0 < k_len; k0 += 16) {
        const __nv_bfloat16* ap = a + g * a_stride + k0 + 2 * tq;
        const uint32_t a0 = ld_u32(ap);
        const uint32_t a1 = ld_u32(ap + 8 * a_stride);
        const uint32_t a2 = ld_u32(ap + 8);
        const uint32_t a3 = ld_u32(ap + 8 * a_stride + 8);
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) {
            if (nt < n_tiles) {
                const __nv_bfloat16* bp = w + (nt * 8 + g) * w_stride + k0 + 2 * tq;
                mma_bf16_16816(acc[nt], a0, a1, a2, a3, ld_u32(bp),
                               ld_u32(bp + 8));
            }
        }
    }
}

__global__ void __launch_bounds__(WARPS * 32)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ bias, long long n_rows,
                     MlpSpec s) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int xs_stride = s.kx + PAD;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* hs = xs + TILE_ROWS * xs_stride;
    __nv_bfloat16* ws = hs + TILE_ROWS * s.h_stride;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const long long row0 = (long long)blockIdx.x * TILE_ROWS;
    const long long left = n_rows - row0;
    const int rows_here = left < TILE_ROWS ? (int)left : TILE_ROWS;

    // input tile -> bf16 (round to nearest even), zero K padding and rows
    const float* xt = x + row0 * s.d_in;
    for (int i = tid; i < TILE_ROWS * s.kx; i += blockDim.x) {
        const int r = i / s.kx, c = i - r * s.kx;
        const float v = (r < rows_here && c < s.d_in)
            ? xt[(long long)r * s.d_in + c] : 0.f;
        xs[r * xs_stride + c] = __float2bfloat16_rn(v);
    }

    for (int layer = 0; layer < s.n_layers; ++layer) {
        const int n_l = s.n[layer], kh = s.kh[layer], kxl = s.kxl[layer];
        const int k_l = kh + kxl, w_stride = k_l + PAD;
        const bool last = layer == s.n_layers - 1;

        __syncthreads();  // input tile written; last layer's weights read
        const uint4* wsrc = reinterpret_cast<const uint4*>(wt + s.w_off[layer]);
        const int vec_per_row = k_l / 8;
        for (int i = tid; i < n_l * vec_per_row; i += blockDim.x) {
            const int r = i / vec_per_row, c = i - r * vec_per_row;
            *reinterpret_cast<uint4*>(ws + r * w_stride + c * 8) = wsrc[i];
        }
        __syncthreads();

        float acc[MAX_NT][4];
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt)
            acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        const int n_tiles = n_l / 8;
        if (kh > 0)
            mma_segment(acc, hs + warp * 16 * s.h_stride, s.h_stride, kh, ws,
                        w_stride, n_tiles, g, tq);
        if (kxl > 0)
            mma_segment(acc, xs + warp * 16 * xs_stride, xs_stride, kxl,
                        ws + kh, w_stride, n_tiles, g, tq);
        __syncwarp();  // every lane has read this warp's hidden rows

#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) {
            if (nt >= n_tiles) continue;
            const int col = nt * 8 + 2 * tq;
            float b0 = 0.f, b1 = 0.f;
            if (s.has_bias) {
                b0 = bias[s.b_off[layer] + col];
                b1 = bias[s.b_off[layer] + col + 1];
            }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = warp * 16 + g + 8 * half;
                float v0 = acc[nt][2 * half] + b0;
                float v1 = acc[nt][2 * half + 1] + b1;
                if (!last) {
                    v0 = v0 > 0.f ? v0 : 0.f;
                    v1 = v1 > 0.f ? v1 : 0.f;
                    *reinterpret_cast<__nv_bfloat162*>(hs + r * s.h_stride + col) =
                        __floats2bfloat162_rn(v0, v1);
                } else if (r < rows_here) {
                    if (s.out_act == 1) {
                        v0 = v0 > 0.f ? v0 : 0.f;
                        v1 = v1 > 0.f ? v1 : 0.f;
                    } else if (s.out_act == 2) {
                        v0 = 1.f / (1.f + expf(-v0));
                        v1 = 1.f / (1.f + expf(-v1));
                    }
                    float* o = out + (row0 + r) * s.out_dim;
                    if (col < s.out_dim) o[col] = v0;
                    if (col + 1 < s.out_dim) o[col + 1] = v1;
                }
            }
        }
    }
}

static long long smem_bytes(const MlpSpec& s) {
    long long w_max = 0;
    for (int i = 0; i < s.n_layers; ++i) {
        const long long w = (long long)s.n[i] * (s.kh[i] + s.kxl[i] + PAD);
        if (w > w_max) w_max = w;
    }
    return 2 * ((long long)TILE_ROWS * (s.kx + PAD)
                + (long long)TILE_ROWS * s.h_stride + w_max);
}

// x: [n_rows, d_in] f32; out: [n_rows, out_dim] f32; wt: packed bf16 W^T
// blocks; bias: packed f32 (may be null when has_bias is 0). meta: host
// int64 [n_layers, d_in, kx, out_dim, out_act, h_stride, has_bias, then per
// layer: n, kh, kxl, w_off, b_off]. Returns cudaGetLastError().
extern "C" int fused_mlp_fwd(const void* x, void* out, const void* wt,
                             const void* bias, const long long* meta,
                             long long n_rows, void* stream) {
    MlpSpec s;
    s.n_layers = (int)meta[0];
    if (s.n_layers < 1 || s.n_layers > MLP_MAX_LAYERS)
        return (int)cudaErrorInvalidValue;
    s.d_in = (int)meta[1];
    s.kx = (int)meta[2];
    s.out_dim = (int)meta[3];
    s.out_act = (int)meta[4];
    s.h_stride = (int)meta[5];
    s.has_bias = (int)meta[6];
    for (int i = 0; i < s.n_layers; ++i) {
        const long long* m = meta + 7 + 5 * i;
        s.n[i] = (int)m[0];
        s.kh[i] = (int)m[1];
        s.kxl[i] = (int)m[2];
        s.w_off[i] = m[3];
        s.b_off[i] = m[4];
        if (s.n[i] % 16 != 0 || s.n[i] > 8 * MAX_NT || (s.kh[i] + s.kxl[i]) % 16 != 0)
            return (int)cudaErrorInvalidValue;
    }
    if (n_rows <= 0) return (int)cudaGetLastError();
    const long long smem = smem_bytes(s);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
    fused_mlp_fwd_kernel<<<(unsigned)blocks, WARPS * 32, (size_t)smem,
                           (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, (const __nv_bfloat16*)wt,
        (const float*)bias, n_rows, s);
    return (int)cudaGetLastError();
}
