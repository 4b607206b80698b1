// The SE(3) deformation field's elementwise chain (the model layer): the
// stem's input encoding, and the exponential map of the head's screw axis
// with its NaN guard, forward and backward.
//
// Replaces no Pallas kernel: the JAX package writes the chain as jnp ops
// (nersemble_tpu/ops/posenc.py windowed_posenc and the concatenation with the
// warp code, nersemble_tpu/utils/se3.py se3_apply, the guard in
// nersemble_tpu/models/deformation.py), which XLA fuses. In eager PyTorch it
// was ~150 ops a field chunk in the forward (the exp map twice: once for the
// guard's values, once to differentiate) and ~100 autograd nodes in the
// backward, each microseconds of card time and tens of microseconds of the
// host's: the host set the training step's pace.
//
// What bounds the kernels on the H100: device memory bandwidth. At N rows:
// - warp_input_kernel reads the positions [N, 3] and the warp code [N, D] and
//   writes the stem's input [N, 6F + 3 + D], all f32;
// - se3_warp_fwd_kernel reads the head's first 6 columns (one 32-byte sector
//   a row) and the positions, and writes the offsets [N, 3] and the screw
//   [N, 6] (the backward's copy, so that the head's [N, H] need not be kept);
// - se3_warp_bwd_kernel reads the offsets' gradient, the screw and the
//   positions, and writes the head's gradient [N, H], zero past column 6.
//
// Arithmetic: f32 throughout, with IEEE sinf / cosf / sqrtf and division (the
// library builds without fast math), in the order of the PyTorch chain it
// replaces (ops/posenc.py windowed_posenc, utils/se3.py se3_apply,
// ops/se3_warp.py se3_offsets_plain); only multiply-adds may contract. Every
// branch of the chain is kept: the Taylor polynomials where |r|^2 < 1e-8, the
// trigonometric forms elsewhere, and the guard: a row whose warp is NaN
// anywhere takes the position in those coordinates and has no gradient
// (nersemble_tpu_torch/models/deformation.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SW_THREADS 256     // threads a block; se3_warp_bwd_kernel's rows a block
#define SW_INPUT_ROWS 32   // rows of the stem's input a block writes
#define SW_MAX_FREQ 32     // ops/se3_warp.py MAX_FREQ
#define SW_SCREW 6         // v (translation) then r (rotation)

// the PyTorch chain's Python constants, rounded to f32 as its scalar ops do
#define SW_TWO_PI ((float)6.283185307179586)   // 2.0 * np.pi
#define SW_PI ((float)3.141592653589793)       // torch.pi
#define SW_SIXTH ((float)(1.0 / 6.0))          // 1.0 / 6.0
#define SW_EPS 1e-8f                           // utils/se3.py _EPS

// ---- the stem's input --------------------------------------------------------
// Row i: [sin(2 pi x_d 2^f) w_f for d, f (d-major)] [cos(...) w_f] [2 pi x_d]
// [code_i]: windowed_posenc at min_freq_exp 0, max_freq_exp F - 1 (bands and
// frequencies 0..F-1 and 2^0..2^(F-1), exact in f32), then the concatenation.
// w_f is utils/windows.py posenc_window's Hann window at window_param, or 1
// (windowed = 0). A block writes SW_INPUT_ROWS whole rows, element by element,
// so that consecutive threads store consecutive floats.
__global__ void __launch_bounds__(SW_THREADS)
warp_input_kernel(const float* __restrict__ pos, long long pos_ld,
                  const float* __restrict__ code, long long code_ld,
                  float* __restrict__ out, long long n, int n_freq, int d_code,
                  float window_param, int windowed) {
    __shared__ float window[SW_MAX_FREQ];
    if ((int)threadIdx.x < n_freq) {
        float w = 1.f;
        if (windowed) {
            const float x = fminf(fmaxf(window_param - (float)threadIdx.x, 0.f), 1.f);
            w = 0.5f * (1.f - cosf(SW_PI * x));
        }
        window[threadIdx.x] = w;
    }
    __syncthreads();
    const int half = 3 * n_freq, enc = 2 * half, width = enc + 3 + d_code;
    const long long row0 = (long long)blockIdx.x * SW_INPUT_ROWS;
    const int rows = (int)min((long long)SW_INPUT_ROWS, n - row0);
    float* dst = out + row0 * width;
    for (int e = threadIdx.x; e < rows * width; e += SW_THREADS) {
        const int r = e / width, c = e - r * width;
        const long long row = row0 + r;
        float v;
        if (c >= enc + 3) {
            v = __ldg(code + row * code_ld + (c - enc - 3));
        } else if (c >= enc) {
            v = __ldg(pos + row * pos_ld + (c - enc)) * SW_TWO_PI;
        } else {
            const bool is_cos = c >= half;
            const int k = is_cos ? c - half : c, d = k / n_freq, f = k - d * n_freq;
            const float a = (__ldg(pos + row * pos_ld + d) * SW_TWO_PI) * (float)(1u << f);
            v = window[f] * (is_cos ? cosf(a) : sinf(a));
        }
        dst[e] = v;
    }
}

// ---- the exponential map -----------------------------------------------------
struct Se3Coeffs {
    float t2, cs, a, b, c;  // |r|^2, cos t, sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3
    float th, sn, co;       // t, sin t, cos t (the trigonometric forms only)
    bool small;             // t2 < 1e-8: the Taylor polynomials
};

__device__ __forceinline__ float dot3(const float* x, const float* y) {
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

__device__ __forceinline__ void cross3(const float* x, const float* y, float* out) {
    out[0] = x[1] * y[2] - x[2] * y[1];
    out[1] = x[2] * y[0] - x[0] * y[2];
    out[2] = x[0] * y[1] - x[1] * y[0];
}

// utils/se3.py _coeffs; the branch the double where selects
__device__ __forceinline__ Se3Coeffs se3_coeffs(const float* r) {
    Se3Coeffs k;
    k.t2 = dot3(r, r);
    k.small = k.t2 < SW_EPS;
    if (k.small) {
        k.th = k.sn = k.co = 0.f;
        k.cs = 1.f - k.t2 / 2.f + k.t2 * k.t2 / 24.f;
        k.a = 1.f - k.t2 / 6.f;
        k.b = 0.5f - k.t2 / 24.f;
        k.c = SW_SIXTH - k.t2 / 120.f;
    } else {
        k.th = sqrtf(k.t2);
        k.sn = sinf(k.th);
        k.co = cosf(k.th);
        k.cs = k.co;
        k.a = k.sn / k.th;
        k.b = (1.f - k.co) / k.t2;
        k.c = (k.th - k.sn) / (k.th * k.t2);
    }
    return k;
}

// utils/se3.py se3_apply: exp([v, r]) p = cos(t) p + a (r x p) + b r (r . p)
// + (1 - c t^2) v + b (r x v) + c r (r . v)
__device__ __forceinline__ void se3_point(const float* v, const float* r, const float* p,
                                          const Se3Coeffs& k, float* w) {
    float rxp[3], rxv[3];
    cross3(r, p, rxp);
    cross3(r, v, rxv);
    const float rp = dot3(r, p), rv = dot3(r, v), m = 1.f - k.c * k.t2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float rotated = k.cs * p[j] + k.a * rxp[j] + (k.b * r[j]) * rp;
        const float t = m * v[j] + k.b * rxv[j] + (k.c * r[j]) * rv;
        w[j] = rotated + t;
    }
}

// Row i: the guarded warp's offsets (warped - p), where a row with a NaN
// anywhere takes p in its NaN coordinates; the screw's copy.
__global__ void __launch_bounds__(SW_THREADS)
se3_warp_fwd_kernel(const float* __restrict__ head, long long head_ld,
                    const float* __restrict__ pos, long long pos_ld,
                    float* __restrict__ off, float* __restrict__ screw, long long n) {
    const long long i = (long long)blockIdx.x * SW_THREADS + threadIdx.x;
    if (i >= n) return;
    float h[SW_SCREW], p[3], w[3];
#pragma unroll
    for (int j = 0; j < SW_SCREW; ++j) h[j] = __ldg(head + i * head_ld + j);
#pragma unroll
    for (int j = 0; j < 3; ++j) p[j] = __ldg(pos + i * pos_ld + j);
    const Se3Coeffs k = se3_coeffs(h + 3);
    se3_point(h, h + 3, p, k, w);
    const bool bad = isnan(w[0]) || isnan(w[1]) || isnan(w[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) off[3 * i + j] = (bad && isnan(w[j]) ? p[j] : w[j]) - p[j];
#pragma unroll
    for (int j = 0; j < SW_SCREW; ++j) screw[SW_SCREW * i + j] = h[j];
}

// The gradient of one row's screw [v, r] from the warp's gradient G, as
// autograd differentiates se3_apply and _coeffs' double where; zero on a row
// the guard replaced.
__device__ __forceinline__ void se3_row_grad(const float* h, const float* p, const float* G,
                                             float* d) {
    const float* v = h;
    const float* r = h + 3;
    const Se3Coeffs k = se3_coeffs(r);
    float w[3];
    se3_point(v, r, p, k, w);
    if (isnan(w[0]) || isnan(w[1]) || isnan(w[2])) {
#pragma unroll
        for (int j = 0; j < SW_SCREW; ++j) d[j] = 0.f;
        return;
    }
    float rxp[3], rxv[3], gxr[3], pxg[3], vxg[3];
    cross3(r, p, rxp);
    cross3(r, v, rxv);
    cross3(G, r, gxr);
    cross3(p, G, pxg);
    cross3(v, G, vxg);
    const float rp = dot3(r, p), rv = dot3(r, v);
    const float gr = dot3(G, r), gv = dot3(G, v);
    // the gradients of the coefficients, and of t2 where it enters directly
    const float g_cs = dot3(G, p);
    const float g_a = dot3(G, rxp);
    const float g_b = rp * gr + dot3(G, rxv);
    const float g_c = rv * gr - k.t2 * gv;
    float g_t2 = -k.c * gv;  // (1 - c t2) v
    if (k.small) {
        g_t2 += g_cs * (-0.5f + k.t2 / 12.f) + g_a * (-1.f / 6.f) + g_b * (-1.f / 24.f)
              + g_c * (-1.f / 120.f);
    } else {
        // t = sqrt(t2), dt/dt2 = 1 / (2 t); a = sin t / t; b = (1 - cos t) / t2;
        // c = (t - sin t) / (t t2)
        const float tt = k.th * k.t2, num = k.th - k.sn;
        const float g_tt = -g_c * num / (tt * tt);
        const float g_th = -g_cs * k.sn + g_a * (k.co / k.th - k.sn / (k.th * k.th))
                         + g_b * k.sn / k.t2 + (g_c / tt) * (1.f - k.co) + g_tt * k.t2;
        g_t2 += g_th / (2.f * k.th) - g_b * (1.f - k.co) / (k.t2 * k.t2) + g_tt * k.th;
    }
    const float m = 1.f - k.c * k.t2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        d[j] = m * G[j] + k.b * gxr[j] + (k.c * gr) * r[j];
        d[3 + j] = k.a * pxg[j] + k.b * (rp * G[j] + gr * p[j]) + k.b * vxg[j]
                 + k.c * (rv * G[j] + gr * v[j]) + 2.f * r[j] * g_t2;
    }
}

// A block takes SW_THREADS rows: a thread a row's screw gradient into shared
// memory, then the block writes the rows [SW_THREADS, width] of the head's
// gradient in order, in float4 stores (width % 4 == 0), zero past column 6.
__global__ void __launch_bounds__(SW_THREADS)
se3_warp_bwd_kernel(const float* __restrict__ g, long long g_ld,
                    const float* __restrict__ screw, const float* __restrict__ pos,
                    long long pos_ld, float* __restrict__ dhead, long long n, int width) {
    __shared__ float part[SW_THREADS * SW_SCREW];
    const long long row0 = (long long)blockIdx.x * SW_THREADS;
    const long long i = row0 + threadIdx.x;
    if (i < n) {
        float h[SW_SCREW], p[3], G[3], d[SW_SCREW];
#pragma unroll
        for (int j = 0; j < SW_SCREW; ++j) h[j] = __ldg(screw + SW_SCREW * i + j);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            p[j] = __ldg(pos + i * pos_ld + j);
            G[j] = __ldg(g + i * g_ld + j);
        }
        se3_row_grad(h, p, G, d);
#pragma unroll
        for (int j = 0; j < SW_SCREW; ++j) part[SW_SCREW * threadIdx.x + j] = d[j];
    }
    __syncthreads();
    const int rows = (int)min((long long)SW_THREADS, n - row0);
    float4* dst = reinterpret_cast<float4*>(dhead + row0 * width);
    const int quads = width / 4;
    for (int e = threadIdx.x; e < rows * quads; e += SW_THREADS) {
        const int r = e / quads, c = 4 * (e - r * quads);
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < SW_SCREW) {
            const float* s = part + SW_SCREW * r + c;
            q.x = s[0];
            q.y = s[1];
            if (c + 2 < SW_SCREW) {
                q.z = s[2];
                q.w = s[3];
            }
        }
        __stcs(dst + e, q);
    }
}

// pos: [n, 3] f32 rows pos_ld floats apart; code: [n, d_code] f32 rows code_ld
// apart; out: [n, 6 n_freq + 3 + d_code] f32, contiguous. window_param is
// read where windowed != 0. Returns cudaGetLastError().
extern "C" int warp_input(const void* pos, long long pos_ld, const void* code,
                          long long code_ld, void* out, long long n, long long n_freq,
                          long long d_code, float window_param, long long windowed,
                          void* stream) {
    if (n < 0 || n_freq < 0 || n_freq > SW_MAX_FREQ || d_code < 0 || pos_ld < 3
        || (d_code > 0 && code_ld < d_code)
        || SW_INPUT_ROWS * (6 * n_freq + 3 + d_code) > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + SW_INPUT_ROWS - 1) / SW_INPUT_ROWS;
    warp_input_kernel<<<(unsigned)blocks, SW_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos, pos_ld, (const float*)code, code_ld, (float*)out, n, (int)n_freq,
        (int)d_code, window_param, (int)(windowed != 0));
    return (int)cudaGetLastError();
}

// head: [n, >= 6] f32 rows head_ld floats apart (the first 6 columns read);
// pos: [n, 3] f32 rows pos_ld apart; off: [n, 3] and screw: [n, 6] f32,
// contiguous. Returns cudaGetLastError().
extern "C" int se3_warp_fwd(const void* head, long long head_ld, const void* pos,
                            long long pos_ld, void* off, void* screw, long long n,
                            void* stream) {
    if (n < 0 || head_ld < SW_SCREW || pos_ld < 3) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + SW_THREADS - 1) / SW_THREADS;
    se3_warp_fwd_kernel<<<(unsigned)blocks, SW_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)head, head_ld, (const float*)pos, pos_ld, (float*)off, (float*)screw, n);
    return (int)cudaGetLastError();
}

// g: [n, 3] f32 rows g_ld floats apart (the offsets' gradient); screw: [n, 6]
// f32, contiguous (se3_warp_fwd's copy); pos: [n, 3] f32 rows pos_ld apart;
// dhead: [n, width] f32, contiguous, 16-byte aligned, width % 4 == 0.
// Returns cudaGetLastError().
extern "C" int se3_warp_bwd(const void* g, long long g_ld, const void* screw,
                            const void* pos, long long pos_ld, void* dhead, long long n,
                            long long width, void* stream) {
    if (n < 0 || g_ld < 3 || pos_ld < 3 || width < SW_SCREW || width % 4 != 0
        || (uintptr_t)dhead % 16 != 0 || (long long)SW_THREADS * width > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + SW_THREADS - 1) / SW_THREADS;
    se3_warp_bwd_kernel<<<(unsigned)blocks, SW_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)g, g_ld, (const float*)screw, (const float*)pos, pos_ld,
        (float*)dhead, n, (int)width);
    return (int)cudaGetLastError();
}
