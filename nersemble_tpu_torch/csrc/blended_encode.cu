// Blended hash-grid encode: the gather-blend forward (kernel A3-fwd) and its
// deterministic backward (kernel A3-bwd).
//
// Replaces no Pallas kernel: the JAX package runs this op as XLA gathers,
// one-hot matmuls and a .at[].add scatter (nersemble_tpu/ops/hash_encoding.py
// _blended_core / _blended_fwd_impl / _blended_vjp_bwd), and the original
// system ran it in tiny-cuda-nn CUDA. The port's plain version is
// nersemble_tpu_torch/ops/hash_encoding.py blended_encode_fwd_plain /
// blended_encode_bwd_plain; every rounding below is that version's, in its
// order, with __fmul_rn / __fadd_rn so that nvcc contracts nothing into an
// FMA. Only the order of some f32 sums differs.
//
// Layout: the xz-quad table [E, 4W] (bf16 or f32) packs quarter q (z, x, xz
// neighbours) of entry e at columns q*W + h*FL + f, logical table h < H,
// feature f < FL, W = H*FL. entry_idx [n, 2L] int64 (column c*L + l is
// y-corner c of level l), wy [n, 2L], fx, fz [n, L] f32, code [n, H] f32 or
// none (the single grid: H = 1, W = FL). out [n, L*FL] f32; residuals
// CG [n, 2, L, 4, FL] and BH [n, L, H, FL] in the table dtype.
//
// What bounds it on the H100: device memory bandwidth. The forward gathers
// 2L rows of 4W elements per sample (flagship: 73,728 samples x 32 rows x
// 512 B = 1.21 GB) and writes 0.19 GB of residuals; the backward reads the
// residuals, the sorted keys and the per-sample inputs (~0.25 GB) and writes
// the [E, 4W] table gradient once, zeros included (3.35 GB bf16).
//
// Forward design: one group of R = 4W/8 lanes per (sample, level); each
// lane loads 8 consecutive elements of both corners' rows (one or two 16-byte
// loads: a flagship bf16 row is one coalesced warp load, lane j holding
// quarter j/8, tables 4(j%8)..+3, both features). The sum over tables is a
// butterfly over the lanes of one quarter, the sums over quarters (the
// output and BH) a butterfly over the quarters' lanes. Rows narrower than
// 8 elements per quarter (the single grid's W = 2) put whole quarters in one
// lane, and several groups share a warp. The residuals, rounded to the
// table dtype, take their f32 sums in one order that the plain version
// repeats (each lane's tables left to right, then the lanes pairwise,
// neighbours first; the quarters as (q0 + q1) + (q2 + q3)), so CG and BH
// equal it bit for bit; the f32 output sums its quarters in another order.
// Widths without that layout (W not a power of two, or 4W > 256: tables
// that are not a power of two in number, or more than 32) take
// be_fwd_wide_kernel, one thread per (sample, level), in the same orders.
//
// Backward design: the table gradient is a keyed reduction, built without
// atomics so that a step repeats bit for bit. The wrapper sorts the n*2L
// entry indices (int32 keys, torch.sort stable: index preparation). Then
//  * be_sample_kernel: one warp per sample, the per-sample gradients
//    d_wy, d_fx, d_fz (lane per level) and d_code (lane per table);
//  * the table gradient is zeroed (cudaMemsetAsync: rows no sample reached);
//  * be_chunk_kernel: one group per chunk of BE_CHUNK sorted positions
//    walks them in order, recomputing each contribution
//    round(round(gbar*u*wy) * round(code)) on the fly and summing in f32.
//    A run of equal keys that lies inside its chunk is rounded and written
//    to its row; the pieces of longer runs go to a per-chunk f32 scratch
//    (slot 0: the piece that starts the chunk, slot 1: the one that ends
//    it). Run heads are found on the device (a position starts a run where
//    its key differs from its predecessor's); nothing is read back to the
//    host;
//  * be_span_kernel: one group per chunk whose last run starts in it and
//    goes on past its end sums that run's pieces in chunk order, rounds
//    once and writes the row. Every sum has one fixed order.
// A hot entry (every padded sample lands on one corner per level) costs at
// most BE_CHUNK steps in one group plus its chunks' count in another.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BE_P 8        // table elements per lane
#define BE_CHUNK 64   // sorted contributions per chunk (ops/hash_encoding.py TABLE_CHUNK)
#define BE_FULL 0xffffffffu

__device__ __forceinline__ float be_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float be_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T be_cast(float v);
template <> __device__ __forceinline__ __nv_bfloat16 be_cast<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float be_cast<float>(float v) { return v; }

// v rounded to the table dtype, kept in f32
template <typename T> __device__ __forceinline__ float be_round(float v) {
    return be_f32(be_cast<T>(v));
}

// 8 elements from 16-byte aligned memory (one 16-byte load in bf16, two in f32)
template <typename T>
__device__ __forceinline__ void be_load8(const T* p, float (&v)[BE_P]) {
    constexpr int NV = BE_P * (int)sizeof(T) / 16;
    uint4 raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < BE_P; ++i) v[i] = be_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void be_store8(T* p, const float (&v)[BE_P]) {
    constexpr int NV = BE_P * (int)sizeof(T) / 16;
    uint4 raw[NV];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int i = 0; i < BE_P; ++i) e[i] = be_cast<T>(v[i]);
#pragma unroll
    for (int i = 0; i < NV; ++i) reinterpret_cast<uint4*>(p)[i] = raw[i];
}

// the quarter weights u_q = wx * wz: (1-fx)(1-fz), (1-fx)fz, fx(1-fz), fx fz
struct Quarters {
    float u[4];
    __device__ __forceinline__ Quarters(float fx, float fz) {
        const float gx = __fsub_rn(1.0f, fx), gz = __fsub_rn(1.0f, fz);
        u[0] = __fmul_rn(gx, gz);
        u[1] = __fmul_rn(gx, fz);
        u[2] = __fmul_rn(fx, gz);
        u[3] = __fmul_rn(fx, fz);
    }
    __device__ __forceinline__ float at(int q) const {
        return q == 0 ? u[0] : q == 1 ? u[1] : q == 2 ? u[2] : u[3];
    }
};

// ---------------------------------------------------------------------------
// A3-fwd. FL: features per table; WP = min(W, 8): the elements of one
// quarter a lane holds; CODE: the blended encode (else the single grid).
template <typename T, int FL, int WP, bool CODE>
__global__ void __launch_bounds__(256)
be_fwd_kernel(const T* __restrict__ table, const long long* __restrict__ entry_idx,
              const float* __restrict__ wy, const float* __restrict__ fx,
              const float* __restrict__ fz, const float* __restrict__ code,
              float* __restrict__ out, T* __restrict__ cg_out, T* __restrict__ bh_out,
              long long n, int L, int H, int log2w, int R) {
    constexpr int P = BE_P;
    constexpr int QPL = P / WP;  // quarters per lane (1 when W >= 8)
    constexpr int NS = QPL * FL; // (local quarter, feature) slots
    const int W = 1 << log2w, W4 = 4 * W;
    const int lpq = W >= P ? W / P : 1;  // lanes per quarter
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long gi = tid / R;
    const int t = (int)(tid % R);
    const bool active = gi < n * L;
    const long long s = active ? gi / L : 0;
    const int l = active ? (int)(gi % L) : 0;
    const int q0 = (t * P) >> log2w;  // the lane's first quarter

    float r[2][P], w[2];
    float fxv = 0.0f, fzv = 0.0f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        if (active) {
            const long long j = s * 2 * L + c * L + l;
            be_load8(table + entry_idx[j] * W4 + t * P, r[c]);
            w[c] = wy[j];
        } else {
#pragma unroll
            for (int i = 0; i < P; ++i) r[c][i] = 0.0f;
            w[c] = 0.0f;
        }
    }
    if (active) {
        fxv = fx[s * L + l];
        fzv = fz[s * L + l];
    }
    const Quarters u(fxv, fzv);

    // the code of each element's table, rounded to the table dtype
    float cv[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        cv[i] = 1.0f;
        if (CODE && active)
            cv[i] = be_round<T>(code[s * H + (((t * P + i) & (W - 1)) / FL)]);
    }

    // CG: the sum over tables of round(rows * code), per corner and slot
    float cg[2][NS];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int j = 0; j < NS; ++j) cg[c][j] = 0.0f;
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const float term = CODE ? be_round<T>(__fmul_rn(r[c][i], cv[i])) : r[c][i];
            const int j = (i / WP) * FL + (i % FL);
            cg[c][j] = __fadd_rn(cg[c][j], term);
        }
    }
    for (int m = 1; m < lpq; m <<= 1) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < NS; ++j)
                cg[c][j] = __fadd_rn(cg[c][j], __shfl_xor_sync(BE_FULL, cg[c][j], m));
    }
    if (active && cg_out != nullptr && t % lpq == 0) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < NS; ++j)
                cg_out[((s * 2 + c) * L + l) * 4 * FL + q0 * FL + j] = be_cast<T>(cg[c][j]);
    }

    // the output: sum over quarters of cg * u, then the two corners
    float g[2][FL];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int f = 0; f < FL; ++f) {
            float acc = 0.0f;
#pragma unroll
            for (int qi = 0; qi < QPL; ++qi)
                acc = __fadd_rn(acc, __fmul_rn(cg[c][qi * FL + f], u.at(q0 + qi)));
            g[c][f] = acc;
        }
    for (int m = lpq; m < R; m <<= 1) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int f = 0; f < FL; ++f)
                g[c][f] = __fadd_rn(g[c][f], __shfl_xor_sync(BE_FULL, g[c][f], m));
    }
    if (active && t == 0) {
#pragma unroll
        for (int f = 0; f < FL; ++f)
            out[(s * L + l) * FL + f] = __fadd_rn(__fmul_rn(g[0][f], w[0]),
                                                  __fmul_rn(g[1][f], w[1]));
    }

    // BH: per element round(round(r0 * wu0) + round(r1 * wu1)), wu = round(wy * u),
    // summed over quarters in f32 and rounded once
    if (CODE && bh_out != nullptr) {
        float b[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const float uq = u.at((t * P + i) >> log2w);
            const float w0 = be_round<T>(__fmul_rn(w[0], uq));
            const float w1 = be_round<T>(__fmul_rn(w[1], uq));
            b[i] = be_round<T>(__fadd_rn(be_round<T>(__fmul_rn(r[0][i], w0)),
                                         be_round<T>(__fmul_rn(r[1][i], w1))));
        }
        // the quarters pairwise, neighbours first: (q0 + q1) + (q2 + q3)
#pragma unroll
        for (int j = 0; j < WP; ++j) {
            if (QPL == 4)
                b[j] = __fadd_rn(__fadd_rn(b[j], b[WP + j]),
                                 __fadd_rn(b[2 * WP + j], b[3 * WP + j]));
            else if (QPL == 2)
                b[j] = __fadd_rn(b[j], b[WP + j]);
        }
        for (int m = lpq; m < R; m <<= 1) {
#pragma unroll
            for (int j = 0; j < WP; ++j)
                b[j] = __fadd_rn(b[j], __shfl_xor_sync(BE_FULL, b[j], m));
        }
        if (active && t < lpq) {  // the lanes of quarter 0
            T* dst = bh_out + (s * L + l) * W + t * P;
            if (WP == P) {
                be_store8(dst, b);
            } else {
#pragma unroll
                for (int j = 0; j < WP; ++j) dst[j] = be_cast<T>(b[j]);
            }
        }
    }
}

// A3-fwd for the widths the lane layout lacks (W not a power of two, or
// 4W > 256): one thread per (sample, level), the same roundings, CG's table
// sum in the same order (runs of min(W, 8) / FL tables left to right, then
// the runs pairwise, neighbours first, an odd last run carried), BH's
// quarters as (q0 + q1) + (q2 + q3).
#define BE_MAX_RUNS 32

template <typename T, int FL, bool CODE>
__global__ void __launch_bounds__(256)
be_fwd_wide_kernel(const T* __restrict__ table, const long long* __restrict__ entry_idx,
                   const float* __restrict__ wy, const float* __restrict__ fx,
                   const float* __restrict__ fz, const float* __restrict__ code,
                   float* __restrict__ out, T* __restrict__ cg_out, T* __restrict__ bh_out,
                   long long n, int L, int H, int W) {
    const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gi >= n * L) return;
    const long long s = gi / L;
    const int l = (int)(gi % L), W4 = 4 * W;
    const T* row[2];
    float w[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const long long j = s * 2 * L + c * L + l;
        row[c] = table + entry_idx[j] * W4;
        w[c] = wy[j];
    }
    const Quarters u(fx[s * L + l], fz[s * L + l]);
    int per_run = (W < BE_P ? W : BE_P) / FL;
    if (per_run < 1) per_run = 1;
    if (H % per_run) per_run = H;
    const int n_runs = H / per_run;
    float g[2][FL];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int f = 0; f < FL; ++f) g[c][f] = 0.0f;
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int f = 0; f < FL; ++f) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float cgv;
                if (CODE) {
                    float runs[BE_MAX_RUNS];
                    for (int r = 0; r < n_runs; ++r) {
                        float acc = 0.0f;
                        for (int i = 0; i < per_run; ++i) {
                            const int h = r * per_run + i;
                            const float cq = be_round<T>(code[s * H + h]);
                            acc = __fadd_rn(acc, be_round<T>(__fmul_rn(
                                be_f32(row[c][q * W + h * FL + f]), cq)));
                        }
                        runs[r] = acc;
                    }
                    for (int m = n_runs; m > 1;) {
                        const int half = m / 2;
                        for (int i = 0; i < half; ++i)
                            runs[i] = __fadd_rn(runs[2 * i], runs[2 * i + 1]);
                        if (m % 2) runs[half] = runs[m - 1];
                        m = half + m % 2;
                    }
                    cgv = runs[0];
                } else {
                    cgv = be_f32(row[c][q * W + f]);
                }
                if (cg_out != nullptr)
                    cg_out[((s * 2 + c) * L + l) * 4 * FL + q * FL + f] = be_cast<T>(cgv);
                g[c][f] = __fadd_rn(g[c][f], __fmul_rn(cgv, u.u[q]));
            }
        }
    }
#pragma unroll
    for (int f = 0; f < FL; ++f)
        out[(s * L + l) * FL + f] = __fadd_rn(__fmul_rn(g[0][f], w[0]),
                                              __fmul_rn(g[1][f], w[1]));
    if (CODE && bh_out != nullptr) {
        float w0[4], w1[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            w0[q] = be_round<T>(__fmul_rn(w[0], u.u[q]));
            w1[q] = be_round<T>(__fmul_rn(w[1], u.u[q]));
        }
        for (int k = 0; k < W; ++k) {
            float b[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                b[q] = be_round<T>(__fadd_rn(
                    be_round<T>(__fmul_rn(be_f32(row[0][q * W + k]), w0[q])),
                    be_round<T>(__fmul_rn(be_f32(row[1][q * W + k]), w1[q]))));
            bh_out[(s * L + l) * W + k] =
                be_cast<T>(__fadd_rn(__fadd_rn(b[0], b[1]), __fadd_rn(b[2], b[3])));
        }
    }
}

// ---------------------------------------------------------------------------
// A3-bwd, per sample: one warp per sample.
template <typename T, int FL, bool CODE>
__global__ void __launch_bounds__(256)
be_sample_kernel(const float* __restrict__ gbar, const T* __restrict__ cg_res,
                 const T* __restrict__ bh_res, const float* __restrict__ wy,
                 const float* __restrict__ fx, const float* __restrict__ fz,
                 float* __restrict__ d_code, float* __restrict__ d_wy,
                 float* __restrict__ d_fx, float* __restrict__ d_fz,
                 long long n, int L, int H) {
    const long long s = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x & 31;
    if (s >= n) return;
    for (int l = lane; l < L; l += 32) {
        const float fxv = fx[s * L + l], fzv = fz[s * L + l];
        const Quarters u(fxv, fzv);
        const float gx = __fsub_rn(1.0f, fxv), gz = __fsub_rn(1.0f, fzv);
        const float pat_fx[4] = {-gz, -fzv, gz, fzv};
        const float pat_fz[4] = {-gx, gx, -fxv, fxv};
        float gb[FL];
#pragma unroll
        for (int f = 0; f < FL; ++f) gb[f] = gbar[(s * L + l) * FL + f];
        float dfx = 0.0f, dfz = 0.0f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const long long j = s * 2 * L + c * L + l;
            const float wc = wy[j];
            const T* cgp = cg_res + j * 4 * FL;
            float dwy = 0.0f;
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int f = 0; f < FL; ++f) {
                    const float cgv = be_f32(cgp[q * FL + f]);
                    dwy = __fadd_rn(dwy, __fmul_rn(__fmul_rn(cgv, u.u[q]), gb[f]));
                    const float core = __fmul_rn(__fmul_rn(cgv, wc), gb[f]);
                    dfx = __fadd_rn(dfx, __fmul_rn(core, pat_fx[q]));
                    dfz = __fadd_rn(dfz, __fmul_rn(core, pat_fz[q]));
                }
            d_wy[j] = dwy;
        }
        d_fx[s * L + l] = dfx;
        d_fz[s * L + l] = dfz;
    }
    if (CODE) {
        // d code[h] = sum_{l,f} round(BH[l,h,f] * round(gbar[l,f]))
        for (int h = lane; h < H; h += 32) {
            float acc = 0.0f;
            for (int l = 0; l < L; ++l) {
#pragma unroll
                for (int f = 0; f < FL; ++f) {
                    const float bh = be_f32(bh_res[((s * L + l) * H + h) * FL + f]);
                    const float gq = be_round<T>(gbar[(s * L + l) * FL + f]);
                    acc = __fadd_rn(acc, be_round<T>(__fmul_rn(bh, gq)));
                }
            }
            d_code[s * H + h] = acc;
        }
    }
}

// one contribution's per-sample inputs: the code of each of the lane's
// elements' tables (1 without a code)
template <int FL>
struct Contribution {
    float fx, fz, wy, gb[FL], cv[BE_P];
};

// A3-bwd: the table gradient of one chunk of sorted positions per group of R
// lanes (R = 4W/8, any count: no shuffles), each lane 8 elements of the row
template <typename T, int FL, bool CODE>
__global__ void __launch_bounds__(256)
be_chunk_kernel(const int* __restrict__ skey, const long long* __restrict__ perm,
                long long total, const float* __restrict__ gbar,
                const float* __restrict__ code, const float* __restrict__ wy,
                const float* __restrict__ fx, const float* __restrict__ fz,
                T* __restrict__ d_table, float* __restrict__ partial,
                int L, int H, int W, int R) {
    constexpr int P = BE_P;
    constexpr int BATCH = 4;               // contributions whose loads are in flight together
    const int W4 = 4 * W;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long chunk = tid / R;
    const int t = (int)(tid % R);
    const long long lo = chunk * BE_CHUNK;
    if (lo >= total) return;
    const long long hi = lo + BE_CHUNK < total ? lo + BE_CHUNK : total;

    // each element's quarter and table
    int qof[P], hof[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const int k = t * P + i;
        qof[i] = k / W;
        hof[i] = (k % W) / FL;
    }

    float acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = 0.0f;
    long long a = lo;  // start of the current piece
    int key = skey[lo];

    auto flush = [&](long long b) {
        const bool head = a > lo || lo == 0 || skey[lo - 1] != key;
        const bool end = b < hi || b == total || skey[b] != key;
        if (head && end) {
            be_store8(d_table + (long long)key * W4 + t * P, acc);
        } else {
            const int slot = a == lo ? 0 : 1;
            float* dst = partial + (chunk * 2 + slot) * W4 + t * P;
            reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        }
#pragma unroll
        for (int i = 0; i < P; ++i) acc[i] = 0.0f;
    };

    for (long long i0 = lo; i0 < hi; i0 += BATCH) {
        int keys[BATCH];
        Contribution<FL> in[BATCH];
#pragma unroll
        for (int bi = 0; bi < BATCH; ++bi) {
            const long long i = i0 + bi;
            keys[bi] = -1;
            if (i < hi) {
                keys[bi] = skey[i];
                const long long p = perm[i];
                const long long s = p / (2 * L);
                const int l = (int)(p % (2 * L)) % L;
                in[bi].fx = fx[s * L + l];
                in[bi].fz = fz[s * L + l];
                in[bi].wy = wy[p];
#pragma unroll
                for (int f = 0; f < FL; ++f) in[bi].gb[f] = gbar[(s * L + l) * FL + f];
#pragma unroll
                for (int e = 0; e < P; ++e)
                    in[bi].cv[e] = CODE ? be_round<T>(__ldg(code + s * H + hof[e])) : 1.0f;
            }
        }
#pragma unroll
        for (int bi = 0; bi < BATCH; ++bi) {
            const long long i = i0 + bi;
            if (i >= hi) break;
            if (keys[bi] != key) {
                flush(i);
                a = i;
                key = keys[bi];
            }
            const Quarters u(in[bi].fx, in[bi].fz);
#pragma unroll
            for (int e = 0; e < P; ++e) {
                // round(gbar * u * wy), times the rounded code
                const float gf = in[bi].gb[e % FL];  // 8 % FL == 0
                float d = be_round<T>(__fmul_rn(__fmul_rn(gf, u.at(qof[e])), in[bi].wy));
                if (CODE) d = be_round<T>(__fmul_rn(d, in[bi].cv[e]));
                acc[e] = __fadd_rn(acc[e], d);
            }
        }
    }
    flush(hi);
}

// A3-bwd: the runs that span chunks. One group of R lanes per chunk c0 whose
// last run starts in it and goes on past its end: the run's pieces, c0's
// (slot 0 if the run covers c0's first position, else slot 1) and then
// slot 0 of each following chunk the run reaches, summed in chunk order.
template <typename T>
__global__ void __launch_bounds__(256)
be_span_kernel(const int* __restrict__ skey, long long total,
               const float* __restrict__ partial, T* __restrict__ d_table,
               int W4, int R) {
    constexpr int P = BE_P;
    constexpr int UNROLL = 4;  // chunks whose loads are in flight together
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long c0 = tid / R;
    const int t = (int)(tid % R);
    const long long lo = c0 * BE_CHUNK, hi = lo + BE_CHUNK;
    if (hi >= total) return;  // the last chunk: no run goes past it
    const int key = skey[hi - 1];
    if (skey[hi] != key) return;  // its last run ends inside it
    const bool covers_lo = skey[lo] == key;
    if (covers_lo && lo > 0 && skey[lo - 1] == key) return;  // begun in an earlier chunk
    const long long n_chunks = (total + BE_CHUNK - 1) / BE_CHUNK;
    float acc[P];
    {
        const float4* src = reinterpret_cast<const float4*>(
            partial + (c0 * 2 + (covers_lo ? 0 : 1)) * W4 + t * P);
        const float4 a = src[0], b = src[1];
        acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
        acc[4] = b.x; acc[5] = b.y; acc[6] = b.z; acc[7] = b.w;
    }
    bool going = true;
    for (long long c = c0 + 1; going && c < n_chunks; c += UNROLL) {
        int keys[UNROLL];
        float4 v[UNROLL][2];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            keys[k] = -1;
            if (c + k < n_chunks) {
                keys[k] = skey[(c + k) * BE_CHUNK];
                const float4* src = reinterpret_cast<const float4*>(
                    partial + (c + k) * 2 * W4 + t * P);
                v[k][0] = src[0];
                v[k][1] = src[1];
            }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            going = going && keys[k] == key;
            if (going) {
                acc[0] = __fadd_rn(acc[0], v[k][0].x);
                acc[1] = __fadd_rn(acc[1], v[k][0].y);
                acc[2] = __fadd_rn(acc[2], v[k][0].z);
                acc[3] = __fadd_rn(acc[3], v[k][0].w);
                acc[4] = __fadd_rn(acc[4], v[k][1].x);
                acc[5] = __fadd_rn(acc[5], v[k][1].y);
                acc[6] = __fadd_rn(acc[6], v[k][1].z);
                acc[7] = __fadd_rn(acc[7], v[k][1].w);
            }
        }
    }
    be_store8(d_table + (long long)key * W4 + t * P, acc);
}

// ---------------------------------------------------------------------------
// host side

struct FwdArgs {
    const void *table, *entry_idx, *wy, *fx, *fz, *code;
    void *out, *cg, *bh;
    long long n;
    int L, H, W, log2w, R;  // log2w, R: the lane layout's (-1, 0 without one)
};

template <typename T, int FL, int WP, bool CODE>
static int be_launch_fwd(const FwdArgs& a, cudaStream_t st) {
    const long long threads = a.n * a.L * a.R;
    const unsigned grid = (unsigned)((threads + 255) / 256);
    be_fwd_kernel<T, FL, WP, CODE><<<grid, 256, 0, st>>>(
        (const T*)a.table, (const long long*)a.entry_idx, (const float*)a.wy,
        (const float*)a.fx, (const float*)a.fz, (const float*)a.code, (float*)a.out,
        (T*)a.cg, (T*)a.bh, a.n, a.L, a.H, a.log2w, a.R);
    return (int)cudaGetLastError();
}

template <typename T, int FL, bool CODE>
static int be_launch_fwd_wide(const FwdArgs& a, cudaStream_t st) {
    const unsigned grid = (unsigned)((a.n * a.L + 255) / 256);
    be_fwd_wide_kernel<T, FL, CODE><<<grid, 256, 0, st>>>(
        (const T*)a.table, (const long long*)a.entry_idx, (const float*)a.wy,
        (const float*)a.fx, (const float*)a.fz, (const float*)a.code, (float*)a.out,
        (T*)a.cg, (T*)a.bh, a.n, a.L, a.H, a.W);
    return (int)cudaGetLastError();
}

template <typename T, int FL, bool CODE>
static int be_fwd_wp(int wp, const FwdArgs& a, cudaStream_t st) {
    if (a.log2w < 0) return be_launch_fwd_wide<T, FL, CODE>(a, st);
    if constexpr (!CODE) {  // the single grid: one table, quarters of FL elements
        if (wp != FL || FL < 2) return (int)cudaErrorInvalidValue;
        return be_launch_fwd<T, FL, (FL < 2 ? 2 : FL), CODE>(a, st);
    } else {
        if (wp == 8) return be_launch_fwd<T, FL, 8, CODE>(a, st);
        if constexpr (FL <= 4) {
            if (wp == 4) return be_launch_fwd<T, FL, 4, CODE>(a, st);
        }
        if constexpr (FL <= 2) {
            if (wp == 2) return be_launch_fwd<T, FL, 2, CODE>(a, st);
        }
        return (int)cudaErrorInvalidValue;
    }
}

template <typename T, bool CODE>
static int be_fwd_fl(int fl, int wp, const FwdArgs& a, cudaStream_t st) {
    if (fl == 1) return be_fwd_wp<T, 1, CODE>(wp, a, st);
    if (fl == 2) return be_fwd_wp<T, 2, CODE>(wp, a, st);
    if (fl == 4) return be_fwd_wp<T, 4, CODE>(wp, a, st);
    if (fl == 8) return be_fwd_wp<T, 8, CODE>(wp, a, st);
    return (int)cudaErrorInvalidValue;
}

static int be_log2(long long v) {
    int k = 0;
    while ((1LL << k) < v) ++k;
    return (1LL << k) == v ? k : -1;
}

// the shapes the kernels take: FL in {1, 2, 4, 8}, rows of whole 8-element
// chunks (4W a multiple of 8) up to 4W = 1024, and with no code one table
// (W = FL); the lane layout takes W a power of two and 4W <= 256, the wide
// forward kernel the others
static bool be_valid(long long W, long long FL, long long H, bool has_code,
                     long long elem_bytes) {
    if (be_log2(FL) < 0 || FL > BE_P || H < 1 || H * FL != W || (4 * W) % BE_P
        || 4 * W > 128 * BE_P || (!has_code && H != 1))
        return false;
    return elem_bytes == 2 || elem_bytes == 4;
}

static bool be_lane_layout(long long W) {
    return be_log2(W) >= 0 && 4 * W <= 32 * BE_P && 4 * W >= BE_P;
}

// table [E, 4W], entry_idx [n, 2L] int64, wy [n, 2L], fx, fz [n, L] f32,
// code [n, H] f32 or null; out [n, L*FL] f32; cg [n, 2, L, 4, FL] and
// bh [n, L, H, FL] in the table dtype, or null (no residuals kept; bh is
// always null without a code). Rows 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it lacks.
extern "C" int blended_encode_fwd(const void* table, const void* entry_idx,
                                  const void* wy, const void* fx, const void* fz,
                                  const void* code, void* out, void* cg, void* bh,
                                  long long n, long long L, long long H, long long W,
                                  long long FL, long long elem_bytes, void* stream) {
    const bool has_code = code != nullptr;
    if (!be_valid(W, FL, H, has_code, elem_bytes) || n < 0 || L < 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const bool lanes = be_lane_layout(W);
    FwdArgs a{table, entry_idx, wy, fx, fz, code, out, cg, has_code ? bh : nullptr,
              n, (int)L, (int)H, (int)W, lanes ? be_log2(W) : -1,
              lanes ? (int)(4 * W / BE_P) : 0};
    const int wp = W < BE_P ? (int)W : BE_P;
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_bytes == 2)
        return has_code ? be_fwd_fl<__nv_bfloat16, true>((int)FL, wp, a, st)
                        : be_fwd_fl<__nv_bfloat16, false>((int)FL, wp, a, st);
    return has_code ? be_fwd_fl<float, true>((int)FL, wp, a, st)
                    : be_fwd_fl<float, false>((int)FL, wp, a, st);
}

struct BwdArgs {
    const void *gbar, *cg, *bh, *code, *wy, *fx, *fz, *skey, *perm;
    void *partial, *d_table, *d_code, *d_wy, *d_fx, *d_fz;
    long long n, E;
    int L, H, W, R;
};

template <typename T, int FL, bool CODE>
static int be_launch_bwd(const BwdArgs& a, cudaStream_t st) {
    const unsigned sample_grid = (unsigned)((a.n * 32 + 255) / 256);
    be_sample_kernel<T, FL, CODE><<<sample_grid, 256, 0, st>>>(
        (const float*)a.gbar, (const T*)a.cg, (const T*)a.bh, (const float*)a.wy,
        (const float*)a.fx, (const float*)a.fz, (float*)a.d_code, (float*)a.d_wy,
        (float*)a.d_fx, (float*)a.d_fz, a.n, a.L, a.H);
    int err = (int)cudaGetLastError();
    if (err != 0 || a.d_table == nullptr) return err;

    const long long total = a.n * 2 * a.L;
    const int W4 = 4 * a.W;
    err = (int)cudaMemsetAsync(a.d_table, 0, (size_t)a.E * W4 * sizeof(T), st);
    if (err != 0) return err;
    const long long n_chunks = (total + BE_CHUNK - 1) / BE_CHUNK;
    const unsigned chunk_grid = (unsigned)((n_chunks * a.R + 255) / 256);
    be_chunk_kernel<T, FL, CODE><<<chunk_grid, 256, 0, st>>>(
        (const int*)a.skey, (const long long*)a.perm, total, (const float*)a.gbar,
        (const float*)a.code, (const float*)a.wy, (const float*)a.fx, (const float*)a.fz,
        (T*)a.d_table, (float*)a.partial, a.L, a.H, a.W, a.R);
    be_span_kernel<T><<<chunk_grid, 256, 0, st>>>(
        (const int*)a.skey, total, (const float*)a.partial, (T*)a.d_table, W4, a.R);
    return (int)cudaGetLastError();
}

template <typename T, bool CODE>
static int be_bwd_fl(int fl, const BwdArgs& a, cudaStream_t st) {
    if (fl == 1) return be_launch_bwd<T, 1, CODE>(a, st);
    if (fl == 2) return be_launch_bwd<T, 2, CODE>(a, st);
    if (fl == 4) return be_launch_bwd<T, 4, CODE>(a, st);
    if (fl == 8) return be_launch_bwd<T, 8, CODE>(a, st);
    return (int)cudaErrorInvalidValue;
}

// gbar [n, L*FL] f32, cg / bh the forward's residuals (bh null without a
// code), code / wy / fx / fz as the forward's; skey [n*2L] int32 the sorted
// entry indices and perm [n*2L] int64 their positions in entry_idx (a stable
// sort); scratch partial [2 * ceil(n*2L / BE_CHUNK), 4W] f32; outputs
// d_table [E, 4W] in the table dtype (null: not wanted; skey, perm and the
// scratch are then unused), d_code [n, H] (null without a code), d_wy
// [n, 2L], d_fx, d_fz [n, L] f32.
extern "C" int blended_encode_bwd(const void* gbar, const void* cg, const void* bh,
                                  const void* code, const void* wy, const void* fx,
                                  const void* fz, const void* skey, const void* perm,
                                  void* partial, void* d_table, void* d_code,
                                  void* d_wy, void* d_fx,
                                  void* d_fz, long long n, long long L, long long H,
                                  long long W, long long FL, long long E,
                                  long long elem_bytes, void* stream) {
    const bool has_code = code != nullptr;
    if (!be_valid(W, FL, H, has_code, elem_bytes) || n < 0 || L < 1
        || n * 2 * L >= (1LL << 31) || E >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    BwdArgs a{gbar, cg, bh, code, wy, fx, fz, skey, perm, partial,
              d_table, d_code, d_wy, d_fx, d_fz, n, E, (int)L, (int)H, (int)W,
              (int)(4 * W / BE_P)};
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_bytes == 2)
        return has_code ? be_bwd_fl<__nv_bfloat16, true>((int)FL, a, st)
                        : be_bwd_fl<__nv_bfloat16, false>((int)FL, a, st);
    return has_code ? be_bwd_fl<float, true>((int)FL, a, st)
                    : be_bwd_fl<float, false>((int)FL, a, st);
}
