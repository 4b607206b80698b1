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
// 512 B = 1.21 GB, 0.64 GB of them distinct rows) and writes 0.19 GB of
// residuals; the backward reads the residuals, the sorted keys and the
// per-sample inputs (~0.25 GB) and writes the [E, 4W] table gradient once,
// zeros included (3.35 GB bf16).
//
// Forward design (be_fwd_kernel): a persistent grid of 256-thread blocks.
// A block walks stages of UPS units; a unit is one sample's levels (a group
// of LG of them where a sample's rows pass 32 KB). A ring of S slots in
// shared memory overlaps the gather of the next stages with the blend of
// the current one: rows of 64 bytes or more arrive by one bulk copy each
// (cp.async.bulk onto the slot's mbarrier, issued by a few lanes of every
// warp), narrower ones by 16-byte cp.async; each copy's entry index and the
// units' code, wy, fx and fz are loaded into registers one stage ahead and
// the latter stored into the slot. Rows sit at a stride of an odd number of
// 16-byte chunks, so eight consecutive rows read at one column fall in
// distinct banks. Per stage, from shared memory only, with two barriers:
//  A. one thread per CG slot (unit, quarter, corner, level) sums its tables
//     in _sum_tables' order: runs of 8 elements (all the tables where W is
//     not a multiple of 8) left to right, then the runs pairwise, neighbours
//     first, an odd last run carried (a binary counter over the runs builds
//     that tree); one thread per BH slot (unit, level, 8 elements) forms
//     round(round(r0 * w0) + round(r1 * w1)) per quarter, sums
//     (q0 + q1) + (q2 + q3) and stores 16 bytes;
//  B. one thread per (unit, level, feature) forms `out` from the f32 CG sums:
//     p_q = cg_q * u_q, (z(p0) + p1) + (z(p2) + p3) with z(x) = 0 + x where W
//     is a power of two from 4 to 64, else ((z(p0) + p1) + p2) + p3 (the
//     orders of the two forward kernels this one replaced), then
//     corner 0 * wy0 + corner 1 * wy1; CG, rounded, leaves in 16-byte
//     stores; and for the next stage (0.) the code rounded to the table
//     dtype once per element, u_q and round(wy * u_q), into the other of two
//     buffer sets.
// The single grid (no code) takes one thread per (unit, level) and one
// barrier per stage. With residuals off (render) BH and the residual stores
// are skipped; the f32 CG sums are still formed, since `out` is built from
// them. A bf16 product or sum of two bf16 values takes one packed
// fma.rn.bf16x2: the product of two bf16 values is exact in f32 and the f32
// sum of two is exact or far from a bf16 tie, so round(a * b) and
// round(a + b) equal the f32 operation rounded once, bit for bit. What holds
// it at the flagship (clock64 stamps, H100): the bulk copies' issue stalls
// (the copy engine's queue is full; about a third of a stage) and blend
// phases that are latency-bound at 32 warps per SM.
//
// Backward design: the table gradient is a keyed reduction, built without
// atomics so that a step repeats bit for bit. The wrapper zeroes the table
// gradient on a side stream (blended_encode_zero, cudaMemsetAsync: rows no
// sample reached) while it sorts the n*2L entry indices (int32 keys,
// torch.sort stable: index preparation) and runs be_sample_kernel on the
// caller's stream; an event joins the two before be_chunk_kernel. Then
//  * be_sample_kernel: one warp per sample, the per-sample gradients
//    d_wy, d_fx, d_fz (lane per level) and d_code (lane per table), and each
//    position's rounded row factor m[p, q, f] = round((gbar * u_q) * wy) and
//    the sample's rounded code (the first rounding of each contribution);
//  * be_chunk_kernel: a block stages the keys of its chunks of BE_CHUNK
//    sorted positions, their factor vectors and their samples' code rows in
//    shared memory (cp.async, all issued together), then one group of
//    R = 4W/8 lanes walks each chunk in order from shared memory, summing
//    round(m * round(code)) in f32 (each lane 8 elements of the row). A run
//    of equal keys that lies inside its chunk is rounded and written to its
//    row; the pieces of longer runs go to a per-chunk f32 scratch (slot 0:
//    the piece that starts the chunk, slot 1: the one that ends it). Run
//    heads are found on the device (a position starts a run where its key
//    differs from its predecessor's); nothing is read back to the host;
//  * be_span_kernel: one group per chunk whose last run starts in it and
//    goes on past its end sums that run's pieces in chunk order, rounds
//    once and writes the row. Every sum has one fixed order.
// A hot entry (every padded sample lands on one corner per level) costs at
// most BE_CHUNK steps in one group plus its chunks' count in another. The
// memset writes at the card's bandwidth and fills every SM, so the sort and
// the per-sample kernel mostly wait for it: the side stream saves little.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BE_P 8                 // elements per lane and per forward run
#define BE_CHUNK 64            // sorted contributions per chunk (ops/hash_encoding.py TABLE_CHUNK)
#define BE_THREADS 256         // forward block
#define BE_STAGE_BYTES 16384   // gathered row bytes per forward stage, at most
#define BE_MAX_RUNS 32         // runs of 8 elements per quarter (W <= 256)
#define BE_RUN_LEVELS 6        // binary counter levels for BE_MAX_RUNS runs
#define BE_BWD_SMEM 49152      // bytes a backward block stages, at most
#define BE_SMEM_LIMIT 232448   // shared memory a block can use on the H100

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float be_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float be_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T be_cast(float v);
template <> __device__ __forceinline__ bf16 be_cast<bf16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float be_cast<float>(float v) { return v; }

// v rounded to the table dtype, kept in f32
template <typename T> __device__ __forceinline__ float be_round(float v) {
    return be_f32(be_cast<T>(v));
}

// packed bf16 pairs, each half rounded once: round(a * b) and round(a + b)
__device__ __forceinline__ unsigned be_bmul(unsigned a, unsigned b) {
    unsigned d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
    return d;
}
__device__ __forceinline__ unsigned be_badd(unsigned a, unsigned b) {
    unsigned d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
    return d;
}
__device__ __forceinline__ float be_lo(unsigned v) {
    return __low2float(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float be_hi(unsigned v) {
    return __high2float(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ unsigned be_pair(bf16 lo, bf16 hi) {
    const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// asynchronous global -> shared copies
__device__ __forceinline__ unsigned be_smem(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void be_cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(be_smem(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void be_cp4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(be_smem(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void be_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void be_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 elements from 16-byte aligned memory (one 16-byte load in bf16, two in f32)
template <typename T> struct Vec8;
template <> struct Vec8<bf16> {
    uint4 v;
    __device__ __forceinline__ void load(const void* p) { v = *reinterpret_cast<const uint4*>(p); }
    __device__ __forceinline__ unsigned word(int i) const {
        return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    }
};
template <> struct Vec8<float> {
    float4 a, b;
    __device__ __forceinline__ void load(const void* p) {
        a = reinterpret_cast<const float4*>(p)[0];
        b = reinterpret_cast<const float4*>(p)[1];
    }
    __device__ __forceinline__ float at(int i) const {
        const float4& h = i < 4 ? a : b;
        const int j = i & 3;
        return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
    }
};

// t[i] = round(r[i] * c[i]) (c already rounded), in f32
__device__ __forceinline__ void be_terms(const Vec8<bf16>& r, const Vec8<bf16>& c,
                                         float (&t)[BE_P]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const unsigned p = be_bmul(r.word(i), c.word(i));
        t[2 * i] = be_lo(p);
        t[2 * i + 1] = be_hi(p);
    }
}
__device__ __forceinline__ void be_terms(const Vec8<float>& r, const Vec8<float>& c,
                                         float (&t)[BE_P]) {
#pragma unroll
    for (int i = 0; i < BE_P; ++i) t[i] = __fmul_rn(r.at(i), c.at(i));
}

// b[i] = round(round(r0[i] * w0) + round(r1[i] * w1)), in f32
__device__ __forceinline__ void be_blend(const Vec8<bf16>& r0, const Vec8<bf16>& r1,
                                         bf16 w0, bf16 w1, float (&b)[BE_P]) {
    const unsigned w0p = be_pair(w0, w0), w1p = be_pair(w1, w1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const unsigned p = be_badd(be_bmul(r0.word(i), w0p), be_bmul(r1.word(i), w1p));
        b[2 * i] = be_lo(p);
        b[2 * i + 1] = be_hi(p);
    }
}
__device__ __forceinline__ void be_blend(const Vec8<float>& r0, const Vec8<float>& r1,
                                         float w0, float w1, float (&b)[BE_P]) {
#pragma unroll
    for (int i = 0; i < BE_P; ++i)
        b[i] = __fadd_rn(__fmul_rn(r0.at(i), w0), __fmul_rn(r1.at(i), w1));
}

// the same one element at a time (widths that are not a multiple of 8)
template <typename T> __device__ __forceinline__ float be_term1(T r, T c) {
    return be_round<T>(__fmul_rn(be_f32(r), be_f32(c)));
}
template <typename T> __device__ __forceinline__ float be_blend1(T r0, T r1, T w0, T w1) {
    return be_round<T>(__fadd_rn(be_round<T>(__fmul_rn(be_f32(r0), be_f32(w0))),
                                 be_round<T>(__fmul_rn(be_f32(r1), be_f32(w1)))));
}

// N elements to 16-byte aligned global memory, as 16-byte stores
template <typename T, int N>
__device__ __forceinline__ void be_store(T* p, const float (&v)[N]) {
    constexpr int PER = 16 / (int)sizeof(T);
    static_assert(N % PER == 0, "whole 16-byte vectors");
#pragma unroll
    for (int k = 0; k < N / PER; ++k) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < PER; ++i) e[i] = be_cast<T>(v[k * PER + i]);
        reinterpret_cast<uint4*>(p)[k] = raw;
    }
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
};

// ---------------------------------------------------------------------------
// A3-fwd

// n / d for 0 <= n < 2^31 by a multiply and a shift (the divisor's magic
// number taken on the host: m = ceil(2^p / d), p = 31 + ceil(log2 d))
struct BeDiv {
    unsigned mul, shr;  // mul == 0: d == 1
    __device__ __forceinline__ int div(int n) const {
        return mul ? (int)(__umulhi((unsigned)n, mul) >> shr) : n;
    }
};

// the layout of one launch, computed on the host (be_fwd_plan)
struct FwdPlan {
    const unsigned char* table;
    const long long* entry_idx;
    const float *wy, *fx, *fz, *code;
    float* out;
    void *cg, *bh;
    int n, stages;               // samples; stages of UPS units (n * NG units)
    int L, H, W;
    int LG, NG, UPS;             // levels per unit, units per sample, units per stage
    int RB, RS, RPS, bulk;       // row bytes, row stride in shared memory, rows per
                                 // stage; rows by bulk copy (else 16-byte cp.async)
    int S;                       // ring slots
    int NR, pair_q;              // runs per quarter; `out`'s quarter order
    BeDiv lg, w, nkc, cpr, ng;   // divisors: LG, W, BH slots per level, 16-byte
                                 // chunks per row, NG
    int slot, o_sc, n_sc;        // a slot's bytes; its scalars (code, wy, fx, fz)
    int o_ce, o_u, o_wq, derived, o_cgs, o_cgr;  // two sets of per-stage buffers
    int o_bar, o_ring, smem;                     // (code, u, wq), then CG, mbarriers,
                                                 // the ring
};

// CG's f32 sum over tables of one (corner, level, quarter): round(row * code)
// in runs of 8 elements left to right, the runs combined as a binary
// counter (the tree of _sum_tables: pairwise, neighbours first); NRB >= NR
template <typename T, int FL, int NRB>
__device__ __forceinline__ void be_cg_runs(const unsigned char* row, const T* ce, int NR,
                                           float (&res)[FL]) {
    constexpr int LEVELS = NRB <= 8 ? 4 : BE_RUN_LEVELS;
    float stk[LEVELS][FL];
#pragma unroll
    for (int r = 0; r < NRB; ++r) {
        if (r < NR) {
            Vec8<T> rv, cv;
            rv.load(row + r * BE_P * sizeof(T));
            cv.load(ce + r * BE_P);
            float t[BE_P], run[FL];
            be_terms(rv, cv, t);
#pragma unroll
            for (int f = 0; f < FL; ++f) run[f] = 0.0f;
#pragma unroll
            for (int i = 0; i < BE_P; ++i) run[i % FL] = __fadd_rn(run[i % FL], t[i]);
            int lvl = 0;
#pragma unroll
            for (; lvl < LEVELS - 1; ++lvl) {
                if (!((r >> lvl) & 1)) break;
#pragma unroll
                for (int f = 0; f < FL; ++f) run[f] = __fadd_rn(stk[lvl][f], run[f]);
            }
#pragma unroll
            for (int f = 0; f < FL; ++f) stk[lvl][f] = run[f];
        }
    }
    bool have = false;
#pragma unroll
    for (int b = 0; b < LEVELS; ++b) {
        if ((NR >> b) & 1) {
#pragma unroll
            for (int f = 0; f < FL; ++f) res[f] = have ? __fadd_rn(stk[b][f], res[f]) : stk[b][f];
            have = true;
        }
    }
}

// `out`'s sum over quarters of p_q = cg_q * u_q: (z(p0) + p1) + (z(p2) + p3)
// with z(x) = 0 + x, or ((z(p0) + p1) + p2) + p3
__device__ __forceinline__ float be_quarter_sum(float p0, float p1, float p2, float p3,
                                                int pair_q) {
    const float a = __fadd_rn(__fadd_rn(0.0f, p0), p1);
    return pair_q ? __fadd_rn(a, __fadd_rn(__fadd_rn(0.0f, p2), p3))
                  : __fadd_rn(__fadd_rn(a, p2), p3);
}

__device__ __forceinline__ void be_bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(be_smem(bar)));
}
__device__ __forceinline__ void be_bar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(be_smem(bar)), "r"(bytes) : "memory");
}
// waits for the phase of `parity` to complete; traps after ~10^10 cycles
// instead of hanging the card
__device__ __forceinline__ void be_bar_wait(uint64_t* bar, unsigned parity) {
    const long long start = clock64();
    while (true) {
        unsigned done;
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(be_smem(bar)), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - start > 10000000000LL) __trap();
    }
}
__device__ __forceinline__ void be_bulk(void* dst, const void* src, unsigned bytes,
                                        uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(be_smem(dst)), "l"(src), "r"(bytes), "r"(be_smem(bar)) : "memory");
}

#define BE_NJ 2    // rows (or row chunks) a thread copies per stage, at most
#define BE_NSC 4   // scalars a thread copies per stage, at most

// FL: features per table; CODE: the blended encode (else the single grid);
// VEC: W a multiple of 8 (runs of 8 elements read as 16-byte vectors); NRB:
// the runs per quarter unrolled (8 or 32)
template <typename T, int FL, bool CODE, bool VEC, int NRB>
__global__ void __launch_bounds__(BE_THREADS, sizeof(T) == 2 ? 4 : 3)
be_fwd_kernel(const __grid_constant__ FwdPlan p) {
    extern __shared__ __align__(128) unsigned char be_sm[];
    constexpr int ES = (int)sizeof(T);
    const int tid = threadIdx.x;
    const int L = p.L, H = p.H, W = p.W, LG = p.LG, UPS = p.UPS, S = p.S;
    const int mine = p.stages > (int)blockIdx.x
        ? (p.stages - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
    const bool resid = p.cg != nullptr, blend = CODE && p.bh != nullptr;
    uint64_t* bars = reinterpret_cast<uint64_t*>(be_sm + p.o_bar);
    float* cgs = reinterpret_cast<float*>(be_sm + p.o_cgs);
    T* cgr = reinterpret_cast<T*>(be_sm + p.o_cgr);

    auto stage_at = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
    // stage k's first sample, first level, units and levels present
    auto first_sample = [&](int k) { return p.NG == 1 ? k * UPS : p.ng.div(k); };
    auto first_level = [&](int k) { return p.NG == 1 ? 0 : (k - p.ng.div(k) * p.NG) * LG; };
    auto units_here = [&](int k) { return p.NG == 1 ? min(UPS, p.n - k * UPS) : 1; };
    // the bytes of stage k's rows
    auto row_bytes = [&](int k) {
        const int rows = p.NG == 1 ? units_here(k) * 2 * L : 2 * min(LG, L - first_level(k));
        return (unsigned)(rows * p.RB);
    };

    // this thread's rows: by bulk copy rows (tid % 32) * 8 + tid / 32 (every
    // warp issues a few); else 16-byte chunk tid % CPR of rows tid / CPR +
    // j * (256 / CPR). Their entry indices and this thread's scalars are
    // loaded one stage ahead.
    const int cpr = p.RB / 16;
    const int rstep = p.bulk ? BE_THREADS : BE_THREADS / cpr;
    const int cj = p.bulk ? 0 : tid - p.cpr.div(tid) * cpr;
    const int r0 = p.bulk ? (tid & 31) * 8 + (tid >> 5)
                          : (tid < rstep * cpr ? p.cpr.div(tid) : BE_NJ * BE_THREADS);
    int idx[BE_NJ];
    float sc[BE_NSC];
    auto fetch = [&](int k) {
        const int s0 = first_sample(k), g0 = first_level(k), here = units_here(k);
#pragma unroll
        for (int j = 0; j < BE_NJ; ++j) {
            const int r = r0 + j * rstep;
            idx[j] = -1;
            if (r < p.RPS) {
                int c = 0, l = r;
                if (p.NG != 1) {
                    c = p.lg.div(r);
                    l = g0 + r - c * LG;
                }
                const long long pos = (long long)s0 * 2 * L + c * L + l;
                if (p.NG == 1 ? r < here * 2 * L : l < L)
                    idx[j] = (int)__ldg(p.entry_idx + pos);
            }
        }
        const int n_code = CODE ? UPS * H : 0, n_wy = UPS * 2 * LG, n_f = UPS * LG;
#pragma unroll
        for (int m = 0; m < BE_NSC; ++m) {
            int j = tid + m * BE_THREADS;
            const float* src = nullptr;
            if (j < n_code) {
                if (j < here * H) src = p.code + (long long)s0 * H + j;
            } else if ((j -= n_code) < n_wy) {
                if (p.NG == 1) {
                    if (j < here * 2 * L) src = p.wy + (long long)s0 * 2 * L + j;
                } else {
                    const int c = p.lg.div(j), l = g0 + j - c * LG;
                    if (l < L) src = p.wy + (long long)s0 * 2 * L + c * L + l;
                }
            } else if ((j -= n_wy) < 2 * n_f) {
                const bool z = j >= n_f;
                if (z) j -= n_f;
                const float* a = z ? p.fz : p.fx;
                if (p.NG == 1 ? j < here * L : g0 + j < L)
                    src = a + (long long)s0 * L + g0 + j;
            }
            sc[m] = src != nullptr ? __ldg(src) : 0.0f;
        }
    };
    // issue stage k's rows into ring slot `s` and store its scalars there
    auto issue = [&](int s) {
        unsigned char* base = be_sm + p.o_ring + s * p.slot;
#pragma unroll
        for (int j = 0; j < BE_NJ; ++j) {
            if (idx[j] < 0) continue;
            const int r = r0 + j * rstep;
            const unsigned char* src = p.table + (long long)idx[j] * p.RB;
            if (p.bulk) be_bulk(base + r * p.RS, src, p.RB, bars + s);
            else be_cp16(base + r * p.RS + cj * 16, src + cj * 16);
        }
        float* scs = reinterpret_cast<float*>(base + p.o_sc);
#pragma unroll
        for (int m = 0; m < BE_NSC; ++m)
            if (tid + m * BE_THREADS < p.n_sc) scs[tid + m * BE_THREADS] = sc[m];
    };
    // 0. stage k (ring slot s) into derived set d: the code rounded per
    // element, u_q, round(wy * u_q)
    auto derive = [&](int k, int s, int d) {
        const float* scs = reinterpret_cast<const float*>(be_sm + p.o_ring + s * p.slot + p.o_sc);
        const float* code_s = scs;
        const float* wy_s = scs + UPS * H;
        const float* fx_s = wy_s + UPS * 2 * LG;
        const float* fz_s = fx_s + UPS * LG;
        unsigned char* dset = be_sm + d * p.derived;
        T* ce = reinterpret_cast<T*>(dset + p.o_ce);
        float* us = reinterpret_cast<float*>(dset + p.o_u);
        T* wq = reinterpret_cast<T*>(dset + p.o_wq);
        const int here = units_here(k), nl = min(LG, L - first_level(k));
        const int n_ce = UPS * W;
        for (int i = tid; i < n_ce + UPS * LG; i += BE_THREADS) {
            if (i < n_ce) {
                const int ul = p.w.div(i), e = i - ul * W;
                if (ul < here) ce[i] = be_cast<T>(code_s[ul * H + e / FL]);
            } else {
                const int j = i - n_ce, ul = p.lg.div(j), li = j - ul * LG;
                if (ul < here && li < nl) {
                    const Quarters u(fx_s[j], fz_s[j]);
#pragma unroll
                    for (int q = 0; q < 4; ++q) us[j * 4 + q] = u.u[q];
                    if (blend) {
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const int rc = (ul * 2 + c) * LG + li;
#pragma unroll
                            for (int q = 0; q < 4; ++q)
                                wq[rc * 4 + q] = be_cast<T>(__fmul_rn(wy_s[rc], u.u[q]));
                        }
                    }
                }
            }
        }
    };
    auto wait_stage = [&](int i) {
        if (p.bulk) be_bar_wait(bars + i % S, (unsigned)((i / S) & 1));
        else be_cp_wait<2>();  // the cp.async path runs 4 slots: 2 stages may pend
    };

    // prologue: stages 0 .. S-2 in flight, stage 0 derived, stage S-1's
    // inputs loaded and its bytes expected
    if (tid == 0) {
        for (int s = 0; s < S; ++s) be_bar_init(bars + s);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (p.bulk)
            for (int i = 0; i < S - 1 && i < mine; ++i)
                be_bar_expect(bars + i, row_bytes(stage_at(i)));
    }
    __syncthreads();
    for (int i = 0; i < S - 1; ++i) {
        if (i < mine) {
            fetch(stage_at(i));
            issue(i);
        }
        be_cp_commit();
    }
    if (S - 1 < mine) fetch(stage_at(S - 1));
    if (mine > 0) {
        if (p.bulk) be_bar_wait(bars, 0);
        else be_cp_wait<2>();
        __syncthreads();
        if (CODE) derive(stage_at(0), 0, 0);
    }
    if (tid == 0 && p.bulk && S - 1 < mine)
        be_bar_expect(bars + (S - 1), row_bytes(stage_at(S - 1)));
    __syncthreads();

    for (int it = 0; it < mine; ++it) {
        const int ahead = it + S - 1;
        if (ahead < mine) issue(ahead % S);
        be_cp_commit();
        if (ahead + 1 < mine) fetch(stage_at(ahead + 1));

        const int k = stage_at(it);
        const int sl = it % S, d = it & 1;
        const unsigned char* slot = be_sm + p.o_ring + sl * p.slot;
        const float* scs = reinterpret_cast<const float*>(slot + p.o_sc);
        const float* wy_s = scs + (CODE ? UPS * H : 0);
        const int s0 = first_sample(k);
        const int l0 = first_level(k), here = units_here(k), nl = min(LG, L - l0);

        if constexpr (!CODE) {
            // the single grid: one thread per (unit, level) forms CG, stores
            // it and forms `out`
            const float* fx_s = wy_s + UPS * 2 * LG;
            const float* fz_s = fx_s + UPS * LG;
            for (int i = tid; i < UPS * LG; i += BE_THREADS) {
                const int ul = p.lg.div(i), li = i - ul * LG;
                if (ul >= here || li >= nl) continue;
                const Quarters u(fx_s[i], fz_s[i]);
                const long long s = s0 + ul;
                float g[2][FL];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int rc = (ul * 2 + c) * LG + li;
                    const T* e = reinterpret_cast<const T*>(slot + rc * p.RS);
                    float cg[4 * FL];
#pragma unroll
                    for (int x = 0; x < 4 * FL; ++x) cg[x] = __fadd_rn(0.0f, be_f32(e[x]));
                    if (resid)
                        be_store<T, 4 * FL>(reinterpret_cast<T*>(p.cg)
                                            + ((s * 2 + c) * L + l0 + li) * 4 * FL, cg);
#pragma unroll
                    for (int f = 0; f < FL; ++f)
                        g[c][f] = be_quarter_sum(__fmul_rn(cg[f], u.u[0]),
                                                 __fmul_rn(cg[FL + f], u.u[1]),
                                                 __fmul_rn(cg[2 * FL + f], u.u[2]),
                                                 __fmul_rn(cg[3 * FL + f], u.u[3]), p.pair_q);
                }
                const float w0 = wy_s[(ul * 2) * LG + li], w1 = wy_s[(ul * 2 + 1) * LG + li];
#pragma unroll
                for (int f = 0; f < FL; ++f)
                    p.out[(s * L + l0 + li) * FL + f] =
                        __fadd_rn(__fmul_rn(g[0][f], w0), __fmul_rn(g[1][f], w1));
            }
            if (it + 1 < mine) wait_stage(it + 1);
            if (tid == 0 && p.bulk && ahead + 1 < mine)
                be_bar_expect(bars + (ahead + 1) % S, row_bytes(stage_at(ahead + 1)));
            __syncthreads();
            continue;
        }

        const unsigned char* dset = be_sm + d * p.derived;
        const T* ce = reinterpret_cast<const T*>(dset + p.o_ce);
        const float* us = reinterpret_cast<const float*>(dset + p.o_u);
        const T* wq = reinterpret_cast<const T*>(dset + p.o_wq);

        // A. CG per (unit, quarter, corner, level); BH per (unit, level, 8 elements)
        const int n_cg = UPS * 8 * LG, nkc = VEC ? W / BE_P : W / 2;
        const int n_bh = blend ? UPS * LG * nkc : 0;
        for (int i = tid; i < n_cg + n_bh; i += BE_THREADS) {
            if (i < n_cg) {
                const int t = p.lg.div(i), li = i - t * LG;
                const int c = t & 1, q = (t >> 1) & 3, ul = t >> 3;
                if (ul >= here || li >= nl) continue;
                const int rc = (ul * 2 + c) * LG + li;
                const unsigned char* row = slot + rc * p.RS + q * W * ES;
                float res[FL];
                if (VEC) {
                    be_cg_runs<T, FL, NRB>(row, ce + ul * W, p.NR, res);
                } else {  // one run of every table
                    const T* e = reinterpret_cast<const T*>(row);
                    const T* ceu = ce + ul * W;
#pragma unroll
                    for (int f = 0; f < FL; ++f) res[f] = 0.0f;
                    for (int h = 0; h < H; ++h)
#pragma unroll
                        for (int f = 0; f < FL; ++f)
                            res[f] = __fadd_rn(res[f], be_term1<T>(e[h * FL + f], ceu[h * FL + f]));
                }
                const int o = (rc * 4 + q) * FL;
#pragma unroll
                for (int f = 0; f < FL; ++f) {
                    cgs[o + f] = res[f];
                    if (resid) cgr[o + f] = be_cast<T>(res[f]);
                }
            } else {
                const int j = i - n_cg, t = p.nkc.div(j), kc = j - t * nkc;
                const int ul = p.lg.div(t), li = t - ul * LG;
                if (ul >= here || li >= nl) continue;
                const int rc0 = (ul * 2) * LG + li, rc1 = rc0 + LG;
                const unsigned char* row0 = slot + rc0 * p.RS;
                const unsigned char* row1 = slot + rc1 * p.RS;
                const T* w0 = wq + rc0 * 4;
                const T* w1 = wq + rc1 * 4;
                T* dst = reinterpret_cast<T*>(p.bh) + ((long long)(s0 + ul) * L + l0 + li) * W;
                if (VEC) {
                    float b[4][BE_P], sum[BE_P];
                    const int col = kc * BE_P * ES;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        Vec8<T> a0, a1;
                        a0.load(row0 + q * W * ES + col);
                        a1.load(row1 + q * W * ES + col);
                        be_blend(a0, a1, w0[q], w1[q], b[q]);
                    }
#pragma unroll
                    for (int e = 0; e < BE_P; ++e)
                        sum[e] = __fadd_rn(__fadd_rn(b[0][e], b[1][e]), __fadd_rn(b[2][e], b[3][e]));
                    be_store<T, BE_P>(dst + kc * BE_P, sum);
                } else {  // two elements
                    const T* e0 = reinterpret_cast<const T*>(row0);
                    const T* e1 = reinterpret_cast<const T*>(row1);
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        const int col = kc * 2 + x;
                        float b[4];
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            b[q] = be_blend1<T>(e0[q * W + col], e1[q * W + col], w0[q], w1[q]);
                        dst[col] = be_cast<T>(__fadd_rn(__fadd_rn(b[0], b[1]), __fadd_rn(b[2], b[3])));
                    }
                }
            }
        }
        // the next stage's copies have landed
        if (it + 1 < mine) wait_stage(it + 1);
        __syncthreads();

        // B. out per (unit, level, feature); CG leaves; 0. for the next stage
        for (int i = tid; i < UPS * LG * FL; i += BE_THREADS) {
            const int t = i / FL, f = i - t * FL, ul = p.lg.div(t), li = t - ul * LG;
            if (ul >= here || li >= nl) continue;
            const float* uu = us + (ul * LG + li) * 4;
            float g[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float* cc = cgs + ((ul * 2 + c) * LG + li) * 4 * FL + f;
                g[c] = be_quarter_sum(__fmul_rn(cc[0], uu[0]), __fmul_rn(cc[FL], uu[1]),
                                      __fmul_rn(cc[2 * FL], uu[2]), __fmul_rn(cc[3 * FL], uu[3]),
                                      p.pair_q);
            }
            const float w0 = wy_s[(ul * 2) * LG + li], w1 = wy_s[(ul * 2 + 1) * LG + li];
            p.out[((long long)(s0 + ul) * L + l0 + li) * FL + f] =
                __fadd_rn(__fmul_rn(g[0], w0), __fmul_rn(g[1], w1));
        }
        if (resid) {
            // each corner's levels of a unit are contiguous in CG: 16-byte
            // stores where a piece is whole 16-byte vectors, else elements
            const int piece = nl * 4 * FL;  // elements per (unit, corner)
            if ((piece * ES) % 16 == 0 && (LG * 4 * FL * ES) % 16 == 0
                && (L * 4 * FL * ES) % 16 == 0) {
                const int v16 = piece * ES / 16;
                for (int i = tid; i < here * 2 * v16; i += BE_THREADS) {
                    const int uc = i / v16, v = i - uc * v16;
                    const uint4* src = reinterpret_cast<const uint4*>(cgr + uc * LG * 4 * FL) + v;
                    uint4* dst = reinterpret_cast<uint4*>(
                        reinterpret_cast<T*>(p.cg) + ((long long)(s0 * 2 + uc) * L + l0) * 4 * FL) + v;
                    *dst = *src;
                }
            } else {
                for (int i = tid; i < here * 2 * piece; i += BE_THREADS) {
                    const int uc = i / piece, e = i - uc * piece;
                    reinterpret_cast<T*>(p.cg)[((long long)(s0 * 2 + uc) * L + l0) * 4 * FL + e] =
                        cgr[uc * LG * 4 * FL + e];
                }
            }
        }
        if (it + 1 < mine) derive(stage_at(it + 1), (it + 1) % S, d ^ 1);
        if (tid == 0 && p.bulk && ahead + 1 < mine)
            be_bar_expect(bars + (ahead + 1) % S, row_bytes(stage_at(ahead + 1)));
        __syncthreads();
    }
    be_cp_wait<0>();
}

// ---------------------------------------------------------------------------
// A3-bwd, per sample: one warp per sample. With mfac, also each position's
// rounded row factor [4][FL] (MP elements, zero padded to 16 bytes) and,
// with a code, the rounded code row (HP elements, zero padded)
template <typename T, int FL>
struct Factor {
    static constexpr int PER = 16 / (int)sizeof(T);
    static constexpr int MP = (4 * FL + PER - 1) / PER * PER;
};

template <typename T, int FL, bool CODE>
__global__ void __launch_bounds__(256)
be_sample_kernel(const float* __restrict__ gbar, const T* __restrict__ cg_res,
                 const T* __restrict__ bh_res, const float* __restrict__ code,
                 const float* __restrict__ wy, const float* __restrict__ fx,
                 const float* __restrict__ fz, T* __restrict__ mfac, T* __restrict__ coder,
                 float* __restrict__ d_code, float* __restrict__ d_wy,
                 float* __restrict__ d_fx, float* __restrict__ d_fz,
                 long long n, int L, int H, int HP) {
    constexpr int MP = Factor<T, FL>::MP;
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
            if (mfac != nullptr) {
                // round(gbar * u * wy): the row gradient's first rounding
                float m[MP];
#pragma unroll
                for (int e = 0; e < MP; ++e)
                    m[e] = e < 4 * FL ? be_round<T>(__fmul_rn(__fmul_rn(gb[e % FL], u.u[(e / FL) & 3]), wc))
                                      : 0.0f;
                be_store<T, MP>(mfac + j * MP, m);
            }
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
        if (coder != nullptr)
            for (int h = lane; h < HP; h += 32)
                coder[s * HP + h] = be_cast<T>(h < H ? code[s * H + h] : 0.0f);
    }
}

// A3-bwd: the table gradient of one chunk of sorted positions per group of R
// lanes (R = 4W/8, any count: no shuffles), each lane 8 elements of the row.
// The block's chunks are staged first: keys, factor vectors, code rows.
// ALIGNED: W a multiple of 8 (a lane's elements lie in one quarter).
template <typename T, int FL, bool CODE, bool ALIGNED>
__global__ void __launch_bounds__(256)
be_chunk_kernel(const int* __restrict__ skey, const long long* __restrict__ perm,
                long long total, const T* __restrict__ mfac, const T* __restrict__ coder,
                T* __restrict__ d_table, float* __restrict__ partial,
                int L, int W, int R, int CPB, int HP) {
    constexpr int P = BE_P;
    constexpr int MP = Factor<T, FL>::MP;
    constexpr int PER = 16 / (int)sizeof(T);
    extern __shared__ __align__(16) unsigned char be_sm[];
    const int tid = threadIdx.x, nth = blockDim.x;
    const int NP = CPB * BE_CHUNK;
    int* keys = reinterpret_cast<int*>(be_sm);
    T* msm = reinterpret_cast<T*>(be_sm + NP * 4);
    T* csm = msm + NP * MP;
    const long long lo_b = (long long)blockIdx.x * NP;
    const int np = (int)min((long long)NP, total - lo_b);
    const unsigned two_l = 2u * (unsigned)L;

    // staging: every load issued before any is awaited
    for (int i = tid; i < np; i += nth) be_cp4(keys + i, skey + lo_b + i);
    for (int i0 = tid; i0 < np; i0 += 8 * nth) {
        long long pp[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = i0 + j * nth;
            pp[j] = i < np ? __ldg(perm + lo_b + i) : 0;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = i0 + j * nth;
            if (i >= np) continue;
#pragma unroll
            for (int v = 0; v < MP / PER; ++v)
                be_cp16(msm + i * MP + v * PER, mfac + pp[j] * MP + v * PER);
            if (CODE) {
                const long long s = (unsigned)pp[j] / two_l;
                for (int v = 0; v < HP / PER; ++v)
                    be_cp16(csm + i * HP + v * PER, coder + s * HP + v * PER);
            }
        }
    }
    be_cp_commit();
    be_cp_wait<0>();
    __syncthreads();

    const int g = tid / R, t = tid - g * R;
    const long long lo = lo_b + (long long)g * BE_CHUNK;
    if (g >= CPB || lo >= total) return;
    const long long hi = lo + BE_CHUNK < total ? lo + BE_CHUNK : total;
    const int W4 = 4 * W, k0 = t * P;
    const int key_before = lo > 0 ? skey[lo - 1] : -1;
    const int key_after = hi < total ? skey[hi] : -1;

    // the shared-memory offsets of the lane's elements: factor m[q][f] and
    // code[h] of element k = k0 + e (q = k / W, h = (k % W) / FL, f = e % FL)
    int mo[P], co[P];
#pragma unroll
    for (int e = 0; e < P; ++e) {
        const int k = ALIGNED ? k0 : k0 + e;
        const int q = k / W, h = (k % W) / FL;
        mo[e] = CODE ? q * FL + e % FL : k0 + e;
        co[e] = ALIGNED ? h + e / FL : h;
    }

    float acc[P];
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] = 0.0f;
    long long a = lo;  // start of the current piece
    int key = keys[lo - lo_b];

    auto flush = [&](long long b) {
        const bool head = a > lo || key_before != key;
        const bool end = b < hi || key_after != key;
        if (head && end) {
            be_store<T, P>(d_table + (long long)key * W4 + k0, acc);
        } else {
            const int slot = a == lo ? 0 : 1;
            float* dst = partial + ((lo / BE_CHUNK) * 2 + slot) * W4 + k0;
            reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        }
#pragma unroll
        for (int e = 0; e < P; ++e) acc[e] = 0.0f;
    };

#pragma unroll 2
    for (long long i = lo; i < hi; ++i) {
        const int li = (int)(i - lo_b);
        const int ki = keys[li];
        if (ki != key) {
            flush(i);
            a = i;
            key = ki;
        }
        const T* ms = msm + li * MP;
        float d[P];
        if (CODE) {
            // round(m * round(code)), the packed pairs (2e, 2e + 1)
            const T* cs = csm + li * HP;
            if constexpr (sizeof(T) == 2) {
#pragma unroll
                for (int e = 0; e < P; e += 2) {
                    const unsigned pm = be_pair(ms[mo[e]], ms[mo[e + 1]]);
                    const unsigned pc = be_pair(cs[co[e]], cs[co[e + 1]]);
                    const unsigned pr = be_bmul(pm, pc);
                    d[e] = be_lo(pr);
                    d[e + 1] = be_hi(pr);
                }
            } else {
#pragma unroll
                for (int e = 0; e < P; ++e) d[e] = __fmul_rn(be_f32(ms[mo[e]]), be_f32(cs[co[e]]));
            }
        } else {
#pragma unroll
            for (int e = 0; e < P; ++e) d[e] = be_f32(ms[mo[e]]);
        }
#pragma unroll
        for (int e = 0; e < P; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
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
    be_store<T, P>(d_table + (long long)key * W4 + t * P, acc);
}

// ---------------------------------------------------------------------------
// host side

static int be_log2(long long v) {
    int k = 0;
    while ((1LL << k) < v) ++k;
    return (1LL << k) == v ? k : -1;
}

static int be_align16(long long v) { return (int)((v + 15) / 16 * 16); }

// the shapes the kernels take: FL in {1, 2, 4, 8}, rows of whole 8-element
// chunks (4W a multiple of 8) up to 4W = 1024, and with no code one table
// (W = FL)
static bool be_valid(long long W, long long FL, long long H, bool has_code,
                     long long elem_bytes) {
    if (be_log2(FL) < 0 || FL > BE_P || H < 1 || H * FL != W || (4 * W) % BE_P
        || 4 * W > 128 * BE_P || (!has_code && H != 1))
        return false;
    return elem_bytes == 2 || elem_bytes == 4;
}

static BeDiv be_div(unsigned d) {
    BeDiv v{0u, 0u};
    if (d > 1) {
        unsigned l = 0;
        while ((1u << l) < d) ++l;
        const unsigned p = 31 + l;
        v.mul = (unsigned)(((1ull << p) + d - 1) / d);
        v.shr = p - 32;
    }
    return v;
}

// the forward's stages and shared-memory layout; false if it has none
static bool be_fwd_plan(FwdPlan& p, long long n, int L, int H, int W, int FL, int es,
                        bool code) {
    p.n = (int)n;
    p.L = L;
    p.H = H;
    p.W = W;
    p.RB = 4 * W * es;
    p.bulk = p.RB >= 64;  // narrower rows: one 16-byte cp.async per chunk
    // rows a stage can hold: one per thread (bulk), or BE_NJ per thread's chunk
    const int rows_cap = p.bulk ? BE_THREADS : BE_NJ * (BE_THREADS / (p.RB / 16));
    const int per_unit_sc = code ? H : 0;  // + 4 per level
    const long long sample = 2LL * L * p.RB;
    if (sample <= (p.bulk ? 2 : 1) * BE_STAGE_BYTES && 2 * L <= rows_cap) {
        p.LG = L;  // whole samples: up to 32 KB of rows in one stage
        p.NG = 1;
        long long ups = BE_STAGE_BYTES / sample;
        const long long cap = rows_cap / (2 * L);
        const long long cap_sc = (long long)BE_NSC * BE_THREADS / (per_unit_sc + 4 * L);
        ups = ups > cap ? cap : ups;
        ups = ups > cap_sc ? cap_sc : ups;
        p.UPS = (int)(ups < 1 ? 1 : ups);
    } else {
        long long lg = BE_STAGE_BYTES / (2 * p.RB);
        lg = lg < 1 ? 1 : lg > rows_cap / 2 ? rows_cap / 2 : lg;
        p.LG = (int)lg;
        p.NG = (int)((L + lg - 1) / lg);
        p.UPS = 1;
    }
    p.RPS = p.UPS * 2 * p.LG;
    // ring slots: 2 for stages past 16 KB (a whole f32 sample: three blocks
    // per SM), 3 for bf16 rows (four blocks per SM), else 4; the cp.async
    // path waits on 4
    p.S = !p.bulk ? 4 : (long long)p.RPS * p.RB > BE_STAGE_BYTES ? 2 : es == 2 ? 3 : 4;
    p.RS = p.RB + ((p.RB / 16) % 2 == 0 ? 16 : 32);  // an odd number of 16-byte chunks
    p.NR = W % BE_P == 0 ? W / BE_P : 1;
    p.pair_q = be_log2(W) >= 2 && W <= 64;
    p.stages = (int)((n * p.NG + p.UPS - 1) / p.UPS);
    const int UPS = p.UPS, LG = p.LG;
    p.lg = be_div(LG);
    p.w = be_div(W);
    p.nkc = be_div(W % BE_P == 0 ? W / BE_P : W / 2);
    p.cpr = be_div(p.RB / 16);
    p.ng = be_div(p.NG);
    p.n_sc = UPS * (per_unit_sc + 4 * LG);
    // the derived sets first (two), then CG, the mbarriers and the ring
    p.o_ce = 0;
    p.o_u = be_align16(code ? UPS * W * es : 0);
    p.o_wq = be_align16(p.o_u + UPS * LG * 16);
    p.derived = be_align16(p.o_wq + UPS * 2 * LG * 4 * es);
    p.o_cgs = 2 * p.derived;
    p.o_cgr = be_align16(p.o_cgs + UPS * 8 * LG * FL * 4);
    p.o_bar = be_align16(p.o_cgr + UPS * 8 * LG * FL * es);
    p.o_ring = (p.o_bar + 8 * 4 + 127) / 128 * 128;
    // a ring slot: the rows, then the units' code, wy, fx, fz
    p.o_sc = be_align16((long long)p.RPS * p.RS);
    p.slot = (p.o_sc + p.n_sc * 4 + 127) / 128 * 128;
    p.smem = p.o_ring + p.S * p.slot;
    return p.RPS <= rows_cap && p.n_sc <= BE_NSC * BE_THREADS && p.smem <= BE_SMEM_LIMIT;
}

template <typename T, int FL, bool CODE, bool VEC, int NRB>
static int be_launch_fwd(const FwdPlan& p, cudaStream_t st) {
    auto kernel = be_fwd_kernel<T, FL, CODE, VEC, NRB>;
    // the shared-memory attribute and the resident blocks, taken again only
    // when the device or the shared memory changes (a render calls this
    // hundreds of times per frame)
    static int last_device = -1, last_smem = -1;
    static long long resident = 1;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && (device != last_device || p.smem != last_smem)) {
        int sms = 0, per_sm = 0;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   p.smem);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BE_THREADS,
                                                                p.smem);
        if (err == cudaSuccess) {
            resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
            last_device = device;
            last_smem = p.smem;
        }
    }
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)(p.stages < resident ? p.stages : resident);
    be_fwd_kernel<T, FL, CODE, VEC, NRB><<<grid, BE_THREADS, p.smem, st>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, int FL, bool CODE>
static int be_fwd_vec(const FwdPlan& p, cudaStream_t st) {
    if constexpr (CODE) {
        if (p.W % BE_P == 0)
            return p.NR <= 8 ? be_launch_fwd<T, FL, true, true, 8>(p, st)
                             : be_launch_fwd<T, FL, true, true, BE_MAX_RUNS>(p, st);
        if constexpr (FL < BE_P) return be_launch_fwd<T, FL, true, false, 1>(p, st);
        return (int)cudaErrorInvalidValue;
    } else {  // the single grid: one table of FL >= 2 features
        if constexpr (FL >= 2) return be_launch_fwd<T, FL, false, false, 1>(p, st);
        return (int)cudaErrorInvalidValue;
    }
}

template <typename T, bool CODE>
static int be_fwd_fl(int fl, const FwdPlan& p, cudaStream_t st) {
    if (fl == 1) return be_fwd_vec<T, 1, CODE>(p, st);
    if (fl == 2) return be_fwd_vec<T, 2, CODE>(p, st);
    if (fl == 4) return be_fwd_vec<T, 4, CODE>(p, st);
    if (fl == 8) return be_fwd_vec<T, 8, CODE>(p, st);
    return (int)cudaErrorInvalidValue;
}

// table [E, 4W] (E < 2^31), entry_idx [n, 2L], wy [n, 2L], fx, fz [n, L] f32,
// code [n, H] f32 or null; out [n, L*FL] f32; cg [n, 2, L, 4, FL] and
// bh [n, L, H, FL] in the table dtype, or null (no residuals kept; bh is
// always null without a code). table, cg and bh 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it lacks.
extern "C" int blended_encode_fwd(const void* table, const void* entry_idx,
                                  const void* wy, const void* fx, const void* fz,
                                  const void* code, void* out, void* cg, void* bh,
                                  long long n, long long L, long long H, long long W,
                                  long long FL, long long elem_bytes, void* stream) {
    const bool has_code = code != nullptr;
    if (!be_valid(W, FL, H, has_code, elem_bytes) || n < 0 || L < 1 || L > 4096
        || n * 2 * L >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    FwdPlan p{};
    if (!be_fwd_plan(p, n, (int)L, (int)H, (int)W, (int)FL, (int)elem_bytes, has_code))
        return (int)cudaErrorInvalidValue;
    p.table = (const unsigned char*)table;
    p.entry_idx = (const long long*)entry_idx;
    p.wy = (const float*)wy;
    p.fx = (const float*)fx;
    p.fz = (const float*)fz;
    p.code = (const float*)code;
    p.out = (float*)out;
    p.cg = cg;
    p.bh = has_code ? bh : nullptr;
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_bytes == 2)
        return has_code ? be_fwd_fl<bf16, true>((int)FL, p, st)
                        : be_fwd_fl<bf16, false>((int)FL, p, st);
    return has_code ? be_fwd_fl<float, true>((int)FL, p, st)
                    : be_fwd_fl<float, false>((int)FL, p, st);
}

// the backward's scratch row widths in elements: the row factor [4][FL] and
// the rounded code [H], each padded to whole 16-byte vectors
static long long be_pad(long long v, long long elem_bytes) {
    const long long per = 16 / elem_bytes;
    return (v + per - 1) / per * per;
}

template <typename T, int FL, bool CODE>
static int be_launch_sample(const void* gbar, const void* cg, const void* bh,
                            const void* code, const void* wy, const void* fx,
                            const void* fz, void* mfac, void* coder, void* d_code,
                            void* d_wy, void* d_fx, void* d_fz, long long n, int L,
                            int H, cudaStream_t st) {
    const unsigned grid = (unsigned)((n * 32 + 255) / 256);
    be_sample_kernel<T, FL, CODE><<<grid, 256, 0, st>>>(
        (const float*)gbar, (const T*)cg, (const T*)bh, (const float*)code,
        (const float*)wy, (const float*)fx, (const float*)fz, (T*)mfac, (T*)coder,
        (float*)d_code, (float*)d_wy, (float*)d_fx, (float*)d_fz, n, L, H,
        (int)be_pad(H, sizeof(T)));
    return (int)cudaGetLastError();
}

template <typename T, bool CODE>
static int be_sample_fl(int fl, const void* gbar, const void* cg, const void* bh,
                        const void* code, const void* wy, const void* fx, const void* fz,
                        void* mfac, void* coder, void* d_code, void* d_wy, void* d_fx,
                        void* d_fz, long long n, int L, int H, cudaStream_t st) {
#define BE_SAMPLE(F) be_launch_sample<T, F, CODE>(gbar, cg, bh, code, wy, fx, fz, mfac, \
        coder, d_code, d_wy, d_fx, d_fz, n, L, H, st)
    if (fl == 1) return BE_SAMPLE(1);
    if (fl == 2) return BE_SAMPLE(2);
    if (fl == 4) return BE_SAMPLE(4);
    if (fl == 8) return BE_SAMPLE(8);
#undef BE_SAMPLE
    return (int)cudaErrorInvalidValue;
}

// gbar [n, L*FL] f32, cg / bh the forward's residuals (bh null without a
// code), code / wy / fx / fz as the forward's; outputs d_code [n, H] (null
// without a code), d_wy [n, 2L], d_fx, d_fz [n, L] f32 and, unless null (no
// table gradient wanted), the scratch mfac [n*2L, MP] and coder [n, HP] in
// the table dtype (MP = 4*FL and HP = H elements, each padded to whole
// 16-byte vectors; coder null without a code)
extern "C" int blended_encode_bwd_sample(const void* gbar, const void* cg, const void* bh,
                                         const void* code, const void* wy, const void* fx,
                                         const void* fz, void* mfac, void* coder,
                                         void* d_code, void* d_wy, void* d_fx, void* d_fz,
                                         long long n, long long L, long long H, long long W,
                                         long long FL, long long elem_bytes, void* stream) {
    const bool has_code = code != nullptr;
    if (!be_valid(W, FL, H, has_code, elem_bytes) || n < 0 || L < 1
        || n * 2 * L >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_bytes == 2)
        return has_code
            ? be_sample_fl<bf16, true>((int)FL, gbar, cg, bh, code, wy, fx, fz, mfac, coder,
                                       d_code, d_wy, d_fx, d_fz, n, (int)L, (int)H, st)
            : be_sample_fl<bf16, false>((int)FL, gbar, cg, bh, code, wy, fx, fz, mfac,
                                        nullptr, d_code, d_wy, d_fx, d_fz, n, (int)L,
                                        (int)H, st);
    return has_code
        ? be_sample_fl<float, true>((int)FL, gbar, cg, bh, code, wy, fx, fz, mfac, coder,
                                    d_code, d_wy, d_fx, d_fz, n, (int)L, (int)H, st)
        : be_sample_fl<float, false>((int)FL, gbar, cg, bh, code, wy, fx, fz, mfac,
                                     nullptr, d_code, d_wy, d_fx, d_fz, n, (int)L, (int)H,
                                     st);
}

template <typename T, int FL, bool CODE, bool ALIGNED>
static int be_launch_chunks(const void* skey, const void* perm, const void* mfac,
                            const void* coder, void* d_table, void* partial,
                            long long total, int L, int H, int W, cudaStream_t st) {
    auto kernel = be_chunk_kernel<T, FL, CODE, ALIGNED>;
    const int R = 4 * W / BE_P;
    const int HP = CODE ? (int)be_pad(H, sizeof(T)) : 0;
    const long long per_pos = 4 + (Factor<T, FL>::MP + HP) * (long long)sizeof(T);
    long long cpb = BE_THREADS / R;
    const long long fit = BE_BWD_SMEM / (BE_CHUNK * per_pos);
    if (fit < cpb) cpb = fit;
    if (cpb < 1) cpb = 1;
    const long long smem = cpb * BE_CHUNK * per_pos;
    if (smem > BE_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long n_chunks = (total + BE_CHUNK - 1) / BE_CHUNK;
    be_chunk_kernel<T, FL, CODE, ALIGNED><<<(unsigned)((n_chunks + cpb - 1) / cpb),
                                             (unsigned)(R * cpb), (size_t)smem, st>>>(
        (const int*)skey, (const long long*)perm, total, (const T*)mfac, (const T*)coder,
        (T*)d_table, (float*)partial, L, W, R, (int)cpb, HP);
    return (int)cudaGetLastError();
}

template <typename T, int FL, bool CODE>
static int be_chunks_aligned(const void* skey, const void* perm, const void* mfac,
                             const void* coder, void* d_table, void* partial,
                             long long total, int L, int H, int W, cudaStream_t st) {
    if (W % BE_P == 0)
        return be_launch_chunks<T, FL, CODE, true>(skey, perm, mfac, coder, d_table, partial,
                                                   total, L, H, W, st);
    return be_launch_chunks<T, FL, CODE, false>(skey, perm, mfac, coder, d_table, partial,
                                                total, L, H, W, st);
}

template <typename T, bool CODE>
static int be_chunks_fl(int fl, const void* skey, const void* perm, const void* mfac,
                        const void* coder, void* d_table, void* partial, long long total,
                        int L, int H, int W, cudaStream_t st) {
#define BE_CHUNKS(F) be_chunks_aligned<T, F, CODE>(skey, perm, mfac, coder, d_table, \
        partial, total, L, H, W, st)
    if (fl == 1) return BE_CHUNKS(1);
    if (fl == 2) return BE_CHUNKS(2);
    if (fl == 4) return BE_CHUNKS(4);
    if (fl == 8) return BE_CHUNKS(8);
#undef BE_CHUNKS
    return (int)cudaErrorInvalidValue;
}

// skey [n*2L] int32 the sorted entry indices and perm [n*2L] int64 their
// positions in entry_idx (a stable sort); mfac / coder from
// blended_encode_bwd_sample (coder null without a code); scratch partial
// [2 * ceil(n*2L / BE_CHUNK), 4W] f32; d_table [E, 4W] in the table dtype,
// zeroed before this runs: every row some position reaches is written
extern "C" int blended_encode_bwd_chunks(const void* skey, const void* perm,
                                         const void* mfac, const void* coder,
                                         void* d_table, void* partial, long long n,
                                         long long L, long long H, long long W,
                                         long long FL, long long elem_bytes, void* stream) {
    const bool has_code = coder != nullptr;
    if (!be_valid(W, FL, H, has_code, elem_bytes) || n < 0 || L < 1
        || n * 2 * L >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long total = n * 2 * L;
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_bytes == 2)
        return has_code
            ? be_chunks_fl<bf16, true>((int)FL, skey, perm, mfac, coder, d_table, partial,
                                       total, (int)L, (int)H, (int)W, st)
            : be_chunks_fl<bf16, false>((int)FL, skey, perm, mfac, nullptr, d_table,
                                        partial, total, (int)L, (int)H, (int)W, st);
    return has_code
        ? be_chunks_fl<float, true>((int)FL, skey, perm, mfac, coder, d_table, partial,
                                    total, (int)L, (int)H, (int)W, st)
        : be_chunks_fl<float, false>((int)FL, skey, perm, mfac, nullptr, d_table, partial,
                                     total, (int)L, (int)H, (int)W, st);
}

// the runs that span chunks, after blended_encode_bwd_chunks on the same
// keys, scratch and table gradient
extern "C" int blended_encode_bwd_spans(const void* skey, const void* partial,
                                        void* d_table, long long n, long long L,
                                        long long W, long long elem_bytes, void* stream) {
    if (n < 0 || L < 1 || W < 1 || (4 * W) % BE_P || 4 * W > 128 * BE_P
        || n * 2 * L >= (1LL << 31) || (elem_bytes != 2 && elem_bytes != 4))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long total = n * 2 * L, n_chunks = (total + BE_CHUNK - 1) / BE_CHUNK;
    const int W4 = (int)(4 * W), R = W4 / BE_P;
    const unsigned grid = (unsigned)((n_chunks * R + 255) / 256);
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_bytes == 2)
        be_span_kernel<bf16><<<grid, 256, 0, st>>>((const int*)skey, total,
                                                   (const float*)partial, (bf16*)d_table, W4, R);
    else
        be_span_kernel<float><<<grid, 256, 0, st>>>((const int*)skey, total,
                                                    (const float*)partial, (float*)d_table, W4, R);
    return (int)cudaGetLastError();
}

// the table gradient's zeros (rows no sample reached), on the stream given
extern "C" int blended_encode_zero(void* d_table, long long bytes, void* stream) {
    if (bytes < 0) return (int)cudaErrorInvalidValue;
    return (int)cudaMemsetAsync(d_table, 0, (size_t)bytes, (cudaStream_t)stream);
}
