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
// barrier per stage. Quad rows of 4 elements (one feature: the single
// grid's column that one rank of two holds under the feature-sharded
// layout) are 8 bytes in bf16, which no bulk copy takes (its size is a
// multiple of 16 bytes): be_fwd_narrow_kernel takes one thread per
// (sample, level), reads its two rows with read-only vector loads and sums
// in the single grid's order for W = 1 and 2, so a rank's column of
// features equals the whole table's column bit for bit. With residuals off (render) BH and the residual stores
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
// Rows of 4 elements (W = 1) take a path of their own in the same order
// (below: the keys ordered by the kernels' own counting sort, every row
// written by a reduce, no memset, no torch.sort).
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

// a quad row of 4 elements: 8 bytes in bf16, 16 in f32
template <typename T> struct Row4;
template <> struct Row4<bf16> { typedef uint2 type; };
template <> struct Row4<float> { typedef float4 type; };

__device__ __forceinline__ void be_row4(uint2 r, float (&v)[4]) {
    v[0] = be_lo(r.x);
    v[1] = be_hi(r.x);
    v[2] = be_lo(r.y);
    v[3] = be_hi(r.y);
}
__device__ __forceinline__ void be_row4(float4 r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
}
// 4 values rounded to the table dtype, packed as a quad row
__device__ __forceinline__ void be_pack4(const float (&v)[4], uint2& r) {
    r = make_uint2(be_pair(be_cast<bf16>(v[0]), be_cast<bf16>(v[1])),
                   be_pair(be_cast<bf16>(v[2]), be_cast<bf16>(v[3])));
}
__device__ __forceinline__ void be_pack4(const float (&v)[4], float4& r) {
    r = make_float4(v[0], v[1], v[2], v[3]);
}

// A3-fwd on quad rows of 4 elements (W = FL = 1, no code): one thread per
// (sample, level) item i = s * L + l (s = i / L by a multiply and a shift).
// What bounds it on the H100: the row gathers, two loads of 8 or 16 bytes
// per item from a table of 49.5 / 99 MB (the single grid's column), each
// its own 32-byte sector, beside the streams of indices, weights, `out` and
// CG. Variants timed in turns on the card were slower: four items per
// thread with every load issued before the first blend, an L2 evict-last
// hint on the rows, streaming stores of `out` and CG, 1024-thread blocks.
// Evict-first loads of the streams help in bf16 and cost a little in f32,
// which loads them plainly. CG (cg, unless null) and `out` as the
// single-grid path of be_fwd_kernel forms them: cg_q = 0 + row_q, then
// ((z(p0) + p1) + p2) + p3 per corner, then corner 0 * wy0 + corner 1 * wy1.
template <typename T>
__global__ void __launch_bounds__(256)
be_fwd_narrow_kernel(const T* __restrict__ table, const long long* __restrict__ entry_idx,
                     const float* __restrict__ wy, const float* __restrict__ fx,
                     const float* __restrict__ fz, float* __restrict__ out,
                     T* __restrict__ cg, int items, int L, BeDiv per_level) {
    typedef typename Row4<T>::type Row;
    const int i = (int)blockIdx.x * 256 + (int)threadIdx.x;
    if (i >= items) return;
    const int s = per_level.div(i), l = i - s * L, j = s * 2 * L + l;
    auto stream = [](const auto* p) {
        if constexpr (sizeof(T) == 2) return __ldcs(p);
        else return *p;
    };
    const long long e0 = stream(entry_idx + j), e1 = stream(entry_idx + j + L);
    const float w0 = stream(wy + j), w1 = stream(wy + j + L);
    const Quarters u(stream(fx + i), stream(fz + i));
    const Row* rows = reinterpret_cast<const Row*>(table);
    const Row r[2] = {__ldg(rows + e0), __ldg(rows + e1)};
    float g[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        float v[4];
        be_row4(r[c], v);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = __fadd_rn(0.0f, v[q]);
        if (cg != nullptr) be_pack4(v, reinterpret_cast<Row*>(cg)[j + c * L]);
        g[c] = be_quarter_sum(__fmul_rn(v[0], u.u[0]), __fmul_rn(v[1], u.u[1]),
                              __fmul_rn(v[2], u.u[2]), __fmul_rn(v[3], u.u[3]), 0);
    }
    out[i] = __fadd_rn(__fmul_rn(g[0], w0), __fmul_rn(g[1], w1));
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

// d_wy, d_fx, d_fz (and with mfac the row factors) of sample s, level l;
// PACK: one feature, the factors as quad rows of 4 elements (8 or 16 bytes)
template <typename T, int FL, bool PACK = false>
__device__ __forceinline__ void be_sample_level(
        const float* __restrict__ gbar, const T* __restrict__ cg_res,
        const float* __restrict__ wy, const float* __restrict__ fx,
        const float* __restrict__ fz, T* __restrict__ mfac, float* __restrict__ d_wy,
        float* __restrict__ d_fx, float* __restrict__ d_fz, long long s, int l, int L) {
    constexpr int MP = Factor<T, FL>::MP;
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
            if constexpr (PACK) {
                const float m4[4] = {m[0], m[1], m[2], m[3]};
                be_pack4(m4, reinterpret_cast<typename Row4<T>::type*>(mfac)[j]);
            } else {
                be_store<T, MP>(mfac + j * MP, m);
            }
        }
    }
    d_fx[s * L + l] = dfx;
    d_fz[s * L + l] = dfz;
}

// one warp per sample, a lane per level; without a code and at one feature
// (quad rows of 4 elements) one thread per (sample, level) instead, all
// lanes busy, and the factors packed (the column path's first pass reads
// them)
template <typename T, int FL, bool CODE>
__global__ void __launch_bounds__(256)
be_sample_kernel(const float* __restrict__ gbar, const T* __restrict__ cg_res,
                 const T* __restrict__ bh_res, const float* __restrict__ code,
                 const float* __restrict__ wy, const float* __restrict__ fx,
                 const float* __restrict__ fz, T* __restrict__ mfac, T* __restrict__ coder,
                 float* __restrict__ d_code, float* __restrict__ d_wy,
                 float* __restrict__ d_fx, float* __restrict__ d_fz,
                 long long n, int L, int H, int HP) {
    if constexpr (FL == 1 && !CODE) {
        const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
        if (i >= n * L) return;
        const long long s = i / L;
        be_sample_level<T, FL, true>(gbar, cg_res, wy, fx, fz, mfac, d_wy, d_fx, d_fz, s,
                                     (int)(i - s * L), L);
        return;
    }
    const long long s = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x & 31;
    if (s >= n) return;
    for (int l = lane; l < L; l += 32)
        be_sample_level<T, FL>(gbar, cg_res, wy, fx, fz, mfac, d_wy, d_fx, d_fz, s, l, L);
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
// lanes (R = 4W/P, any count: no shuffles), each lane P = 8 elements of the
// row. The block's chunks are staged first: keys, factor vectors, code rows.
// ALIGNED: W a multiple of 8 (a lane's elements lie in one quarter).
template <typename T, int FL, bool CODE, bool ALIGNED>
__global__ void __launch_bounds__(256)
be_chunk_kernel(const int* __restrict__ skey, const long long* __restrict__ perm,
                long long total, const T* __restrict__ mfac, const T* __restrict__ coder,
                T* __restrict__ d_table, float* __restrict__ partial,
                int L, int W, int R, int CPB, int HP) {
    constexpr int MP = Factor<T, FL>::MP;
    constexpr int PER = 16 / (int)sizeof(T);
    constexpr int P = BE_P;
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
            float4* dst = reinterpret_cast<float4*>(
                partial + ((lo / BE_CHUNK) * 2 + slot) * W4 + k0);
#pragma unroll
            for (int k = 0; k < P / 4; ++k)
                dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
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
    constexpr int V = P / 4;  // float4 pieces of a lane's elements
    float acc[P];
    {
        const float4* src = reinterpret_cast<const float4*>(
            partial + (c0 * 2 + (covers_lo ? 0 : 1)) * W4 + t * P);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const float4 a = src[k];
            acc[4 * k] = a.x; acc[4 * k + 1] = a.y; acc[4 * k + 2] = a.z; acc[4 * k + 3] = a.w;
        }
    }
    bool going = true;
    for (long long c = c0 + 1; going && c < n_chunks; c += UNROLL) {
        int keys[UNROLL];
        float4 v[UNROLL][V];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            keys[k] = -1;
            if (c + k < n_chunks) {
                keys[k] = skey[(c + k) * BE_CHUNK];
                const float4* src = reinterpret_cast<const float4*>(
                    partial + (c + k) * 2 * W4 + t * P);
#pragma unroll
                for (int x = 0; x < V; ++x) v[k][x] = src[x];
            }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            going = going && keys[k] == key;
            if (going) {
#pragma unroll
                for (int x = 0; x < V; ++x) {
                    acc[4 * x] = __fadd_rn(acc[4 * x], v[k][x].x);
                    acc[4 * x + 1] = __fadd_rn(acc[4 * x + 1], v[k][x].y);
                    acc[4 * x + 2] = __fadd_rn(acc[4 * x + 2], v[k][x].z);
                    acc[4 * x + 3] = __fadd_rn(acc[4 * x + 3], v[k][x].w);
                }
            }
        }
    }
    be_store<T, P>(d_table + (long long)key * W4 + t * P, acc);
}

// ---------------------------------------------------------------------------
// A3-bwd on quad rows of 4 elements (W = 1, one feature, no code): the table
// gradient as a keyed reduction without a library sort. Its order is the one
// above: positions sorted stably by key, pieces of each run cut at the global
// BE_CHUNK boundaries of that order, each piece summed left to right in f32
// from zero, the pieces of a run added in order, rounded once. A stable
// least-significant-digit counting sort produces that order itself, one pass
// per 8 bits of the key (three below 2^24 rows), on (key, rounded factor)
// records; be_sample_kernel writes the factors round((gbar * u_q) * wy) with
// the per-sample gradients:
//  * be_col_count_kernel: per block of BE_COL_BLOCK positions, the count of
//    each digit (integer shared-memory atomics: the same counts in any order);
//  * be_col_colscan_kernel: per digit, the exclusive prefix of the counts over
//    blocks, in place, and the digit's total;
//  * be_col_scatter_kernel: per block, each digit's start (a scan of the
//    totals) plus the block's prefix; each warp counts its positions' digits
//    and ranks equal digits 32 at a time with one ballot per digit bit (a
//    position's slot depends on the keys alone); the block places its records
//    in digit order in shared memory and writes each digit's records out as
//    one run of consecutive slots. Every kernel issues its global loads
//    together before it uses them;
//  * be_col_starts_kernel: each 2048-row block's first sorted position;
//  * be_col_reduce_kernel, one block per 2048 table rows: stages its sorted
//    positions in tiles of whole chunks in shared memory (the next tile's
//    loads issued before the current one is summed), lists the tile's pieces
//    (a ballot per 32 positions), sums each piece with one thread, folds the
//    runs that cross chunks from the chunks' partials in order (a run that
//    goes on past a tile carried into the next), and writes all of its rows
//    from shared memory, zeros where no key reaches: no memset.
// No float atomics, no host read-back; the keys, factors and counts live in
// the wrapper's scratch (blended_encode_bwd_column_scratch).

#define BE_COL_WARPS 8
#define BE_COL_THREADS (BE_COL_WARPS * 32)
#define BE_COL_PER 16                                  // positions per thread of a pass block
#define BE_COL_SEG (32 * BE_COL_PER)                   // positions per warp of a pass block
#define BE_COL_BLOCK (BE_COL_WARPS * BE_COL_SEG)       // positions per pass block
#define BE_COL_DIGIT_BITS 8
#define BE_COL_DIGITS (1 << BE_COL_DIGIT_BITS)
#define BE_COL_ROWS 2048                               // table rows per reduce block
#define BE_COL_MAX_PASSES 4
#define BE_COL_BATCH 16                                // global loads a thread issues together
#define BE_FULL 0xffffffffu
static_assert(BE_COL_THREADS == BE_COL_DIGITS, "a thread per digit");

// a position's key: entry_idx (int64, below 2^31) on the first pass, else the
// previous pass's int32 keys
template <bool FIRST>
__device__ __forceinline__ int be_col_key(const void* keys, long long p) {
    if constexpr (FIRST) return (int)__ldcs(reinterpret_cast<const long long*>(keys) + p);
    else return __ldcs(reinterpret_cast<const int*>(keys) + p);
}

// the lanes whose digit equals this lane's, one ballot per digit bit
// (invalid lanes, dg < 0, among themselves)
__device__ __forceinline__ unsigned be_col_peers(int dg) {
    const unsigned valid = __ballot_sync(BE_FULL, dg >= 0);
    unsigned peers = dg >= 0 ? valid : ~valid;
#pragma unroll
    for (int b = 0; b < BE_COL_DIGIT_BITS; ++b) {
        const bool on = (dg >> b) & 1;
        const unsigned set = __ballot_sync(BE_FULL, on);
        peers &= on ? set : ~set;
    }
    return peers;
}

// the exclusive prefix over the block of v (one value per thread, in thread
// order); all threads call it
__device__ __forceinline__ int be_col_scan(int v, int* warp_sum) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(BE_FULL, incl, o);
        if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[w] = incl;
    __syncthreads();
    int run = incl - v;
    for (int k = 0; k < w; ++k) run += warp_sum[k];
    __syncthreads();
    return run;
}

template <bool FIRST>
__global__ void __launch_bounds__(BE_COL_THREADS)
be_col_count_kernel(const void* __restrict__ keys, long long total, int lo, int mask, int D,
                    int* __restrict__ cnt) {
    __shared__ int hist[BE_COL_DIGITS];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const long long s0 = (long long)blockIdx.x * BE_COL_BLOCK + w * BE_COL_SEG + lane;
    int key[BE_COL_PER];  // every load issued before the first is used
#pragma unroll
    for (int k = 0; k < BE_COL_PER; ++k)
        key[k] = s0 + k * 32 < total ? be_col_key<FIRST>(keys, s0 + k * 32) : -1;
    hist[tid] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BE_COL_PER; ++k) {
        const int dg = key[k] >= 0 ? (key[k] >> lo) & mask : -1;
        const unsigned peers = be_col_peers(dg);
        if (dg >= 0 && lane == __ffs(peers) - 1) atomicAdd(hist + dg, __popc(peers));
    }
    __syncthreads();
    if (tid < D) cnt[(long long)blockIdx.x * D + tid] = hist[tid];
}

// a block per digit: the exclusive prefix of its counts over the G blocks, in
// place, and its total; each warp takes a slice of the blocks
__global__ void __launch_bounds__(BE_COL_THREADS)
be_col_colscan_kernel(int* __restrict__ cnt, int* __restrict__ dtotal, int G, int D) {
    __shared__ int slice_sum[BE_COL_WARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, d = blockIdx.x;
    const int per = (G + BE_COL_WARPS * 32 - 1) / (BE_COL_WARPS * 32) * 32;
    const int g0 = w * per, g1 = min(G, g0 + per);
    int sum = 0;
    for (int g = g0; g < g1; g += 32 * BE_COL_BATCH) {
        int v[BE_COL_BATCH];
#pragma unroll
        for (int k = 0; k < BE_COL_BATCH; ++k) {
            const int gg = g + k * 32 + lane;
            v[k] = gg < g1 ? cnt[(long long)gg * D + d] : 0;
        }
#pragma unroll
        for (int k = 0; k < BE_COL_BATCH; ++k) sum += v[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(BE_FULL, sum, o);
    if (lane == 0) slice_sum[w] = sum;
    __syncthreads();
    int carry = 0;
    for (int k = 0; k < w; ++k) carry += slice_sum[k];
    for (int g = g0; g < g1; g += 32 * BE_COL_BATCH) {
        int v[BE_COL_BATCH];
#pragma unroll
        for (int k = 0; k < BE_COL_BATCH; ++k) {
            const int gg = g + k * 32 + lane;
            v[k] = gg < g1 ? cnt[(long long)gg * D + d] : 0;
        }
#pragma unroll
        for (int k = 0; k < BE_COL_BATCH; ++k) {
            int incl = v[k];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(BE_FULL, incl, o);
                if (lane >= o) incl += u;
            }
            const int gg = g + k * 32 + lane;
            if (gg < g1) cnt[(long long)gg * D + d] = carry + incl - v[k];
            carry += __shfl_sync(BE_FULL, incl, 31);
        }
    }
    if (w == BE_COL_WARPS - 1 && lane == 0) dtotal[d] = carry;
}

// one pass's layout (the host's be_col_plan)
struct ColPass {
    const void* keys_in;           // FIRST: entry_idx [T] int64, else [T] int32
    const void* fac_in;            // [T]: the factors (FIRST: be_sample_kernel's, in
                                   // position order; else the previous pass's)
    int* keys_out;
    void* fac_out;
    const int* cnt;                // [G, D]: exclusive prefixes over blocks
    const int* dtotal;             // [D]
    long long total;               // T = n * 2L positions
    int lo, mask, D;
};

#define BE_COL_AHEAD 8  // steps of a warp whose payload loads are in flight together

// A block's BE_COL_BLOCK positions: each warp counts its positions' digits,
// the block places every record at its digit's slot in shared memory (the
// count of equal digits before it), then writes each digit's records out as
// one run of consecutive slots
template <typename T, bool FIRST>
__global__ void __launch_bounds__(BE_COL_THREADS)
be_col_scatter_kernel(const __grid_constant__ ColPass a) {
    typedef typename Row4<T>::type Fac;
    extern __shared__ __align__(16) unsigned char be_sm[];
    Fac* sfac = reinterpret_cast<Fac*>(be_sm);                  // [BE_COL_BLOCK] in digit order
    int* skey = reinterpret_cast<int*>(sfac + BE_COL_BLOCK);    // [BE_COL_BLOCK]
    __shared__ int wcnt[BE_COL_WARPS][BE_COL_DIGITS];           // per warp and digit
    __shared__ int loc[BE_COL_DIGITS], gbase[BE_COL_DIGITS], warp_sum[BE_COL_WARPS];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const unsigned lower = (1u << lane) - 1u;
    const long long g = blockIdx.x, s0 = g * BE_COL_BLOCK + w * BE_COL_SEG + lane;
    const int D = a.D;
    int key[BE_COL_PER];  // the warp's positions s0 + 32 k: every load issued together
#pragma unroll
    for (int k = 0; k < BE_COL_PER; ++k)
        key[k] = s0 + k * 32 < a.total ? be_col_key<FIRST>(a.keys_in, s0 + k * 32) : -1;
    const int tot = tid < D ? a.dtotal[tid] : 0;
    const int pre = tid < D ? a.cnt[g * D + tid] : 0;
#pragma unroll
    for (int k = 0; k < BE_COL_WARPS; ++k) wcnt[k][tid] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BE_COL_PER; ++k) {
        const int dg = key[k] >= 0 ? (key[k] >> a.lo) & a.mask : -1;
        const unsigned peers = be_col_peers(dg);
        if (dg >= 0 && lane == __ffs(peers) - 1) wcnt[w][dg] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // digit tid: its records' local start (the block's digits before it), each
    // warp's start, and its global slot (the digit's start + earlier blocks)
    {
        int here = 0;
#pragma unroll
        for (int k = 0; k < BE_COL_WARPS; ++k) here += wcnt[k][tid];
        const int start = be_col_scan(tot, warp_sum);
        const int local = be_col_scan(here, warp_sum);
        loc[tid] = local;
        gbase[tid] = start + pre;
        int run = local;
#pragma unroll
        for (int k = 0; k < BE_COL_WARPS; ++k) {
            const int v = wcnt[k][tid];
            wcnt[k][tid] = run;
            run += v;
        }
    }
    __syncthreads();
    // each warp's positions in order, to their local slots; the factors of
    // BE_COL_AHEAD steps loaded before the first of them is placed
#pragma unroll
    for (int k0 = 0; k0 < BE_COL_PER; k0 += BE_COL_AHEAD) {
        Fac f[BE_COL_AHEAD];
#pragma unroll
        for (int k = 0; k < BE_COL_AHEAD; ++k)
            if (key[k0 + k] >= 0)
                f[k] = __ldcs(reinterpret_cast<const Fac*>(a.fac_in) + s0 + (k0 + k) * 32);
#pragma unroll
        for (int k = 0; k < BE_COL_AHEAD; ++k) {
            const int kk = key[k0 + k];
            const int dg = kk >= 0 ? (kk >> a.lo) & a.mask : -1;
            const unsigned peers = be_col_peers(dg);
            int at = 0;
            if (dg >= 0) at = wcnt[w][dg] + __popc(peers & lower);
            __syncwarp();
            if (dg >= 0 && lane == __ffs(peers) - 1) wcnt[w][dg] += __popc(peers);
            __syncwarp();
            if (dg < 0) continue;
            skey[at] = kk;
            sfac[at] = f[k];
        }
    }
    __syncthreads();
    // out in local order: a digit's records to consecutive global slots
    const long long here = a.total - g * BE_COL_BLOCK;
    Fac* fac_out = reinterpret_cast<Fac*>(a.fac_out);
#pragma unroll
    for (int k = 0; k < BE_COL_PER; ++k) {
        const int j = k * BE_COL_THREADS + tid;
        if (j >= here) break;
        const int kk = skey[j], dg = (kk >> a.lo) & a.mask;
        const int dst = gbase[dg] + j - loc[dg];
        a.keys_out[dst] = kk;
        fac_out[dst] = sfac[j];
    }
}

// the first sorted position of each BE_COL_ROWS-row block of the table,
// bstart[nb] = T: a thread per sorted position marks the blocks whose rows
// start at it
__global__ void __launch_bounds__(BE_COL_THREADS)
be_col_starts_kernel(const int* __restrict__ skey, long long total, int nb,
                     int* __restrict__ bstart) {
    const long long i = (long long)blockIdx.x * BE_COL_THREADS + threadIdx.x;
    if (i > total) return;
    const int prev = i > 0 ? skey[i - 1] / BE_COL_ROWS : -1;
    const int here = i < total ? skey[i] / BE_COL_ROWS : nb;
    for (int b = prev + 1; b <= here; ++b) bstart[b] = (int)i;
}

// a reduce block's shared memory: its rows (rounded), then a tile of sorted
// positions (whole chunks): their factors, the chunks' partials, their keys
// and the key after the tile, the tile's piece heads (48 KB of keys and
// factors)
template <typename T> struct ColTile {
    typedef typename Row4<T>::type Fac;
    static constexpr int N = sizeof(T) == 2 ? 4096 : 2048;
    static constexpr int CHUNKS = N / BE_CHUNK;
    static constexpr int O_FAC = BE_COL_ROWS * (int)sizeof(Fac);
    static constexpr int O_PART = O_FAC + N * (int)sizeof(Fac);
    static constexpr int O_KEY = O_PART + CHUNKS * 2 * 16;
    static constexpr int O_HEAD = O_KEY + (N + 4) * 4;
    static constexpr int SMEM = O_HEAD + (N + 2) * 2;
};

// one block per BE_COL_ROWS table rows r0.. of the table gradient, from the
// sorted keys and factors of the last pass. The block's sorted positions are
// staged in tiles of whole chunks; a thread per chunk walks it from shared
// memory; the runs that cross chunks are folded from the chunks' partials
// in order, a run that goes on past the tile carried into the next tile's
// fold. Every row is written from shared memory at the end.
template <typename T>
__global__ void __launch_bounds__(BE_COL_THREADS)
be_col_reduce_kernel(const int* __restrict__ skey, const void* __restrict__ sfac,
                     const int* __restrict__ bstart, T* __restrict__ d_table, long long E) {
    typedef typename Row4<T>::type Fac;
    typedef ColTile<T> Tile;
    constexpr int TILE = Tile::N;
    extern __shared__ __align__(16) unsigned char be_sm[];
    Fac* rowv = reinterpret_cast<Fac*>(be_sm);
    Fac* tfac = reinterpret_cast<Fac*>(be_sm + Tile::O_FAC);
    float4 (*tpart)[2] = reinterpret_cast<float4 (*)[2]>(be_sm + Tile::O_PART);
    int* tkey = reinterpret_cast<int*>(be_sm + Tile::O_KEY);
    unsigned short* head = reinterpret_cast<unsigned short*>(be_sm + Tile::O_HEAD);
    __shared__ float4 carry[2];            // a run's fold carried between tiles
    __shared__ int hcount[TILE / 32], n_heads;  // heads per (step, warp)
    __shared__ int carry_key[2];
    __shared__ int key_prev;               // the key before the tile
    const Fac* fac = reinterpret_cast<const Fac*>(sfac);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const long long r0 = (long long)blockIdx.x * BE_COL_ROWS;
    const int nr = (int)min((long long)BE_COL_ROWS, E - r0);
    const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = tid; r < BE_COL_ROWS; r += BE_COL_THREADS) be_pack4(zero, rowv[r]);
    if (tid == 0) {
        carry_key[0] = -1;
        key_prev = -1;
    }
    const long long lo = bstart[blockIdx.x], hi = bstart[blockIdx.x + 1];
    // the tiles' keys and factors pass through registers: a tile's loads are
    // issued before the previous tile is walked
    constexpr int PT = TILE / BE_COL_THREADS;
    int kk[PT], after = -1;  // after: the key past the tile (thread 0)
    Fac ff[PT];
    auto fetch = [&](long long t0) {
        const long long tlo = t0 > lo ? t0 : lo, thi = t0 + TILE < hi ? t0 + TILE : hi;
#pragma unroll
        for (int k = 0; k < PT; ++k) {
            const long long i = tlo + k * BE_COL_THREADS + tid;
            if (i < thi) {
                kk[k] = skey[i];
                ff[k] = fac[i];
            }
        }
        if (tid == 0) after = thi < hi ? skey[thi] : -1;
    };
    const long long first_tile = lo / BE_CHUNK * BE_CHUNK;
    if (hi > lo) fetch(first_tile);
    __syncthreads();
    int t = 0;
    for (long long t0 = first_tile; t0 < hi; t0 += TILE, ++t) {
        const long long tlo = t0 > lo ? t0 : lo, thi = t0 + TILE < hi ? t0 + TILE : hi;
#pragma unroll
        for (int k = 0; k < PT; ++k) {
            const long long i = tlo + k * BE_COL_THREADS + tid;
            if (i < thi) {
                tkey[i - t0] = kk[k];
                tfac[i - t0] = ff[k];
            }
        }
        if (tid == 0) {
            tkey[thi - t0] = after;
            carry_key[(t + 1) & 1] = -1;
        }
        if (t0 + TILE < hi) fetch(t0 + TILE);
        __syncthreads();
        const int nch = (int)((thi - t0 + BE_CHUNK - 1) / BE_CHUNK);
        const int llo = (int)(tlo - t0), lhi = (int)(thi - t0);  // the tile's positions
        // the pieces: a position starts one where its key differs from the one
        // before it, or where it starts a chunk. Step k of warp w flags the
        // positions k * 256 + w * 32 + lane (one ballot), a scan of the
        // (step, warp) counts lists the heads in position order
        {
            unsigned ball[PT];
#pragma unroll
            for (int k = 0; k < PT; ++k) {
                const int i = k * BE_COL_THREADS + tid;
                bool flag = false;
                if (i >= llo && i < lhi) {
                    const int before = i > llo ? tkey[i - 1] : (tlo > lo ? key_prev : -1);
                    flag = i % BE_CHUNK == 0 || tkey[i] != before;
                }
                ball[k] = __ballot_sync(BE_FULL, flag);
                if (lane == 0) hcount[k * BE_COL_WARPS + w] = __popc(ball[k]);
            }
            __syncthreads();
            if (w == 0) {  // the (step, warp) counts' exclusive prefix, 4 per lane
                constexpr int PER_LANE = PT * BE_COL_WARPS / 32;
                int v[PER_LANE], sum = 0;
#pragma unroll
                for (int k = 0; k < PER_LANE; ++k) {
                    v[k] = hcount[lane * PER_LANE + k];
                    sum += v[k];
                }
                int incl = sum;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int u = __shfl_up_sync(BE_FULL, incl, o);
                    if (lane >= o) incl += u;
                }
                int run = incl - sum;
#pragma unroll
                for (int k = 0; k < PER_LANE; ++k) {
                    hcount[lane * PER_LANE + k] = run;
                    run += v[k];
                }
                if (lane == 31) {
                    n_heads = run;
                    head[run] = (unsigned short)lhi;
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < PT; ++k)
                if ((ball[k] >> lane) & 1)
                    head[hcount[k * BE_COL_WARPS + w] + __popc(ball[k] & ((1u << lane) - 1u))] =
                        (unsigned short)(k * BE_COL_THREADS + tid);
        }
        __syncthreads();
        // each piece summed left to right from zero: a whole run to rowv, the
        // others to tpart (slot 0: the piece that starts at its chunk's first
        // position, 1: the one that goes on past its chunk's end)
        for (int k = tid; k < n_heads; k += BE_COL_THREADS) {
            const int a = head[k], b = head[k + 1], key = tkey[a];
            const bool starts = a > llo ? tkey[a - 1] != key : (tlo > lo ? key_prev : -1) != key;
            const bool ends = b + t0 < hi ? tkey[b] != key : true;
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int i0 = a; i0 < b; i0 += 8) {
                Fac ff8[8];
#pragma unroll
                for (int k8 = 0; k8 < 8; ++k8)
                    if (i0 + k8 < b) ff8[k8] = tfac[i0 + k8];
#pragma unroll
                for (int k8 = 0; k8 < 8; ++k8) {
                    if (i0 + k8 >= b) break;
                    float v[4];
                    be_row4(ff8[k8], v);
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[q] = __fadd_rn(acc[q], v[q]);
                }
            }
            if (starts && ends)
                be_pack4(acc, rowv[key - r0]);
            else
                tpart[a / BE_CHUNK][a % BE_CHUNK == 0 ? 0 : 1] =
                    make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
        __syncthreads();
        // the runs that cross chunks: each fold starts in the chunk where its
        // run starts (or, for a run carried in, at the tile's first chunk)
        // and adds slot 0 of each next chunk the run reaches
        for (int lc = tid; lc < nch; lc += BE_COL_THREADS) {
            const long long c0 = t0 + (long long)lc * BE_CHUNK;
            const int chi = (int)((c0 + BE_CHUNK < hi ? c0 + BE_CHUNK : hi) - t0);
            auto fold = [&](float4 acc, int key) {
                int cc = lc + 1;
                bool going = true;
                while (going && cc < nch) {  // 8 chunks' keys and partials read together
                    int ck[8];
                    float4 cp[8];
#pragma unroll
                    for (int k = 0; k < 8; ++k) {
                        ck[k] = cc + k < nch ? tkey[(cc + k) * BE_CHUNK] : -1;
                        cp[k] = tpart[cc + k < nch ? cc + k : cc][0];
                    }
#pragma unroll
                    for (int k = 0; k < 8; ++k) {
                        going = going && ck[k] == key;
                        if (going) {
                            acc = make_float4(__fadd_rn(acc.x, cp[k].x), __fadd_rn(acc.y, cp[k].y),
                                              __fadd_rn(acc.z, cp[k].z), __fadd_rn(acc.w, cp[k].w));
                            ++cc;
                        }
                    }
                }
                if (cc == nch && tkey[thi - t0] == key) {  // goes on into the next tile
                    carry[(t + 1) & 1] = acc;
                    carry_key[(t + 1) & 1] = key;
                } else {
                    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
                    be_pack4(v, rowv[key - r0]);
                }
            };
            const int ck = carry_key[t & 1];
            if (lc == 0 && ck >= 0) {
                const float4 c = carry[t & 1], p = tpart[0][0];
                fold(make_float4(__fadd_rn(c.x, p.x), __fadd_rn(c.y, p.y), __fadd_rn(c.z, p.z),
                                 __fadd_rn(c.w, p.w)), ck);
            }
            const int key = tkey[chi - 1];
            if (chi + t0 >= hi || tkey[chi] != key) continue;  // the last run ends here
            const bool covers = c0 >= lo && tkey[c0 - t0] == key;
            const int before = c0 > tlo ? tkey[c0 - t0 - 1] : key_prev;
            if (covers && c0 > lo && before == key) continue;  // begun in an earlier chunk
            fold(tpart[lc][covers ? 0 : 1], key);
        }
        const int last = tid == 0 ? tkey[thi - 1 - t0] : 0;
        __syncthreads();
        if (tid == 0) key_prev = last;
    }
    __syncthreads();
    Fac* out = reinterpret_cast<Fac*>(d_table) + r0;
    for (int r = tid; r < nr; r += BE_COL_THREADS) __stcs(out + r, rowv[r]);
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
// (W = FL), also of one feature (rows of 4 elements)
static bool be_valid(long long W, long long FL, long long H, bool has_code,
                     long long elem_bytes) {
    if (be_log2(FL) < 0 || FL > BE_P || H < 1 || H * FL != W
        || ((4 * W) % BE_P && (has_code || W != 1)) || 4 * W > 128 * BE_P
        || (!has_code && H != 1))
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
    if (W == 1) {  // rows of 4 elements: no bulk copy takes them
        const int items = (int)(n * L);
        const unsigned grid = (unsigned)((items + 255) / 256);
        const BeDiv per_level = be_div((unsigned)L);
        cudaStream_t st = (cudaStream_t)stream;
        if (elem_bytes == 2)
            be_fwd_narrow_kernel<bf16><<<grid, 256, 0, st>>>(
                (const bf16*)table, (const long long*)entry_idx, (const float*)wy,
                (const float*)fx, (const float*)fz, (float*)out, (bf16*)cg, items, (int)L,
                per_level);
        else
            be_fwd_narrow_kernel<float><<<grid, 256, 0, st>>>(
                (const float*)table, (const long long*)entry_idx, (const float*)wy,
                (const float*)fx, (const float*)fz, (float*)out, (float*)cg, items, (int)L,
                per_level);
        return (int)cudaGetLastError();
    }
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
    const long long threads = FL == 1 && !CODE ? n * L : n * 32;  // be_sample_kernel's mapping
    const unsigned grid = (unsigned)((threads + 255) / 256);
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
// zeroed before this runs: every row some position reaches is written. Rows
// of 4 elements take blended_encode_bwd_column instead.
extern "C" int blended_encode_bwd_chunks(const void* skey, const void* perm,
                                         const void* mfac, const void* coder,
                                         void* d_table, void* partial, long long n,
                                         long long L, long long H, long long W,
                                         long long FL, long long elem_bytes, void* stream) {
    const bool has_code = coder != nullptr;
    if (!be_valid(W, FL, H, has_code, elem_bytes) || W == 1 || n < 0 || L < 1
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
    const int* k = (const int*)skey;
    const float* part = (const float*)partial;
    if (elem_bytes == 2)
        be_span_kernel<bf16><<<grid, 256, 0, st>>>(k, total, part, (bf16*)d_table, W4, R);
    else
        be_span_kernel<float><<<grid, 256, 0, st>>>(k, total, part, (float*)d_table, W4, R);
    return (int)cudaGetLastError();
}

// the table gradient's zeros (rows no sample reached), on the stream given
extern "C" int blended_encode_zero(void* d_table, long long bytes, void* stream) {
    if (bytes < 0) return (int)cudaErrorInvalidValue;
    return (int)cudaMemsetAsync(d_table, 0, (size_t)bytes, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// A3-bwd on quad rows of 4 elements: host side

// the passes of the keyed reduction and its scratch (byte offsets)
struct ColPlan {
    int passes, lo[BE_COL_MAX_PASSES], mask[BE_COL_MAX_PASSES], D[BE_COL_MAX_PASSES];
    long long T, G;
    long long o_cnt, o_tot, o_start, o_keys[2], o_fac[2], bytes;
    int nb;  // reduce blocks of BE_COL_ROWS rows
};

static long long be_col_align(long long v) { return (v + 255) / 256 * 256; }

// digits of 8 bits, the last of what is left, over the bits of E - 1; a
// digit's count is cut to the values keys below E take
static void be_col_plan(ColPlan& c, long long T, long long E, int es) {
    int bits = 1;
    while ((1LL << bits) < E) ++bits;
    c.passes = 0;
    for (int at = 0; at < bits;) {
        const int width = bits - at < BE_COL_DIGIT_BITS ? bits - at : BE_COL_DIGIT_BITS;
        const long long values = ((E - 1) >> at) + 1;
        c.lo[c.passes] = at;
        c.mask[c.passes] = (1 << width) - 1;
        c.D[c.passes] = (int)(values < (1LL << width) ? values : (1LL << width));
        at += width;
        ++c.passes;
    }
    c.T = T;
    c.G = (T + BE_COL_BLOCK - 1) / BE_COL_BLOCK;
    long long at = 0;
    c.o_cnt = at;
    at += be_col_align(c.G * BE_COL_DIGITS * 4);
    c.o_tot = at;
    at += be_col_align(BE_COL_DIGITS * 4);
    c.nb = (int)((E + BE_COL_ROWS - 1) / BE_COL_ROWS);
    c.o_start = at;
    at += be_col_align((long long)(c.nb + 1) * 4);
    for (int k = 0; k < 2; ++k) {
        c.o_keys[k] = at;
        at += be_col_align(T * 4);
    }
    for (int k = 0; k < 2; ++k) {
        c.o_fac[k] = at;
        at += be_col_align(T * 4 * es);
    }
    c.bytes = at;
}

// the scatter's records in digit order: keys and factors
template <typename T> static size_t be_col_scatter_smem() {
    return (size_t)BE_COL_BLOCK * (4 + sizeof(typename Row4<T>::type));
}

template <typename T, bool FIRST>
static int be_col_scatter(const ColPass& a, long long G, cudaStream_t st) {
    // the shared-memory attribute, once per device
    static int set_device = -1;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device != set_device) {
        err = cudaFuncSetAttribute(be_col_scatter_kernel<T, FIRST>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)be_col_scatter_smem<T>());
        if (err == cudaSuccess) set_device = device;
    }
    if (err != cudaSuccess) return (int)err;
    be_col_scatter_kernel<T, FIRST><<<(unsigned)G, BE_COL_THREADS, be_col_scatter_smem<T>(), st>>>(a);
    return (int)cudaGetLastError();
}

// the column's per-sample inputs and outputs
struct ColIO {
    const void* entry_idx;
    const float *gbar, *wy, *fx, *fz;
    const void* cg;
    float *d_wy, *d_fx, *d_fz;
    void* d_table;
    long long n, E;
    int L;
};

// pass k reads keys and factors from set (k + 1) % 2 (pass 0: entry_idx and
// be_sample_kernel's factors, which go to set 1) and writes set k % 2
template <typename T>
static int be_col_run(const ColPlan& c, unsigned char* scratch, const ColIO& io,
                      long long parts, cudaStream_t st) {
    int* cnt = reinterpret_cast<int*>(scratch + c.o_cnt);
    int* tot = reinterpret_cast<int*>(scratch + c.o_tot);
    int* start = reinterpret_cast<int*>(scratch + c.o_start);
    if (parts & 4) {
        be_sample_kernel<T, 1, false><<<(unsigned)((io.n * io.L + 255) / 256), 256, 0, st>>>(
            io.gbar, (const T*)io.cg, nullptr, nullptr, io.wy, io.fx, io.fz,
            (T*)(scratch + c.o_fac[1]), nullptr, nullptr, io.d_wy, io.d_fx, io.d_fz, io.n,
            io.L, 1, 0);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    if (parts & 1) {
        for (int k = 0; k < c.passes; ++k) {
            const bool first = k == 0;
            const void* keys_in = first ? io.entry_idx : scratch + c.o_keys[(k + 1) % 2];
            if (first)
                be_col_count_kernel<true><<<(unsigned)c.G, BE_COL_THREADS, 0, st>>>(
                    keys_in, c.T, c.lo[k], c.mask[k], c.D[k], cnt);
            else
                be_col_count_kernel<false><<<(unsigned)c.G, BE_COL_THREADS, 0, st>>>(
                    keys_in, c.T, c.lo[k], c.mask[k], c.D[k], cnt);
            be_col_colscan_kernel<<<(unsigned)c.D[k], BE_COL_THREADS, 0, st>>>(
                cnt, tot, (int)c.G, c.D[k]);
            const ColPass a{keys_in, scratch + c.o_fac[(k + 1) % 2],
                            reinterpret_cast<int*>(scratch + c.o_keys[k % 2]),
                            scratch + c.o_fac[k % 2], cnt, tot, c.T, c.lo[k], c.mask[k],
                            c.D[k]};
            const int err = first ? be_col_scatter<T, true>(a, c.G, st)
                                  : be_col_scatter<T, false>(a, c.G, st);
            if (err != 0) return err;
        }
    }
    if (parts & 2) {
        static int set_device = -1;  // the shared-memory attribute, once per device
        int device = 0;
        cudaError_t err = cudaGetDevice(&device);
        if (err == cudaSuccess && device != set_device) {
            err = cudaFuncSetAttribute(be_col_reduce_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ColTile<T>::SMEM);
            if (err == cudaSuccess) set_device = device;
        }
        if (err != cudaSuccess) return (int)err;
        const int last = (c.passes - 1) % 2;
        const int* skey = reinterpret_cast<const int*>(scratch + c.o_keys[last]);
        be_col_starts_kernel<<<(unsigned)(c.T / BE_COL_THREADS + 1), BE_COL_THREADS, 0, st>>>(
            skey, c.T, c.nb, start);
        be_col_reduce_kernel<T><<<(unsigned)c.nb, BE_COL_THREADS, ColTile<T>::SMEM, st>>>(
            skey, scratch + c.o_fac[last], start, (T*)io.d_table, io.E);
    }
    return (int)cudaGetLastError();
}

static bool be_col_valid(long long n, long long L, long long E, long long elem_bytes) {
    return n >= 0 && L >= 1 && E >= 1 && E < (1LL << 31) && n * 2 * L < (1LL << 31)
           && (elem_bytes == 2 || elem_bytes == 4);
}

// bytes of scratch blended_encode_bwd_column needs (256-byte aligned), or -1
extern "C" long long blended_encode_bwd_column_scratch(long long n, long long L, long long E,
                                                       long long elem_bytes) {
    if (!be_col_valid(n, L, E, elem_bytes)) return -1;
    ColPlan c;
    be_col_plan(c, n * 2 * L, E, (int)elem_bytes);
    return c.bytes;
}

// A3-bwd on quad rows of 4 elements (one feature, no code): from gbar [n, L],
// the forward's residual cg [n, 2, L, 4], entry_idx [n, 2L] int64, wy [n, 2L],
// fx, fz [n, L] f32, the per-sample gradients d_wy [n, 2L], d_fx, d_fz [n, L]
// f32 and the table gradient [E, 4] (bf16 or f32, 16-byte aligned, every row
// written). parts, a sum of: 4 the per-sample kernel (also the rounded
// factors into the scratch), 1 the passes of the order (keys and factors,
// needs 4), 2 the reduce (needs 1). scratch: blended_encode_bwd_column_scratch
// bytes, 256-byte aligned.
extern "C" int blended_encode_bwd_column(const void* gbar, const void* cg, const void* entry_idx,
                                         const void* wy, const void* fx, const void* fz,
                                         void* d_wy, void* d_fx, void* d_fz, void* d_table,
                                         void* scratch, long long n, long long L, long long E,
                                         long long elem_bytes, long long parts, void* stream) {
    if (!be_col_valid(n, L, E, elem_bytes) || n == 0) return (int)cudaErrorInvalidValue;
    ColPlan c;
    be_col_plan(c, n * 2 * L, E, (int)elem_bytes);
    const ColIO io{entry_idx, (const float*)gbar, (const float*)wy, (const float*)fx,
                   (const float*)fz, cg, (float*)d_wy, (float*)d_fx, (float*)d_fz, d_table, n,
                   E, (int)L};
    cudaStream_t st = (cudaStream_t)stream;
    unsigned char* sc = (unsigned char*)scratch;
    return elem_bytes == 2 ? be_col_run<bf16>(c, sc, io, parts, st)
                           : be_col_run<float>(c, sc, io, parts, st);
}
