// One Adam step over every parameter leaf in one pass (the optimizer).
//
// Replaces no Pallas kernel: the JAX package's Adam
// (nersemble_tpu/engine/optimizers.py::fused_adam_update) is elementwise
// XLA, which fuses the update of a leaf into one loop. The port's plain
// version (ops/fused_adam.py adam_update_plain) runs it as ~17 PyTorch
// passes per leaf, each over the whole leaf with a leaf-sized temporary: on
// the flagship's [6,537,216, 64] f32 table ~21 ms a step, against the one
// pass's bound below. So this kernel was added.
//
// What bounds it on the H100: device memory bandwidth. Each element reads
// p, g, mu and nu once and writes p, mu and nu once: 28 bytes per f32
// element, 11.7 GB over the flagship's 418,381,824 elements, 3.50 ms at
// 3.35 TB/s. The arithmetic (three IEEE divisions and a square root per
// element) does not bound it: the kernel runs at 86% of that bound on an
// H100 80GB HBM3 (PERF.md).
//
// Design: the host cuts every leaf into segments (ops/fused_adam.py
// plan_segments): a scalar head up to the parameter's first 16-byte
// boundary, a vector body of whole float4s on which all four streams are
// aligned, and a scalar tail; a leaf whose streams cannot be aligned
// together (a gradient viewed out of a flat all-reduce buffer, a row shard
// of the 2-feature single grid at an odd row) is one scalar segment. The
// segments of up to ADAM_MAX_SEGS leaves travel in the kernel's parameter
// space (__grid_constant__: read from the constant bank, no host-to-device
// copy, no synchronisation), cut into tiles of ADAM_TILE elements. A
// persistent grid of the resident blocks walks the tiles with a grid
// stride; a thread issues all its loads of a tile (ADAM_UNROLL float4s of
// each of the four streams) before the first store, with streaming cache
// hints (ld.global.cs / st.global.cs): no byte is read twice. A gradient in
// bf16 is read in its own type and widened, as .to(torch.float32) does.
//
// The arithmetic is the plain update's, op for op, with its roundings
// (intrinsics that never contract into an FMA), so the result is the plain
// version's on the card bit for bit:
//   mu = b1 mu + (1 - b1) g
//   nu = b2 nu + (1 - b2) (g g)
//   p  = p - lr ((mu / c1) / (sqrt(nu / c2) + eps))
// with b1, b2, 1 - b1, 1 - b2, eps and lr the floats PyTorch makes of the
// host's doubles, and c1, c2 read from the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ADAM_THREADS 256
#define ADAM_UNROLL 2                                   // float4s per stream per thread
#define ADAM_TILE (ADAM_THREADS * ADAM_UNROLL * 4)      // elements per tile
#define ADAM_MAX_SEGS 64  // ops/fused_adam.py MAX_SEGMENTS: 64 * 56 B of 4 KB

// a segment's kind: the gradient's type in the low bits, ADAM_VECTOR set on
// a body of whole float4s (count a multiple of 4, every stream 16-byte
// aligned, the gradient 4-element aligned)
#define ADAM_G_F32 0
#define ADAM_G_BF16 1
#define ADAM_VECTOR 2

struct AdamSeg {  // ops/fused_adam.py _Segment
    float* p;
    const void* g;
    float* mu;
    float* nu;
    long long count;  // elements
    float lr;
    int kind;
};

struct AdamArgs {
    AdamSeg seg[ADAM_MAX_SEGS];
    long long tile_end[ADAM_MAX_SEGS];  // tiles of segments 0..s
    const float* c1;
    const float* c2;
    float b1, b2, omb1, omb2, eps;
    int n_segs;
};

struct AdamConsts {
    float b1, b2, omb1, omb2, eps, c1, c2, lr;
};

__device__ __forceinline__ void adam1(float& p, float g, float& mu, float& nu,
                                      const AdamConsts& k) {
    mu = __fadd_rn(__fmul_rn(k.b1, mu), __fmul_rn(k.omb1, g));
    nu = __fadd_rn(__fmul_rn(k.b2, nu), __fmul_rn(k.omb2, __fmul_rn(g, g)));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, k.c2)), k.eps);
    p = __fsub_rn(p, __fmul_rn(k.lr, __fdiv_rn(__fdiv_rn(mu, k.c1), denom)));
}

template <int GK>
__device__ __forceinline__ float load_g1(const void* g, long long i) {
    if constexpr (GK == ADAM_G_F32) return __ldcs(reinterpret_cast<const float*>(g) + i);
    else return __bfloat162float(__ldcs(reinterpret_cast<const __nv_bfloat16*>(g) + i));
}

template <int GK>
__device__ __forceinline__ float4 load_g4(const void* g, long long j) {
    if constexpr (GK == ADAM_G_F32) {
        return __ldcs(reinterpret_cast<const float4*>(g) + j);
    } else {
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(g) + 2 * j;
        const float2 lo = __bfloat1622float2(__ldcs(g2));
        const float2 hi = __bfloat1622float2(__ldcs(g2 + 1));
        return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
}

// one tile of a vector segment: elements [start, start + ADAM_TILE) as
// float4s, every load of the thread before its first store
template <int GK>
__device__ __forceinline__ void adam_tile_vec(const AdamSeg& s, long long start,
                                              const AdamConsts& k) {
    float4* __restrict__ P = reinterpret_cast<float4*>(s.p);
    float4* __restrict__ M = reinterpret_cast<float4*>(s.mu);
    float4* __restrict__ V = reinterpret_cast<float4*>(s.nu);
    const long long n4 = s.count >> 2;
    const long long j0 = (start >> 2) + threadIdx.x;
    float4 p[ADAM_UNROLL], g[ADAM_UNROLL], m[ADAM_UNROLL], v[ADAM_UNROLL];
#pragma unroll
    for (int u = 0; u < ADAM_UNROLL; ++u) {
        const long long j = j0 + (long long)u * ADAM_THREADS;
        if (j < n4) {
            p[u] = __ldcs(P + j);
            g[u] = load_g4<GK>(s.g, j);
            m[u] = __ldcs(M + j);
            v[u] = __ldcs(V + j);
        }
    }
#pragma unroll
    for (int u = 0; u < ADAM_UNROLL; ++u) {
        const long long j = j0 + (long long)u * ADAM_THREADS;
        if (j < n4) {
            adam1(p[u].x, g[u].x, m[u].x, v[u].x, k);
            adam1(p[u].y, g[u].y, m[u].y, v[u].y, k);
            adam1(p[u].z, g[u].z, m[u].z, v[u].z, k);
            adam1(p[u].w, g[u].w, m[u].w, v[u].w, k);
            __stcs(P + j, p[u]);
            __stcs(M + j, m[u]);
            __stcs(V + j, v[u]);
        }
    }
}

// one tile of a scalar segment (a head, a tail, or a leaf whose streams
// do not align together): consecutive threads on consecutive elements
template <int GK>
__device__ __forceinline__ void adam_tile_scalar(const AdamSeg& s, long long start,
                                                 const AdamConsts& k) {
    constexpr int PER = ADAM_UNROLL * 4;
    float p[PER], g[PER], m[PER], v[PER];
    const long long i0 = start + threadIdx.x;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const long long i = i0 + (long long)u * ADAM_THREADS;
        if (i < s.count) {
            p[u] = __ldcs(s.p + i);
            g[u] = load_g1<GK>(s.g, i);
            m[u] = __ldcs(s.mu + i);
            v[u] = __ldcs(s.nu + i);
        }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const long long i = i0 + (long long)u * ADAM_THREADS;
        if (i < s.count) {
            adam1(p[u], g[u], m[u], v[u], k);
            __stcs(s.p + i, p[u]);
            __stcs(s.mu + i, m[u]);
            __stcs(s.nu + i, v[u]);
        }
    }
}

__global__ void __launch_bounds__(ADAM_THREADS)
fused_adam_kernel(const __grid_constant__ AdamArgs a) {
    AdamConsts k{a.b1, a.b2, a.omb1, a.omb2, a.eps, __ldg(a.c1), __ldg(a.c2), 0.0f};
    const long long tiles = a.tile_end[a.n_segs - 1];
    int s = 0;
    // a block's tiles ascend, so its segment index only moves forward
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        while (tile >= a.tile_end[s]) ++s;
        const AdamSeg& seg = a.seg[s];
        const long long start = (tile - (s ? a.tile_end[s - 1] : 0)) * ADAM_TILE;
        k.lr = seg.lr;
        switch (seg.kind) {
            case ADAM_G_F32 | ADAM_VECTOR: adam_tile_vec<ADAM_G_F32>(seg, start, k); break;
            case ADAM_G_BF16 | ADAM_VECTOR: adam_tile_vec<ADAM_G_BF16>(seg, start, k); break;
            case ADAM_G_F32: adam_tile_scalar<ADAM_G_F32>(seg, start, k); break;
            default: adam_tile_scalar<ADAM_G_BF16>(seg, start, k); break;
        }
    }
}

// segs: n_segs (1..ADAM_MAX_SEGS) host segments, each count > 0, a vector
// segment's pointers aligned and its count a multiple of 4 (the wrapper
// plans them); c1, c2: device f32 scalars; b1, b2, omb1 = 1 - b1, omb2 =
// 1 - b2 and eps as floats. Launches one kernel on `stream`; returns
// cudaGetLastError().
extern "C" int fused_adam(const AdamSeg* segs, long long n_segs, const void* c1,
                          const void* c2, float b1, float b2, float omb1, float omb2,
                          float eps, void* stream) {
    if (n_segs < 1 || n_segs > ADAM_MAX_SEGS) return (int)cudaErrorInvalidValue;
    AdamArgs a;
    long long tiles = 0;
    for (int s = 0; s < (int)n_segs; ++s) {
        const AdamSeg& seg = segs[s];
        const int gk = seg.kind & ~ADAM_VECTOR;
        const bool vec = (seg.kind & ADAM_VECTOR) != 0;
        if (seg.count < 1 || seg.kind < 0 || gk > ADAM_G_BF16)
            return (int)cudaErrorInvalidValue;
        if (vec && (seg.count % 4 || (uintptr_t)seg.p % 16 || (uintptr_t)seg.mu % 16
                    || (uintptr_t)seg.nu % 16
                    || (uintptr_t)seg.g % (gk == ADAM_G_F32 ? 16 : 8)))
            return (int)cudaErrorInvalidValue;
        a.seg[s] = seg;
        tiles += (seg.count + ADAM_TILE - 1) / ADAM_TILE;
        a.tile_end[s] = tiles;
    }
    a.c1 = (const float*)c1;
    a.c2 = (const float*)c2;
    a.b1 = b1;
    a.b2 = b2;
    a.omb1 = omb1;
    a.omb2 = omb2;
    a.eps = eps;
    a.n_segs = (int)n_segs;
    // the resident blocks, taken again only when the device changes
    static int last_device = -1;
    static long long resident = 1;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device != last_device) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_adam_kernel,
                                                                ADAM_THREADS, 0);
        if (err == cudaSuccess) {
            resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
            last_device = device;
        }
    }
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    fused_adam_kernel<<<grid, ADAM_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
