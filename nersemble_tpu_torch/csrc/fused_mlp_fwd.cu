// Fused MLP forward: the whole layer chain per tile of rows (kernel B1-fwd).
//
// Replaces the Pallas TPU kernel nersemble_tpu/ops/fused_mlp.py::_fwd_kernel
// (launched by _fused_fwd_impl). Rounding points are JAX's: the input is
// rounded to bf16; bf16 x bf16 products accumulate in f32; the f32 bias is
// added; hidden layers apply relu and round to bf16 before the next layer;
// a skip layer takes [h, x_in] (h first); the last layer's activation
// (none / relu / sigmoid) is applied in f32 and the output is f32.
//
// What bounds it on the H100. Per row the stem reads 692 B of x and writes
// 512 B, and does 252 kFLOP: 0.035 ms of bytes and 0.025 ms of bf16
// tensor-core work at 98,304 rows, so bytes bound it with the FLOPs close
// behind. The base (32 -> 64 -> 16) and the head (18 -> 64 -> 64 -> 3) do
// 6-13 kFLOP per row against 192 B and 84 B: bytes alone bound them.
// Measured (PERF.md), each 64-row block's chain of dependent layers is what
// limits it: per layer the wgmmas, then their wait, then the epilogue, and
// only two such chains per SM to overlap.
//
// Design: a persistent, warp-specialised grid of one block per SM, three
// warpgroups. Block b walks tiles b, b + grid, ... of 128 rows; each of the
// two consumer warpgroups owns 64 of them (one wgmma M), the producer
// warpgroup's first thread only issues bulk copies that complete on
// mbarriers (setmaxnreg moves its registers to the consumers).
//  - Every layer runs on wgmma.mma_async m64nNk16 (N = the layer width
//    padded to 16, 32, 64 or 128; bf16 in, f32 accumulators in registers).
//    B, the weights, comes from shared memory as [N][64] K-major blocks in
//    the 128-byte swizzle; A from shared memory for layer 0 and for the
//    skip layer's x part, and FROM REGISTERS for hidden activations: after
//    bias, relu and bf16 rounding, the accumulator of one layer is repacked
//    in place as the next layer's A fragments (the two layouts agree per
//    8-column block), so hidden activations never touch shared memory.
//  - The weights are one cyclic stream of prepacked chunks, each one
//    swizzled [N][64] K block (ops/fused_mlp.py fwd_weight_image builds the
//    image on the device once per weight version). Chunks go through a ring
//    of shared-memory stages: the producer refills a stage once both
//    consumers have released it, so the next layer's chunks land while this
//    one computes, and each staged chunk serves both 64-row halves. A
//    weight set that fits the ring (base, head) is loaded once per launch.
//  - x arrives as one 1-D bulk copy of a whole 64-row block (64 * d_in f32,
//    a multiple of 16 bytes) into one of the consumer's staging blocks,
//    x_stages tiles ahead (1 for the stem, whose weight ring takes the rest
//    of shared memory; up to 8 for the base and head, whose x is small);
//    the consumer converts it once to bf16 in the swizzled A layout with
//    zero K padding, then frees the block. The ragged last block, and x not
//    16-byte aligned, are read from device memory instead.
//  - Output: lanes t and t ^ 1 swap halves so each holds 4 neighbouring
//    columns, stored as 16 bytes (rows of out_dim % 4 == 0); else masked
//    scalar stores (the head's 3 columns).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MLP_MAX_LAYERS 8
#define CONSUMERS 2                     // consumer warpgroups
#define THREADS (128 * (CONSUMERS + 1))
#define BR 64                           // rows per consumer block (wgmma M)
#define MAX_STAGES 8
#define MAX_X_STAGES 8                  // x staging blocks per consumer
#define MAX_CHUNKS 64
#define KBLOCK_BYTES (BR * 128)         // one [64 rows][64 K] bf16 A block

struct FwdSpec {
    int n_layers;
    int d_in;
    int kx;           // d_in padded to 16
    int out_dim;
    int out_act;      // 0 none, 1 relu, 2 sigmoid
    int has_bias;
    int n_chunks;     // weight chunks per tile
    int stages;       // ring stages
    int resident;     // every chunk has its own stage: loaded once
    int stage_bytes;
    int x_bulk;       // x is 16-byte aligned: whole blocks by bulk copy
    int x_stages;     // x staging blocks per consumer (copies in flight)
    int off_xa, off_xraw, off_bias, off_bars;  // shared-memory regions
    int N[MLP_MAX_LAYERS];       // wgmma width of layer l (16, 32, 64, 128)
    int KH[MLP_MAX_LAYERS];      // K from the hidden registers (N of l - 1)
    int KX[MLP_MAX_LAYERS];      // K from the x tile
    int n_pack[MLP_MAX_LAYERS];  // bias entries in the packed bias
    int b_off[MLP_MAX_LAYERS];   // of layer l in the packed bias
    int sb_off[MLP_MAX_LAYERS];  // of layer l in shared memory (N wide)
    int chunk0[MLP_MAX_LAYERS];  // first chunk of layer l
    int chunk_off[MAX_CHUNKS];   // byte offset of a chunk in the image
    int chunk_bytes[MAX_CHUNKS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// A phase that never completes (a copy that was never issued) fails the
// launch after ~10^10 cycles (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    const long long start = clock64();
    while (true) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - start > 10000000000LL) __trap();
    }
}

// One thread: `bytes` from global `src` into shared `dst`, completing on
// `bar` (which expects exactly these bytes and this one arrival).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
}

// the consumer warpgroup's own barrier (0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int c) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(c + 1) : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows 128 bytes apart, 8-row groups 1024 bytes apart (SBO); the
// start may step by 32 bytes (one k16 slice) inside a 1024-aligned atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}
// keeps the compiler from moving reads of an accumulator across a wait
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]: ss takes A from shared memory, rs
// from registers (a0..a3 as mma.sync's m16n8k16 A fragment, per warp's 16
// rows); D as N / 8 blocks of 4 floats: (row g, cols 8j + 2t, +1), then
// the same at row g + 8 (g = lane / 4, t = lane % 4).
template <int N> struct Wgmma;

template <> struct Wgmma<16> {
    static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "l"(da), "l"(db), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
    }
};

template <> struct Wgmma<32> {
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
            "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(da), "l"(db), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
            "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
    }
};

template <> struct Wgmma<64> {
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
    }
};

template <> struct Wgmma<128> {
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(da), "l"(db), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
    }
};

// A consumer's place in the weight stream: chunk c of the stream lies in
// stage c % stages (phase c / stages) while streaming; in stage c when
// every chunk has its own (resident, loaded once per launch).
struct Ring {
    unsigned char* base;
    uint64_t* full;
    uint64_t* empty;
    int stages, stage_bytes, resident;
    int k;  // chunks taken so far (streaming)

    // (branch-free, as is all code between a layer's wgmmas: ptxas
    // serializes wgmmas around code that it must treat as divergent)
    __device__ __forceinline__ int take(int chunk) {
        const int stage = resident ? chunk : k % stages;
        const int parity = resident ? 0 : (k / stages) & 1;
        k += !resident;
        mbar_wait(full + stage, parity);
        return stage;
    }
    // every thread of both consumers arrives once: then the producer
    // refills the stage (nothing when resident or stage < 0)
    __device__ __forceinline__ void release(int stage) {
        const uint32_t on = !resident && stage >= 0;
        asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
                     " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
                     :: "r"(smem_u32(empty + (stage < 0 ? 0 : stage))), "r"(on) : "memory");
    }
};

// One layer of one consumer's 64 rows: acc = [h (registers af), x tile (xa)]
// W^T, then bias and relu into af (bf16) or, for the last layer, the
// output activation and the stores.
template <int N, int KH>
__device__ __forceinline__ void run_layer(const FwdSpec& s, int l, bool last,
                                          Ring& ring, uint32_t (&af)[32],
                                          uint32_t xa, const float* bias_s,
                                          float* __restrict__ out, long long row0,
                                          int rows_here, int wq, int lane) {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    fence_regs(af);
    wgmma_fence();  // af and acc were written by ordinary instructions
    constexpr int kh16 = KH / 16;
    const int nk = kh16 + (s.KX[l] >> 4);
    int chunk = s.chunk0[l], stage = -1, prev = -1;
    uint32_t b_base = 0;
    // a chunk's wgmmas are one group; once the next group is committed,
    // waiting down to one pending group frees the chunk before it
    auto next_chunk = [&](bool first) {
        if (!first) {
            wgmma_commit();
            wgmma_wait<1>();
            ring.release(prev);
            prev = stage;
        }
        stage = ring.take(chunk++);
        b_base = smem_u32(ring.base + stage * ring.stage_bytes);
    };
    // hidden part, A from registers (fragment indices known at compile time)
#pragma unroll
    for (int ks = 0; ks < kh16; ++ks) {
        if ((ks & 3) == 0) next_chunk(ks == 0);
        Wgmma<N>::rs(acc, af[4 * ks], af[4 * ks + 1], af[4 * ks + 2], af[4 * ks + 3],
                     sw128_desc(b_base + 32 * (ks & 3)), 1);
    }
    // x part, A from the swizzled bf16 x tile
    for (int ks = kh16; ks < nk; ++ks) {
        if ((ks & 3) == 0) next_chunk(ks == 0);
        const int c0 = 16 * (ks - kh16);
        Wgmma<N>::ss(acc, sw128_desc(xa + (c0 >> 6) * KBLOCK_BYTES + ((c0 & 63) >> 4) * 32),
                     sw128_desc(b_base + 32 * (ks & 3)), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(prev);
    ring.release(stage);

    const int g = lane >> 2, t = lane & 3;
    const float* b = bias_s + s.sb_off[l];  // zeros without a bias
    if (!last) {
        // relu, bf16, and the accumulator's (row g | g + 8, cols 8j + 2t)
        // pairs become the next layer's A fragments in place
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
            af[2 * j] = pack_bf16(fmaxf(acc[4 * j] + bb.x, 0.f),
                                  fmaxf(acc[4 * j + 1] + bb.y, 0.f));
            af[2 * j + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + bb.x, 0.f),
                                      fmaxf(acc[4 * j + 3] + bb.y, 0.f));
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v = acc[4 * j + e] + ((e & 1) ? bb.y : bb.x);
            if (s.out_act == 1) v = fmaxf(v, 0.f);
            else if (s.out_act == 2) v = 1.f / (1.f + expf(-v));
            acc[4 * j + e] = v;
        }
    }
    const int r_lo = 16 * wq + g;  // this lane's rows: r_lo and r_lo + 8
    const int od = s.out_dim;
    if ((od & 3) == 0) {
        // lanes t and t ^ 1 swap halves: the even one holds 4 neighbouring
        // columns of row r_lo, the odd one of row r_lo + 8
        const bool odd = t & 1;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
            const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
            const float4 v = odd ? make_float4(s0, s1, acc[4 * j + 2], acc[4 * j + 3])
                                 : make_float4(acc[4 * j], acc[4 * j + 1], s0, s1);
            const int r = r_lo + (odd ? 8 : 0), col = 8 * j + 4 * (t >> 1);
            if (r < rows_here && col < od)
                *reinterpret_cast<float4*>(out + (row0 + r) * od + col) = v;
        }
    } else {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = r_lo + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
            if (r < rows_here && col < od) out[(row0 + r) * od + col] = acc[4 * j + e];
        }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const unsigned char* __restrict__ image,
                     const float* __restrict__ bias, long long n_rows, FwdSpec s) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the swizzled tiles need 1024-byte alignment (the launch adds 1 KB)
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.off_bars);  // [MAX_STAGES]
    uint64_t* empty = full + MAX_STAGES;                                // [MAX_STAGES]
    uint64_t* xfull = empty + MAX_STAGES;                  // [CONSUMERS][MAX_X_STAGES]
    uint64_t* xempty = xfull + CONSUMERS * MAX_X_STAGES;   // [CONSUMERS][MAX_X_STAGES]
    float* bias_s = reinterpret_cast<float*>(smem + s.off_bias);
    // the warpgroup, broadcast from lane 0 so that the compiler knows it is
    // uniform in the warp (a role branch it takes for divergent makes it
    // serialize the wgmmas)
    const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    if (tid == 0) {
        for (int i = 0; i < s.stages; ++i) {
            mbar_init(full + i, 1);
            mbar_init(empty + i, 128 * CONSUMERS);
        }
        for (int i = 0; i < CONSUMERS * MAX_X_STAGES; ++i) {
            mbar_init(xfull + i, 1);
            mbar_init(xempty + i, 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int l = 0; l < s.n_layers; ++l)
        for (int col = tid; col < s.N[l]; col += THREADS)
            bias_s[s.sb_off[l] + col] =
                s.has_bias && col < s.n_pack[l] ? bias[s.b_off[l] + col] : 0.f;
    __syncthreads();

    const long long n_blocks = (n_rows + BR - 1) / BR;
    const long long n_tiles = (n_blocks + CONSUMERS - 1) / CONSUMERS;
    const int d_in = s.d_in;
    const uint32_t xraw_bytes = 4u * BR * d_in;
    auto bulk_x = [&](long long block) {
        return s.x_bulk && (block + 1) * BR <= n_rows;
    };

    if (wg == 0) {
        // ---- producer: one thread keeps the bulk copies in flight
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == 0) {
            int k = 0;                 // chunks issued while streaming
            int xn[CONSUMERS] = {};    // x blocks issued per consumer
            auto issue_x = [&](long long t) {
                if (t >= n_tiles) return;
                for (int c = 0; c < CONSUMERS; ++c) {
                    const long long block = t * CONSUMERS + c;
                    if (!bulk_x(block)) continue;
                    const int i = xn[c] % s.x_stages;
                    mbar_wait(xempty + c * MAX_X_STAGES + i, ((xn[c] / s.x_stages) & 1) ^ 1);
                    ++xn[c];
                    bulk_load(smem + s.off_xraw + (c * s.x_stages + i) * xraw_bytes,
                              x + block * BR * d_in, xraw_bytes, xfull + c * MAX_X_STAGES + i);
                }
            };
            auto issue_chunk = [&](int j) {
                int stage = j;
                if (!s.resident) {
                    stage = k % s.stages;
                    mbar_wait(empty + stage, ((k / s.stages) & 1) ^ 1);
                    ++k;
                }
                bulk_load(smem + stage * s.stage_bytes, image + s.chunk_off[j],
                          s.chunk_bytes[j], full + stage);
            };
            // x runs x_stages tiles ahead: tile t's conversion frees the
            // blocks that tile t + x_stages takes. While streaming weights
            // that copy goes out once the consumers are into tile t (past
            // the first chunk refilled), so its wait for the staging blocks
            // never holds the weight stream back.
            const int x_after = s.resident ? s.n_chunks - 1
                                           : min(s.stages, s.n_chunks - 1);
            const long long ahead = (long long)s.x_stages * gridDim.x;
            for (int i = 0; i < s.x_stages; ++i) issue_x(blockIdx.x + (long long)i * gridDim.x);
            bool weights = true;
            for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
                if (!weights) {
                    issue_x(t + ahead);
                    continue;
                }
                for (int j = 0; j < s.n_chunks; ++j) {
                    issue_chunk(j);
                    if (j == x_after) issue_x(t + ahead);
                }
                weights = !s.resident;
            }
        }
    } else {
        // ---- consumers: 64 rows each, the whole chain in registers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int c = wg - 1, ctid = tid - 128 * wg;
        const int wq = __shfl_sync(0xffffffffu, ctid >> 5, 0), lane = ctid & 31;
        const int xa_bytes = ((s.kx + 63) >> 6) * KBLOCK_BYTES;
        unsigned char* xa = smem + s.off_xa + c * xa_bytes;
        const uint32_t xa_u32 = smem_u32(xa);
        Ring ring{smem, full, empty, s.stages, s.stage_bytes, s.resident, 0};
        uint32_t af[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) af[i] = 0u;
        int xn = 0;
        for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
            const long long block = t * CONSUMERS + c;
            if (block >= n_blocks) {  // no rows here: pass the chunks on
                if (!s.resident)
                    for (int j = 0; j < s.n_chunks; ++j) ring.release(ring.take(j));
                continue;
            }
            const long long row0 = block * BR;
            const int rows_here = n_rows - row0 < BR ? (int)(n_rows - row0) : BR;
            const bool bulk = bulk_x(block);
            wg_sync(c);  // every warp's products of the last tile have read xa
            const int slot = xn % s.x_stages;
            const float* xraw = reinterpret_cast<const float*>(
                smem + s.off_xraw + (c * s.x_stages + slot) * xraw_bytes);
            if (bulk) {
                mbar_wait(xfull + c * MAX_X_STAGES + slot, (xn / s.x_stages) & 1);
                ++xn;
            }
            // x -> bf16 (round to nearest even) in the swizzled A layout,
            // zero K padding and rows. Staged rows of d_in % 4 == 0 floats
            // are read as float4 pairs, neighbouring threads along a row;
            // other widths a float at a time, neighbouring threads on
            // neighbouring rows (no bank conflicts for odd d_in: the stem)
            const int groups = s.kx >> 3;
            const bool vec = bulk && (d_in & 3) == 0;
            for (int idx = ctid; idx < BR * groups; idx += 128) {
                const int r = vec ? idx / groups : idx & (BR - 1);
                const int cg = vec ? idx - r * groups : idx >> 6;
                float v[8];
                if (vec && 8 * cg + 8 <= d_in) {
                    const float4 lo = *reinterpret_cast<const float4*>(xraw + r * d_in + 8 * cg);
                    const float4 hi = *reinterpret_cast<const float4*>(xraw + r * d_in + 8 * cg + 4);
                    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
                    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const int col = 8 * cg + e;
                        v[e] = 0.f;
                        if (col < d_in && r < rows_here)
                            v[e] = bulk ? xraw[r * d_in + col] : x[(row0 + r) * d_in + col];
                    }
                }
                *reinterpret_cast<uint4*>(xa + (cg >> 3) * KBLOCK_BYTES + r * 128
                                          + (((cg & 7) ^ (r & 7)) << 4)) =
                    make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                               pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma
            wg_sync(c);
            if (bulk && ctid == 0) mbar_arrive(xempty + c * MAX_X_STAGES + slot);
            for (int l = 0; l < s.n_layers; ++l) {
                const bool last = l == s.n_layers - 1;
                switch (s.N[l] * 256 + s.KH[l]) {
#define LAYER(n, kh) case n * 256 + kh: \
                    run_layer<n, kh>(s, l, last, ring, af, xa_u32, bias_s, out, row0, rows_here, wq, lane); \
                    break;
#define LAYERS(n) LAYER(n, 0) LAYER(n, 16) LAYER(n, 32) LAYER(n, 64) LAYER(n, 128)
                LAYERS(16) LAYERS(32) LAYERS(64) LAYERS(128)
#undef LAYERS
#undef LAYER
                }
            }
        }
    }
}

// x: [n_rows, d_in] f32; out: [n_rows, out_dim] f32; image: the weight
// chunks (ops/fused_mlp.py fwd_weight_image); bias: pack_weights' packed
// f32 bias (read only when has_bias). meta: host int64 from
// ops/fused_mlp.py fwd_layout: [n_layers, d_in, kx, out_dim, out_act,
// has_bias, stages, resident, stage_bytes, x_bulk, n_ctas, smem_bytes,
// off_xa, off_xraw, off_bias, off_bars, image_bytes, x_stages, then per
// layer: N, KH,
// KX, n_pack, b_off, sb_off]. Returns cudaGetLastError().
extern "C" int fused_mlp_fwd(const void* x, void* out, const void* image,
                             const void* bias, const long long* meta,
                             long long n_rows, void* stream) {
    FwdSpec s;
    s.n_layers = (int)meta[0];
    if (s.n_layers < 1 || s.n_layers > MLP_MAX_LAYERS) return (int)cudaErrorInvalidValue;
    s.d_in = (int)meta[1];
    s.kx = (int)meta[2];
    s.out_dim = (int)meta[3];
    s.out_act = (int)meta[4];
    s.has_bias = (int)meta[5];
    s.stages = (int)meta[6];
    s.resident = (int)meta[7];
    s.stage_bytes = (int)meta[8];
    s.x_bulk = (int)meta[9];
    const long long n_ctas = meta[10], smem = meta[11];
    s.off_xa = (int)meta[12];
    s.off_xraw = (int)meta[13];
    s.off_bias = (int)meta[14];
    s.off_bars = (int)meta[15];
    const long long image_bytes = meta[16];
    s.x_stages = (int)meta[17];
    s.n_chunks = 0;
    long long off = 0;
    for (int l = 0; l < s.n_layers; ++l) {
        const long long* m = meta + 18 + 6 * l;
        s.N[l] = (int)m[0];
        s.KH[l] = (int)m[1];
        s.KX[l] = (int)m[2];
        s.n_pack[l] = (int)m[3];
        s.b_off[l] = (int)m[4];
        s.sb_off[l] = (int)m[5];
        const int n = s.N[l];
        if ((n != 16 && n != 32 && n != 64 && n != 128) || s.KH[l] != (l ? s.N[l - 1] : 0)
            || s.KX[l] % 16 != 0 || s.KX[l] > s.kx || s.KH[l] + s.KX[l] == 0
            || s.n_pack[l] > n || n * 128 > s.stage_bytes)
            return (int)cudaErrorInvalidValue;
        s.chunk0[l] = s.n_chunks;
        for (int c0 = 0; c0 < s.KH[l] + s.KX[l]; c0 += 64) {
            if (s.n_chunks == MAX_CHUNKS) return (int)cudaErrorInvalidValue;
            s.chunk_off[s.n_chunks] = (int)off;
            s.chunk_bytes[s.n_chunks++] = n * 128;
            off += n * 128;
        }
    }
    if (off != image_bytes || s.kx % 16 != 0 || s.d_in > s.kx || n_ctas < 1
        || s.out_dim > s.N[s.n_layers - 1] || s.stages < 1 || s.stages > MAX_STAGES
        || s.x_stages < 1 || s.x_stages > MAX_X_STAGES
        || (s.resident ? s.n_chunks > s.stages : s.stages < 2)
        || s.stage_bytes % 1024 != 0 || s.off_xa % 1024 != 0
        || smem + 1024 > 232448)
        return (int)cudaErrorInvalidValue;
    if (n_rows <= 0) return (int)cudaGetLastError();
    // the shared-memory limit is raised once per device (the render
    // launches this kernel hundreds of times per frame)
    static int configured[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= 64 || configured[device] < smem + 1024) {
        err = cudaFuncSetAttribute(fused_mlp_fwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (err != cudaSuccess) return (int)err;
        if (device < 64) configured[device] = 232448;
    }
    const long long n_tiles = ((n_rows + BR - 1) / BR + CONSUMERS - 1) / CONSUMERS;
    const long long grid = n_tiles < n_ctas ? n_tiles : n_ctas;
    fused_mlp_fwd_kernel<<<(unsigned)grid, THREADS, (size_t)(smem + 1024),
                           (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, (const unsigned char*)image,
        (const float*)bias, n_rows, s);
    return (int)cudaGetLastError();
}
