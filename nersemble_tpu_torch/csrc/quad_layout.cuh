// The per-level table layout that the xz-quad kernels B3 (quad_build.cu)
// and B4 (quad_fold.cu) take, and how a warp finds the level of a row group.
//
// HashGridLevels.create (ops/hash_encoding.py) makes every level offset and
// size, and every roll stride, a multiple of QUAD_GROUP rows. So a
// QUAD_GROUP-aligned group of rows lies in one level, and in every quarter
// its rolled source rows are one contiguous, aligned run that never wraps.
// read_layout refuses a layout without that property.

#pragma once

#include <stdint.h>

#define QUAD_MAX_LEVELS 32
#define QUAD_GROUP 32
#define QUAD_FULL_MASK 0xffffffffu
#define QUAD_NO_ROW 0x7fffffff  // past every row (rows are below 2^31)

struct QuadLayout {
    int n_levels;
    long long offset[QUAD_MAX_LEVELS];
    long long size[QUAD_MAX_LEVELS];
    long long shift[3][QUAD_MAX_LEVELS];  // quarters 1..3 (z, x, xz), mod size
};

// meta: host int64 [n_levels, offsets..., sizes..., shift_z..., shift_x...,
// shift_xz...]. False unless the levels tile [0, n_rows) in order and every
// offset, size and shift is a multiple of QUAD_GROUP, each shift < its size.
static inline bool read_layout(const long long* meta, long long n_rows,
                               QuadLayout& layout) {
    const int n = (int)meta[0];
    if (n < 1 || n > QUAD_MAX_LEVELS) return false;
    layout.n_levels = n;
    long long end = 0;
    for (int l = 0; l < n; ++l) {
        const long long off = meta[1 + l], size = meta[1 + n + l];
        if (off != end || size <= 0 || size % QUAD_GROUP != 0) return false;
        layout.offset[l] = off;
        layout.size[l] = size;
        for (int q = 0; q < 3; ++q) {
            const long long s = meta[1 + (2 + q) * n + l];
            if (s < 0 || s >= size || s % QUAD_GROUP != 0) return false;
            layout.shift[q][l] = s;
        }
        end += size;
    }
    return end == n_rows;
}

// Level `lane` of the layout, held by that lane of every warp; lanes past
// the last level hold an offset past every row. A warp then finds a row's
// level with one ballot (level_of) and takes the level's entries from its
// lane by shuffles (group_of), instead of each thread walking the levels.
// Rows are below 2^31 (the entry points refuse more), so 32-bit values do.
struct LaneLevel {
    int offset, size, shift[3];
};

struct LevelTable {
    int v[5][QUAD_MAX_LEVELS];  // offset, size, shift_z, shift_x, shift_xz
};

// Copies the layout into shared memory once per block (`table`), then each
// thread reads its lane's level. Call with every thread of the block.
__device__ __forceinline__ LaneLevel lane_level(const QuadLayout& layout,
                                                LevelTable& table) {
    if (threadIdx.x < QUAD_MAX_LEVELS) {
        const int l = threadIdx.x;
        const bool real = l < layout.n_levels;
        table.v[0][l] = real ? (int)layout.offset[l] : QUAD_NO_ROW;
        table.v[1][l] = real ? (int)layout.size[l] : 1;
        for (int q = 0; q < 3; ++q) table.v[2 + q][l] = real ? (int)layout.shift[q][l] : 0;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    LaneLevel m;
    m.offset = table.v[0][lane];
    m.size = table.v[1][lane];
    for (int q = 0; q < 3; ++q) m.shift[q] = table.v[2 + q][lane];
    return m;
}

// The level of `row`, a warp-uniform row: the count of level offsets at or
// below it, less one. Every lane of the warp must take part.
__device__ __forceinline__ int level_of(int row, const LaneLevel& m) {
    return __popc(__ballot_sync(QUAD_FULL_MASK, m.offset <= row)) - 1;
}

// Level `l`'s entries, taken from lane l (l may differ between lanes).
struct Group {
    int offset, size, shift[3];
};

__device__ __forceinline__ Group group_of(const LaneLevel& m, int l) {
    Group g;
    g.offset = __shfl_sync(QUAD_FULL_MASK, m.offset, l);
    g.size = __shfl_sync(QUAD_FULL_MASK, m.size, l);
    for (int q = 0; q < 3; ++q) g.shift[q] = __shfl_sync(QUAD_FULL_MASK, m.shift[q], l);
    return g;
}

// Row e rolled forward by `shift` rows inside its level: the build's source
// row of a quarter with that shift. The fold reads the inverse roll.
__device__ __forceinline__ int rolled_forward(int e, const Group& g, int shift) {
    int r = e - g.offset + shift;
    if (r >= g.size) r -= g.size;
    return g.offset + r;
}

__device__ __forceinline__ int rolled_back(int e, const Group& g, int shift) {
    int r = e - g.offset - shift;
    if (r < 0) r += g.size;
    return g.offset + r;
}
