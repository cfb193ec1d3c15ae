// Shared inverse-CDF descent over the flat K-ary sum tree, one warp per
// draw.  Included by sumtree_sample.cu and sample_gather.cu so the split
// and fused kernels run the identical arithmetic.  The flat layout is
// described in tree_levels.cuh.
//
// One dependent memory round trip per level.  Lane `lane` loads children
// [lane*C, (lane+1)*C) of the sibling row up front (one float2, float4 or
// two float4 loads where K = 32*C and the row is aligned, else C masked
// scalar loads issued before any is used), so the whole row arrives in
// one round trip.  The scan then runs in registers:
//
//   local[i]  sequential inclusive sums of the lane's C children;
//   s         inclusive Hillis-Steele warp scan of the lane totals
//             (5 __shfl_up_sync);
//   base      carry + s of the lane before (0 for lane 0);
//   csum      of the lane's child i is base + local[i].
//
// The first lane whose last csum reaches the residual (__ballot_sync,
// __ffs) holds the cutoff, and a short search in that lane finds the
// first child.  K > 256 takes the C = 8 instance a chunk of 256 children
// at a time (one round trip each), carrying the chunk's total.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "tree_levels.cuh"

namespace descend {

constexpr unsigned kFull = 0xffffffffu;

// Children per lane for fanout K: the smallest of 1, 2, 4 and 8 that
// covers ceil(K/32); 8 (in chunks of 256) past K = 256.
inline int row_width(int K) {
    const int c = (K + 31) / 32;
    return c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : 8;
}

// Whether every row can be read with vector loads: full chunks (K a
// multiple of 32*C) and a tree base aligned to the vector.  Level offsets
// are multiples of K, so then every row is aligned too.
inline bool row_vectors(const float* tree, int K, int C) {
    const uintptr_t align = C >= 4 ? 16 : 8;
    return C >= 2 && K % (32 * C) == 0 && reinterpret_cast<uintptr_t>(tree) % align == 0;
}

// Calls f(std::integral_constant<int, C>) for the instance of width C.
template <typename F>
inline void with_row_width(int C, F&& f) {
    switch (C) {
        case 1: f(std::integral_constant<int, 1>{}); break;
        case 2: f(std::integral_constant<int, 2>{}); break;
        case 4: f(std::integral_constant<int, 4>{}); break;
        default: f(std::integral_constant<int, 8>{}); break;
    }
}

template <int C>
__device__ __forceinline__ void load_children(const float* __restrict__ row, int first,
                                              int K, bool vec, float (&v)[C]) {
    if (C >= 2 && vec) {
        if constexpr (C == 2) {
            const float2 x = *reinterpret_cast<const float2*>(row + first);
            v[0] = x.x; v[1] = x.y;
        } else if constexpr (C >= 4) {
#pragma unroll
            for (int q = 0; q < C / 4; ++q) {
                const float4 x = *reinterpret_cast<const float4*>(row + first + 4 * q);
                v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < C; ++i) v[i] = first + i < K ? row[first + i] : 0.f;
    }
}

// Scans one sibling row against `residual`, in every lane of the warp:
// the first child whose csum reaches it, that csum and the child's value;
// with no hit (the fp tail) the last child, csum[K-1] and row[K-1].
template <int C>
__device__ __forceinline__ void scan_row(const float* __restrict__ row, int K, bool vec,
                                         float residual, int lane, int* cutoff,
                                         float* picked, float* row_val) {
    float carry = 0.f;
    for (int c0 = 0; c0 < K; c0 += 32 * C) {
        const int first = c0 + lane * C;
        float v[C];
        load_children<C>(row, first, K, vec, v);
        float local[C];
        local[0] = v[0];
#pragma unroll
        for (int i = 1; i < C; ++i) local[i] = local[i - 1] + v[i];
        float s = local[C - 1];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const float n = __shfl_up_sync(kFull, s, d);
            if (lane >= d) s += n;
        }
        float before = __shfl_up_sync(kFull, s, 1);
        if (lane == 0) before = 0.f;
        const float base = carry + before;
        const unsigned hit = __ballot_sync(kFull, first < K && base + local[C - 1] >= residual);
        // in-lane: the first child whose csum reaches (children past K hold
        // 0, so the lane's last csum is that of its last live child)
        int i_hit = C - 1;
        float p = base + local[C - 1], rv = v[C - 1];
#pragma unroll
        for (int i = C - 2; i >= 0; --i) {
            if (base + local[i] >= residual) { i_hit = i; p = base + local[i]; rv = v[i]; }
        }
        if (hit) {
            const int src = __ffs(hit) - 1;
            *cutoff = c0 + src * C + __shfl_sync(kFull, i_hit, src);
            *picked = __shfl_sync(kFull, p, src);
            *row_val = __shfl_sync(kFull, rv, src);
            return;
        }
        if (c0 + 32 * C >= K) {     // no hit in the row: the last child
            const int src = (K - 1 - c0) / C, il = (K - 1 - c0) - src * C;
            float vl = v[0];
#pragma unroll
            for (int i = 1; i < C; ++i) if (i == il) vl = v[i];
            *cutoff = K - 1;
            *picked = __shfl_sync(kFull, base + local[C - 1], src);
            *row_val = __shfl_sync(kFull, vl, src);
            return;
        }
        carry = carry + __shfl_sync(kFull, s, 31);
    }
}

// Returns the clamped leaf index in *leaf and its priority in *pri, in
// every lane of the calling warp.  All 32 lanes must call it with the
// same u and total (the root tree[0], read by the caller with u).  At the
// leaf level the picked child's value is the leaf priority; it is read
// again only when the clamp to capacity - 1 moved the leaf.
template <int C>
__device__ __forceinline__ void descend_warp(const float* __restrict__ tree, float u, float total,
                                             const TreeLevels& lv, int K, int capacity, bool vec,
                                             long long* leaf, float* pri) {
    const int lane = threadIdx.x & 31;
    // clip bounds are the f32 roundings of the reference's Python floats
    const float lo = 1e-12f;
    const float hi = (float)(1.0 - 1e-7);
    float residual = fminf(fmaxf(u, lo), hi) * total;
    long long group = 0;
    float row_val = 0.f;
    for (int l = 1; l < lv.n_levels; ++l) {
        // A padding node (reachable only through fp-tail no-hits on a tree
        // whose interior exceeds its leaves) has no child row; every leaf
        // below it lies past capacity, so the draw clamps to capacity-1.
        if (group * K >= lv.off[l + 1] - lv.off[l]) { group = capacity; break; }
        const float* row = tree + lv.off[l] + group * (long long)K;
        int cutoff;
        float picked;
        scan_row<C>(row, K, vec, residual, lane, &cutoff, &picked, &row_val);
        residual = residual - (picked - row_val);
        group = group * K + cutoff;
    }
    const long long last = (long long)capacity - 1;
    *leaf = group < last ? group : last;
    *pri = *leaf == group ? row_val : tree[lv.off[lv.n_levels - 1] + *leaf];
}

}  // namespace descend
