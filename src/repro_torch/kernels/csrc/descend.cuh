// Shared inverse-CDF descent over the flat K-ary sum tree, one warp per
// draw.  Included by sumtree_sample.cu and sample_gather.cu so the split
// and fused kernels run the identical arithmetic.  The flat layout is
// described in tree_levels.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tree_levels.cuh"

// Returns the clamped leaf index in *leaf and its priority (re-read after
// the clamp) in *pri, in every lane of the calling warp.  All 32 lanes of
// the warp must call it with the same u.
__device__ __forceinline__ void descend_warp(
        const float* __restrict__ tree, float u, const TreeLevels& lv,
        int K, int capacity, long long* leaf, float* pri) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    // clip bounds are the f32 roundings of the reference's Python floats
    const float lo = 1e-12f;
    const float hi = (float)(1.0 - 1e-7);
    float residual = fminf(fmaxf(u, lo), hi) * tree[0];   // total = the root
    long long group = 0;
    for (int l = 1; l < lv.n_levels; ++l) {
        // A padding node (reachable only through fp-tail no-hits on a tree
        // whose interior exceeds its leaves) has no child row; every leaf
        // below it lies past capacity, so the draw clamps to capacity-1.
        if (group >= (lv.off[l + 1] - lv.off[l]) / K) {
            group = capacity;
            break;
        }
        const float* row = tree + lv.off[l] + group * (long long)K;
        float carry = 0.f;      // inclusive cumsum up to the previous chunk
        int cutoff = -1;
        float picked = 0.f, row_val = 0.f;
        for (int c0 = 0; c0 < K; c0 += 32) {
            const int j = c0 + lane;
            const float v = (j < K) ? row[j] : 0.f;
            float s = v;        // warp-shuffle inclusive scan of the chunk
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const float n = __shfl_up_sync(full, s, d);
                if (lane >= d) s += n;
            }
            s += carry;
            const unsigned hit = __ballot_sync(full, (j < K) && (s >= residual));
            if (hit) {          // warp-uniform: the first lane that reaches it
                const int first = __ffs(hit) - 1;
                cutoff = c0 + first;
                picked = __shfl_sync(full, s, first);
                row_val = __shfl_sync(full, v, first);
                break;
            }
            // lanes past K hold 0, so lane 31 carries csum of the whole chunk
            carry = __shfl_sync(full, s, 31);
        }
        if (cutoff < 0) {       // no hit (fp tail): the last child
            cutoff = K - 1;
            picked = carry;     // csum[K-1]
            row_val = row[K - 1];
        }
        residual = residual - (picked - row_val);
        group = group * K + cutoff;
    }
    const long long last = (long long)capacity - 1;
    *leaf = group < last ? group : last;
    *pri = tree[lv.off[lv.n_levels - 1] + *leaf];
}
