// Batched priority SET with upward delta propagation, in place: the
// last-writer dedup, the leaf writes and every ancestor's sum in one
// launch, with no atomics.
//
// Replaces the TPU kernel src/repro/kernels/sumtree_update.py:110
// (sumtree_update_levels -> pl.pallas_call, _kernel).  The TPU kernel takes
// a last-writer mask computed outside it and turns the scatter into
// one-hot MXU matmuls over VMEM-resident level matrices.  Here one CTA
// takes a chunk of up to kChunk updates and does the dedup itself:
//
//   1. thread t loads (idx[t], values[t]) and packs the key
//      idx << kPosBits | t (32 bits where every leaf index fits 22, else
//      64); the keys are sorted ascending by a bitonic sort (shuffles for
//      strides below 32, shared memory with one barrier a stage above),
//      padded to the block's power of two P >= 32 with the largest key;
//   2. sorted entry t survives when entry t + 1 holds another leaf (or t is
//      the chunk's last): the last writer by position, the rule of
//      core/sumtree.py::last_writer_mask.  A survivor reads its old leaf,
//      delta = v - old; every other entry has delta 0;
//   3. in sorted order the ancestors of each interior level form contiguous
//      runs (leaf / K^h, a shift where K is a power of two, is monotone).  Each level's run sums are one
//      segmented inclusive scan of the deltas, in this fixed order:
//        a. in each warp, Hillis-Steele over the lanes: for d = 1, 2, 4, 8,
//           16, lane i takes v = v[i - d] + v[i] when i - d is not before
//           the first lane of its run in the warp (0 for a run that began
//           in an earlier warp);
//        b. the warps' last lanes' values, scanned the same way in warp 0,
//           a warp opening a run where it holds a run head;
//        c. a lane whose run began in an earlier warp w0 < w adds the
//           carry: v = carry[w - 1] + v;
//      the run's last entry then writes tree[off + ancestor] = old + v
//      with a plain store: one thread owns each node.  The root (level 0)
//      is the run of the whole chunk.  Up to kLevelsAtOnce interior levels
//      are scanned together, and their ancestor loads are issued together
//      with the old-leaf loads: three memory round trips (idx and values,
//      old leaves with ancestors, stores) for up to 4 interior levels (K =
//      128 up to 2^28 leaves), one more a further 4;
//   4. the survivors store their new leaves last.
//
// A batch larger than kChunk runs as chunks in position order, one launch
// after another on the stream: sequential SETs give the same last writer,
// and the interior differs from a single pass only in rounding.  The
// order above makes the result the same bit for bit from run to run;
// tests/test_torch_update_sm90.py repeats it in numpy.
//
// What bounds it on an H100: at B = 64 updates on a 3-level tree a few KB
// of scattered reads and writes, so the launch and the dependent round
// trips; the sort (21 compare-exchange stages at P = 64, one through
// shared memory) and the scans run in registers between them.
#include <cstdint>
#include <cuda_runtime.h>

#include "tree_levels.cuh"

namespace {

constexpr int kChunk = 1024;          // updates a launch (one CTA)
constexpr int kPosBits = 10;          // log2(kChunk)
constexpr int kLevelsAtOnce = 4;      // interior levels scanned together
constexpr unsigned kFull = 0xffffffffu;

// Inclusive segmented sum over the lanes of a warp.  `heads` has bit i set
// where lane i starts a run; lanes before the warp's first head continue a
// run from an earlier warp.
__device__ __forceinline__ float warp_seg_scan(float v, unsigned heads, int lane) {
    const unsigned upto = heads & (kFull >> (31 - lane));
    const int start = upto ? 31 - __clz(upto) : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(kFull, v, d);
        if (lane - d >= start) v = o + v;
    }
    return v;
}

// Ancestor of `node` one level up: a shift where K is a power of two.
template <bool kPow2>
__device__ __forceinline__ unsigned parent(unsigned node, unsigned K, int k_shift) {
    return kPow2 ? node >> k_shift : node / K;
}

// KeyT: 32-bit keys where every leaf index fits 32 - kPosBits bits, else
// 64-bit; kPow2: K a power of two (2^k_shift).
template <typename KeyT, bool kPow2>
__global__ void __launch_bounds__(kChunk)
sumtree_update_kernel(float* __restrict__ tree, const long long* __restrict__ idx,
                      const float* __restrict__ values, int n, unsigned K, int k_shift,
                      TreeLevels lv) {
    __shared__ KeyT keys[2][kChunk];
    __shared__ float vals[kChunk];
    __shared__ float wsum[kLevelsAtOnce][32];
    __shared__ bool whead[kLevelsAtOnce][32];
    __shared__ float wcarry[kLevelsAtOnce][32];

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int P = blockDim.x, n_warps = P >> 5;
    // 1. load and sort (idx, position) keys; a stride of 32 or more goes
    // through shared memory, one buffer a stage in turn, so one barrier
    // a stage suffices
    KeyT key = ~KeyT(0);
    if (t < n) {
        key = ((KeyT)idx[t] << kPosBits) | (KeyT)t;
        vals[t] = values[t];
    }
    int buf = 0;
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            KeyT other;
            if (j >= 32) {
                keys[buf][t] = key;
                __syncthreads();
                other = keys[buf][t ^ j];
                buf ^= 1;
            } else {
                other = __shfl_xor_sync(kFull, key, j);
            }
            const bool up = (t & k) == 0, lower = (t & j) == 0;
            key = (lower == up) ? (key < other ? key : other) : (key > other ? key : other);
        }
    }
    keys[buf][t] = key;
    __syncthreads();

    // 2. survivors and their old leaves
    const bool valid = t < n;
    const unsigned leaf = (unsigned)(key >> kPosBits);
    const unsigned prev = t > 0 && valid ? (unsigned)(keys[buf][t - 1] >> kPosBits) : leaf;
    const unsigned next = t + 1 < n ? (unsigned)(keys[buf][t + 1] >> kPosBits) : leaf;
    const bool survivor = valid && (t + 1 == n || next != leaf);
    const long long leaf_at = lv.off[lv.n_levels - 1] + leaf;
    float old = 0.f, v = 0.f;
    if (survivor) {
        old = tree[leaf_at];
        v = vals[key & (kChunk - 1)];
    }

    // 3. every interior level's run sums, kLevelsAtOnce levels a pass
    const int n_interior = lv.n_levels - 1;   // levels n_levels - 2 (parents) .. 0 (root)
    unsigned node = leaf, pnode = prev, nnode = next;
    float delta = 0.f;
    for (int i0 = 0; i0 < n_interior; i0 += kLevelsAtOnce) {
        unsigned anc[kLevelsAtOnce], heads[kLevelsAtOnce];
        bool end[kLevelsAtOnce];
        float anc_old[kLevelsAtOnce], s[kLevelsAtOnce];
#pragma unroll
        for (int i = 0; i < kLevelsAtOnce; ++i) {
            if (i0 + i >= n_interior) break;
            node = parent<kPow2>(node, K, k_shift);
            pnode = parent<kPow2>(pnode, K, k_shift);
            nnode = parent<kPow2>(nnode, K, k_shift);
            anc[i] = node;
            heads[i] = __ballot_sync(kFull, !valid || t == 0 || pnode != node);
            end[i] = valid && (t + 1 == n || nnode != node);
            anc_old[i] = end[i] ? tree[lv.off[n_interior - 1 - (i0 + i)] + node] : 0.f;
        }
        if (i0 == 0) delta = survivor ? v - old : 0.f;
#pragma unroll
        for (int i = 0; i < kLevelsAtOnce; ++i) {
            if (i0 + i >= n_interior) break;
            s[i] = warp_seg_scan(delta, heads[i], lane);
            if (lane == 31) {
                wsum[i][warp] = s[i];
                whead[i][warp] = heads[i] != 0;
            }
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
            for (int i = 0; i < kLevelsAtOnce; ++i) {
                if (i0 + i >= n_interior) break;
                const float x = lane < n_warps ? wsum[i][lane] : 0.f;
                const unsigned wh = __ballot_sync(kFull, lane >= n_warps || whead[i][lane]);
                wcarry[i][lane] = warp_seg_scan(x, wh, lane);
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kLevelsAtOnce; ++i) {
            if (i0 + i >= n_interior) break;
            if (warp > 0 && (heads[i] & (kFull >> (31 - lane))) == 0)
                s[i] = wcarry[i][warp - 1] + s[i];
            const int level = n_interior - 1 - (i0 + i);
            if (end[i]) tree[lv.off[level] + anc[i]] = anc_old[i] + s[i];
        }
        __syncthreads();    // wsum and wcarry are reused by the next pass
    }

    // 4. the new leaves
    if (survivor) tree[leaf_at] = v;
}

}  // namespace

// Launches ceil(B / kChunk) chunks in position order; writes the number of
// launches to *launches.  Leaf indices must lie in [0, 2^31) and within
// the leaf level.
extern "C" int sumtree_update_launch(float* tree, const long long* idx,
                                     const float* values, long long B, int K,
                                     const long long* offsets, int n_levels,
                                     void* stream, int* launches) {
    *launches = 0;
    TreeLevels lv;
    if (!load_levels(offsets, n_levels, &lv) || K < 2 || B < 0)
        return (int)cudaErrorInvalidValue;
    int k_shift = 0;
    while ((1 << k_shift) < K) ++k_shift;
    const bool pow2 = (1 << k_shift) == K;
    const bool narrow = lv.off[n_levels] - lv.off[n_levels - 1] <= (1ll << (32 - kPosBits));
    for (long long c0 = 0; c0 < B; c0 += kChunk) {
        const int n = (int)(B - c0 < kChunk ? B - c0 : kChunk);
        int p = 32;
        while (p < n) p <<= 1;
        const dim3 grid(1), block(p);
        const cudaStream_t st = (cudaStream_t)stream;
        if (narrow && pow2)
            sumtree_update_kernel<unsigned, true><<<grid, block, 0, st>>>(
                tree, idx + c0, values + c0, n, (unsigned)K, k_shift, lv);
        else if (narrow)
            sumtree_update_kernel<unsigned, false><<<grid, block, 0, st>>>(
                tree, idx + c0, values + c0, n, (unsigned)K, k_shift, lv);
        else if (pow2)
            sumtree_update_kernel<unsigned long long, true><<<grid, block, 0, st>>>(
                tree, idx + c0, values + c0, n, (unsigned)K, k_shift, lv);
        else
            sumtree_update_kernel<unsigned long long, false><<<grid, block, 0, st>>>(
                tree, idx + c0, values + c0, n, (unsigned)K, k_shift, lv);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        ++*launches;
    }
    return (int)cudaSuccess;
}
