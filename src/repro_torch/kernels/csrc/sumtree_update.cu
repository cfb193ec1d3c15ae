// Batched priority SET with upward delta propagation, in place.
//
// Replaces the TPU kernel src/repro/kernels/sumtree_update.py
// (sumtree_update_levels -> pl.pallas_call, _kernel).  The TPU kernel
// turns the scatter into one-hot MXU matmuls over VMEM-resident level
// matrices; here one thread owns one update: it reads the old leaf, sets
// the leaf to the new value and atomicAdds the delta into its ancestor
// at every level and into the root, in the flat tree.  Duplicate leaves
// are resolved before the launch: the wrapper passes the last-writer
// mask (or none when the caller guarantees distinct indices), so at most
// one thread writes a leaf.  Float atomics make the order of the ancestor
// sums vary from run to run, so the result is held to allclose.
//
// What bounds it on an H100: at B = 64 updates on a 3-level tree a few
// KB of scattered read-modify-writes, so launch latency; the atomics on
// the shared top levels (at most K + 1 distinct addresses) serialise only
// B additions each.
#include <cstdint>
#include <cuda_runtime.h>

#include "tree_levels.cuh"

namespace {

__global__ void sumtree_update_kernel(float* __restrict__ tree,
                                      const long long* __restrict__ idx,
                                      const float* __restrict__ values,
                                      const unsigned char* __restrict__ mask,
                                      int B, int K, TreeLevels lv) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    if (mask != nullptr && !mask[i]) return;   // superseded duplicate: delta 0
    const int leaf_level = lv.n_levels - 1;
    long long node = idx[i];
    float* leaf = tree + lv.off[leaf_level] + node;
    const float v = values[i];
    const float delta = v - *leaf;
    *leaf = v;
    for (int l = leaf_level - 1; l >= 0; --l) {
        node /= K;
        atomicAdd(tree + lv.off[l] + node, delta);
    }
}

}  // namespace

// mask: one byte per update (nonzero = the surviving write), or null when
// every index is distinct.
extern "C" int sumtree_update_launch(float* tree, const long long* idx,
                                     const float* values,
                                     const unsigned char* mask, int B, int K,
                                     const long long* offsets, int n_levels,
                                     void* stream) {
    TreeLevels lv;
    if (!load_levels(offsets, n_levels, &lv)) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int threads = 128;
        sumtree_update_kernel<<<(B + threads - 1) / threads, threads, 0,
                                (cudaStream_t)stream>>>(
            tree, idx, values, mask, B, K, lv);
    }
    return (int)cudaGetLastError();
}
