// Batched inverse-CDF sample over the flat K-ary sum tree.
//
// Replaces the TPU kernel src/repro/kernels/sumtree_sample.py
// (sumtree_sample_levels -> pl.pallas_call, _kernel, descend).  The TPU
// kernel gathers each draw's sibling row with a one-hot MXU matmul over a
// VMEM-resident level matrix; here a warp reads its row straight from
// device memory (one coalesced K*4-byte read per level) and finds the
// cutoff with a warp-shuffle scan plus __ballot_sync/__ffs.
//
// What bounds it on an H100: at the replay sizes the main path uses
// (B = 64 draws, 3 levels of K = 128) the work is ~100 KB of dependent
// row reads, far below what the card moves in the ~3 us a launch costs,
// so launch latency bounds it.  The design keeps the latency chain short:
// one warp per draw (no block-level sync), one row read per level, and
// the early break at the first chunk that reaches the residual.
#include "descend.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void sumtree_sample_kernel(const float* __restrict__ tree,
                                      const float* __restrict__ u,
                                      long long* __restrict__ out_idx,
                                      float* __restrict__ out_pri,
                                      int B, int K, int capacity,
                                      TreeLevels lv) {
    const int draw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (draw >= B) return;    // whole warps exit together
    long long leaf;
    float pri;
    descend_warp(tree, u[draw], lv, K, capacity, &leaf, &pri);
    if ((threadIdx.x & 31) == 0) {
        out_idx[draw] = leaf;
        out_pri[draw] = pri;
    }
}

}  // namespace

extern "C" int sumtree_sample_launch(const float* tree, const float* u,
                                     long long* out_idx, float* out_pri,
                                     int B, int K, int capacity,
                                     const long long* offsets, int n_levels,
                                     void* stream) {
    TreeLevels lv;
    if (!load_levels(offsets, n_levels, &lv)) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
        sumtree_sample_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                (cudaStream_t)stream>>>(
            tree, u, out_idx, out_pri, B, K, capacity, lv);
    }
    return (int)cudaGetLastError();
}
