// Batched inverse-CDF sample over the flat K-ary sum tree.
//
// Replaces the TPU kernel src/repro/kernels/sumtree_sample.py:111
// (sumtree_sample_levels -> pl.pallas_call, _kernel, descend).  The TPU
// kernel gathers each draw's sibling row with a one-hot MXU matmul over a
// VMEM-resident level matrix; here a warp reads its row straight from
// device memory and finds the cutoff with a register scan plus
// __ballot_sync/__ffs (descend.cuh).
//
// What bounds it on an H100: not bytes (B = 64 draws read ~100 KB of rows
// on the main path's 3-level tree, tens of nanoseconds of memory time)
// but the chain of dependent memory round trips each draw makes, on top
// of the launch.  The design makes the chain as short as the tree allows:
// u[draw] and the root are read together (one round trip), each level is
// one round trip (its whole sibling row loaded up front, scanned in
// registers), and the leaf priority comes from the leaf row already read.
// At 50,000 leaves and K = 128 that is 4 round trips, from 9-10 in the
// earlier chunk-by-chunk scan.  The kernel triggers its dependents
// (griddepcontrol.launch_dependents) as it starts, so a gather launched
// with programmatic stream serialization (gather.cu) is scheduled while
// the descent runs; the gather's griddepcontrol.wait still waits for
// this grid to complete and its writes to be visible.
#include "descend.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sumtree_sample_kernel(const float* __restrict__ tree, const float* __restrict__ u,
                      long long* __restrict__ out_idx, float* __restrict__ out_pri,
                      int B, int K, int capacity, bool vec, TreeLevels lv) {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    const int draw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (draw >= B) return;    // whole warps exit together
    const float ud = u[draw];
    const float total = tree[0];
    long long leaf;
    float pri;
    descend::descend_warp<C>(tree, ud, total, lv, K, capacity, vec, &leaf, &pri);
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
        const int C = descend::row_width(K);
        const bool vec = descend::row_vectors(tree, K, C);
        descend::with_row_width(C, [&](auto width) {
            sumtree_sample_kernel<decltype(width)::value>
                <<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
                    tree, u, out_idx, out_pri, B, K, capacity, vec, lv);
        });
    }
    return (int)cudaGetLastError();
}
