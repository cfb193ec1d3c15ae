// Fused inverse-CDF sample + storage-row gather, one launch.
//
// Replaces the TPU kernel src/repro/kernels/sample_gather.py
// (sample_gather_levels -> pl.pallas_call, _kernel).  The TPU kernel runs
// the descent at storage step 0 and then streams every storage leaf
// through VMEM as f32, accumulating one-hot matmuls (so integers are exact
// only below 2^24 and every row of storage is read).  Here the warp that
// descends for a draw copies that draw's row from every storage leaf
// straight away, through a table of (source, destination, row bytes) in
// the native dtypes: no f32 flatten, and only the sampled rows move.
//
// What bounds it on an H100: at the main path's sizes (B = 64, five
// CartPole leaves of 4-16 bytes a row) a few hundred KB of dependent
// reads, so launch latency; the fusion saves one launch and the round
// trip of the indices through device memory between two launches.
#include "descend.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLeaves = 16;

struct LeafTable {
    const char* src[kMaxLeaves];
    char* dst[kMaxLeaves];
    long long row_bytes[kMaxLeaves];
    long long n_rows[kMaxLeaves];
    int n;
};

template <typename VT>
__device__ __forceinline__ void warp_copy(const char* src, char* dst,
                                          long long n_vec, int lane) {
    const VT* s = reinterpret_cast<const VT*>(src);
    VT* d = reinterpret_cast<VT*>(dst);
    for (long long c = lane; c < n_vec; c += 32) d[c] = s[c];
}

__device__ __forceinline__ bool aligned(const void* p, long long a) {
    return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(a - 1)) == 0;
}

__global__ void sample_gather_kernel(const float* __restrict__ tree,
                                     const float* __restrict__ u,
                                     long long* __restrict__ out_idx,
                                     float* __restrict__ out_pri,
                                     int B, int K, int capacity,
                                     TreeLevels lv, LeafTable leaves) {
    const int draw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (draw >= B) return;
    const int lane = threadIdx.x & 31;
    long long leaf;
    float pri;
    descend_warp(tree, u[draw], lv, K, capacity, &leaf, &pri);
    if (lane == 0) {
        out_idx[draw] = leaf;
        out_pri[draw] = pri;
    }
    for (int j = 0; j < leaves.n; ++j) {
        const long long rb = leaves.row_bytes[j];
        const long long n = leaves.n_rows[j];
        const long long r = leaf < n ? leaf : n - 1;
        const char* src = leaves.src[j] + r * rb;
        char* dst = leaves.dst[j] + (long long)draw * rb;
        if (rb % 16 == 0 && aligned(src, 16) && aligned(dst, 16)) {
            warp_copy<uint4>(src, dst, rb / 16, lane);
        } else if (rb % 4 == 0 && aligned(src, 4) && aligned(dst, 4)) {
            warp_copy<unsigned int>(src, dst, rb / 4, lane);
        } else {
            warp_copy<unsigned char>(src, dst, rb, lane);
        }
    }
}

}  // namespace

extern "C" int sample_gather_launch(const float* tree, const float* u,
                                    long long* out_idx, float* out_pri,
                                    int B, int K, int capacity,
                                    const long long* offsets, int n_levels,
                                    int n_leaves, void* const* srcs,
                                    void* const* dsts,
                                    const long long* row_bytes,
                                    const long long* n_rows, void* stream) {
    if (n_leaves < 0 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
    TreeLevels lv;
    if (!load_levels(offsets, n_levels, &lv)) return (int)cudaErrorInvalidValue;
    LeafTable tab;
    for (int j = 0; j < n_leaves; ++j) {
        tab.src[j] = (const char*)srcs[j];
        tab.dst[j] = (char*)dsts[j];
        tab.row_bytes[j] = row_bytes[j];
        tab.n_rows[j] = n_rows[j];
    }
    tab.n = n_leaves;
    if (B > 0) {
        const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
        sample_gather_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                               (cudaStream_t)stream>>>(
            tree, u, out_idx, out_pri, B, K, capacity, lv, tab);
    }
    return (int)cudaGetLastError();
}
