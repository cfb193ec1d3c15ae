// Fused inverse-CDF sample + storage-row gather, one launch.
//
// Replaces the TPU kernel src/repro/kernels/sample_gather.py:119
// (sample_gather_levels -> pl.pallas_call, _kernel).  The TPU kernel runs
// the descent at storage step 0 and then streams every storage leaf
// through VMEM as f32, accumulating one-hot matmuls (so integers are exact
// only below 2^24 and every row of storage is read).  Here the warp that
// descends for a draw (descend.cuh, the descent sumtree_sample.cu runs:
// one round trip per level) then copies that draw's row of every storage
// leaf, as bytes in the native dtypes: no f32 flatten, and only the
// sampled rows move.
//
// What bounds it on an H100: at the main path's sizes (B = 64, five
// CartPole leaves of 4-16 bytes a row) the launch and the chain of
// dependent round trips, not bytes.  So the copy puts every leaf's row in
// flight at once:
//   * the host picks each leaf's vector width (16, 8, 4, 2 or 1 bytes)
//     from its pointers and row bytes and writes it, with the prefix sum
//     of the leaves' vector ("chunk") counts, into the table passed by
//     value: no alignment test on the device;
//   * a draw's chunks of all leaves are numbered 0 .. total - 1 in leaf
//     order and shared by W warps (W = 1, 2, 4 or 8: enough for one chunk
//     a lane), each of which runs the same descent; lane l of the draw's
//     warp w takes chunks 32w + l, 32w + l + 32W, ..., walks the prefix
//     table forward to each chunk's leaf and loads up to kInFlight of them
//     into registers before it stores any, so one round trip covers
//     32 * W * kInFlight chunks.  CartPole's five rows are five chunks, one
//     warp; the token replay's four 1 KB rows are 256 chunks of 16 bytes,
//     eight warps with one chunk a lane: its B = 8 draws run as eight
//     blocks on eight SMs, where one warp a draw put all 32 KB through
//     one SM;
//   * each leaf's row index is clamped into its rows, as XLA's gather
//     clamps.

#include "descend.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLeaves = 16;
constexpr int kInFlight = 8;          // chunks a lane loads before it stores

struct LeafTable {
    const char* src[kMaxLeaves];
    char* dst[kMaxLeaves];
    long long row_bytes[kMaxLeaves];
    long long n_rows[kMaxLeaves];
    int first[kMaxLeaves + 1];        // a draw's first chunk of each leaf; first[n] = total
    int shift[kMaxLeaves];            // log2 of the leaf's vector width in bytes
    int n;
};

__device__ __forceinline__ uint4 load_vec(const char* p, int shift) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    switch (shift) {
        case 4: x = *reinterpret_cast<const uint4*>(p); break;
        case 3: { const uint2 y = *reinterpret_cast<const uint2*>(p); x.x = y.x; x.y = y.y; break; }
        case 2: x.x = *reinterpret_cast<const unsigned int*>(p); break;
        case 1: x.x = *reinterpret_cast<const unsigned short*>(p); break;
        default: x.x = *reinterpret_cast<const unsigned char*>(p); break;
    }
    return x;
}

__device__ __forceinline__ void store_vec(char* p, int shift, uint4 x) {
    switch (shift) {
        case 4: *reinterpret_cast<uint4*>(p) = x; break;
        case 3: *reinterpret_cast<uint2*>(p) = make_uint2(x.x, x.y); break;
        case 2: *reinterpret_cast<unsigned int*>(p) = x.x; break;
        case 1: *reinterpret_cast<unsigned short*>(p) = (unsigned short)x.x; break;
        default: *reinterpret_cast<unsigned char*>(p) = (unsigned char)x.x; break;
    }
}

// 2^wpd_shift warps a draw: each descends (the same u, the same leaf) and
// copies every 2^wpd_shift-th group of 32 chunks.
template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sample_gather_kernel(const float* __restrict__ tree, const float* __restrict__ u,
                     long long* __restrict__ out_idx, float* __restrict__ out_pri,
                     int B, int K, int capacity, bool vec, TreeLevels lv,
                     LeafTable leaves, int wpd_shift) {
    const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int draw = warp >> wpd_shift;
    if (draw >= B) return;
    const int lane = threadIdx.x & 31;
    const int sub = warp & ((1 << wpd_shift) - 1);   // the warp's place in its draw
    const float ud = u[draw];
    const float total = tree[0];
    long long leaf;
    float pri;
    descend::descend_warp<C>(tree, ud, total, lv, K, capacity, vec, &leaf, &pri);
    if (lane == 0 && sub == 0) {
        out_idx[draw] = leaf;
        out_pri[draw] = pri;
    }
    const int chunks = leaves.first[leaves.n];
    const int stride = 32 << wpd_shift;            // chunks a round of the draw's warps
    int j = 0;                                     // the leaf of the lane's chunk
    for (int c0 = sub * 32 + lane; c0 < chunks; c0 += stride * kInFlight) {
        uint4 x[kInFlight];
        char* dst[kInFlight];
        int shift[kInFlight];
#pragma unroll
        for (int r = 0; r < kInFlight; ++r) {      // every load first ...
            const int c = c0 + stride * r;
            if (c < chunks) {
                while (c >= leaves.first[j + 1]) ++j;
                const long long rb = leaves.row_bytes[j];
                const long long n = leaves.n_rows[j];
                const long long at = (long long)(c - leaves.first[j]) << leaves.shift[j];
                shift[r] = leaves.shift[j];
                dst[r] = leaves.dst[j] + (long long)draw * rb + at;
                x[r] = load_vec(leaves.src[j] + (leaf < n ? leaf : n - 1) * rb + at, shift[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < kInFlight; ++r)        // ... then every store
            if (c0 + stride * r < chunks) store_vec(dst[r], shift[r], x[r]);
    }
}

}  // namespace

// vec_bytes[j]: 16, 8, 4, 2 or 1; the caller checks that it divides
// row_bytes[j] and both base pointers.
extern "C" int sample_gather_launch(const float* tree, const float* u,
                                    long long* out_idx, float* out_pri,
                                    int B, int K, int capacity,
                                    const long long* offsets, int n_levels,
                                    int n_leaves, void* const* srcs,
                                    void* const* dsts,
                                    const long long* row_bytes,
                                    const long long* n_rows, const int* vec_bytes,
                                    void* stream) {
    if (n_leaves < 0 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
    TreeLevels lv;
    if (!load_levels(offsets, n_levels, &lv)) return (int)cudaErrorInvalidValue;
    LeafTable tab;
    long long chunks = 0;
    for (int j = 0; j < n_leaves; ++j) {
        int shift = 0;
        while ((1 << shift) < vec_bytes[j]) ++shift;
        if ((1 << shift) != vec_bytes[j] || shift > 4 || row_bytes[j] < 0 ||
            row_bytes[j] % vec_bytes[j] != 0 || n_rows[j] < 1)
            return (int)cudaErrorInvalidValue;
        tab.src[j] = (const char*)srcs[j];
        tab.dst[j] = (char*)dsts[j];
        tab.row_bytes[j] = row_bytes[j];
        tab.n_rows[j] = n_rows[j];
        tab.shift[j] = shift;
        tab.first[j] = (int)chunks;
        chunks += row_bytes[j] >> shift;
        if (chunks >= (1ll << 31) - 32ll * kInFlight) return (int)cudaErrorInvalidValue;
    }
    tab.first[n_leaves] = (int)chunks;
    tab.n = n_leaves;
    // warps a draw: enough for one chunk a lane, at most a block's 8
    int wpd_shift = 0;
    while ((32ll << wpd_shift) < chunks && (1 << wpd_shift) < kWarpsPerBlock) ++wpd_shift;
    if (B > 0) {
        const long long warps = (long long)B << wpd_shift;
        const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
        const int C = descend::row_width(K);
        const bool vec = descend::row_vectors(tree, K, C);
        descend::with_row_width(C, [&](auto width) {
            sample_gather_kernel<decltype(width)::value>
                <<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
                    tree, u, out_idx, out_pri, B, K, capacity, vec, lv, tab, wpd_shift);
        });
    }
    return (int)cudaGetLastError();
}
