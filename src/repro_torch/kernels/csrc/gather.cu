// Row gather out[j][i] = storage[j][clamp(idx[i], 0, N_j - 1)] for every
// storage leaf j in one launch, in each leaf's native dtype.
//
// Replaces the TPU kernel src/repro/kernels/gather.py:60 (gather_rows ->
// pl.pallas_call, _kernel).  The TPU kernel streams the whole storage
// through VMEM and assembles the batch with one-hot f32 matmuls, one leaf a
// call, so it reads all N rows, is exact for integers only below 2^24 and
// turns one inf in a column into NaN in every gathered row.  Here each
// thread copies one vector of one sampled row of one leaf: bytes only, so
// every dtype is bit-exact, and only the B sampled rows are read.
//
// What bounds it on an H100: not bytes (the main path's B = 64 rows of
// 4-16 bytes are a few KB) but the launch and two dependent round trips
// (the index, then the row).  The design:
//   * one launch for up to 16 leaves, through a table of (source,
//     destination, row bytes, rows, vector width) passed by value; the
//     grid's y index is the leaf, so a block copies one leaf with one
//     vector width and finds its entry without a search, and every copy
//     of every leaf is in flight at once (two round trips in all, not two
//     per leaf);
//   * the widest vector (16, 8, 4, 2 or 1 bytes) that the row size and
//     both pointers allow; consecutive lanes on consecutive vectors of a
//     row, or on consecutive draws where a row is one vector;
//   * 32-bit index arithmetic (the launcher refuses a leaf of 2^31
//     vectors or more), so no 64-bit division per element;
//   * each thread reads its draw's index once and clamps it into its
//     leaf's rows, as XLA's gather does;
//   * programmatic dependent launch: the kernel is launched with
//     programmatic stream serialization, so it may start while the kernel
//     before it (the descent, which triggers its dependents as it starts)
//     runs; griddepcontrol.wait, before the first memory access, waits
//     for that grid to complete and its writes to be visible.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 256;

struct GatherTable {
    const char* src[kMaxLeaves];
    char* dst[kMaxLeaves];
    long long row_bytes[kMaxLeaves];
    long long n_rows[kMaxLeaves];
    int vec_shift[kMaxLeaves];          // log2 of the vector width in bytes
};

struct alignas(2) V2 { unsigned char b[2]; };

template <typename VT>
__device__ __forceinline__ void copy_vec(const char* src, char* dst) {
    *reinterpret_cast<VT*>(dst) = *reinterpret_cast<const VT*>(src);
}

__global__ void __launch_bounds__(kThreads)
gather_items_kernel(const long long* __restrict__ idx, unsigned B, GatherTable tab) {
    const int j = blockIdx.y;                            // the leaf
    const int shift = tab.vec_shift[j];
    const long long rb = tab.row_bytes[j];
    const unsigned vpr = (unsigned)(rb >> shift);       // vectors a row
    const unsigned t = blockIdx.x * kThreads + threadIdx.x;
    if (vpr == 0 || t >= B * vpr) return;                // past this leaf's rows
    const unsigned draw = t / vpr;
    const unsigned c = t - draw * vpr;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    long long r = idx[draw];
    const long long n = tab.n_rows[j];
    r = r < 0 ? 0 : (r >= n ? n - 1 : r);                // XLA gather clamps
    const long long at = (long long)c << shift;
    const char* src = tab.src[j] + r * rb + at;
    char* dst = tab.dst[j] + (long long)draw * rb + at;
    switch (shift) {
        case 4: copy_vec<uint4>(src, dst); break;
        case 3: copy_vec<uint2>(src, dst); break;
        case 2: copy_vec<unsigned int>(src, dst); break;
        case 1: copy_vec<V2>(src, dst); break;
        default: copy_vec<unsigned char>(src, dst); break;
    }
}

}  // namespace

// One launch for n_leaves leaves (at most 16).  vec_bytes[j]: 16, 8, 4, 2
// or 1; the caller checks that it divides row_bytes[j] and both base
// pointers.  A leaf with 0-byte rows has nothing to copy.
extern "C" int gather_items_launch(const long long* idx, long long B, int n_leaves,
                                   void* const* srcs, void* const* dsts,
                                   const long long* row_bytes, const long long* n_rows,
                                   const int* vec_bytes, void* stream) {
    if (n_leaves < 1 || n_leaves > kMaxLeaves || B < 0) return (int)cudaErrorInvalidValue;
    GatherTable tab;
    long long most = 0;                 // the largest leaf's vector count
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
        tab.vec_shift[j] = shift;
        const long long vectors = B * (row_bytes[j] >> shift);
        if (vectors >= (1ll << 31)) return (int)cudaErrorInvalidValue;
        most = vectors > most ? vectors : most;
    }
    if (most == 0) return (int)cudaGetLastError();
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((most + kThreads - 1) / kThreads), (unsigned)n_leaves);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, gather_items_kernel, idx, (unsigned)B, tab);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
