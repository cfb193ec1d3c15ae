// Row gather out[i] = storage[clamp(idx[i], 0, N-1)] in the native dtype.
//
// Replaces the TPU kernel src/repro/kernels/gather.py (gather_rows ->
// pl.pallas_call, _kernel).  The TPU kernel streams the whole storage
// through VMEM and assembles the batch with one-hot f32 matmuls, so it
// reads all N rows and is exact for integers only below 2^24.  Here each
// thread copies one vector of one sampled row: bytes only, no f32 round
// trip, so every dtype is bit-exact, and only the B sampled rows are read.
//
// What bounds it on an H100: bytes (B rows read + B rows written), which
// at the main path's B = 64 rows of 4-16 bytes is a few KB, so launch
// latency bounds it.  The copy uses the widest vector (16, 8, 4, 2 or 1
// bytes) that the row size and both pointers' alignment allow, with
// consecutive threads on consecutive vectors of a row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct alignas(2) V2 { unsigned char b[2]; };

template <typename VT>
__global__ void gather_rows_kernel(const VT* __restrict__ src,
                                   const long long* __restrict__ idx,
                                   VT* __restrict__ dst,
                                   long long B, long long N, long long vpr) {
    const long long total = B * vpr;
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const long long i = t / vpr;
        const long long c = t - i * vpr;
        long long r = idx[i];
        r = r < 0 ? 0 : (r >= N ? N - 1 : r);   // XLA gather clamps
        dst[t] = src[r * vpr + c];
    }
}

template <typename VT>
void launch(const void* src, const long long* idx, void* dst, long long B,
            long long N, long long row_bytes, cudaStream_t stream) {
    const long long vpr = row_bytes / (long long)sizeof(VT);
    const long long total = B * vpr;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond 32 blocks/SM
    gather_rows_kernel<VT><<<(unsigned)blocks, threads, 0, stream>>>(
        (const VT*)src, idx, (VT*)dst, B, N, vpr);
}

}  // namespace

// vec_bytes: 16, 8, 4, 2 or 1; the caller checks that it divides
// row_bytes and both base pointers.
extern "C" int gather_rows_launch(const void* storage, const long long* idx,
                                  void* out, long long B, long long N,
                                  long long row_bytes, int vec_bytes,
                                  void* stream) {
    if (B > 0 && row_bytes > 0 && N > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        switch (vec_bytes) {
            case 16: launch<uint4>(storage, idx, out, B, N, row_bytes, s); break;
            case 8: launch<uint2>(storage, idx, out, B, N, row_bytes, s); break;
            case 4: launch<unsigned int>(storage, idx, out, B, N, row_bytes, s); break;
            case 2: launch<V2>(storage, idx, out, B, N, row_bytes, s); break;
            case 1: launch<unsigned char>(storage, idx, out, B, N, row_bytes, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
