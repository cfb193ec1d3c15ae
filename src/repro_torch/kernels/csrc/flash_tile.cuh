// Tile loads and stores of the f32 flash-attention forward: rows of an
// (S, HD) matrix in f32 or bf16 into f32 shared memory, 16 bytes a thread
// (rows are HD * sizeof(T) bytes, a multiple of 16 for every HD taken, and
// the wrappers check alignment), and f32 results back in the tensor's dtype.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace flash {

template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void load(const float* p, float* out) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(h[t]);
            out[2 * t] = f.x;
            out[2 * t + 1] = f.y;
        }
    }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [0, ROWS) of a tile whose first row is ``src`` into ``dst`` with row
// stride ``STRIDE``; rows r >= ``live`` (past the end of the matrix) are
// zero and never read.
template <typename T, int HD, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int live, int tid) {
    constexpr int VN = Vec<T>::N;
    constexpr int VPR = HD / VN;    // vectors per row
    constexpr int ROUNDS = (ROWS * VPR + THREADS - 1) / THREADS;
#pragma unroll
    for (int it = 0; it < ROUNDS; ++it) {
        const int e = tid + it * THREADS;
        if (e >= ROWS * VPR) break;
        const int r = e / VPR, c = (e - r * VPR) * VN;
        float x[VN];
        if (r < live) {
            Vec<T>::load(src + (size_t)r * HD + c, x);
        } else {
#pragma unroll
            for (int t = 0; t < VN; ++t) x[t] = 0.f;
        }
#pragma unroll
        for (int t = 0; t < VN; ++t) dst[r * STRIDE + c + t] = x[t];
    }
}

}  // namespace flash
