// Flash-attention forward: O = softmax(mask(Q K^T * scale)) V and the row
// log-sum-exp, for (N, S, hd) tensors in f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_fwd ->
// pl.pallas_call, _fwd_kernel).  The TPU grid walks (N, S/BQ, S/BK) in
// order on one core and carries m, l and the accumulator in VMEM scratch
// from one K block to the next.  Here one CTA owns (n, a 64-row query
// tile) and walks the K/V tiles in a loop, keeping m and l in registers
// and the accumulator in registers; blocks run in parallel over (n, tile).
//
// Numerics follow the TPU kernel: scores, online softmax, P.V and the LSE
// in f32; a masked entry scores NEG = -1e30 (not -inf), so a row whose
// first visited tile is fully masked gathers exp(0) = 1 terms that the
// correction exp(m_prev - m_new) = 0 later wipes exactly; O is cast to the
// input dtype; LSE = m + log(max(l, 1e-30)).  Columns past Sk (the ragged
// last tile, which the TPU kernel never has) score -inf and add exactly 0.
// Tiles that no query of the tile can reach are skipped by the test of
// _block_reachable; entries by the test of _block_mask (both in
// flash_mask.cuh, which the backward kernels share).
//
// What bounds it on an H100: at the serve path's prefill shapes (N = 32
// heads, S <= 512, hd 128) operations, not bytes: ~2 N S^2 hd FLOPs
// against ~4 N S hd bytes.  This first version does its arithmetic in
// f32 FMA from shared memory (no tensor cores, no TMA): 256 threads, each
// holding a 4x4 block of the 64x64 score tile and a 4 x hd/16 block of
// the output; the Q and K tiles are stored with a padded row stride
// (hd + 1) so the score loop reads them without bank conflicts, and the
// P tile with stride 65.  At hd 128 that is 115,456 bytes of shared
// memory, so two CTAs fit on an SM.  Heavier (later) query tiles launch
// first, since causal work grows with the tile index.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mask.cuh"
#include "flash_tile.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;
using flash::NEG;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;          // row stride of the P tile

// reduce over the 16 lanes of a half-warp (the threads that share a row)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <int HD>
constexpr int smem_bytes() {
    return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * PS) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Sk, int attention,
                 int window, bool causal, bool glob, float scale) {
    constexpr int QS = HD + 1;      // padded row stride of the Q and K tiles
    constexpr int DJ = HD / 16;     // output columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;               // BQ x QS
    float* sK = sQ + BQ * QS;       // BK x QS
    float* sV = sK + BK * QS;       // BK x HD
    float* sP = sV + BK * HD;       // BQ x PS

    const int n = blockIdx.y;
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int tid = threadIdx.x;
    const int tx = tid & 15;        // column lane: score cols tx+16j, out cols tx+16jj
    const int ty = tid >> 4;        // row lane: rows ty+16i
    const size_t q_base = (size_t)n * S * HD;
    const size_t k_base = (size_t)n * Sk * HD;

    flash::load_tile<T, HD, BQ, QS, THREADS>(sQ, q + q_base + (size_t)q_start * HD,
                                             min(S - q_start, BQ), tid);

    float m[4], l[4], acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
    }

    const int nk = (Sk + BK - 1) / BK;
    for (int kt = 0; kt < nk; ++kt) {
        const int k_start = kt * BK;
        if (!flash::reachable(attention, window, causal, glob, q_start, BQ, k_start, BK))
            continue;
        __syncthreads();            // the previous tile's K, V and P are consumed
        const int live = min(Sk - k_start, BK);
        flash::load_tile<T, HD, BK, QS, THREADS>(sK, k + k_base + (size_t)k_start * HD, live, tid);
        flash::load_tile<T, HD, BK, HD, THREADS>(sV, v + k_base + (size_t)k_start * HD, live, tid);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * QS + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q_start + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k_start + tx + 16 * j;
                float x = s[i][j] * scale;
                if (kp >= Sk) x = -INFINITY;
                else if (!flash::allowed(attention, window, causal, glob, qp, kp)) x = NEG;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            const float corr = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
                sum += p;
            }
            l[i] = l[i] * corr + half_warp_sum(sum);
            m[i] = m_new;
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) {
                const float vv = sV[kk * HD + tx + 16 * jj];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qr = q_start + ty + 16 * i;
        if (qr >= S) continue;
        const float lsum = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
            flash::store(&o[q_base + (size_t)qr * HD + tx + 16 * jj], acc[i][jj] / lsum);
        if (tx == 0) lse[(size_t)n * S + qr] = m[i] + logf(lsum);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int n, int s, int sk, int attention, int window, int causal,
           int glob, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)n);
    flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, s, sk, attention,
        window, causal != 0, glob != 0, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int n, int s, int sk, int attention, int window,
                int causal, int glob, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, stream);
        case 64: return launch<T, 64>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, stream);
        case 96: return launch<T, 96>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, stream);
        case 128: return launch<T, 128>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q (n, s, hd), k and v (n, sk, hd), o (n, s, hd) in one dtype (0 = f32,
// 1 = bf16), all contiguous; lse (n, s) f32.  attention: 0 full, 1 sliding,
// 2 chunked (window >= 1); causal and glob are 0 or 1.  The caller checks
// shapes, dtypes and hd in {16, 64, 96, 128}.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int n, int s, int sk, int hd,
                                          int dtype, int attention, int window,
                                          int causal, int glob, void* stream) {
    if (n == 0 || s == 0) return (int)cudaGetLastError();
    if (sk < 1 || attention < FULL || attention > CHUNKED
        || (attention == CHUNKED && window < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
    return (int)cudaErrorInvalidValue;
}
