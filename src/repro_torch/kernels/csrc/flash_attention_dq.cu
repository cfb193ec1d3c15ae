// Flash-attention backward, dQ: for (N, S, hd) tensors in f32 or bf16,
//   p  = mask ? exp(q.k * scale - lse) : 0
//   ds = p * (dO.v - delta)
//   dQ = scale * sum over keys of ds * k
// with lse the forward's row log-sum-exp and delta = rowsum(O * dO), both
// (N, S) f32 and computed outside this kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_bwd ->
// pl.pallas_call, _dq_kernel).  The TPU grid walks (N, S/BQ, S/BK) in
// order and carries the dQ accumulator in VMEM from one K block to the
// next.  Here one CTA owns (n, a 64-row query tile) and loops over the key
// tiles that the tile can reach (the test of _block_reachable), keeping
// its dQ block in f32 registers: no atomics, no cross-block reduction, so
// the result is deterministic.  A masked entry gets p = 0 (not
// exp(NEG - lse)), as the TPU kernel; keys past Sk get p = 0 and rows past
// S are zero and never stored, so any S works.  The masks come from
// flash_mask.cuh, shared with the forward and dK/dV kernels.
//
// What bounds it on an H100: at the training shape (N = 8 x 16 heads =
// 128, S = 256, hd 128, bf16, causal) bytes, not operations, for the work
// itself: it reads q, k, v, dO (4 N S hd x 2 bytes = 33.6 MB), lse and
// delta (0.26 MB) and writes dQ (8.4 MB), 42.2 MB or 12.6 us at 3.35 TB/s;
// its three products over the causal half, 3 x 2 N hd S(S+1)/2 = 3.2
// GFLOP, take 3.2 us at the bf16 tensor-core peak.  This first version
// computes in f32 FMA from shared memory (no tensor cores, no TMA), as the
// forward kernel does, so it is bound by its FMA rate instead, ~67 TFLOP/s
// at best: 256 threads, each holding a 4x4 block of the 64x64 score and
// dP tiles and a 4 x hd/16 block of dQ; the Q, dO, K and V tiles are
// stored with a padded row stride (hd + 1) so that the two score products
// read them without bank conflicts, and the dS tile with stride 65.  At
// hd 128 that is 148,736 bytes of shared memory, one CTA an SM.  Heavier
// (later) query tiles launch first, since causal work grows with the tile
// index.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mask.cuh"
#include "flash_tile.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;          // row stride of the dS tile

template <int HD>
constexpr int smem_bytes() {
    return (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * PS) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int S, int Sk, int attention, int window,
                bool causal, bool glob, float scale) {
    constexpr int QS = HD + 1;      // padded row stride of the Q, dO, K, V tiles
    constexpr int DJ = HD / 16;     // dQ columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;               // BQ x QS
    float* sO = sQ + BQ * QS;       // BQ x QS (dO)
    float* sK = sO + BQ * QS;       // BK x QS
    float* sV = sK + BK * QS;       // BK x QS
    float* sDS = sV + BK * QS;      // BQ x PS

    const int n = blockIdx.y;
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int tid = threadIdx.x;
    const int tx = tid & 15;        // column lane: keys tx+16j, dQ cols tx+16jj
    const int ty = tid >> 4;        // row lane: query rows ty+16i
    const size_t q_base = (size_t)n * S * HD;
    const size_t k_base = (size_t)n * Sk * HD;

    const int q_live = min(S - q_start, BQ);
    flash::load_tile<T, HD, BQ, QS, THREADS>(sQ, q + q_base + (size_t)q_start * HD, q_live, tid);
    flash::load_tile<T, HD, BQ, QS, THREADS>(sO, dout + q_base + (size_t)q_start * HD, q_live,
                                             tid);
    float row_lse[4], row_delta[4], acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        row_lse[i] = r < q_live ? lse[(size_t)n * S + q_start + r] : 0.f;
        row_delta[i] = r < q_live ? delta[(size_t)n * S + q_start + r] : 0.f;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
    }

    const int nk = (Sk + BK - 1) / BK;
    for (int kt = 0; kt < nk; ++kt) {
        const int k_start = kt * BK;
        if (!flash::reachable(attention, window, causal, glob, q_start, BQ, k_start, BK))
            continue;
        __syncthreads();            // the previous tile's K and dS are consumed
        const int k_live = min(Sk - k_start, BK);
        flash::load_tile<T, HD, BK, QS, THREADS>(sK, k + k_base + (size_t)k_start * HD, k_live,
                                                 tid);
        flash::load_tile<T, HD, BK, QS, THREADS>(sV, v + k_base + (size_t)k_start * HD, k_live,
                                                 tid);
        __syncthreads();

        // scores q.k and dP = dO.v for this thread's 4x4 block
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float a[4], g[4], b[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                a[i] = sQ[(ty + 16 * i) * QS + d];
                g[i] = sO[(ty + 16 * i) * QS + d];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                b[j] = sK[(tx + 16 * j) * QS + d];
                c[j] = sV[(tx + 16 * j) * QS + d];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(a[i], b[j], s[i][j]);
                    dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q_start + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k_start + tx + 16 * j;
                const float p = (kp < Sk && flash::allowed(attention, window, causal, glob, qp, kp))
                                    ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
                sDS[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
            }
        }
        __syncthreads();

        // dQ += dS . K
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float ds[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) {
                const float kv = sK[kk * QS + tx + 16 * jj];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(ds[i], kv, acc[i][jj]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qr = q_start + ty + 16 * i;
        if (qr >= S) continue;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
            flash::store(&dq[q_base + (size_t)qr * HD + tx + 16 * jj], acc[i][jj] * scale);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int n, int s, int sk, int attention, int window,
           int causal, int glob, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)n);
    flash_dq_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, s, sk,
        attention, window, causal != 0, glob != 0, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int n, int s, int sk,
                int attention, int window, int causal, int glob, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, stream);
        case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, stream);
        case 96: return launch<T, 96>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, stream);
        case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q, dout, dq (n, s, hd) and k, v (n, sk, hd) in one dtype (0 = f32,
// 1 = bf16), lse and delta (n, s) f32, all contiguous.  attention: 0 full,
// 1 sliding, 2 chunked (window >= 1); causal and glob are 0 or 1.  The
// caller checks shapes, dtypes and hd in {16, 64, 96, 128}.
extern "C" int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, int n, int s, int sk,
                                         int hd, int dtype, int attention, int window,
                                         int causal, int glob, void* stream) {
    if (n == 0 || s == 0) return (int)cudaGetLastError();
    if (sk < 1 || attention < FULL || attention > CHUNKED
        || (attention == CHUNKED && window < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, st);
    return (int)cudaErrorInvalidValue;
}
