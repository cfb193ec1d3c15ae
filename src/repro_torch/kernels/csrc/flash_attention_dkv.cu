// Flash-attention backward, dK and dV: for (N, S, hd) tensors in f32 or
// bf16,
//   p  = mask ? exp(q.k * scale - lse) : 0
//   dV = sum over queries of p * dO
//   ds = p * (dO.v - delta)
//   dK = scale * sum over queries of ds * q
// with lse the forward's row log-sum-exp and delta = rowsum(O * dO), both
// (N, S) f32 and computed outside this kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_bwd ->
// pl.pallas_call, _dkv_kernel).  The TPU grid walks (N, S/BK, S/BQ) in
// order and carries the dK and dV accumulators in VMEM from one Q block to
// the next.  Here one CTA owns (n, a 64-row key tile) and loops over the
// query tiles that can reach it (the test of _block_reachable; under a
// causal mask they start at the key tile's own row), keeping its dK and
// dV blocks in f32 registers: no atomics, no cross-block reduction, so the
// result is deterministic, and the TPU's split into a dQ and a dK/dV
// kernel stays.  A masked entry gets p = 0 (not exp(NEG - lse)), as the
// TPU kernel; keys past Sk get p = 0 and are never stored.  Query rows
// past S (the ragged last tile) load as zero, with lse and delta 0, so
// their p * dO and ds * q are exactly 0.  The masks come from
// flash_mask.cuh, shared with the forward and dQ kernels.
//
// What bounds it on an H100: at the training shape (N = 8 x 16 heads =
// 128, S = 256, hd 128, bf16, causal) bytes, not operations, for the work
// itself: it reads q, k, v, dO (33.6 MB), lse and delta (0.26 MB) and
// writes dK and dV (16.8 MB), 50.6 MB or 15.1 us at 3.35 TB/s; its four
// products over the causal half, 4 x 2 N hd S(S+1)/2 = 4.3 GFLOP, take
// 4.4 us at the bf16 tensor-core peak.  This first version computes in f32
// FMA from shared memory (no tensor cores, no TMA), as the forward kernel
// does, so it is bound by its FMA rate instead: 256 threads, each holding
// a 4x4 block of the 64x64 transposed score and dP tiles and a 4 x hd/16
// block of dK and of dV; the K, V, Q and dO tiles are stored with a padded
// row stride (hd + 1), the P and dS tiles with stride 65.  At hd 128 that
// is 165,888 bytes of shared memory, one CTA an SM.  Heavier (earlier) key
// tiles launch first, since causal work shrinks with the tile index.
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
constexpr int PS = BQ + 1;          // row stride of the P and dS tiles

template <int HD>
constexpr int smem_bytes() {
    return (2 * BK * (HD + 1) + 2 * BQ * (HD + 1) + 2 * BK * PS + 2 * BQ)
           * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int attention,
                 int window, bool causal, bool glob, float scale) {
    constexpr int QS = HD + 1;      // padded row stride of the K, V, Q, dO tiles
    constexpr int DJ = HD / 16;     // dK/dV columns per thread
    extern __shared__ float smem[];
    float* sK = smem;               // BK x QS
    float* sV = sK + BK * QS;       // BK x QS
    float* sQ = sV + BK * QS;       // BQ x QS
    float* sO = sQ + BQ * QS;       // BQ x QS (dO)
    float* sP = sO + BQ * QS;       // BK x PS (p, transposed: key rows)
    float* sDS = sP + BK * PS;      // BK x PS (ds, transposed)
    float* sL = sDS + BK * PS;      // BQ: lse of the query tile
    float* sD = sL + BQ;            // BQ: delta of the query tile

    const int n = blockIdx.y;
    const int k_start = blockIdx.x * BK;
    const int tid = threadIdx.x;
    const int tx = tid & 15;        // column lane: queries tx+16j, dK/dV cols tx+16jj
    const int ty = tid >> 4;        // row lane: key rows ty+16i
    const size_t q_base = (size_t)n * S * HD;
    const size_t k_base = (size_t)n * Sk * HD;

    const int k_live = min(Sk - k_start, BK);
    flash::load_tile<T, HD, BK, QS, THREADS>(sK, k + k_base + (size_t)k_start * HD, k_live, tid);
    flash::load_tile<T, HD, BK, QS, THREADS>(sV, v + k_base + (size_t)k_start * HD, k_live, tid);
    float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

    const int nq = (S + BQ - 1) / BQ;
    for (int qt = causal ? k_start / BQ : 0; qt < nq; ++qt) {
        const int q_start = qt * BQ;
        if (!flash::reachable(attention, window, causal, glob, q_start, BQ, k_start, BK))
            continue;
        __syncthreads();            // the previous tile's Q, dO, P and dS are consumed
        const int q_live = min(S - q_start, BQ);
        flash::load_tile<T, HD, BQ, QS, THREADS>(sQ, q + q_base + (size_t)q_start * HD, q_live,
                                                 tid);
        flash::load_tile<T, HD, BQ, QS, THREADS>(sO, dout + q_base + (size_t)q_start * HD,
                                                 q_live, tid);
        for (int r = tid; r < BQ; r += THREADS) {
            sL[r] = r < q_live ? lse[(size_t)n * S + q_start + r] : 0.f;
            sD[r] = r < q_live ? delta[(size_t)n * S + q_start + r] : 0.f;
        }
        __syncthreads();

        // transposed scores k.q and dP^T = v.dO for this thread's 4x4 block
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float a[4], c[4], b[4], g[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                a[i] = sK[(ty + 16 * i) * QS + d];
                c[i] = sV[(ty + 16 * i) * QS + d];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                b[j] = sQ[(tx + 16 * j) * QS + d];
                g[j] = sO[(tx + 16 * j) * QS + d];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(a[i], b[j], s[i][j]);
                    dp[i][j] = fmaf(c[i], g[j], dp[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kp = k_start + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int ql = tx + 16 * j;
                const int qp = q_start + ql;
                const bool ok = kp < Sk && flash::allowed(attention, window, causal, glob, qp, kp);
                const float p = ok ? expf(s[i][j] * scale - sL[ql]) : 0.f;
                sP[(ty + 16 * i) * PS + ql] = p;
                sDS[(ty + 16 * i) * PS + ql] = p * (dp[i][j] - sD[ql]);
            }
        }
        __syncthreads();

        // dV += P^T . dO and dK += dS^T . Q
#pragma unroll 4
        for (int qq = 0; qq < BQ; ++qq) {
            float p[4], ds[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                p[i] = sP[(ty + 16 * i) * PS + qq];
                ds[i] = sDS[(ty + 16 * i) * PS + qq];
            }
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) {
                const float o = sO[qq * QS + tx + 16 * jj];
                const float x = sQ[qq * QS + tx + 16 * jj];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc_v[i][jj] = fmaf(p[i], o, acc_v[i][jj]);
                    acc_k[i][jj] = fmaf(ds[i], x, acc_k[i][jj]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kr = k_start + ty + 16 * i;
        if (kr >= Sk) continue;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
            const size_t at = k_base + (size_t)kr * HD + tx + 16 * jj;
            flash::store(&dk[at], acc_k[i][jj] * scale);
            flash::store(&dv[at], acc_v[i][jj]);
        }
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int n, int s, int sk, int attention,
           int window, int causal, int glob, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((sk + BK - 1) / BK), (unsigned)n);
    flash_dkv_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, s,
        sk, attention, window, causal != 0, glob != 0, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int n, int s,
                int sk, int attention, int window, int causal, int glob, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, stream);
        case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, stream);
        case 96: return launch<T, 96>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, stream);
        case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q, dout (n, s, hd) and k, v, dk, dv (n, sk, hd) in one dtype (0 = f32,
// 1 = bf16), lse and delta (n, s) f32, all contiguous.  attention: 0 full,
// 1 sliding, 2 chunked (window >= 1); causal and glob are 0 or 1.  The
// caller checks shapes, dtypes and hd in {16, 64, 96, 128}.  With s = 0
// every dK and dV row is written as 0.
extern "C" int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dk, void* dv, int n,
                                          int s, int sk, int hd, int dtype, int attention,
                                          int window, int causal, int glob, void* stream) {
    if (n == 0 || sk == 0) return (int)cudaGetLastError();
    if (s < 0 || attention < FULL || attention > CHUNKED
        || (attention == CHUNKED && window < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, st);
    return (int)cudaErrorInvalidValue;
}
