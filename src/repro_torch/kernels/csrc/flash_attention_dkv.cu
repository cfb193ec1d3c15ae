// Flash-attention backward, dK and dV, on the tensor cores: for (N, S, hd)
// tensors in f32 or bf16,
//   p  = mask ? exp(q.k * scale - lse) : 0
//   dV = sum over queries of p * dO
//   ds = p * (dO.v - delta)
//   dK = scale * sum over queries of ds * q
// with lse the forward's row log-sum-exp and delta = rowsum(O * dO), both
// (N, S) f32 and computed outside this kernel.  _bwd_kernel_for sends it
// f32 at every hd and bf16 at hd 16 (bf16 at hd 64-128 goes to the Hopper
// pair, flash_attention_dkv_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_bwd ->
// pl.pallas_call, _dkv_kernel).  The TPU grid walks (N, S/BK, S/BQ) in
// order and carries the dK and dV accumulators in VMEM from one Q block to
// the next.  Here one CTA owns (n, a tile of 32 keys) and loops over the
// query tiles that can reach it (the test of _block_reachable; under a
// causal mask they start at the key tile's own row), keeping its dK and
// dV rows in f32 registers: no atomics, no cross-block reduction, and the
// TPU's split into a dQ and a dK/dV kernel stays.  A masked entry gets
// p = 0 (not exp(NEG - lse)), as the TPU kernel; keys past Sk and queries
// past S get p = 0, and keys past Sk are never stored; with S = 0 every
// row is written as 0.  The masks come from flash_mask.cuh, shared with
// the forward and dQ kernels.  Heavier (earlier) key tiles launch first,
// since causal work shrinks with the tile index.
//
// What bounds it on an H100 (3.35 TB/s; f32-accurate products at 495 / 3 =
// 165 TFLOP/s by 3xTF32, 67 on the FMA units; bf16 989): at (N = 128,
// S = 256, hd 128) causal in f32 it reads q, k, v, dO (67.1 MB), lse and
// delta (0.26 MB) and writes dK and dV (33.6 MB): 100.9 MB or 30.1 us;
// its four products over the causal half, 4 x 2 N hd S(S+1)/2 = 4.31
// GFLOP, take 26.1 us at 165 TFLOP/s (64.4 at 67): bytes bound it, by
// little.  At the wall-clock trainer's (32, 128, 16) f32 it moves 1.61 MB
// (0.48 us) for 34 MFLOP (0.20 us; 0.50 at 67): one launch and a few trips
// to memory are the floor.
//
// The design.  Products are warp-level mma.sync from shared memory
// (flash_mma.cuh), on the transposed scores: S^T = K Q^T and dP^T = V dO^T
// (K, V the A operands, 16 keys a warp; B read from Q and dO stored
// [query][d]), then dV += P^T dO and dK += dS^T Q, where P^T and dS^T are
// used where they were computed, in the accumulator registers, and Q and
// dO are the B operands in the other layout ([k = query][n = d]).  wgmma
// is not an option for f32: it takes TF32 operands K-major only, and both
// of these products contract over the query axis, so their B tiles (dO,
// Q) are MN-major (the Hopper pair gets round that with bf16's MN-major B,
// which TF32 lacks); mma.sync reads a fragment from a padded tile in
// either layout.  f32 keeps its accuracy by 3xTF32 (each operand split
// big + small, three products): one TF32 product keeps ~3 decimal digits,
// too close to the rule's rtol 1e-3, and breaks it
// (tests/test_torch_flash_split.py).  bf16 inputs take m16n8k16 directly;
// P^T and dS^T, computed in f32, are split hi + lo for their products.
// The work of 16 keys and a slice of each query tile goes to a pair of
// warps: one computes S^T, P^T and dV, the other dP^T and, with the P^T
// its partner leaves in shared memory behind a named barrier, dS^T and
// dK, so each warp holds one accumulator (hd / 2 registers) and 16 warps
// fit an SM; each query tile is cut into SPLIT slices (4 at hd 16, 2
// above), and at the end the key block's pairs add their partial dK and
// dV in a fixed order through shared memory, so a second call repeats the
// first bit for bit.  One warp holding dK and dV for a whole query tile
// left the tensor cores waiting (tools/flash_bwd_ab.py measured 243 us
// against 153 at the shape above).  Q, dO, lse and delta tiles (32
// queries at hd 96-128, 64 below) are double-buffered with cp.async (16
// bytes a thread for the tiles, 4 for lse and delta; rows past S
// zero-filled without a read): the next reachable query tile's copy runs
// under the current one's products.  At (32, 128, 16) that is 128 CTAs of
// 16 warps; shared memory is 106 KB at hd 128 in f32, two CTAs an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mask.cuh"
#include "flash_mma.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;
using flash::Mma;

constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int HD>
struct Shape {
    static constexpr int KEY_WARPS = 2;                 // 16 keys each
    static constexpr int SPLIT = HD <= 32 ? 4 : 2;      // slices of each query tile
    // a pair of warps for each (16 keys, query slice): one computes P^T and
    // accumulates dV, the other dS^T and dK
    static constexpr int PAIRS = KEY_WARPS * SPLIT;
    static constexpr int WARPS = 2 * PAIRS;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int BK = 16 * KEY_WARPS;   // keys a CTA
    static constexpr int BQ = HD >= 96 ? 32 : 64;   // queries a tile
    static constexpr int QW = BQ / SPLIT;       // queries of each tile a pair takes
    static constexpr int LD = HD + Mma<T>::PAD; // row stride of the shared tiles
    static constexpr int SMEM = (2 * BK + 4 * BQ) * LD * (int)sizeof(T)
                                + (4 * BQ + PAIRS * 16 * QW) * (int)sizeof(float);
    // the partial dK and dV of the pairs past the first of each key block
    static constexpr int RED = (SPLIT - 1) * BK * 2 * HD * (int)sizeof(float);
    static_assert(RED <= SMEM && QW % (8 * Mma<T>::C_TILES) == 0 && PAIRS < 16, "shape");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<T, HD>::THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int attention,
                 int window, bool causal, bool glob, float scale) {
    using M = Mma<T>;
    using Sh = Shape<T, HD>;
    constexpr int BQ = Sh::BQ, BK = Sh::BK, LD = Sh::LD, THREADS = Sh::THREADS;
    constexpr int NT = Sh::QW / 8;  // accumulator tiles across a pair's queries of a tile
    constexpr int DT = HD / 8;      // accumulator tiles across dK's or dV's columns
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sK = reinterpret_cast<T*>(smem_raw);     // BK x LD
    T* sV = sK + BK * LD;                       // BK x LD
    T* sQ = sV + BK * LD;                       // 2 stages of BQ x LD
    T* sO = sQ + 2 * BQ * LD;                   // 2 stages of BQ x LD (dO)
    float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LD);   // 2 stages of BQ: lse
    float* sD = sL + 2 * BQ;                                  // 2 stages of BQ: delta
    float* sP = sD + 2 * BQ;                    // each pair's P^T, 16 x QW

    const int n = blockIdx.y;
    const int k_start = blockIdx.x * BK;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool dk_warp = warp & 1;              // dS^T and dK; else P^T and dV
    const int pair = warp >> 1;
    const int kw = pair % Sh::KEY_WARPS;        // this pair's key block
    const int part = pair / Sh::KEY_WARPS;      // and its slice of each query tile
    const size_t q_base = (size_t)n * S * HD;
    const size_t k_base = (size_t)n * Sk * HD;
    const int nq = (S + BQ - 1) / BQ;
    const float scale_log2 = scale * LOG2E;

    auto next_tile = [&](int qt) {      // the first reachable query tile from qt on
        while (qt < nq && !flash::reachable(attention, window, causal, glob, qt * BQ, BQ,
                                            k_start, BK))
            ++qt;
        return qt;
    };
    auto load_q = [&](int qt, int stage) {
        const int q_start = qt * BQ;
        const size_t at = q_base + (size_t)q_start * HD;
        flash::copy_tile<T, HD, BQ, LD, THREADS>(sQ + stage * BQ * LD, q + at, S - q_start, tid);
        flash::copy_tile<T, HD, BQ, LD, THREADS>(sO + stage * BQ * LD, dout + at, S - q_start,
                                                 tid);
        const size_t row = (size_t)n * S + q_start;
        flash::copy_row<BQ, THREADS>(sL + stage * BQ, lse + row, S - q_start, tid);
        flash::copy_row<BQ, THREADS>(sD + stage * BQ, delta + row, S - q_start, tid);
    };

    flash::copy_tile<T, HD, BK, LD, THREADS>(sK, k + k_base + (size_t)k_start * HD,
                                             Sk - k_start, tid);
    flash::copy_tile<T, HD, BK, LD, THREADS>(sV, v + k_base + (size_t)k_start * HD,
                                             Sk - k_start, tid);
    int qt = next_tile(causal ? k_start / BQ : 0);
    if (qt < nq) load_q(qt, 0);
    flash::cp_async_commit();

    float acc[DT * 4];              // dK or dV; accumulator tile c is acc[4c .. 4c + 3]
#pragma unroll
    for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;

    // this thread's keys of the tile: r0 and r0 + 8
    const int r0 = kw * 16 + g;
    // the first product's A: K for S^T = K Q^T, V for dP^T = V dO^T
    const T* a_rows = (dk_warp ? sV : sK) + kw * 16 * LD;
    float* pt = sP + pair * 16 * Sh::QW;        // P^T, [value][lane] of the P^T warp
    for (int it = 0; qt < nq; ++it) {
        const int qn = next_tile(qt + 1);
        if (qn < nq) load_q(qn, (it + 1) & 1);
        flash::cp_async_commit();
        flash::cp_async_wait<1>();          // this tile's copies (and K, V) have landed
        __syncthreads();
        const int stage = it & 1;
        const T* cQ = sQ + (stage * BQ + part * Sh::QW) * LD;  // this pair's queries
        const T* cO = sO + (stage * BQ + part * Sh::QW) * LD;
        // the first product's B ([query][d]) and the second's ([k = query][d])
        const T* b_first = dk_warp ? cO : cQ;
        const T* b_second = dk_warp ? cQ : cO;

        // S^T (or dP^T) for this pair's 16 keys and QW queries
        float x[NT * 4];
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) x[i] = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += M::KS) {
            const typename M::A a = M::load_a(a_rows + d0, LD, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j)
                M::mma(&x[4 * j], a, M::load_b_nk(b_first + j * 8 * LD + d0, LD, lane));
        }

        // P^T in place of S^T, handed to the pair's other warp; dS^T in
        // place of dP^T
        if (!dk_warp) {
            const float* cL = sL + stage * BQ + part * Sh::QW;
            const int q_start = qt * BQ + part * Sh::QW;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kp = k_start + r0 + 8 * (e >> 1);
                    const int ql = j * 8 + 2 * t + (e & 1);
                    const int qp = q_start + ql;
                    const bool ok = kp < Sk && qp < S
                                    && flash::allowed(attention, window, causal, glob, qp, kp);
                    x[4 * j + e] =
                        ok ? flash::exp2_approx(fmaf(x[4 * j + e], scale_log2, -cL[ql] * LOG2E))
                           : 0.f;
                    pt[(4 * j + e) * 32 + lane] = x[4 * j + e];
                }
            flash::bar_arrive(1 + pair, 64);
        } else {
            const float* cD = sD + stage * BQ + part * Sh::QW;
            flash::bar_sync(1 + pair, 64);
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    x[4 * j + e] = pt[(4 * j + e) * 32 + lane]
                                   * (x[4 * j + e] - cD[j * 8 + 2 * t + (e & 1)]);
        }

        // dV += P^T dO, or dK += dS^T Q
#pragma unroll
        for (int j = 0; j < NT; j += M::C_TILES) {
            const typename M::P a = M::from_c(&x[4 * j]);
#pragma unroll
            for (int c = 0; c < DT; ++c)
                M::mma(&acc[4 * c], a, M::load_b_kn(b_second + j * 8 * LD + c * 8, LD, lane));
        }
        __syncthreads();                    // this stage is read: the next copy may land in it
        qt = qn;
    }
    flash::cp_async_wait<0>();
    if constexpr (Sh::SPLIT > 1) {
        // the key block's pairs add their partial dK and dV in a fixed order:
        // the first pair takes the others' through shared memory
        __syncthreads();                    // every tile is read
        float* red = reinterpret_cast<float*>(smem_raw);
        if (part > 0) {
            float* mine = red + (((part - 1) * Sh::KEY_WARPS + kw) * 2 + dk_warp) * DT * 4 * 32;
#pragma unroll
            for (int i = 0; i < DT * 4; ++i) mine[i * 32 + lane] = acc[i];
        }
        __syncthreads();
        if (part > 0) return;
        for (int o = 1; o < Sh::SPLIT; ++o) {
            const float* theirs =
                red + (((o - 1) * Sh::KEY_WARPS + kw) * 2 + dk_warp) * DT * 4 * 32;
#pragma unroll
            for (int i = 0; i < DT * 4; ++i) acc[i] += theirs[i * 32 + lane];
        }
    }

    T* out = dk_warp ? dk : dv;
    const float sc = dk_warp ? scale : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int kr = k_start + r0 + 8 * h;
        if (kr >= Sk) continue;
        T* row = out + k_base + (size_t)kr * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < DT; ++c)
            flash::store_pair(row + c * 8, acc[4 * c + 2 * h] * sc, acc[4 * c + 2 * h + 1] * sc);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int n, int s, int sk, int attention,
           int window, int causal, int glob, cudaStream_t stream) {
    using Sh = Shape<T, HD>;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((sk + Sh::BK - 1) / Sh::BK), (unsigned)n);
    flash_dkv_kernel<T, HD><<<grid, Sh::THREADS, Sh::SMEM, stream>>>(
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
