// Flash-attention backward, dQ, on the tensor cores: for (N, S, hd) tensors
// in f32 or bf16,
//   p  = mask ? exp(q.k * scale - lse) : 0
//   ds = p * (dO.v - delta)
//   dQ = scale * sum over keys of ds * k
// with lse the forward's row log-sum-exp and delta = rowsum(O * dO), both
// (N, S) f32 and computed outside this kernel.  _bwd_kernel_for sends it
// f32 at every hd and bf16 at hd 16 (bf16 at hd 64-128 goes to the Hopper
// pair, flash_attention_dq_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_bwd ->
// pl.pallas_call, _dq_kernel).  The TPU grid walks (N, S/BQ, S/BK) in
// order and carries the dQ accumulator in VMEM from one K block to the
// next.  Here one CTA owns (n, a tile of 32 query rows) and loops over the
// key tiles the tile can reach (the test of _block_reachable), keeping its
// dQ rows in f32 registers: no atomics, no cross-block reduction.  A
// masked entry gets p = 0 (not exp(NEG - lse)), as the TPU kernel; keys
// past Sk get p = 0 and rows past S are zero and never stored, so any S
// works.  The masks come from flash_mask.cuh, shared with the forward and
// dK/dV kernels.  Heavier (later) query tiles launch first, since causal
// work grows with the tile index.
//
// What bounds it on an H100 (3.35 TB/s; f32-accurate products at 495 / 3 =
// 165 TFLOP/s by 3xTF32, 67 on the FMA units; bf16 989): at (N = 128,
// S = 256, hd 128) causal in f32 it reads q, k, v, dO (67.1 MB), lse and
// delta (0.26 MB) and writes dQ (16.8 MB): 84.1 MB or 25.1 us; its three
// products over the causal half, 3 x 2 N hd S(S+1)/2 = 3.23 GFLOP, take
// 19.6 us at 165 TFLOP/s (48.3 at 67): bytes bound it, by little.  At the
// wall-clock trainer's (32, 128, 16) f32 it moves 1.34 MB (0.40 us) for
// 25 MFLOP (0.15 us): one launch and a few trips to memory are the floor.
//
// The design.  Products are warp-level mma.sync from shared memory
// (flash_mma.cuh): S = Q K^T and dP = dO V^T (B read from K and V stored
// [key][d]), then dQ += dS K, where dS is used where it was computed, in
// the accumulator registers, and K is the B operand in the other layout
// ([k = key][n = d]).  wgmma is not an option for f32: it takes TF32
// operands K-major only, and K is MN-major for dS K (the Hopper pair gets
// round that with bf16's MN-major B, which TF32 lacks); mma.sync reads a
// fragment from a padded tile in either layout.  f32 keeps its accuracy
// by 3xTF32 (each operand split big + small, three products): one TF32
// product keeps ~3 decimal digits, too close to the rule's rtol 1e-3, and
// breaks it (tests/test_torch_flash_split.py).  bf16 inputs take m16n8k16
// directly; dS, computed in f32, is split hi + lo for its product.  K and
// V tiles of 32 keys are double-buffered with cp.async (16 bytes a thread,
// rows past Sk zero-filled without a read): the next reachable tile's copy
// runs under the current tile's products.  Each 16-row block of the tile
// has SPLIT warps (4 in f32, 2 in bf16), each taking its slice of every
// key tile, which keeps 16 warps an SM busy where one warp a row block
// left the tensor cores waiting on a single warp's dependent loads and
// products (tools/flash_bwd_ab.py measured 305 us against 137 at the
// shape above); at the end the row block's warps add their partial dQ in
// a fixed order through shared memory, so a second call repeats the first
// bit for bit.  At (32, 128, 16) that is 128 CTAs of 8 warps; shared
// memory is 101 KB at hd 128 in f32, two CTAs an SM.
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
    static constexpr int ROW_WARPS = 2;                 // 16 query rows each
    static constexpr int SPLIT = sizeof(T) == 4 ? 4 : 2;    // warps on the same rows
    static constexpr int WARPS = ROW_WARPS * SPLIT;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int BQ = 16 * ROW_WARPS;   // query rows a CTA
    static constexpr int BK = 32;               // keys a tile
    static constexpr int KW = BK / SPLIT;       // keys of each tile a warp takes
    static constexpr int LD = HD + Mma<T>::PAD; // row stride of the shared tiles
    static constexpr int SMEM = (2 * BQ + 4 * BK) * LD * (int)sizeof(T);
    // the partial dQ of the warps past the first of each row block, at the end
    static constexpr int RED = (SPLIT - 1) * BQ * HD * (int)sizeof(float);
    static_assert(RED <= SMEM && KW % (8 * Mma<T>::C_TILES) == 0, "shape");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<T, HD>::THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int S, int Sk, int attention, int window,
                bool causal, bool glob, float scale) {
    using M = Mma<T>;
    using Sh = Shape<T, HD>;
    constexpr int BQ = Sh::BQ, BK = Sh::BK, LD = Sh::LD, THREADS = Sh::THREADS;
    constexpr int NT = Sh::KW / 8;  // accumulator tiles across a warp's keys of a tile
    constexpr int DT = HD / 8;      // accumulator tiles across dQ's columns
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);     // BQ x LD
    T* sO = sQ + BQ * LD;                       // BQ x LD (dO)
    T* sK = sO + BQ * LD;                       // 2 stages of BK x LD
    T* sV = sK + 2 * BK * LD;                   // 2 stages of BK x LD

    const int n = blockIdx.y;
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rw = warp % Sh::ROW_WARPS;        // this warp's row block
    const int kw0 = warp / Sh::ROW_WARPS * Sh::KW;  // and its first key of each tile
    const size_t q_base = (size_t)n * S * HD;
    const size_t k_base = (size_t)n * Sk * HD;
    const int q_live = min(S - q_start, BQ);
    const int nk = (Sk + BK - 1) / BK;
    const float scale_log2 = scale * LOG2E;

    auto next_tile = [&](int kt) {      // the first reachable key tile from kt on
        while (kt < nk && !flash::reachable(attention, window, causal, glob, q_start, BQ,
                                            kt * BK, BK))
            ++kt;
        return kt;
    };
    auto load_kv = [&](int kt, int stage) {
        const size_t at = k_base + (size_t)kt * BK * HD;
        flash::copy_tile<T, HD, BK, LD, THREADS>(sK + stage * BK * LD, k + at, Sk - kt * BK, tid);
        flash::copy_tile<T, HD, BK, LD, THREADS>(sV + stage * BK * LD, v + at, Sk - kt * BK, tid);
    };

    flash::copy_tile<T, HD, BQ, LD, THREADS>(sQ, q + q_base + (size_t)q_start * HD, q_live, tid);
    flash::copy_tile<T, HD, BQ, LD, THREADS>(sO, dout + q_base + (size_t)q_start * HD, q_live,
                                             tid);
    int kt = next_tile(0);
    if (kt < nk) load_kv(kt, 0);
    flash::cp_async_commit();

    // this thread's rows of the tile: r0 and r0 + 8
    const int r0 = rw * 16 + g;
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        lse2[h] = r < q_live ? lse[(size_t)n * S + q_start + r] * LOG2E : 0.f;
        dlt[h] = r < q_live ? delta[(size_t)n * S + q_start + r] : 0.f;
    }
    float acc[DT * 4];              // accumulator tile c is acc[4c .. 4c + 3]
#pragma unroll
    for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;

    const T* aQ = sQ + rw * 16 * LD;
    const T* aO = sO + rw * 16 * LD;
    for (int it = 0; kt < nk; ++it) {
        const int kn = next_tile(kt + 1);
        if (kn < nk) load_kv(kn, (it + 1) & 1);
        flash::cp_async_commit();
        flash::cp_async_wait<1>();          // this tile's copies (and Q, dO) have landed
        __syncthreads();
        const T* cK = sK + ((it & 1) * BK + kw0) * LD;     // this warp's keys
        const T* cV = sV + ((it & 1) * BK + kw0) * LD;
        const int k_start = kt * BK + kw0;

        // S = Q K^T and dP = dO V^T for this warp's 16 rows and KW keys
        float s[NT * 4], dp[NT * 4];
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += M::KS) {
            const typename M::A a_q = M::load_a(aQ + d0, LD, lane);
            const typename M::A a_o = M::load_a(aO + d0, LD, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                M::mma(&s[4 * j], a_q, M::load_b_nk(cK + j * 8 * LD + d0, LD, lane));
                M::mma(&dp[4 * j], a_o, M::load_b_nk(cV + j * 8 * LD + d0, LD, lane));
            }
        }

        // dS, in place of S
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1;
                const int qp = q_start + r0 + 8 * h;
                const int kp = k_start + j * 8 + 2 * t + (e & 1);
                const bool ok = qp < S && kp < Sk
                                && flash::allowed(attention, window, causal, glob, qp, kp);
                const float p =
                    ok ? flash::exp2_approx(fmaf(s[4 * j + e], scale_log2, -lse2[h])) : 0.f;
                s[4 * j + e] = p * (dp[4 * j + e] - dlt[h]);
            }

        // dQ += dS K
#pragma unroll
        for (int j = 0; j < NT; j += M::C_TILES) {
            const typename M::P a_ds = M::from_c(&s[4 * j]);
#pragma unroll
            for (int c = 0; c < DT; ++c)
                M::mma(&acc[4 * c], a_ds, M::load_b_kn(cK + j * 8 * LD + c * 8, LD, lane));
        }
        __syncthreads();                    // this stage is read: the next copy may land in it
        kt = kn;
    }
    flash::cp_async_wait<0>();
    if constexpr (Sh::SPLIT > 1) {
        // the row block's warps add their partial dQ in a fixed order: the
        // first warp takes the others' through shared memory
        __syncthreads();                    // every tile is read
        float* red = reinterpret_cast<float*>(smem_raw);
        const int part = warp / Sh::ROW_WARPS;
        if (part > 0) {
            float* mine = red + ((part - 1) * Sh::ROW_WARPS + rw) * DT * 4 * 32;
#pragma unroll
            for (int i = 0; i < DT * 4; ++i) mine[i * 32 + lane] = acc[i];
        }
        __syncthreads();
        if (part > 0) return;
        for (int o = 1; o < Sh::SPLIT; ++o) {
            const float* theirs = red + ((o - 1) * Sh::ROW_WARPS + rw) * DT * 4 * 32;
#pragma unroll
            for (int i = 0; i < DT * 4; ++i) acc[i] += theirs[i * 32 + lane];
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qr = q_start + r0 + 8 * h;
        if (qr >= S) continue;
        T* row = dq + q_base + (size_t)qr * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < DT; ++c)
            flash::store_pair(row + c * 8, acc[4 * c + 2 * h] * scale,
                              acc[4 * c + 2 * h + 1] * scale);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int n, int s, int sk, int attention, int window,
           int causal, int glob, cudaStream_t stream) {
    using Sh = Shape<T, HD>;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((s + Sh::BQ - 1) / Sh::BQ), (unsigned)n);
    flash_dq_kernel<T, HD><<<grid, Sh::THREADS, Sh::SMEM, stream>>>(
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
