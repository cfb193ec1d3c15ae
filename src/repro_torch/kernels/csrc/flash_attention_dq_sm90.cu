// Flash-attention backward, dQ, for Hopper (sm_90a): for (N, S, hd) bf16
// tensors, hd 64, 96 or 128,
//   p  = mask ? exp(q.k * scale - lse) : 0
//   ds = p * (dO.v - delta)
//   dQ = scale * sum over keys of ds * k
// with lse the forward's row log-sum-exp and delta = rowsum(O * dO), both
// (N, S) f32 and computed outside this kernel; wgmma on the tensor cores and
// TMA loads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:237 (_bwd ->
// pl.pallas_call, _dq_kernel) for every bf16 launch at those head widths;
// flash_attention_dq.cu keeps f32 and hd 16.  Its numeric contract is that of
// flash_attention_bwd_plain: a masked entry and a key past Sk give p = 0 (not
// exp(NEG - lse)), rows past S are never stored, and dQ is summed in f32 in
// one CTA (no atomics: the result is deterministic).  The masks are
// flash::reachable and flash::allowed of flash_mask.cuh.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 3 products x 2 hd flops a
// reachable (query, key) pair / 989 TFLOP/s); bytes = q, k, v, dO read, dQ
// written (5 N S hd x 2) plus lse and delta.  At the training shape (128,
// 256, 128) causal bytes bound it (12.6 us), at (32, 4096, 128) operations.
//
// Design: the forward kernel's shape (flash_attention_fwd_sm90.cu) with a
// second score product.  One CTA per (n, 128-row query tile), heavier causal
// tiles launched first, over the key tiles of 64 keys that flash::reachable
// lets through.
//   * Warpgroups 0 and 1 are consumers, 64 query rows each; warpgroup 2 is the
//     producer, one thread of which issues every TMA load (setmaxnreg 24/240).
//   * Q and dO are loaded once; K and V per key tile into a 3-stage ring of
//     full/empty mbarriers.  3-D tensor maps (hd, rows, N) with the 128-byte
//     swizzle zero-fill rows past S or Sk; hd 96 is two 64-column boxes.
//   * S = Q K^T and dP = dO V^T: wgmma m64n64k16, both operands from shared
//     memory (K and V stored row-major are K-major for these products).
//   * Per thread, on the accumulator fragments: P = exp2(S scale log2 e -
//     LSE log2 e), 0 where masked, and dS = P (dP - delta).  LSE and delta are
//     read once from global memory, two rows a thread, as the fragment holds
//     them.
//   * dQ += dS_hi K + dS_lo K: dS split into bf16 hi = bf16(dS) and lo =
//     bf16(dS - hi), register-A wgmma m64n{hd}k16 with K the MN-major B
//     operand (the transpose bit), as the forward reads V.  The stage goes
//     back to the producer when both chains have read K.
//   * Epilogue: dQ scale cast to bf16, stored from registers.
//
// Why dS is split: rounded to bf16 alone, p and ds put 120 dQ, 214 dK and
// 15,710 dV of 262,144 each beyond parity.flash_bwd_check's one-ulp rule at
// (4, 512, 128) causal, up to 36,708 ulp; split, none (0.494 ulp)
// (tests/test_torch_flash_bwd_sm90.py emulates this arithmetic).  The kernel
// does 4 products a pair against the bound's 3.
//
// Left for later: persistent CTAs and native GQA.  A software pipeline inside
// each consumer (the next tile's score products in flight with this tile's
// dS K) holds ~160 registers of fragments; ptxas then serialized the wgmmas
// (C7512) and spilled, and the kernel was slower, so it is left out.
#include <math.h>

#include "flash_mask.cuh"
#include "sm90.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;
using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;

// one CTA: BQ query rows over two consumer warpgroups, tiles of BK keys
constexpr int BQ = 128;
constexpr int BK = 64;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 3;                               // K/V ring depth
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int HD>
struct Cfg {
    static constexpr int HDP = HD <= 64 ? 64 : 128;     // head width in shared memory
    static constexpr int NBOX = HDP / 64;               // 64-column TMA boxes a row
    static constexpr int Q_BYTES = BQ * HDP * 2;        // Q, and dO
    static constexpr int KV_BYTES = BK * HDP * 2;       // one K or V tile
    static constexpr int BARS = 1 + 3 * STAGES;
    static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

static_assert(BK == 64, "issue_ss's wgmma is m64n64k16");

// dQ += dS_hi K + dS_lo K: BK/16 k-steps of 16 keys, K MN-major (LBO: the next
// 64-column box, SBO: the next 8 keys)
template <int HDP>
__device__ __forceinline__ void issue_dsk(float* acc, const uint32_t* ds_hi, const uint32_t* ds_lo,
                                          uint32_t k_addr) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dk = sw128_desc(k_addr + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<HDP>(acc, &ds_hi[4 * kk], dk);
        wgmma_rs<HDP>(acc, &ds_lo[4 * kk], dk);
    }
}

// dS of one key tile in place of its S fragment (entry i: row row0 + 8 ((i %
// 4) / 2), key k_start + 8 (i / 4) + col0 + i % 2): p = exp2(S scale_log2 -
// lse2), 0 where masked or past Sk, then dS = p (dP - delta)
template <int NS>
__device__ __forceinline__ void ds_tile(float* sc, const float* dp, const float* lse2,
                                        const float* delta, bool interior, int k_start, int row0,
                                        int col0, int Sk, int attention, int window, bool causal,
                                        bool glob, float scale_log2) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int h = (i % 4) / 2;
        float p = exp2f(sc[i] * scale_log2 - lse2[h]);
        if (!interior) {
            const int kp = k_start + 8 * (i / 4) + col0 + (i % 2);
            if (kp >= Sk || !flash::allowed(attention, window, causal, glob, row0 + 8 * h, kp))
                p = 0.f;
        }
        sc[i] = p * (dp[i] - delta[h]);
    }
}

// -- the kernel --------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int S, int Sk, int attention, int window,
                     bool causal, bool glob, float scale, float scale_log2) {
    using C = Cfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
    uint8_t* sQ = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint8_t* sDO = sQ + C::Q_BYTES;
    uint8_t* sK = sDO + C::Q_BYTES;                     // STAGES K tiles
    uint8_t* sV = sK + STAGES * C::KV_BYTES;            // STAGES V tiles
    uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * C::KV_BYTES);   // Q and dO
    uint64_t* full_k = bar_q + 1;
    uint64_t* full_v = full_k + STAGES;
    uint64_t* empty = full_v + STAGES;

    const int n = blockIdx.y;
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
    // the key tiles [kt_lo, kt_hi] from the first that a query of the CTA can
    // reach to the last (every mask reaches a contiguous run of tiles)
    const int nk = (Sk + BK - 1) / BK;
    int kt_lo = 0, kt_hi = nk - 1;
    while (kt_lo < nk && !flash::reachable(attention, window, causal, glob, q_start, BQ, kt_lo * BK, BK))
        ++kt_lo;
    while (kt_hi > kt_lo && !flash::reachable(attention, window, causal, glob, q_start, BQ, kt_hi * BK, BK))
        --kt_hi;

    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full_k[s], 1);
            mbar_init(&full_v[s], 1);
            mbar_init(&empty[s], 4 * CONSUMERS);        // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        // producer warpgroup: one thread issues the loads
        reg_dealloc<PRODUCER_REGS>();
        if (threadIdx.x == CONSUMERS * 128 && kt_lo < nk) {
            mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
            for (int b = 0; b < C::NBOX; ++b) {
                tma_load(sQ + b * BQ * 128, &tq, bar_q, 64 * b, q_start, n);
                tma_load(sDO + b * BQ * 128, &tdo, bar_q, 64 * b, q_start, n);
            }
            for (int kt = kt_lo; kt <= kt_hi; ++kt) {
                const int it = kt - kt_lo, s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
                for (int b = 0; b < C::NBOX; ++b)
                    tma_load(sK + s * C::KV_BYTES + b * BK * 128, &tk, &full_k[s], 64 * b, kt * BK, n);
                mbar_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
                for (int b = 0; b < C::NBOX; ++b)
                    tma_load(sV + s * C::KV_BYTES + b * BK * 128, &tv, &full_v[s], 64 * b, kt * BK, n);
            }
        }
    } else {
        // consumer warpgroup wg: query rows [q_start + 64 wg, + 64)
        reg_alloc<CONSUMER_REGS>();
        constexpr int NS = BK / 2;                      // S and dP fragments: floats a thread
        constexpr int NO = C::HDP / 2;                  // dQ fragment
        const int wg_start = q_start + 64 * wg;
        const int row0 = wg_start + 16 * (warp % 4) + lane / 4;   // rows row0, row0 + 8
        const int col0 = 2 * (lane % 4);
        const bool mask_is_causal = attention == FULL || glob;    // no window to apply
        const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;
        const uint32_t do_addr = smem_u32(sDO) + wg * 64 * 128;

        float lse2[2], dl[2];                           // this thread's two rows
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            lse2[h] = r < S ? lse[static_cast<size_t>(n) * S + r] * LOG2E : 0.f;
            dl[h] = r < S ? delta[static_cast<size_t>(n) * S + r] : 0.f;
        }
        float acc[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] = 0.f;
        // a tile needs no mask when every key is below Sk and no query of the
        // warpgroup is before it
        auto interior = [&](int k_start) {
            return mask_is_causal && k_start + BK <= Sk && (!causal || k_start + BK - 1 <= wg_start);
        };

        if (kt_lo < nk) {
            mbar_wait(bar_q, 0);
            for (int kt = kt_lo; kt <= kt_hi; ++kt) {
                const int it = kt - kt_lo, s = it % STAGES;
                const uint32_t phase = (it / STAGES) & 1;
                const uint32_t k_addr = smem_u32(sK) + s * C::KV_BYTES;
                float sc[NS], dp[NS];
#pragma unroll
                for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
                mbar_wait(&full_k[s], phase);
                mbar_wait(&full_v[s], phase);
                wg_fence();
                issue_ss<HD, BQ, BK>(sc, opaque(q_addr), k_addr);
                issue_ss<HD, BQ, BK>(dp, opaque(do_addr), smem_u32(sV) + s * C::KV_BYTES);
                wg_commit();
                wg_wait<0>();
                fence_regs<NS>(sc);
                fence_regs<NS>(dp);
                ds_tile<NS>(sc, dp, lse2, dl, interior(kt * BK), kt * BK, row0, col0, Sk,
                            attention, window, causal, glob, scale_log2);
                uint32_t ds_hi[NS / 2], ds_lo[NS / 2];
                split_hi_lo<NS>(sc, ds_hi, ds_lo);
                wg_fence();
                issue_dsk<C::HDP>(acc, ds_hi, ds_lo, k_addr);
                wg_commit();
                wg_wait<0>();
                fence_regs<NO>(acc);
                fence_regs<NS / 2>(ds_hi);
                fence_regs<NS / 2>(ds_lo);
                if (lane == 0) mbar_arrive(&empty[s]);  // this warp has read K and V
            }
        }

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qr = row0 + 8 * h;
            if (qr >= S) continue;
            __nv_bfloat16* row = dq + (static_cast<size_t>(n) * S + qr) * HD;
#pragma unroll
            for (int j = 0; j < C::HDP / 8; ++j) {
                const int c = 8 * j + col0;
                if (c < HD)
                    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
                        acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
            }
        }
    }
}

// -- host side ---------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int n, int s, int sk, int attention, int window,
           int causal, int glob, cudaStream_t stream) {
    using C = Cfg<HD>;
    auto kernel = flash_dq_sm90_kernel<HD>;
    static int ready = -1;
    if (ready < 0) {
        const int rc = configure(kernel, C::SMEM, THREADS, PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
        if (rc != 0) return rc;
        ready = 1;
    }
    CUtensorMap tq, tk, tv, tdo;
    int rc = make_map(&tq, q, HD, s, n, BQ);
    if (rc == 0) rc = make_map(&tdo, dout, HD, s, n, BQ);
    if (rc == 0) rc = make_map(&tk, k, HD, sk, n, BK);
    if (rc == 0) rc = make_map(&tv, v, HD, sk, n, BK);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)n);
    const float scale = 1.0f / sqrtf((float)HD);
    kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dq, s,
                                               sk, attention, window, causal != 0, glob != 0,
                                               scale, scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq (n, s, hd) and k, v (n, sk, hd), all bf16, contiguous and
// 16-byte aligned; lse and delta (n, s) f32.  hd 64, 96 or 128; attention:
// 0 full, 1 sliding, 2 chunked (window >= 1); causal and glob 0 or 1.  The
// caller checks shapes and dtypes.
extern "C" int flash_attention_dq_sm90_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse,
                                              const float* delta, void* dq, int n, int s, int sk,
                                              int hd, int attention, int window, int causal,
                                              int glob, void* stream) {
    if (n == 0 || s == 0) return (int)cudaGetLastError();
    if (sk < 1 || attention < FULL || attention > CHUNKED || (attention == CHUNKED && window < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 64: return launch<64>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, st);
        case 96: return launch<96>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, st);
        case 128: return launch<128>(q, k, v, dout, lse, delta, dq, n, s, sk, attention, window, causal, glob, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
