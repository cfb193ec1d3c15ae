// Flash-attention backward, dK and dV, for Hopper (sm_90a): for (N, S, hd)
// bf16 tensors, hd 64, 96 or 128,
//   p  = mask ? exp(q.k * scale - lse) : 0
//   dV = sum over queries of p * dO
//   ds = p * (dO.v - delta)
//   dK = scale * sum over queries of ds * q
// with lse the forward's row log-sum-exp and delta = rowsum(O * dO), both
// (N, S) f32 and computed outside this kernel; wgmma on the tensor cores and
// TMA loads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:255 (_bwd ->
// pl.pallas_call, _dkv_kernel) for every bf16 launch at those head widths;
// flash_attention_dkv.cu keeps f32 and hd 16.  Its numeric contract is that
// of flash_attention_bwd_plain: a masked entry, a key past Sk and a query
// past S give p = 0, keys past Sk are never stored, and dK and dV are summed
// in f32 in one CTA (no atomics: the result is deterministic).  The masks
// are flash::reachable and flash::allowed of flash_mask.cuh.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 4 products x 2 hd flops a
// reachable (query, key) pair / 989 TFLOP/s); bytes = q, k, v, dO read, dK
// and dV written (6 N S hd x 2) plus lse and delta.  At the training shape
// (128, 256, 128) causal bytes bound it (15.1 us), at (32, 4096, 128)
// operations.
//
// Design: one CTA per (n, 64-key tile), heavier (earlier) causal tiles
// launched first, over the query tiles of 64 rows that can reach the key
// tile; under a causal mask they start at its own diagonal.
//   * Warpgroup 0 accumulates dV, warpgroup 1 dK, each for all 64 keys;
//     warpgroup 2 is the producer (setmaxnreg 24/240): one thread issues every
//     TMA load, and its second warp copies each query tile's LSE (times
//     log2 e) and delta into the stage, 0 past S.  A stage's full barrier
//     waits for the TMA bytes and for that warp's 32 arrivals.
//   * K and V are loaded once; Q and dO per query tile into a 3-stage ring.
//     3-D tensor maps (hd, rows, N) with the 128-byte swizzle zero-fill rows
//     past S or Sk; hd 96 is two 64-column boxes.
//   * S^T = K Q^T (both warpgroups) and dP^T = V dO^T (warpgroup 1): wgmma
//     m64n64k16 from shared memory.
//   * Per thread, on the accumulator fragments, with LSE and delta broadcast
//     along the columns (queries): P^T = exp2(S^T scale log2 e - LSE log2 e),
//     0 where masked, and (warpgroup 1) dS^T = P^T (dP^T - delta).
//   * dV += P^T_hi dO + P^T_lo dO, or dK += dS^T_hi Q + dS^T_lo Q: split into
//     bf16 hi/lo, register-A wgmma m64n{hd}k16 with dO or Q the MN-major B
//     operand (the transpose bit).  The stage goes back to the producer when
//     both warpgroups have read it.
//   * Epilogue: dV, and dK scale, cast to bf16, stored from registers.
//
// Why one warpgroup a gradient: a warpgroup that holds both dK and dV of its
// 64 keys (hd f32 registers a thread, 128 at hd 128) besides S^T, dP^T and
// the four hi/lo fragments spilled under ptxas and had its wgmmas
// serialized (C7512), even with the query tile taken in halves.  Split by
// gradient, a warpgroup holds at most hd/2 + 96 registers of fragments, and
// S^T is computed twice: 7 products a pair against the bound's 4.  A
// software pipeline inside each warpgroup (the next tile's score products in
// flight with this tile's dV or dK product) made ptxas serialize the wgmmas
// again, and was slower; it is left out.
//
// Why P and dS are split: rounded to bf16 alone, they put 120 dQ, 214 dK and
// 15,710 dV of 262,144 each beyond parity.flash_bwd_check's one-ulp rule at
// (4, 512, 128) causal, up to 36,708 ulp; split, none (0.494 ulp)
// (tests/test_torch_flash_bwd_sm90.py emulates this arithmetic).
//
// Left for later: persistent CTAs, native GQA (dK and dV summed over a KV
// head's query heads).
#include <math.h>

#include "flash_mask.cuh"
#include "sm90.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;
using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;

// one CTA: BKV keys, warpgroup 0 accumulating their dV and warpgroup 1 their
// dK, over tiles of BQ queries
constexpr int BKV = 64;
constexpr int BQ = 64;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 3;                               // Q/dO ring depth
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int HD>
struct Cfg {
    static constexpr int HDP = HD <= 64 ? 64 : 128;     // head width in shared memory
    static constexpr int NBOX = HDP / 64;               // 64-column TMA boxes a row
    static constexpr int KV_BYTES = BKV * HDP * 2;      // K, and V
    static constexpr int QT_BYTES = BQ * HDP * 2;       // one Q or dO tile
    static constexpr int ROWS_BYTES = STAGES * BQ * 4;  // LSE (or delta) of each stage
    static constexpr int BARS = 1 + 2 * STAGES;
    static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * QT_BYTES + 2 * ROWS_BYTES
                                + 8 * BARS;
};

static_assert(BQ == 64 && BKV == 64, "issue_ss's wgmma is m64n64k16");

// acc += hi B + lo B: BQ/16 k-steps of 16 queries, B (dO or Q) MN-major (LBO:
// the next 64-column box, SBO: the next 8 queries)
template <int HDP>
__device__ __forceinline__ void issue_split(float* acc, const uint32_t* hi, const uint32_t* lo,
                                            uint32_t b_addr) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t db = sw128_desc(b_addr + kk * 16 * 128, BQ * 128, 1024);
        wgmma_rs<HDP>(acc, &hi[4 * kk], db);
        wgmma_rs<HDP>(acc, &lo[4 * kk], db);
    }
}

// P^T of one query tile in place of its S^T fragment (entry i: key row0 + 8
// ((i % 4) / 2), query q_start + 8 (i / 4) + col0 + i % 2), with lse2 the
// tile's rows in shared memory: p = exp2(S^T scale_log2 - lse2), 0 where
// masked or past S or Sk
template <int NS>
__device__ __forceinline__ void p_tile(float* sc, const float* lse2, bool interior, int q_start,
                                       int row0, int col0, int S, int Sk, int attention,
                                       int window, bool causal, bool glob, float scale_log2) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i / 4) + col0 + (i % 2);
        float p = exp2f(sc[i] * scale_log2 - lse2[c]);
        if (!interior) {
            const int qp = q_start + c, kp = row0 + 8 * ((i % 4) / 2);
            if (qp >= S || kp >= Sk || !flash::allowed(attention, window, causal, glob, qp, kp))
                p = 0.f;
        }
        sc[i] = p;
    }
}

// One consumer warpgroup over the query tiles [qt_lo, qt_hi]: DK false
// accumulates dV += P^T_hi dO + P^T_lo dO, DK true dK += dS^T_hi Q + dS^T_lo Q
// with dS^T = P^T (dP^T - delta); then stores its 64 rows (dK times scale),
// those below Sk.
template <int HD, bool DK>
__device__ __forceinline__ void consume(uint8_t* sK, uint8_t* sV, uint8_t* sQ, uint8_t* sDO,
                                        const float* sL, const float* sD, uint64_t* bar_kv,
                                        uint64_t* full, uint64_t* empty,
                                        __nv_bfloat16* __restrict__ out, float out_scale, int n,
                                        int k_start, int qt_lo, int qt_hi, int S, int Sk,
                                        int attention, int window, bool causal, bool glob,
                                        float scale_log2) {
    using C = Cfg<HD>;
    constexpr int NS = BQ / 2;                          // S^T and dP^T fragments: floats a thread
    constexpr int NO = C::HDP / 2;                      // dK or dV fragment
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int row0 = k_start + 16 * warp + lane / 4;    // keys row0, row0 + 8
    const int col0 = 2 * (lane % 4);
    const bool mask_is_causal = attention == FULL || glob;    // no window to apply
    const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    // a tile needs no mask when every query is below S, every key below Sk,
    // and no key after a query
    auto interior = [&](int q_start) {
        return mask_is_causal && q_start + BQ <= S && k_start + BKV <= Sk
               && (!causal || k_start + BKV - 1 <= q_start);
    };

    if (qt_lo <= qt_hi) {
        mbar_wait(bar_kv, 0);
        for (int qt = qt_lo; qt <= qt_hi; ++qt) {
            const int it = qt - qt_lo, s = it % STAGES;
            const uint32_t phase = (it / STAGES) & 1;
            const uint32_t q_addr = smem_u32(sQ) + s * C::QT_BYTES;
            const uint32_t do_addr = smem_u32(sDO) + s * C::QT_BYTES;
            float sc[NS], dp[NS];
#pragma unroll
            for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
            mbar_wait(&full[s], phase);
            wg_fence();
            issue_ss<HD, BKV, BQ>(sc, opaque(k_addr), q_addr);
            if constexpr (DK) issue_ss<HD, BKV, BQ>(dp, opaque(v_addr), do_addr);
            wg_commit();
            wg_wait<0>();
            fence_regs<NS>(sc);
            if constexpr (DK) fence_regs<NS>(dp);
            p_tile<NS>(sc, sL + s * BQ, interior(qt * BQ), qt * BQ, row0, col0, S, Sk, attention,
                       window, causal, glob, scale_log2);
            uint32_t hi[NS / 2], lo[NS / 2];
            if constexpr (DK) {
#pragma unroll
                for (int i = 0; i < NS; ++i) sc[i] *= dp[i] - sD[s * BQ + 8 * (i / 4) + col0 + (i % 2)];
                split_hi_lo<NS>(sc, hi, lo);            // dS^T
            } else {
                split_hi_lo<NS>(sc, hi, lo);            // P^T
            }
            wg_fence();
            issue_split<C::HDP>(acc, hi, lo, DK ? q_addr : do_addr);   // dK takes Q, dV dO
            wg_commit();
            wg_wait<0>();
            fence_regs<NO>(acc);
            fence_regs<NS / 2>(hi);
            fence_regs<NS / 2>(lo);
            if (lane == 0) mbar_arrive(&empty[s]);      // this warp has read the stage
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int kr = row0 + 8 * h;
        if (kr >= Sk) continue;
        __nv_bfloat16* row = out + (static_cast<size_t>(n) * Sk + kr) * HD;
#pragma unroll
        for (int j = 0; j < C::HDP / 8; ++j) {
            const int c = 8 * j + col0;
            if (c < HD)
                *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
                    acc[4 * j + 2 * h] * out_scale, acc[4 * j + 2 * h + 1] * out_scale);
        }
    }
}

// -- the kernel --------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                      int Sk, int attention, int window, bool causal, bool glob, float scale,
                      float scale_log2) {
    using C = Cfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
    uint8_t* sK = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint8_t* sV = sK + C::KV_BYTES;
    uint8_t* sQ = sV + C::KV_BYTES;                     // STAGES Q tiles
    uint8_t* sDO = sQ + STAGES * C::QT_BYTES;           // STAGES dO tiles
    float* sL = reinterpret_cast<float*>(sDO + STAGES * C::QT_BYTES);   // STAGES x BQ
    float* sD = sL + STAGES * BQ;                       // STAGES x BQ
    uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sD + STAGES * BQ);
    uint64_t* full = bar_kv + 1;
    uint64_t* empty = full + STAGES;

    const int n = blockIdx.y;
    const int k_start = blockIdx.x * BKV;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
    // the query tiles [qt_lo, qt_hi] from the first that can reach a key of
    // the CTA to the last (every mask reaches a contiguous run of tiles)
    const int nq = (S + BQ - 1) / BQ;
    int qt_lo = 0, qt_hi = nq - 1;
    while (qt_lo < nq && !flash::reachable(attention, window, causal, glob, qt_lo * BQ, BQ, k_start, BKV))
        ++qt_lo;
    while (qt_hi > qt_lo && !flash::reachable(attention, window, causal, glob, qt_hi * BQ, BQ, k_start, BKV))
        --qt_hi;
    if (qt_lo == nq) qt_hi = -1;                        // no query reaches these keys

    if (threadIdx.x == 0) {
        mbar_init(bar_kv, 1);
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1 + 32);                // the TMA thread and the LSE warp
            mbar_init(&empty[s], 4 * CONSUMERS);        // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        reg_dealloc<PRODUCER_REGS>();
        if (threadIdx.x == CONSUMERS * 128 && qt_lo <= qt_hi) {
            // one thread issues the loads
            mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
            for (int b = 0; b < C::NBOX; ++b) {
                tma_load(sK + b * BKV * 128, &tk, bar_kv, 64 * b, k_start, n);
                tma_load(sV + b * BKV * 128, &tv, bar_kv, 64 * b, k_start, n);
            }
            for (int qt = qt_lo; qt <= qt_hi; ++qt) {
                const int it = qt - qt_lo, s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], 2 * C::QT_BYTES);
#pragma unroll
                for (int b = 0; b < C::NBOX; ++b) {
                    tma_load(sQ + s * C::QT_BYTES + b * BQ * 128, &tq, &full[s], 64 * b, qt * BQ, n);
                    tma_load(sDO + s * C::QT_BYTES + b * BQ * 128, &tdo, &full[s], 64 * b, qt * BQ, n);
                }
            }
        } else if (warp == CONSUMERS * 4 + 1) {
            // the second warp copies the query tile's LSE (log2 units) and delta
            const size_t base = static_cast<size_t>(n) * S;
            for (int qt = qt_lo; qt <= qt_hi; ++qt) {
                const int it = qt - qt_lo, s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                for (int j = lane; j < BQ; j += 32) {
                    const int q = qt * BQ + j;
                    sL[s * BQ + j] = q < S ? lse[base + q] * LOG2E : 0.f;
                    sD[s * BQ + j] = q < S ? delta[base + q] : 0.f;
                }
                mbar_arrive(&full[s]);
            }
        }
    } else {
        reg_alloc<CONSUMER_REGS>();
        if (wg == 0)
            consume<HD, false>(sK, sV, sQ, sDO, sL, sD, bar_kv, full, empty, dv, 1.f, n, k_start,
                               qt_lo, qt_hi, S, Sk, attention, window, causal, glob, scale_log2);
        else
            consume<HD, true>(sK, sV, sQ, sDO, sL, sD, bar_kv, full, empty, dk, scale, n, k_start,
                              qt_lo, qt_hi, S, Sk, attention, window, causal, glob, scale_log2);
    }
}

// -- host side ---------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int n, int s, int sk, int attention,
           int window, int causal, int glob, cudaStream_t stream) {
    using C = Cfg<HD>;
    auto kernel = flash_dkv_sm90_kernel<HD>;
    static int ready = -1;
    if (ready < 0) {
        const int rc = configure(kernel, C::SMEM, THREADS, PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
        if (rc != 0) return rc;
        ready = 1;
    }
    CUtensorMap tq, tk, tv, tdo;
    int rc = make_map(&tq, q, HD, s, n, BQ);
    if (rc == 0) rc = make_map(&tdo, dout, HD, s, n, BQ);
    if (rc == 0) rc = make_map(&tk, k, HD, sk, n, BKV);
    if (rc == 0) rc = make_map(&tv, v, HD, sk, n, BKV);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)((sk + BKV - 1) / BKV), (unsigned)n);
    const float scale = 1.0f / sqrtf((float)HD);
    kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dk,
                                               (__nv_bfloat16*)dv, s, sk, attention, window,
                                               causal != 0, glob != 0, scale, scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace

// q, dout (n, s, hd) and k, v, dk, dv (n, sk, hd), all bf16, contiguous and
// 16-byte aligned; lse and delta (n, s) f32.  hd 64, 96 or 128; attention:
// 0 full, 1 sliding, 2 chunked (window >= 1); causal and glob 0 or 1.  The
// caller checks shapes and dtypes.  With s = 0 every dK and dV row is written
// as 0.
extern "C" int flash_attention_dkv_sm90_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dk, void* dv, int n,
                                               int s, int sk, int hd, int attention, int window,
                                               int causal, int glob, void* stream) {
    if (n == 0 || sk == 0) return (int)cudaGetLastError();
    if (s < 0 || attention < FULL || attention > CHUNKED || (attention == CHUNKED && window < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (s == 0) {                                       // no query reaches a key: no tensor map
        const size_t bytes = static_cast<size_t>(n) * sk * hd * 2;
        cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
        if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
        return (int)err;
    }
    switch (hd) {
        case 64: return launch<64>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, st);
        case 96: return launch<96>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, st);
        case 128: return launch<128>(q, k, v, dout, lse, delta, dk, dv, n, s, sk, attention, window, causal, glob, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
