// Flash-attention forward for Hopper (sm_90a): O = softmax(mask(Q K^T * scale)) V
// and the row log-sum-exp, for (N, S, hd) bf16 tensors, hd 64, 96 or 128, with
// wgmma on the tensor cores and TMA loads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:123 (_fwd ->
// pl.pallas_call, _fwd_kernel) for every bf16 launch at those head widths;
// flash_attention_fwd.cu keeps f32 and hd 16.  It computes what that kernel
// computes, with its numeric contract: a masked score is NEG = -1e30 (not
// -inf), a key past Sk scores -inf and adds exactly 0, the running max, the
// sum and the O accumulator are f32, LSE = m + log(max(l, 1e-30)), O is cast
// to bf16.  The masks are flash::reachable and flash::allowed of
// flash_mask.cuh, shared with the f32 forward and the two backward kernels.
//
// Bound on an H100 SXM: max(4 N S hd * 2 bytes / 3.35 TB/s, 4 hd N pairs /
// 989 TFLOP/s), pairs the (query, key) pairs the mask lets through (S(S+1)/2
// causal); Q K^T and P V are 2 hd flops a pair each.  At the serve and train
// shapes (S 256-4096, hd 128) operations bound it from S ~ 300 up.
//
// Design: one CTA per (n, 128-row query tile), heavier causal tiles launched
// first, over the key tiles of 64 keys from the first a query of the tile can
// reach to the last.
//   * Warpgroups 0 and 1 are consumers, 64 query rows each; warpgroup 2 is the
//     producer, one thread of which issues every TMA load.  setmaxnreg moves
//     registers from the producer (24) to the consumers (240).
//   * TMA loads Q once and K, V per tile into a ring of 3 stages with
//     full/empty mbarriers (K and V have a full barrier each).  The tensor
//     maps are 3-D (hd, rows, N): TMA zero-fills rows past S or Sk and never
//     reads the next head's rows.  Rows are cut into 64-column (128-byte)
//     boxes with the 128-byte swizzle, the layout wgmma reads without bank
//     conflicts; at hd 128 two boxes.  At hd 96 (192 bytes, not a whole number
//     of 128-byte rows) the second box covers columns 64-127, of which TMA
//     zero-fills 96-127: hd 96 shares hd 128's layout and instructions for
//     1/4 more shared memory and P V work (no configuration on a main path
//     has hd 96).  The maps are built on the host for each call.
//   * S = Q K^T: wgmma m64n64k16, A and B from shared memory, both K-major
//     (K stored row-major is K-major for this product), hd/16 k-steps.
//   * The online softmax runs on the accumulator fragment in registers: each
//     thread holds two rows, the four threads of a quad share a row, so the
//     row max is two shuffles; the row sum stays per thread until the end.
//     Scores are carried in log2 units (scale * log2 e in one multiply), so
//     each exponential is one exp2f; LSE = m ln 2 + log(max(l, 1e-30)).
//   * P V with P split: P_hi = bf16(P), P_lo = bf16(P - P_hi), both register-A
//     fragments (the accumulator layout of S is the A layout of P), two wgmma
//     chains m64n{hd}k16 against the same V tile, V the MN-major B operand
//     (the transpose bit), both into the one f32 O fragment.  The stage goes
//     back to the producer when both chains have read V.
//   * A software pipeline inside each consumer: tile t's Q K^T is issued, then
//     tile t-1's P V, and tile t's softmax runs in f32 while P V is on the
//     tensor cores; O is rescaled and tile t's P split into the A fragments
//     only once P V has landed.  (Splitting P earlier into a second pair of
//     fragments and copying them over made ptxas serialize every wgmma.)
//   * Epilogue: O / l cast to bf16 and stored from registers; the LSE by one
//     thread of each quad.
//
// Why P is split: rounding P to bf16 before P V, as FlashAttention-2/3 do,
// puts O many bf16 ulps from the f32 result (tests/test_torch_flash_sm90.py
// emulates this kernel's arithmetic on the CPU: at (4, 512, 128) causal,
// 40,619 of 262,144 outputs fall outside parity.flash_check's one-ulp rule);
// P_hi + P_lo keeps ~16 bits of P and leaves O's own rounding (0.499 ulp).
// The cost: P V is done twice, so the kernel does 1.5x the tensor-core work
// of a bf16-P kernel (3 products of 2 hd flops a pair, not 2).
//
// The PTX wrappers, the wgmma descriptors and the host's tensor maps are in
// sm90.cuh, shared with the backward pair.
//
// Left for later: persistent CTAs over the tiles, the two consumer warpgroups
// in ping-pong so that one's softmax overlaps the other's GEMMs, and native
// GQA (K and V read once per KV head instead of the caller's
// expansion).
#include <math.h>

#include "flash_mask.cuh"
#include "sm90.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;
using flash::NEG;
using namespace sm90;

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
    static constexpr int Q_BYTES = BQ * HDP * 2;
    static constexpr int KV_BYTES = BK * HDP * 2;       // one K or V tile
    static constexpr int BARS = 1 + 3 * STAGES;
    static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

static_assert(BK == 64, "issue_ss's wgmma is m64n64k16");

// O += P_hi V + P_lo V: BK/16 k-steps of 16 keys, V MN-major (LBO: the next
// 64-column box, SBO: the next 8 keys)
template <int HDP>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* p_hi, const uint32_t* p_lo,
                                         uint32_t v_addr) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<HDP>(acc, &p_hi[4 * kk], dv);
        wgmma_rs<HDP>(acc, &p_lo[4 * kk], dv);
    }
}

// the online softmax of one tile on its S fragment (entry i: row row0 +
// 8 ((i % 4) / 2), key k_start + 8 (i / 4) + col0 + i % 2): scale into log2
// units, mask, the new row max m and the correction of what came before,
// then P = exp2(S - m) in place, in f32, and this thread's share of the row
// sums
template <int NS>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* corr, float* rs,
                                             bool interior, int k_start, int row0, int col0,
                                             int Sk, int attention, int window, bool causal,
                                             bool glob, float scale_log2) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int h = (i % 4) / 2;
        float x = sc[i] * scale_log2;
        if (!interior) {
            const int kp = k_start + 8 * (i / 4) + col0 + (i % 2);
            if (kp >= Sk) x = -INFINITY;
            else if (!flash::allowed(attention, window, causal, glob, row0 + 8 * h, kp)) x = NEG;
        }
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float r = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float m_new = fmaxf(m[h], r);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        rs[h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int h = (i % 4) / 2;
        sc[i] = exp2f(sc[i] - m[h]);
        rs[h] += sc[i];
    }
}

// -- the kernel --------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int S, int Sk, int attention, int window,
                      bool causal, bool glob, float scale_log2) {
    using C = Cfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
    uint8_t* sQ = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint8_t* sK = sQ + C::Q_BYTES;                      // STAGES K tiles
    uint8_t* sV = sK + STAGES * C::KV_BYTES;            // STAGES V tiles
    uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * C::KV_BYTES);
    uint64_t* full_k = bar_q + 1;
    uint64_t* full_v = full_k + STAGES;
    uint64_t* empty = full_v + STAGES;

    const int n = blockIdx.y;
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
    // the key tiles [kt_lo, kt_hi] from the first that a query of the CTA can
    // reach to the last (every mask reaches a contiguous run of tiles; one in
    // between that it could not reach would be masked entry by entry)
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
            mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
            for (int b = 0; b < C::NBOX; ++b)
                tma_load(sQ + b * BQ * 128, &tq, bar_q, 64 * b, q_start, n);
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
        constexpr int NS = BK / 2;                      // S fragment: floats a thread
        constexpr int NO = C::HDP / 2;                  // O fragment
        const int wg_start = q_start + 64 * wg;
        const int row0 = wg_start + 16 * (warp % 4) + lane / 4;   // rows row0, row0 + 8
        const int col0 = 2 * (lane % 4);
        const bool mask_is_causal = attention == FULL || glob;    // no window to apply
        const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;

        float acc[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] = 0.f;
        float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};     // l: this thread's share of the row sum
        // a tile needs no mask when every key is below Sk and no query of the
        // warpgroup is before it
        auto interior = [&](int k_start) {
            return mask_is_causal && k_start + BK <= Sk && (!causal || k_start + BK - 1 <= wg_start);
        };

        if (kt_lo < nk) {
            mbar_wait(bar_q, 0);
            // the first tile: S = Q K^T and its softmax
            uint32_t p_hi[NS / 2], p_lo[NS / 2];        // the previous tile's P
            {
                float sc[NS], corr[2];
#pragma unroll
                for (int i = 0; i < NS; ++i) sc[i] = 0.f;
                mbar_wait(&full_k[0], 0);
                wg_fence();
                issue_ss<HD, BQ, BK>(sc, q_addr, smem_u32(sK));
                wg_commit();
                wg_wait<0>();
                fence_regs<NS>(sc);
                softmax_tile<NS>(sc, m, corr, l, interior(kt_lo * BK), kt_lo * BK, row0, col0, Sk,
                                 attention, window, causal, glob, scale_log2);
                split_hi_lo<NS>(sc, p_hi, p_lo);
            }
            // a software pipeline over the rest: tile t's S = Q K^T is issued,
            // then tile t-1's P V; tile t's softmax runs in f32 while P V is on
            // the tensor cores; once P V has landed, O is rescaled and tile t's
            // P is split into the A fragments (not before: P V reads them)
            for (int kt = kt_lo + 1; kt <= kt_hi; ++kt) {
                const int it = kt - kt_lo, s = it % STAGES, prev = (it - 1) % STAGES;
                const uint32_t phase = (it / STAGES) & 1;
                const uint32_t prev_phase = ((it - 1) / STAGES) & 1;
                float sc[NS], corr[2], rs[2];
#pragma unroll
                for (int i = 0; i < NS; ++i) sc[i] = 0.f;
                mbar_wait(&full_k[s], phase);
                mbar_wait(&full_v[prev], prev_phase);
                wg_fence();
                issue_ss<HD, BQ, BK>(sc, q_addr, smem_u32(sK) + s * C::KV_BYTES);
                wg_commit();
                issue_pv<C::HDP>(acc, p_hi, p_lo, smem_u32(sV) + prev * C::KV_BYTES);
                wg_commit();
                wg_wait<1>();                           // S has landed; P V may still run
                fence_regs<NS>(sc);
                softmax_tile<NS>(sc, m, corr, rs, interior(kt * BK), kt * BK, row0, col0, Sk,
                                 attention, window, causal, glob, scale_log2);
                wg_wait<0>();
                fence_regs<NO>(acc);
                fence_regs<NS / 2>(p_hi);
                fence_regs<NS / 2>(p_lo);
                if (lane == 0) mbar_arrive(&empty[prev]);   // this warp has read K and V
#pragma unroll
                for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
                for (int i = 0; i < NO; ++i) acc[i] *= corr[(i % 4) / 2];
                split_hi_lo<NS>(sc, p_hi, p_lo);
            }
            // the last tile's P V
            const int last = (kt_hi - kt_lo) % STAGES;
            mbar_wait(&full_v[last], ((kt_hi - kt_lo) / STAGES) & 1);
            wg_fence();
            issue_pv<C::HDP>(acc, p_hi, p_lo, smem_u32(sV) + last * C::KV_BYTES);
            wg_commit();
            wg_wait<0>();
            fence_regs<NO>(acc);
            fence_regs<NS / 2>(p_hi);
            fence_regs<NS / 2>(p_lo);
        }

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float lt = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
            lt += __shfl_xor_sync(0xffffffffu, lt, 2);
            const float lsum = fmaxf(lt, 1e-30f);
            const int qr = row0 + 8 * h;
            if (qr >= S) continue;
            __nv_bfloat16* orow = o + (static_cast<size_t>(n) * S + qr) * HD;
#pragma unroll
            for (int j = 0; j < C::HDP / 8; ++j) {
                const int c = 8 * j + col0;
                if (c < HD)
                    *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
                        acc[4 * j + 2 * h] / lsum, acc[4 * j + 2 * h + 1] / lsum);
            }
            if (lane % 4 == 0)
                lse[static_cast<size_t>(n) * S + qr] = m[h] * 0.69314718055994531f + logf(lsum);
        }
    }
}

// -- host side ---------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int s,
           int sk, int attention, int window, int causal, int glob, cudaStream_t stream) {
    using C = Cfg<HD>;
    auto kernel = flash_fwd_sm90_kernel<HD>;
    // once per instance: the shared memory, and a register file large enough
    // for setmaxnreg's shares
    static int ready = -1;
    if (ready < 0) {
        const int rc = configure(kernel, C::SMEM, THREADS, PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
        if (rc != 0) return rc;
        ready = 1;
    }
    CUtensorMap tq, tk, tv;
    int rc = make_map(&tq, q, HD, s, n, BQ);
    if (rc == 0) rc = make_map(&tk, k, HD, sk, n, BK);
    if (rc == 0) rc = make_map(&tv, v, HD, sk, n, BK);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)n);
    kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, (__nv_bfloat16*)o, lse, s, sk,
                                               attention, window, causal != 0, glob != 0,
                                               1.4426950408889634f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

}  // namespace

// q (n, s, hd), k and v (n, sk, hd), o (n, s, hd), all bf16, contiguous and
// 16-byte aligned; lse (n, s) f32.  hd 64, 96 or 128; attention: 0 full,
// 1 sliding, 2 chunked (window >= 1); causal and glob 0 or 1.  The caller
// checks shapes and dtypes.
extern "C" int flash_attention_fwd_sm90_launch(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int n, int s, int sk, int hd,
                                               int attention, int window, int causal, int glob,
                                               void* stream) {
    if (n == 0 || s == 0) return (int)cudaGetLastError();
    if (sk < 1 || attention < FULL || attention > CHUNKED || (attention == CHUNKED && window < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 64: return launch<64>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
        case 96: return launch<96>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
        case 128: return launch<128>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
