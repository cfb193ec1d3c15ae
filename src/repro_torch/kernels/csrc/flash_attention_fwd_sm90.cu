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
// Left for later: persistent CTAs over the tiles, the two consumer warpgroups
// in ping-pong so that one's softmax overlaps the other's GEMMs, and native
// GQA (K and V read once per KV head instead of the caller's
// repeat_interleave).
#include <cuda.h>           // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

using flash::CHUNKED;
using flash::FULL;
using flash::NEG;

constexpr long long WAIT_TRAP_CYCLES = 20000000000LL;   // ~10 s: a fault, not a hang

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

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the phase of parity ``parity``.  A wait that
// lasts ~10 s traps, so a broken pipeline faults instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    const long long t0 = clock64();
    while (true) {
        uint32_t done;
        asm volatile("{\n.reg .pred P1;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
                     "selp.b32 %0, 1, 0, P1;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > WAIT_TRAP_CYCLES) __trap();
    }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4, %5}], [%2];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
                    "r"(col), "r"(row), "r"(head)
                 : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16)
           | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of a wgmma's registers (its
// accumulator, or its A fragment, which it reads asynchronously) across the
// wait for it
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R)); }
template <int R>
__device__ __forceinline__ void reg_dealloc() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R)); }

// wgmma m64nNk16, bf16 in, f32 accumulate.  ss: A and B from shared memory,
// both K-major, d = scale_d ? d + A B : A B.  rs: A (four bf16x2 registers) from
// the accumulator-shaped fragment, B MN-major (transpose bit set), d += A B.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
    if constexpr (N == 64) wgmma_rs_n64(d, a, db);
    else wgmma_rs_n128(d, a, db);
}

static_assert(BK == 64, "issue_qk's wgmma is m64n64k16");

// S = Q K^T for one warpgroup's 64 query rows: hd/16 k-steps of 16 columns,
// Q (BQ rows) and K (BK rows) stored as 64-column boxes of 128-byte rows
template <int HD>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;             // 16 columns inside a 128-byte row
        wgmma_ss_n64(sc, sw128_desc(q_addr + (kk / 4) * BQ * 128 + off, 16, 1024),
                     sw128_desc(k_addr + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
    }
}

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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
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

// P (f32, the S fragment's layout) into the bf16 A fragments P_hi = bf16(P)
// and P_lo = bf16(P - P_hi)
template <int NS>
__device__ __forceinline__ void split_p(const float* p, uint32_t* p_hi, uint32_t* p_lo) {
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[i], p[i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[i / 2] = bf16x2_bits(hi);
        p_lo[i / 2] = bf16x2_bits(__floats2bfloat162_rn(p[i] - hf.x, p[i + 1] - hf.y));
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
                issue_qk<HD>(sc, q_addr, smem_u32(sK));
                wg_commit();
                wg_wait<0>();
                fence_regs<NS>(sc);
                softmax_tile<NS>(sc, m, corr, l, interior(kt_lo * BK), kt_lo * BK, row0, col0, Sk,
                                 attention, window, causal, glob, scale_log2);
                split_p<NS>(sc, p_hi, p_lo);
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
                issue_qk<HD>(sc, q_addr, smem_u32(sK) + s * C::KV_BYTES);
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
                split_p<NS>(sc, p_hi, p_lo);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                                 cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                        cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 3-D map (hd, rows, heads) of a contiguous (heads, rows, hd) bf16 tensor,
// read in boxes of 64 columns x box_rows rows, 128-byte swizzle; outside the
// tensor TMA fills zeros.
int make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)rows * hd * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int s,
           int sk, int attention, int window, int causal, int glob, cudaStream_t stream) {
    using C = Cfg<HD>;
    auto kernel = flash_fwd_sm90_kernel<HD>;
    // once per instance: the shared memory, and a register file large enough
    // for setmaxnreg's shares (a shortfall would stall the consumers forever)
    static int ready = -1;
    if (ready < 0) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               C::SMEM);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return (int)err;
        if (attr.numRegs * THREADS < 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS))
            return (int)cudaErrorInvalidConfiguration;
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
