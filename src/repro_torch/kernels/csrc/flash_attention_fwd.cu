// Flash-attention forward on the tensor cores: O = softmax(mask(Q K^T *
// scale)) V and the row log-sum-exp, for (N, S, hd) queries and (N, Sk, hd)
// keys and values.  _fwd_kernel_for sends it f32 at every hd and bf16 at
// hd 16 (bf16 at hd 64-128 goes to the Hopper kernel,
// flash_attention_fwd_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_fwd ->
// pl.pallas_call, _fwd_kernel).  The TPU grid walks (N, S/BQ, S/BK) in
// order on one core and carries m, l and the accumulator in VMEM scratch
// from one K block to the next.  Here one CTA owns (n, a tile of query
// rows) and loops over the key tiles the tile can reach (the test of
// _block_reachable), keeping m, l and the O accumulator in registers;
// CTAs run in parallel over (n, tile), heavier (later, under a causal
// mask) query tiles first.
//
// Numerics follow the TPU kernel: scores, online softmax, P.V and the LSE
// in f32; v is taken in f32; O is cast to the input dtype; LSE = m +
// log(max(l, 1e-30)).  Scores are kept in log2 units (scale * log2(e)
// folded in, 2^x on ex2.approx), so a masked entry scores NEG * log2(e),
// NEG = -1e30 set after scaling (not -inf): a row whose first visited tile
// is fully masked gathers 2^0 = 1 terms that the correction 2^(m_prev -
// m_new) = 0 later wipes exactly.  m starts there too, so no tile computes
// -inf - (-inf).  Columns past Sk (the ragged last tile, which the TPU
// kernel never has) score -inf and add exactly 0; rows past S are zero
// and never stored, so any S and Sk work.  The masks come from
// flash_mask.cuh, shared with the backward kernels; a tile wholly inside
// the mask skips the per-entry test.
//
// What bounds it on an H100 (3.35 TB/s; f32-accurate products at 495 / 3
// = 165 TFLOP/s by 3xTF32, 67 on the FMA units; bf16 989): at (N = 128,
// S = 256, hd 128) causal in f32 it reads q, k, v (50.3 MB) and writes O
// (16.8 MB) and the LSE (0.13 MB): 67.2 MB or 20.1 us; its two products
// over the causal half, 2 x 2 N hd S(S+1)/2 = 2.16 GFLOP, take 13.1 us at
// 165 TFLOP/s (32.2 at 67): bytes bound it.  mma.sync itself reaches ~310
// TFLOP/s of TF32 on an H100 (tools/mma_probe.py), ~103 f32-accurate, so
// the products with the causal tiles' waste need ~26 us there, and the
// splits and the softmax issue as many instructions again.  At the
// wall-clock trainer's (32, 128, 16) it moves 1.06 MB (0.32 us): one
// launch and a few trips to memory are the floor.
//
// The design.  Both products are warp-level mma.sync from shared memory
// (flash_mma.cuh): S = Q K^T with Q the A operand and K the B operand as
// stored ([key][d]), then O += P V with P used where it was computed, in
// the accumulator registers (TF32's k slots t, t + 4 take columns 2t,
// 2t + 1), and V the B operand in the other layout ([k = key][n = d]), as
// the dQ kernel takes dS K.  wgmma is no option for P V in f32: it takes
// TF32 operands K-major only, and V is MN-major there; for S alone it was
// tried (tools/flash_bwd_ab.py, PERF.md) and gained nothing, since the two
// kinds of product share the tensor cores.  f32 keeps its accuracy by
// 3xTF32 (each operand split big + small, three products): one TF32
// product keeps ~3 decimal digits, far too few for the rule's rtol 1e-4
// (tests/test_torch_flash_split.py).  bf16 inputs take m16n8k16 directly;
// P, computed in f32, is split in three bf16 parts (hi, mid, lo) and takes
// three products: hi + lo alone, as the backward splits dS, keeps P to
// ~2^-17 and puts O at 0.16 of its rule, ten times the backward's
// tightness, where three parts keep it at 0.007.  Q's tile and STAGES K/V
// tiles live in shared memory, the K/V tiles filled by cp.async (16 bytes
// a thread, rows past Sk zero-filled without a read): the next reachable
// tiles' copies run under the current tile's products.  A row's max and
// sum reduce over the four lanes of a quad (lane 4g + t holds rows g and
// g + 8).  Two shapes: WIDE, 4 warps of 16 rows each over 16-key tiles
// (64 query rows a CTA; 67.6 KB of shared memory at hd 128 in f32 and at
// most 170 registers a thread, so three CTAs fit on an SM), and DEEP, 4
// warps on the same 16 rows, each taking its 8 (bf16: 16) keys of every
// tile, 4 tiles in flight, whose (m, l, O) the first warp merges in a
// fixed order through shared memory at the end, so a second call repeats
// the first bit for bit.  DEEP runs where WIDE's CTAs would give fewer
// than 8 warps an SM (the trainer's (32, 128, 16): 64 CTAs WIDE, 256
// DEEP).  The grid runs heads fastest, so every head's heaviest causal
// tile launches before any lighter one: launched head by head, the heavy
// tiles of the last heads started late and ran alone at the end (109 us
// against 80 at (128, 256, 128) on an H100; tools/flash_bwd_ab.py).
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
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = flash::NEG * LOG2E;  // a masked score, in log2 units

template <typename T, int HD, bool DEEP>
struct Shape {
    static constexpr int ROW_WARPS = DEEP ? 1 : 4;      // 16 query rows each
    static constexpr int SPLIT = DEEP ? 4 : 1;          // warps on the same rows
    static constexpr int KW = DEEP ? 8 * Mma<T>::C_TILES : 16;  // keys of a tile a warp takes
    static constexpr int MIN_CTAS = DEEP ? 1 : 3;   // CTAs an SM the registers must allow
    static constexpr int WARPS = ROW_WARPS * SPLIT;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int BQ = 16 * ROW_WARPS;   // query rows a CTA
    static constexpr int BK = KW * SPLIT;       // keys a tile
    static constexpr int STAGES = DEEP ? 4 : 2; // K/V tiles in flight
    static constexpr int LD = HD + Mma<T>::PAD; // row stride of the shared tiles
    static constexpr int STAGE = 2 * BK * LD;   // K then V of one tile, elements
    static constexpr int SMEM = (STAGES * STAGE + BQ * LD) * (int)sizeof(T);   // and Q's tile
    // (m, l, O) of the warps past the first of each row block, at the end
    static constexpr int VALS = HD / 2 + 4;     // a lane's O values, m and l
    static constexpr int RED = (SPLIT - 1) * ROW_WARPS * VALS * 32 * (int)sizeof(float);
    static_assert(RED <= SMEM && KW % (8 * Mma<T>::C_TILES) == 0, "shape");
};

template <typename T, int HD, bool DEEP>
__global__ void __launch_bounds__(Shape<T, HD, DEEP>::THREADS, Shape<T, HD, DEEP>::MIN_CTAS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Sk, int attention,
                 int window, bool causal, bool glob, float scale) {
    using M = Mma<T>;
    using Sh = Shape<T, HD, DEEP>;
    constexpr int BQ = Sh::BQ, BK = Sh::BK, LD = Sh::LD, THREADS = Sh::THREADS;
    constexpr int STAGES = Sh::STAGES;
    constexpr int NT = Sh::KW / 8;  // accumulator tiles across a warp's keys of a tile
    constexpr int DT = HD / 8;      // accumulator tiles across O's columns
    constexpr int KSTEPS = HD / M::KS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sKV = reinterpret_cast<T*>(smem_raw);    // STAGES stages of K (BK x LD) then V,
                                                // then Q's tile (BQ x LD)

    // heads vary fastest, so the CTAs launch in order of work: every head's
    // last (under a causal mask, heaviest) query tile first
    const int n = blockIdx.x;
    const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rw = warp % Sh::ROW_WARPS;        // this warp's row block
    const int part = warp / Sh::ROW_WARPS;      // and its slice of each key tile
    const int kw0 = part * Sh::KW;
    const size_t q_base = (size_t)n * S * HD;
    const size_t k_base = (size_t)n * Sk * HD;
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
        T* dst = sKV + stage * Sh::STAGE;
        flash::copy_tile<T, HD, BK, LD, THREADS>(dst, k + at, Sk - kt * BK, tid);
        flash::copy_tile<T, HD, BK, LD, THREADS>(dst + BK * LD, v + at, Sk - kt * BK, tid);
    };

    // Q's tile, read at each use, and with it the first STAGES - 1
    // reachable K/V tiles
    T* sQ = sKV + STAGES * Sh::STAGE;
    const T* aQ = sQ + rw * 16 * LD;
    flash::copy_tile<T, HD, BQ, LD, THREADS>(sQ, q + q_base + (size_t)q_start * HD,
                                             min(S - q_start, BQ), tid);
    int kt = next_tile(0), kl = kt;     // the tile to compute, the last one copied
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st > 0) kl = next_tile(kl + 1);
        if (kl < nk) load_kv(kl, st);
        flash::cp_async_commit();
    }

    // this thread's rows of the tile: r0 and r0 + 8
    const int r0 = rw * 16 + g;
    float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};   // l: this lane's columns only
    float acc[DT * 4];              // accumulator tile c is acc[4c .. 4c + 3]
#pragma unroll
    for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;

    for (int it = 0; kt < nk; ++it) {
        kl = next_tile(kl + 1);
        if (kl < nk) load_kv(kl, (it + STAGES - 1) % STAGES);
        flash::cp_async_commit();
        flash::cp_async_wait<STAGES - 1>(); // this tile's copies have landed
        __syncthreads();
        const T* cK = sKV + it % STAGES * Sh::STAGE + kw0 * LD;   // this warp's keys
        const T* cV = cK + BK * LD;
        const int k_start = kt * BK + kw0;

        // S = Q K^T for this warp's 16 rows and KW keys
        float s[NT * 4];
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            const typename M::A a_q = M::load_a(aQ + ks * M::KS, LD, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j)
                M::mma(&s[4 * j], a_q, M::load_b_nk(cK + j * 8 * LD + ks * M::KS, LD, lane));
        }

        // the online softmax, row by row, in log2 units; P in place of S.
        // A tile wholly inside the mask needs no per-entry test.
        const bool whole = kt * BK + BK <= Sk
                           && flash::inside(attention, window, causal, glob, q_start, BQ,
                                            kt * BK, BK);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qp = q_start + r0 + 8 * h;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    float x = s[4 * j + e] * scale_log2;
                    if (!whole) {
                        const int kp = k_start + j * 8 + 2 * t + (e & 1);
                        if (kp >= Sk) x = -INFINITY;
                        else if (!flash::allowed(attention, window, causal, glob, qp, kp))
                            x = NEG2;
                    }
                    s[4 * j + e] = x;
                    mx = fmaxf(mx, x);
                }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[h], mx);
            const float corr = flash::exp2_approx(m[h] - m_new);
            m[h] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    const float p = flash::exp2_approx(s[4 * j + e] - m_new);
                    s[4 * j + e] = p;
                    sum += p;
                }
            l[h] = l[h] * corr + sum;
#pragma unroll
            for (int c = 0; c < DT; ++c) {
                acc[4 * c + 2 * h] *= corr;
                acc[4 * c + 2 * h + 1] *= corr;
            }
        }

        // O += P V
#pragma unroll
        for (int j = 0; j < NT; j += M::C_TILES) {
            const typename M::P3 a_p = M::from_c3(&s[4 * j]);
#pragma unroll
            for (int c = 0; c < DT; ++c)
                M::mma(&acc[4 * c], a_p, M::load_b_kn(cV + j * 8 * LD + c * 8, LD, lane));
        }
        __syncthreads();                    // this stage is read: a later copy may land in it
        kt = next_tile(kt + 1);
    }
    flash::cp_async_wait<0>();
    if constexpr (Sh::SPLIT > 1) {
        // the row block's warps merge their (m, l, O) in a fixed order: the
        // first warp takes the others' through shared memory
        __syncthreads();                    // every tile is read
        float* red = reinterpret_cast<float*>(smem_raw);
        if (part > 0) {
            float* mine = red + ((part - 1) * Sh::ROW_WARPS + rw) * Sh::VALS * 32;
#pragma unroll
            for (int i = 0; i < DT * 4; ++i) mine[i * 32 + lane] = acc[i];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mine[(DT * 4 + h) * 32 + lane] = m[h];
                mine[(DT * 4 + 2 + h) * 32 + lane] = l[h];
            }
        }
        __syncthreads();
        if (part > 0) return;
        for (int w = 1; w < Sh::SPLIT; ++w) {
            const float* theirs = red + ((w - 1) * Sh::ROW_WARPS + rw) * Sh::VALS * 32;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float mo = theirs[(DT * 4 + h) * 32 + lane];
                const float m_new = fmaxf(m[h], mo);
                const float c0 = flash::exp2_approx(m[h] - m_new);
                const float co = flash::exp2_approx(mo - m_new);
                m[h] = m_new;
                l[h] = l[h] * c0 + theirs[(DT * 4 + 2 + h) * 32 + lane] * co;
#pragma unroll
                for (int c = 0; c < DT; ++c)
#pragma unroll
                    for (int e = 4 * c + 2 * h; e < 4 * c + 2 * h + 2; ++e)
                        acc[e] = acc[e] * c0 + theirs[e * 32 + lane] * co;
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float lsum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
        lsum = fmaxf(lsum + __shfl_xor_sync(0xffffffffu, lsum, 2), 1e-30f);
        const int qr = q_start + r0 + 8 * h;
        if (qr >= S) continue;
        T* row = o + q_base + (size_t)qr * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < DT; ++c)
            flash::store_pair(row + c * 8, acc[4 * c + 2 * h] / lsum,
                              acc[4 * c + 2 * h + 1] / lsum);
        if (t == 0) lse[(size_t)n * S + qr] = m[h] * LN2 + logf(lsum);
    }
}

// the number of SMs of the current device
int sm_count() {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
}

template <typename T, int HD, bool DEEP>
int launch_shape(const void* q, const void* k, const void* v, void* o, float* lse, int n,
                 int s, int sk, int attention, int window, int causal, int glob,
                 cudaStream_t stream) {
    using Sh = Shape<T, HD, DEEP>;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, DEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n, (unsigned)((s + Sh::BQ - 1) / Sh::BQ));
    flash_fwd_kernel<T, HD, DEEP><<<grid, Sh::THREADS, Sh::SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, s, sk, attention, window,
        causal != 0, glob != 0, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

// WIDE where its CTAs give at least 8 warps an SM, DEEP (four times the
// CTAs) below that
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int s,
           int sk, int attention, int window, int causal, int glob, cudaStream_t stream) {
    using Wide = Shape<T, HD, false>;
    const long wide_warps = (long)n * ((s + Wide::BQ - 1) / Wide::BQ) * Wide::WARPS;
    if (wide_warps >= 8L * sm_count())
        return launch_shape<T, HD, false>(q, k, v, o, lse, n, s, sk, attention, window, causal,
                                          glob, stream);
    return launch_shape<T, HD, true>(q, k, v, o, lse, n, s, sk, attention, window, causal,
                                     glob, stream);
}

}  // namespace

// q (n, s, hd), k and v (n, sk, hd), o (n, s, hd) in one dtype (0 = f32 at
// hd 16, 64, 96 or 128; 1 = bf16 at hd 16), all contiguous; lse (n, s)
// f32.  attention: 0 full, 1 sliding, 2 chunked (window >= 1); causal and
// glob are 0 or 1.  The caller checks shapes and dtypes.
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
    if (dtype == 0) {
        switch (hd) {
            case 16: return launch<float, 16>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
            case 64: return launch<float, 64>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
            case 96: return launch<float, 96>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
            case 128: return launch<float, 128>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 1 && hd == 16)
        return launch<__nv_bfloat16, 16>(q, k, v, o, lse, n, s, sk, attention, window, causal, glob, st);
    return (int)cudaErrorInvalidValue;
}
