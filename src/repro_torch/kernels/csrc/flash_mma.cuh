// Warp-level tensor-core products and asynchronous tile copies shared by the
// three flash-attention kernels of f32 and hd 16: the forward
// (flash_attention_fwd.cu) and the backward pair (flash_attention_dq.cu,
// flash_attention_dkv.cu).
//
// Products are mma.sync on 16 x 8 accumulator tiles with f32 accumulators:
// m16n8k8 TF32 for f32 inputs, m16n8k16 bf16 for bf16 inputs.  In a warp,
// lane = 4 g + t holds rows g and g + 8 of a tile and, of an accumulator
// tile, columns 2t and 2t + 1 (c[0], c[1] in row g; c[2], c[3] in row g + 8).
//
// f32 keeps f32 accuracy by 3xTF32, the split of CUTLASS's fast-f32 warp
// MMA (OpMultiplyAddFastF32): each operand x = big + small with big =
// tf32(x) and small = tf32(x - big), both rounded to nearest (in integer
// operations on the bits), and a product
// is small*big' + big*small' + big*big' (small*small' is below f32's last
// bit).  bf16 operands read from memory are exact; an operand computed in
// f32 registers (P, dS) is split hi = bf16(x), lo = bf16(x - hi) and takes
// two products, as the Hopper pair does; the forward's P, held to a rule
// ten times tighter, in three (from_c3) and takes three.
//
// An A operand made from accumulator tiles (P, dS for the products that
// contract over their columns) keeps its values where they are: for TF32,
// the k slots t and t + 4 of an 8-deep step take columns 2t and 2t + 1, the
// order a thread holds them in, and the B operand of that product is read
// in the same order (load_b_kn); for bf16, two accumulator tiles are one
// 16-deep A operand as they stand.
//
// Shared tiles are row-major with a row stride of HD + PAD elements (16
// bytes of padding).  Fragments of the [n][k] layout, and bf16's of either,
// come from ldmatrix, whose eight 16-byte rows at that stride land on
// distinct banks; f32's [k][n] B operand, which ldmatrix cannot transpose
// (it moves 16-bit elements), from 32-bit loads that the stride puts on 32
// distinct banks too, for every HD taken.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared memory, asynchronously; with
// live false the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Rows [0, ROWS) of an (rows, HD) row-major matrix whose row 0 is ``src``
// into ``dst`` with row stride LD, 16 bytes a copy; rows >= ``live`` are
// zero and never read.  ``src`` itself must lie inside the matrix.
template <typename T, int HD, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int live, int tid) {
    constexpr int VN = 16 / (int)sizeof(T);
    constexpr int VPR = HD / VN;    // copies a row
#pragma unroll
    for (int it = 0; it < (ROWS * VPR + THREADS - 1) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        if (ROWS * VPR % THREADS != 0 && e >= ROWS * VPR) break;
        const int r = e / VPR, c = (e - r * VPR) * VN;
        const bool ok = r < live;
        cp_async16(dst + r * LD + c, ok ? src + (size_t)r * HD + c : src, ok);
    }
}

// ROWS floats from ``src`` (a row of lse or delta); entries >= ``live`` are 0
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int live, int tid) {
    for (int r = tid; r < ROWS; r += THREADS) cp_async4(dst + r, r < live ? src + r : src, r < live);
}

// a named barrier of ``n`` threads (ids from 1; __syncthreads takes 0): the
// writers of shared memory arrive, the readers wait
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// x rounded to TF32's 10 mantissa bits, to nearest (ties away from zero),
// by two integer operations on its bits: an add and a mask at full rate,
// where cvt.rna.tf32.f32 would take the conversion unit
__device__ __forceinline__ uint32_t tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: each lane gives the shared address of one 16-byte row of the
// 8 x 8 (16-bit) matrices, x2 or x4 of them, and receives its 32-bit piece
// of each, in mma's fragment order; .trans transposes 16-bit elements
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

template <typename T> struct Mma;

// f32 inputs: 8-deep TF32 steps, every operand split big + small
template <> struct Mma<float> {
    static constexpr int KS = 8;        // depth of one step
    static constexpr int PAD = 4;       // row padding of the shared tiles
    static constexpr int C_TILES = 1;   // accumulator tiles one step of from_c covers
    struct A { uint32_t big[4], small[4]; };
    struct B { uint32_t big[2], small[2]; };
    using P = A;

    // A: rows g, g + 8 and k columns t, t + 4 of a [m][k] tile whose (0, 0)
    // is s: four 8 x 4 f32 blocks, one ldmatrix.x4
    __device__ __forceinline__ static A load_a(const float* s, int ld, int lane) {
        uint32_t r[4];
        ldsm_x4(r, s + (lane & 15) * ld + (lane >> 4) * 4);
        A a;
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), a.big[i], a.small[i]);
        return a;
    }
    // B: k rows t, t + 4 and column g of a tile stored [n][k]: two blocks
    __device__ __forceinline__ static B load_b_nk(const float* s, int ld, int lane) {
        uint32_t r[2];
        ldsm_x2(r, s + (lane & 7) * ld + ((lane >> 3) & 1) * 4);
        B b;
        split_tf32(__uint_as_float(r[0]), b.big[0], b.small[0]);
        split_tf32(__uint_as_float(r[1]), b.big[1], b.small[1]);
        return b;
    }
    // B: k rows 2t, 2t + 1 (from_c's order) and column g of a tile stored
    // [k][n], by 32-bit loads (ldmatrix transposes 16-bit elements only)
    __device__ __forceinline__ static B load_b_kn(const float* s, int ld, int lane) {
        const int g = lane >> 2, t = lane & 3;
        B b;
        split_tf32(s[2 * t * ld + g], b.big[0], b.small[0]);
        split_tf32(s[(2 * t + 1) * ld + g], b.big[1], b.small[1]);
        return b;
    }
    // A whose k slots t and t + 4 are columns 2t and 2t + 1 of accumulator
    // tile c (its four values)
    __device__ __forceinline__ static P from_c(const float* c) {
        P a;
        split_tf32(c[0], a.big[0], a.small[0]);
        split_tf32(c[2], a.big[1], a.small[1]);
        split_tf32(c[1], a.big[2], a.small[2]);
        split_tf32(c[3], a.big[3], a.small[3]);
        return a;
    }
    __device__ __forceinline__ static void mma(float* d, const A& a, const B& b) {
        mma_tf32(d, a.small, b.big);
        mma_tf32(d, a.big, b.small);
        mma_tf32(d, a.big, b.big);
    }
    // from_c kept to f32's accuracy (the forward's P): 3xTF32 already is
    using P3 = P;
    __device__ __forceinline__ static P3 from_c3(const float* c) { return from_c(c); }
};

// bf16 inputs: 16-deep bf16 steps; P and dS split hi + lo
template <> struct Mma<__nv_bfloat16> {
    using T = __nv_bfloat16;
    static constexpr int KS = 16;
    static constexpr int PAD = 8;
    static constexpr int C_TILES = 2;
    struct A { uint32_t x[4]; };
    struct B { uint32_t x[2]; };
    struct P { A hi, lo; };

    // rows g, g + 8 and k columns 2t, 2t + 1, 2t + 8, 2t + 9 of a [m][k] tile
    __device__ __forceinline__ static A load_a(const T* s, int ld, int lane) {
        A a;
        ldsm_x4(a.x, s + (lane & 15) * ld + (lane >> 4) * 8);
        return a;
    }
    // k rows 2t, 2t + 1, 2t + 8, 2t + 9 and column g of a tile stored [n][k]
    __device__ __forceinline__ static B load_b_nk(const T* s, int ld, int lane) {
        B b;
        ldsm_x2(b.x, s + (lane & 7) * ld + ((lane >> 3) & 1) * 8);
        return b;
    }
    // the same k rows and column g of a tile stored [k][n]
    __device__ __forceinline__ static B load_b_kn(const T* s, int ld, int lane) {
        B b;
        ldsm_x2_trans(b.x, s + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld);
        return b;
    }
    __device__ __forceinline__ static void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        hi = *reinterpret_cast<const uint32_t*>(&h);
        lo = *reinterpret_cast<const uint32_t*>(&l);
    }
    // A whose 16 k slots are the columns of two adjacent accumulator tiles
    // (their eight values, c[0..3] and c[4..7])
    __device__ __forceinline__ static P from_c(const float* c) {
        P a;
        split(c[0], c[1], a.hi.x[0], a.lo.x[0]);
        split(c[2], c[3], a.hi.x[1], a.lo.x[1]);
        split(c[4], c[5], a.hi.x[2], a.lo.x[2]);
        split(c[6], c[7], a.hi.x[3], a.lo.x[3]);
        return a;
    }
    __device__ __forceinline__ static void mma(float* d, const A& a, const B& b) {
        mma_bf16(d, a.x, b.x);
    }
    __device__ __forceinline__ static void mma(float* d, const P& a, const B& b) {
        mma_bf16(d, a.lo.x, b.x);
        mma_bf16(d, a.hi.x, b.x);
    }
    // from_c kept to ~24 bits (the forward's P, whose rule is ten times
    // tighter): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    // three products
    struct P3 { A hi, mid, lo; };
    __device__ __forceinline__ static void split3(float x0, float x1, uint32_t& hi,
                                                  uint32_t& mid, uint32_t& lo) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        split(x0 - hf.x, x1 - hf.y, mid, lo);
        hi = *reinterpret_cast<const uint32_t*>(&h);
    }
    __device__ __forceinline__ static P3 from_c3(const float* c) {
        P3 a;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            split3(c[2 * i], c[2 * i + 1], a.hi.x[i], a.mid.x[i], a.lo.x[i]);
        return a;
    }
    __device__ __forceinline__ static void mma(float* d, const P3& a, const B& b) {
        mma(d, P{a.mid, a.lo}, b);      // lo, then mid
        mma_bf16(d, a.hi.x, b.x);
    }
};

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// two adjacent results of one row, in the output's dtype
__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace flash
