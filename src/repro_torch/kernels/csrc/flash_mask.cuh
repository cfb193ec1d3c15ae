// The masks of the flash-attention kernels, shared by the forward
// (flash_attention_fwd.cu) and the two backward kernels
// (flash_attention_dq.cu, flash_attention_dkv.cu), so that the three
// cannot mask differently.  They are _block_reachable and _block_mask of
// the TPU kernels (src/repro/kernels/flash_attention.py), and ``inside``,
// the forward's test for a tile that needs no per-entry mask.
#pragma once

namespace flash {

constexpr float NEG = -1e30f;       // a masked score, as the TPU kernel's NEG

enum Attention { FULL = 0, SLIDING = 1, CHUNKED = 2 };

// _block_reachable: can any query of [q_start, q_start+bq) see any key of
// [k_start, k_start+bk)?
__device__ __forceinline__ bool reachable(int attention, int window, bool causal,
                                          bool glob, int q_start, int bq,
                                          int k_start, int bk) {
    const int q_last = q_start + bq - 1, k_last = k_start + bk - 1;
    bool r = true;
    if (causal) r = r && (k_start <= q_last);
    if (attention == SLIDING) r = r && (glob || k_last > q_start - window);
    if (attention == CHUNKED)
        r = r && (glob || ((k_start / window) <= (q_last / window)
                           && (k_last / window) >= (q_start / window)));
    return r;
}

// Does every query of [q_start, q_start+bq) see every key of
// [k_start, k_start+bk)?  Then the tile needs no per-entry test.
__device__ __forceinline__ bool inside(int attention, int window, bool causal,
                                       bool glob, int q_start, int bq,
                                       int k_start, int bk) {
    const int q_last = q_start + bq - 1, k_last = k_start + bk - 1;
    bool r = true;
    if (causal) r = r && (k_last <= q_start);
    if (attention == SLIDING) r = r && (glob || k_start > q_last - window);
    if (attention == CHUNKED)
        r = r && (glob || (k_start / window == k_last / window
                           && q_start / window == q_last / window
                           && k_start / window == q_start / window));
    return r;
}

// _block_mask for one (query, key) pair; positions are >= 0.
__device__ __forceinline__ bool allowed(int attention, int window, bool causal,
                                        bool glob, int qp, int kp) {
    bool m = true;
    if (causal) m = kp <= qp;
    if (attention == SLIDING) m = m && (glob || kp > qp - window);
    if (attention == CHUNKED) m = m && (glob || (kp / window) == (qp / window));
    return m;
}

}  // namespace flash
