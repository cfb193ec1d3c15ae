// The flat sum tree's level offsets, passed by value to every tree kernel.
//
// Layout (repro_torch/core/sumtree.py): one flat f32 array, levels
// top-down at offsets off[0..n_levels-1]; level 0 is the padded root
// group (root value at tree[0]), level n_levels-1 is the leaf level, and
// off[n_levels] is the end of the leaf level (the scratch slot).  The
// launchers fill it from the n_levels + 1 offsets that
// repro_torch/kernels/_build.py::level_offsets builds.
#pragma once

#include <cuda_runtime.h>

#define REPRO_MAX_LEVELS 40   // K >= 2 and < 2^31 leaves need at most 34 offsets

struct TreeLevels {
    long long off[REPRO_MAX_LEVELS];   // n_levels + 1 entries
    int n_levels;                      // levels including the padded root level
};

// Copies the n_levels + 1 offsets into *lv; false when n_levels is out
// of range (the launcher then returns cudaErrorInvalidValue).
inline bool load_levels(const long long* offsets, int n_levels, TreeLevels* lv) {
    if (n_levels < 2 || n_levels + 1 > REPRO_MAX_LEVELS) return false;
    for (int l = 0; l <= n_levels; ++l) lv->off[l] = offsets[l];
    lv->n_levels = n_levels;
    return true;
}
