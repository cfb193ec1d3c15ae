#!/usr/bin/env python3
"""Throughput and latency of the tensor-core instructions the f32 flash
kernels issue, on a GPU: ``mma.sync`` m16n8k8 TF32 (the 3xTF32 products of
``csrc/flash_mma.cuh``) and m16n8k16 bf16, and ``wgmma`` m64n32k8 TF32
with B from shared memory.

    python3 tools/mma_probe.py

Builds a small probe kernel with nvcc into ``build/mma_probe/`` and times
it with CUDA events: each warp runs a loop of instructions into CHAINS
independent accumulators (CHAINS = 1 gives the latency of a dependent
chain, 8 the issue rate) on every SM, 1 to 16 warps an SM.  Prints, per
instruction, the cycles per instruction per SM sub-partition at the SM
clock that ``nvidia-smi`` reads after the run, and the TFLOP/s of the
card.  Inputs are zeros: the rate of an instruction does not depend on
its values.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void tf32_mma(float* out, int iters) {
    float d[CHAINS][4] = {};
    uint32_t a[4] = {0, 0, 0, 0}, b[2] = {0, 0};
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c)
            asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                         "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                         : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
    if (s != 0.f) out[threadIdx.x] = s;
}

template <int CHAINS>
__global__ void bf16_mma(float* out, int iters) {
    float d[CHAINS][4] = {};
    uint32_t a[4] = {0, 0, 0, 0}, b[2] = {0, 0};
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c)
            asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                         "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                         : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
    if (s != 0.f) out[threadIdx.x] = s;
}

// one warpgroup a CTA: wgmma m64n32k8 tf32, A from registers, B (32 x 8,
// no swizzle) from shared memory, one commit and wait every 16 instructions
__global__ void tf32_wgmma(float* out, int iters) {
    __shared__ __align__(1024) float bsm[32 * 8];
    for (int i = threadIdx.x; i < 32 * 8; i += blockDim.x) bsm[i] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(bsm);
    const uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
                          | ((uint64_t)(256 >> 4) << 32);
    float d[16] = {};
    uint32_t a[4] = {0, 0, 0, 0};
    for (int i = 0; i < iters; ++i) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int c = 0; c < 16; ++c)
            asm volatile(
                "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) s += d[c];
    if (s != 0.f) out[threadIdx.x] = s;
}

extern "C" int probe(int kind, int chains, int blocks, int threads, int iters, float* out,
                     float* ms) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    for (int rep = 0; rep < 2; ++rep) {     // the first launch warms up
        cudaEventRecord(e0);
        if (kind == 2) tf32_wgmma<<<blocks, threads>>>(out, iters);
        else if (kind == 0 && chains == 1) tf32_mma<1><<<blocks, threads>>>(out, iters);
        else if (kind == 0) tf32_mma<8><<<blocks, threads>>>(out, iters);
        else if (chains == 1) bf16_mma<1><<<blocks, threads>>>(out, iters);
        else bf16_mma<8><<<blocks, threads>>>(out, iters);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
    }
    cudaEventElapsedTime(ms, e0, e1);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
    return (int)cudaGetLastError();
}
"""


def main() -> None:
    import torch

    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "mma_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "probe.cu").write_text(SRC)
    lib_path = out_dir / "libprobe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "probe.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(1024, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    rows = []
    for kind, name, flops in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                              (1, "mma.sync m16n8k16 bf16", 2 * 16 * 8 * 16)):
        for chains in (1, 8):
            for warps in (1, 2, 4, 8, 16):
                ms = ctypes.c_float()
                rc = lib.probe(kind, chains, sms, 32 * warps, iters, out.data_ptr(),
                               ctypes.byref(ms))
                assert rc == 0, rc
                n = sms * warps * iters * chains           # instructions issued
                rows.append((name, chains, warps, ms.value, n, n * flops / (ms.value * 1e-3)))
    for warpgroups in (1, 2, 4):
        ms = ctypes.c_float()
        rc = lib.probe(2, 16, sms * warpgroups, 128, iters // 4, out.data_ptr(), ctypes.byref(ms))
        assert rc == 0, rc
        n = sms * warpgroups * (iters // 4) * 16
        rows.append(("wgmma m64n32k8 tf32", 16, 4 * warpgroups, ms.value, n,
                     n * 2 * 64 * 32 * 8 / (ms.value * 1e-3)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    clock_mhz = float(smi.split(",")[-1].split()[0])
    print(f"[card] {smi}")
    for name, chains, warps, ms, n, rate in rows:
        # cycles per instruction per SM sub-partition (4 an SM)
        per_sub = ms * 1e-3 * clock_mhz * 1e6 / (n / sms / 4)
        print(f"[probe] {name}: {chains} chains, {warps} warps an SM (CTAs of them for "
              f"wgmma: a warpgroup each): {ms:.3f} ms, {per_sub:.2f} cycles an instruction a "
              f"sub-partition, {rate / 1e12:.1f} TFLOP/s")


if __name__ == "__main__":
    main()
