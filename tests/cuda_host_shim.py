"""A kernel's device code compiled for the host, for the CPU tests.

There is no nvcc here, so the source of a kernel up to its host entry
points is built by g++ against SHIM, a small stand-in for the CUDA
builtins the kernels use: every CUDA thread is a std::thread, blocks run one
after another, __syncthreads and __syncwarp are barriers, the warp
shuffles (with their width), ballot and any go through a per-warp
exchange array (any type of up to 8 bytes), shared-memory atomics are host
atomics, the float and double intrinsics are the host's IEEE operations
(built without contraction; __fmaf_rn is the C library's fmaf, which
rounds once), a cp.async (__pipeline_memcpy_async) is a
copy at once (a source or destination not aligned to the copy's size
aborts, as the card refuses it), and every __ldg, cp.async source
and global atomicAdd is checked against the buffers of the launch (an
access outside them aborts). A test's harness defines the launch. What this
cannot show: timing, occupancy, and anything nvcc compiles differently
from g++; the `cuda` tests of tests/test_torch_cuda.py hold the card."""

import ctypes
import shutil
import subprocess

import pytest

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
struct dim3_ { unsigned x, y, z; };
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
extern thread_local dim3_ threadIdx, blockIdx;
extern dim3_ blockDim;
template <class T> inline T min(T a, T b) { return a < b ? a : b; }
template <class T> inline T max(T a, T b) { return a > b ? a : b; }
struct Range { const char *lo, *hi; };
extern std::vector<Range> g_ranges;
inline void chk(const void* p, size_t n) {
    const char* c = (const char*)p;
    for (auto& r : g_ranges) if (c >= r.lo && c + n <= r.hi) return;
    fprintf(stderr, "access outside the launch's buffers: %p\n", p);
    abort();
}
template <class T> inline T __ldg(const T* p) { chk(p, sizeof(T)); return *p; }
template <class T> inline T __ldcg(const T* p) { chk(p, sizeof(T)); return *p; }
inline int atomicAdd(int* p, int v) { chk(p, 4); int o = *p; *p = o + v; return o; }
inline unsigned atomicOr(unsigned* p, unsigned v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicOr(unsigned long long* p, unsigned long long v) {
    return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }  // rounds once
inline unsigned __float_as_uint(float v) { unsigned u; memcpy(&u, &v, 4); return u; }
inline float __uint_as_float(unsigned u) { float v; memcpy(&v, &u, 4); return v; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
inline unsigned __brev(unsigned x) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
    return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
    return (unsigned)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    uint64_t v = ((uint64_t)y << 32) | x;
    unsigned r = 0;
    for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
    return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
// cp.async: a checked copy at once; the commit and the wait have nothing to do
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
    if (((uintptr_t)dst | (uintptr_t)src) % n) {
        fprintf(stderr, "cp.async of %zu bytes off alignment: %p to %p\n", n, src, dst);
        abort();
    }
    chk(src, n);
    memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
struct Barrier {
    std::mutex m;
    std::condition_variable cv;
    int n = 0, count = 0, gen = 0;
    void wait() {
        std::unique_lock<std::mutex> l(m);
        int g = gen;
        if (++count == n) { count = 0; ++gen; cv.notify_all(); }
        else cv.wait(l, [&] { return gen != g; });
    }
};
struct Exch { uint64_t v[32]; };
extern thread_local Barrier* t_warp;
extern thread_local Exch* t_exch;
extern Barrier* g_block;
inline void __syncwarp() { t_warp->wait(); }
inline void __syncthreads() { g_block->wait(); }
// the value lane ``src(lane)`` put in, or the lane's own where src is out of the warp
template <class T, class F> inline T exch(T v, F src) {
    static_assert(sizeof(T) <= 8, "shuffles of up to 8 bytes");
    int lane = threadIdx.x & 31;
    uint64_t s = 0;
    memcpy(&s, &v, sizeof(T));
    t_exch->v[lane] = s;
    t_warp->wait();
    int from = src(lane);
    T r = v;
    if (from >= 0 && from < 32) memcpy(&r, &t_exch->v[from], sizeof(T));
    t_warp->wait();
    return r;
}
// shuffles within segments of ``width`` lanes, as CUDA's
template <class T> inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
    return exch(v, [&](int l) { return (l & ~(width - 1)) | (src & (width - 1)); });
}
template <class T> inline T __shfl_up_sync(unsigned, T v, int d, int width = 32) {
    return exch(v, [&](int l) { return (l & (width - 1)) >= d ? l - d : l; });
}
template <class T> inline T __shfl_down_sync(unsigned, T v, int d, int width = 32) {
    return exch(v, [&](int l) { return (l & (width - 1)) + d < width ? l + d : l; });
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
    return exch(v, [&](int l) { return (l ^ m) < ((l & ~(width - 1)) + width) ? l ^ m : l; });
}
inline unsigned __ballot_sync(unsigned, int p) {
    int lane = threadIdx.x & 31; t_exch->v[lane] = p != 0; t_warp->wait();
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= (unsigned)t_exch->v[i] << i;
    t_warp->wait(); return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
"""

# the globals SHIM declares, for a harness to define once
SHIM_GLOBALS = r"""
thread_local dim3_ threadIdx, blockIdx;
dim3_ blockDim;
thread_local Barrier* t_warp;
thread_local Exch* t_exch;
Barrier* g_block;
std::vector<Range> g_ranges;
"""


def build(tmp_dir, source: str, stop: str, harness: str, name: str) -> ctypes.CDLL:
    """g++ of ``source`` (a kernel's .cu text) up to the line that starts
    with ``stop`` (its host entry points), with SHIM and ``harness`` (which
    includes "shim.h" and "kernel.inc"), into a library in tmp_dir. Skips
    the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    body = source[:source.index(stop)]
    body = "\n".join(ln for ln in body.splitlines() if not ln.startswith("#include <cuda_"))
    (tmp_dir / "kernel.inc").write_text(body)
    (tmp_dir / "shim.h").write_text(SHIM)
    (tmp_dir / "harness.cpp").write_text(harness)
    out = tmp_dir / f"lib{name}.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-fPIC", "-shared", "-pthread",
                    "-ffp-contract=off", "-I", str(tmp_dir), "-o", str(out),
                    str(tmp_dir / "harness.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(out))
