// K-r dc_mct_fwd and K-s mct_inv_round_clip: the Part-2 array-based
// multiple component transform (T.801 Annex J), forward with the DC level
// shift, inverse with the offsets, rounding and each component's clip.
//
// Replaces: the mct == 2 branches of grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:70-79) and make_inverse_fn (:192-197, with the finish
// :206-217), each an [N, N] float32 matmul over the component axis; held to
// the reference's default host path, tile/tile_processor.py:327-337 (encode)
// and :1599-1602 with :1636-1650 (decode), which compute it as numpy's
// float32 `matrix @ flat` (ops/mct.py:83-89). That product is a sequential
// fused multiply-add chain in k = 0..N-1 in every output, so each output
// here is __fmul_rn(m[o][0], x_0), then __fmaf_rn(m[o][k], x_k, acc) for
// k = 1..N-1: explicit fused operations, which -fmad=false leaves alone
// (the ICT kernels K-j and K-o must not fuse; this one must). The finish of
// K-s is native/pipeline.cpp finish_irrev (:597-611): floor(v + add) with
// add = float32(0.5 + offset), the clip in float before the cast, NaN to
// the low end.
//
// Bound on an H100 (3.35 TB/s): bytes. N int32 (K-r) or float32 (K-s)
// planes in and N planes out, 8N bytes a pixel: 3840x2160x3 moves 199 MB,
// 0.06 ms; the 2N^2 float operations a pixel stay far below the FP32 rate
// for any N the codestream allows. Design: one kernel a direction for every
// N, a grid-stride elementwise pass, neighbouring threads on neighbouring
// samples. A launch's parameters (the plane addresses, the matrix and the
// per-component constants) go to the device in one copy, into the caller's
// scratch, laid out as `Params` says; each output re-reads the pixel's
// inputs (L1 hits after the first) and the matrix through the read-only
// cache. N is at most MAX_COMPS, the reference's own limit (one MCT marker
// segment holds at most 127 x 127 float32 elements).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_COMPS 127

// a launch's parameters in one block of 16 N + 4 N^2 + 12 N bytes: the N
// input and the N output plane addresses (int64), the [N, N] float32
// matrix, row-major, then the per-component constants (K-r: int32 dc [N];
// K-s: float32 add [N], int32 lo [N], int32 hi [N])
struct Params {
    int64_t* ins;
    int64_t* outs;
    float* m;
    int32_t* per;
};

__host__ __device__ static Params carve(void* base, int N) {
    Params p;
    p.ins = (int64_t*)base;
    p.outs = p.ins + N;
    p.m = (float*)(p.outs + N);
    p.per = (int32_t*)(p.m + N * N);
    return p;
}

static size_t params_bytes(int N) { return (size_t)(16 * N + 4 * N * N + 12 * N); }

__device__ __forceinline__ int32_t finish(float v, float add, int lo, int hi) {
    float f = floorf(__fadd_rn(v, add));
    if (!(f > (float)lo)) f = (float)lo;
    if (f > (float)hi) f = (float)hi;
    return (int32_t)f;
}

// K-r
__global__ void mct_fwd(void* params, int64_t n, int N) {
    const Params p = carve(params, N);
    const int64_t* __restrict__ ins = p.ins;
    const int64_t* __restrict__ outs = p.outs;
    const float* __restrict__ m = p.m;
    const int32_t* __restrict__ dc = p.per;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        for (int o = 0; o < N; ++o) {
            const float* row = m + o * N;
            float acc = __fmul_rn(__ldg(row), (float)(((const int32_t*)ins[0])[i] - __ldg(dc)));
            for (int k = 1; k < N; ++k)
                acc = __fmaf_rn(__ldg(row + k),
                                (float)(((const int32_t*)ins[k])[i] - __ldg(dc + k)), acc);
            ((float*)outs[o])[i] = acc;
        }
    }
}

// K-s
__global__ void mct_inv(void* params, int64_t n, int N) {
    const Params p = carve(params, N);
    const int64_t* __restrict__ ins = p.ins;
    const int64_t* __restrict__ outs = p.outs;
    const float* __restrict__ m = p.m;
    const float* __restrict__ add = (const float*)p.per;
    const int32_t* __restrict__ lo = p.per + N;
    const int32_t* __restrict__ hi = p.per + 2 * N;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        for (int o = 0; o < N; ++o) {
            const float* row = m + o * N;
            float acc = __fmul_rn(__ldg(row), ((const float*)ins[0])[i]);
            for (int k = 1; k < N; ++k)
                acc = __fmaf_rn(__ldg(row + k), ((const float*)ins[k])[i], acc);
            ((int32_t*)outs[o])[i] = finish(acc, __ldg(add + o), __ldg(lo + o), __ldg(hi + o));
        }
    }
}

static unsigned grid_for(int64_t n, int threads) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)blocks;
}

// Lays the host arrays out as Params (per: the nper int32-sized arrays of N
// elements each), copies them into the device scratch in one copy and
// launches kernel. A copy from pageable memory returns once the source is
// staged, so the host buffer is freed at once.
static int launch(void (*kernel)(void*, int64_t, int), const int64_t* ins, const int64_t* outs,
                  const float* m, const void* const* per, int nper, void* scratch, int64_t n,
                  int N, void* stream) {
    if (N < 1 || N > MAX_COMPS || !scratch) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const size_t bytes = params_bytes(N);
    void* host = malloc(bytes);
    if (!host) return (int)cudaErrorMemoryAllocation;
    const Params h = carve(host, N);
    memcpy(h.ins, ins, 8 * N);
    memcpy(h.outs, outs, 8 * N);
    memcpy(h.m, m, 4 * N * N);
    for (int j = 0; j < nper; ++j) memcpy(h.per + j * N, per[j], 4 * N);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemcpyAsync(scratch, host, bytes, cudaMemcpyHostToDevice, st);
    free(host);
    if (e) return (int)e;
    const int threads = 256;
    kernel<<<grid_for(n, threads), threads, 0, st>>>(scratch, n, N);
    return (int)cudaGetLastError();
}

// ins/outs: host int64 [N], the planes' addresses (int32 in, float32 out,
// n samples each); m: host float32 [N, N] row-major encoding matrix; dc:
// host int32 [N] DC level shifts; scratch: device memory of 16 N + 4 N^2 +
// 12 N bytes, the wrapper's.
extern "C" int dc_mct_fwd(const int64_t* ins, const int64_t* outs, const float* m,
                          const int32_t* dc, void* scratch, int64_t n, int N, void* stream) {
    const void* per[1] = {dc};
    return launch(mct_fwd, ins, outs, m, per, 1, scratch, n, N, stream);
}

// ins/outs: host int64 [N], the planes' addresses (float32 in, int32 out);
// m: host float32 [N, N] row-major decoding matrix; add: host float32 [N];
// lo, hi: host int32 [N] each component's range; scratch as for dc_mct_fwd.
extern "C" int mct_inv_round_clip(const int64_t* ins, const int64_t* outs, const float* m,
                                  const float* add, const int32_t* lo, const int32_t* hi,
                                  void* scratch, int64_t n, int N, void* stream) {
    const void* per[3] = {add, lo, hi};
    return launch(mct_inv, ins, outs, m, per, 3, scratch, n, N, stream);
}
