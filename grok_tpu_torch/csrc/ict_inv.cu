// K-o ict_inv_dc_round_clip: inverse irreversible colour transform (T.800
// G.3), inverse DC level shift, rounding and the clip to each component's
// range, float32 in, int32 out.
//
// Replaces: the irreversible tail of grok_tpu/ops/jax_pipeline.py
// make_inverse_fn (:198-217), an XLA elementwise fusion over ops/mct.py
// ict_inverse (:56), floor(a + 0.5 + offset) and the clip; held to the host
// path's native/pipeline.cpp ict_finish and finish_irrev (:597-611).
//
// Bound on an H100 (3.35 TB/s): bytes. Three float32 planes in, three int32
// planes out, 24 bytes per pixel: 3840x2160 moves 199 MB, 0.06 ms. Design:
// K-h's fused grid-stride pass (rct_inv.cu), neighbouring threads on
// neighbouring samples. r = y + 1.402 cr, g = (y - 0.344136 cb) - 0.714136 cr,
// b = y + 1.772 cb, then floor(v + add) with add = float32(0.5 + dc), every
// product and sum rounded on its own (__fmul_rn/__fadd_rn; built with
// -fmad=false), as the host path does. The clip happens in float before the
// cast, and NaN gives the low end: if !(v > lo) v = lo. Components without
// the ICT (fewer than three, mct = 0, or past the third) take the rounding
// and clip alone (ict = 0, plane 0 only).

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int32_t finish(float v, float add, int lo, int hi) {
    float f = floorf(__fadd_rn(v, add));
    if (!(f > (float)lo)) f = (float)lo;
    if (f > (float)hi) f = (float)hi;
    return (int32_t)f;
}

template <bool ICT>
__global__ void ict_inv_kernel(const float* __restrict__ in0, const float* __restrict__ in1,
                               const float* __restrict__ in2, int32_t* __restrict__ out0,
                               int32_t* __restrict__ out1, int32_t* __restrict__ out2,
                               int64_t n, float add0, int lo0, int hi0, float add1, int lo1,
                               int hi1, float add2, int lo2, int hi2) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const float y = in0[i];
        if (ICT) {
            const float cb = in1[i], cr = in2[i];
            const float r = __fadd_rn(y, __fmul_rn(1.402f, cr));
            const float g = __fadd_rn(__fadd_rn(y, __fmul_rn(-0.344136f, cb)),
                                      __fmul_rn(-0.714136f, cr));
            const float b = __fadd_rn(y, __fmul_rn(1.772f, cb));
            out0[i] = finish(r, add0, lo0, hi0);
            out1[i] = finish(g, add1, lo1, hi1);
            out2[i] = finish(b, add2, lo2, hi2);
        } else {
            out0[i] = finish(y, add0, lo0, hi0);
        }
    }
}

// in: float32 [n] planes; out: int32 [n] planes; per plane add, lo, hi.
extern "C" int ict_inv_dc_round_clip(const void* in0, const void* in1, const void* in2,
                                     void* out0, void* out1, void* out2, int64_t n,
                                     float add0, int lo0, int hi0, float add1, int lo1,
                                     int hi1, float add2, int lo2, int hi2, int ict,
                                     void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (ict)
        ict_inv_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            (const float*)in0, (const float*)in1, (const float*)in2, (int32_t*)out0,
            (int32_t*)out1, (int32_t*)out2, n, add0, lo0, hi0, add1, lo1, hi1, add2, lo2,
            hi2);
    else
        ict_inv_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            (const float*)in0, nullptr, nullptr, (int32_t*)out0, nullptr, nullptr, n,
            add0, lo0, hi0, 0.0f, 0, 0, 0.0f, 0, 0);
    return (int)cudaGetLastError();
}
