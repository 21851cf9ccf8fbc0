// K-l quant_deadzone and K-m dequant_midbin: per-band dead-zone scalar
// quantization of a Mallat-packed float32 plane (T.800 E.1, encode) and
// its mid-bin reconstruction (E.1.1.2, decode).
//
// Replaces: grok_tpu/ops/jax_pipeline.py make_forward_fn (:96-102), an XLA
// fusion of sign(v) * floor(|v| / step) over the band slices, and
// make_inverse_fn (:177-190), (|q| + 0.5) * step; held to the host path's
// native/pipeline.cpp quant_bands and dequant_bands.
//
// Bound on an H100 (3.35 TB/s): bytes. One 4-byte sample in and one out a
// sample: a 3840x2160x3 image moves 199 MB, 0.06 ms. Design: one launch per
// component over its whole packed plane, one thread a sample in a
// grid-stride loop, neighbouring threads on neighbouring samples. A block
// first copies the band table (at most 3 * 32 + 1 bands of (oy, ox, h, w)
// and a float32 step) into shared memory; each thread then finds its band
// by a scan of the table (the bands tile the plane; a sample in none gets
// 0). The division is IEEE (__fdiv_rn) and the product rounded on its own
// (__fmul_rn; the source is built with -fmad=false), as on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BANDS 128

__device__ __forceinline__ int find_band(const int* rects, int nb, int y, int x) {
    for (int b = 0; b < nb; b++) {
        const int oy = rects[4 * b], ox = rects[4 * b + 1];
        if (y >= oy && y < oy + rects[4 * b + 2] && x >= ox && x < ox + rects[4 * b + 3])
            return b;
    }
    return -1;
}

template <bool QUANT>
__global__ void band_kernel(const void* __restrict__ src, void* __restrict__ dst, int h,
                            int w, const int32_t* __restrict__ rects_g,
                            const float* __restrict__ steps_g, int nb) {
    __shared__ int rects[4 * MAX_BANDS];
    __shared__ float steps[MAX_BANDS];
    for (int i = threadIdx.x; i < 4 * nb; i += blockDim.x) rects[i] = rects_g[i];
    for (int i = threadIdx.x; i < nb; i += blockDim.x) steps[i] = steps_g[i];
    __syncthreads();
    const int64_t n = (int64_t)h * w;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const int y = (int)(i / w), x = (int)(i - (int64_t)y * w);
        const int b = find_band(rects, nb, y, x);
        if (QUANT) {
            const float v = ((const float*)src)[i];
            int32_t q = 0;
            if (b >= 0) {
                q = (int32_t)floorf(__fdiv_rn(fabsf(v), steps[b]));
                if (v < 0) q = -q;
            }
            ((int32_t*)dst)[i] = q;
        } else {
            const int32_t q = ((const int32_t*)src)[i];
            float rec = 0.0f;
            if (b >= 0) {
                const float mag = __int2float_rn(q < 0 ? -q : q);
                rec = mag > 0.0f ? __fmul_rn(__fadd_rn(mag, 0.5f), steps[b]) : 0.0f;
                if (q < 0) rec = -rec;
            }
            ((float*)dst)[i] = rec;
        }
    }
}

static int launch(bool quant, const void* src, void* dst, int h, int w, const void* rects,
                  const void* steps, int nb, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    if (nb < 0 || nb > MAX_BANDS) return (int)cudaErrorInvalidValue;
    const int64_t n = (int64_t)h * w;
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (quant)
        band_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            src, dst, h, w, (const int32_t*)rects, (const float*)steps, nb);
    else
        band_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            src, dst, h, w, (const int32_t*)rects, (const float*)steps, nb);
    return (int)cudaGetLastError();
}

// src float32 [h, w] -> dst int32 [h, w]; rects int32 [nb, 4] (oy, ox, h, w),
// steps float32 [nb]
extern "C" int quant_deadzone(const void* src, void* dst, int h, int w, const void* rects,
                              const void* steps, int nb, void* stream) {
    return launch(true, src, dst, h, w, rects, steps, nb, stream);
}

// src int32 [h, w] -> dst float32 [h, w]
extern "C" int dequant_midbin(const void* src, void* dst, int h, int w, const void* rects,
                              const void* steps, int nb, void* stream) {
    return launch(false, src, dst, h, w, rects, steps, nb, stream);
}
