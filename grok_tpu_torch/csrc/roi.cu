// K-t roi_up and roi_down: the ROI maxshift of one component's packed
// coefficient plane (T.800 Annex H), in place.
//
// Replaces: grok_tpu/ops/jax_pipeline.py make_forward_fn's upshift
// (:103-104 after the 9/7 quantization, :107-108 on the 5/3 plane) and
// make_inverse_fn's downshift (:168-176); held to the host path,
// tile/tile_processor.py:379-384 with native/pipeline.cpp quant_bands
// (:549, q << shift) on encode and :1487-1500 with native/pipeline.cpp
// roi_unshift (:580-595) on decode. roi_up: a << s, wrapping as the host's
// int32 shift does. roi_down: mag >= 1 << s ? mag >> s : mag with the sign
// kept; |INT32_MIN| stays negative, as in the host's int32 arithmetic, so
// that sample is left as it is. The decoder applies roi_down to HT
// codeblocks only: the Part-1 decoder K-i unshifts in its writeout, in the
// scaled domain (csrc/ebcot_dec.cu).
//
// Bound on an H100 (3.35 TB/s): bytes. One int32 plane read and written,
// 8 bytes a sample: a 3840x2160 component moves 66 MB, 0.02 ms. Design:
// grid-stride elementwise pass, neighbouring threads on neighbouring
// samples. The wrapper takes shifts of 1..30 only.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void roi_up_kernel(int32_t* __restrict__ a, int64_t n, int s) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
        a[i] = (int32_t)((uint32_t)a[i] << s);
}

__global__ void roi_down_kernel(int32_t* __restrict__ a, int64_t n, int s) {
    const int32_t thresh = 1 << s;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const int32_t v = a[i];
        int32_t mag = v < 0 ? (int32_t)(0u - (uint32_t)v) : v;
        if (mag >= thresh) mag >>= s;
        a[i] = v < 0 ? (int32_t)(0u - (uint32_t)mag) : mag;
    }
}

static unsigned grid_for(int64_t n, int threads) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)blocks;
}

// a: int32 [n], shifted in place by s (1..30).
extern "C" int roi_up(void* a, int64_t n, int s, void* stream) {
    if (s < 1 || s > 30) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    roi_up_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>((int32_t*)a, n, s);
    return (int)cudaGetLastError();
}

extern "C" int roi_down(void* a, int64_t n, int s, void* stream) {
    if (s < 1 || s > 30) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    roi_down_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>((int32_t*)a, n, s);
    return (int)cudaGetLastError();
}
