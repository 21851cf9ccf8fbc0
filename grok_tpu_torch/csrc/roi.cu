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
// 8 bytes a sample: a 3840x2160 component moves 66 MB, 0.0198 ms.
//
// Design. roi_up: a vector pass. Each thread shifts 8 samples as two
// independent 16-byte loads and stores, 256 threads a block, neighbouring
// threads on neighbouring vectors, and the grid covers the plane (4,050
// blocks for one 3840x2160 component), so each thread has two 16-byte
// loads in flight where a 4-byte grid-stride loop had one 4-byte load. A
// base that is not 16-byte aligned takes a scalar head of up to 3 samples,
// a count past the last whole vector a scalar tail; the first threads of
// the grid shift those. roi_down: a grid-stride elementwise pass of 4-byte
// loads, neighbouring threads on neighbouring samples. The wrapper takes
// shifts of 1..30 only.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROI_THREADS 256

__device__ __forceinline__ int32_t shl(int32_t v, int s) {
    return (int32_t)((uint32_t)v << s);
}

// a: int32 [n], its first `head` samples before the first 16-byte boundary;
// nvec whole vectors from there, then n - head - 4 * nvec samples of tail
__global__ void __launch_bounds__(ROI_THREADS)
    roi_up_kernel(int32_t* __restrict__ a, int64_t head, int64_t nvec, int64_t n, int s) {
    int4* v = reinterpret_cast<int4*>(a + head);
    const int64_t i0 = (int64_t)blockIdx.x * (2 * ROI_THREADS) + threadIdx.x;
    const int64_t i1 = i0 + ROI_THREADS;
    int4 x0, x1;
    if (i0 < nvec) x0 = v[i0];
    if (i1 < nvec) x1 = v[i1];
    if (i0 < nvec) v[i0] = make_int4(shl(x0.x, s), shl(x0.y, s), shl(x0.z, s), shl(x0.w, s));
    if (i1 < nvec) v[i1] = make_int4(shl(x1.x, s), shl(x1.y, s), shl(x1.z, s), shl(x1.w, s));
    const int64_t g = (int64_t)blockIdx.x * ROI_THREADS + threadIdx.x;
    const int64_t tail0 = head + 4 * nvec;
    if (g < head + (n - tail0)) {
        const int64_t i = g < head ? g : tail0 + (g - head);
        a[i] = shl(a[i], s);
    }
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
    const int64_t mis = ((uintptr_t)a & 15) / 4;  // samples past the last 16-byte boundary
    const int64_t head = mis ? (4 - mis < n ? 4 - mis : n) : 0;
    const int64_t nvec = (n - head) / 4;
    const int64_t blocks = nvec > 0 ? (nvec + 2 * ROI_THREADS - 1) / (2 * ROI_THREADS) : 1;
    roi_up_kernel<<<(unsigned)blocks, ROI_THREADS, 0, (cudaStream_t)stream>>>((int32_t*)a, head,
                                                                            nvec, n, s);
    return (int)cudaGetLastError();
}

extern "C" int roi_down(void* a, int64_t n, int s, void* stream) {
    if (s < 1 || s > 30) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    roi_down_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>((int32_t*)a, n, s);
    return (int)cudaGetLastError();
}
