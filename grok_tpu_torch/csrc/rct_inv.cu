// K-h rct_inv_dc_clip: inverse reversible colour transform (T.800 G.2),
// inverse DC level shift and the clip to each component's range.
//
// Replaces: the reversible tail of grok_tpu/ops/jax_pipeline.py
// make_inverse_fn (:198-220), an XLA elementwise fusion over ops/mct.py
// rct_inverse (:41) and the clip to [lo, hi] of each precision.
//
// Bound on an H100 (3.35 TB/s): bytes. Three int32 planes in, three out,
// 24 bytes per pixel: 3840x2160 moves 199 MB, 0.06 ms. Design: one fused
// grid-stride pass, neighbouring threads on neighbouring samples, every
// value read once and written once, in place (each thread reads its three
// samples before it writes them). Components without RCT (fewer than three,
// mct = 0, or past the third) take the shift and clip alone (rct = 0, plane
// 0 only).

#include <cuda_runtime.h>
#include <stdint.h>

template <bool RCT>
__global__ void rct_inv_kernel(int32_t* p0, int32_t* p1, int32_t* p2, int64_t n,
                               int dc0, int lo0, int hi0, int dc1, int lo1,
                               int hi1, int dc2, int lo2, int hi2) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        if (RCT) {
            const int32_t y = p0[i], cb = p1[i], cr = p2[i];
            const int32_t g = y - ((cb + cr) >> 2);  // arithmetic shift
            p0[i] = min(max(cr + g + dc0, lo0), hi0);
            p1[i] = min(max(g + dc1, lo1), hi1);
            p2[i] = min(max(cb + g + dc2, lo2), hi2);
        } else {
            p0[i] = min(max(p0[i] + dc0, lo0), hi0);
        }
    }
}

// planes: int32 [n] each, updated in place; per-plane dc shift and range.
extern "C" int rct_inv_dc_clip(void* p0, void* p1, void* p2, int64_t n, int dc0,
                               int lo0, int hi0, int dc1, int lo1, int hi1,
                               int dc2, int lo2, int hi2, int rct, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (rct)
        rct_inv_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            (int32_t*)p0, (int32_t*)p1, (int32_t*)p2, n, dc0, lo0, hi0, dc1, lo1,
            hi1, dc2, lo2, hi2);
    else
        rct_inv_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            (int32_t*)p0, nullptr, nullptr, n, dc0, lo0, hi0, 0, 0, 0, 0, 0, 0);
    return (int)cudaGetLastError();
}
