// K-a dc_rct_fwd: DC level shift + reversible colour transform (T.800 G.2).
//
// Replaces: the reversible branch of grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:69-87), an XLA elementwise fusion over ops/mct.py
// rct_forward and the DC shift.
//
// Bound on an H100 (3.35 TB/s): bytes. Three int32 planes in, three out,
// 24 bytes per pixel and ~8 integer ops: 3840x2160 moves 199 MB, 0.06 ms.
// Design: one fused grid-stride pass, neighbouring threads on neighbouring
// samples (coalesced 4-byte loads and stores), every value read once and
// written once. Gray and 2-component images, and components past the third,
// take the shift alone (rct = 0, plane 0 only).

#include <cuda_runtime.h>
#include <stdint.h>

template <bool RCT>
__global__ void dc_rct_kernel(const int32_t* __restrict__ in0,
                              const int32_t* __restrict__ in1,
                              const int32_t* __restrict__ in2,
                              int32_t* __restrict__ out0,
                              int32_t* __restrict__ out1,
                              int32_t* __restrict__ out2, int64_t n, int dc0,
                              int dc1, int dc2) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int32_t r = in0[i] - dc0;
        if (RCT) {
            const int32_t g = in1[i] - dc1;
            const int32_t b = in2[i] - dc2;
            out0[i] = (r + 2 * g + b) >> 2;  // arithmetic shift, as int32 >>
            out1[i] = b - g;
            out2[i] = r - g;
        } else {
            out0[i] = r;
        }
    }
}

extern "C" int dc_rct_fwd(const void* in0, const void* in1, const void* in2,
                          void* out0, void* out1, void* out2, int64_t n,
                          int dc0, int dc1, int dc2, int rct, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (rct)
        dc_rct_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            (const int32_t*)in0, (const int32_t*)in1, (const int32_t*)in2,
            (int32_t*)out0, (int32_t*)out1, (int32_t*)out2, n, dc0, dc1, dc2);
    else
        dc_rct_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            (const int32_t*)in0, nullptr, nullptr, (int32_t*)out0, nullptr,
            nullptr, n, dc0, 0, 0);
    return (int)cudaGetLastError();
}
