// K-j dc_ict_fwd: DC level shift to float32 + irreversible colour transform
// (T.800 G.3, the ICT).
//
// Replaces: the irreversible branch of grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:69-84), an XLA elementwise fusion over ops/mct.py
// ict_forward (:48) and the DC shift; held to the host path's
// native/pipeline.cpp ict_dc_forward.
//
// Bound on an H100 (3.35 TB/s): bytes. Three int32 planes in, three float32
// planes out, 24 bytes per pixel and 15 float operations: 3840x2160 moves
// 199 MB, 0.06 ms. Design: K-a's grid-stride pass (dc_rct.cu), neighbouring
// threads on neighbouring samples. Every product and every sum is rounded on
// its own (__fmul_rn/__fadd_rn, and the source is built with -fmad=false), in
// the host path's order m0*r + m1*g + m2*b, left to right, so the result is
// bit-identical to it. Components past the third, and images without the
// ICT, take the shift alone (ict = 0, plane 0 only).

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float dot3(float m0, float m1, float m2, float a, float b,
                                      float c) {
    return __fadd_rn(__fadd_rn(__fmul_rn(m0, a), __fmul_rn(m1, b)), __fmul_rn(m2, c));
}

template <bool ICT>
__global__ void dc_ict_kernel(const int32_t* __restrict__ in0,
                              const int32_t* __restrict__ in1,
                              const int32_t* __restrict__ in2,
                              float* __restrict__ out0, float* __restrict__ out1,
                              float* __restrict__ out2, int64_t n, int dc0, int dc1,
                              int dc2) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const float r = __int2float_rn(in0[i] - dc0);
        if (ICT) {
            const float g = __int2float_rn(in1[i] - dc1);
            const float b = __int2float_rn(in2[i] - dc2);
            out0[i] = dot3(0.299f, 0.587f, 0.114f, r, g, b);
            out1[i] = dot3(-0.168736f, -0.331264f, 0.5f, r, g, b);
            out2[i] = dot3(0.5f, -0.418688f, -0.081312f, r, g, b);
        } else {
            out0[i] = r;
        }
    }
}

extern "C" int dc_ict_fwd(const void* in0, const void* in1, const void* in2,
                          void* out0, void* out1, void* out2, int64_t n,
                          int dc0, int dc1, int dc2, int ict, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (ict)
        dc_ict_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            (const int32_t*)in0, (const int32_t*)in1, (const int32_t*)in2,
            (float*)out0, (float*)out1, (float*)out2, n, dc0, dc1, dc2);
    else
        dc_ict_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            (const int32_t*)in0, nullptr, nullptr, (float*)out0, nullptr, nullptr,
            n, dc0, 0, 0);
    return (int)cudaGetLastError();
}
