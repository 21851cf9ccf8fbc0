// K-g dwt53_inv_level: one level of the inverse reversible 5/3 wavelet
// (T.800 F.3.8.2), horizontal then vertical, on the Mallat-packed top-left
// h x w region of a plane, in place.
//
// Replaces: the reversible lifting inside grok_tpu/ops/jax_pipeline.py
// make_inverse_fn (:191), i.e. ops/dwt.py inverse (:285) over inv53_axis
// (:128), an XLA program of shifted slices and interleaving scatters.
//
// Bound on an H100 (3.35 TB/s): bytes. A level reads its region once and
// writes it once, 8 bytes per sample; five levels of 3840x2160x3 move
// ~265 MB, 0.08 ms. Design: the counterpart of K-b (dwt53.cu). Each output
// sample is one thread, which recomputes its lifting neighbourhood (at most
// seven packed samples) with clamped indices -- whole-sample symmetric
// extension is a clamp to the nearest valid opposite-phase sample -- so
// there is no halo logic. The horizontal pass writes a compact scratch plane
// and the vertical pass writes the packed plane back. The origin parity of
// the level's rect (y0 & 1, x0 & 1) decides which phase is low-pass: sample
// i of a line is low-pass iff (i & 1) == parity, and its index within its
// phase is i >> 1. Shifts are arithmetic on negative values, as in int32
// numpy and XLA.

#include <cuda_runtime.h>
#include <stdint.h>

struct Line {
    const int32_t* p;
    int64_t step;
    __device__ __forceinline__ int32_t at(int i) const { return p[i * step]; }
};

// low-pass sample i after the update step: s[i] - (d[l] + d[r] + 2) >> 2;
// the packed line holds s in [0, sn) and d in [sn, n)
__device__ __forceinline__ int32_t s_out(const Line& L, int i, int par, int sn, int dn) {
    const int dl = par == 0 ? max(i - 1, 0) : i;
    const int dr = min(par == 0 ? i : i + 1, dn - 1);
    return L.at(i) - ((L.at(sn + dl) + L.at(sn + dr) + 2) >> 2);
}

// natural-order output o of a length-n packed line
__device__ __forceinline__ int32_t unlift_out(const Line& L, int n, int par, int o) {
    if (n == 1) return par ? (L.at(0) >> 1) : L.at(0);
    const int sn = par ? n / 2 : (n + 1) / 2;
    const int dn = n - sn;
    const int k = o >> 1;
    if ((o & 1) == par) return s_out(L, k, par, sn, dn);
    const int sl = par == 0 ? k : max(k - 1, 0);
    const int sr = min(par == 0 ? k + 1 : k, sn - 1);
    return L.at(sn + k) + ((s_out(L, sl, par, sn, dn) + s_out(L, sr, par, sn, dn)) >> 1);
}

__global__ void dwt53_inv_horz(const int32_t* __restrict__ plane,
                               int32_t* __restrict__ tmp, int ld, int h, int w,
                               int par) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (o >= w || y >= h) return;
    const Line L{plane + (int64_t)y * ld, 1};
    tmp[(int64_t)y * w + o] = unlift_out(L, w, par, o);
}

__global__ void dwt53_inv_vert(const int32_t* __restrict__ tmp,
                               int32_t* __restrict__ plane, int ld, int h, int w,
                               int par) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int o = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || o >= h) return;
    const Line L{tmp + x, w};
    plane[(int64_t)o * ld + x] = unlift_out(L, h, par, o);
}

// plane: packed int32 plane with row stride ld; tmp: >= h*w int32 scratch.
extern "C" int dwt53_inv_level(void* plane, void* tmp, int ld, int h, int w,
                               int py, int px, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    dwt53_inv_horz<<<grid, block, 0, st>>>((const int32_t*)plane, (int32_t*)tmp,
                                           ld, h, w, px);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dwt53_inv_vert<<<grid, block, 0, st>>>((const int32_t*)tmp, (int32_t*)plane,
                                           ld, h, w, py);
    return (int)cudaGetLastError();
}

// The horizontal half alone (K6's _inv53_h_local, grok_tpu/parallel/
// mesh.py:130, with the origin parity px): the first pass above into the
// compact scratch, then the scratch copied back into place.
extern "C" int dwt53_inv_h(void* plane, void* tmp, int ld, int h, int w, int px,
                           void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    dwt53_inv_horz<<<grid, block, 0, st>>>((const int32_t*)plane, (int32_t*)tmp, ld, h, w,
                                           px);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    return (int)cudaMemcpy2DAsync(plane, (size_t)ld * 4, tmp, (size_t)w * 4, (size_t)w * 4,
                                  (size_t)h, cudaMemcpyDeviceToDevice, st);
}
