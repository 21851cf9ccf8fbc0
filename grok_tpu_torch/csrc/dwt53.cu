// K-b dwt53_fwd_level: one level of the forward reversible 5/3 wavelet
// (T.800 F.4.8.1), vertical then horizontal, written Mallat-packed in place
// into the top-left h x w region of the packed plane.
//
// Replaces: the reversible lifting inside grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:93), i.e. ops/dwt.py forward (:259) over fwd53_axis
// (:112), an XLA program of shifted slices and concatenates.
//
// Bound on an H100 (3.35 TB/s): bytes. A level reads its region once and
// writes it once, 8 bytes per sample; five levels of 3840x2160x3 move
// ~265 MB, 0.08 ms. Design: each output sample is one thread, which
// recomputes its lifting neighbourhood (at most five source samples) from
// the source with clamped indices -- whole-sample symmetric extension is
// exactly "clamp to the nearest valid opposite-phase sample", so there is
// no halo logic. The vertical pass writes a compact scratch plane and the
// horizontal pass writes the packed plane, so each pass is out of place and
// needs no synchronisation beyond the launch boundary. The origin parity of
// the current level's rect (y0 & 1, x0 & 1) selects which phase is low-pass.

#include <cuda_runtime.h>
#include <stdint.h>

struct Line {
    const int32_t* p;
    int64_t step;
    __device__ __forceinline__ int32_t at(int i) const { return p[i * step]; }
};

__device__ __forceinline__ int32_t s_at(const Line& L, int i, int par) {
    return L.at(2 * i + par);
}

__device__ __forceinline__ int32_t d_at(const Line& L, int j, int par) {
    return L.at(2 * j + 1 - par);
}

// high-pass output j after the predict step
__device__ __forceinline__ int32_t dprime(const Line& L, int j, int par, int sn) {
    const int sl = par == 0 ? j : max(j - 1, 0);
    const int sr = min(par == 0 ? j + 1 : j, sn - 1);
    return d_at(L, j, par) - ((s_at(L, sl, par) + s_at(L, sr, par)) >> 1);
}

// Mallat-packed output o of a length-n line: [low | high]
__device__ __forceinline__ int32_t lift_out(const Line& L, int n, int par, int o) {
    if (n == 1) return par ? L.at(0) * 2 : L.at(0);
    const int sn = par ? n / 2 : (n + 1) / 2;
    const int dn = n - sn;
    if (o >= sn) return dprime(L, o - sn, par, sn);
    const int dl = par == 0 ? max(o - 1, 0) : o;
    const int dr = min(par == 0 ? o : o + 1, dn - 1);
    return s_at(L, o, par) +
           ((dprime(L, dl, par, sn) + dprime(L, dr, par, sn) + 2) >> 2);
}

__global__ void dwt53_vert(const int32_t* __restrict__ plane,
                           int32_t* __restrict__ tmp, int ld, int h, int w,
                           int par) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int o = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || o >= h) return;
    const Line L{plane + x, ld};
    tmp[(int64_t)o * w + x] = lift_out(L, h, par, o);
}

__global__ void dwt53_horz(const int32_t* __restrict__ tmp,
                           int32_t* __restrict__ plane, int ld, int h, int w,
                           int par) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (o >= w || y >= h) return;
    const Line L{tmp + (int64_t)y * w, 1};
    plane[(int64_t)y * ld + o] = lift_out(L, w, par, o);
}

// plane: packed int32 plane with row stride ld; tmp: >= h*w int32 scratch.
extern "C" int dwt53_fwd_level(void* plane, void* tmp, int ld, int h, int w,
                               int py, int px, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    dwt53_vert<<<grid, block, 0, st>>>((const int32_t*)plane, (int32_t*)tmp,
                                       ld, h, w, py);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dwt53_horz<<<grid, block, 0, st>>>((const int32_t*)tmp, (int32_t*)plane,
                                       ld, h, w, px);
    return (int)cudaGetLastError();
}

// The horizontal half alone (K6's _fwd53_h_local, grok_tpu/parallel/
// mesh.py:118, with the origin parity px): the sub-block is copied to the
// compact scratch and lifted back into place, as the second pass above.
extern "C" int dwt53_fwd_h(void* plane, void* tmp, int ld, int h, int w, int px,
                           void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int rc = (int)cudaMemcpy2DAsync(tmp, (size_t)w * 4, plane, (size_t)ld * 4, (size_t)w * 4,
                                    (size_t)h, cudaMemcpyDeviceToDevice, st);
    if (rc) return rc;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    dwt53_horz<<<grid, block, 0, st>>>((const int32_t*)tmp, (int32_t*)plane, ld, h, w, px);
    return (int)cudaGetLastError();
}
