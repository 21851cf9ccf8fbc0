// K-w blk_stats: the block statistics of the tile-parallel transform. For an
// int32 batch [T, C, H, W] (H and W multiples of 64): the largest magnitude
// of every 64 x 64 block, int32 [T, C, H/64, W/64], and the sum of the
// squares of every sample as one float64.
//
// Replaces: K6, grok_tpu/parallel/mesh.py make_sharded_transform (:442),
// its blk_max (the abs/reshape/max of :475-476) and the per-shard share of
// its psum of distortion (:477-479).
//
// Bound on an H100 (3.35 TB/s): bytes. It reads the batch once and writes
// one int32 a block and one float64 a block: 4 bytes a sample.
//
// Design. One CUDA block of 256 threads a 64 x 64 block; a thread reads 16
// samples (a row segment at a time, neighbouring threads on neighbouring
// samples), keeps its largest magnitude and its float64 sum of squares, and
// the block reduces both through shared memory. The block's sum goes to a
// partials array, one float64 a block, and a second launch of one block adds
// the partials. Each square of a coefficient below 2^26 in magnitude is an
// integer a float64 holds exactly, and while every partial sum stays below
// 2^53 the float64 sum is exact in any order, so it equals the plain
// version's sum and numpy's int64 sum. A magnitude is computed in int32, as
// torch.abs does (INT_MIN stays INT_MIN).

#include <cuda_runtime.h>
#include <stdint.h>

static const int kThreads = 256;

__global__ void blk_reduce(const int32_t* __restrict__ x, int32_t* __restrict__ bmax,
                           double* __restrict__ partial, int H, int W) {
    const int bx = blockIdx.x, by = blockIdx.y, plane = blockIdx.z;
    const int nbx = W / 64, nby = H / 64;
    const int32_t* p = x + (int64_t)plane * H * W + (int64_t)(by * 64) * W + bx * 64;
    int32_t m = INT32_MIN;
    double s = 0.0;
    for (int i = threadIdx.x; i < 64 * 64; i += kThreads) {
        const int32_t v = p[(int64_t)(i >> 6) * W + (i & 63)];
        const int32_t a = v < 0 ? (int32_t)(0u - (uint32_t)v) : v;
        m = max(m, a);
        s += (double)v * (double)v;
    }
    __shared__ int32_t sm[kThreads];
    __shared__ double ss[kThreads];
    sm[threadIdx.x] = m;
    ss[threadIdx.x] = s;
    __syncthreads();
    for (int k = kThreads / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k) {
            sm[threadIdx.x] = max(sm[threadIdx.x], sm[threadIdx.x + k]);
            ss[threadIdx.x] += ss[threadIdx.x + k];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        const int64_t b = ((int64_t)plane * nby + by) * nbx + bx;
        bmax[b] = sm[0];
        partial[b] = ss[0];
    }
}

__global__ void sum_partials(const double* __restrict__ partial, int64_t n,
                             double* __restrict__ out) {
    __shared__ double ss[kThreads];
    double s = 0.0;
    for (int64_t i = threadIdx.x; i < n; i += kThreads) s += partial[i];
    ss[threadIdx.x] = s;
    __syncthreads();
    for (int k = kThreads / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k) ss[threadIdx.x] += ss[threadIdx.x + k];
        __syncthreads();
    }
    if (threadIdx.x == 0) *out = ss[0];
}

// x: int32 [planes, H, W] contiguous; bmax: int32 [planes, H/64, W/64];
// partial: float64 scratch, one a block; out: one float64
extern "C" int blk_stats(const void* x, void* bmax, void* partial, void* out, int planes,
                         int H, int W, void* stream) {
    if (planes <= 0 || H <= 0 || W <= 0 || H % 64 || W % 64) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(W / 64, H / 64, planes);
    blk_reduce<<<grid, kThreads, 0, st>>>((const int32_t*)x, (int32_t*)bmax,
                                          (double*)partial, H, W);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    sum_partials<<<1, kThreads, 0, st>>>((const double*)partial,
                                        (int64_t)planes * (H / 64) * (W / 64), (double*)out);
    return (int)cudaGetLastError();
}
