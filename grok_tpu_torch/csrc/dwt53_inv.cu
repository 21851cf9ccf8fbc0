// K-g dwt53_inv_level: one level of the inverse reversible 5/3 wavelet
// (T.800 F.3.8.2), horizontal then vertical, from the Mallat-packed top-left
// h x w region of an int32 plane to natural order, in one launch, out of
// place.
//
// Replaces: the reversible lifting inside grok_tpu/ops/jax_pipeline.py
// make_inverse_fn (:191), i.e. ops/dwt.py inverse (:285) over inv53_axis
// (:128), an XLA program of shifted slices and interleaving scatters; held
// to the host path's native/pipeline.cpp i53_row/i53_vert (:73, :309).
//
// Bound on an H100 (3.35 TB/s): bytes. A level reads its region once and
// writes it once, 8 bytes per sample; five levels of 3840x2160x3 move
// ~265 MB, 0.08 ms. The origin parity of the level's rect (y0 & 1, x0 & 1)
// decides which phase is low-pass: sample i of a line is low-pass iff
// (i & 1) == parity, and its index within its phase is i >> 1. Shifts are
// arithmetic on negative values, as in int32 numpy and XLA; sums wrap as
// the reference's wadd/wsub (native/pipeline.cpp:37-46), since corrupt
// streams carry coefficients near INT32_MAX: they are done in uint32_t and
// converted back before each shift, so no compiler may assume that a
// signed sum does not overflow.
//
// Design: K-n's (dwt97.cu, whose header proves that the native clamps are
// T.800's symmetric extension and that tiles with a reflected halo agree
// bit for bit; the proof holds word for word for the two steps here, and
// (a + b + 2) >> 2 and (a + b) >> 1 do not depend on the order of their
// neighbours). In natural order the inverse is s -= (d + d + 2) >> 2 at
// every low-pass sample, then d += (s + s) >> 1 at every high-pass one,
// each from its two neighbours x - 1 and x + 1, so an output depends on the
// inputs within 2 of it. A block stages the (TH + 4) x (TW + 4) packed
// inputs around its TH x TW output tile from their packed places by
// cp.async (a warp row reads two runs of 34 consecutive words, the s and
// the d half), lifts each staged row in registers (a thread a row), then
// each of its TW middle columns (a thread a column), and writes its middle
// in natural order, a row 64 consecutive words (two whole 128-B lines).
// 60 x 64 tiles: 64 threads lift the 64 staged rows and then the 64 middle
// columns, each in one round. The halos a tile reads are other tiles'
// outputs, so the level writes out of place: the wrapper gives it the LL
// quadrant (the coarser level's output) and the rest of the packed plane as
// two sources and a destination that overlaps neither
// (transform.inv_ping_pong runs the levels).
//
// The horizontal half alone (dwt53_inv_h, the sharded strip wavelet) lives
// in strip_h.cu.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TH 60           // output rows a tile
#define TW 64           // output columns a tile
#define HALO 2          // two lifting steps: a sample depends on 2 on each side
#define TR (TH + 2 * HALO)  // tile rows staged: 64, a thread each (horizontal)
#define TC (TW + 2 * HALO)  // tile columns staged: 68
#define TP (TC + 1)         // pitch of a staged row (odd: a column reads no bank twice)
#define INV_THREADS 64      // TR rows, then TW columns, a thread each

// the reference's wrapping sum and difference
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// T.800's symmetric extension of an axis of n samples: x reflected into [0, n)
__device__ __forceinline__ int reflect(int x, int n) {
    if (x >= 0 && x < n) return x;
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    x %= period;
    if (x < 0) x += period;
    return x < n ? x : period - x;
}

// where natural sample x of an axis lies in its packed [s | d] form: s if
// (x & 1) == par, at x >> 1 of its phase
__device__ __forceinline__ int packed(int x, int par, int sn) {
    return ((x & 1) == par ? 0 : sn) + (x >> 1);
}

// one axis of the inverse on a line in registers, sample c low-pass iff
// (c & 1) == PAR: s -= (d_l + d_r + 2) >> 2, then d += (s_l + s_r) >> 1,
// each over the samples inside (0, N - 1) (the line's ends lack a neighbour
// and go stale). After the two steps samples [HALO, N - HALO) are right. A
// line of one sample (n == 1) is x >> 1 at odd origin, else as it is.
template <int N, int PAR>
__device__ __forceinline__ void inv53_line(int32_t (&x)[N]) {
#pragma unroll
    for (int c = PAR == 0 ? 2 : 1; c < N - 1; c += 2)
        x[c] = wsub(x[c], wadd(wadd(x[c - 1], x[c + 1]), 2) >> 2);
#pragma unroll
    for (int c = PAR == 0 ? 1 : 2; c < N - 1; c += 2)
        x[c] = wadd(x[c], wadd(x[c - 1], x[c + 1]) >> 1);
}

template <int N>
__device__ __forceinline__ void inv53_axis(int32_t (&x)[N], int n, int par) {
    if (n > 1) {
        if (par) inv53_line<N, 1>(x); else inv53_line<N, 0>(x);
    } else if (par) {
#pragma unroll
        for (int c = 0; c < N; ++c) x[c] >>= 1;
    }
}

// ll: the packed input's LL quadrant (rows [0, snv), columns [0, snh)),
// row stride ld_ll; src: the rest of the packed input, stride ld; dst: the
// natural-order output, stride ld_dst. A tile stages rows y0 - HALO .. and
// columns x0 - HALO .. of the natural-order input (each reflected into the
// region, then read from its packed place), lifts every staged row in
// registers (a thread a row), then its TW middle columns (a thread a
// column), and writes its TH x TW middle.
__global__ void __launch_bounds__(INV_THREADS)
dwt53_inv_tile(const int32_t* __restrict__ ll, int64_t ld_ll, const int32_t* __restrict__ src,
               int64_t ld, int32_t* __restrict__ dst, int64_t ld_dst, int h, int w, int py,
               int px) {
    extern __shared__ int32_t s_tile[];  // TR x TP
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const int snv = py ? h / 2 : (h + 1) / 2, snh = px ? w / 2 : (w + 1) / 2;
    int sx[3];     // packed columns of this lane's staged columns lane, lane + 32, lane + 64
    bool in_ll[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        sx[k] = packed(reflect(x0 - HALO + lane + 32 * k, w), px, snh);
        in_ll[k] = sx[k] < snh;
    }
#pragma unroll 8
    for (int r = warp; r < TR; r += INV_THREADS / 32) {  // copies in flight, no registers held
        const int sy = packed(reflect(y0 - HALO + r, h), py, snv);
        const int32_t* a = ll + sy * ld_ll;
        const int32_t* b = src + sy * ld;
        const bool y_ll = sy < snv;
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (lane + 32 * k < TC)
                __pipeline_memcpy_async(&s_tile[r * TP + lane + 32 * k],
                                        (y_ll && in_ll[k] ? a : b) + sx[k], sizeof(int32_t));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    {  // rows: thread tid lifts staged row tid
        int32_t x[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) x[c] = s_tile[tid * TP + c];
        inv53_axis(x, w, px);
#pragma unroll
        for (int c = HALO; c < HALO + TW; ++c) s_tile[tid * TP + c] = x[c];
    }
    __syncthreads();
    int32_t x[TR];  // columns: thread tid lifts column HALO + tid
#pragma unroll
    for (int r = 0; r < TR; ++r) x[r] = s_tile[r * TP + HALO + tid];
    inv53_axis(x, h, py);
    if (x0 + tid >= w) return;
    int32_t* out = dst + x0 + tid;
#pragma unroll
    for (int r = HALO; r < HALO + TH; ++r)
        if (y0 + r - HALO < h) out[(y0 + r - HALO) * ld_dst] = x[r];
}

// ---------------------------------------------------------------- the C entries
// a K-g tile's threads and shared bytes, and its blocks resident on one SM
extern "C" int dwt53_inv_occupancy(int* threads, int* smem, int* blocks) {
    *threads = INV_THREADS;
    *smem = TR * TP * (int)sizeof(int32_t);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dwt53_inv_tile, *threads,
                                                              *smem);
}

// One launch: the level of the packed ll/src (see dwt53_inv_tile) into
// dst, which must not overlap either.
extern "C" int dwt53_inv_level(const void* ll, int64_t ld_ll, const void* src, int64_t ld,
                               void* dst, int64_t ld_dst, int h, int w, int py, int px,
                               void* stream) {
    if (h <= 0 || w <= 0) return 0;
    static_assert(TR == INV_THREADS && TW == INV_THREADS && TC <= 96, "a thread a row, a column");
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
    dwt53_inv_tile<<<grid, INV_THREADS, TR * TP * sizeof(int32_t), (cudaStream_t)stream>>>(
        (const int32_t*)ll, ld_ll, (const int32_t*)src, ld, (int32_t*)dst, ld_dst, h, w, py,
        px);
    return (int)cudaGetLastError();
}
