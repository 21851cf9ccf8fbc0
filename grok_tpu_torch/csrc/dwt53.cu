// K-b dwt53_fwd_level: one level of the forward reversible 5/3 wavelet
// (T.800 F.4.8.1), vertical then horizontal, from the top-left h x w region
// of an int32 plane in natural order to its Mallat-packed form, in one
// launch, out of place.
//
// Replaces: the reversible lifting inside grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:93), i.e. ops/dwt.py forward (:259) over fwd53_axis
// (:112), an XLA program of shifted slices and concatenates; held to the
// host path's native/pipeline.cpp f53_row/f53_vert (:48, :290).
//
// Bound on an H100 (3.35 TB/s): bytes. A level reads its region once and
// writes it once, 8 bytes per sample; five levels of 3840x2160x3 move
// ~265 MB, 0.08 ms. The origin parity of the level's rect (y0 & 1, x0 & 1)
// decides which phase is low-pass: sample i of a line is low-pass iff
// (i & 1) == parity, and its index within its phase is i >> 1. Shifts are
// arithmetic on negative values, as in int32 numpy and XLA; sums wrap as
// the reference's wadd/wsub (native/pipeline.cpp:40-45): they are done in
// uint32_t and converted back before each shift, so no compiler may assume
// that a signed sum does not overflow. A line of one sample is doubled at
// odd origin (wrapping too) and kept at even origin (ops/dwt.py:118-119).
//
// Design: K-k's (dwt97.cu, whose header proves that the native clamps are
// T.800's symmetric extension and that tiles with a reflected halo agree
// bit for bit; the proof holds word for word for the two steps here, and
// (a + b) >> 1 and (a + b + 2) >> 2 do not depend on the order of their
// neighbours). In natural order the forward is d -= (s + s) >> 1 at every
// high-pass sample, then s += (d + d + 2) >> 2 at every low-pass one, each
// from its two neighbours x - 1 and x + 1, so an output depends on the
// inputs within 2 of it. A block stages the (FTH + 4) x (FTW + 4)
// natural-order input around its FTH x FTW tile by cp.async
// (__pipeline_memcpy_async: every copy in flight at once, no register
// held), lifts each staged column in registers (a thread a column; the
// vertical axis first, as the plain version and the reference: the integer
// 5/3 does not commute), then each of its FTH middle rows (a thread a row),
// writes each row back to shared memory as its s half and its d half, and
// stores a row's halves as two runs of FTW / 2 consecutive words of the
// packed plane (32 words, 128 B, four whole sectors): the LL quadrant to
// one buffer, the detail bands (final) to another. 60 x 64 tiles: the
// staged tile is K-g's (64 x 68 words, 17,664 B), and 96 threads lift its
// 68 staged columns in one round and its 60 middle rows in one round (K-k
// measured 96 threads against 64, whose columns take two rounds, and kept
// 96). A tile starts at an even offset and the halo is even, so a staged
// index has the parity of its natural position. The halos a tile reads are
// other tiles' inputs, so the level writes out of place
// (transform.fwd_ping_pong runs the levels).
//
// The horizontal half alone (dwt53_fwd_h, the sharded strip wavelet) lives
// in strip_h.cu.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FTH 60                // input rows a tile
#define FTW 64                // input columns a tile: a row's halves are runs of 32
#define HALO 2                // two lifting steps: a sample depends on 2 on each side
#define FTR (FTH + 2 * HALO)  // tile rows staged: 64
#define FTC (FTW + 2 * HALO)  // tile columns staged: 68
#define FTP (FTC + 1)         // pitch of a staged row (odd: a column reads no bank twice)
#define FWD_THREADS 96        // FTC columns, then FTH rows, a thread each

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

// one axis of the forward on a line in registers, sample c low-pass iff
// (c & 1) == PAR: d -= (s_l + s_r) >> 1, then s += (d_l + d_r + 2) >> 2,
// each over the samples inside (0, N - 1) (the line's ends lack a neighbour
// and go stale). After the two steps samples [HALO, N - HALO) are right.
template <int N, int PAR>
__device__ __forceinline__ void fwd53_line(int32_t (&x)[N]) {
#pragma unroll
    for (int c = PAR == 0 ? 1 : 2; c < N - 1; c += 2)
        x[c] = wsub(x[c], wadd(x[c - 1], x[c + 1]) >> 1);
#pragma unroll
    for (int c = PAR == 0 ? 2 : 1; c < N - 1; c += 2)
        x[c] = wadd(x[c], wadd(wadd(x[c - 1], x[c + 1]), 2) >> 2);
}

// the forward on an axis of n samples: a line of one sample is doubled at
// odd origin, else kept
template <int N>
__device__ __forceinline__ void fwd53_axis(int32_t (&x)[N], int n, int par) {
    if (n > 1) {
        if (par) fwd53_line<N, 1>(x); else fwd53_line<N, 0>(x);
    } else if (par) {
#pragma unroll
        for (int c = 0; c < N; ++c) x[c] = wadd(x[c], x[c]);
    }
}

// src: the natural-order input, row stride ld; ll: where the packed LL
// quadrant goes (rows [0, snv), columns [0, snh)), stride ld_ll; dst: the
// rest of the packed output, stride ld_dst (ll may be dst, with ld_ll ==
// ld_dst). A tile stages rows y0 - HALO .. and columns x0 - HALO .. of src
// (each reflected into the region), lifts every staged column in registers
// (a thread a column), then its FTH middle rows (a thread a row), which it
// leaves in shared memory as [s half | d half], and writes each middle
// row's halves, a warp a half.
__global__ void __launch_bounds__(FWD_THREADS)
dwt53_fwd_tile(const int32_t* __restrict__ src, int64_t ld, int32_t* __restrict__ ll,
               int64_t ld_ll, int32_t* __restrict__ dst, int64_t ld_dst, int h, int w, int py,
               int px) {
    extern __shared__ int32_t s_tile[];  // FTR x FTP
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int y0 = blockIdx.y * FTH, x0 = blockIdx.x * FTW;
    int sx[(FTC + 31) / 32];  // this lane's staged columns lane, lane + 32, ...
#pragma unroll
    for (int k = 0; k < (FTC + 31) / 32; ++k) sx[k] = reflect(x0 - HALO + lane + 32 * k, w);
#pragma unroll 8
    for (int r = warp; r < FTR; r += FWD_THREADS / 32) {  // copies in flight, no registers held
        const int32_t* row = src + reflect(y0 - HALO + r, h) * ld;
#pragma unroll
        for (int k = 0; k < (FTC + 31) / 32; ++k)
            if (lane + 32 * k < FTC)
                __pipeline_memcpy_async(&s_tile[r * FTP + lane + 32 * k], row + sx[k],
                                        sizeof(int32_t));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int c = tid; c < FTC; c += FWD_THREADS) {  // columns: every staged one
        int32_t x[FTR];
#pragma unroll
        for (int r = 0; r < FTR; ++r) x[r] = s_tile[r * FTP + c];
        fwd53_axis(x, h, py);
#pragma unroll
        for (int r = HALO; r < HALO + FTH; ++r) s_tile[r * FTP + c] = x[r];
    }
    __syncthreads();
    for (int i = tid; i < FTH; i += FWD_THREADS) {  // rows: staged row HALO + i
        int32_t* row = s_tile + (HALO + i) * FTP;
        int32_t x[FTC];
#pragma unroll
        for (int c = 0; c < FTC; ++c) x[c] = row[c];
        fwd53_axis(x, w, px);
        // middle column HALO + c is natural x0 + c: s at c >> 1 if (c & 1) == px
#pragma unroll
        for (int c = 0; c < FTW; ++c) row[((c & 1) == px ? 0 : FTW / 2) + (c >> 1)] = x[HALO + c];
    }
    __syncthreads();
    const int snv = py ? h / 2 : (h + 1) / 2, snh = px ? w / 2 : (w + 1) / 2;
    const int j = lane;  // sample j of a half: natural x0 + 2j + its phase
    for (int i = warp; i < 2 * FTH; i += FWD_THREADS / 32) {
        const int r = i >> 1, d = i & 1;
        const int y = y0 + r, x = x0 + 2 * j + (d ? 1 - px : px);
        if (y >= h || x >= w) continue;
        const int yp = packed(y, py, snv);
        int32_t* out = !d && yp < snv ? ll + yp * ld_ll : dst + yp * ld_dst;
        out[(d ? snh : 0) + (x >> 1)] = s_tile[(HALO + r) * FTP + d * (FTW / 2) + j];
    }
}

// ---------------------------------------------------------------- the C entries
// a K-b tile's threads and shared bytes, and its blocks resident on one SM
extern "C" int dwt53_fwd_occupancy(int* threads, int* smem, int* blocks) {
    *threads = FWD_THREADS;
    *smem = FTR * FTP * (int)sizeof(int32_t);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dwt53_fwd_tile, *threads,
                                                              *smem);
}

// One launch: the level of the natural-order src into the packed ll (its
// LL quadrant) and dst (the rest; see dwt53_fwd_tile); neither may overlap
// src.
extern "C" int dwt53_fwd_level(const void* src, int64_t ld, void* ll, int64_t ld_ll, void* dst,
                               int64_t ld_dst, int h, int w, int py, int px, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    static_assert(FTW / 2 == 32 && FTC <= FWD_THREADS && FTH <= FWD_THREADS &&
                      FWD_THREADS % 32 == 0, "a warp a half row; a thread a column, a row");
    const dim3 grid((w + FTW - 1) / FTW, (h + FTH - 1) / FTH);
    dwt53_fwd_tile<<<grid, FWD_THREADS, FTR * FTP * sizeof(int32_t), (cudaStream_t)stream>>>(
        (const int32_t*)src, ld, (int32_t*)ll, ld_ll, (int32_t*)dst, ld_dst, h, w, py, px);
    return (int)cudaGetLastError();
}
