// K-k dwt97_fwd_level and K-n dwt97_inv_level: one level of the forward and
// of the inverse irreversible 9/7 wavelet (T.800 F.4.8.2 and F.3.8.2), on
// the top-left h x w region of a float32 plane, Mallat-packed on one side
// and in natural order on the other, each level one launch out of place.
//
// Replaces: the irreversible lifting inside grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:93) and make_inverse_fn (:191), i.e. ops/dwt.py forward
// (:259) over fwd97_axis (:148) and inverse (:285) over inv97_axis (:172);
// held to the host path's native/pipeline.cpp f97_row/f97_vert (:99, :329)
// and i97_row/i97_vert (:130, :353).
//
// Bound on an H100 (3.35 TB/s): bytes. A level reads its region once and
// writes it once, 8 bytes per sample, and does 4 lifting steps of 3 float
// operations plus a scaling per sample and axis; five levels of 3840x2160x3
// move ~265 MB, 0.08 ms. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, and the source is built with -fmad=false),
// as the host path computes them. A line of one sample is left unscaled in
// both parities (ops/dwt.py:154-158). The origin parity of the level's rect
// decides which phase is low-pass: sample p is low-pass iff (p & 1) == par,
// at index p >> 1 of its phase.
//
// Edges. In natural order each lifting step updates the samples of one
// phase from their two neighbours x - 1 and x + 1, which are of the other
// phase. The native row code clamps those neighbours into the other phase's
// array: forward, d[j] += A (s[j] + s[min(j + 1, sn - 1)]) for parity 0 and
// d[j] += A (s[max(j - 1, 0)] + s[min(j, sn - 1)]) for parity 1, the s steps
// alike. That is T.800's symmetric extension of the natural signal (x -> -x,
// n - 1 + x -> n - 1 - x): a clamp only ever replaces a neighbour that lies
// outside [0, n), namely -1 (reflected to 1) or n (reflected to n - 2), and
// 1 and n - 2 are exactly the clamped samples. For parity 0, d[j] is natural
// 2j + 1 and s[k] natural 2k: the right neighbour 2j + 2 = n exists only
// for the last d of an even n, and s[sn - 1] = natural n - 2. For parity 1,
// d[j] is natural 2j and s[k] natural 2k + 1: the left neighbour of d[0] is
// -1, reflected to 1 = s[0] = s[max(-1, 0)], and the right one of the last
// d of an odd n is n, reflected to n - 2 = s[sn - 1]. The s steps are the
// same with the phases swapped. Reflection maps a position to one of the
// same parity (x and -x, n - 1 + x and n - 1 - x differ by an even number,
// n - 1 - x and n - 1 + x too) and the pair {x - 1, x + 1} to the pair
// around the image of x; a sum of two neighbours does not depend on their
// order. So a step applied to the extended signal leaves it symmetric, and
// every step of the four (and the scaling, sample by sample) sees, at the
// region's edges, exactly the values the clamps give. An axis of n = 1 has
// no neighbours: it is neither lifted nor scaled (its reflection is the one
// sample).
//
// Tiles. A sample after one step depends on its two neighbours before it,
// so after the four steps it depends on the samples within 4 of it. A block
// makes a tile of outputs from its inputs and a halo of 4 around them, each
// staged row and column reflected into the region as above; the staged halo
// samples are lifted again by the tiles that own them, with the same
// operations on the same values (the reflected extension is one signal,
// whichever tile stages it), so every tile agrees bit for bit with the
// whole-line lifting. A tile starts at an even level-local offset and the
// halo is even, so a staged index has the parity of its natural position.
// The halos a tile reads are other tiles' inputs, so no level writes in
// place: each reads one buffer and writes another (transform.fwd_ping_pong
// and inv_ping_pong run the levels).
//
// K-k: a block stages the (FTH + 8) x (FTW + 8) natural-order input around
// its FTH x FTW tile by cp.async (__pipeline_memcpy_async: every copy in
// flight at once, no register held), lifts each staged column in registers
// (a thread a column; the vertical axis first, as the plain version), then
// each of its FTH middle rows (a thread a row), writes each row back to
// shared memory as its s half and its d half, and stores a row's halves as
// two runs of FTW / 2 consecutive floats of the packed plane (32 floats,
// 128 B, four whole sectors): the LL quadrant to one buffer, the detail
// bands (final) to the output plane. Why 56 x 64 tiles and 96 threads: the
// 64-column tile gives the packed rows their whole 128-B runs, the staged
// tile (64 x 72 floats, 18,688 B) is K-n's, and 96 threads lift its 72
// staged columns in one round (and its 56 middle rows, the third warp idle):
// on an H100 the 4K image's 15 levels took 0.252 ms against 0.278 with 64
// threads (the columns in two rounds) and 0.270 with 64 x 56 tiles and 64
// threads (both passes in one round, 112-B runs), in turns (PERF.md §6).
//
// K-n: the mirror: a block stages the (TH + 8) x (TW + 8) packed input
// around its TH x TW output tile from their packed places (a warp row reads
// two runs of 36 consecutive floats, the s and the d half), lifts each
// staged row in registers (a thread a row), then each of its TW middle
// columns (a thread a column), and writes its TH x TW middle in natural
// order, a warp row 32 consecutive floats. The wrapper gives it the LL
// quadrant (the coarser level's output) and the rest of the packed plane as
// two sources and a destination that overlaps neither.
//
// The strip wavelet's horizontal halves of both, dwt97_fwd_h and
// dwt97_inv_h, are in strip_h.cu.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the constants of native/pipeline.cpp:28-33
#define A97 ((float)-1.586134342059924)
#define B97 ((float)-0.052980118572961)
#define G97 ((float)0.882911075530934)
#define D97 ((float)0.443506852043971)
#define K97 ((float)1.230174104914001)
#define IK97 ((float)(1.0 / 1.230174104914001))

// ---------------------------------------------------------------- K-n
// One inverse level in one launch, out of place: a block makes a TH x TW
// tile of the natural-order output from the packed input around it.
#define TH 56    // output rows a tile
#define TW 64    // output columns a tile
#define HALO 4   // four lifting steps: a sample depends on 4 on each side
#define TR (TH + 2 * HALO)  // tile rows staged: 64, a thread each (horizontal)
#define TC (TW + 2 * HALO)  // tile columns staged: 72
#define TP (TC + 1)         // pitch of a staged row (odd: a column reads no bank twice)
#define INV_THREADS 64      // TR rows, then TW columns, a thread each

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

// x[c] -= k * (x[c - 1] + x[c + 1]) for c = FIRST, FIRST + 2, ... inside
// (0, N - 1): the line's ends lack a neighbour and go stale
template <int N, int FIRST>
__device__ __forceinline__ void inv_step(float (&x)[N], float k) {
#pragma unroll
    for (int c = FIRST == 0 ? 2 : 1; c < N - 1; c += 2)
        x[c] = __fsub_rn(x[c], __fmul_rn(k, __fadd_rn(x[c - 1], x[c + 1])));
}

// one axis of the inverse on a line in registers, sample c low-pass iff
// (c & 1) == PAR: s * K, d / K, then s -= D (d + d), d -= G (s + s),
// s -= B (d + d), d -= A (s + s) -- the plain version's operations in its
// order. After the four steps samples [HALO, N - HALO) are right.
template <int N, int PAR>
__device__ __forceinline__ void inv97_line(float (&x)[N]) {
#pragma unroll
    for (int c = 0; c < N; ++c) x[c] = __fmul_rn(x[c], (c & 1) == PAR ? K97 : IK97);
    inv_step<N, PAR>(x, D97);
    inv_step<N, 1 - PAR>(x, G97);
    inv_step<N, PAR>(x, B97);
    inv_step<N, 1 - PAR>(x, A97);
}

// ll: the packed input's LL quadrant (rows [0, snv), columns [0, snh)),
// row stride ld_ll; src: the rest of the packed input, stride ld; dst: the
// natural-order output, stride ld_dst. A tile stages rows y0 - HALO .. and
// columns x0 - HALO .. of the natural-order input (each reflected into the
// region, then read from its packed place), lifts every staged row in
// registers (a thread a row), then its TW middle columns (a thread a
// column), and writes its TH x TW middle. An axis of one sample is neither
// scaled nor lifted.
__global__ void __launch_bounds__(INV_THREADS)
dwt97_inv_tile(const float* __restrict__ ll, int64_t ld_ll, const float* __restrict__ src,
               int64_t ld, float* __restrict__ dst, int64_t ld_dst, int h, int w, int py,
               int px) {
    extern __shared__ float s_tile[];  // TR x TP
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
        const float* a = ll + sy * ld_ll;
        const float* b = src + sy * ld;
        const bool y_ll = sy < snv;
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (lane + 32 * k < TC)
                __pipeline_memcpy_async(&s_tile[r * TP + lane + 32 * k],
                                        (y_ll && in_ll[k] ? a : b) + sx[k], sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (w > 1) {  // rows: thread tid lifts staged row tid
        float x[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) x[c] = s_tile[tid * TP + c];
        if (px) inv97_line<TC, 1>(x); else inv97_line<TC, 0>(x);
#pragma unroll
        for (int c = HALO; c < HALO + TW; ++c) s_tile[tid * TP + c] = x[c];
    }
    __syncthreads();
    float x[TR];  // columns: thread tid lifts column HALO + tid
#pragma unroll
    for (int r = 0; r < TR; ++r) x[r] = s_tile[r * TP + HALO + tid];
    if (h > 1) {
        if (py) inv97_line<TR, 1>(x); else inv97_line<TR, 0>(x);
    }
    if (x0 + tid >= w) return;
    float* out = dst + x0 + tid;
#pragma unroll
    for (int r = HALO; r < HALO + TH; ++r)
        if (y0 + r - HALO < h) out[(y0 + r - HALO) * ld_dst] = x[r];
}

// ---------------------------------------------------------------- K-k
// One forward level in one launch, out of place: a block lifts a FTH x FTW
// tile of the natural-order input and writes it to its packed places.
#define FTH 56          // input rows a tile
#define FTW 64          // input columns a tile: a row's halves are runs of 32
#define FTR (FTH + 2 * HALO)  // tile rows staged: 64
#define FTC (FTW + 2 * HALO)  // tile columns staged: 72
#define FTP (FTC + 1)         // pitch of a staged row (odd: a column reads no bank twice)
#define FWD_THREADS 96        // FTC columns, then FTH rows, a thread each

// x[c] += k * (x[c - 1] + x[c + 1]) for c = FIRST, FIRST + 2, ... inside
// (0, N - 1): the line's ends lack a neighbour and go stale
template <int N, int FIRST>
__device__ __forceinline__ void fwd_step(float (&x)[N], float k) {
#pragma unroll
    for (int c = FIRST == 0 ? 2 : 1; c < N - 1; c += 2)
        x[c] = __fadd_rn(x[c], __fmul_rn(k, __fadd_rn(x[c - 1], x[c + 1])));
}

// one axis of the forward on a line in registers, sample c low-pass iff
// (c & 1) == PAR: d += A (s + s), s += B (d + d), d += G (s + s),
// s += D (d + d), then s / K, d * K -- the plain version's operations in its
// order. After the four steps samples [HALO, N - HALO) are right.
template <int N, int PAR>
__device__ __forceinline__ void fwd97_line(float (&x)[N]) {
    fwd_step<N, 1 - PAR>(x, A97);
    fwd_step<N, PAR>(x, B97);
    fwd_step<N, 1 - PAR>(x, G97);
    fwd_step<N, PAR>(x, D97);
#pragma unroll
    for (int c = 0; c < N; ++c) x[c] = __fmul_rn(x[c], (c & 1) == PAR ? IK97 : K97);
}

// src: the natural-order input, row stride ld; ll: where the packed LL
// quadrant goes (rows [0, snv), columns [0, snh)), stride ld_ll; dst: the
// rest of the packed output, stride ld_dst (ll may be dst, with ld_ll ==
// ld_dst). A tile stages rows y0 - HALO .. and columns x0 - HALO .. of src
// (each reflected into the region), lifts every staged column in registers
// (a thread a column), then its FTH middle rows (a thread a row), which it
// leaves in shared memory as [s half | d half], and writes each middle
// row's halves, a warp a half. An axis of one sample is neither lifted nor
// scaled.
__global__ void __launch_bounds__(FWD_THREADS)
dwt97_fwd_tile(const float* __restrict__ src, int64_t ld, float* __restrict__ ll,
               int64_t ld_ll, float* __restrict__ dst, int64_t ld_dst, int h, int w, int py,
               int px) {
    extern __shared__ float s_tile[];  // FTR x FTP
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int y0 = blockIdx.y * FTH, x0 = blockIdx.x * FTW;
    int sx[(FTC + 31) / 32];  // this lane's staged columns lane, lane + 32, ...
#pragma unroll
    for (int k = 0; k < (FTC + 31) / 32; ++k) sx[k] = reflect(x0 - HALO + lane + 32 * k, w);
#pragma unroll 8
    for (int r = warp; r < FTR; r += FWD_THREADS / 32) {  // copies in flight, no registers held
        const float* row = src + reflect(y0 - HALO + r, h) * ld;
#pragma unroll
        for (int k = 0; k < (FTC + 31) / 32; ++k)
            if (lane + 32 * k < FTC)
                __pipeline_memcpy_async(&s_tile[r * FTP + lane + 32 * k], row + sx[k],
                                        sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (h > 1) {  // columns: every staged one, its FTH middle rows kept
        for (int c = tid; c < FTC; c += FWD_THREADS) {
            float x[FTR];
#pragma unroll
            for (int r = 0; r < FTR; ++r) x[r] = s_tile[r * FTP + c];
            if (py) fwd97_line<FTR, 1>(x); else fwd97_line<FTR, 0>(x);
#pragma unroll
            for (int r = HALO; r < HALO + FTH; ++r) s_tile[r * FTP + c] = x[r];
        }
        __syncthreads();
    }
    for (int i = tid; i < FTH; i += FWD_THREADS) {  // rows: staged row HALO + i
        float* row = s_tile + (HALO + i) * FTP;
        float x[FTC];
#pragma unroll
        for (int c = 0; c < FTC; ++c) x[c] = row[c];
        if (w > 1) {
            if (px) fwd97_line<FTC, 1>(x); else fwd97_line<FTC, 0>(x);
        }
        // middle column HALO + c is natural x0 + c: s at c >> 1 if (c & 1) == px
#pragma unroll
        for (int c = 0; c < FTW; ++c) row[((c & 1) == px ? 0 : FTW / 2) + (c >> 1)] = x[HALO + c];
    }
    __syncthreads();
    const int snv = py ? h / 2 : (h + 1) / 2, snh = px ? w / 2 : (w + 1) / 2;
    const int j = lane;  // sample j of a half: natural x0 + 2j + its phase
    if (j >= FTW / 2) return;
    for (int i = warp; i < 2 * FTH; i += FWD_THREADS / 32) {
        const int r = i >> 1, d = i & 1;
        const int y = y0 + r, x = x0 + 2 * j + (d ? 1 - px : px);
        if (y >= h || x >= w) continue;
        const int yp = packed(y, py, snv);
        float* out = !d && yp < snv ? ll + yp * ld_ll : dst + yp * ld_dst;
        out[(d ? snh : 0) + (x >> 1)] = s_tile[(HALO + r) * FTP + d * (FTW / 2) + j];
    }
}

// ---------------------------------------------------------------- the C entries
// a K-k tile's threads and shared bytes, and its blocks resident on one SM
extern "C" int dwt97_fwd_occupancy(int* threads, int* smem, int* blocks) {
    *threads = FWD_THREADS;
    *smem = FTR * FTP * (int)sizeof(float);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dwt97_fwd_tile, *threads,
                                                              *smem);
}

// Forward, one launch: the level of the natural-order src into the packed
// ll (its LL quadrant) and dst (the rest; see dwt97_fwd_tile); neither may
// overlap src.
extern "C" int dwt97_fwd_level(const void* src, int64_t ld, void* ll, int64_t ld_ll, void* dst,
                               int64_t ld_dst, int h, int w, int py, int px, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    static_assert(FTW / 2 <= 32 && FTC <= 96 && FWD_THREADS % 32 == 0, "a warp a half row");
    const dim3 grid((w + FTW - 1) / FTW, (h + FTH - 1) / FTH);
    dwt97_fwd_tile<<<grid, FWD_THREADS, FTR * FTP * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)src, ld, (float*)ll, ld_ll, (float*)dst, ld_dst, h, w, py, px);
    return (int)cudaGetLastError();
}

// a K-n tile's threads and shared bytes, and its blocks resident on one SM
extern "C" int dwt97_inv_occupancy(int* threads, int* smem, int* blocks) {
    *threads = INV_THREADS;
    *smem = TR * TP * (int)sizeof(float);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dwt97_inv_tile, *threads,
                                                              *smem);
}

// Inverse, one launch: the level of the packed ll/src (see dwt97_inv_tile)
// into dst, which must not overlap either.
extern "C" int dwt97_inv_level(const void* ll, int64_t ld_ll, const void* src, int64_t ld,
                               void* dst, int64_t ld_dst, int h, int w, int py, int px,
                               void* stream) {
    if (h <= 0 || w <= 0) return 0;
    static_assert(TR == INV_THREADS && TW == INV_THREADS && TC <= 96, "a thread a row, a column");
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
    dwt97_inv_tile<<<grid, INV_THREADS, TR * TP * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)ll, ld_ll, (const float*)src, ld, (float*)dst, ld_dst, h, w, py, px);
    return (int)cudaGetLastError();
}
