// K-l quant_deadzone and K-m dequant_midbin: per-band dead-zone scalar
// quantization of a tile's Mallat-packed float32 planes (T.800 E.1, encode)
// and its mid-bin reconstruction (E.1.1.2, decode).
//
// Replaces: grok_tpu/ops/jax_pipeline.py make_forward_fn (:96-102), an XLA
// fusion of sign(v) * floor(|v| / step) over the band slices, and
// make_inverse_fn (:177-190), (|q| + 0.5) * step; held to the host path's
// native/pipeline.cpp quant_bands and dequant_bands.
//
// Bound on an H100 (3.35 TB/s): bytes. One 4-byte sample in and one out a
// sample: a 3840x2160x3 tile moves 199 MB, 0.0594 ms.
//
// Design: one launch a tile over all its components, as many as one
// launch's parameters hold (MAX_COMPS components, MAX_BANDS bands; the
// wrapper groups the components of a larger tile). Blocks are band-major:
// a block covers TILE_ROWS rows by QX quads (four samples aligned to 16
// bytes of the output plane) of one band of one component, so the band's
// step is one register and no sample looks its band up. The components and
// bands travel by value in the kernel's parameters (__grid_constant__:
// read in place, never copied per thread); a block finds its band once, by
// a binary search of the bands' first blocks (prefix sums the C entry
// forms). A warp takes 32 neighbouring quads of a band row (512 contiguous
// bytes), and a thread loads its RPT rows before it computes any, so 64
// bytes a thread are in flight. A quad wholly inside its band row moves as
// one 16-byte load and one 16-byte store, where the input plane has the
// output's address modulo 16 (the wrapper allocates the output so); the
// quads at a row's two ends, which the neighbouring bands share, move
// sample by sample, each sample by the block of its own band. The bands
// tile the plane (the wrapper checks that their areas sum to the plane's),
// so nothing is zero-filled. The arithmetic is the host path's: the
// division is IEEE (__fdiv_rn), floorf and the sign follow, and the
// reconstruction's sum and product are rounded each on its own
// (__fadd_rn, __fmul_rn; the source is built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_COMPS 8    // components a launch (transform.QUANT_MAX_COMPS)
#define MAX_BANDS 112  // bands a launch (transform.QUANT_MAX_BANDS); the parameters stay under 4 KB
#define QX 32          // quads across a block tile: a warp
#define QY 8           // warps a block
#define RPT 4          // rows a thread
#define TILE_ROWS (QY * RPT)

struct QComp {
    const uint8_t* src;  // the input plane's sample 0
    uint8_t* dst;        // the output plane's sample 0
    long long W;         // samples a row
    int shift;           // (dst / 4) mod 4: quads start at dst samples 4k - shift
    int vec;             // src has dst's address modulo 16
};

struct QBand {
    int oy, ox, h, w;
    int tiles_x;  // block tiles across a row
    int first;    // the band's first block
    int comp;
    float step;
};

struct QArgs {
    QComp comp[MAX_COMPS];
    QBand band[MAX_BANDS];
    int nb;
};

template <bool QUANT>
__device__ __forceinline__ uint32_t convert(uint32_t x, float step) {
    if (QUANT) {
        const float v = __uint_as_float(x);
        int32_t q = (int32_t)floorf(__fdiv_rn(fabsf(v), step));
        if (v < 0) q = -q;
        return (uint32_t)q;
    }
    const int32_t q = (int32_t)x;
    const float mag = __int2float_rn(q < 0 ? -q : q);
    float rec = mag > 0.0f ? __fmul_rn(__fadd_rn(mag, 0.5f), step) : 0.0f;
    if (q < 0) rec = -rec;
    return __float_as_uint(rec);
}

template <bool QUANT>
__global__ void __launch_bounds__(QX * QY) band_kernel(const __grid_constant__ QArgs a) {
    const int bid = blockIdx.x;
    int lo = 0, hi = a.nb - 1;  // the last band whose first block is at most bid
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.band[mid].first <= bid)
            lo = mid;
        else
            hi = mid - 1;
    }
    const QBand& b = a.band[lo];
    const QComp& c = a.comp[b.comp];
    const int t = bid - b.first, ty = t / b.tiles_x;
    const int64_t jq = (int64_t)(t - ty * b.tiles_x) * QX + threadIdx.x;  // quad of the row
    const int r0 = ty * TILE_ROWS + threadIdx.y;
    const uint8_t* src = c.src - 4 * c.shift;  // quad k at byte 16k of both
    uint8_t* dst = c.dst - 4 * c.shift;
    uint32_t x[RPT][4];
    int64_t q[RPT];
    unsigned m[RPT];  // the quad's samples inside the band row, a bit each
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int r = r0 + k * QY;
        m[k] = 0;
        q[k] = 0;
        if (r < b.h) {
            const int64_t s = (int64_t)(b.oy + r) * c.W + b.ox + c.shift;  // the row's first sample
            q[k] = (s >> 2) + jq;
            const int64_t e0 = 4 * q[k];
            const int from = s > e0 ? (int)(s - e0) : 0;
            const int to = s + b.w < e0 + 4 ? (int)(s + b.w - e0) : 4;
            if (to > from) m[k] = ((1u << to) - 1) & ~((1u << from) - 1);
        }
        x[k][0] = x[k][1] = x[k][2] = x[k][3] = 0;
        if (m[k] == 0xF && c.vec) {
            const uint4 v = __ldg((const uint4*)(src + 16 * q[k]));
            x[k][0] = v.x;
            x[k][1] = v.y;
            x[k][2] = v.z;
            x[k][3] = v.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if ((m[k] >> j) & 1) x[k][j] = __ldg((const uint32_t*)(src + 16 * q[k] + 4 * j));
        }
    }
    const float step = b.step;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        if (!m[k]) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[k][j] = convert<QUANT>(x[k][j], step);
        if (m[k] == 0xF) {
            *(uint4*)(dst + 16 * q[k]) = make_uint4(x[k][0], x[k][1], x[k][2], x[k][3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if ((m[k] >> j) & 1) *(uint32_t*)(dst + 16 * q[k] + 4 * j) = x[k][j];
        }
    }
}

// The launch's parameters from comps: int64 [nc, 3] on the host (the input
// plane's address, the output plane's, samples a row; 4-byte samples) and
// bands: int32 [nb, 6] on the host (component 0 .. nc - 1, oy, ox, h, w,
// the float32 step's bits). Returns the blocks of the launch, or -1 for a
// count or a component out of range.
static int64_t make_args(QArgs& a, const int64_t* comps, const int32_t* bands, int nc, int nb) {
    if (nc < 1 || nc > MAX_COMPS || nb < 1 || nb > MAX_BANDS) return -1;
    memset(&a, 0, sizeof(a));
    for (int i = 0; i < nc; ++i) {
        const uint64_t s = (uint64_t)comps[3 * i], d = (uint64_t)comps[3 * i + 1];
        a.comp[i] = QComp{(const uint8_t*)s, (uint8_t*)d, (long long)comps[3 * i + 2],
                          (int)((d >> 2) & 3), ((s ^ d) & 15) == 0};
    }
    int64_t total = 0;
    for (int i = 0; i < nb; ++i) {
        const int32_t* d = bands + 6 * i;
        if (d[0] < 0 || d[0] >= nc) return -1;
        const QComp& c = a.comp[d[0]];
        const int oy = d[1], ox = d[2], h = d[3], w = d[4];
        float step;
        memcpy(&step, d + 5, 4);
        // quads a row touches: where every row starts at one alignment, its
        // count; else the most any alignment gives
        const int64_t nq = c.W % 4 == 0 ? ((c.shift + (int64_t)oy * c.W + ox) % 4 + w + 3) / 4
                                        : (w + 2) / 4 + 1;
        const int tiles_x = h > 0 && w > 0 ? (int)((nq + QX - 1) / QX) : 0;
        a.band[i] = QBand{oy, ox, h, w, tiles_x, (int)total, d[0], step};
        total += (int64_t)tiles_x * ((h + TILE_ROWS - 1) / TILE_ROWS);
        if (total > 0x7FFFFFFF) return -1;
    }
    a.nb = nb;
    return total;
}

static int launch(bool quant, const void* comps, const void* bands, int nc, int nb,
                  void* stream) {
    QArgs a;
    const int64_t total = make_args(a, (const int64_t*)comps, (const int32_t*)bands, nc, nb);
    if (total < 0) return (int)cudaErrorInvalidValue;
    if (total == 0) return 0;
    const dim3 block(QX, QY);
    cudaStream_t st = (cudaStream_t)stream;
    if (quant)
        band_kernel<true><<<(unsigned)total, block, 0, st>>>(a);
    else
        band_kernel<false><<<(unsigned)total, block, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// float32 planes -> int32 planes: sign(v) * floor(|v| / step)
extern "C" int quant_deadzone(const void* comps, const void* bands, int nc, int nb,
                              void* stream) {
    return launch(true, comps, bands, nc, nb, stream);
}

// int32 planes -> float32 planes: sign(q) * (|q| + 0.5) * step, 0 for q = 0
extern "C" int dequant_midbin(const void* comps, const void* bands, int nc, int nb,
                              void* stream) {
    return launch(false, comps, bands, nc, nb, stream);
}
