// K-k dwt97_fwd_level and K-n dwt97_inv_level: one level of the forward and
// of the inverse irreversible 9/7 wavelet (T.800 F.4.8.2 and F.3.8.2), on
// the Mallat-packed top-left h x w region of a float32 plane, in place.
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
// move ~265 MB, 0.08 ms. Design: a block stages whole lines in shared
// memory, deinterleaved into their low-pass half s [0, sn) and high-pass half
// d [sn, n), and runs the four lifting steps over them with __syncthreads()
// between steps, then the 1/K and K scaling. Staging the whole line makes
// every step clamp into the opposite-phase array exactly as the native row
// code does (d[j] += A * (s[j] + s[min(j + 1, sn - 1)]) and so on), with no
// halo logic. A horizontal pass gives a block one row (neighbouring threads
// on neighbouring samples); a vertical pass gives it G neighbouring columns
// (element k of column g at buf[k * G + g], so a load of G consecutive
// columns is one coalesced segment). Each block owns its lines, so both
// passes work in place. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, and the source is built with -fmad=false),
// as the host path computes them. A line of one sample is left unscaled in
// both parities (ops/dwt.py:154-158). The origin parity of the level's rect
// decides which phase is low-pass: sample p is low-pass iff (p & 1) == par,
// at index p >> 1 of its phase.

#include <cuda_runtime.h>
#include <stdint.h>

// the constants of native/pipeline.cpp:28-33
#define A97 ((float)-1.586134342059924)
#define B97 ((float)-0.052980118572961)
#define G97 ((float)0.882911075530934)
#define D97 ((float)0.443506852043971)
#define K97 ((float)1.230174104914001)
#define IK97 ((float)(1.0 / 1.230174104914001))

// dynamic shared memory a block may use: a line of at most 51200 samples
// (transform.MAX_LINE_97)
static const int kMaxSmem = 200 * 1024;

// one lifting step over a group of lines staged as buf[k * G + g]:
// tgt[t] += sign * c * (src[l] + src[r]) for every t of the target phase
// (nt samples at offset to) from the source phase (ns samples at offset so);
// the neighbours are src[t + lo] and src[t + hi], clamped into [0, ns)
__device__ __forceinline__ void lift_step(float* buf, int G, int to, int nt, int so,
                                          int ns, int lo, int hi, float c, bool sub) {
    for (int idx = threadIdx.x; idx < nt * G; idx += blockDim.x) {
        const int t = idx / G, g = idx - t * G;
        const int l = min(max(t + lo, 0), ns - 1), r = min(max(t + hi, 0), ns - 1);
        const float sum = __fadd_rn(buf[(so + l) * G + g], buf[(so + r) * G + g]);
        const float p = __fmul_rn(c, sum);
        float& x = buf[(to + t) * G + g];
        x = sub ? __fsub_rn(x, p) : __fadd_rn(x, p);
    }
    __syncthreads();
}

// neighbour offsets, T.800's symmetric extension as a clamp: a d sample's s
// neighbours are (j, j + 1) for parity 0 and (j - 1, j) for parity 1; an s
// sample's d neighbours are (i - 1, i) for parity 0 and (i, i + 1) for parity 1
template <bool FWD>
__global__ void dwt97_lines(float* plane, int n, int nlines, int G,
                            int64_t elem_step, int64_t line_step, int par) {
    extern __shared__ float buf[];
    const int line0 = blockIdx.x * G;
    const int g_here = min(G, nlines - line0);
    float* base = plane + (int64_t)line0 * line_step;
    const int sn = par ? n / 2 : (n + 1) / 2, dn = n - sn;
    // load: forward deinterleaves (natural -> [s | d]); inverse reads packed
    for (int idx = threadIdx.x; idx < n * G; idx += blockDim.x) {
        const int p = idx / G, g = idx - p * G;
        if (g >= g_here) continue;
        const float v = base[g * line_step + p * elem_step];
        const int k = FWD ? (((p & 1) == par) ? (p >> 1) : sn + (p >> 1)) : p;
        buf[k * G + g] = v;
    }
    __syncthreads();
    const int d_lo = par ? -1 : 0, d_hi = par ? 0 : 1;   // d's s neighbours
    const int s_lo = par ? 0 : -1, s_hi = par ? 1 : 0;   // s's d neighbours
    if (FWD) {
        lift_step(buf, G, sn, dn, 0, sn, d_lo, d_hi, A97, false);
        lift_step(buf, G, 0, sn, sn, dn, s_lo, s_hi, B97, false);
        lift_step(buf, G, sn, dn, 0, sn, d_lo, d_hi, G97, false);
        lift_step(buf, G, 0, sn, sn, dn, s_lo, s_hi, D97, false);
        for (int idx = threadIdx.x; idx < n * G; idx += blockDim.x) {
            const int k = idx / G, g = idx - k * G;
            if (g >= g_here) continue;
            base[g * line_step + k * elem_step] = __fmul_rn(buf[idx], k < sn ? IK97 : K97);
        }
    } else {
        for (int idx = threadIdx.x; idx < n * G; idx += blockDim.x) {
            const int k = idx / G;
            buf[idx] = __fmul_rn(buf[idx], k < sn ? K97 : IK97);
        }
        __syncthreads();
        lift_step(buf, G, 0, sn, sn, dn, s_lo, s_hi, D97, true);
        lift_step(buf, G, sn, dn, 0, sn, d_lo, d_hi, G97, true);
        lift_step(buf, G, 0, sn, sn, dn, s_lo, s_hi, B97, true);
        lift_step(buf, G, sn, dn, 0, sn, d_lo, d_hi, A97, true);
        for (int idx = threadIdx.x; idx < n * G; idx += blockDim.x) {
            const int p = idx / G, g = idx - p * G;
            if (g >= g_here) continue;
            const int k = ((p & 1) == par) ? (p >> 1) : sn + (p >> 1);
            base[g * line_step + p * elem_step] = buf[k * G + g];
        }
    }
}

// lines of n samples, elem_step apart, line_step between lines
template <bool FWD>
static int run_lines(float* plane, int n, int nlines, int64_t elem_step,
                     int64_t line_step, int par, cudaStream_t st) {
    if (n <= 1 || nlines <= 0) return 0;  // a lone sample stays as it is
    if ((int64_t)n * 4 > kMaxSmem) return (int)cudaErrorInvalidValue;
    int G = 1;
    if (elem_step != 1)  // vertical: several neighbouring columns a block
        while (G < 32 && (int64_t)n * 4 * G * 2 <= 96 * 1024) G *= 2;
    const size_t smem = (size_t)n * G * 4;
    int rc = (int)cudaFuncSetAttribute(dwt97_lines<FWD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc) return rc;
    const int threads = 256;
    const int blocks = (nlines + G - 1) / G;
    dwt97_lines<FWD><<<blocks, threads, smem, st>>>(plane, n, nlines, G, elem_step,
                                                line_step, par);
    return (int)cudaGetLastError();
}

// plane: packed float32 plane with row stride ld; the level is its top-left
// h x w with origin parities py, px. Forward: vertical, then horizontal.
extern "C" int dwt97_fwd_level(void* plane, int ld, int h, int w, int py, int px,
                               void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    float* p = (float*)plane;
    int rc = run_lines<true>(p, h, w, ld, 1, py, st);
    if (rc) return rc;
    return run_lines<true>(p, w, h, 1, ld, px, st);
}

// Inverse: horizontal, then vertical.
extern "C" int dwt97_inv_level(void* plane, int ld, int h, int w, int py, int px,
                               void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    float* p = (float*)plane;
    int rc = run_lines<false>(p, w, h, 1, ld, px, st);
    if (rc) return rc;
    return run_lines<false>(p, h, w, ld, 1, py, st);
}

// The horizontal halves alone (K6's _fwd97_h_local and _inv97_h_local,
// grok_tpu/parallel/mesh.py:207, :229, with the origin parity px).
extern "C" int dwt97_fwd_h(void* plane, int ld, int h, int w, int px, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    return run_lines<true>((float*)plane, w, h, 1, ld, px, (cudaStream_t)stream);
}

extern "C" int dwt97_inv_h(void* plane, int ld, int h, int w, int px, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    return run_lines<false>((float*)plane, w, h, 1, ld, px, (cudaStream_t)stream);
}
