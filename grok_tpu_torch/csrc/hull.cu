// K-q hull_slopes: the effective rate-distortion slope of every coding pass
// of a batch of codeblocks after convex-hull pruning, what PCRD's layer
// search compares with its threshold.
//
// Replaces: native/pipeline.cpp:630 hull_slopes, the host C++ that
// grok_tpu's default path runs for t2/rate_control.py hull_effective_slopes
// (:17; its plain loop :41-77, which is this kernel's plain version). Not a
// TPU kernel: the reference runs it on the host.
//
// Bound on an H100 (3.35 TB/s): bytes. It reads the rates (int64) and
// distortions (float64) of each coded pass once and writes the slopes
// (float64) of every pass slot once: 2.9 MB for the 6,321 codeblocks of a
// 4K 9/7 image (63,111 coded passes in 37 slots a codeblock), 0.00087 ms.
// Design: one thread a codeblock. The hull is a stack whose pops depend on
// every earlier vertex, so a codeblock is one serial chain; its cumulative
// distortions and the stack live in the thread's local memory. Every sum,
// difference and quotient is written as an IEEE-rounded double intrinsic in
// the host code's order (and the source is built with -fmad=false), so the
// slopes equal the host's bit for bit: PCRD compares them with a
// threshold, and a last-bit difference can move a pass across it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PASSES 256  // t2/rate_control.py HULL_MAX_PASSES
#define BLOCK_THREADS 64

__global__ void hull_kernel(const int64_t* __restrict__ rates,
                            const double* __restrict__ dists,
                            const int32_t* __restrict__ npasses,
                            double* __restrict__ slopes, int n, int pmax) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    double* srow = slopes + (int64_t)i * pmax;
    for (int k = 0; k < pmax; k++) srow[k] = 0.0;
    int np_i = npasses[i];
    if (np_i > pmax) np_i = pmax;
    if (np_i <= 0) return;
    const int64_t* r = rates + (int64_t)i * pmax;
    const double* dd = dists + (int64_t)i * pmax;
    double d_cum[MAX_PASSES];
    int hull[MAX_PASSES];
    double acc = 0.0;
    for (int k = 0; k < np_i; k++) {
        acc = __dadd_rn(acc, dd[k]);
        d_cum[k] = acc;
    }
    auto R = [&](int j) { return j >= 0 ? (double)r[j] : 0.0; };
    auto D = [&](int j) { return j >= 0 ? d_cum[j] : 0.0; };
    auto slope = [](double d, double dr) {
        return __ddiv_rn(d, dr > 1e-9 ? dr : 1e-9);
    };
    int hn = 0;
    for (int k = 0; k < np_i; k++) {
        if (d_cum[k] <= D(hn ? hull[hn - 1] : -1)) continue;  // no gain: never a vertex
        while (hn) {
            const int prev = hn >= 2 ? hull[hn - 2] : -1;
            const double s_top = slope(__dsub_rn(D(hull[hn - 1]), D(prev)),
                                       __dsub_rn(R(hull[hn - 1]), R(prev)));
            const double s_new = slope(__dsub_rn(d_cum[k], D(prev)),
                                       __dsub_rn((double)r[k], R(prev)));
            if (s_new >= s_top)
                hn--;
            else
                break;
        }
        hull[hn++] = k;
    }
    int prev_idx = -1;
    double r0 = 0.0, d0 = 0.0;
    for (int j = 0; j < hn; j++) {
        const int h = hull[j];
        const double seg = slope(__dsub_rn(d_cum[h], d0), __dsub_rn((double)r[h], r0));
        for (int k = prev_idx + 1; k <= h; k++) srow[k] = seg;
        r0 = (double)r[h];
        d0 = d_cum[h];
        prev_idx = h;
    }
    // passes after the last vertex keep slope 0 (never included)
}

// rates [n, pmax] int64 (monotone); dists [n, pmax] float64; npasses [n]
// int32; slopes [n, pmax] float64 out. pmax <= MAX_PASSES.
extern "C" int hull_slopes(const void* rates, const void* dists, const void* npasses,
                           void* slopes, int n, int pmax, void* stream) {
    if (n <= 0) return 0;
    if (pmax <= 0 || pmax > MAX_PASSES) return (int)cudaErrorInvalidValue;
    hull_kernel<<<(n + BLOCK_THREADS - 1) / BLOCK_THREADS, BLOCK_THREADS, 0,
                  (cudaStream_t)stream>>>(
        (const int64_t*)rates, (const double*)dists, (const int32_t*)npasses,
        (double*)slopes, n, pmax);
    return (int)cudaGetLastError();
}
