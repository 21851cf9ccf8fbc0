// K-p ebcot_pass_dist: the distortion decrease of every coding pass of a
// batch of Part-1 codeblocks, in float64, from the symbol records of the
// scan (K-c) and the coefficients. PCRD weighs each pass's decrease against
// its rate.
//
// Replaces: the distortion half of K5-enc, grok_tpu/t1/ebcot_jax.py
// _build_encoder (:504; _dd_sig_f32 / _dd_ref_f32 :472-488). Its parity
// target is grok_tpu's default path, the native host coder
// (native/t1_coder.cpp enc_spp :479, enc_mrp :541, enc_cup :618), which
// sums float64 decreases one sample at a time in scan order; K5-enc sums in
// float32 and is not followed.
//
// Bound on an H100 (3.35 TB/s): bytes. It reads the records of every coded
// pass once (1 byte a slot) and the coefficients (4 bytes a sample), and
// writes 8 bytes a pass; about 0.25 ms for the 4K batch (0.84 GB of coded
// records).
// Design: one warp per (codeblock, pass). The lanes read 32 consecutive
// positions of the pass's record row (coalesced), each forms its sample's
// decrease, and the warp adds the significant ones into one float64 sum in
// slot order -- the ballot's set bits in ascending order, each term
// broadcast by a shuffle. Slot order is the native coder's scan order
// (stripe, column, row), so the sequential sum is bit-identical to it at
// any magnitude; a tree reduction would be exact only while every partial
// sum stays an exact dyadic. Every product and sum is an IEEE-rounded
// double intrinsic (and the source is built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS_PER_BLOCK 4
#define VALID 0x80

__global__ void ebcot_dist_kernel(const uint8_t* __restrict__ sym,
                                  const int32_t* __restrict__ coeffs,
                                  const int32_t* __restrict__ numbps,
                                  double* __restrict__ dist, int n, int pmaxc,
                                  int s_pad, int h, int w, int max_passes) {
    const int lane = threadIdx.x & 31;
    const int64_t wid = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (wid >= (int64_t)n * max_passes) return;
    const int i = (int)(wid / max_passes);
    const int j = (int)(wid % max_passes);  // lane-local pass index
    const int nb = numbps[i];
    const int npasses = nb > 0 ? 3 * nb - 2 : 0;
    if (j >= npasses) {
        if (lane == 0) dist[wid] = 0.0;
        return;
    }
    // pass 0 is the cleanup of the top plane; then SPP, MRP, CUP per plane
    const int rel = j == 0 ? 0 : (j - 1) / 3 + 1;
    const int kind = j == 0 ? 2 : (j - 1) % 3;
    const int plane = nb - 1 - rel;
    const uint8_t* rec = sym + (((int64_t)i * pmaxc + (pmaxc - 1 - plane)) * 3 + kind) * s_pad;
    const int32_t* blk = coeffs + (int64_t)i * h * w;
    const int ns = (h + 3) >> 2;
    const int npos = ns * w * 4;  // positions (stripe, column, row)
    const double c1 = ldexp(3.0, plane), c2 = ldexp(2.25, 2 * plane);
    const double full = ldexp(1.0, plane), half = ldexp(0.5, plane);
    const int64_t m1 = (int64_t(2) << plane) - 1, m2 = (int64_t(1) << plane) - 1;
    double acc = 0.0;
    for (int base = 0; base < npos; base += 32) {
        const int q = base + lane;
        bool valid = false;
        double term = 0.0;
        if (q < npos) {
            // the slot of position q in this pass's record row
            const int slot = kind == 0 ? 2 * q + 1                           // SPP sign
                           : kind == 1 ? q                                   // MRP
                                       : (q >> 2) * 11 + 4 + 2 * (q & 3);    // CUP sign
            valid = (rec[slot] & VALID) != 0;
            if (valid) {
                const int s = q / (4 * w), x = (q >> 2) % w, y = 4 * s + (q & 3);
                const int32_t v = y < h ? blk[(int64_t)y * w + x] : 0;
                const int64_t m = v < 0 ? -(int64_t)v : (int64_t)v;
                if (kind == 1) {
                    const double a1 = __dsub_rn((double)(m & m1), full);
                    const double a2 = __dsub_rn((double)(m & m2), half);
                    term = __dsub_rn(__dmul_rn(a1, a1), __dmul_rn(a2, a2));
                } else {
                    term = __dsub_rn(__dmul_rn(c1, (double)m), c2);
                }
            }
        }
        unsigned set = __ballot_sync(0xffffffffu, valid);
        while (set) {  // uniform across the warp: every lane keeps the same sum
            const int l = __ffs(set) - 1;
            set &= set - 1;
            acc = __dadd_rn(acc, __shfl_sync(0xffffffffu, term, l));
        }
    }
    if (lane == 0) dist[wid] = acc;
}

// sym [n, pmaxc, 3, s_pad] uint8 (K-c's records); coeffs [n, h, w] int32;
// numbps [n] int32; dist [n, max_passes] float64 out.
extern "C" int ebcot_pass_dist(const void* sym, const void* coeffs, const void* numbps,
                               void* dist, int n, int pmaxc, int s_pad, int h, int w,
                               int max_passes, void* stream) {
    if (n <= 0 || max_passes <= 0) return 0;
    const int64_t warps = (int64_t)n * max_passes;
    const int64_t blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    ebcot_dist_kernel<<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)sym, (const int32_t*)coeffs, (const int32_t*)numbps, (double*)dist,
        n, pmaxc, s_pad, h, w, max_passes);
    return (int)cudaGetLastError();
}
