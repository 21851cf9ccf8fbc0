// K-c ebcot_symbols: Part-1 EBCOT encode context modelling (T.800 D.3).
//
// Replaces: grok_tpu/t1/ebcot_pallas.py _build_kernel_wide (:70, pallas_call
// at :362), the TPU's one Pallas kernel. For every (bit-plane, SPP/MRP/CUP
// pass, stripe, column, row) it emits one byte record
//     valid << 7 | raw << 6 | bit << 5 | ctx
// at a fixed slot, in the layout _encode_wide hands to its packers:
//     out[p][pass][slot][lane], p = 0..pmaxc-1 codes plane pmaxc-1-p,
//     SPP slot (s*w + x)*8 + 2k + {0 zc, 1 sign},
//     MRP slot (s*w + x)*4 + k,
//     CUP slot (s*w + x)*11 + {0 rl, 1-2 uni, 3+2k zc, 4+2k sign},
//     CUP slots ns*w*11 + 0..3 the SEGSYM 1010 tail, every other slot 0.
// Records that are not valid still carry the bit and context the TPU kernel
// computes for them, so the byte arrays are identical.
//
// Bound on an H100 (3.35 TB/s): bytes. The record array is the output:
// pmaxc*3*s_pad bytes per codeblock (64x64 at pmaxc 16: 541 KB), 3.4 GB for
// the ~6,300 codeblocks of a 3840x2160x3 image, ~1 ms. Design: one thread
// per codeblock walks planes, passes, stripes, columns and rows in the
// order of the standard, so the scan has no lockstep masking. The flag
// plane (sig 1, visited 2, refined 4, sign 8) is uint8 in global memory,
// lane-minor ([(Hp+2)(W+2)][n]), and a column's 6x3 flag window rides in
// registers while the scan moves along the stripe (one new column loaded
// per step). Coefficients and records are lane-minor as well, so a warp's
// loads and one-byte record stores fall on 32 adjacent bytes. All
// codeblocks launch at once, 32 threads (one warp) per block; at ~6,300
// codeblocks the card holds ~200 warps, far too few to hide memory latency
// -- the known limit of this simple form. The TPU kernel's sublane packing,
// VMEM budget search, unrolled stripes and stripe-gridded output are TPU
// compiler rules and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#define CTX_MR0 14
#define CTX_RL 17
#define CTX_UNI 18

__device__ __forceinline__ uint8_t rec(bool valid, bool raw, int bit, int ctx) {
    return (uint8_t)((valid ? 0x80 : 0) | ((raw && valid) ? 0x40 : 0) |
                     ((bit & 1) << 5) | ctx);
}

__device__ __forceinline__ int sg(int f) { return f & 1; }

// significance contribution to the sign context: +1, -1 or 0
__device__ __forceinline__ int con(int f) { return (f & 1) * (1 - 2 * ((f >> 3) & 1)); }

__device__ __forceinline__ int clamp1(int v) { return v < -1 ? -1 : (v > 1 ? 1 : v); }

// window rows: index j = padded row y0 + j (block rows y0-1 .. y0+4)
struct Win {
    int L[6], M[6], R[6];
};

// zero-coding neighbour counts for row k of the window (dnc: VSC cut)
__device__ __forceinline__ void zc_counts(const Win& W, int k, bool dnc, int& h,
                                          int& v, int& d) {
    h = sg(W.L[k + 1]) + sg(W.R[k + 1]);
    v = sg(W.M[k]) + (dnc ? 0 : sg(W.M[k + 2]));
    d = sg(W.L[k]) + sg(W.R[k]) + (dnc ? 0 : sg(W.L[k + 2]) + sg(W.R[k + 2]));
}

__device__ __forceinline__ int sc_index(const Win& W, int k, bool dnc) {
    const int below = dnc ? 0 : con(W.M[k + 2]);
    const int hb = clamp1(con(W.L[k + 1]) + con(W.R[k + 1]));
    const int vb = clamp1(con(W.M[k]) + below);
    return (hb + 1) * 3 + (vb + 1);
}

__global__ void __launch_bounds__(32)
ebcot_symbols_kernel(const int32_t* __restrict__ coef,   // [h][w][n]
                     const int32_t* __restrict__ lanes,  // [5][n]
                     const int32_t* __restrict__ tab,    // [198]
                     uint8_t* __restrict__ flags,        // [(Hp+2)(w+2)][n]
                     uint8_t* __restrict__ out,          // [pmaxc][3][s_pad][n]
                     int n, int h, int w, int pmaxc, int64_t s_pad) {
    __shared__ int s_tab[198];
    for (int i = threadIdx.x; i < 198; i += blockDim.x) s_tab[i] = tab[i];
    __syncthreads();
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= n) return;

    const int Hp = (h + 3) & ~3;
    const int NS = Hp >> 2;
    const int Wp = w + 2;
    const int nb = lanes[l];
    const int hgt = lanes[n + l];
    const int wid = lanes[2 * n + l];
    const int orient = lanes[3 * n + l];
    const int sty = lanes[4 * n + l];
    const bool vsc = (sty & 0x08) != 0;
    const bool segsym = (sty & 0x20) != 0;
    const bool bypass = (sty & 0x01) != 0;
    const int* zc = s_tab + orient * 45;
    const int* scc = s_tab + 180;
    const int* scx = s_tab + 189;
    const int64_t N = n;

#define FL(y, x) flags[((int64_t)(y) * Wp + (x)) * N + l]
#define COEF(y, x) ((y) < h ? coef[((int64_t)(y) * w + (x)) * N + l] : 0)

    // flag bit 3 = static sign plane; bits 0..2 start clear
    for (int y = 0; y < Hp + 2; y++)
        for (int x = 0; x < Wp; x++) {
            const int yy = y - 1, xx = x - 1;
            const bool neg = yy >= 0 && yy < h && xx >= 0 && xx < w &&
                             coef[((int64_t)yy * w + xx) * N + l] < 0;
            FL(y, x) = neg ? 8 : 0;
        }

    for (int p = 0; p < pmaxc; p++) {
        const int plane = pmaxc - 1 - p;
        const bool spp_m = nb - 1 > plane;
        const bool cup_m = nb - 1 >= plane;
        const int rel = nb - 1 - plane;
        const bool raw_spp = bypass && (rel <= 0 ? 0 : (rel - 1) * 3 + 1) >= 10;
        const bool raw_mrp = bypass && (rel <= 0 ? 0 : (rel - 1) * 3 + 2) >= 10;
        uint8_t* o_spp = out + ((int64_t)p * 3 + 0) * s_pad * N + l;
        uint8_t* o_mrp = out + ((int64_t)p * 3 + 1) * s_pad * N + l;
        uint8_t* o_cup = out + ((int64_t)p * 3 + 2) * s_pad * N + l;

        // ---------------------------------------------------------- SPP
        for (int s = 0; s < NS; s++) {
            const int y0 = 4 * s;
            Win W;
#pragma unroll
            for (int j = 0; j < 6; j++) {
                W.L[j] = FL(y0 + j, 0);
                W.M[j] = FL(y0 + j, 1);
            }
            for (int x = 0; x < w; x++) {
#pragma unroll
                for (int j = 0; j < 6; j++) W.R[j] = FL(y0 + j, x + 2);
#pragma unroll
                for (int k = 0; k < 4; k++) {
                    const bool dnc = vsc && k == 3;
                    int hh, vv, dd;
                    zc_counts(W, k, dnc, hh, vv, dd);
                    const int ctx = zc[hh * 15 + vv * 5 + dd];
                    const int selff = W.M[k + 1];
                    const int y = y0 + k;
                    const int c = COEF(y, x);
                    const int mag = c < 0 ? -c : c;
                    const int sgn = c < 0 ? 1 : 0;
                    const bool inb = y < hgt && x < wid && spp_m;
                    const bool code = inb && (selff & 1) == 0 && hh + vv + dd > 0;
                    const int bit = (mag >> plane) & 1;
                    const int64_t slot0 = ((int64_t)s * w + x) * 8 + k * 2;
                    o_spp[slot0 * N] = rec(code, raw_spp, bit, ctx);
                    const bool became = code && bit == 1;
                    const int si = sc_index(W, k, dnc);
                    const int sbit = raw_spp ? sgn : (sgn ^ scx[si]);
                    o_spp[(slot0 + 1) * N] = rec(became, raw_spp, sbit, scc[si]);
                    W.M[k + 1] = selff | (became ? 1 : 0) | (code ? 2 : 0);
                }
#pragma unroll
                for (int k = 0; k < 4; k++) FL(y0 + k + 1, x + 1) = (uint8_t)W.M[k + 1];
#pragma unroll
                for (int j = 0; j < 6; j++) {
                    W.L[j] = W.M[j];
                    W.M[j] = W.R[j];
                }
            }
        }
        for (int64_t i = (int64_t)NS * w * 8; i < s_pad; i++) o_spp[i * N] = 0;

        // ---------------------------------------------------------- MRP
        for (int s = 0; s < NS; s++) {
            const int y0 = 4 * s;
            Win W;
#pragma unroll
            for (int j = 0; j < 6; j++) {
                W.L[j] = FL(y0 + j, 0);
                W.M[j] = FL(y0 + j, 1);
            }
            for (int x = 0; x < w; x++) {
#pragma unroll
                for (int j = 0; j < 6; j++) W.R[j] = FL(y0 + j, x + 2);
#pragma unroll
                for (int k = 0; k < 4; k++) {
                    const bool dnc = vsc && k == 3;
                    int hh, vv, dd;
                    zc_counts(W, k, dnc, hh, vv, dd);
                    const int selff = W.M[k + 1];
                    const int y = y0 + k;
                    const int c = COEF(y, x);
                    const int mag = c < 0 ? -c : c;
                    const bool inb = y < hgt && x < wid && spp_m;
                    const bool code = inb && (selff & 1) != 0 && (selff & 2) == 0;
                    const int ctx = (selff & 4) ? CTX_MR0 + 2
                                                : (hh + vv + dd > 0 ? CTX_MR0 + 1 : CTX_MR0);
                    const int bit = (mag >> plane) & 1;
                    o_mrp[(((int64_t)s * w + x) * 4 + k) * N] = rec(code, raw_mrp, bit, ctx);
                    W.M[k + 1] = selff | (code ? 4 : 0);
                }
#pragma unroll
                for (int k = 0; k < 4; k++) FL(y0 + k + 1, x + 1) = (uint8_t)W.M[k + 1];
#pragma unroll
                for (int j = 0; j < 6; j++) {
                    W.L[j] = W.M[j];
                    W.M[j] = W.R[j];
                }
            }
        }
        for (int64_t i = (int64_t)NS * w * 4; i < s_pad; i++) o_mrp[i * N] = 0;

        // ---------------------------------------------------------- CUP
        for (int s = 0; s < NS; s++) {
            const int y0 = 4 * s;
            const bool full_stripe = y0 + 4 <= hgt;
            Win W;
#pragma unroll
            for (int j = 0; j < 6; j++) {
                W.L[j] = FL(y0 + j, 0);
                W.M[j] = FL(y0 + j, 1);
            }
            for (int x = 0; x < w; x++) {
#pragma unroll
                for (int j = 0; j < 6; j++) W.R[j] = FL(y0 + j, x + 2);
                int mag[4], sgn[4];
#pragma unroll
                for (int k = 0; k < 4; k++) {
                    const int c = COEF(y0 + k, x);
                    mag[k] = c < 0 ? -c : c;
                    sgn[k] = c < 0 ? 1 : 0;
                }
                // run-length eligibility on the column's state at its start
                bool rl = full_stripe && x < wid && cup_m;
#pragma unroll
                for (int k = 0; k < 4; k++) {
                    int hh, vv, dd;
                    zc_counts(W, k, vsc && k == 3, hh, vv, dd);
                    rl = rl && (W.M[k + 1] & 3) == 0 && hh + vv + dd == 0;
                }
                int fk = 4;
#pragma unroll
                for (int k = 3; k >= 0; k--)
                    if (rl && ((mag[k] >> plane) & 1)) fk = k;
                const bool rl_bit = rl && fk < 4;
                const int64_t base = ((int64_t)s * w + x) * 11;
                o_cup[base * N] = rec(rl, false, rl_bit ? 1 : 0, CTX_RL);
                const bool sigcol = rl && rl_bit;
                o_cup[(base + 1) * N] = rec(sigcol, false, (fk >> 1) & 1, CTX_UNI);
                o_cup[(base + 2) * N] = rec(sigcol, false, fk & 1, CTX_UNI);
                const bool skip_rl0 = rl && !rl_bit;
#pragma unroll
                for (int k = 0; k < 4; k++) {
                    const bool dnc = vsc && k == 3;
                    const int selff = W.M[k + 1];
                    const int y = y0 + k;
                    const bool inb = y < hgt && x < wid && cup_m;
                    const bool bse = inb && (selff & 3) == 0 && !skip_rl0;
                    const bool pre_run = sigcol && k < fk;
                    const bool implied = sigcol && k == fk;
                    const bool zc_code = bse && !pre_run && !implied;
                    int hh, vv, dd;
                    zc_counts(W, k, dnc, hh, vv, dd);
                    const int bit = (mag[k] >> plane) & 1;
                    o_cup[(base + 3 + 2 * k) * N] =
                        rec(zc_code, false, bit, zc[hh * 15 + vv * 5 + dd]);
                    const bool became = (zc_code && bit == 1) || implied;
                    const int si = sc_index(W, k, dnc);
                    o_cup[(base + 4 + 2 * k) * N] =
                        rec(became, false, sgn[k] ^ scx[si], scc[si]);
                    W.M[k + 1] = selff | (became ? 1 : 0);
                }
                // 'visited' is read only by its own position within a pass,
                // so it is cleared as the column is stored
#pragma unroll
                for (int k = 0; k < 4; k++)
                    FL(y0 + k + 1, x + 1) = (uint8_t)(W.M[k + 1] & ~2);
#pragma unroll
                for (int j = 0; j < 6; j++) {
                    W.L[j] = W.M[j];
                    W.M[j] = W.R[j];
                }
            }
        }
        const int64_t tail = (int64_t)NS * w * 11;
        const bool seg = segsym && cup_m;
        o_cup[tail * N] = rec(seg, false, 1, CTX_UNI);
        o_cup[(tail + 1) * N] = rec(seg, false, 0, CTX_UNI);
        o_cup[(tail + 2) * N] = rec(seg, false, 1, CTX_UNI);
        o_cup[(tail + 3) * N] = rec(seg, false, 0, CTX_UNI);
        for (int64_t i = tail + 4; i < s_pad; i++) o_cup[i * N] = 0;
    }
#undef FL
#undef COEF
}

extern "C" int ebcot_symbols(const void* coef, const void* lanes, const void* tab,
                             void* flags, void* out, int n, int h, int w,
                             int pmaxc, int64_t s_pad, void* stream) {
    if (n <= 0) return 0;
    const int threads = 32;
    ebcot_symbols_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)coef, (const int32_t*)lanes, (const int32_t*)tab,
        (uint8_t*)flags, (uint8_t*)out, n, h, w, pmaxc, s_pad);
    return (int)cudaGetLastError();
}
