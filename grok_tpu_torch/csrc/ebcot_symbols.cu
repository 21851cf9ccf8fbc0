// K-c ebcot_symbols: Part-1 EBCOT encode context modelling (T.800 D.3).
//
// Replaces: grok_tpu/t1/ebcot_pallas.py _build_kernel_wide (:70, pallas_call
// at :362), the TPU's one Pallas kernel. For every (bit-plane, SPP/MRP/CUP
// pass, stripe, column, row) it emits one byte record
//     valid << 7 | raw << 6 | bit << 5 | ctx
// at a fixed slot, codeblock-major as the Pallas kernel emits them:
//     out[lane][p][pass][slot], p = 0..pmaxc-1 codes plane pmaxc-1-p,
//     SPP slot (s*w + x)*8 + 2k + {0 zc, 1 sign},
//     MRP slot (s*w + x)*4 + k,
//     CUP slot (s*w + x)*11 + {0 rl, 1-2 uni, 3+2k zc, 4+2k sign},
//     CUP slots ns*w*11 + 0..3 the SEGSYM 1010 tail, every other slot 0.
// Records that are not valid still carry the bit and context the TPU kernel
// computes for them, and the planes above a codeblock's numbps are written
// too, so the byte arrays are identical.
//
// Bound on an H100 (3.35 TB/s): bytes, the record array written once
// (pmaxc*3*s_pad bytes a codeblock, 270 KB at 64x64 and pmaxc 8, 1.7 GB for
// the 6,321 codeblocks of a 3840x2160x3 image, ~0.5 ms). What sets the time
// is the scan's chain of dependent column steps, so the design cuts that
// chain and keeps the state next to the SM:
//  - A group of G = min(ns, 32) lanes owns one codeblock; lane s owns stripe
//    s. One warp takes 32/G codeblocks (two 64x64 blocks), fewer where their
//    shared memory would not fit. ns > 32 runs in rounds of 32 stripes, each
//    round after the previous one has finished.
//  - SPP and CUP run as a wavefront: at step t lane s codes column
//    x = t - 2s, and the warp synchronises between steps. Stripe s-1 then
//    has finished columns up to x+1 (it is one step ahead by two columns),
//    and stripe s+1 has not reached x-1, so the values read across stripe
//    boundaries are those of the sequential scan. w + 2(G-1) steps a pass
//    (94 at 64x64) in place of ns*w (1,024).
//  - MRP decides nothing that another decision of the pass reads, so all
//    stripes run at once.
//  - Until a codeblock's first CUP pass nothing in it is significant, so
//    its contexts are fixed. Where that holds for every codeblock of the
//    warp (the planes above every numbps, a quarter of the planes at
//    3840x2160x3, where most codeblocks code 6 of 8, and SPP and MRP of the
//    first coded plane) the warp fills the pass's records position by
//    position, all lanes at once.
//  - The magnitudes' bit-planes and the (Hp+2) x (w+2) flag plane (sig 1,
//    visited 2, refined 4, sign 8) live in shared memory, staged once with
//    coalesced loads; each lane's 6x3 flag window rides in registers along
//    its stripe. A stripe column's four bits of two planes share a byte
//    (pmaxc*ns*w/2 bytes, 4 KB at 64x64 and pmaxc 8, in place of 16 KB of
//    int32), so five warps of two 64x64 codeblocks fit on an SM, not three.
//  - A pass's records go to a shared buffer of s_pad bytes (8 or 4 byte
//    stores for SPP and MRP), and the warp writes it out with 16-byte stores,
//    zeros past the pass's last slot.
// The TPU kernel's sublane packing, VMEM budget search, unrolled stripes and
// stripe-gridded output are TPU compiler rules and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#define CTX_MR0 14
#define CTX_RL 17
#define CTX_UNI 18

__device__ __forceinline__ uint32_t rec(bool valid, bool raw, int bit, int ctx) {
    return (valid ? 0x80u : 0u) | ((raw && valid) ? 0x40u : 0u) |
           ((uint32_t)(bit & 1) << 5) | (uint32_t)ctx;
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

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// 8 record bytes at off of a shared buffer, zero from byte len on
__device__ __forceinline__ uint2 load8(const uint8_t* src, int off, int len) {
    if (off + 8 <= len) return *(const uint2*)(src + off);
    uint32_t lo = 0, hi = 0;
    for (int i = 0; i < 8 && off + i < len; i++) {
        const uint32_t b = (uint32_t)src[off + i] << (8 * (i & 3));
        if (i < 4) lo |= b; else hi |= b;
    }
    return make_uint2(lo, hi);
}

// The warp writes one pass's records (s_pad bytes, len of them from the
// shared buffer, the rest zero) to dst, which is 8-byte aligned.
__device__ __forceinline__ void copy_out(uint8_t* __restrict__ dst, const uint8_t* src,
                                         int len, int s_pad, int lane) {
    const int head = ((uintptr_t)dst & 15) ? 8 : 0;
    if (head && lane == 0) *(uint2*)dst = load8(src, 0, len);
    const int units = (s_pad - head) >> 4;
    for (int u = lane; u < units; u += 32) {
        const int off = head + 16 * u;
        const uint2 a = load8(src, off, len), b = load8(src, off + 8, len);
        *(uint4*)(dst + off) = make_uint4(a.x, a.y, b.x, b.y);
    }
    if (((s_pad - head) & 8) && lane == 0)
        *(uint2*)(dst + s_pad - 8) = load8(src, s_pad - 8, len);
}

__global__ void __launch_bounds__(32)
ebcot_symbols_kernel(const int32_t* __restrict__ coef,   // [n][h][w]
                     const int32_t* __restrict__ lanes,  // [5][n]
                     const int32_t* __restrict__ tab,    // [198]
                     uint8_t* __restrict__ out,          // [n][pmaxc][3][s_pad]
                     int n, int h, int w, int pmaxc, int s_pad, int G, int cpw) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int s_tab[198];
    const int lane = threadIdx.x;
    for (int i = lane; i < 198; i += 32) s_tab[i] = tab[i];

    const int Hp = (h + 3) & ~3;
    const int NS = Hp >> 2;
    const int Wp = w + 2;
    const int mag_b = round16(pmaxc / 2 * NS * w);
    const int fl_b = round16((Hp + 2) * Wp);
    const int per_cb = mag_b + fl_b + round16(s_pad);
    const int cb0 = blockIdx.x * cpw;
    const int ncb = min(cpw, n - cb0);

    // ---- stage magnitudes and the flag plane (sign in bit 3), warp-wide.
    // Magnitudes as bit-plane columns: byte (plane/2, s, x) holds the four
    // rows of stripe s, column x, of planes 2(plane/2) (low nibble) and
    // 2(plane/2) + 1 (high nibble).
    for (int j = 0; j < ncb; j++) {
        uint8_t* mg = smem + j * per_cb;
        uint8_t* fl = smem + j * per_cb + mag_b;
        const int32_t* c = coef + (int64_t)(cb0 + j) * h * w;
        for (int i = lane; i < NS * w; i += 32) {
            const int s = i / w, x = i - s * w;
            uint32_t m[4];
#pragma unroll
            for (int k = 0; k < 4; k++) {
                const int v = 4 * s + k < h ? c[(4 * s + k) * w + x] : 0;
                m[k] = (uint32_t)(v < 0 ? -v : v);
            }
            for (int pp = 0; pp < pmaxc / 2; pp++) {
                uint32_t b = 0;
#pragma unroll
                for (int k = 0; k < 4; k++)
                    b |= ((m[k] >> (2 * pp)) & 1) << k | ((m[k] >> (2 * pp + 1)) & 1) << (k + 4);
                mg[pp * NS * w + i] = (uint8_t)b;
            }
        }
        for (int i = lane; i < (Hp + 2) * Wp; i += 32) {
            const int yy = i / Wp - 1, xx = i % Wp - 1;
            fl[i] = (yy >= 0 && yy < h && xx >= 0 && xx < w && c[yy * w + xx] < 0) ? 8 : 0;
        }
    }
    __syncwarp();

    const int slot = lane / G;
    const int gl = lane - slot * G;
    const bool active = slot < ncb;
    const int cb = cb0 + (active ? slot : 0);
    const uint8_t* mg = smem + (active ? slot : 0) * per_cb;
    uint8_t* fl = smem + (active ? slot : 0) * per_cb + mag_b;
    uint8_t* rb = fl + fl_b;  // this pass's records

    const int nb = lanes[cb];
    const int hgt = lanes[n + cb];
    const int wid = lanes[2 * n + cb];
    const int orient = lanes[3 * n + cb];
    const int sty = lanes[4 * n + cb];
    const bool vsc = (sty & 0x08) != 0;
    const bool segsym = (sty & 0x20) != 0;
    const bool bypass = (sty & 0x01) != 0;
    const int* zc = s_tab + orient * 45;
    const int* scc = s_tab + 180;
    const int* scx = s_tab + 189;
    const int rounds = (NS + G - 1) / G;
    const int steps = w + 2 * (G - 1);

#define FL(y, x) fl[(y) * Wp + (x)]
// the four bits of this plane in stripe s, column x (row k in bit k)
#define BITS4(s, x) ((bp[(s) * w + (x)] >> bsh) & 15)

    for (int p = 0; p < pmaxc; p++) {
        const int plane = pmaxc - 1 - p;
        const uint8_t* bp = mg + (plane >> 1) * NS * w;
        const int bsh = (plane & 1) * 4;
        const bool spp_m = nb - 1 > plane;
        const bool cup_m = nb - 1 >= plane;
        const int rel = nb - 1 - plane;
        const bool raw_spp = bypass && (rel <= 0 ? 0 : (rel - 1) * 3 + 1) >= 10;
        const bool raw_mrp = bypass && (rel <= 0 ? 0 : (rel - 1) * 3 + 2) >= 10;
        // no sample of the warp's codeblocks is significant before this
        // plane's CUP (SPP and MRP of the first coded plane and every pass
        // above it): no flag but the sign is set, so every context is fixed
        // and a record is its own position's bit and sign alone
        const bool quiet_sm = __all_sync(0xFFFFFFFFu, !active || !spp_m);
        const bool quiet_c = __all_sync(0xFFFFFFFFu, !active || !cup_m);

        for (int pass = 0; pass < 3; pass++) {
            if (pass == 2 ? quiet_c : quiet_sm) {
                // ------------------------------- any pass, all positions at once
                // These bytes must equal what the general passes below write
                // with no significant neighbour: ZC context zc[0], MRP context
                // CTX_MR0, CTX_RL and CTX_UNI, sign context index 4, nothing
                // valid. The card tests compare whole record arrays.
                const uint32_t sc0 = s_tab[180 + 4], sx0 = s_tab[189 + 4];
                for (int j = 0; j < ncb; j++) {
                    const uint8_t* bj = smem + j * per_cb + (plane >> 1) * NS * w;
                    const uint8_t* fj = smem + j * per_cb + mag_b;
                    uint8_t* rj = smem + j * per_cb + mag_b + fl_b;
                    const uint32_t zc0 = s_tab[lanes[3 * n + cb0 + j] * 45];
                    for (int i = lane; i < NS * w; i += 32) {
                        const int s = i / w, x = i - s * w;
                        const uint32_t b4 = (bj[i] >> bsh) & 15;
                        uint32_t zcr[4], sgr[4];
#pragma unroll
                        for (int k = 0; k < 4; k++) {
                            const uint32_t sgn = (fj[(4 * s + k + 1) * Wp + x + 1] >> 3) & 1;
                            zcr[k] = ((b4 >> k) & 1) << 5 | zc0;
                            sgr[k] = (sgn ^ sx0) << 5 | sc0;
                        }
                        if (pass == 0) {
                            *(uint2*)(rj + i * 8) =
                                make_uint2(zcr[0] | sgr[0] << 8 | zcr[1] << 16 | sgr[1] << 24,
                                           zcr[2] | sgr[2] << 8 | zcr[3] << 16 | sgr[3] << 24);
                        } else if (pass == 1) {
                            uint32_t word = 0;
#pragma unroll
                            for (int k = 0; k < 4; k++)
                                word |= (((b4 >> k) & 1) << 5 | CTX_MR0) << (8 * k);
                            *(uint32_t*)(rj + i * 4) = word;
                        } else {
                            uint8_t* o = rj + i * 11;
                            o[0] = CTX_RL;
                            o[1] = CTX_UNI;
                            o[2] = CTX_UNI;
#pragma unroll
                            for (int k = 0; k < 4; k++) {
                                o[3 + 2 * k] = (uint8_t)zcr[k];
                                o[4 + 2 * k] = (uint8_t)sgr[k];
                            }
                        }
                    }
                }
            } else if (pass == 1) {
                // ---------------------------------------- MRP, all stripes at once
                for (int s = gl; active && s < NS; s += G) {
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
                        const int b4 = BITS4(s, x);
                        uint32_t word = 0;
#pragma unroll
                        for (int k = 0; k < 4; k++) {
                            const bool dnc = vsc && k == 3;
                            int hh, vv, dd;
                            zc_counts(W, k, dnc, hh, vv, dd);
                            const int selff = W.M[k + 1];
                            const int y = y0 + k;
                            const bool inb = y < hgt && x < wid && spp_m;
                            const bool code = inb && (selff & 1) != 0 && (selff & 2) == 0;
                            const int ctx = (selff & 4) ? CTX_MR0 + 2
                                                        : (hh + vv + dd > 0 ? CTX_MR0 + 1 : CTX_MR0);
                            const int bit = (b4 >> k) & 1;
                            word |= rec(code, raw_mrp, bit, ctx) << (8 * k);
                            W.M[k + 1] = selff | (code ? 4 : 0);
                        }
                        *(uint32_t*)(rb + (s * w + x) * 4) = word;
#pragma unroll
                        for (int k = 0; k < 4; k++) FL(y0 + k + 1, x + 1) = (uint8_t)W.M[k + 1];
#pragma unroll
                        for (int j = 0; j < 6; j++) {
                            W.L[j] = W.M[j];
                            W.M[j] = W.R[j];
                        }
                    }
                }
            } else {
                // ------------------------------- SPP / CUP, a wavefront of stripes
                for (int r = 0; r < rounds; r++) {
                    const int s = r * G + gl;
                    const bool on = active && s < NS;
                    const int y0 = 4 * s;
                    const bool full_stripe = y0 + 4 <= hgt;
                    Win W;
                    for (int t = 0; t < steps; t++) {
                        const int x = t - 2 * gl;
                        if (on && x >= 0 && x < w) {
                            if (x == 0) {
#pragma unroll
                                for (int j = 0; j < 6; j++) {
                                    W.L[j] = FL(y0 + j, 0);
                                    W.M[j] = FL(y0 + j, 1);
                                }
                            }
#pragma unroll
                            for (int j = 0; j < 6; j++) W.R[j] = FL(y0 + j, x + 2);
                            const int b4 = BITS4(s, x);
                            if (pass == 0) {
                                uint32_t lo = 0, hi = 0;
#pragma unroll
                                for (int k = 0; k < 4; k++) {
                                    const bool dnc = vsc && k == 3;
                                    int hh, vv, dd;
                                    zc_counts(W, k, dnc, hh, vv, dd);
                                    const int ctx = zc[hh * 15 + vv * 5 + dd];
                                    const int selff = W.M[k + 1];
                                    const int y = y0 + k;
                                    const int sgn = (selff >> 3) & 1;
                                    const bool inb = y < hgt && x < wid && spp_m;
                                    const bool code = inb && (selff & 1) == 0 && hh + vv + dd > 0;
                                    const int bit = (b4 >> k) & 1;
                                    const bool became = code && bit == 1;
                                    const int si = sc_index(W, k, dnc);
                                    const int sbit = raw_spp ? sgn : (sgn ^ scx[si]);
                                    const uint32_t two = rec(code, raw_spp, bit, ctx) |
                                                         (rec(became, raw_spp, sbit, scc[si]) << 8);
                                    if (k < 2) lo |= two << (16 * k);
                                    else hi |= two << (16 * (k - 2));
                                    W.M[k + 1] = selff | (became ? 1 : 0) | (code ? 2 : 0);
                                }
                                *(uint2*)(rb + (s * w + x) * 8) = make_uint2(lo, hi);
#pragma unroll
                                for (int k = 0; k < 4; k++)
                                    FL(y0 + k + 1, x + 1) = (uint8_t)W.M[k + 1];
                            } else {
                                int sgn[4];
#pragma unroll
                                for (int k = 0; k < 4; k++) sgn[k] = (W.M[k + 1] >> 3) & 1;
                                // run-length eligibility on the column's state at its start
                                bool rl = full_stripe && x < wid && cup_m;
#pragma unroll
                                for (int k = 0; k < 4; k++) {
                                    int hh, vv, dd;
                                    zc_counts(W, k, vsc && k == 3, hh, vv, dd);
                                    rl = rl && (W.M[k + 1] & 3) == 0 && hh + vv + dd == 0;
                                }
                                // the first row whose bit is set, 4 if none
                                const int fk = rl && b4 ? __ffs(b4) - 1 : 4;
                                const bool rl_bit = rl && fk < 4;
                                uint8_t* o = rb + (s * w + x) * 11;
                                o[0] = (uint8_t)rec(rl, false, rl_bit ? 1 : 0, CTX_RL);
                                const bool sigcol = rl && rl_bit;
                                o[1] = (uint8_t)rec(sigcol, false, (fk >> 1) & 1, CTX_UNI);
                                o[2] = (uint8_t)rec(sigcol, false, fk & 1, CTX_UNI);
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
                                    const int bit = (b4 >> k) & 1;
                                    o[3 + 2 * k] =
                                        (uint8_t)rec(zc_code, false, bit, zc[hh * 15 + vv * 5 + dd]);
                                    const bool became = (zc_code && bit == 1) || implied;
                                    const int si = sc_index(W, k, dnc);
                                    o[4 + 2 * k] =
                                        (uint8_t)rec(became, false, sgn[k] ^ scx[si], scc[si]);
                                    W.M[k + 1] = selff | (became ? 1 : 0);
                                }
                                // 'visited' is read only by its own position within
                                // a pass, so it is cleared as the column is stored
#pragma unroll
                                for (int k = 0; k < 4; k++)
                                    FL(y0 + k + 1, x + 1) = (uint8_t)(W.M[k + 1] & ~2);
                            }
#pragma unroll
                            for (int j = 0; j < 6; j++) {
                                W.L[j] = W.M[j];
                                W.M[j] = W.R[j];
                            }
                        }
                        __syncwarp();
                    }
                }
            }
            if (pass == 2 && active && gl == 0) {  // the SEGSYM tail
                const bool seg = segsym && cup_m;
                uint8_t* o = rb + NS * w * 11;
                o[0] = (uint8_t)rec(seg, false, 1, CTX_UNI);
                o[1] = (uint8_t)rec(seg, false, 0, CTX_UNI);
                o[2] = (uint8_t)rec(seg, false, 1, CTX_UNI);
                o[3] = (uint8_t)rec(seg, false, 0, CTX_UNI);
            }
            __syncwarp();
            const int len = pass == 0 ? NS * w * 8 : (pass == 1 ? NS * w * 4 : NS * w * 11 + 4);
            for (int j = 0; j < ncb; j++)
                copy_out(out + (((int64_t)(cb0 + j) * pmaxc + p) * 3 + pass) * s_pad,
                         smem + j * per_cb + mag_b + fl_b, len, s_pad, lane);
            __syncwarp();
        }
    }
#undef FL
#undef BITS4
}

// Launch geometry: G lanes per codeblock, cpw codeblocks per warp (one warp
// per block), and the dynamic shared memory that takes.
extern "C" int ebcot_symbols(const void* coef, const void* lanes, const void* tab,
                             void* out, int n, int h, int w, int pmaxc,
                             int64_t s_pad, void* stream) {
    if (n <= 0) return 0;
    const int Hp = (h + 3) & ~3;
    const int ns = Hp / 4;
    const int G = ns < 32 ? ns : 32;
    const int per_cb = ((pmaxc / 2 * ns * w + 15) & ~15) + (((Hp + 2) * (w + 2) + 15) & ~15) +
                       (int)((s_pad + 15) & ~15);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int avail = optin - (int)(198 * sizeof(int)) - 1024;
    int cpw = 32 / G;
    if (cpw * per_cb > avail) cpw = avail / per_cb;
    if (cpw < 1) return (int)cudaErrorInvalidValue;
    const int bytes = cpw * per_cb;
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(ebcot_symbols_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
    }
    ebcot_symbols_kernel<<<(n + cpw - 1) / cpw, 32, bytes, (cudaStream_t)stream>>>(
        (const int32_t*)coef, (const int32_t*)lanes, (const int32_t*)tab, (uint8_t*)out,
        n, h, w, pmaxc, (int)s_pad, G, cpw);
    return (int)cudaGetLastError();
}
