// K-i ebcot_decode: Part-1 (MQ) codeblock decode (T.800 Annex C and D)
// into signed coefficients, every codeblock style 0x3F.
//
// Replaces: grok_tpu/t1/ebcot_jax.py _build_decoder (:760; entry
// decode_cblks :1123), K5's decoder, the XLA program that runs all
// codeblocks of a batch in lockstep over the padded [h, w, N] geometry,
// one masked step per scan position. Written from what it computes, the
// scalar form of grok_tpu/t1/ebcot_np.py decode_cblks (:354) and the
// decode halves of _spp (:463), _mrp (:530) and _cup (:581): per codeblock,
// for each bit-plane from numbps - 1 down, SPP, MRP and CUP over stripes of
// four rows, column by column, as far as npasses reaches (the first plane
// has its cleanup pass only); run-length mode on full stripe columns; VSC
// (rows at a stripe's bottom see nothing below); RESET after each pass;
// SEGSYM (four UNIFORM decisions after each cleanup pass, dropped);
// TERMALL and BYPASS (after a pass that ends a codeword segment, the MQ
// decoder is re-primed, or a raw segment starts, on the next merged
// segment). Reads past a segment's end give 0xFF, as in the reference.
// Mid-bin reconstruction: a sample that becomes significant at plane p
// gets 3 << p in the scaled-by-2 domain, refinements add or take 1 << p,
// and the result is halved at the end (ebcot_jax.py :1007). A component
// with an ROI shift s (RGN, style bits 8-15) has each scaled magnitude of
// at least 1 << s shifted down by s before the halving, the scaled-domain
// rule of the reference's default decoder (native/t1_coder.cpp:1143-1158,
// t1/ebcot_np.py:447-455), not ebcot_jax.py:1182-1189's rule after it.
//
// Bound on an H100 (3.35 TB/s): bytes, each codeblock's segments read once
// and its int32 samples written once (about 0.04 ms at 3840x2160x3). What
// sets the time is the serial chain inside each codeblock: every MQ
// decision steers the scan, so a codeblock's decisions (35,004 in the
// largest of the 4K lossless53 image) run one after another. Design, the
// simple form first: one thread a codeblock, BLOCK_THREADS codeblocks a
// CUDA block (the HT coders' width). The flag plane (significant, visited,
// refined, negative) with a one-sample border and the 19 context states
// live in shared memory; the tables too. Magnitudes accumulate in the
// output tensor, which the thread alone touches; bytes come through __ldg.
// Nothing is handed to the host. The wrapper (t1/ebcot_cuda.py
// ebcot_decode) refuses numbps > 30, where the scaled magnitude would
// leave int32.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_CTX 19
#define CTX_MR0 14
#define CTX_RL 17
#define CTX_UNI 18
#define BLOCK_THREADS 4
#define F_SIG 1
#define F_VIS 2
#define F_REF 4
#define F_NEG 8

struct Tabs {
    uint16_t qe[47];
    uint8_t nmps[47], nlps[47], sw[47];
    uint8_t zc[180], scc[9], scx[9];
};

struct Dec {
    const uint8_t* p;  // the codeblock's bytes
    int total;         // how many it has
    uint8_t* cx;       // 19 contexts, state << 1 | mps
    const Tabs* t;
    int base, end, bp, ct;
    uint32_t a;
    uint64_t c;  // the reference's int64 register, masked to 32 bits at shifts
    int rbase, rend, rpos, rbits;
    uint32_t rtmp;
    bool rprev_ff;

    __device__ __forceinline__ uint32_t byte_at(int seg, int idx, int seg_end) const {
        const int pos = seg + idx;
        return (idx < seg_end && pos < total) ? (uint32_t)__ldg(p + pos) : 0xFFu;
    }
    __device__ __forceinline__ void bytein() {
        const uint32_t b = byte_at(base, bp, end);
        const uint32_t b1 = byte_at(base, bp + 1, end);
        if (b == 0xFF) {
            if (b1 > 0x8F) {  // a marker (or the end): feed 1 bits
                c += 0xFF00;
                ct = 8;
            } else {
                c += (uint64_t)b1 << 9;
                ct = 7;
                ++bp;
            }
        } else {
            c += (uint64_t)b1 << 8;
            ct = 8;
            ++bp;
        }
    }
    __device__ void init(int seg, int len) {  // INITDEC; contexts persist
        base = seg;
        end = len;
        bp = 0;
        c = (uint64_t)byte_at(base, 0, end) << 16;
        bytein();
        c = (c << 7) & 0xFFFFFFFFull;
        ct -= 7;
        a = 0x8000;
    }
    __device__ __forceinline__ void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c = (c << 1) & 0xFFFFFFFFull;
            --ct;
        } while (!(a & 0x8000));
    }
    __device__ __forceinline__ int decode(int ctx) {
        uint32_t v = cx[ctx];
        const int st = v >> 1, mps = v & 1;
        const uint32_t qe = t->qe[st];
        a -= qe;
        int d;
        if (((c >> 16) & 0xFFFF) < qe) {  // LPS interval: conditional exchange
            if (a < qe) {
                d = mps;
                v = (t->nmps[st] << 1) | mps;
            } else {
                d = 1 - mps;
                v = (t->nlps[st] << 1) | (mps ^ t->sw[st]);
            }
            a = qe;
            cx[ctx] = (uint8_t)v;
            renorm();
        } else {
            c -= (uint64_t)qe << 16;
            if (a & 0x8000) return mps;
            if (a < qe) {
                d = 1 - mps;
                v = (t->nlps[st] << 1) | (mps ^ t->sw[st]);
            } else {
                d = mps;
                v = (t->nmps[st] << 1) | mps;
            }
            cx[ctx] = (uint8_t)v;
            renorm();
        }
        return d;
    }
    __device__ void raw_init(int seg, int len) {
        rbase = seg;
        rend = len;
        rpos = 0;
        rbits = 0;
        rtmp = 0;
        rprev_ff = false;
    }
    __device__ __forceinline__ int raw_bit() {  // MSB first, 7 bits after 0xFF
        if (rbits == 0) {
            const uint32_t b = byte_at(rbase, rpos, rend);
            ++rpos;
            rbits = rprev_ff ? 7 : 8;
            rprev_ff = b == 0xFF;
            rtmp = b;
        }
        --rbits;
        return (rtmp >> rbits) & 1;
    }
    __device__ __forceinline__ int bit(int ctx, bool raw) { return raw ? raw_bit() : decode(ctx); }
};

__device__ __forceinline__ void reset_contexts(uint8_t* cx) {
    for (int k = 0; k < NUM_CTX; ++k) cx[k] = 0;
    cx[0] = 4 << 1;
    cx[CTX_RL] = 3 << 1;
    cx[CTX_UNI] = 46 << 1;
}

__device__ __forceinline__ bool term_after(int lpi, bool termall, bool bypass) {
    const int t = lpi == 0 ? 2 : (lpi - 1) % 3;
    return termall || (bypass && (lpi == 9 || (lpi > 9 && (t == 1 || t == 2))));
}

__device__ __forceinline__ bool pass_is_raw(int lpi, bool bypass) {
    const int kind = lpi == 0 ? 2 : (lpi - 1) % 3;
    return bypass && lpi >= 10 && kind != 2;
}

struct Block {
    uint8_t* F;  // flags, (h + 2) x (w + 2), sample (y, x) at (y + 1) * st + x + 1
    int32_t* o;  // output rows of bw
    int h, w, st, bw, o45;
    bool vsc;
    const Tabs* t;

    // zero-coding neighbourhood (h, v, d counts) of sample q in row y
    __device__ __forceinline__ int zc_index(int q, int y, int* cnt) const {
        const bool cut = vsc && (y & 3) == 3;
        const int hh = (F[q - 1] & F_SIG) + (F[q + 1] & F_SIG);
        const int up = q - st, dn = q + st;
        int vv = F[up] & F_SIG;
        int dd = (F[up - 1] & F_SIG) + (F[up + 1] & F_SIG);
        if (!cut) {
            vv += F[dn] & F_SIG;
            dd += (F[dn - 1] & F_SIG) + (F[dn + 1] & F_SIG);
        }
        *cnt = hh + vv + dd;
        return hh * 15 + vv * 5 + dd;
    }
    __device__ __forceinline__ int contrib(int q) const {
        const int f = F[q];
        return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
    }
    // sign decision of sample q (row y, column x) that just became significant
    __device__ __forceinline__ void make_significant(Dec& mq, int q, int y, int x, int plane,
                                                     bool raw) {
        const bool cut = vsc && (y & 3) == 3;
        const int hs = max(-1, min(1, contrib(q - 1) + contrib(q + 1)));
        const int vs = max(-1, min(1, contrib(q - st) + (cut ? 0 : contrib(q + st))));
        const int si = (hs + 1) * 3 + vs + 1;
        // a raw sign bit is the sign itself; an MQ one is xored with the
        // sign-coding predictor
        const int neg = raw ? mq.raw_bit() : (mq.decode(t->scc[si]) ^ t->scx[si]);
        F[q] |= F_SIG | (neg ? F_NEG : 0);
        o[y * bw + x] = 3 << plane;
    }

    __device__ void spp(Dec& mq, int plane, bool raw) {
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int rows = min(4, h - y0);
            for (int x = 0; x < w; ++x) {
                for (int k = 0; k < rows; ++k) {
                    const int y = y0 + k, q = (y + 1) * st + x + 1;
                    if (F[q] & F_SIG) continue;
                    int cnt;
                    const int zi = zc_index(q, y, &cnt);
                    if (cnt == 0) continue;
                    const int b = mq.bit(t->zc[o45 + zi], raw);
                    F[q] |= F_VIS;
                    if (b) make_significant(mq, q, y, x, plane, raw);
                }
            }
        }
    }

    __device__ void mrp(Dec& mq, int plane, bool raw) {
        const int step = 1 << plane;
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int rows = min(4, h - y0);
            for (int x = 0; x < w; ++x) {
                for (int k = 0; k < rows; ++k) {
                    const int y = y0 + k, q = (y + 1) * st + x + 1;
                    const int f = F[q];
                    if ((f & (F_SIG | F_VIS)) != F_SIG) continue;
                    int cnt;
                    zc_index(q, y, &cnt);
                    const int ctx = (f & F_REF) ? CTX_MR0 + 2 : (cnt ? CTX_MR0 + 1 : CTX_MR0);
                    const int b = mq.bit(ctx, raw);
                    o[y * bw + x] += b ? step : -step;
                    F[q] = (uint8_t)(f | F_REF);
                }
            }
        }
    }

    __device__ void cup(Dec& mq, int plane, bool segsym) {
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int rows = min(4, h - y0);
            for (int x = 0; x < w; ++x) {
                int k0 = 0;
                if (rows == 4) {
                    bool rl = true;
                    for (int k = 0; k < 4 && rl; ++k) {
                        const int y = y0 + k, q = (y + 1) * st + x + 1;
                        int cnt;
                        zc_index(q, y, &cnt);
                        rl = !(F[q] & (F_SIG | F_VIS)) && cnt == 0;
                    }
                    if (rl) {
                        if (!mq.decode(CTX_RL)) continue;  // four zeros
                        k0 = mq.decode(CTX_UNI) << 1;
                        k0 |= mq.decode(CTX_UNI);
                        const int y = y0 + k0;
                        make_significant(mq, (y + 1) * st + x + 1, y, x, plane, false);
                        ++k0;
                    }
                }
                for (int k = k0; k < rows; ++k) {
                    const int y = y0 + k, q = (y + 1) * st + x + 1;
                    if (F[q] & (F_SIG | F_VIS)) continue;
                    int cnt;
                    const int zi = zc_index(q, y, &cnt);
                    if (mq.decode(t->zc[o45 + zi])) make_significant(mq, q, y, x, plane, false);
                }
            }
        }
        if (segsym)
            for (int k = 0; k < 4; ++k) mq.decode(CTX_UNI);
    }
};

__global__ void __launch_bounds__(BLOCK_THREADS)
ebcot_dec_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
                 const int32_t* __restrict__ lanes, const int32_t* __restrict__ segl,
                 const int32_t* __restrict__ ctx_tab, const int32_t* __restrict__ mq_tab,
                 int32_t* __restrict__ out, int n, int max_segs, int bh, int bw,
                 int flag_bytes) {
    extern __shared__ uint8_t s_flags[];
    __shared__ Tabs s_t;
    __shared__ uint8_t s_cx[BLOCK_THREADS][NUM_CTX + 1];
    for (int k = threadIdx.x; k < 47; k += BLOCK_THREADS) {
        s_t.qe[k] = (uint16_t)mq_tab[k];
        s_t.nmps[k] = (uint8_t)mq_tab[47 + k];
        s_t.nlps[k] = (uint8_t)mq_tab[94 + k];
        s_t.sw[k] = (uint8_t)mq_tab[141 + k];
    }
    for (int k = threadIdx.x; k < 180; k += BLOCK_THREADS) s_t.zc[k] = (uint8_t)ctx_tab[k];
    for (int k = threadIdx.x; k < 9; k += BLOCK_THREADS) {
        s_t.scc[k] = (uint8_t)ctx_tab[180 + k];
        s_t.scx[k] = (uint8_t)ctx_tab[189 + k];
    }
    __syncthreads();
    const int i = blockIdx.x * BLOCK_THREADS + threadIdx.x;
    if (i >= n) return;
    const int nb = lanes[i], npass = lanes[n + i];
    const int h = lanes[2 * n + i], w = lanes[3 * n + i];
    const int orient = lanes[4 * n + i], style = lanes[5 * n + i], length = lanes[6 * n + i];
    if (nb <= 0 || npass <= 0 || h <= 0 || w <= 0) return;  // the output stays zero

    const bool termall = style & 0x04, bypass = style & 0x01, reset = style & 0x02;
    const bool segmented = termall || bypass;
    const int32_t* sl = segl + (int64_t)i * max_segs;
    Block blk;
    blk.F = s_flags + threadIdx.x * flag_bytes;
    blk.o = out + (int64_t)i * bh * bw;
    blk.h = h;
    blk.w = w;
    blk.st = w + 2;
    blk.bw = bw;
    blk.o45 = orient * 45;
    blk.vsc = style & 0x08;
    blk.t = &s_t;
    const int fsize = (h + 2) * (w + 2);
    for (int k = 0; k < fsize; ++k) blk.F[k] = 0;

    Dec mq;
    mq.p = data + starts[i];
    mq.total = length;
    mq.cx = s_cx[threadIdx.x];
    mq.t = &s_t;
    reset_contexts(mq.cx);
    mq.raw_init(0, 0);
    mq.init(0, segmented ? sl[0] : length);
    int seg_i = 0, seg_off = 0;

    auto end_pass = [&](int lpi) {
        if (reset) reset_contexts(mq.cx);
        if (!segmented || !term_after(lpi, termall, bypass) || lpi + 1 >= npass) return;
        seg_off += sl[min(seg_i, max_segs - 1)];
        ++seg_i;
        const int nxt = seg_i < max_segs ? sl[seg_i] : 0;
        if (pass_is_raw(lpi + 1, bypass)) mq.raw_init(seg_off, nxt);
        else mq.init(seg_off, nxt);
    };

    for (int plane = nb - 1; plane >= 0; --plane) {
        if (plane == nb - 1) {  // the first plane has its cleanup pass only
            blk.cup(mq, plane, style & 0x20);
            end_pass(0);
        } else {
            const int lp = (nb - 2 - plane) * 3 + 1;
            if (lp >= npass) break;
            blk.spp(mq, plane, pass_is_raw(lp, bypass));
            end_pass(lp);
            if (lp + 1 >= npass) break;
            blk.mrp(mq, plane, pass_is_raw(lp + 1, bypass));
            end_pass(lp + 1);
            if (lp + 2 >= npass) break;
            blk.cup(mq, plane, style & 0x20);
            end_pass(lp + 2);
        }
        for (int k = 0; k < fsize; ++k) blk.F[k] &= ~F_VIS;  // next plane: unvisited
    }

    // the ROI downshift (style bits 8-15) in the scaled domain, before the
    // half bit is dropped, as native/t1_coder.cpp:1143-1158 does; a shift of
    // 32 or more exceeds every magnitude and leaves it as it is
    const uint32_t rs = ((uint32_t)style >> 8) & 0xFF;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            uint32_t m2 = (uint32_t)blk.o[y * bw + x];
            if (rs && rs < 32 && m2 >= (1u << rs)) m2 >>= rs;
            const int32_t m = (int32_t)(m2 >> 1);
            blk.o[y * bw + x] = (blk.F[(y + 1) * blk.st + x + 1] & F_NEG) ? -m : m;
        }
    }
}

// data: the codeblocks' bytes, one flat uint8 buffer; starts [n] int64;
// lanes [7, n] int32 (numbps, npasses, height, width, orient, style,
// length); segl [n, max_segs] int32 merged segment lengths; ctx_tab [198]
// and mq_tab [4, 47] int32; out [n, bh, bw] int32, zeroed by the caller;
// flag_bytes: shared bytes a codeblock's flag plane takes (the largest
// (h + 2) * (w + 2) of the batch).
extern "C" int ebcot_decode(const void* data, const void* starts, const void* lanes,
                            const void* segl, const void* ctx_tab, const void* mq_tab,
                            void* out, int n, int max_segs, int bh, int bw, int flag_bytes,
                            void* stream) {
    if (n <= 0) return 0;
    if (max_segs < 1 || flag_bytes < 9) return (int)cudaErrorInvalidValue;
    ebcot_dec_kernel<<<(n + BLOCK_THREADS - 1) / BLOCK_THREADS, BLOCK_THREADS,
                       BLOCK_THREADS * flag_bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lanes,
        (const int32_t*)segl, (const int32_t*)ctx_tab, (const int32_t*)mq_tab,
        (int32_t*)out, n, max_segs, bh, bw, flag_bytes);
    return (int)cudaGetLastError();
}
