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
// largest of the 4K lossless53 image) run one after another, and the card
// runs as many chains side by side as it holds codeblocks.
//
// Design: one codeblock a warp. Lane 0 runs the decision chain; the 32
// lanes share the work off it, with __syncwarp() between phases: zeroing
// the state, clearing the visited bits and adding the magnitudes of the
// samples that became significant after each bit-plane, and the writeout
// (sign, ROI shift, halving) as coalesced int32 stores. The state
// is the stripe word of the reference's default decoder (the layout of
// native/t1_coder.cpp:214-227, its passes :646-835), one word per
// (stripe, column) in shared memory, no border:
//   bits 0-17   significance of columns {left, self, right} x rows -1..4,
//               bit col * 6 + row + 1
//   bits 18-21  visited, rows 0-3 (coded earlier in this bit-plane)
//   bits 22-25  refined, rows 0-3
//   bits 26-31  sign of the self column, rows -1..4 (1 = negative)
// The left and right columns' signs come from the neighbouring words' bits
// 27-30: a 32-bit word, half the shared memory of the reference's 64-bit
// one that holds them too.
// A zero-coding or sign context is then one word and one table lookup (9-
// and 8-bit keys; a stripe's last row drops its row-below bits under VSC),
// SPP jumps to the next row with a significant neighbour (nbr4), the
// run-length test is one compare, and for widths up to 64 per-stripe column
// bits (activity, all four rows significant) skip whole columns. MRP's
// contexts are fixed for its whole pass, so the warp lists them (32 columns
// at a time, a prefix sum over the lanes), lane 0 decodes the list back to
// back and the lanes apply the refinements. The MQ contexts hold their
// table entry (Qe, MPS and the two next entries), so a decision reads one
// word; the fewest instructions a decision win over fewer branches, since
// a full card of chains is bound by its issue slots. Bytes
// come through a register window of three aligned 32-bit words; the third
// is loaded four bytes before it is needed, with the bytes past the
// segment's readable ones (past the segment or past the codeblock's bytes)
// set to 0xFF as it is loaded, so the byte reads carry no such test; a
// word with no readable byte is not loaded at all. Magnitudes
// accumulate in the zeroed output with fire-and-forget atomic adds made by
// the lanes (MRP's refinements, and each plane's new significances, found
// against a byte a stripe word of rows already added); the writeout reads
// them through L2. Nothing of the magnitudes is on lane 0's chain, and
// each instruction off it counts: on a full card the chains share the
// SMs' issue slots (PERF.md §6 has the measurements). The coding
// tables are built from ctx_tab and mq_tab once per block, in static
// shared memory. The wrapper (t1/ebcot_cuda.py ebcot_decode) sizes a warp's
// shared state from the batch's largest codeblock, refuses numbps > 30
// (the scaled magnitude would leave int32) and codeblocks over 4096
// samples, and launches the codeblocks longest first when the batch takes
// more than one wave.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_CTX 19
#define CTX_MR0 14
#define CTX_RL 17
#define CTX_UNI 18
#define MAX_WARPS 16
#define CX_BYTES 80  // a warp's 19 context entries, padded (DEC_CX_BYTES of the wrapper)
#define MR_BYTES 144  // a warp's MRP chunk: 128 contexts, each then its bit (DEC_MR_BYTES)

#define SIG18 0x3FFFFu
#define VIS4 (0xFu << 18)
// what a stripe's row 3 must not see under VSC: row 4's significance in
// each column and its sign (bit 31); no other row's context reads them
#define VSC_CUT ((1u << 5) | (1u << 11) | (1u << 17) | (1u << 31))

// the block's tables: 94 MQ entries (state * 2 + mps: the MPS in bit 0,
// the entry after an MPS in bits 1-7, after an LPS in bits 8-14, Qe in bits
// 16-31), the zero-coding context of each 9-bit key for each orientation,
// the sign context (bits 0-4) and predictor (bit 7) of each 10-bit key
// (DEC_TAB_BYTES of the wrapper: 3,448 bytes)
__shared__ uint32_t s_mq[94];
__shared__ uint8_t s_zc[4 * 512];
__shared__ uint8_t s_sc[1024];

// a zero-coding table's address as a 32-bit shared-window address, and the
// byte there: held in a register, where the compiler would rebuild the
// table's address at every lookup (on the host, where the device code is
// built for testing, an offset into s_zc)
__device__ __forceinline__ uint32_t shared_addr(const uint8_t* p) {
#ifdef __CUDA_ARCH__
    return (uint32_t)__cvta_generic_to_shared(p);
#else
    return (uint32_t)(p - s_zc);
#endif
}
__device__ __forceinline__ uint32_t lds_u8(uint32_t a) {
#ifdef __CUDA_ARCH__
    uint32_t v;
    asm("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
#else
    return s_zc[a];
#endif
}

// a segment's bytes: a window of three aligned words in registers. Each
// word's bytes from vend on (past the segment's readable bytes) are set to
// 0xFF as it is loaded, so every byte past them reads 0xFF; a word with a
// readable byte lies inside the flat buffer (4-aligned, a multiple of 4
// bytes long: the wrapper pads it), and no other word is loaded
struct Src {
    const uint8_t* al;  // the address of lo
    const uint8_t* vend;
    uint32_t lo, hi, nxt;
    int off;  // the current byte's index in hi:lo (0-3)

    __device__ __forceinline__ uint32_t word(const uint8_t* a) const {
        const int n = (int)min(max((long long)(vend - a), 0LL), 4LL);  // readable bytes
        return n == 4 ? __ldg((const uint32_t*)a)
                      : (n ? __ldg((const uint32_t*)a) : 0u) | (0xFFFFFFFFu << (8 * n));
    }
    __device__ __forceinline__ void start(const uint8_t* p, int valid) {
        al = (const uint8_t*)((uintptr_t)p & ~(uintptr_t)3);
        off = (int)(p - al);
        vend = valid > 0 ? p + valid : al;  // p itself may lie past the buffer then
        lo = word(al);
        hi = word(al + 4);
        nxt = word(al + 8);
    }
    // the current byte in bits 0-7, the next in bits 8-15
    __device__ __forceinline__ uint32_t peek2() const {
        return __byte_perm(lo, hi, off | ((off + 1) << 4)) & 0xFFFFu;
    }
    __device__ __forceinline__ void advance() {
        if (++off == 4) {
            off = 0;
            al += 4;
            lo = hi;
            hi = nxt;
            nxt = word(al + 8);
        }
    }
};

// The MQ decoder (T.800 C.3) and the raw (BYPASS) bit reader over one Src.
// C is 32 bits: the reference's register is masked to 32 bits at every
// shift and only its bits 16-31 are ever compared, so carries past bit 31
// change nothing. A is kept shifted up by 16, beside C's compared half, so
// Qe << 16 comes from the table entry by one mask and a renormalisation is
// one shift by clz(A) when no byte is due.
struct Dec {
    Src src;
    uint32_t* cx;  // the 19 contexts' table entries
    uint32_t a, c;  // A << 16, C
    int ct;
    uint32_t rtmp;
    int rbits;
    bool rff;

    __device__ __forceinline__ void bytein() {
        const uint32_t two = src.peek2(), b1 = two >> 8;
        if ((two & 0xFF) == 0xFF) {
            if (b1 > 0x8F) {  // a marker (or the end): feed 1 bits
                c += 0xFF00;
                ct = 8;
            } else {
                c += b1 << 9;
                ct = 7;
                src.advance();
            }
        } else {
            c += b1 << 8;
            ct = 8;
            src.advance();
        }
    }
    __device__ __forceinline__ void init(const uint8_t* p, int valid) {  // INITDEC; contexts persist
        src.start(p, valid);
        c = (src.peek2() & 0xFF) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x80000000u;
    }
    __device__ __forceinline__ void renorm() {  // whole runs of shifts up to the next BYTEIN
        for (;;) {
            const int s = min(__clz((int)a), ct);
            a <<= s;
            c <<= s;
            ct -= s;
            if (a & 0x80000000u) return;
            bytein();  // ct is 0
        }
    }
    // one decision in the context whose table entry is e; returns whether
    // the context's state moved (e then holds its new entry)
    __device__ __forceinline__ bool decide(uint32_t& e, int& d) {
        const uint32_t q = e & 0xFFFF0000u;  // Qe << 16
        const uint32_t mps = e & 1;
        a -= q;
        const bool lps = c < q;  // the LPS interval
        if (!lps) {
            c -= q;
            if (a & 0x80000000u) {  // the MPS without renormalisation
                d = mps;
                return false;
            }
        }
        // the conditional exchange: the decision is the MPS's opposite
        // (and the state takes its LPS transition) when exactly one of the
        // LPS interval and A < Qe holds
        const uint32_t flip = (uint32_t)lps ^ (uint32_t)(a < q);
        d = mps ^ flip;
        e = s_mq[(e >> (flip ? 8 : 1)) & 0x7F];
        if (lps) a = q;
        renorm();
        return true;
    }
    // one decision in the context whose entry is at p
    __device__ __forceinline__ int decode_at(uint32_t* p) {
        uint32_t e = *p;
        int d;
        if (decide(e, d)) *p = e;
        return d;
    }
    __device__ __forceinline__ int decode(int ctx) { return decode_at(cx + ctx); }
    __device__ __forceinline__ void raw_init(const uint8_t* p, int valid) {
        src.start(p, valid);
        rbits = 0;
        rtmp = 0;
        rff = false;
    }
    __device__ __forceinline__ int raw_bit() {  // MSB first, 7 bits after 0xFF
        if (rbits == 0) {
            const uint32_t b = src.peek2() & 0xFF;
            src.advance();
            rbits = rff ? 7 : 8;
            rff = b == 0xFF;
            rtmp = b;
        }
        --rbits;
        return (rtmp >> rbits) & 1;
    }
};

__device__ __forceinline__ void reset_contexts(uint32_t* cx) {
    for (int k = 0; k < NUM_CTX; ++k) cx[k] = s_mq[0];
    cx[0] = s_mq[4 << 1];
    cx[CTX_RL] = s_mq[3 << 1];
    cx[CTX_UNI] = s_mq[46 << 1];
}

__device__ __forceinline__ bool term_after(int lpi, bool termall, bool bypass) {
    const int t = lpi == 0 ? 2 : (lpi - 1) % 3;
    return termall || (bypass && (lpi == 9 || (lpi > 9 && (t == 1 || t == 2))));
}

__device__ __forceinline__ bool pass_is_raw(int lpi, bool bypass) {
    const int kind = lpi == 0 ? 2 : (lpi - 1) % 3;
    return bypass && lpi >= 10 && kind != 2;
}

// the 9-bit zero-coding key of row k from t = word >> k: left column rows
// k-1..k+1 in bits 0-2, the self column in 3-5 (bit 4, the sample, is
// ignored by the table), the right column in 6-8
__device__ __forceinline__ uint32_t zkey(uint32_t t) {
    return (t & 7) | ((t >> 3) & 0x38) | ((t >> 6) & 0x1C0);
}

// bit k set iff row k has a significant neighbour (the word's row-4 bits
// cleared by the caller under VSC)
__device__ __forceinline__ uint32_t nbr4(uint32_t w) {
    const uint32_t lr = (w | (w >> 12)) & 0x3F, s = (w >> 6) & 0x3F;
    return (lr | (lr >> 1) | (lr >> 2) | s | (s >> 2)) & 0xF;
}

struct Cblk {
    uint32_t* words;       // stripe s at s * w
    uint64_t* colact;  // per stripe: columns with a significant sample in reach (w <= 64)
    uint64_t* colfull;  // per stripe: columns whose four rows are significant
    int32_t* o;        // the output rows of bw: scaled magnitudes until the writeout
    uint32_t zc;  // the orientation's zero-coding table, as shared_addr gives it
    int h, w, S, bw;
    uint32_t kmask;  // the word as every context sees it: without VSC_CUT under VSC
    bool bits;
    uint64_t wmask;

    __device__ __forceinline__ int zc_ctx(uint32_t wv, int k) const {
        return (int)lds_u8(zc + zkey((wv & kmask) >> k));
    }
    // the sign decision of row k of column x, which just became significant
    __device__ __forceinline__ uint32_t sign(Dec& mq, const uint32_t* row, int x, int k,
                                             uint32_t wv) const {
        const uint32_t t = (wv & kmask) >> k;
        // the 10-bit key of s_sc: from t, rows k - 1 and k + 1 of the self
        // column (bits 0 and 2; bit 1, the sample, is not yet set), their
        // signs (3 and 5; 4 is the sample's), the left and right columns'
        // row k (6 and 7), and the neighbouring words' signs of row k
        uint32_t key = ((t >> 6) & 0x87) | ((t >> 23) & 0x38) | ((t << 5) & 0x40);
        if (x > 0) key |= ((row[x - 1] >> (27 + k)) & 1) << 8;
        if (x + 1 < w) key |= ((row[x + 1] >> (27 + k)) & 1) << 9;
        const uint32_t e = s_sc[key];
        return (uint32_t)mq.decode(e & 0x1F) ^ (e >> 7);
    }
    // row k of column x of stripe s became significant with sign neg: its
    // own bits in the caller's copy wv, its neighbours' in their words, the
    // column bits (the stripe's own in the caller's ca, cf); its magnitude
    // comes with the lanes' next flush
    __device__ __forceinline__ void became(uint32_t* row, int s, int x, int k, uint32_t neg,
                                           uint32_t& wv, uint64_t& ca, uint64_t& cf) {
        wv |= (1u << (7 + k)) | (neg << (27 + k));
        const bool l = x > 0, r = x + 1 < w;
        if (l) row[x - 1] |= 1u << (13 + k);
        if (r) row[x + 1] |= 1u << (1 + k);
        const bool up = k == 0 && s > 0, dn = k == 3 && s + 1 < S;
        if (up) {
            uint32_t* u = row - w;
            u[x] |= (1u << 11) | (neg << 31);
            if (l) u[x - 1] |= 1u << 17;
            if (r) u[x + 1] |= 1u << 5;
        } else if (dn) {
            uint32_t* d = row + w;
            d[x] |= (1u << 6) | (neg << 26);
            if (l) d[x - 1] |= 1u << 12;
            if (r) d[x + 1] |= 1u;
        }
        if (bits) {
            const uint64_t m = (l ? 7ull << (x - 1) : 3ull) & wmask;
            ca |= m;
            if (up) colact[s - 1] |= m;
            if (dn) colact[s + 1] |= m;
            if (((wv >> 7) & 0xF) == 0xF) cf |= 1ull << x;
        }
    }

    __device__ __forceinline__ uint32_t row_mask(int s) const {
        return (1u << min(4, h - 4 * s)) - 1;
    }

    __device__ __forceinline__ void spp(Dec& mq, bool raw) {
        for (int s = 0; s < S; ++s) {
            uint32_t* row = words + s * w;
            const uint32_t rmask = row_mask(s);
            uint64_t ca = bits ? colact[s] : 0, cf = bits ? colfull[s] : 0;
            auto col = [&](int x) {
                uint32_t wv = row[x];
                const uint32_t w0 = wv;
                uint32_t cand = ~(wv >> 7) & rmask;
                // the scan is top-down and wv changes only on a hit, so the
                // jump to the next row with a significant neighbour codes
                // exactly the rows a sequential scan would
                uint32_t live = cand & nbr4(wv & kmask);
                while (live) {
                    const int k = __ffs(live) - 1;
                    const int bit = raw ? mq.raw_bit() : mq.decode(zc_ctx(wv, k));
                    wv |= 1u << (18 + k);
                    if (bit) {
                        cand &= ~((2u << k) - 1);  // rows up to k are done
                        // a raw sign bit is the sign itself
                        const uint32_t neg = raw ? (uint32_t)mq.raw_bit() : sign(mq, row, x, k, wv);
                        became(row, s, x, k, neg, wv, ca, cf);
                        // of the rows left, only row k + 1 gains a
                        // significant neighbour (row k)
                        live = (live | (2u << k)) & cand;
                    } else {
                        live &= live - 1;
                    }
                }
                if (wv != w0) row[x] = wv;
            };
            if (bits) {
                for (int x0 = 0; x0 < w; x0 += 32) {  // 32-bit masks: fewer instructions
                    uint32_t done = 0;
                    for (;;) {  // ca grows as samples become significant
                        const uint32_t avail = (uint32_t)((ca & ~cf) >> x0) & ~done;
                        if (!avail) break;
                        const int b = __ffs(avail) - 1;
                        done |= (2u << b) - 1;
                        col(x0 + b);
                    }
                }
                colact[s] = ca;
                colfull[s] = cf;
            } else {
                for (int x = 0; x < w; ++x)
                    if (row[x] & SIG18) col(x);
            }
        }
    }

    // MRP, the warp together: its contexts are fixed for the whole pass, so
    // for each chunk of 32 columns of a stripe the lanes (a column each)
    // list the candidates' contexts (each entry's byte offset) in scan
    // order (a prefix sum over the lanes), lane 0 decodes them back to
    // back, each bit over its context,
    // and the lanes apply the refinements to the magnitudes and set the
    // refined bits
    __device__ __forceinline__ void mrp(Dec& mq, int plane, bool raw, int lane, uint8_t* codes) {
        const int step = 1 << plane;
        for (int s = 0; s < S; ++s) {
            uint32_t* row = words + s * w;
            const uint32_t rmask = row_mask(s);
            for (int x0 = 0; x0 < w; x0 += 32) {
                const int x = x0 + lane;
                const uint32_t wv = x < w ? row[x] : 0u;
                const uint32_t cand = (wv >> 7) & ~(wv >> 18) & rmask;
                if (!__ballot_sync(~0u, cand != 0)) continue;
                const int cnt = __popc(cand);
                int off = cnt;  // inclusive prefix sum of the counts
                for (int d = 1; d < 32; d <<= 1) {
                    const int v = __shfl_up_sync(~0u, off, d);
                    if (lane >= d) off += v;
                }
                const int total = __shfl_sync(~0u, off, 31);
                off -= cnt;
                const uint32_t nb = nbr4(wv & kmask);
                for (uint32_t c = cand, j = off; c; c &= c - 1, ++j) {
                    const int k = __ffs(c) - 1;
                    codes[j] = 4 * (CTX_MR0 + ((wv >> (22 + k)) & 1 ? 2 : (nb >> k) & 1));
                }
                __syncwarp();
                if (lane == 0 && raw) {
                    for (int j = 0; j < total; ++j) codes[j] = mq.raw_bit();
                } else if (lane == 0) {
                    uint32_t off = codes[0];
                    for (int j = 0; j < total; ++j) {
                        const uint32_t next = codes[j + 1];  // read ahead (past the last: unused)
                        codes[j] = mq.decode_at((uint32_t*)((uint8_t*)mq.cx + off));
                        off = next;
                    }
                }
                __syncwarp();
                int32_t* ox = o + 4 * s * bw + x;
                for (uint32_t c = cand, j = off; c; c &= c - 1, ++j) {
                    const int k = __ffs(c) - 1;
                    atomicAdd(ox + k * bw, codes[j] ? step : -step);
                }
                if (cand) row[x] = wv | (cand << 22);
                __syncwarp();  // codes serve the next chunk
            }
        }
    }

    __device__ __forceinline__ void cup(Dec& mq, bool segsym) {
        const uint32_t rlmask = (SIG18 & kmask) | VIS4;
        for (int s = 0; s < S; ++s) {
            uint32_t* row = words + s * w;
            const uint32_t rmask = row_mask(s);
            const bool full = rmask == 0xF;
            uint64_t ca = bits ? colact[s] : 0, cf = bits ? colfull[s] : 0;
            auto col = [&](int x) {
                uint32_t wv = row[x];
                const uint32_t w0 = wv;
                int first = -1;  // the run's first significant row
                if (full && (wv & rlmask) == 0) {
                    if (!mq.decode(CTX_RL)) return;  // four zeros
                    first = mq.decode(CTX_UNI) << 1;
                    first |= mq.decode(CTX_UNI);
                }
                uint32_t cand = ~((wv >> 7) | (wv >> 18)) & rmask;
                if (first > 0) cand &= ~((1u << first) - 1);
                while (cand) {
                    const int k = __ffs(cand) - 1;
                    cand &= cand - 1;
                    if (k == first || mq.decode(zc_ctx(wv, k)))
                        became(row, s, x, k, sign(mq, row, x, k, wv), wv, ca, cf);
                }
                if (wv != w0) row[x] = wv;
            };
            if (bits) {
                const uint64_t todo = wmask & ~cf;
                for (int x0 = 0; x0 < w; x0 += 32)
                    for (uint32_t cols = (uint32_t)(todo >> x0); cols; cols &= cols - 1)
                        col(x0 + __ffs(cols) - 1);
                colact[s] = ca;
                colfull[s] = cf;
            } else {
                for (int x = 0; x < w; ++x) col(x);
            }
        }
        if (segsym)
            for (int k = 0; k < 4; ++k) mq.decode(CTX_UNI);
    }
};

// bytes of a segment at offset seg (len long) that are read: the rest, and
// all past the codeblock's total, read 0xFF
__device__ __forceinline__ int seg_valid(long long seg, int len, int total) {
    return (int)max(0LL, min((long long)len, (long long)total - seg));
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
ebcot_dec_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
                 const int32_t* __restrict__ lanes,
                 const int32_t* __restrict__ segl, const int32_t* __restrict__ ctx_tab,
                 const int32_t* __restrict__ mq_tab, const int32_t* __restrict__ order,
                 int32_t* __restrict__ out, int n, int max_segs, int bh, int bw, int warp_bytes,
                 int col_stripes) {
    extern __shared__ __align__(16) uint8_t s_dyn[];
    for (int j = threadIdx.x; j < 94; j += blockDim.x) {
        const int st = j >> 1, mps = j & 1;
        const uint32_t nm = (uint32_t)mq_tab[47 + st] * 2 + mps;
        const uint32_t nl = (uint32_t)mq_tab[94 + st] * 2 + (mps ^ mq_tab[141 + st]);
        s_mq[j] = ((uint32_t)mq_tab[st] << 16) | (uint32_t)mps | (nm << 1) | (nl << 8);
    }
    for (int j = threadIdx.x; j < 4 * 512; j += blockDim.x) {
        const int key = j & 511;
        const int l = key & 7, c = (key >> 3) & 7, r = (key >> 6) & 7;
        const int hh = ((l >> 1) & 1) + ((r >> 1) & 1);
        const int vv = (c & 1) + ((c >> 2) & 1);
        const int dd = (l & 1) + ((l >> 2) & 1) + (r & 1) + ((r >> 2) & 1);
        s_zc[j] = (uint8_t)ctx_tab[(j >> 9) * 45 + hh * 15 + vv * 5 + dd];
    }
    for (int j = threadIdx.x; j < 1024; j += blockDim.x) {
        // key bits: sigU, -, sigD, sgnU, -, sgnD, sigL, sigR, sgnL, sgnR
        auto contrib = [&](int sig, int neg) { return sig ? (neg ? -1 : 1) : 0; };
        const int hs = max(-1, min(1, contrib((j >> 6) & 1, (j >> 8) & 1) +
                                          contrib((j >> 7) & 1, (j >> 9) & 1)));
        const int vs = max(-1, min(1, contrib(j & 1, (j >> 3) & 1) +
                                          contrib((j >> 2) & 1, (j >> 5) & 1)));
        const int si = (hs + 1) * 3 + vs + 1;
        s_sc[j] = (uint8_t)(ctx_tab[180 + si] | (ctx_tab[189 + si] << 7));
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
    const int g = blockIdx.x * (blockDim.x >> 5) + wi;
    if (g >= n) return;
    const int i = order ? order[g] : g;
    const int nb = lanes[i], npass = lanes[n + i];
    const int h = lanes[2 * n + i], w = lanes[3 * n + i];
    const int orient = lanes[4 * n + i], style = lanes[5 * n + i], length = lanes[6 * n + i];
    if (nb <= 0 || npass <= 0 || h <= 0 || w <= 0) return;  // the output stays zero

    uint8_t* base = s_dyn + wi * warp_bytes;
    uint8_t* codes = base + CX_BYTES;
    Cblk cb;
    cb.colact = (uint64_t*)(base + CX_BYTES + MR_BYTES);
    cb.colfull = cb.colact + col_stripes;
    cb.words = (uint32_t*)(cb.colfull + col_stripes);
    cb.o = out + (int64_t)i * bh * bw;
    cb.zc = shared_addr(s_zc + (orient & 3) * 512);
    cb.h = h;
    cb.w = w;
    cb.S = (h + 3) >> 2;
    cb.bw = bw;
    const bool vsc = style & 0x08;
    cb.kmask = vsc ? ~VSC_CUT : ~0u;
    cb.bits = w <= 64;
    cb.wmask = w >= 64 ? ~0ull : (1ull << w) - 1;
    uint32_t* cx = (uint32_t*)base;
    const int nwords = cb.S * w;
    uint8_t* flushed = (uint8_t*)(cb.words + nwords);
    for (int j = lane; j < nwords; j += 32) {
        cb.words[j] = 0;
        flushed[j] = 0;
    }
    if (cb.bits)
        for (int j = lane; j < cb.S; j += 32) cb.colact[j] = cb.colfull[j] = 0;
    __syncwarp();

    const bool termall = style & 0x04, bypass = style & 0x01, reset = style & 0x02;
    const bool segmented = termall || bypass, segsym = style & 0x20;
    const int32_t* sl = segl + (int64_t)i * max_segs;
    const uint8_t* p = data + starts[i];
    Dec mq;
    mq.cx = cx;
    long long seg_off = 0;
    int seg_i = 0;
    if (lane == 0) {  // the first segment is always an MQ one
        reset_contexts(cx);
        mq.init(p, seg_valid(0, segmented ? sl[0] : length, length));
    }
    auto end_pass = [&](int lpi) {
        if (reset) reset_contexts(cx);
        if (!segmented || !term_after(lpi, termall, bypass) || lpi + 1 >= npass) return;
        seg_off += sl[min(seg_i, max_segs - 1)];
        ++seg_i;
        const int v = seg_valid(seg_off, seg_i < max_segs ? sl[seg_i] : 0, length);
        if (pass_is_raw(lpi + 1, bypass)) mq.raw_init(p + seg_off, v);
        else mq.init(p + seg_off, v);
    };

    // the lanes a stripe word each: the samples that became significant
    // since the last flush get 3 << plane (flushed holds each word's rows
    // already added); at a plane's end the visited bits go too
    auto flush = [&](int plane, bool unvisit) {
        for (int j = lane; j < nwords; j += 32) {
            const uint32_t wv = cb.words[j], sig = (wv >> 7) & 0xF;
            if (unvisit) cb.words[j] = wv & ~VIS4;
            if (sig == flushed[j]) continue;
            const int s = j / w, x = j - s * w;
            int32_t* q = cb.o + 4 * s * bw + x;
            for (uint32_t m = sig & ~(uint32_t)flushed[j]; m; m &= m - 1)
                atomicAdd(q + (__ffs(m) - 1) * bw, 3 << plane);
            flushed[j] = (uint8_t)sig;
        }
    };
    int last = nb - 1;
    for (int plane = nb - 1; plane >= 0; --plane) {
        last = plane;
        const bool first = plane == nb - 1;  // the first plane has its cleanup pass only
        const int lp = first ? 0 : (nb - 2 - plane) * 3 + 1;  // the plane's first pass
        if (lp >= npass) break;
        if (!first) {  // one call site a pass: the kernel's code stays small
            if (lane == 0) {
                cb.spp(mq, pass_is_raw(lp, bypass));
                end_pass(lp);
            }
            if (lp + 1 >= npass) break;
            __syncwarp();
            cb.mrp(mq, plane, pass_is_raw(lp + 1, bypass), lane, codes);
            if (lane == 0) end_pass(lp + 1);
            if (lp + 2 >= npass) break;
        }
        if (lane == 0) {
            cb.cup(mq, segsym);
            end_pass(first ? 0 : lp + 2);
        }
        __syncwarp();
        flush(plane, true);
        __syncwarp();
    }
    __syncwarp();
    flush(last, false);  // a plane the passes stopped in

    // the writeout: the ROI downshift (style bits 8-15) in the scaled domain,
    // before the half bit is dropped, as native/t1_coder.cpp:1143-1158 does
    // (a shift of 32 or more exceeds every magnitude and leaves it as it
    // is), then the sign; lane 0's atomic adds are made visible first
    __threadfence();
    __syncwarp();
    const uint32_t rs = ((uint32_t)style >> 8) & 0xFF;
    int y = 0, x = lane;
    while (x >= w) {
        x -= w;
        ++y;
    }
    while (y < h) {
        int32_t* q = cb.o + y * bw + x;
        uint32_t m2 = (uint32_t)__ldcg(q);
        if (rs && rs < 32 && m2 >= (1u << rs)) m2 >>= rs;
        const int32_t m = (int32_t)(m2 >> 1);
        *q = (cb.words[(y >> 2) * w + x] >> (27 + (y & 3))) & 1 ? -m : m;
        x += 32;
        while (x >= w) {
            x -= w;
            ++y;
        }
    }
}

static cudaError_t dec_attributes(int smem) {
    const auto k = ebcot_dec_kernel;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    return e;
}

// blocks of `warps` warps and `smem` dynamic shared bytes resident on one SM
extern "C" int ebcot_decode_occupancy(int warps, int smem, int* blocks) {
    cudaError_t e = dec_attributes(smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ebcot_dec_kernel,
                                                          warps * 32, smem);
    return (int)e;
}

// data: the codeblocks' bytes, one flat uint8 buffer of nbytes, 4-aligned
// and a multiple of 4 bytes (every word load stays inside it); starts [n]
// int64; lanes [7, n] int32 (numbps, npasses, height, width, orient, style,
// length); segl [n, max_segs] int32 merged
// segment lengths; ctx_tab [198] and mq_tab [4, 47] int32; order [n] int32,
// the codeblock each warp decodes (null: warp g decodes codeblock g); out
// [n, bh, bw] int32, zeroed by the caller; warps: codeblocks a block;
// warp_bytes: a warp's shared state (CX_BYTES, MR_BYTES, then 2 *
// col_stripes uint64 column bits, then the stripe words of the batch's
// largest codeblock and a byte for each).
extern "C" int ebcot_decode(const void* data, int64_t nbytes, const void* starts,
                            const void* lanes, const void* segl, const void* ctx_tab,
                            const void* mq_tab, const void* order, void* out, int n,
                            int max_segs, int bh, int bw, int warps, int warp_bytes,
                            int col_stripes, void* stream) {
    if (n <= 0) return 0;
    if (max_segs < 1 || nbytes < 4 || nbytes % 4 || (uintptr_t)data % 4 || warps < 1 ||
        warps > MAX_WARPS || warp_bytes < CX_BYTES + MR_BYTES || warp_bytes % 16 || col_stripes < 0)
        return (int)cudaErrorInvalidValue;
    const int smem = warps * warp_bytes;
    const cudaError_t e = dec_attributes(smem);
    if (e != cudaSuccess) return (int)e;
    ebcot_dec_kernel<<<(n + warps - 1) / warps, warps * 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lanes,
        (const int32_t*)segl, (const int32_t*)ctx_tab, (const int32_t*)mq_tab,
        (const int32_t*)order, (int32_t*)out, n, max_segs, bh, bw, warp_bytes, col_stripes);
    return (int)cudaGetLastError();
}
