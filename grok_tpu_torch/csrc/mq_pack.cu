// K-d mq_pack: MQ (T.800 Annex C) and raw (bypass) coding of the symbol
// records of K-c into codeword segments, with per-pass rate bounds.
//
// Replaces: the host packers of the TPU path, grok_tpu/t1/ebcot_pallas.py
// _pack_symbols (:399) and _pack_symbols_nat (:535, native
// t1_pack_symbols). Termination follows their end_pass (:455-476) and final
// tail (:505-523): TERMALL, BYPASS raw segments and their restarts, RESET,
// the safe mid-segment rate bound, FLUSH, and the clamp of every rate to
// the final length. Output uses the same 1-byte offset convention: byte 0
// of a lane's row absorbs carries, the segment is buf[1 : 1 + length].
//
// Bound on an H100 (3.35 TB/s): bytes, the records of the passes each
// codeblock codes read once (0.8 GB at 3840x2160x3) and the segments
// written once, ~0.25 ms. What sets the time is the MQ coder's serial chain
// over the valid records of the codeblock that has the most of them. So:
//  - One warp per codeblock (6,321 warps at 3840x2160x3, four to a block).
//  - For each coded pass the warp streams the codeblock's contiguous records
//    in chunks of 1 KB, 16-byte loads, two per lane. It keeps only the valid
//    records, in order, in a shared queue: each lane counts its valid bytes
//    and a warp prefix sum (__shfl_up_sync) places them.
//  - Lane 0 runs the MQ / raw coder over the queue while the idle lanes'
//    loads of the next chunk are in flight: the loads are issued before the
//    coding of the current chunk and consumed after it. A second warp per
//    codeblock would halve the codeblocks resident per SM (64 warps at most)
//    for a chain that is lane 0's either way; the 31 idle lanes cost nothing
//    the other resident warps could use.
//  - The coder keeps the last written byte in a register and writes the
//    segment to a 2 KB shared window; nothing reads buf back from global
//    memory. Only the last two positions of a segment can change (a carry
//    into the current byte, a dropped trailing 0xFF on FLUSH), so when the
//    window fills the warp writes all but those to buf with coalesced byte
//    stores and slides; at the end it writes the rest, stale bytes past the
//    final length included, as the plain coder leaves them.
//  - Lane 0 codes as many queued records as the window has room for (a
//    record writes at most 3 bytes) with no check between them, and loads
//    the next record before it codes the current one.
//  - The state-machine table and the 19 contexts live in shared memory.
//    Renormalisation shifts in CT-bounded runs found with __clz. On the
//    whole 3840x2160x3 batch this beat a packed one-word table entry and a
//    one-byte context (fewer loads, more instructions) and a cap of 40
//    registers (48 warps an SM, but spills): the coder is bound by its
//    instruction chain, not by loads.
// A write that would pass the lane's row (max_bytes + 2 bytes) marks the
// lane with length -1 and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_CTX 19
#define CTX_ZC0 0
#define CTX_RL 17
#define CTX_UNI 18
#define WARPS 4
#define QCAP 1024   // records a chunk holds: 32 lanes x 2 x 16 bytes
#define SEG 2048    // segment window bytes
#define ROOM 16     // window bytes left free for one coder operation

struct Tables {
    int qe[47], nmps[47], nlps[47], sw[47];
};

// word k (0..7) of the 32 bytes a, b, without an indexed local array
__device__ __forceinline__ uint32_t word_at(const uint4& a, const uint4& b, int k) {
    return (k & 4) ? ((k & 2) ? ((k & 1) ? b.w : b.z) : ((k & 1) ? b.y : b.x))
                   : ((k & 2) ? ((k & 1) ? a.w : a.z) : ((k & 1) ? a.y : a.x));
}

// The coder of one codeblock; only lane 0 of its warp runs it.
struct Coder {
    const Tables* T;    // shared state-machine table
    uint8_t* st;        // [NUM_CTX] shared context states
    uint8_t* mps;       // [NUM_CTX] shared context MPS symbols
    uint8_t* seg;       // shared window over segment positions [wbase, wbase + SEG)
    int wbase;
    uint32_t a, c;
    int ct;
    int pos, hi, cap;  // current position, highest written, row capacity
    uint32_t last;     // the byte at pos
    bool overflow;
    uint32_t raw_tmp;
    int raw_used, raw_avail;

    __device__ void reset_ctx() {
        for (int i = 0; i < NUM_CTX; i++) {
            st[i] = 0;
            mps[i] = 0;
        }
        st[CTX_ZC0] = 4;
        st[CTX_RL] = 3;
        st[CTX_UNI] = 46;
    }

    __device__ __forceinline__ void put(uint32_t v) {
        seg[pos - wbase] = (uint8_t)v;
        last = v & 0xFF;
    }

    __device__ __forceinline__ void push(uint32_t v) {
        if (pos + 1 >= cap) {
            overflow = true;
            return;
        }
        ++pos;
        put(v);
        if (pos > hi) hi = pos;
    }

    __device__ __forceinline__ void byteout() {
        uint32_t b = last;
        if (b != 0xFF && (c & 0x8000000u)) {
            b = b + 1;
            put(b);
            if (b == 0xFF) c &= 0x7FFFFFFu;
        }
        if (b == 0xFF) {
            push(c >> 20);
            c &= 0xFFFFF;
            ct = 7;
        } else {
            push(c >> 19);
            c &= 0x7FFFF;
            ct = 8;
        }
    }

    // Shift a and c left until a >= 0x8000 (0 < a < 0x8000 on entry), a
    // byte out each time ct reaches 0: the standard's one-bit loop, in
    // CT-bounded runs found with __clz.
    __device__ __forceinline__ void renorm() {
        int n = __clz(a) - 16;
        while (n >= ct) {
            a <<= ct;
            c <<= ct;
            n -= ct;
            byteout();
        }
        a <<= n;
        c <<= n;
        ct -= n;
    }

    __device__ __forceinline__ void encode(int bit, int ctx) {
        const int s = st[ctx];
        const uint32_t qe = (uint32_t)T->qe[s];
        a -= qe;
        if (bit == mps[ctx]) {
            if ((a & 0x8000) == 0) {
                if (a < qe)
                    a = qe;
                else
                    c += qe;
                st[ctx] = (uint8_t)T->nmps[s];
                renorm();
            } else {
                c += qe;
            }
        } else {
            if (a < qe)
                c += qe;
            else
                a = qe;
            if (T->sw[s]) mps[ctx] = (uint8_t)(1 - mps[ctx]);
            st[ctx] = (uint8_t)T->nlps[s];
            renorm();
        }
    }

    __device__ void flush() {
        const uint32_t tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
    }

    __device__ int length() const { return pos + (last != 0xFF ? 1 : 0) - 1; }

    __device__ void restart() {
        a = 0x8000;
        c = 0;
        ct = last == 0xFF ? 13 : 12;
    }

    __device__ int terminate_restart() {
        flush();
        const int len = length();
        if (len != pos) {  // a trailing 0xFF is dropped: step back inside the window
            pos = len;
            last = seg[pos - wbase];
        }
        restart();
        return len;
    }

    __device__ void raw_start() {
        raw_tmp = 0;
        raw_used = 0;
        raw_avail = last == 0xFF ? 7 : 8;
    }

    __device__ __forceinline__ void raw_bit(int v) {
        raw_tmp = (raw_tmp << 1) | (uint32_t)v;
        if (++raw_used == raw_avail) {
            push(raw_tmp);
            raw_avail = last == 0xFF ? 7 : 8;
            raw_tmp = 0;
            raw_used = 0;
        }
    }

    __device__ int raw_safe_len() const { return pos + (raw_used > 0 ? 1 : 0); }

    __device__ int raw_terminate_restart_mq() {
        if (raw_used > 0) push(raw_tmp << (raw_avail - raw_used));
        if (last == 0xFF) push(0);  // raw segments can't end 0xFF
        const int len = pos;
        restart();
        raw_used = 0;
        raw_tmp = 0;
        return len;
    }
};

__global__ void __launch_bounds__(32 * WARPS)
mq_pack_kernel(const uint8_t* __restrict__ sym,      // [n][pmaxc][3][s_pad]
               const int32_t* __restrict__ numbps,   // [n]
               const int32_t* __restrict__ styles,   // [n]
               const int32_t* __restrict__ table,    // [4][47]
               uint8_t* __restrict__ buf,            // [n][stride], zeroed
               int64_t* __restrict__ lengths,        // [n]
               int64_t* __restrict__ pass_rates,     // [n][max_passes], zeroed
               int n, int pmaxc, int s_pad, int ns, int w, int64_t stride,
               int max_passes) {
    __shared__ Tables T;
    __shared__ __align__(16) uint8_t s_q[WARPS][QCAP + 4];
    __shared__ __align__(16) uint8_t s_seg[WARPS][SEG];
    __shared__ uint8_t s_ctx[WARPS][2 * NUM_CTX];
    for (int i = threadIdx.x; i < 47; i += blockDim.x) {
        T.qe[i] = table[i];
        T.nmps[i] = table[47 + i];
        T.nlps[i] = table[94 + i];
        T.sw[i] = table[141 + i];
    }
    __syncthreads();
    const int wid = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int l = blockIdx.x * WARPS + wid;
    if (l >= n) return;  // warp-uniform
    const int nb = numbps[l];
    const int npass = nb > 0 ? 3 * nb - 2 : 0;
    int64_t* rates = pass_rates + (int64_t)l * max_passes;
    if (npass == 0) {
        if (lane == 0) lengths[l] = 0;
        return;
    }
    const int sty = styles[l];
    const bool termall = (sty & 0x04) != 0;
    const bool bypass = (sty & 0x01) != 0;
    const bool reset = (sty & 0x02) != 0;
    uint8_t* q = s_q[wid];
    uint8_t* row = buf + (int64_t)l * stride;

    Coder mq;
    mq.T = &T;
    mq.st = s_ctx[wid];
    mq.mps = s_ctx[wid] + NUM_CTX;
    mq.seg = s_seg[wid];
    mq.wbase = 0;
    mq.a = 0x8000;
    mq.c = 0;
    mq.ct = 12;
    mq.pos = 0;
    mq.hi = 0;
    mq.cap = (int)stride;
    mq.overflow = false;
    mq.raw_tmp = 0;
    mq.raw_used = 0;
    mq.raw_avail = 8;
    if (lane == 0) {
        mq.put(0);  // buf[0], the carry byte
        mq.reset_ctx();
    }
    __syncwarp();

    // Keep ROOM bytes free in the window: write out every position below
    // pos - 1 (final) and slide the last few bytes to the window's front.
    auto room = [&]() {
        const int pos = __shfl_sync(0xFFFFFFFFu, mq.pos, 0);
        if (pos - mq.wbase < SEG - ROOM) return;
        const int hi = __shfl_sync(0xFFFFFFFFu, mq.hi, 0);
        const int f = pos - 1;
        for (int i = lane; i < f - mq.wbase; i += 32) row[mq.wbase + i] = mq.seg[i];
        const int keep = hi - f + 1;
        const uint8_t v = lane < keep ? mq.seg[f - mq.wbase + lane] : 0;
        __syncwarp();
        if (lane < keep) mq.seg[lane] = v;
        mq.wbase = f;
        __syncwarp();
    };

    auto lpi_f = [&](int plane, int kind) {
        const int rel = nb - 1 - plane;
        return rel <= 0 ? 0 : (rel - 1) * 3 + 1 + kind;
    };
    auto is_raw = [&](int lp, int kind) { return bypass && lp >= 10 && kind != 2; };
    auto term_after = [&](int lp) {
        const int t = lp == 0 ? 2 : (lp - 1) % 3;
        return termall || (bypass && (lp == 9 || (lp > 9 && (t == 1 || t == 2))));
    };

    // One 16-byte unit of records [at, at + 16), or its lower half where the
    // upper one passes lim (the rounded end of the region, never past the
    // tensor).
    auto load_unit = [&](const uint8_t* at, const uint8_t* lim) -> uint4 {
        if (at >= lim) return make_uint4(0, 0, 0, 0);
        if (at + 16 <= lim) return __ldg((const uint4*)at);
        const uint2 v = __ldg((const uint2*)at);
        return make_uint4(v.x, v.y, 0, 0);
    };

    // Code the valid records of one pass region [reg, reg + cnt).
    auto feed = [&](const uint8_t* reg, int cnt) {
        const int head = (int)((uintptr_t)reg & 15);  // 0 or 8
        const uint8_t* a0 = reg - head;
        const uint8_t* lim = reg + ((cnt + 7) & ~7);
        const int units = (head + cnt + 15) >> 4;
        const int chunks = (units + 63) >> 6;
        uint4 v0 = load_unit(a0 + 32 * lane, lim);
        uint4 v1 = load_unit(a0 + 32 * lane + 16, lim);
        for (int ch = 0; ch < chunks; ch++) {
            // select: this lane's 32 bytes, region bytes lo .. lo + 31
            const int lo = (ch * 64 + 2 * lane) * 16 - head;
            uint32_t m = 0;
#pragma unroll
            for (int i = 0; i < 32; i++)
                m |= ((word_at(v0, v1, i >> 2) >> (8 * (i & 3) + 7)) & 1u) << i;
            const int b0 = lo < 0 ? -lo : 0;
            const int b1 = cnt - lo >= 32 ? 32 : (cnt - lo < 0 ? 0 : cnt - lo);
            m &= b1 > b0 ? ((b1 == 32 ? 0xFFFFFFFFu : (1u << b1) - 1) & ~((1u << b0) - 1)) : 0;
            const int cntl = __popc(m);
            int incl = cntl;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
                if (lane >= d) incl += t;
            }
            const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
            int o = incl - cntl;
            while (m) {
                const int i = __ffs(m) - 1;
                q[o++] = (uint8_t)(word_at(v0, v1, i >> 2) >> (8 * (i & 3)));
                m &= m - 1;
            }
            // the next chunk's loads, in flight while lane 0 codes this one
            if (ch + 1 < chunks) {
                const uint8_t* at = a0 + (int64_t)(ch + 1) * 1024 + 32 * lane;
                v0 = load_unit(at, lim);
                v1 = load_unit(at + 16, lim);
            }
            __syncwarp();
            int qi = 0;
            while (qi < total) {
                if (lane == 0) {
                    // a record writes at most 3 bytes: code as many as the
                    // window holds with no check between them
                    const int free_b = SEG - ROOM - (mq.pos - mq.wbase);
                    const int stop = min(total, qi + (free_b > 0 ? max(1, free_b / 3) : 0));
                    uint32_t r = q[qi];  // the queue has slack past its end
                    while (qi < stop) {
                        const uint32_t next = q[++qi];
                        const int bit = (r >> 5) & 1;
                        if (r & 0x40)
                            mq.raw_bit(bit);
                        else
                            mq.encode(bit, r & 0x1F);
                        r = next;
                    }
                }
                qi = __shfl_sync(0xFFFFFFFFu, qi, 0);
                room();
            }
            __syncwarp();
        }
    };

    bool last_term = false;
    int last_rate = 0;
    auto end_pass = [&](int plane, int kind) {
        room();
        if (lane == 0) {
            const int lp = lpi_f(plane, kind);
            const bool raw_m = is_raw(lp, kind);
            const bool term = term_after(lp);
            int r = raw_m ? mq.raw_safe_len() : mq.pos + (27 - mq.ct + 7) / 8;
            if (term) r = raw_m ? mq.raw_terminate_restart_mq() : mq.terminate_restart();
            rates[lp] = r;
            last_rate = r;
            last_term = term;
            if (reset) mq.reset_ctx();
            if (term && is_raw(lp + 1, (kind + 1) % 3)) mq.raw_start();
        }
        __syncwarp();
    };

    const int np4 = ns * w * 4;
    for (int plane = nb - 1; plane >= 0; plane--) {
        const int pidx = pmaxc - 1 - plane;
        const uint8_t* base = sym + ((int64_t)l * pmaxc + pidx) * 3 * s_pad;
        if (nb - 1 > plane) {
            feed(base, np4 * 2);  // SPP: (position) x (zc, sign)
            end_pass(plane, 0);
            feed(base + s_pad, np4);  // MRP: one slot per position
            end_pass(plane, 1);
        }
        feed(base + 2 * s_pad, ns * w * 11 + 4);  // CUP + segsym
        end_pass(plane, 2);
    }

    room();
    const int final_lp = npass - 1;
    int len = 0;
    if (lane == 0) {
        const int fkind = final_lp == 0 ? 2 : (final_lp - 1) % 3;
        if (last_term) {
            len = last_rate;
        } else if (is_raw(final_lp, fkind)) {
            len = mq.raw_terminate_restart_mq();
        } else {
            mq.flush();
            len = mq.length();
        }
        rates[final_lp] = len;
        lengths[l] = mq.overflow ? -1 : len;
    }
    len = __shfl_sync(0xFFFFFFFFu, len, 0);
    const int hi = __shfl_sync(0xFFFFFFFFu, mq.hi > mq.pos ? mq.hi : mq.pos, 0);
    __syncwarp();
    for (int i = lane; i <= hi - mq.wbase; i += 32) row[mq.wbase + i] = mq.seg[i];
    for (int i = lane; i < npass; i += 32)
        if (rates[i] > len) rates[i] = len;
}

extern "C" int mq_pack(const void* sym, const void* numbps, const void* styles,
                       const void* table, void* buf, void* lengths,
                       void* pass_rates, int n, int pmaxc, int64_t s_pad, int ns,
                       int w, int64_t stride, int max_passes, void* stream) {
    if (n <= 0) return 0;
    mq_pack_kernel<<<(n + WARPS - 1) / WARPS, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)sym, (const int32_t*)numbps, (const int32_t*)styles,
        (const int32_t*)table, (uint8_t*)buf, (int64_t*)lengths,
        (int64_t*)pass_rates, n, pmaxc, (int)s_pad, ns, w, stride, max_passes);
    return (int)cudaGetLastError();
}
