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
// Bound on an H100 (3.35 TB/s): bytes. The records of the planes each
// codeblock codes are read once (up to 3.4 GB at 3840x2160x3) and the
// segment buffers written once, ~1 ms. Design: one thread per codeblock runs
// the scalar coder over its records slot by slot. The records are
// slot-major and lane-minor, so a warp's one-byte loads fall on 32 adjacent
// bytes; the coder's registers and 19 context states live in the thread,
// the state-machine table in shared memory. A write that would pass the
// lane's row (max_bytes + 2 bytes) marks the lane with length -1 and the
// wrapper raises. As with K-c, ~6,300 threads cannot fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_CTX 19
#define CTX_ZC0 0
#define CTX_RL 17
#define CTX_UNI 18

struct Tables {
    int qe[47], nmps[47], nlps[47], sw[47];
};

struct MQ {
    const Tables* T;
    uint32_t a, c;
    int ct;
    uint8_t* buf;  // buf[0] is the virtual carry byte
    int64_t pos, cap;
    bool overflow;
    uint8_t st[NUM_CTX], mps[NUM_CTX];
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

    __device__ void init(const Tables* t, uint8_t* b, int64_t capacity) {
        T = t;
        a = 0x8000;
        c = 0;
        ct = 12;
        buf = b;
        buf[0] = 0;
        pos = 0;
        cap = capacity;
        overflow = false;
        raw_tmp = 0;
        raw_used = 0;
        raw_avail = 8;
        reset_ctx();
    }

    __device__ __forceinline__ void push(uint8_t v) {
        if (pos + 1 >= cap) {
            overflow = true;
            return;
        }
        buf[++pos] = v;
    }

    __device__ void byteout() {
        uint8_t b = buf[pos];
        if (b != 0xFF && (c & 0x8000000u)) {
            b = (uint8_t)(b + 1);
            buf[pos] = b;
            if (b == 0xFF) c &= 0x7FFFFFFu;
        }
        if (b == 0xFF) {
            push((uint8_t)(c >> 20));
            c &= 0xFFFFF;
            ct = 7;
        } else {
            push((uint8_t)(c >> 19));
            c &= 0x7FFFF;
            ct = 8;
        }
    }

    __device__ __forceinline__ void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while ((a & 0x8000) == 0);
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

    __device__ int64_t length() const { return pos + (buf[pos] != 0xFF ? 1 : 0) - 1; }

    __device__ void restart() {
        a = 0x8000;
        c = 0;
        ct = buf[pos] == 0xFF ? 13 : 12;
    }

    __device__ int64_t terminate_restart() {
        flush();
        const int64_t len = length();
        pos = len;  // buf[pos] = last counted byte
        restart();
        return len;
    }

    __device__ void raw_start() {
        raw_tmp = 0;
        raw_used = 0;
        raw_avail = buf[pos] == 0xFF ? 7 : 8;
    }

    __device__ __forceinline__ void raw_bit(int v) {
        raw_tmp = (raw_tmp << 1) | (uint32_t)v;
        if (++raw_used == raw_avail) {
            push((uint8_t)raw_tmp);
            raw_avail = buf[pos] == 0xFF ? 7 : 8;
            raw_tmp = 0;
            raw_used = 0;
        }
    }

    __device__ int64_t raw_safe_len() const { return pos + (raw_used > 0 ? 1 : 0); }

    __device__ int64_t raw_terminate_restart_mq() {
        if (raw_used > 0) push((uint8_t)(raw_tmp << (raw_avail - raw_used)));
        if (buf[pos] == 0xFF) push(0);  // raw segments can't end 0xFF
        const int64_t len = pos;
        restart();
        raw_used = 0;
        raw_tmp = 0;
        return len;
    }
};

__global__ void __launch_bounds__(32)
mq_pack_kernel(const uint8_t* __restrict__ sym,      // [pmaxc][3][s_pad][n]
               const int32_t* __restrict__ numbps,   // [n]
               const int32_t* __restrict__ styles,   // [n]
               const int32_t* __restrict__ table,    // [4][47]
               uint8_t* __restrict__ buf,            // [n][stride], zeroed
               int64_t* __restrict__ lengths,        // [n]
               int64_t* __restrict__ pass_rates,     // [n][max_passes], zeroed
               int n, int pmaxc, int64_t s_pad, int ns, int w,
               int64_t stride, int max_passes) {
    __shared__ Tables T;
    for (int i = threadIdx.x; i < 47; i += blockDim.x) {
        T.qe[i] = table[i];
        T.nmps[i] = table[47 + i];
        T.nlps[i] = table[94 + i];
        T.sw[i] = table[141 + i];
    }
    __syncthreads();
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= n) return;
    const int nb = numbps[l];
    const int npass = nb > 0 ? 3 * nb - 2 : 0;
    int64_t* rates = pass_rates + (int64_t)l * max_passes;
    lengths[l] = 0;
    if (npass == 0) return;
    const int sty = styles[l];
    const bool termall = (sty & 0x04) != 0;
    const bool bypass = (sty & 0x01) != 0;
    const bool reset = (sty & 0x02) != 0;
    const int64_t N = n;
    const int64_t np4 = (int64_t)ns * w * 4;

    MQ mq;
    mq.init(&T, buf + (int64_t)l * stride, stride);

    auto lpi_f = [&](int plane, int kind) {
        const int rel = nb - 1 - plane;
        return rel <= 0 ? 0 : (rel - 1) * 3 + 1 + kind;
    };
    auto is_raw = [&](int lp, int kind) { return bypass && lp >= 10 && kind != 2; };
    auto term_after = [&](int lp) {
        const int t = lp == 0 ? 2 : (lp - 1) % 3;
        return termall || (bypass && (lp == 9 || (lp > 9 && (t == 1 || t == 2))));
    };
    auto feed = [&](const uint8_t* st, int64_t cnt) {
        for (int64_t i = 0; i < cnt; i++) {
            const uint8_t r = st[i * N];
            if (!(r & 0x80)) continue;
            const int bit = (r >> 5) & 1;
            if (r & 0x40)
                mq.raw_bit(bit);
            else
                mq.encode(bit, r & 0x1F);
        }
    };
    bool last_term = false;
    auto end_pass = [&](int plane, int kind) {
        const int lp = lpi_f(plane, kind);
        const bool raw_m = is_raw(lp, kind);
        const bool term = term_after(lp);
        int64_t r = raw_m ? mq.raw_safe_len() : mq.pos + (27 - mq.ct + 7) / 8;
        if (term) r = raw_m ? mq.raw_terminate_restart_mq() : mq.terminate_restart();
        rates[lp] = r;
        last_term = term;
        if (reset) mq.reset_ctx();
        if (term && is_raw(lp + 1, (kind + 1) % 3)) mq.raw_start();
    };

    for (int plane = nb - 1; plane >= 0; plane--) {
        const int pidx = pmaxc - 1 - plane;
        const uint8_t* base = sym + (int64_t)pidx * 3 * s_pad * N + l;
        if (nb - 1 > plane) {
            feed(base, np4 * 2);  // SPP: (position) x (zc, sign)
            end_pass(plane, 0);
            feed(base + s_pad * N, np4);  // MRP: one slot per position
            end_pass(plane, 1);
        }
        feed(base + 2 * s_pad * N, (int64_t)ns * w * 11 + 4);  // CUP + segsym
        end_pass(plane, 2);
    }

    const int final_lp = npass - 1;
    const int fkind = final_lp == 0 ? 2 : (final_lp - 1) % 3;
    int64_t len;
    if (last_term) {
        len = rates[final_lp];
    } else if (is_raw(final_lp, fkind)) {
        len = mq.raw_terminate_restart_mq();
    } else {
        mq.flush();
        len = mq.length();
    }
    rates[final_lp] = len;
    for (int i = 0; i < npass; i++)
        if (rates[i] > len) rates[i] = len;
    lengths[l] = mq.overflow ? -1 : len;
}

extern "C" int mq_pack(const void* sym, const void* numbps, const void* styles,
                       const void* table, void* buf, void* lengths,
                       void* pass_rates, int n, int pmaxc, int64_t s_pad, int ns,
                       int w, int64_t stride, int max_passes, void* stream) {
    if (n <= 0) return 0;
    const int threads = 32;
    mq_pack_kernel<<<(n + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
        (const uint8_t*)sym, (const int32_t*)numbps, (const int32_t*)styles,
        (const int32_t*)table, (uint8_t*)buf, (int64_t*)lengths,
        (int64_t*)pass_rates, n, pmaxc, s_pad, ns, w, stride, max_passes);
    return (int)cudaGetLastError();
}
