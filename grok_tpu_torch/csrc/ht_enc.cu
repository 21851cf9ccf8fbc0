// K-e ht_cleanup_enc: the HTJ2K cleanup pass (T.814 clause 7.3) of a batch
// of codeblocks, each into its finished codeword segment
// [MagSgn fwd][MEL fwd][VLC bwd] with the Scup locator patched into its last
// two bytes.
//
// Replaces: grok_tpu/t1/ht_jax.py _encode_device (:217), the XLA program of
// quad exponents, CxtVLC lookups, u-codes, MagSgn items and the MEL scan
// packed into uint32 words, together with the host byte stuffing and
// assembly that follow it (_stuff_host :503, _compact :560). Written from
// the scalar coder grok_tpu/t1/ht.py encode_cleanup (:214) and its bit
// machines MelEnc/VlcEnc/MsEnc (:88-190) and _terminate_mel_vlc (:191),
// not from the TPU's dense-array form: on Hopper the three streams are
// appended byte by byte with their stuffing rules as they are coded.
//
// Bound on an H100 (3.35 TB/s): bytes. The function reads the int32 samples
// inside each codeblock once (4 bytes a sample, 99.5 MB for the 24.9M
// samples of a 3840x2160x3 image) and writes the segments once (a fifth of
// that); about 0.036 ms.
// Design: one thread per codeblock runs the scalar coder -- every context
// (c_q, kappa), the MEL run state and the three stream writers chain from
// one quad to the next, so a codeblock is one serial chain. MagSgn bytes go
// straight to the segment; MEL bytes grow forward and VLC bytes backward in
// a per-codeblock scratch row, and are copied behind MagSgn at the end. The
// line buffers (exponents and significance of the quad row above) live in
// per-thread local memory. A segment or scratch row that would overflow its
// capacity sets the codeblock's length to -1 (the wrapper raises). This
// form leaves the card mostly idle (one thread a codeblock); its time is in
// PERF.md.
//
// Block energy (for PCRD): given a non-null ``energy``, each thread also
// writes its codeblock's sum(v*v) in float64, row sums first and then the
// sum of the rows, each sequential, as grok_tpu's default HT coder does
// (native/ht_coder.cpp:650-662; K3 computes it in float32, ht_jax.py:465,
// and is not followed). Products and sums are IEEE-rounded double
// intrinsics (the source is built with -fmad=false). It adds 8 bytes a
// codeblock written to the bytes bound.

#include <cuda_runtime.h>
#include <stdint.h>

// int32 table layout shared with t1/ht_cuda.py ht_tables()
#define T_ENC 0          // [2][2048] (cwd << 8) | (len << 4) | e_k
#define T_MEL_EXP 6144   // [13]
#define T_U_PRE 6157     // [33]
#define T_U_PRE_LEN 6190
#define T_U_SUF 6223
#define T_U_SUF_LEN 6256
#define NQW_MAX 512      // quads across a 1024-wide codeblock
// codeblocks (threads) a CUDA block: fewer lanes a warp diverge less and
// spread the 6,321 codeblocks of a 4K image over more SMs (PERF.md has the
// sweep over 32, 16, 8 and 4)
#define BLOCK_THREADS 4

struct Writer {
    uint8_t* p;  // base of the row
    int n;       // bytes written
    int cap;
    bool over;
    __device__ __forceinline__ void put(int at, uint8_t b) {
        if (at >= 0 && at < cap) p[at] = b; else over = true;
    }
};

struct MelEnc {
    int tmp = 0, rem = 8, run = 0, k = 0, threshold = 1, n = 0;
};

struct VlcEnc {  // bytes counted from 1: the pre-filled 0xFF is byte 0
    int tmp = 0xF, used = 4, n = 1;
    bool last_gt_8f = true;
};

struct MsEnc {
    uint32_t tmp = 0;
    int used = 0, max_bits = 8;
};

__device__ __forceinline__ void mel_bit(MelEnc& m, Writer& aux, int v) {
    m.tmp = (m.tmp << 1) | v;
    if (--m.rem == 0) {
        aux.put(m.n++, (uint8_t)m.tmp);
        m.rem = m.tmp == 0xFF ? 7 : 8;
        m.tmp = 0;
    }
}

__device__ void mel_encode(MelEnc& m, Writer& aux, const int* mel_exp, bool bit) {
    if (!bit) {
        if (++m.run >= m.threshold) {
            mel_bit(m, aux, 1);
            m.run = 0;
            m.k = min(12, m.k + 1);
            m.threshold = 1 << mel_exp[m.k];
        }
    } else {
        mel_bit(m, aux, 0);
        for (int t = mel_exp[m.k]; t > 0;) {
            --t;
            mel_bit(m, aux, (m.run >> t) & 1);
        }
        m.run = 0;
        m.k = max(0, m.k - 1);
        m.threshold = 1 << mel_exp[m.k];
    }
}

// VLC bytes are stored backward from the end of the scratch row, so the
// stream order (last emitted first) is contiguous there.
__device__ void vlc_encode(VlcEnc& v, Writer& aux, uint32_t cwd, int ln) {
    while (ln > 0) {
        int avail = 8 - (v.last_gt_8f ? 1 : 0) - v.used;
        const int t = min(avail, ln);
        v.tmp |= (int)(cwd & ((1u << t) - 1)) << v.used;
        v.used += t;
        avail -= t;
        ln -= t;
        cwd >>= t;
        if (avail == 0) {
            if (v.last_gt_8f && v.tmp != 0x7F) {
                v.last_gt_8f = false;  // one more usable bit in this byte
                continue;
            }
            aux.put(aux.cap - 1 - v.n++, (uint8_t)v.tmp);
            v.last_gt_8f = v.tmp > 0x8F;
            v.tmp = 0;
            v.used = 0;
        }
    }
}

__device__ void ms_encode(MsEnc& s, Writer& seg, uint32_t cwd, int ln) {
    while (ln > 0) {
        const int t = min(s.max_bits - s.used, ln);
        s.tmp |= (cwd & ((1u << t) - 1)) << s.used;
        s.used += t;
        cwd >>= t;
        ln -= t;
        if (s.used >= s.max_bits) {
            seg.put(seg.n++, (uint8_t)s.tmp);
            s.max_bits = s.tmp == 0xFF ? 7 : 8;
            s.tmp = 0;
            s.used = 0;
        }
    }
}

__global__ void ht_enc_kernel(const int32_t* __restrict__ coeffs,
                              const int32_t* __restrict__ heights,
                              const int32_t* __restrict__ widths,
                              const int32_t* __restrict__ tab,
                              uint8_t* __restrict__ out,
                              uint8_t* __restrict__ scratch,
                              int32_t* __restrict__ lengths,
                              double* __restrict__ energy, int n, int bh,
                              int bw, int cap, int aux_cap) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int h = heights[i], w = widths[i];
    const int32_t* blk = coeffs + (int64_t)i * bh * bw;
    if (energy) {
        double d = 0.0;
        for (int y = 0; y < h; ++y) {
            double dr = 0.0;
            for (int x = 0; x < w; ++x) {
                const double v = (double)blk[(int64_t)y * bw + x];
                dr = __dadd_rn(dr, __dmul_rn(v, v));
            }
            d = __dadd_rn(d, dr);
        }
        energy[i] = d;
    }
    if (h <= 0 || w <= 0) {
        lengths[i] = 0;
        return;
    }
    const int* mel_exp = tab + T_MEL_EXP;
    const int* u_pre = tab + T_U_PRE;
    const int* u_pre_len = tab + T_U_PRE_LEN;
    const int* u_suf = tab + T_U_SUF;
    const int* u_suf_len = tab + T_U_SUF_LEN;
    Writer seg{out + (int64_t)i * cap, 0, cap, false};
    Writer aux{scratch + (int64_t)i * aux_cap, 0, aux_cap, false};
    MelEnc mel;
    VlcEnc vlc;
    MsEnc ms;

    // line buffers of the row above (prev) and this row (cur), swapped per row
    uint8_t e_buf[2][NQW_MAX + 2], cx_buf[2][NQW_MAX + 2];
    const int nqw = (w + 1) >> 1;
    bool any_sig = false;
    for (int qy = 0; qy < (h + 1) >> 1; ++qy) {
        const bool line0 = qy == 0;
        const int* tbl = tab + T_ENC + (line0 ? 0 : 2048);
        const uint8_t* prev_e = e_buf[(qy + 1) & 1];
        const uint8_t* prev_cx = cx_buf[(qy + 1) & 1];
        uint8_t* cur_e = e_buf[qy & 1];
        uint8_t* cur_cx = cx_buf[qy & 1];
        cur_e[0] = 0;
        cur_cx[0] = 0;
        int c_left = 0;
        const int y0 = 2 * qy;
        for (int qx = 0; qx < nqw; qx += 2) {
            int us[2] = {0, 0};
            for (int j = 0; j < 2; ++j) {
                const int qi = qx + j;
                if (qi >= nqw) break;
                int rho = 0, emax = 0;
                int e_q[4];
                uint32_t s_q[4];
                for (int k = 0; k < 4; ++k) {
                    const int y = y0 + (k & 1), x = 2 * qi + (k >> 1);
                    const int32_t c = (y < h && x < w) ? blk[y * bw + x] : 0;
                    const uint32_t mu = (uint32_t)(c < 0 ? -c : c);
                    e_q[k] = 0;
                    s_q[k] = 0;
                    if (mu) {
                        rho |= 1 << k;
                        e_q[k] = 32 - __clz(2 * mu - 1);
                        emax = max(emax, e_q[k]);
                        s_q[k] = 2 * (mu - 1) + (c < 0 ? 1 : 0);
                    }
                }
                int c_q, kappa = 1;
                if (line0) {
                    c_q = c_left;
                } else {
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left;
                    if (rho & (rho - 1))
                        kappa = max(1, max((int)prev_e[qi], (int)prev_e[qi + 1]) - 1);
                }
                const int uq = max(emax, kappa);
                const int u = uq - kappa;
                int eps = 0;
                if (u > 0)
                    for (int k = 0; k < 4; ++k) eps |= (e_q[k] == emax) << k;
                const int tup = __ldg(tbl + (c_q << 8) + (rho << 4) + eps);
                vlc_encode(vlc, aux, (uint32_t)(tup >> 8), (tup >> 4) & 7);
                if (c_q == 0) mel_encode(mel, aux, mel_exp, rho != 0);
                for (int k = 0; k < 4; ++k) {
                    if (rho & (1 << k)) {
                        const int m = uq - ((tup >> k) & 1);
                        ms_encode(ms, seg, s_q[k] & (uint32_t)((1ull << m) - 1), m);
                    }
                }
                any_sig |= rho != 0;
                cur_e[qi] = (uint8_t)max((int)cur_e[qi], e_q[1]);
                cur_e[qi + 1] = (uint8_t)e_q[3];
                cur_cx[qi] |= (rho & 2) >> 1;
                cur_cx[qi + 1] = (rho & 8) >> 3;
                c_left = line0 ? ((rho >> 1) | (rho & 1))
                               : (((rho & 4) >> 1) | ((rho & 8) >> 2));
                us[j] = u;
            }
            const int u0 = us[0], u1 = us[1];
            if (line0) {
                if (u0 > 0 && u1 > 0) mel_encode(mel, aux, mel_exp, min(u0, u1) > 2);
                if (u0 > 2 && u1 > 2) {
                    vlc_encode(vlc, aux, u_pre[u0 - 2], u_pre_len[u0 - 2]);
                    vlc_encode(vlc, aux, u_pre[u1 - 2], u_pre_len[u1 - 2]);
                    vlc_encode(vlc, aux, u_suf[u0 - 2], u_suf_len[u0 - 2]);
                    vlc_encode(vlc, aux, u_suf[u1 - 2], u_suf_len[u1 - 2]);
                    continue;
                }
                if (u0 > 2 && u1 > 0) {
                    vlc_encode(vlc, aux, u_pre[u0], u_pre_len[u0]);
                    vlc_encode(vlc, aux, u1 - 1, 1);
                    vlc_encode(vlc, aux, u_suf[u0], u_suf_len[u0]);
                    continue;
                }
            }
            vlc_encode(vlc, aux, u_pre[u0], u_pre_len[u0]);
            vlc_encode(vlc, aux, u_pre[u1], u_pre_len[u1]);
            vlc_encode(vlc, aux, u_suf[u0], u_suf_len[u0]);
            vlc_encode(vlc, aux, u_suf[u1], u_suf_len[u1]);
        }
    }
    if (!any_sig) {  // an all-zero codeblock has an empty segment
        lengths[i] = 0;
        return;
    }

    // ---- MEL/VLC termination and fuse (ht.py _terminate_mel_vlc)
    if (mel.run > 0) mel_bit(mel, aux, 1);
    const int mel_tmp = (mel.tmp << mel.rem) & 0xFF;
    const int mel_mask = (0xFF << mel.rem) & 0xFF;
    const int vlc_mask = vlc.used ? 0xFF >> (8 - vlc.used) : 0;
    int extra_mel = -1, extra_vlc = -1;  // bytes after MEL / before VLC
    if (mel_mask | vlc_mask) {
        const int fuse = mel_tmp | vlc.tmp;
        if ((((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) == 0 &&
            fuse != 0xFF && vlc.n > 1) {
            extra_mel = fuse;
        } else {
            extra_mel = mel_tmp;
            extra_vlc = vlc.tmp;
        }
    }
    // the 0xFF that opens the VLC stream
    aux.put(aux.cap - 1, 0xFF);

    // ---- MagSgn termination (ht.py MsEnc.terminate)
    if (ms.used) {
        const int t = ms.max_bits - ms.used;
        ms.tmp |= (0xFFu & ((1u << t) - 1)) << ms.used;
        if (ms.tmp != 0xFF) seg.put(seg.n++, (uint8_t)ms.tmp);
    } else if (ms.max_bits == 7) {
        --seg.n;  // a final 0xFF with nothing after it is dropped
    }
    if (mel.n + vlc.n > aux.cap) aux.over = true;

    // ---- assembly: MagSgn | MEL (+ fused or partial byte) | VLC
    int pos = seg.n;
    for (int b = 0; b < mel.n && !aux.over; ++b) seg.put(pos++, aux.p[b]);
    if (extra_mel >= 0) seg.put(pos++, (uint8_t)extra_mel);
    if (extra_vlc >= 0) seg.put(pos++, (uint8_t)extra_vlc);
    for (int b = aux.cap - vlc.n; b < aux.cap && !aux.over; ++b) seg.put(pos++, aux.p[b]);
    const int scup = pos - seg.n;
    if (seg.over || aux.over || pos < 2) {
        lengths[i] = -1;
        return;
    }
    seg.p[pos - 1] = (uint8_t)((scup >> 4) & 0xFF);
    seg.p[pos - 2] = (uint8_t)((seg.p[pos - 2] & 0xF0) | (scup & 0xF));
    lengths[i] = pos;
}

// coeffs [n, bh, bw] int32; heights/widths [n] int32; tab: ht_tables();
// out [n, cap] uint8 (zeroed by the caller); scratch [n, aux_cap] uint8;
// lengths [n] int32 (-1: the codeblock overflowed its capacity); energy
// [n] float64 or null (no energy).
extern "C" int ht_cleanup_enc(const void* coeffs, const void* heights,
                              const void* widths, const void* tab, void* out,
                              void* scratch, void* lengths, void* energy, int n,
                              int bh, int bw, int cap, int aux_cap, void* stream) {
    if (n <= 0) return 0;
    if (bw > 2 * NQW_MAX) return (int)cudaErrorInvalidValue;
    ht_enc_kernel<<<(n + BLOCK_THREADS - 1) / BLOCK_THREADS, BLOCK_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const int32_t*)coeffs, (const int32_t*)heights, (const int32_t*)widths,
        (const int32_t*)tab, (uint8_t*)out, (uint8_t*)scratch, (int32_t*)lengths,
        (double*)energy, n, bh, bw, cap, aux_cap);
    return (int)cudaGetLastError();
}
