// K-f ht_cleanup_dec: decode a batch of HTJ2K cleanup segments (T.814
// clause 7.3) into signed coefficients, with one flag per codeblock whose
// decode stopped early on a corrupt segment.
//
// Replaces: grok_tpu/t1/ht_jax_dec.py _decode_device (:233), the XLA
// program that unstuffs the three streams into dense words (_unstuff_* :60-
// 138, over host-presliced suffixes, preslice_suffix :141), scans the
// VLC/MEL parse per quad pair (_mel_event :170) and extracts MagSgn row by
// row. Written from the scalar decoder grok_tpu/t1/ht.py decode_cleanup
// (:538) and its readers MelDec/VlcDec/MsDec (:347-472): each codeblock
// reads its own segment directly -- MagSgn forward from byte 0, MEL forward
// from Lcup - Scup, VLC backward from the high nibble of byte Lcup - 2 --
// so none of the TPU's preslicing, capacity floors or bucketing remain.
//
// Reads past a chunk give the scalar readers' pads (0xFF for MagSgn and MEL,
// 0 for VLC), so such a codeblock decodes to what the scalar decoder gives;
// no address outside the segment is touched. On a corrupt segment the decode
// stops where grok_tpu's default decoder (native/ht_coder.cpp decode_block)
// stops, keeping what it wrote, and flags the codeblock: at an invalid
// CxtVLC codeword, at a MagSgn field over 32 bits, or at once when the header
// is invalid (Scup outside [2, Lcup]). MagSgn fields of up to 32 bits are
// read in 64-bit arithmetic and the result wraps to int32, as there.
//
// Bound on an H100 (3.35 TB/s): bytes. The segments are read once and the
// int32 samples inside each codeblock written once: the 24.9M samples of a
// 3840x2160x3 image write 99.5 MB, about 0.036 ms with the segments. Design: one thread per codeblock runs
// the scalar parse; the VLC/MEL chain is serial within a codeblock and the
// MagSgn reads depend on it. Line buffers live in per-thread local memory.

#include <cuda_runtime.h>
#include <stdint.h>

// int32 table layout shared with t1/ht_cuda.py ht_tables()
#define T_DEC 4096       // [2][8][128] rho | u_off<<4 | e_k<<5 | e_1<<9 | len<<13; -1 invalid
#define T_MEL_EXP 6144   // [13]
#define NQW_MAX 512
#define MS_BITS 32  // the widest MagSgn field decode_block reads
// codeblocks (threads) a CUDA block: fewer lanes a warp diverge less and
// spread the 6,321 codeblocks of a 4K image over more SMs (PERF.md has the
// sweep over 32, 16, 8 and 4)
#define BLOCK_THREADS 4

struct MsDec {
    const uint8_t* p;
    int pos, end, bits;
    bool prev_ff;
    uint64_t tmp;
    __device__ uint32_t read(int n) {
        if (n == 0) return 0;
        while (bits < n) {
            const int nbits = prev_ff ? 7 : 8;
            const uint32_t b = pos < end ? p[pos++] : 0xFF;
            prev_ff = b == 0xFF;
            tmp |= (uint64_t)(b & ((1u << nbits) - 1)) << bits;
            bits += nbits;
        }
        const uint32_t v = (uint32_t)(tmp & ((1ull << n) - 1));
        tmp >>= n;
        bits -= n;
        return v;
    }
};

struct MelDec {
    const uint8_t* p;
    int pos, end, bits, tmp, k, zeros;
    bool prev_ff, one;
    __device__ int bit() {
        if (bits == 0) {
            const int b = pos < end ? p[pos++] : 0xFF;
            bits = prev_ff ? 7 : 8;
            prev_ff = b == 0xFF;
            tmp = b;
        }
        --bits;
        return (tmp >> bits) & 1;
    }
    __device__ int event(const int* mel_exp) {
        if (!zeros && !one) {
            if (bit()) {
                zeros = 1 << mel_exp[k];
                k = min(12, k + 1);
            } else {
                int run = 0;
                for (int t = mel_exp[k]; t > 0; --t) run = (run << 1) | bit();
                k = max(0, k - 1);
                zeros = run;
                one = true;
            }
        }
        if (zeros) {
            --zeros;
            return 0;
        }
        one = false;
        return 1;
    }
};

struct VlcDec {  // backward over [start, pos]
    const uint8_t* p;
    int pos, start, bits;
    bool unstuff;
    uint32_t tmp;
    __device__ void fill(int need) {
        while (bits < need) {
            const uint32_t b = pos >= start ? p[pos--] : 0;
            const int nbits = (unstuff && (b & 0x7F) == 0x7F) ? 7 : 8;
            unstuff = b > 0x8F;
            tmp |= (b & ((1u << nbits) - 1)) << bits;
            bits += nbits;
        }
    }
    __device__ int peek(int n) {
        fill(n);
        return (int)(tmp & ((1u << n) - 1));
    }
    __device__ void advance(int n) {
        fill(n);
        tmp >>= n;
        bits -= n;
    }
    __device__ int read(int n) {
        const int v = peek(n);
        advance(n);
        return v;
    }
    __device__ int prefix() {  // 1 -> 1, 01 -> 2, 001 -> 3, 000 -> 5
        if (read(1)) return 1;
        if (read(1)) return 2;
        return read(1) ? 3 : 5;
    }
    __device__ int suffix(int pre) {
        if (pre == 3) return 3 + read(1);
        if (pre == 5) return 5 + read(5);
        return pre;
    }
};

__global__ void ht_dec_kernel(const uint8_t* __restrict__ data,
                              const int32_t* __restrict__ lengths,
                              const int32_t* __restrict__ heights,
                              const int32_t* __restrict__ widths,
                              const int32_t* __restrict__ tab,
                              int32_t* __restrict__ out,
                              uint8_t* __restrict__ stopped, int n, int L, int bh,
                              int bw) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    stopped[i] = 0;
    const int len = lengths[i], h = heights[i], w = widths[i];
    const uint8_t* seg = data + (int64_t)i * L;
    if (len < 2 || len > L || h <= 0 || w <= 0) return;
    const int scup = (seg[len - 1] << 4) | (seg[len - 2] & 0xF);
    if (scup < 2 || scup > len) {
        stopped[i] = 1;
        return;
    }
    const int ms_len = len - scup;
    int32_t* o = out + (int64_t)i * bh * bw;
    const int* mel_exp = tab + T_MEL_EXP;

    MsDec ms{seg, 0, ms_len, 0, false, 0};
    MelDec mel{seg, ms_len, len, 0, 0, 0, 0, false, false};
    VlcDec vlc{seg, len - 3, ms_len, 0, false, 0};
    {
        const int d = seg[len - 2];
        vlc.bits = 4 - (((d >> 4) & 7) == 7 ? 1 : 0);
        vlc.tmp = (uint32_t)(d >> 4) & ((1u << vlc.bits) - 1);  // payload bits only
        vlc.unstuff = (d | 0xF) > 0x8F;
    }

    uint8_t e_buf[2][NQW_MAX + 2], cx_buf[2][NQW_MAX + 2];
    const int nqw = (w + 1) >> 1;
    bool ok = true;
    for (int qy = 0; qy < (h + 1) >> 1 && ok; ++qy) {
        const bool line0 = qy == 0;
        const int* tbl = tab + T_DEC + (line0 ? 0 : 1024);
        const uint8_t* prev_e = e_buf[(qy + 1) & 1];
        const uint8_t* prev_cx = cx_buf[(qy + 1) & 1];
        uint8_t* cur_e = e_buf[qy & 1];
        uint8_t* cur_cx = cx_buf[qy & 1];
        cur_e[0] = 0;
        cur_cx[0] = 0;
        int c_left = 0;
        for (int qx = 0; qx < nqw && ok; qx += 2) {
            int rho[2] = {0, 0}, u_off[2] = {0, 0}, e_k[2] = {0, 0}, e_1[2] = {0, 0};
            int kappa[2] = {1, 1};
            for (int j = 0; j < 2; ++j) {
                const int qi = qx + j;
                if (qi >= nqw) break;
                const int c_q = line0 ? c_left
                                      : prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left;
                if (c_q != 0 || mel.event(mel_exp)) {
                    const int ent = __ldg(tbl + c_q * 128 + vlc.peek(7));
                    if (ent < 0) {
                        ok = false;  // invalid codeword
                        break;
                    }
                    rho[j] = ent & 0xF;
                    u_off[j] = (ent >> 4) & 1;
                    e_k[j] = (ent >> 5) & 0xF;
                    e_1[j] = (ent >> 9) & 0xF;
                    vlc.advance((ent >> 13) & 7);
                }
                const int r = rho[j];
                if (!line0 && (r & (r - 1)))
                    kappa[j] = max(1, max((int)prev_e[qi], (int)prev_e[qi + 1]) - 1);
                c_left = line0 ? ((r >> 1) | (r & 1)) : (((r & 4) >> 1) | ((r & 8) >> 2));
            }
            if (!ok) break;

            // u pair (ht.py _dec_u_pair)
            int u0 = 0, u1 = 0;
            if (line0 && u_off[0] && u_off[1]) {
                if (mel.event(mel_exp)) {
                    const int p0 = vlc.prefix();
                    const int p1 = vlc.prefix();
                    u0 = vlc.suffix(p0) + 2;
                    u1 = vlc.suffix(p1) + 2;
                } else {
                    const int p0 = vlc.prefix();
                    if (p0 > 2) {
                        u1 = 1 + vlc.read(1);
                        u0 = vlc.suffix(p0);
                    } else {
                        const int p1 = vlc.prefix();
                        u0 = vlc.suffix(p0);
                        u1 = vlc.suffix(p1);
                    }
                }
            } else {
                const int p0 = u_off[0] ? vlc.prefix() : 0;
                const int p1 = u_off[1] ? vlc.prefix() : 0;
                if (u_off[0]) u0 = vlc.suffix(p0);
                if (u_off[1]) u1 = vlc.suffix(p1);
            }

            for (int j = 0; j < 2 && ok; ++j) {
                const int qi = qx + j;
                if (qi >= nqw) break;
                const int uq = kappa[j] + (j ? u1 : u0);
                int e_bl = 0, e_br = 0;
                for (int k = 0; k < 4; ++k) {
                    if (!(rho[j] & (1 << k))) continue;
                    const int m = uq - ((e_k[j] >> k) & 1);
                    if (m > MS_BITS) {
                        ok = false;
                        break;
                    }
                    const uint64_t v = (uint64_t)ms.read(m) |
                                       ((uint64_t)((e_1[j] >> k) & 1) << m);
                    const int64_t mu = (int64_t)(v >> 1) + 1;
                    const int e_n = 64 - __clzll((long long)(v | 1));
                    const int y = 2 * qy + (k & 1), x = 2 * qi + (k >> 1);
                    if (y < h && x < w) o[y * bw + x] = (int32_t)((v & 1) ? -mu : mu);
                    if (k == 1) e_bl = e_n;
                    else if (k == 3) e_br = e_n;
                }
                cur_e[qi] = (uint8_t)max((int)cur_e[qi], e_bl);
                cur_e[qi + 1] = (uint8_t)e_br;
                cur_cx[qi] |= (rho[j] & 2) >> 1;
                cur_cx[qi + 1] = (rho[j] & 8) >> 3;
            }
        }
    }
    stopped[i] = !ok;
}

// data [n, L] uint8; lengths/heights/widths [n] int32; tab: ht_tables();
// out [n, bh, bw] int32 (zeroed by the caller); stopped [n] uint8.
extern "C" int ht_cleanup_dec(const void* data, const void* lengths,
                              const void* heights, const void* widths,
                              const void* tab, void* out, void* stopped, int n, int L,
                              int bh, int bw, void* stream) {
    if (n <= 0) return 0;
    if (bw > 2 * NQW_MAX) return (int)cudaErrorInvalidValue;
    ht_dec_kernel<<<(n + BLOCK_THREADS - 1) / BLOCK_THREADS, BLOCK_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)lengths, (const int32_t*)heights,
        (const int32_t*)widths, (const int32_t*)tab, (int32_t*)out, (uint8_t*)stopped,
        n, L, bh, bw);
    return (int)cudaGetLastError();
}
