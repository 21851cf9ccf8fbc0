// K-e ht_cleanup_enc: the HTJ2K cleanup pass (T.814 clause 7.3) of a batch
// of codeblocks, each into its finished codeword segment
// [MagSgn fwd][MEL fwd][VLC bwd] with the Scup locator patched into its last
// two bytes.
//
// Replaces: grok_tpu/t1/ht_jax.py _encode_device (:217), the XLA program of
// quad exponents, CxtVLC lookups, u-codes, MagSgn items and the MEL scan
// packed into uint32 words, together with the host byte stuffing and
// assembly that follow it (_stuff_host :503, _compact :560). It computes
// what the scalar coder grok_tpu/t1/ht.py encode_cleanup (:214) writes,
// with its bit machines MelEnc/VlcEnc/MsEnc (:88-190) and
// _terminate_mel_vlc (:191), byte for byte.
//
// Bound on an H100 (3.35 TB/s): bytes. The function reads the int32 samples
// inside each codeblock once (4 bytes a sample, 99.5 MB for the 24.9M
// samples of a 3840x2160x3 image) and writes each codeblock's output row
// whole, the segment and the zeros past it (55.7 MB: 6,321 rows of 8,815
// bytes), and its length; about 0.046 ms.
//
// Range: every int32 coefficient, INT32_MIN included (|v| = 2^31 on
// uint32_t, as native/ht_coder.cpp takes it): exponents up to 32, so a
// MagSgn field holds up to 32 bits, a quad's four up to 128 (mlo, mhi) and a
// chunk's up to 4,096 (MS_WORDS), and u up to 31 (the u-code tables hold 33).
//
// Design: one warp a codeblock, one quad a lane. Everything but the three
// bit writers is a function of the magnitudes, so a warp takes a quad row
// 32 quads (a chunk) at a time, left to right:
//  - each lane loads its 2x2 samples (those of the next chunk while this
//    one is coded) and forms rho, the exponents and the MagSgn values;
//    the context from the left quad comes by a shuffle (and
//    from the chunk before, for lane 0), the exponents and significance of
//    the row above from a per-warp line of 16-bit entries in shared memory
//    (e of the quad's bottom-left and bottom-right samples), read for the
//    quad and shuffled to its neighbours;
//  - the CxtVLC codeword comes from the encode table in shared memory;
//    lane 2j+1 of a quad pair also forms the pair's u-codes (the three
//    line-0 cases of encode_cleanup), so a lane's VLC bits are its
//    codeword, then for an odd lane the pair's u-codes, in stream order;
//  - one warp scan of both streams' bit counts gives every lane its offset;
//    the lanes OR their bits into a staging area (shared memory) behind
//    the bits the stream carried over from the chunk before;
//  - bytes are formed as if none were stuffed, MagSgn 128 at a time (4 a
//    lane), VLC 32 at a time; a ballot finds
//    the first byte a stuffing rule applies to (MagSgn: a 0xFF, after
//    which a byte takes 7 bits; VLC: a byte whose previous byte is above
//    0x8F and whose low 7 bits are all ones, which takes 7 bits), the warp
//    keeps the bytes up to it and goes on from there. MagSgn bytes go
//    straight to the segment, VLC bytes backward into the codeblock's
//    scratch row;
//  - the MEL events (one a quad whose context is 0, one a line-0 pair with
//    both u above 0) come from ballots, in stream order; lane 0 runs the
//    adaptive run-length coder over them (its state in shared memory
//    between chunks) and writes MEL bytes forward into the scratch row.
// At the end lane 0 terminates MEL/VLC and MagSgn, the warp copies MEL and
// VLC behind MagSgn, lane 0 patches Scup, and the warp writes the zeros
// past the segment (the wrapper allocates the rows uninitialised). A
// segment or scratch row that would overflow its capacity sets the
// codeblock's length to -1 (the wrapper raises); no byte is written outside
// either. 64 registers or fewer, no spills: 32 warps an SM, the 6,321
// codeblocks of a 4K image in two waves (PERF.md §6).
//
// Block energy (for PCRD): given a non-null ``energy``, the warp also
// writes its codeblock's sum(v*v) in float64 as grok_tpu's default HT coder
// sums it: row sums along x first, then the sum of the rows, each
// sequential in IEEE double (native/ht_coder.cpp:650-662; K3 computes it in
// float32, ht_jax.py:465, and is not followed). Every partial sum of that
// order is an integer no larger than the total, so where no magnitude
// reaches 2^24 (each product exact) and the total is below 2^53, every
// partial sum is exact and the result is the integer total, which the
// lanes add up from their quads in any order. Otherwise the warp redoes
// the reference's order: lane l sums rows l, l + 32, ... along x, and the
// row sums are added in row order, with IEEE-rounded double intrinsics
// (the source is built with -fmad=false). It adds 8 bytes a codeblock
// written to the bytes bound.

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
#define MAX_WARPS 16     // codeblocks a CUDA block, at most
// shared memory: the block's tables, then each warp's staging and line
#define HEAD_BYTES 8320  // ENC [2][2048] u16, u-codes [33] u16 at 8192, MEL_EXP [13] at 8272
#define MS_WORDS 132     // MagSgn staging: 7 carried + 32 quads x 4 fields of up to 32 bits, and words to read past
#define VLC_WORDS 26     // VLC staging: 7 carried + 32 lanes x 23 bits, and words to read past
#define FULL 0xFFFFFFFFu

#define STATE_WORDS 8     // a warp's MEL coder state and stats counters
// shared bytes of a warp: MagSgn and VLC staging, the MEL state, the row
// above (a u16 a quad)
__host__ __device__ __forceinline__ int warp_bytes_of(int bw) {
    const int nqw = (((bw + 1) >> 1) + 7) & ~7;
    return (4 * (MS_WORDS + VLC_WORDS + STATE_WORDS) + 2 * nqw + 15) & ~15;
}

// the bits of x up to its highest set one (0 for 0): __clz counts the
// leading zeros of the 32 bits, read as an int (x above 2^31 - 1 has none)
__device__ __forceinline__ int bit_length(uint32_t x) { return 32 - __clz((int)x); }

// the 8 bits at bit q of a staging area (LSB first)
__device__ __forceinline__ uint32_t bits8(const uint32_t* st, int q) {
    const uint64_t w = (uint64_t)st[q >> 5] | ((uint64_t)st[(q >> 5) + 1] << 32);
    return (uint32_t)(w >> (q & 31)) & 0xFFu;
}

// the 32 bits at bit q of a staging area (LSB first)
__device__ __forceinline__ uint32_t bits32(const uint32_t* st, int q) {
    const uint64_t w = (uint64_t)st[q >> 5] | ((uint64_t)st[(q >> 5) + 1] << 32);
    return (uint32_t)(w >> (q & 31));
}

// zeros over seg[from, cap) by the warp, 16-byte stores where aligned
__device__ __forceinline__ void zero_tail(uint8_t* seg, int from, int cap, int lane) {
    if (from >= cap) return;
    uint8_t* p = seg + from;
    uint8_t* e = seg + cap;
    const uintptr_t up = ((uintptr_t)p + 15) & ~(uintptr_t)15;
    const uintptr_t ue = (uintptr_t)e & ~(uintptr_t)15;
    uint8_t* a = up < (uintptr_t)e ? (uint8_t*)up : e;
    uint8_t* b = ue > (uintptr_t)a ? (uint8_t*)ue : a;
    if (lane < a - p) p[lane] = 0;
    for (uint4* q = (uint4*)a + lane; q < (uint4*)b; q += 32) *q = make_uint4(0u, 0u, 0u, 0u);
    if (lane < e - b) b[lane] = 0;
}

// the quad of (qy, qi): samples 0 TL, 1 BL, 2 TR, 3 BR, zero outside h x w
__device__ __forceinline__ void load_quad(int32_t v[4], const int32_t* blk, int qy, int qi,
                                          int h, int w, int bw) {
    v[0] = v[1] = v[2] = v[3] = 0;
    const int y0 = 2 * qy, x0 = 2 * qi;
    if (y0 < h && x0 < w) {
        const int32_t* p = blk + (int64_t)y0 * bw + x0;
        const bool x1 = x0 + 1 < w;
        v[0] = __ldg(p);
        if (x1) v[2] = __ldg(p + 1);
        if (y0 + 1 < h) {
            v[1] = __ldg(p + bw);
            if (x1) v[3] = __ldg(p + bw + 1);
        }
    }
}

// the block energy in the reference's order: row sums of v*v along x,
// then the sum of the rows, each sequential in IEEE double; lane l sums
// rows l, l + 32, ...
__device__ double energy_rows(const int32_t* blk, int h, int w, int bw, int lane) {
    double d = 0.0;
    for (int r0 = 0; r0 < h; r0 += 32) {
        double dr = 0.0;
        const int y = r0 + lane;
        if (y < h) {
            const int32_t* row = blk + (int64_t)y * bw;
            for (int x = 0; x < w; ++x) {
                const double v = (double)__ldg(row + x);
                dr = __dadd_rn(dr, __dmul_rn(v, v));
            }
        }
        const int rows = min(32, h - r0);
        for (int r = 0; r < rows; ++r) d = __dadd_rn(d, __shfl_sync(FULL, dr, r));
    }
    return d;
}

// MEL coder state (lane 0's, kept in shared memory between chunks)
struct Mel {
    int tmp, rem, run, k, n;
};
// a warp's state words: the MEL coder, then the stats counters
#define ST_MEL_EVENTS 5
#define ST_MS_STUFFED 6
#define ST_VLC_STUFFED 7

// MEL bits, MSB first, into bytes of 8 bits (7 after a 0xFF)
__device__ __forceinline__ void mel_put(Mel& m, uint8_t* aux, int aux_cap, int val, int nb) {
    while (nb > 0) {
        const int t = min(m.rem, nb);
        m.tmp = (m.tmp << t) | ((val >> (nb - t)) & ((1 << t) - 1));
        m.rem -= t;
        nb -= t;
        if (m.rem == 0) {
            if (m.n < aux_cap) aux[m.n] = (uint8_t)m.tmp;
            ++m.n;
            m.rem = m.tmp == 0xFF ? 7 : 8;
            m.tmp = 0;
        }
    }
}

__device__ __forceinline__ void mel_event(Mel& m, uint8_t* aux, int aux_cap,
                                          const uint8_t* mel_exp, bool bit) {
    if (!bit) {
        if (++m.run >= (1 << mel_exp[m.k])) {
            mel_put(m, aux, aux_cap, 1, 1);
            m.run = 0;
            m.k = min(12, m.k + 1);
        }
    } else {
        const int e = mel_exp[m.k];
        mel_put(m, aux, aux_cap, m.run & ((1 << e) - 1), e + 1);  // a 0, then e bits of run
        m.run = 0;
        m.k = max(0, m.k - 1);
    }
}

// OR ``len`` (<= 128) bits (lo, hi) into a staging area at bit ``o``
// (32-bit shared atomics: 64-bit ones were measured slower)
__device__ __forceinline__ void stage_bits(uint32_t* st, int o, uint64_t lo, uint64_t hi,
                                           int len) {
    if (len == 0) return;
    const uint32_t d[4] = {(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                           (uint32_t)(hi >> 32)};
    const int w0 = o >> 5, sh = o & 31, nw = (sh + len + 31) >> 5;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
        if (t < nw) {
            uint32_t v = t < 4 ? d[t] << sh : 0u;
            if (t > 0 && sh) v |= d[t - 1] >> (32 - sh);
            if (v) atomicOr(st + w0 + t, v);
        }
    }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
ht_enc_kernel(const int32_t* __restrict__ coeffs, const int32_t* __restrict__ heights,
              const int32_t* __restrict__ widths, const int32_t* __restrict__ tab,
              uint8_t* __restrict__ out, uint8_t* __restrict__ scratch,
              int32_t* __restrict__ lengths, double* __restrict__ energy,
              int32_t* __restrict__ stats, int n, int bh, int bw, int cap, int aux_cap) {
    extern __shared__ __align__(16) uint8_t s_dyn[];
    uint16_t* s_tab = (uint16_t*)s_dyn;
    uint16_t* s_uc = (uint16_t*)(s_dyn + 8192);
    uint8_t* s_mel = s_dyn + 8272;
    for (int t = threadIdx.x; t < 4096; t += blockDim.x) s_tab[t] = (uint16_t)__ldg(tab + T_ENC + t);
    if (threadIdx.x < 33) {
        const int t = threadIdx.x;
        // prefix (3 bits) | its length (2) << 3 | suffix (5) << 5 | its length (3) << 10
        s_uc[t] = (uint16_t)(__ldg(tab + T_U_PRE + t) | (__ldg(tab + T_U_PRE_LEN + t) << 3) |
                             (__ldg(tab + T_U_SUF + t) << 5) | (__ldg(tab + T_U_SUF_LEN + t) << 10));
    }
    if (threadIdx.x < 13) s_mel[threadIdx.x] = (uint8_t)__ldg(tab + T_MEL_EXP + threadIdx.x);
    __syncthreads();

    const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
    const int i = blockIdx.x * (blockDim.x >> 5) + wi;
    if (i >= n) return;
    const int h = heights[i], w = widths[i];
    const int32_t* blk = coeffs + (int64_t)i * bh * bw;

    uint32_t* s_ms = (uint32_t*)(s_dyn + HEAD_BYTES + wi * warp_bytes_of(bw));
    uint32_t* s_vl = s_ms + MS_WORDS;
    int* s_st = (int*)(s_vl + VLC_WORDS);  // Mel, then the stats counters
    uint16_t* s_up = (uint16_t*)(s_st + STATE_WORDS);  // the row above: e(BL) | e(BR) << 8
    uint8_t* seg = out + (int64_t)i * cap;
    uint8_t* aux = scratch + (int64_t)i * aux_cap;
    const int nqw = (w + 1) >> 1, nqh = (h + 1) >> 1, nch = (nqw + 31) >> 5;
    const int chunks = h > 0 && w > 0 ? nqh * nch : 0;

    // stream states, the same in every lane: the bits carried to the next
    // chunk, the bytes written, the stuffing state
    uint32_t ms_tmp = 0, vl_tmp = 0xF;  // VLC opens with the 4 locator bits
    int ms_used = 0, vl_used = 4, ms_n = 0, vl_n = 1;  // VLC byte 0 is the 0xFF
    bool ms_ff = false, vl_gt = true;
    if (lane == 0) {
        *(Mel*)s_st = Mel{0, 8, 0, 0, 0};
        s_st[ST_MEL_EVENTS] = s_st[ST_MS_STUFFED] = s_st[ST_VLC_STUFFED] = 0;
    }
    unsigned any = 0;
    // the energy as an exact integer, and whether a magnitude reaches 2^24
    uint64_t sq = 0;
    uint32_t big = 0;

    int qy = 0, c = 0;
    int cl_carry = 0;       // context from the quad left of the chunk
    uint32_t al_carry = 0;  // the row above at the quad left of the chunk
    int32_t v[4];
    load_quad(v, blk, 0, lane, h, w, bw);
    for (int t = 0; t < chunks; ++t) {
        const bool line0 = qy == 0;
        const uint16_t* tbl = s_tab + (line0 ? 0 : 2048);
        const int qi = (c << 5) + lane;
        const bool valid = qi < nqw;
        int rho = 0, emax = 0, e[4];
        uint32_t s[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // |v| up to 2^31 (v = INT32_MIN), its exponent up to 32 and its
            // MagSgn value 2(mu - 1) + sign up to 2^32 - 1: all on uint32_t
            const uint32_t mu = v[k] < 0 ? 0u - (uint32_t)v[k] : (uint32_t)v[k];
            e[k] = mu ? bit_length(2u * mu - 1u) : 0;
            s[k] = mu ? 2u * (mu - 1u) + (v[k] < 0 ? 1u : 0u) : 0u;
            rho |= (mu != 0) << k;
            emax = max(emax, e[k]);
            if (energy) {
                sq += (uint64_t)mu * mu;
                big |= mu >> 24;
            }
        }
        // the next chunk's samples, loaded while this one is coded
        const int nc = c + 1 < nch ? c + 1 : 0, nqy = nc ? qy : qy + 1;
        load_quad(v, blk, nqy, (nc << 5) + lane, h, w, bw);
        // ---- contexts: the row above and the quad on the left
        const uint32_t a = (!line0 && valid) ? s_up[qi] : 0u;
        uint32_t al = __shfl_up_sync(FULL, a, 1);
        uint32_t ar = __shfl_down_sync(FULL, a, 1);
        if (lane == 0) al = al_carry;
        if (lane == 31) ar = (!line0 && qi + 1 < nqw) ? s_up[qi + 1] : 0u;
        al_carry = __shfl_sync(FULL, a, 31);
        const int cl_out = line0 ? ((rho >> 1) | (rho & 1))
                                 : (((rho & 4) >> 1) | ((rho & 8) >> 2));
        int c_left = __shfl_up_sync(FULL, cl_out, 1);
        if (lane == 0) c_left = cl_carry;
        cl_carry = __shfl_sync(FULL, cl_out, 31);
        int c_q = c_left, kappa = 1;
        if (!line0) {
            const int pe0 = max((int)(al >> 8), (int)(a & 0xFF));
            const int pe1 = max((int)(a >> 8), (int)(ar & 0xFF));
            c_q += (pe0 != 0) + ((pe1 != 0) << 2);
            if (rho & (rho - 1)) kappa = max(1, max(pe0, pe1) - 1);
        }
        const int uq = max(emax, kappa);
        const int u = valid ? uq - kappa : 0;
        int eps = 0;
        if (u > 0)
            eps = (e[0] == emax) | ((e[1] == emax) << 1) | ((e[2] == emax) << 2) |
                  ((e[3] == emax) << 3);
        const int tup = valid ? tbl[(c_q << 8) + (rho << 4) + eps] : 0;
        // a lane reads the row above at its own quad (and lane 31 at the next
        // chunk's first), so it may write its own entry now
        if (valid) s_up[qi] = (uint16_t)(e[1] | (e[3] << 8));
        // ---- MagSgn: the fields of the quad's significant samples, in order
        int m[4];
        uint32_t f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            m[k] = (rho >> k) & 1 ? uq - ((tup >> k) & 1) : 0;
            f[k] = s[k] & (uint32_t)((1ull << m[k]) - 1);
        }
        const int p1 = m[0], p2 = p1 + m[1], p3 = p2 + m[2], mlen = p3 + m[3];
        uint64_t mlo = 0, mhi = 0;
        if (mlen <= 64) {  // a field at 64 has no bits (& 63 keeps the shift defined)
            mlo = (uint64_t)f[0] | ((uint64_t)f[1] << (p1 & 63)) |
                  ((uint64_t)f[2] << (p2 & 63)) | ((uint64_t)f[3] << (p3 & 63));
        } else {
            int at = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (at < 64) {
                    mlo |= (uint64_t)f[k] << at;
                    if (at + m[k] > 64) mhi |= (uint64_t)f[k] >> (64 - at);
                } else {
                    mhi |= (uint64_t)f[k] << (at - 64);
                }
                at += m[k];
            }
        }
        // ---- VLC: the CxtVLC codeword, then on lane 2j+1 the pair's u-codes
        int vlen = (tup >> 4) & 7;
        uint32_t vbits = (uint32_t)(tup >> 8) & ((1u << vlen) - 1);
        const int u0 = __shfl_up_sync(FULL, u, 1);
        bool ev_p = false, bit_p = false;
        if ((lane & 1) && qi - 1 < nqw) {
            const int u1 = u;
            auto put = [&](uint32_t val, int len) {
                vbits |= (val & ((1u << len) - 1)) << vlen;
                vlen += len;
            };
            if (line0 && u0 > 0 && u1 > 0) {
                ev_p = true;
                bit_p = min(u0, u1) > 2;
            }
            if (line0 && u0 > 2 && u1 > 2) {
                const uint32_t c0 = s_uc[u0 - 2], c1 = s_uc[u1 - 2];
                put(c0 & 7, (c0 >> 3) & 3);
                put(c1 & 7, (c1 >> 3) & 3);
                put((c0 >> 5) & 31, c0 >> 10);
                put((c1 >> 5) & 31, c1 >> 10);
            } else if (line0 && u0 > 2 && u1 > 0) {
                const uint32_t c0 = s_uc[u0];
                put(c0 & 7, (c0 >> 3) & 3);
                put((uint32_t)(u1 - 1), 1);
                put((c0 >> 5) & 31, c0 >> 10);
            } else {
                const uint32_t c0 = s_uc[u0], c1 = s_uc[u1];
                put(c0 & 7, (c0 >> 3) & 3);
                put(c1 & 7, (c1 >> 3) & 3);
                put((c0 >> 5) & 31, c0 >> 10);
                put((c1 >> 5) & 31, c1 >> 10);
            }
        }
        // ---- MEL: the events of the chunk in stream order, on lane 0
        const unsigned eq = __ballot_sync(FULL, valid && c_q == 0);
        const unsigned bq = __ballot_sync(FULL, rho != 0);
        const unsigned ep = line0 ? __ballot_sync(FULL, ev_p) : 0u;  // pairs: line 0 only
        const unsigned bp = line0 ? __ballot_sync(FULL, bit_p) : 0u;
        any |= bq;
        if (lane == 0 && (eq | ep)) {
            Mel mel = *(Mel*)s_st;
            for (unsigned todo = eq | ep; todo; todo &= todo - 1) {
                const int l = __ffs(todo) - 1;
                if ((eq >> l) & 1) mel_event(mel, aux, aux_cap, s_mel, (bq >> l) & 1);
                if ((ep >> l) & 1) mel_event(mel, aux, aux_cap, s_mel, (bp >> l) & 1);
            }
            *(Mel*)s_st = mel;
            if (stats) s_st[ST_MEL_EVENTS] += __popc(eq) + __popc(ep);
        }
        // ---- offsets of both streams' bits: one scan, MagSgn low, VLC high
        const int both = mlen | (vlen << 16);
        int incl = both;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += t;
        }
        const int tot = __shfl_sync(FULL, incl, 31);
        const int excl = incl - both;
        const int ms_bits = ms_used + (tot & 0xFFFF), vl_bits = vl_used + (tot >> 16);
        const int ms_w = (ms_bits >> 5) + 2, vl_w = (vl_bits >> 5) + 2;
        // word 0 takes the bits carried over, which no lane's bits overlap
        for (int t = lane; t < ms_w; t += 32) s_ms[t] = t ? 0u : ms_tmp;
        if (lane < vl_w) s_vl[lane] = lane ? 0u : vl_tmp;
        __syncwarp();
        stage_bits(s_ms, ms_used + (excl & 0xFFFF), mlo, mhi, mlen);
        stage_bits(s_vl, vl_used + (excl >> 16), vbits, 0, vlen);
        __syncwarp();
        // ---- MagSgn bytes: 128 at a time (4 a lane), up to and with the first 0xFF
        {
            int p = 0;
            for (;;) {
                const int cap0 = ms_ff ? 7 : 8;  // byte 0's bits
                const int rest = ms_bits - p - cap0;
                if (rest < 0) break;
                const int nv = min(128, 1 + (rest >> 3));  // bytes whole in the staged bits
                const int nb = min(4, max(0, nv - 4 * lane));
                uint32_t word = 0;
                if (nb > 0)
                    word = lane == 0 ? (bits8(s_ms, p) & (ms_ff ? 0x7Fu : 0xFFu)) |
                                           (bits32(s_ms, p + cap0) << 8)
                                     : bits32(s_ms, p + cap0 + 8 * (4 * lane - 1));
                // flags on the 0xFF bytes of the word (the lowest one exact)
                const uint32_t inv = ~word;
                const uint32_t z = (inv - 0x01010101u) & ~inv & 0x80808080u &
                                   (nb == 4 ? 0xFFFFFFFFu : (1u << (8 * nb)) - 1);
                const unsigned fb = __ballot_sync(FULL, z != 0);
                int ne = nv;
                if (fb) {
                    const int l = __ffs(fb) - 1;
                    ne = 4 * l + __shfl_sync(FULL, (__ffs(z) - 1) >> 3, l) + 1;
                    if (stats && lane == 0) ++s_st[ST_MS_STUFFED];
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int j = 4 * lane + k;
                    if (j < ne && ms_n + j < cap) seg[ms_n + j] = (uint8_t)(word >> (8 * k));
                }
                ms_n += ne;
                p += cap0 + 8 * (ne - 1);
                ms_ff = fb != 0;
            }
            ms_used = ms_bits - p;
            ms_tmp = bits8(s_ms, p) & ((1u << ms_used) - 1);
        }
        // ---- VLC bytes: 32 at a time, up to and with the first 7-bit byte
        {
            int p = 0;
            while (vl_bits - p >= 7) {  // a byte of 7 bits or more is whole
                const int start = p + 8 * lane;
                const bool ok8 = start + 8 <= vl_bits, ok7 = start + 7 <= vl_bits;
                const uint32_t b = ok7 ? bits8(s_vl, start) : 0u;
                const uint32_t prev = __shfl_up_sync(FULL, b, 1);
                const bool gt = lane == 0 ? vl_gt : prev > 0x8F;
                const unsigned sb = __ballot_sync(FULL, ok7 && gt && (b & 0x7F) == 0x7F);
                const unsigned v8 = __ballot_sync(FULL, ok8);
                int ne;
                if (sb) {
                    ne = __ffs(sb);
                    const int at = vl_n + lane;
                    if (lane < ne && at < aux_cap)
                        aux[aux_cap - 1 - at] = lane == ne - 1 ? 0x7F : (uint8_t)b;
                    p += 8 * (ne - 1) + 7;
                    vl_gt = false;
                    if (stats && lane == 0) ++s_st[ST_VLC_STUFFED];
                } else {
                    ne = __popc(v8);
                    if (!ne) break;
                    const int at = vl_n + lane;
                    if (lane < ne && at < aux_cap) aux[aux_cap - 1 - at] = (uint8_t)b;
                    p += 8 * ne;
                    vl_gt = __shfl_sync(FULL, b, ne - 1) > 0x8F;
                }
                vl_n += ne;
            }
            vl_used = vl_bits - p;
            vl_tmp = bits8(s_vl, p) & ((1u << vl_used) - 1);
        }
        __syncwarp();  // staging is read before the next chunk clears it
        if (nc == 0) {
            cl_carry = 0;
            al_carry = 0;
        }
        c = nc;
        qy = nqy;
    }
    if (energy) {
        // every partial sum of the reference's order is an integer at most
        // the total: below 2^53 they are all exact, and so is the total
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) sq += __shfl_xor_sync(FULL, sq, d);
        const bool exact = !__ballot_sync(FULL, big != 0) && sq < (1ull << 53);
        const double d = exact ? (double)sq : energy_rows(blk, h, w, bw, lane);
        if (lane == 0) energy[i] = d;
    }
    if (stats && lane == 0) {
        stats[3 * i] = s_st[ST_MEL_EVENTS];
        stats[3 * i + 1] = s_st[ST_MS_STUFFED];
        stats[3 * i + 2] = s_st[ST_VLC_STUFFED];
    }
    if (!any) {  // an empty or all-zero codeblock has an empty segment
        if (lane == 0) lengths[i] = 0;
        zero_tail(seg, 0, cap, lane);
        return;
    }

    // ---- MEL/VLC termination and fuse (ht.py _terminate_mel_vlc), lane 0
    int extra = 0;  // bytes between MEL and VLC: (count, MEL side, VLC side)
    int mel_n = 0;
    if (lane == 0) {
        Mel mel = *(Mel*)s_st;
        if (mel.run > 0) mel_put(mel, aux, aux_cap, 1, 1);
        mel_n = mel.n;
        const int mel_tmp = (mel.tmp << mel.rem) & 0xFF;
        const int mel_mask = (0xFF << mel.rem) & 0xFF;
        const int vlc_mask = vl_used ? 0xFF >> (8 - vl_used) : 0;
        if (mel_mask | vlc_mask) {
            const int fuse = mel_tmp | (int)vl_tmp;
            if ((((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ (int)vl_tmp) & vlc_mask)) == 0 &&
                fuse != 0xFF && vl_n > 1)
                extra = 1 | (fuse << 8);
            else
                extra = 2 | (mel_tmp << 8) | ((int)vl_tmp << 16);
        }
    }
    mel_n = __shfl_sync(FULL, mel_n, 0);
    extra = __shfl_sync(FULL, extra, 0);

    // ---- MagSgn termination (ht.py MsEnc.terminate)
    if (ms_used) {
        const int t = (ms_ff ? 7 : 8) - ms_used;
        ms_tmp |= (0xFFu & ((1u << t) - 1)) << ms_used;
        if (ms_tmp != 0xFF) {
            if (lane == 0 && ms_n < cap) seg[ms_n] = (uint8_t)ms_tmp;
            ++ms_n;
        }
    } else if (ms_ff) {
        --ms_n;  // a final 0xFF with nothing after it is dropped
    }

    // ---- assembly: MagSgn | MEL | fused or partial bytes | VLC
    const int ne = extra & 3;
    const int vpos = ms_n + mel_n + ne;
    const int pos = vpos + vl_n;
    if (pos > cap || mel_n + vl_n > aux_cap || pos < 2) {
        if (lane == 0) lengths[i] = -1;
        return;
    }
    __syncwarp();  // MEL and VLC bytes of other lanes are in the scratch row
    for (int t = lane; t < mel_n; t += 32) seg[ms_n + t] = aux[t];
    if (lane < ne) seg[ms_n + mel_n + lane] = (uint8_t)(extra >> (8 + 8 * lane));
    for (int t = lane; t < vl_n; t += 32)
        seg[vpos + t] = t == vl_n - 1 ? 0xFF : aux[aux_cap - vl_n + t];
    __syncwarp();
    if (lane == 0) {
        const int scup = pos - ms_n;
        seg[pos - 1] = (uint8_t)((scup >> 4) & 0xFF);
        seg[pos - 2] = (uint8_t)((seg[pos - 2] & 0xF0) | (scup & 0xF));
        lengths[i] = pos;
    }
    zero_tail(seg, pos, cap, lane);
}

static int block_bytes(int bw, int warps) { return HEAD_BYTES + warps * warp_bytes_of(bw); }

// blocks of ``warps`` codeblocks of width bw resident on one SM, and the
// shared bytes a block takes
extern "C" int ht_enc_occupancy(int bw, int warps, int* blocks, int* smem) {
    *smem = block_bytes(bw, warps);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ht_enc_kernel, warps * 32,
                                                              *smem);
}

// coeffs [n, bh, bw] int32; heights/widths [n] int32; tab: ht_tables();
// out [n, cap] uint8 (every byte written, zeros past the segment); scratch [n, aux_cap] uint8;
// lengths [n] int32 (-1: the codeblock overflowed its capacity); energy
// [n] float64 or null (no energy); warps: codeblocks a CUDA block (1 to
// MAX_WARPS); stats [n, 3] int32 or null: each codeblock's MEL events and
// stuffed MagSgn and VLC bytes.
extern "C" int ht_cleanup_enc(const void* coeffs, const void* heights, const void* widths,
                              const void* tab, void* out, void* scratch, void* lengths,
                              void* energy, int n, int bh, int bw, int cap, int aux_cap,
                              int warps, void* stats, void* stream) {
    if (n <= 0) return 0;
    if (bw > 2 * NQW_MAX || warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
    ht_enc_kernel<<<(n + warps - 1) / warps, warps * 32, block_bytes(bw, warps),
                    (cudaStream_t)stream>>>(
        (const int32_t*)coeffs, (const int32_t*)heights, (const int32_t*)widths,
        (const int32_t*)tab, (uint8_t*)out, (uint8_t*)scratch, (int32_t*)lengths,
        (double*)energy, (int32_t*)stats, n, bh, bw, cap, aux_cap);
    return (int)cudaGetLastError();
}
