// K-f ht_cleanup_dec: decode a batch of HTJ2K cleanup segments (T.814
// clause 7.3) into signed coefficients, with one flag per codeblock whose
// decode stopped early on a corrupt segment.
//
// Replaces: grok_tpu/t1/ht_jax_dec.py _decode_device (:233), the XLA
// program that unstuffs the three streams into dense words (_unstuff_* :60-
// 138, over host-presliced suffixes, preslice_suffix :141), scans the
// VLC/MEL parse per quad pair (_mel_event :170) and extracts MagSgn row by
// row. It computes what the port's scalar decoder grok_tpu_torch/t1/ht.py
// decode_cleanup (:470) gives, with its readers MelDec/VlcDec/MsDec
// (:304-430), value for
// value: each codeblock reads its own segment -- MagSgn forward from byte
// 0, MEL forward from Lcup - Scup, VLC backward from the high nibble of
// byte Lcup - 2 -- so none of the TPU's preslicing, capacity floors or
// bucketing remain.
//
// Bound on an H100 (3.35 TB/s): bytes. The segments are read once and every
// int32 sample of the output rows written once (the kernel writes the
// zeros outside each codeblock's decoded part too: the wrapper allocates
// the rows uninitialised); the 6,321 64x64 rows of a 3840x2160x3 image
// write 103.6 MB, about 0.037 ms with the segments.
//
// Design: a codeblock a group of 16 lanes (two a warp), a quad row 16
// quads (a chunk) at a time; the two groups of a warp run the same steps,
// each on its own codeblock, a group that has finished (or stopped) idle
// until the other has.
//  - Streams: each is unstuffed by the group into dense bits in a ring of
//    32-bit words in shared memory, 64 bytes a step (4 a lane, in reading
//    order): a byte takes 7 bits where the rule of its stream says so
//    (MagSgn and MEL: after a 0xFF; VLC, read backward: where the byte read
//    before it is above 0x8F and its low 7 bits are all ones), so three
//    ballots of the lanes' counts give every lane its bit offset, and the
//    lanes OR their bits in (32-bit shared atomics). MEL's bits are kept in
//    reading order (MSB first in each byte). Past a stream's end the rings
//    hold what the scalar readers' pads give: ones for MagSgn and MEL (0xFF
//    bytes), zeros for VLC. The VLC and MEL rings are filled ahead of a
//    chunk's parse as far as a chunk can read (16 and 10 bits a quad), the
//    MagSgn ring as far as the chunk's fields reach, so shared memory is
//    sized by the width of the rows and not by the segment.
//  - Contexts: each lane reads the row above at its quad from a per-
//    codeblock line of 16-bit entries (e of the quad's bottom-left and
//    bottom-right samples, 0 where not significant), with the neighbours
//    by shuffles; the significance part of each quad's context goes to a
//    per-codeblock row record in shared memory.
//  - The parse, on each group's first lane (lanes 0 and 16 issue together
//    where their codeblocks take the same branches): for each quad of the
//    chunk its context (the record and the quad on the left), a MEL event
//    where it is 0, the CxtVLC codeword from a 7-bit peek into the decode
//    table (in shared memory, 0 where the codeword is invalid, with the
//    context it gives the quad on its right), and for each pair its
//    u-codes (the three line-0 cases; elsewhere both prefixes from one
//    lookup in shared memory), all from a 32-bit window of a 64-bit
//    register cache of the VLC ring (MEL has a cache of its own). Each
//    quad's rho, u_off, e_k, e_1 and u go back into the record.
//  - MagSgn, a quad a lane: kappa from the row above (below line 0, where
//    rho has two bits or more), the field widths m, one scan of the quads'
//    bit counts for their offsets in the MagSgn ring, a ballot for the
//    first field over 32 bits; each field read from two ring words, its
//    e_1 bit at position m, signed and wrapped to int32. The group writes
//    its two rows of 32 samples, then updates the line.
// On a corrupt segment the decode stops where grok_tpu's default decoder
// (native/ht_coder.cpp decode_block) stops, keeping what it wrote, and
// flags the codeblock: at an invalid CxtVLC codeword (before any MagSgn of
// its quad pair), at a MagSgn field over 32 bits (the quad's earlier
// samples kept), or at once when the header is invalid (Scup outside
// [2, Lcup]). A codeblock taller or wider than the output rows is flagged
// and left zero. 80 registers a lane, no spills: two 12-warp blocks (48
// codeblocks) an SM, the whole 4K batch in one wave. PERF.md §6 has the
// measurements behind these choices (1, 2, 4 and 8 codeblocks a warp, and
// 2 at 64 registers).

#include <cuda_runtime.h>
#include <stdint.h>

// int32 table layout shared with t1/ht_cuda.py ht_tables()
#define T_DEC 4096       // [2][8][128] rho | u_off<<4 | e_k<<5 | e_1<<9 | len<<13; -1 invalid
#define T_MEL_EXP 6144   // [13]
#define NQW_MAX 512      // quads across a 1024-wide codeblock
#define MS_BITS 32       // the widest MagSgn field decode_block reads
#define WARPS 12         // warps a CUDA block: at the two blocks an SM of
                         // __launch_bounds__, 80 registers a lane (16 warps: 64)
#define FULL 0xFFFFFFFFu
#define G 16             // lanes a codeblock (a group): a chunk is G quads
#define GROUPS (32 / G)  // codeblocks a warp
// shared memory: the block's tables, then each codeblock's rings, record and line
#define HEAD_BYTES 8720  // DEC [2][8][128] u32, MEL_EXP [13] u8 at 8192, U [256] u16 at 8208
#define MS_WORDS (8 * G) // the rings, in words (powers of two): MagSgn holds a
#define VLC_WORDS (4 * G)  // chunk's fields (up to 128 G bits), VLC and MEL a
#define MEL_WORDS (4 * G)  // chunk's reads ahead (up to 16 G + 64 and 10 G + 48)
#define REC_WORDS G      // the row record: a word a quad of the chunk

// shared bytes of a codeblock: the three rings, the row record, the row
// above (a u16 a quad)
__host__ __device__ __forceinline__ int cblk_bytes_of(int bw) {
    const int nqw = (((bw + 1) >> 1) + 7) & ~7;
    return 4 * (MS_WORDS + VLC_WORDS + MEL_WORDS + REC_WORDS) + 2 * nqw;
}

enum Stream { MAGSGN, MEL, VLC };

// the group's G bits of a ballot
__device__ __forceinline__ unsigned group_bits(unsigned ballot, int hf) {
    return (ballot >> (G * hf)) & (FULL >> (32 - G));
}

// the larger of v over the warp's two groups
__device__ __forceinline__ int groups_max(int v) {
    return max(v, __shfl_xor_sync(FULL, v, G));
}

// One step of a stream's unstuffing by a codeblock's group, where en (the
// group does nothing elsewise): the next 4 G bytes, 4 a lane in reading
// order, into the ring r of W words. fill is the ring's bit count, byte the
// next byte to read (VLC reads down to lo, the others up to hi), carry the
// byte read before it. Invariant: the bits at or above fill in word
// fill >> 5 are zero (a step clears the G words after it before its bits
// go in).
template <int S, int W>
__device__ __forceinline__ void ring_step(uint32_t* r, int& fill, int& byte, uint32_t& carry,
                                          const uint8_t* seg, int lo, int hi, int hl, int hf,
                                          bool en) {
    uint32_t b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int p = S == VLC ? byte - 4 * hl - k : byte + 4 * hl + k;
        if (S == VLC) b[k] = en && p >= lo ? __ldg(seg + p) : 0u;
        else b[k] = en && p < hi ? __ldg(seg + p) : 0xFFu;
    }
    uint32_t prev = __shfl_up_sync(FULL, b[3], 1, G);
    if (hl == 0) prev = carry;
    uint32_t v = 0;
    int nb = 0, sevens = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t pk = k ? b[k - 1] : prev;
        const int seven = S == VLC ? pk > 0x8F && (b[k] & 0x7F) == 0x7F : pk == 0xFF;
        const int n = 8 - seven;
        uint32_t val = b[k] & ((1u << n) - 1);
        if (S == MEL) val = __brev(val) >> (32 - n);  // reading order: the byte's MSB first
        v |= val << nb;
        nb += n;
        sevens += seven;
    }
    // the 7-bit bytes of the lanes before: three ballots of the counts' bits
    const unsigned c0 = group_bits(__ballot_sync(FULL, sevens & 1), hf);
    const unsigned c1 = group_bits(__ballot_sync(FULL, sevens & 2), hf);
    const unsigned c2 = group_bits(__ballot_sync(FULL, sevens & 4), hf);
    const unsigned lt = (1u << hl) - 1;
    const int off = fill + 32 * hl - (__popc(c0 & lt) + 2 * __popc(c1 & lt) + 4 * __popc(c2 & lt));
    if (en) r[((fill >> 5) + 1 + hl) & (W - 1)] = 0u;
    __syncwarp();
    const int wo = off >> 5, sh = off & 31;
    if (en) {
        atomicOr(r + (wo & (W - 1)), v << sh);
        if (sh && sh + nb > 32) atomicOr(r + ((wo + 1) & (W - 1)), v >> (32 - sh));
    }
    __syncwarp();
    const uint32_t last = __shfl_sync(FULL, b[3], G - 1, G);
    if (en) {
        fill += 32 * G - (__popc(c0) + 2 * __popc(c1) + 4 * __popc(c2));
        carry = last;
        byte += S == VLC ? -4 * G : 4 * G;
    }
}

// the 32 bits at bit q of a ring of W words
template <int W>
__device__ __forceinline__ uint32_t ring32(const uint32_t* r, int q) {
    return __funnelshift_r(r[(q >> 5) & (W - 1)], r[((q >> 5) + 1) & (W - 1)], q & 31);
}

// zeros over p[0, n) by the nt threads t of a codeblock, 16-byte stores
// where aligned
__device__ __forceinline__ void zero_words(int32_t* p, int64_t n, int t, int nt) {
    if (n <= 0) return;
    int64_t head = (int64_t)(((16 - ((uintptr_t)p & 15)) & 15) >> 2);
    if (head > n) head = n;
    if (t < head) p[t] = 0;
    p += head;
    n -= head;
    const int64_t nv = n >> 2;
    uint4* q = (uint4*)p;
    for (int64_t k = t; k < nv; k += nt) q[k] = make_uint4(0u, 0u, 0u, 0u);
    if (t < (n & 3)) p[4 * nv + t] = 0;
}

// zeros over columns [x, bw) of rows y and y + 1 (those under bh)
__device__ __forceinline__ void zero_cols(int32_t* o, int y, int x, int bh, int bw, int t) {
    if (x >= bw) return;
    for (int r = y; r < min(y + 2, bh); ++r) zero_words(o + (int64_t)r * bw + x, bw - x, t, G);
}

static int block_bytes(int bw, int warps) { return HEAD_BYTES + GROUPS * warps * cblk_bytes_of(bw); }

__global__ void __launch_bounds__(WARPS * 32, 2)
ht_dec_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths,
              const int32_t* __restrict__ heights, const int32_t* __restrict__ widths,
              const int32_t* __restrict__ tab, int32_t* __restrict__ out,
              uint8_t* __restrict__ stopped, int n, int L, int bh, int bw) {
    extern __shared__ __align__(16) uint8_t s_dyn[];
    uint32_t* s_tab = (uint32_t*)s_dyn;
    uint8_t* s_mx = s_dyn + 8192;
    for (int t = threadIdx.x; t < 2048; t += blockDim.x) {
        const int v = __ldg(tab + T_DEC + t);
        // the packed entry, 0 for an invalid codeword (its length 0), and at
        // bit 16 the context it gives the quad on its right (line 0: t < 1024)
        const int r = v & 15;
        const int cl = t < 1024 ? (r >> 1) | (r & 1) : ((r & 4) >> 1) | ((r & 8) >> 2);
        s_tab[t] = v < 0 ? 0u : (uint32_t)v | ((uint32_t)cl << 16);
    }
    if (threadIdx.x < 13) s_mx[threadIdx.x] = (uint8_t)__ldg(tab + T_MEL_EXP + threadIdx.x);
    // U: a quad pair's two u prefixes (LSB first: 1 -> 1, 01 -> 2, 001 -> 3,
    // 000 -> 5) from its next 6 bits and its two u_off (a quad without reads
    // none): p0 | p1 << 3 | their bits << 6 | the suffixes' bits (1 after 3,
    // 5 after 5) << 9 and << 12
    uint16_t* s_ut = (uint16_t*)(s_dyn + 8208);
    for (int t = threadIdx.x; t < 256; t += blockDim.x) {
        int at = 0, p0 = 0, p1 = 0;
        if ((t >> 6) & 1) {
            p0 = (0x12131215u >> ((t & 7) << 2)) & 15;
            at += min(p0, 3);
        }
        if (t >> 7) {
            p1 = (0x12131215u >> ((((t & 63) >> at) & 7) << 2)) & 15;
            at += min(p1, 3);
        }
        s_ut[t] = (uint16_t)(p0 | (p1 << 3) | (at << 6) | (((0x501000 >> (p0 << 2)) & 15) << 9) |
                             (((0x501000 >> (p1 << 2)) & 15) << 12));
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, hl = lane & (G - 1), hf = lane / G;
    const int slot = (threadIdx.x >> 5) * GROUPS + hf;  // the codeblock's place in the block
    const int i = blockIdx.x * (blockDim.x >> 5) * GROUPS + slot;
    if (i - hf >= n) return;  // every group of the warp past the batch
    const bool mine = i < n;
    uint32_t* s_ms = (uint32_t*)(s_dyn + HEAD_BYTES + slot * cblk_bytes_of(bw));
    uint32_t* s_vl = s_ms + MS_WORDS;
    uint32_t* s_ml = s_vl + VLC_WORDS;
    uint32_t* s_rec = s_ml + MEL_WORDS;  // a quad of the chunk: its context, then its parse
    uint16_t* s_up = (uint16_t*)(s_rec + REC_WORDS);  // the row above: e(BL) | e(BR) << 8
    int32_t* o = out + (int64_t)(mine ? i : 0) * bh * bw;
    const int len = mine ? __ldg(lengths + i) : 0;
    const int h = mine ? __ldg(heights + i) : 0, w = mine ? __ldg(widths + i) : 0;
    const uint8_t* seg = data + (int64_t)(mine ? i : 0) * L;

    // ---- the header: an empty or invalid segment leaves the codeblock zero
    bool live = len >= 2 && len <= L && h > 0 && w > 0, bad = false;
    int scup = 0;
    if (live && (h > bh || w > bw)) {
        live = false;
        bad = true;
    } else if (live) {
        scup = (__ldg(seg + len - 1) << 4) | (__ldg(seg + len - 2) & 0xF);
        if (scup < 2 || scup > len) {
            live = false;
            bad = true;
        }
    }
    if (mine && !live) {
        zero_words(o, (int64_t)bh * bw, hl, G);
        if (hl == 0) stopped[i] = bad;
    }
    const int ms_len = live ? len - scup : 0;
    const int nqw = live ? (w + 1) >> 1 : 0, nqh = live ? (h + 1) >> 1 : 0;
    const int nch = (nqw + G - 1) / G;

    // ---- the rings (their states the same in each lane of a group)
    int ms_fill = 0, ms_byte = 0, ms_pos = 0;
    uint32_t ms_carry = 0;
    int ml_fill = 0, ml_byte = ms_len, ml_cons = 0;
    uint32_t ml_carry = 0;
    const int d = live ? __ldg(seg + len - 2) : 0;
    const int nb0 = 4 - (((d >> 4) & 7) == 7);  // VLC opens with 3 or 4 bits of the nibble
    int vl_fill = nb0, vl_byte = len - 3, vl_cons = 0;
    uint32_t vl_carry = (uint32_t)(d | 0xF);
    if (hl == 0) {
        s_ms[0] = 0u;
        s_ml[0] = 0u;
        s_vl[0] = (uint32_t)(d >> 4) & ((1u << nb0) - 1);
    }
    __syncwarp();
    // the parse state of each group's first lane: the VLC and MEL bit caches, the MEL decoder
    uint64_t vb = 0, mb = 0;
    int vn = 0, vld = 0, mn = 0, mld = 0, mk = 0, mz = 0;
    bool mone = false;

    bool done = !live;
    int sqy = 0, sc = 0;  // the row and chunk where a corrupt segment stopped the decode
    const int nqh_all = groups_max(nqh), nch_all = groups_max(nch);
    for (int qy = 0; qy < nqh_all; ++qy) {
        const bool line0 = qy == 0;
        const uint32_t* tbl = s_tab + (line0 ? 0 : 1024);
        uint32_t al_carry = 0;  // the row above at the quad left of the chunk
        int cl = 0;             // the group's first lane: the context from the quad on the left
        for (int c = 0; c < nch_all; ++c) {
            const bool act = !done && qy < nqh && c < nch;
            if (!__any_sync(FULL, act)) break;
            const int qi = c * G + hl;
            const bool valid = act && qi < nqw;
            const int nqc = act ? min(G, nqw - c * G) : 0;
            // ---- contexts from the row above
            const uint32_t a = (!line0 && valid) ? s_up[qi] : 0u;
            uint32_t al = __shfl_up_sync(FULL, a, 1, G);
            uint32_t ar = __shfl_down_sync(FULL, a, 1, G);
            if (hl == 0) al = al_carry;
            if (hl == G - 1) ar = (!line0 && act && qi + 1 < nqw) ? s_up[qi + 1] : 0u;
            al_carry = __shfl_sync(FULL, a, G - 1, G);
            const int pe0 = max((int)(al >> 8), (int)(a & 0xFF));
            const int pe1 = max((int)(a >> 8), (int)(ar & 0xFF));
            if (act) s_rec[hl] = (pe0 != 0) | ((pe1 != 0) << 2);
            // ---- VLC and MEL bits as far as the chunk's parse can read
            for (;;) {
                const bool need = act && vl_fill < vl_cons + 16 * nqc + 64;
                if (!__any_sync(FULL, need)) break;
                ring_step<VLC, VLC_WORDS>(s_vl, vl_fill, vl_byte, vl_carry, seg, ms_len, len, hl,
                                          hf, need);
            }
            for (;;) {
                const bool need = act && ml_fill < ml_cons + 10 * nqc + 48;
                if (!__any_sync(FULL, need)) break;
                ring_step<MEL, MEL_WORDS>(s_ml, ml_fill, ml_byte, ml_carry, seg, ms_len, len, hl,
                                          hf, need);
            }
            __syncwarp();
            // ---- the parse of the chunk's quads, on each group's first lane
            int stop = nqc;  // the quads parsed: all but from a pair with an invalid codeword
            if (hl == 0 && act) {
                // a pair's bits: a 32-bit window of the cache (it holds 32 or
                // more at a pair's start, a pair reads at most 30) and a position
                uint32_t x = 0;
                int pos = 0;
                auto take = [&](int nb) -> int {
                    const int v = (int)((x >> pos) & ((1u << nb) - 1));
                    pos += nb;
                    return v;
                };
                // u prefixes, LSB first: 1 -> 1, 01 -> 2, 001 -> 3, 000 -> 5
                auto prefix = [&]() -> int {
                    const int p = (0x12131215u >> (((x >> pos) & 7) << 2)) & 15;
                    pos += min(p, 3);
                    return p;
                };
                // the suffix after prefix p: 1 bit after 3, 5 after 5, none else
                auto suffix = [&](int p) -> int { return p + take((0x501000 >> (p << 2)) & 15); };
                auto mel = [&]() -> int {
                    if (!mz && !mone) {
                        if (mn < 6) {
                            mb |= (uint64_t)ring32<MEL_WORDS>(s_ml, mld) << mn;
                            mld += 32;
                            mn += 32;
                        }
                        const int e = s_mx[mk];
                        if (mb & 1) {
                            mz = 1 << e;
                            mk = min(12, mk + 1);
                            mb >>= 1;
                            mn -= 1;
                        } else {  // a 0, then e bits of run, MSB first
                            mz = e ? (int)(__brev((uint32_t)(mb >> 1)) >> (32 - e)) : 0;
                            mk = max(0, mk - 1);
                            mone = true;
                            mb >>= 1 + e;
                            mn -= 1 + e;
                        }
                    }
                    if (mz) {
                        --mz;
                        return 0;
                    }
                    mone = false;
                    return 1;
                };
                auto quad = [&](int q, uint32_t& ent) -> bool {
                    const int cq = line0 ? cl : (int)s_rec[q] + cl;
                    if (cq || mel()) {
                        const uint32_t e = tbl[(cq << 7) | ((x >> pos) & 127)];
                        const int l = (int)(e >> 13) & 7;
                        if (!l) return false;  // invalid codeword
                        pos += l;
                        ent = e;
                    }
                    cl = (int)(ent >> 16);
                    return true;
                };
                for (int q = 0; q < nqc; q += 2) {
                    if (vn < 32) {
                        vb |= (uint64_t)ring32<VLC_WORDS>(s_vl, vld) << vn;
                        vld += 32;
                        vn += 32;
                    }
                    x = (uint32_t)vb;
                    pos = 0;
                    uint32_t e0 = 0, e1 = 0;
                    if (!quad(q, e0) || (q + 1 < nqc && !quad(q + 1, e1))) {
                        stop = q;
                        break;
                    }
                    // the pair's u (ht.py _dec_u_pair)
                    const int uo0 = (e0 >> 4) & 1, uo1 = (e1 >> 4) & 1;
                    int u0 = 0, u1 = 0;
                    if (line0 && uo0 && uo1) {
                        if (mel()) {
                            const int p0 = prefix();
                            const int p1 = prefix();
                            u0 = suffix(p0) + 2;
                            u1 = suffix(p1) + 2;
                        } else {
                            const int p0 = prefix();
                            if (p0 > 2) {
                                u1 = 1 + take(1);
                                u0 = suffix(p0);
                            } else {
                                const int p1 = prefix();
                                u0 = suffix(p0);
                                u1 = suffix(p1);
                            }
                        }
                    } else {  // both prefixes from one lookup
                        const uint32_t ue = s_ut[((x >> pos) & 63) | (uo0 << 6) | (uo1 << 7)];
                        pos += (ue >> 6) & 7;
                        u0 = (int)(ue & 7) + take((ue >> 9) & 7);
                        u1 = (int)((ue >> 3) & 7) + take(ue >> 12);
                    }
                    vb >>= pos;
                    vn -= pos;
                    s_rec[q] = (e0 & 0x1FFFu) | ((uint32_t)u0 << 16);
                    if (q + 1 < nqc) s_rec[q + 1] = (e1 & 0x1FFFu) | ((uint32_t)u1 << 16);
                }
            }
            __syncwarp();
            stop = __shfl_sync(FULL, stop, 0, G);
            vl_cons = __shfl_sync(FULL, vld - vn, 0, G);
            ml_cons = __shfl_sync(FULL, mld - mn, 0, G);

            // ---- MagSgn: the fields of the quad of each lane
            const uint32_t rec = act && hl < stop ? s_rec[hl] : 0u;
            const int rho = rec & 15, ek = (rec >> 5) & 15, e1 = (rec >> 9) & 15;
            const int kappa = (!line0 && (rho & (rho - 1))) ? max(1, max(pe0, pe1) - 1) : 1;
            const int uq = kappa + (int)(rec >> 16);
            int kb = 4;  // the quad's first field over MS_BITS
            for (int k = 3; k >= 0; --k)
                if (((rho >> k) & 1) && uq - ((ek >> k) & 1) > MS_BITS) kb = k;
            const unsigned wide = group_bits(__ballot_sync(FULL, kb < 4), hf);
            const int lb = wide ? __ffs(wide) - 1 : G;  // decode stops in this lane's quad
            const int keep = hl < lb ? rho : hl == lb ? rho & ((1 << kb) - 1) : 0;
            int mlen = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if ((keep >> k) & 1) mlen += uq - ((ek >> k) & 1);
            int incl = mlen;
#pragma unroll
            for (int s = 1; s < G; s <<= 1) {
                const int t = __shfl_up_sync(FULL, incl, s, G);
                if (hl >= s) incl += t;
            }
            const int tot = __shfl_sync(FULL, incl, G - 1, G);
            for (;;) {
                const bool need = act && ms_fill < ms_pos + tot;
                if (!__any_sync(FULL, need)) break;
                ring_step<MAGSGN, MS_WORDS>(s_ms, ms_fill, ms_byte, ms_carry, seg, 0, ms_len, hl,
                                            hf, need);
            }
            int at = ms_pos + incl - mlen;
            int32_t v[4] = {0, 0, 0, 0};
            int ebl = 0, ebr = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (!((keep >> k) & 1)) continue;
                const int m = uq - ((ek >> k) & 1);
                const uint64_t win = (uint64_t)s_ms[(at >> 5) & (MS_WORDS - 1)] |
                                     ((uint64_t)s_ms[((at >> 5) + 1) & (MS_WORDS - 1)] << 32);
                const uint64_t f = (win >> (at & 31)) & ((1ull << m) - 1);
                const uint64_t vv = f | ((uint64_t)((e1 >> k) & 1) << m);
                const int64_t mu = (int64_t)(vv >> 1) + 1;
                v[k] = (int32_t)(uint32_t)(uint64_t)((vv & 1) ? -mu : mu);  // wraps to int32
                const int en = 64 - __clzll((long long)(vv | 1));
                if (k == 1) ebl = en;
                else if (k == 3) ebr = en;
                at += m;
            }
            ms_pos += tot;
            // ---- the quad's samples, zero outside h x w (2qy < h always)
            const int y0 = 2 * qy, x0 = 2 * qi;
            if (act && x0 < bw) {
                const bool in0 = x0 < w, in1 = x0 + 1 < w, iny = y0 + 1 < h;
                const int32_t t0 = in0 ? v[0] : 0, t2 = in1 ? v[2] : 0;
                const int32_t t1 = in0 && iny ? v[1] : 0, t3 = in1 && iny ? v[3] : 0;
                int32_t* p = o + (int64_t)y0 * bw + x0;
                if (!(bw & 1)) {  // 8-byte aligned pairs
                    *(int2*)p = make_int2(t0, t2);
                    if (y0 + 1 < bh) *(int2*)(p + bw) = make_int2(t1, t3);
                } else {
                    p[0] = t0;
                    if (x0 + 1 < bw) p[1] = t2;
                    if (y0 + 1 < bh) {
                        p[bw] = t1;
                        if (x0 + 1 < bw) p[bw + 1] = t3;
                    }
                }
            }
            if (valid) s_up[qi] = (uint16_t)(ebl | (ebr << 8));
            if (act && (stop < nqc || wide)) {
                done = bad = true;
                sqy = qy;
                sc = c;
            }
        }
        if (!done && qy < nqh) zero_cols(o, 2 * qy, nch * 2 * G, bh, bw, hl);
    }
    if (!live) return;
    // ---- the zeros after the last quad written
    int64_t from = (int64_t)2 * nqh * bw;
    if (bad) {
        zero_cols(o, 2 * sqy, (sc + 1) * 2 * G, bh, bw, hl);
        from = (int64_t)(2 * sqy + 2) * bw;
    }
    const int64_t area = (int64_t)bh * bw;
    if (from < area) zero_words(o + from, area - from, hl, G);
    if (hl == 0) stopped[i] = bad;
}

static cudaError_t set_smem(int bytes) {
    return bytes > 48 * 1024 ? cudaFuncSetAttribute(
                                   ht_dec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                             : cudaSuccess;
}

// blocks of WARPS warps (GROUPS codeblocks each) of width bw resident on
// one SM, and the shared bytes a block takes
extern "C" int ht_dec_occupancy(int bw, int* blocks, int* smem) {
    *smem = block_bytes(bw, WARPS);
    const cudaError_t rc = set_smem(*smem);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ht_dec_kernel, WARPS * 32,
                                                              *smem);
}

// data [n, L] uint8; lengths/heights/widths [n] int32; tab: ht_tables();
// out [n, bh, bw] int32 (every sample written); stopped [n] uint8. Blocks
// of WARPS warps, GROUPS codeblocks each.
extern "C" int ht_cleanup_dec(const void* data, const void* lengths, const void* heights,
                              const void* widths, const void* tab, void* out, void* stopped,
                              int n, int L, int bh, int bw, void* stream) {
    if (n <= 0) return 0;
    if (bw > 2 * NQW_MAX || bw < 0 || bh < 0) return (int)cudaErrorInvalidValue;
    const int smem = block_bytes(bw, WARPS);
    const cudaError_t rc = set_smem(smem);
    if (rc != cudaSuccess) return (int)rc;
    const int per_block = GROUPS * WARPS;
    ht_dec_kernel<<<(n + per_block - 1) / per_block, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)lengths, (const int32_t*)heights,
        (const int32_t*)widths, (const int32_t*)tab, (int32_t*)out, (uint8_t*)stopped, n, L,
        bh, bw);
    return (int)cudaGetLastError();
}
