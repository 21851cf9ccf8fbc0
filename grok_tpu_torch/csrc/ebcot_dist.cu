// K-p ebcot_pass_dist: the distortion decrease of every coding pass of a
// batch of Part-1 codeblocks, in float64, from the symbol records of the
// scan (K-c) and the coefficients. PCRD weighs each pass's decrease against
// its rate.
//
// Replaces: the distortion half of K5-enc, grok_tpu/t1/ebcot_jax.py
// _build_encoder (:504; _dd_sig_f32 / _dd_ref_f32 :472-488). Its parity
// target is grok_tpu's default path, the native host coder
// (native/t1_coder.cpp enc_spp :479, enc_mrp :541, enc_cup :618), which
// sums float64 decreases one sample at a time in scan order; K5-enc sums in
// float32 and is not followed.
//
// Bound on an H100 (3.35 TB/s): bytes. It must read the sign slots of SPP
// and CUP and every MRP slot of each coded pass (1 byte a slot) and the
// coefficients (4 bytes a sample), and write 8 bytes a pass; about 0.11 ms
// for the 4K batch (360 MB). The SPP and CUP sign slots share their
// sectors with the other slots, so whole rows come from memory: about
// 5.75 bytes a position and plane, some 0.6 GB for the 4K batch.
//
// Exact sums. A sample that becomes significant at plane p has
// 2^p <= m < 2^(p+1), so its SPP/CUP decrease 3*2^p*m - 2.25*4^p lies in
// [0.75*4^p, 3.75*4^p]; a refinement's a1^2 - a2^2 lies within +-4^p. Four
// times any term is an integer (12*2^p*m - 9*4^p; 4*a1^2 - (2*a2)^2), under
// 4^(p+2) in magnitude. So while (positions) * 4^(p+2) <= 2^53, every term
// and every partial sum, in any order, is an exact double, and the
// reference's sequential float64 sum equals the int64 sum of the quadrupled
// terms times 0.25, bit for bit. For a 64x64 codeblock that holds for
// p <= 18, for 16x16 for p <= 20. The quadrupled sum needs no product a
// sample: with r = m mod 2^p and b = bit p of m, a refinement's term is
// 2^(p+2)*r - 4^p (b = 1) or 3*4^p - 2^(p+2)*r (b = 0), so a pass adds up
// sum(m) and a count (SPP/CUP), or the signed sum of r and two counts
// (MRP), and forms the total once.
//
// Design: one block a codeblock, over all of its passes. The block reads
// the codeblock's magnitudes once, coalesced, into shared memory in
// (stripe, column, row) order -- the native coder's scan order. For each
// pass the threads read the record row in 16-byte loads, a chunk a thread at
// a time (the row's first and last chunk may take 8; 32 registers, eight
// blocks an SM), pick the valid sign (or MRP) slots of their chunk from a
// 16-bit mask, and add up their positions' magnitudes; a warp
// reduces each pass's int64 total by shuffles, and the block adds the warps'
// totals once at the end. Above the bound a pass keeps the ordered chain:
// the threads write every position's decrease (0 where none) to shared
// memory, and one warp adds them in position order -- a ballot of the
// nonzero ones, each broadcast by a shuffle into one __dadd_rn chain, every
// product and sum an IEEE-rounded double intrinsic (the source is built with
// -fmad=false). The block writes its row of dist whole, zeros past its
// passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_THREADS 256
// CUP sign slots: slot mod 11 in {4, 6, 8, 10}, bit s for slot s, three periods
#define CUP_SIGN (0x550ull | (0x550ull << 11) | (0x550ull << 22))

// bit k set where byte k of the 16 is a valid record (0x80)
__device__ __forceinline__ unsigned valid4(unsigned v) {
    return (((v & 0x80808080u) >> 7) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned valid16(uint4 v) {
    return valid4(v.x) | valid4(v.y) << 4 | valid4(v.z) << 8 | valid4(v.w) << 12;
}

// the position (stripe, column, row order) whose sign (or MRP) slot is slot
__device__ __forceinline__ int slot_pos(int kind, int slot) {
    if (kind == 0) return slot >> 1;
    if (kind == 1) return slot;
    const int g = slot / 11;
    return 4 * g + ((slot - 11 * g - 4) >> 1);
}

// shared-memory index of a position's magnitude (a word of padding every 16)
__device__ __forceinline__ int mag_at(int q) { return q + (q >> 4); }

// quadrupled sums are exact doubles while npos * 4^(p+2) <= 2^53
__host__ __device__ __forceinline__ bool exact_plane(int p, int npos) {
    return 2 * p <= 49 && (long long)npos <= (1ll << (49 - 2 * p));
}

__host__ __device__ __forceinline__ int mag_words(int npos) {
    return (npos + (npos >> 4) + 2) & ~1;  // even: what follows is 8-byte aligned
}

__global__ void __launch_bounds__(MAX_THREADS)
ebcot_dist_kernel(const uint8_t* __restrict__ sym, const int32_t* __restrict__ coeffs,
                  const int32_t* __restrict__ numbps, double* __restrict__ dist, int pmaxc,
                  int s_pad, int h, int w, int max_passes) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthreads = blockDim.x, nwarps = nthreads >> 5;
    const int i = blockIdx.x;
    const int npos = ((h + 3) >> 2) * w * 4;  // positions (stripe, column, row)
    uint32_t* mag = smem;
    long long* red = (long long*)(smem + mag_words(npos));  // [nwarps][max_passes]
    double* dres = (double*)(red + nwarps * max_passes);    // ordered sums [max_passes]
    double* dterm = dres + max_passes;                      // ordered terms [npos]
    const int nb = min(numbps[i], (max_passes + 2) / 3);  // at most pmax, as promised
    const int npasses = nb > 0 ? 3 * nb - 2 : 0;

    const int32_t* blk = coeffs + (int64_t)i * h * w;
    for (int q = tid; q < npos && npasses > 0; q += nthreads) {
        const int s = q / (4 * w), rem = q - s * 4 * w;
        const int x = rem >> 2, y = 4 * s + (rem & 3);
        const int32_t v = y < h ? __ldg(blk + y * w + x) : 0;
        mag[mag_at(q)] = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
    }
    __syncthreads();

    for (int j = 0; j < npasses; ++j) {
        // pass 0 is the cleanup of the top plane; then SPP, MRP, CUP per plane
        const int rel = j == 0 ? 0 : (j - 1) / 3 + 1;
        const int kind = j == 0 ? 2 : (j - 1) % 3;
        const int p = nb - 1 - rel;
        const uint8_t* row = sym + (((int64_t)i * pmaxc + (pmaxc - 1 - p)) * 3 + kind) * s_pad;
        const int end = kind == 0 ? 2 * npos : kind == 1 ? npos : 11 * (npos >> 2);
        const int head = (int)((uintptr_t)row & 15);  // 0 or 8: chunks are 16-byte aligned
        const int nch = (end + head + 15) >> 4;
        const bool exact = exact_plane(p, npos);
        long long S = 0;  // sum of m (SPP/CUP); of +-r (MRP)
        int C0 = 0, C1 = 0;
        for (int c = tid; c < nch; c += nthreads) {
            const int b = 16 * c - head;
            uint4 v;
            if (b + 16 <= s_pad) {
                v = __ldg((const uint4*)(row + b));
            } else {  // the row's last 8 bytes
                const uint2 t = __ldg((const uint2*)(row + b));
                v = make_uint4(t.x, t.y, 0, 0);
            }
            unsigned slots = kind == 0 ? 0xAAAAu : kind == 1 ? 0xFFFFu
                           : (unsigned)(CUP_SIGN >> (((b % 11) + 11) % 11)) & 0xFFFFu;
            if (b < 0) slots &= 0xFFFFu << -b;
            if (end - b < 16) slots &= (1u << (end - b)) - 1;
            const unsigned set = valid16(v) & slots;
            if (exact) {
                for (unsigned s = set; s; s &= s - 1) {
                    const uint32_t m = mag[mag_at(slot_pos(kind, b + __ffs(s) - 1))];
                    if (kind == 1) {
                        const int r = (int)(m & ((1u << p) - 1));
                        const bool up = (m >> p) & 1;
                        S += up ? r : -r;
                        C1 += up;
                        C0 += !up;
                    } else {
                        S += m;
                        ++C0;
                    }
                }
            } else {  // every position of the pass gets its term, 0 where none
                for (unsigned s = slots; s; s &= s - 1) {
                    const int k = __ffs(s) - 1, q = slot_pos(kind, b + k);
                    double term = 0.0;
                    if (set >> k & 1) {
                        const int64_t m = mag[mag_at(q)];
                        if (kind == 1) {
                            const int64_t m1 = (int64_t(2) << p) - 1, m2 = (int64_t(1) << p) - 1;
                            const double a1 = __dsub_rn((double)(m & m1), ldexp(1.0, p));
                            const double a2 = __dsub_rn((double)(m & m2), ldexp(0.5, p));
                            term = __dsub_rn(__dmul_rn(a1, a1), __dmul_rn(a2, a2));
                        } else {
                            term = __dsub_rn(__dmul_rn(ldexp(3.0, p), (double)m),
                                             ldexp(2.25, 2 * p));
                        }
                    }
                    dterm[q] = term;
                }
            }
        }
        if (exact) {
            long long t = kind == 1
                ? S * (1ll << (p + 2)) + (long long)(3 * C0 - C1) * (1ll << 2 * p)
                : S * 12 * (1ll << p) - (long long)C0 * 9 * (1ll << 2 * p);
#pragma unroll
            for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
            if (lane == 0) red[warp * max_passes + j] = t;
        } else {
            __syncthreads();
            if (warp == 0) {  // the positions in order: the native coder's sum
                double acc = 0.0;
                for (int base = 0; base < npos; base += 32) {
                    const double t = base + lane < npos ? dterm[base + lane] : 0.0;
                    for (unsigned set = __ballot_sync(0xffffffffu, t != 0.0); set; set &= set - 1)
                        acc = __dadd_rn(acc, __shfl_sync(0xffffffffu, t, __ffs(set) - 1));
                }
                if (lane == 0) dres[j] = acc;
            }
            __syncthreads();
        }
    }
    __syncthreads();
    for (int j = tid; j < max_passes; j += nthreads) {
        double d = 0.0;
        if (j < npasses) {
            const int p = nb - 1 - (j == 0 ? 0 : (j - 1) / 3 + 1);
            if (exact_plane(p, npos)) {
                long long t = 0;
                for (int k = 0; k < nwarps; ++k) t += red[k * max_passes + j];
                d = __dmul_rn((double)t, 0.25);  // |t| < 2^53: both exact
            } else {
                d = dres[j];
            }
        }
        dist[(int64_t)i * max_passes + j] = d;
    }
}

// threads a block for codeblocks of h x w: a 16-byte chunk of the longest
// record row (CUP, 11 slots a column of a stripe) each, whole warps, at most
// MAX_THREADS
static int dist_threads(int h, int w) {
    const int chunks = (11 * ((h + 3) >> 2) * w + 8 + 15) >> 4;
    const int t = (chunks + 31) & ~31;
    return t < MAX_THREADS ? t : MAX_THREADS;
}

// dynamic shared memory: the magnitudes, the warps' pass totals and, where
// a plane below pmax is above the bound, the ordered terms and sums
static size_t dist_smem(int h, int w, int max_passes, int threads) {
    const int npos = ((h + 3) >> 2) * w * 4;
    const int pmax = (max_passes + 2) / 3;
    size_t bytes = (size_t)mag_words(npos) * 4 + (size_t)(threads / 32) * max_passes * 8;
    if (!exact_plane(pmax - 1, npos)) bytes += (size_t)(max_passes + npos) * 8;
    return bytes;
}

// 1 where a pass at plane p of a codeblock of npos positions sums as the
// exact int64 reduction, 0 where it takes the ordered chain
extern "C" int ebcot_dist_exact(int p, int npos) { return exact_plane(p, npos) ? 1 : 0; }

// a launch for codeblocks of h x w: threads and shared bytes a block, and
// blocks resident on one SM
extern "C" int ebcot_dist_occupancy(int h, int w, int max_passes, int* threads, int* smem,
                                    int* blocks) {
    *threads = dist_threads(h, w);
    *smem = (int)dist_smem(h, w, max_passes, *threads);
    int rc = (int)cudaFuncSetAttribute(ebcot_dist_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ebcot_dist_kernel,
                                                              *threads, *smem);
}

// sym [n, pmaxc, 3, s_pad] uint8 (K-c's records, 16-byte aligned); coeffs
// [n, h, w] int32; numbps [n] int32 (each at most pmax = (max_passes + 2) / 3);
// dist [n, max_passes] float64 out.
extern "C" int ebcot_pass_dist(const void* sym, const void* coeffs, const void* numbps,
                               void* dist, int n, int pmaxc, int s_pad, int h, int w,
                               int max_passes, void* stream) {
    if (n <= 0 || max_passes <= 0) return 0;
    if (((uintptr_t)sym & 15) || (s_pad & 7)) return (int)cudaErrorInvalidValue;
    const int threads = dist_threads(h, w);
    const size_t smem = dist_smem(h, w, max_passes, threads);
    int rc = (int)cudaFuncSetAttribute(ebcot_dist_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    ebcot_dist_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)sym, (const int32_t*)coeffs, (const int32_t*)numbps, (double*)dist,
        pmaxc, s_pad, h, w, max_passes);
    return (int)cudaGetLastError();
}
