// The horizontal halves of the strip wavelet, in place on the h x w
// sub-block of each of up to H_PLANES planes of one shape (row stride ld):
// each row becomes [s | d] (forward) or goes from [s | d] back to natural
// order (inverse), with the origin parity px (sample p is low-pass iff
// (p & 1) == px).
//
// Replaces: K6's _fwd53_h_local, _inv53_h_local, _fwd97_h_local and
// _inv97_h_local (grok_tpu/parallel/mesh.py:118, :130, :207, :229).
//
// dwt53_fwd_h / dwt53_inv_h, int32: K-b's and K-g's lifting (dwt53.cu,
// dwt53_inv.cu) along one axis: forward d -= (s + s) >> 1, then
// s += (d + d + 2) >> 2; inverse the two steps undone in reverse. Sums wrap
// as the reference's wadd/wsub (native/pipeline.cpp:37-46): they are done in
// uint32_t and converted back before each shift. A line of one sample is
// doubled (forward) or halved (inverse) at odd origin and kept at even
// origin (ops/dwt.py:118-119).
//
// dwt97_fwd_h / dwt97_inv_h, float32: K-k's and K-n's lifting (dwt97.cu)
// along one axis: forward d += A (s + s), s += B (d + d), d += G (s + s),
// s += D (d + d), then s / K and d * K; inverse s * K and d / K, then the
// four steps undone in reverse. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, and the source is built with -fmad=false,
// which leaves the integer code of the 5/3 halves alone), as the host path
// computes them. A line of one sample is neither lifted nor scaled
// (ops/dwt.py:154-158).
//
// The line length and the lines a launch pick one of two forms
// (transform.h_form), each counted in Kernel.forms:
//
// "smem", lines of up to H_MAX_LINE samples. Bound on an H100: bytes, the
// sub-block read once and written once (8 bytes a sample: the 1024 x 4096
// level-0 sub-block of the 4096x4096 strip moves 33.5 MB, 0.0100 ms at 3.35
// TB/s; the 9/7's float operations take a fifth of that at 67 TFLOP/s).
// One launch takes up to H_PLANES planes of one shape (the shards on one
// card): their addresses travel by value in the parameters (HArgs,
// __grid_constant__) and the grid runs over the rows of all of them. A
// block owns R whole rows of one plane (as many as H_ROWS_SMEM holds, at
// least one: one at 4,096 columns, where 2, 3 and 4 rows a block measured
// slower for the 5/3 on an H100) and stages them in shared memory by
// cp.async, 16 bytes at a time over each row's 16-byte aligned body and 4
// at its ends (a row sits in shared memory at its address modulo 16, so
// the copies line up); a thread takes quads of four samples (the threads of
// a row are a power of two, so a block spreads over its rows without a
// division). The rows belong to the block, which reads all of them before
// it writes any: no scratch and no copy.
// - The 5/3 halves run the two steps in place in shared memory, a quad a
//   thread (one 16-byte shared load where aligned), the forward in natural
//   order, the inverse in the packed layout, and store each row 16 bytes
//   at a time where aligned (the forward's two 16-byte shared loads give
//   four s and four d, the inverse's four s and four d give eight natural
//   samples) and word by word at the ends, with __syncthreads() between
//   staging, each step and the store. In natural order sample p's
//   neighbours p - 1 and p + 1 are reflected at the line's ends (-1 to 1,
//   w to w - 2), the clamps of the packed form (dwt97.cu's header proves
//   the two the same).
// - The 9/7 halves lift a quad in registers: the twelve natural samples
//   from four before it to four after it (three 16-byte shared loads
//   forward; the inverse gathers them from the packed halves, six 8-byte
//   loads), reflected at the line's ends (T.800's symmetric extension, which
//   the clamps equal), go through the scaling and the four steps in
//   registers, and the middle four, right after four steps (K-k's and
//   K-n's tiles with a halo of 4, along one axis), go straight to their
//   places in the row: two 8-byte stores of two s and two d (forward), one
//   16-byte store of four natural samples (inverse). Every window does the
//   same operations on the same values as the whole line, so the result
//   agrees bit for bit; the halo costs about twice the operations of the
//   whole line, under a tenth of the bytes' time. One barrier, after the
//   staging: the 5/3's design, four steps in place with five barriers and
//   stride-2 shared stores that conflict 4-way, took 0.061 / 0.058 ms
//   against 0.052 / 0.052 on the strip's four level-0 sub-blocks on an
//   H100 (PERF.md §6).
//
// A "smem" block lifts its rows alone, so a launch of few long lines
// leaves SMs idle: transform.h_form gives such a launch the "scratch" form.
//
// "scratch", longer lines. The 5/3: one thread an output sample, which
// recomputes its lifting neighbourhood with clamped indices (at most five
// source samples forward, seven inverse), one launch over every plane
// (blockIdx.z a plane) from a compact copy of each sub-block (forward) or
// into one, copied back (inverse). The 9/7: six launches a plane, one
// plane after another, through its compact h x w part of the scratch
// (scratch_lines): the lines deinterleaved into it, each lifting step over
// all of it, then the scaled result back into the plane (the inverse: the
// scaled packed lines in, the steps in reverse, interleaved back). Both do
// the "smem" form's operations on the same values, so they agree bit for
// bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the reference's wrapping sum and difference
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// the constants of native/pipeline.cpp:28-33 (as in dwt97.cu)
#define A97 ((float)-1.586134342059924)
#define B97 ((float)-0.052980118572961)
#define G97 ((float)0.882911075530934)
#define D97 ((float)0.443506852043971)
#define K97 ((float)1.230174104914001)
#define IK97 ((float)(1.0 / 1.230174104914001))

// x + c (a + b), or x - c (a + b) when sub, each operation rounded on its
// own (K-k's and K-n's steps in dwt97.cu write the same three)
__device__ __forceinline__ float lifted(float x, float a, float b, float c, bool sub) {
    const float p = __fmul_rn(c, __fadd_rn(a, b));
    return sub ? __fsub_rn(x, p) : __fadd_rn(x, p);
}

#define H_THREADS 256
#define H_PLANES 8               // planes a launch (transform.H_MAX_PLANES)
// shared bytes the rows of a "smem" block fill: one row of 4,096
// samples (16,416 B), so 8 blocks of 256 threads fit an SM
#define H_ROWS_SMEM (17 * 1024)
#define H_MAX_LINE (50 * 1024)   // the longest "smem" line (transform.MAX_LINE)
#define H_MAX_SMEM (227 * 1024)  // the shared bytes a block may have on an H100

struct HArgs {
    int64_t plane[H_PLANES];  // each plane's sub-block
    int64_t ld;               // their row stride, in samples
    int n, h, w, px;          // planes; rows and columns of a sub-block; origin parity
    int rows, pitch, bps;     // "smem": rows a block, words a staged row, blocks a plane
    int tpr_log;              // "smem": log2 of the threads that share a row
};

// The parameters of a launch over n planes, as many rows a "smem" block as
// H_ROWS_SMEM holds (at least one); false where they are out of range.
static bool make_args(HArgs& a, const int64_t* planes, int n, int64_t ld, int h, int w,
                      int px) {
    if (n < 1 || n > H_PLANES || h <= 0 || w <= 0 || ld < w) return false;
    for (int i = 0; i < H_PLANES; ++i) a.plane[i] = i < n ? planes[i] : 0;
    a.ld = ld;
    a.n = n;
    a.h = h;
    a.w = w;
    a.px = px & 1;
    // room for a row's offset modulo 16 bytes and for the quads read past its end
    a.pitch = ((w + 3) & ~3) + 8;
    const int fit = H_ROWS_SMEM / (a.pitch * 4);
    a.rows = fit < 1 ? 1 : fit < h ? fit : h;
    a.bps = (h + a.rows - 1) / a.rows;
    // a row's quads spread over the fewest threads (a power of two) that take
    // one each, up to the block
    a.tpr_log = 0;
    while ((1 << a.tpr_log) < H_THREADS && (4 << a.tpr_log) < w) ++a.tpr_log;
    return true;
}

// a run of n words of global memory from g as work items: the chunks of 4
// words of its 16-byte aligned body, then each word before and after it
struct Run {
    int head, nvec, n;
    __device__ __forceinline__ Run(const void* g, int n_) : n(n_) {
        const int to16 = (int)(((16 - ((uintptr_t)g & 15)) & 15) >> 2);
        head = to16 < n ? to16 : n;
        nvec = (n - head) >> 2;
    }
    __device__ __forceinline__ int items() const { return n - 3 * nvec; }
    // the word of item j >= nvec
    __device__ __forceinline__ int word(int j) const {
        j -= nvec;
        return j < head ? j : j + 4 * nvec;
    }
};

// a thread's share of a block's rows: rows r0, r0 + rstep, ..., and of each
// row the items lt, lt + tpr, ...
struct Share {
    int lt, tpr, r0, rstep;
    __device__ __forceinline__ explicit Share(int tpr_log)
        : lt((int)threadIdx.x & ((1 << tpr_log) - 1)), tpr(1 << tpr_log),
          r0((int)threadIdx.x >> tpr_log), rstep((int)blockDim.x >> tpr_log) {}
};

// where global row g sits in shared memory: its row r, at g's offset modulo 16 bytes
template <class T>
__device__ __forceinline__ T* staged(T* s, int pitch, int r, const T* g) {
    return s + r * pitch + (int)(((uintptr_t)g >> 2) & 3);
}

// rows [0, nr) of width w from g0 (stride ld) into shared memory, by cp.async
template <class T>
__device__ __forceinline__ void stage_rows(const T* g0, int64_t ld, int nr, int w, int pitch,
                                           T* s, const Share& sh) {
    for (int r = sh.r0; r < nr; r += sh.rstep) {
        const T* g = g0 + r * ld;
        T* x = staged(s, pitch, r, g);
        const Run run(g, w);
        for (int j = sh.lt; j < run.items(); j += sh.tpr) {
            if (j < run.nvec) {
                const int k = run.head + 4 * j;
                __pipeline_memcpy_async(x + k, g + k, 16);
            } else {
                const int k = run.word(j);
                __pipeline_memcpy_async(x + k, g + k, 4);
            }
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
}

// a sample from its 32 bits
__device__ __forceinline__ void unbits(unsigned u, int32_t& v) { v = (int32_t)u; }
__device__ __forceinline__ void unbits(unsigned u, float& v) { v = __uint_as_float(u); }

// staged samples x[0 .. 3] into e[0 .. 3]: one 16-byte load where aligned
template <class T>
__device__ __forceinline__ void load4(const T* x, T* e) {
    if (((uintptr_t)x & 15) == 0) {
        const uint4 v = *(const uint4*)x;
        unbits(v.x, e[0]), unbits(v.y, e[1]), unbits(v.z, e[2]), unbits(v.w, e[3]);
    } else {
        e[0] = x[0], e[1] = x[1], e[2] = x[2], e[3] = x[3];
    }
}

// ---------------------------------------------------------------- the 5/3 forward
// d -= (l + r) >> 1 (predict) or s += (l + r + 2) >> 2 (update)
template <bool PREDICT>
__device__ __forceinline__ int32_t step53(int32_t x, int32_t l, int32_t r) {
    return PREDICT ? wsub(x, wadd(l, r) >> 1) : wadd(x, wadd(wadd(l, r), 2) >> 2);
}

// on a staged natural-order line of w >= 2 samples, in place: the samples of
// phase PH of quad q (natural 4q + PH and 4q + PH + 2) from their two
// neighbours, reflected at the ends (-1 to 1, w to w - 2)
template <bool PREDICT, int PH>
__device__ __forceinline__ void lift_quad(int32_t* x, int q, int w) {
    const int p0 = 4 * q;
    int32_t e[6];  // natural p0 - 1 .. p0 + 4
    load4(x + p0, e + 1);
    e[0] = PH == 0 && q ? x[p0 - 1] : 0;
    e[5] = PH == 1 ? x[p0 + 4] : 0;
#pragma unroll
    for (int c = PH; c < 4; c += 2) {
        const int p = p0 + c;  // e[c + 1]
        if (p >= w) break;
        const int32_t l = p ? e[c] : e[2];
        x[p] = step53<PREDICT>(e[c + 1], l, p + 1 < w ? e[c + 2] : l);
    }
}

// the "smem" form: block b lifts rows [y0, y0 + rows) of plane b / bps
__global__ void __launch_bounds__(H_THREADS) dwt53_fwd_rows(const __grid_constant__ HArgs a) {
    extern __shared__ __align__(16) int32_t s_rows[];
    const int p = blockIdx.x / a.bps, y0 = (blockIdx.x - p * a.bps) * a.rows;
    const int nr = min(a.rows, a.h - y0), w = a.w, px = a.px, nq = (w + 3) >> 2;
    const Share sh(a.tpr_log);
    int32_t* g0 = (int32_t*)a.plane[p] + y0 * a.ld;
    stage_rows(g0, a.ld, nr, w, a.pitch, s_rows, sh);
    __syncthreads();
    if (w == 1) {
        for (int r = threadIdx.x; r < nr && px; r += blockDim.x) {
            int32_t* x = staged(s_rows, a.pitch, r, g0 + r * a.ld);
            x[0] = wadd(x[0], x[0]);
        }
    } else {
        for (int r = sh.r0; r < nr; r += sh.rstep) {  // d -= (s + s) >> 1
            int32_t* x = staged(s_rows, a.pitch, r, g0 + r * a.ld);
            for (int q = sh.lt; q < nq; q += sh.tpr) {
                if (px) lift_quad<true, 0>(x, q, w); else lift_quad<true, 1>(x, q, w);
            }
        }
        __syncthreads();
        for (int r = sh.r0; r < nr; r += sh.rstep) {  // s += (d + d + 2) >> 2
            int32_t* x = staged(s_rows, a.pitch, r, g0 + r * a.ld);
            for (int q = sh.lt; q < nq; q += sh.tpr) {
                if (px) lift_quad<false, 1>(x, q, w); else lift_quad<false, 0>(x, q, w);
            }
        }
    }
    __syncthreads();
    // the s run (natural 2k + px) at the row's start, the d run (2k + 1 - px) after it
    const int sn = px ? w >> 1 : (w + 1) >> 1;
    for (int r = sh.r0; r < nr; r += sh.rstep) {
        int32_t* g = g0 + r * a.ld;
        const int32_t* x = staged(s_rows, a.pitch, r, g);
        if (((uintptr_t)g & 15) == 0 && (sn & 3) == 0) {
            // both runs 16-byte aligned: natural 8j .. 8j + 7 give s and d 4j .. 4j + 3
            const int n8 = w >> 3;
            for (int j = sh.lt; j < n8 + (w & 7); j += sh.tpr) {
                if (j < n8) {
                    const uint4 lo = *(const uint4*)(x + 8 * j);
                    const uint4 hi = *(const uint4*)(x + 8 * j + 4);
                    const uint4 ev = make_uint4(lo.x, lo.z, hi.x, hi.z);
                    const uint4 od = make_uint4(lo.y, lo.w, hi.y, hi.w);
                    *(uint4*)(g + 4 * j) = px ? od : ev;
                    *(uint4*)(g + sn + 4 * j) = px ? ev : od;
                } else {
                    const int q = 8 * n8 + j - n8;
                    g[((q & 1) == px ? 0 : sn) + (q >> 1)] = x[q];
                }
            }
            continue;
        }
        for (int d = 0; d < 2; ++d) {
            const int ph = d ? 1 - px : px;  // run sample k is natural 2k + ph
            int32_t* gr = g + (d ? sn : 0);
            const Run run(gr, d ? w - sn : sn);
            for (int j = sh.lt; j < run.items(); j += sh.tpr) {
                if (j < run.nvec) {
                    const int k = run.head + 4 * j;
                    const int32_t* q = x + 2 * k + ph;
                    *(uint4*)(gr + k) = make_uint4(q[0], q[2], q[4], q[6]);
                } else {
                    const int k = run.word(j);
                    gr[k] = x[2 * k + ph];
                }
            }
        }
    }
}

// ---------------------------------------------------------------- the 5/3 inverse
// on a staged packed line (s at [0, sn), d at [sn, sn + dn)), in place: the
// update step on the s samples of quad q (k = 4q .. 4q + 3, k < sn),
// s_k -= (d_l + d_r + 2) >> 2 with the forward's clamped neighbours
template <int PX>
__device__ __forceinline__ void update_quad(int32_t* s, const int32_t* d, int q, int sn, int dn) {
    const int k0 = 4 * q;
    int32_t v[4], e[6];  // e[i + 1] = d[k0 + i]
    load4(s + k0, v);
    load4(d + k0, e + 1);
    e[0] = PX == 0 && q ? d[k0 - 1] : 0;
    e[5] = PX == 1 ? d[k0 + 4] : 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int k = k0 + t;
        if (k >= sn) break;
        const int32_t l = PX ? e[t + 1] : k ? e[t] : e[1];
        const int32_t r = PX ? (k + 1 < dn ? e[t + 2] : e[t + 1]) : (k < dn ? e[t + 1] : e[t]);
        s[k] = wsub(v[t], wadd(wadd(l, r), 2) >> 2);
    }
}

// then the predict step on the d samples of quad q (k < dn),
// d_k += (s_l + s_r) >> 1
template <int PX>
__device__ __forceinline__ void predict_quad(const int32_t* s, int32_t* d, int q, int sn, int dn) {
    const int k0 = 4 * q;
    int32_t v[4], e[6];  // e[i + 1] = s[k0 + i]
    load4(d + k0, v);
    load4(s + k0, e + 1);
    e[0] = PX == 1 && q ? s[k0 - 1] : 0;
    e[5] = PX == 0 ? s[k0 + 4] : 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int k = k0 + t;
        if (k >= dn) break;
        const int32_t l = PX ? (k ? e[t] : e[1]) : e[t + 1];
        const int32_t r = PX ? (k < sn ? e[t + 1] : e[t]) : (k + 1 < sn ? e[t + 2] : e[t + 1]);
        d[k] = wadd(v[t], wadd(l, r) >> 1);
    }
}

// natural sample q of a packed line: s[q >> 1] if (q & 1) == px, else d[q >> 1]
__device__ __forceinline__ int32_t natural(const int32_t* s, const int32_t* d, int px, int q) {
    return ((q & 1) == px ? s : d)[q >> 1];
}

// the "smem" form: block b lifts rows [y0, y0 + rows) of plane b / bps
__global__ void __launch_bounds__(H_THREADS) dwt53_inv_rows(const __grid_constant__ HArgs a) {
    extern __shared__ __align__(16) int32_t s_rows[];
    const int p = blockIdx.x / a.bps, y0 = (blockIdx.x - p * a.bps) * a.rows;
    const int nr = min(a.rows, a.h - y0), w = a.w, px = a.px;
    const int sn = px ? w >> 1 : (w + 1) >> 1, dn = w - sn;
    const Share sh(a.tpr_log);
    int32_t* g0 = (int32_t*)a.plane[p] + y0 * a.ld;
    stage_rows(g0, a.ld, nr, w, a.pitch, s_rows, sh);
    __syncthreads();
    if (w == 1) {
        for (int r = threadIdx.x; r < nr && px; r += blockDim.x) {
            int32_t* x = staged(s_rows, a.pitch, r, g0 + r * a.ld);
            x[0] >>= 1;
        }
    } else {
        for (int r = sh.r0; r < nr; r += sh.rstep) {  // s -= (d + d + 2) >> 2
            int32_t* s = staged(s_rows, a.pitch, r, g0 + r * a.ld);
            for (int q = sh.lt; 4 * q < sn; q += sh.tpr) {
                if (px) update_quad<1>(s, s + sn, q, sn, dn);
                else update_quad<0>(s, s + sn, q, sn, dn);
            }
        }
        __syncthreads();
        for (int r = sh.r0; r < nr; r += sh.rstep) {  // d += (s + s) >> 1
            int32_t* s = staged(s_rows, a.pitch, r, g0 + r * a.ld);
            for (int q = sh.lt; 4 * q < dn; q += sh.tpr) {
                if (px) predict_quad<1>(s, s + sn, q, sn, dn);
                else predict_quad<0>(s, s + sn, q, sn, dn);
            }
        }
    }
    __syncthreads();
    for (int r = sh.r0; r < nr; r += sh.rstep) {  // the row in natural order
        int32_t* g = g0 + r * a.ld;
        const int32_t* s = staged(s_rows, a.pitch, r, g);
        const int32_t* d = s + sn;
        if (((uintptr_t)g & 15) == 0 && (sn & 3) == 0) {
            // s and d 16-byte aligned: s and d 4j .. 4j + 3 give natural 8j .. 8j + 7
            const int n8 = w >> 3;
            for (int j = sh.lt; j < n8 + (w & 7); j += sh.tpr) {
                if (j < n8) {
                    const uint4 sv = *(const uint4*)(s + 4 * j), dv = *(const uint4*)(d + 4 * j);
                    const uint4 e = px ? dv : sv, o = px ? sv : dv;  // the even and odd samples
                    *(uint4*)(g + 8 * j) = make_uint4(e.x, o.x, e.y, o.y);
                    *(uint4*)(g + 8 * j + 4) = make_uint4(e.z, o.z, e.w, o.w);
                } else {
                    const int q = 8 * n8 + j - n8;
                    g[q] = natural(s, d, px, q);
                }
            }
            continue;
        }
        const Run run(g, w);
        for (int j = sh.lt; j < run.items(); j += sh.tpr) {
            if (j < run.nvec) {
                const int q = run.head + 4 * j;  // natural samples q .. q + 3
                *(uint4*)(g + q) = make_uint4(natural(s, d, px, q), natural(s, d, px, q + 1),
                                              natural(s, d, px, q + 2), natural(s, d, px, q + 3));
            } else {
                const int q = run.word(j);
                g[q] = natural(s, d, px, q);
            }
        }
    }
}

// ---------------------------------------------------------------- the 9/7 in registers
// T.800's symmetric extension of a line of n >= 2 samples: x reflected into [0, n)
__device__ __forceinline__ int reflect(int x, int n) {
    if (x >= 0 && x < n) return x;
    const int period = 2 * (n - 1);
    x %= period;
    if (x < 0) x += period;
    return x < n ? x : period - x;
}

// one lifting step on a window of N samples in registers: v[c] += k (v[c - 1]
// + v[c + 1]), or -= when SUB, for c = FIRST, FIRST + 2, ... inside
// (0, N - 1); the window's ends lack a neighbour and go stale, so after j
// steps samples [j, N - j) are right
template <int N, int FIRST, bool SUB>
__device__ __forceinline__ void window_step(float (&v)[N], float k) {
#pragma unroll
    for (int c = FIRST == 0 ? 2 : 1; c < N - 1; c += 2)
        v[c] = lifted(v[c], v[c - 1], v[c + 1], k, SUB);
}

// staged words x[0 .. 2n) into e[0 .. 2n): 8-byte loads where aligned
template <int N2>
__device__ __forceinline__ void load_pairs(const float* x, float* e) {
    if (((uintptr_t)x & 7) == 0) {
#pragma unroll
        for (int i = 0; i < N2; i += 2) {
            const uint2 u = *(const uint2*)(x + i);
            e[i] = __uint_as_float(u.x), e[i + 1] = __uint_as_float(u.y);
        }
    } else {
#pragma unroll
        for (int i = 0; i < N2; ++i) e[i] = x[i];
    }
}

// natural samples p0 - 4 .. p0 + 7 of quad q of a staged natural-order
// line, reflected at its ends, lifted forward in registers, stored to the
// row's [s | d] places in g: natural p0 .. p0 + 3 are two s and two d
template <int PX>
__device__ __forceinline__ void fwd97_quad(const float* x, float* g, int q, int w, int sn) {
    const int p0 = 4 * q;
    float v[12];
    if (p0 >= 4 && p0 + 8 <= w) {
        load4(x + p0 - 4, v), load4(x + p0, v + 4), load4(x + p0 + 4, v + 8);
    } else {
#pragma unroll
        for (int i = 0; i < 12; ++i) v[i] = x[reflect(p0 - 4 + i, w)];
    }
    window_step<12, 1 - PX, false>(v, A97);  // v[c] is low-pass iff (c & 1) == PX
    window_step<12, PX, false>(v, B97);
    window_step<12, 1 - PX, false>(v, G97);
    window_step<12, PX, false>(v, D97);
    // natural p0 + c is v[4 + c]: s[2q + (c >> 1)] if (c & 1) == PX, else d[2q + (c >> 1)]
    const float s0 = __fmul_rn(v[4 + PX], IK97), s1 = __fmul_rn(v[6 + PX], IK97);
    const float d0 = __fmul_rn(v[5 - PX], K97), d1 = __fmul_rn(v[7 - PX], K97);
    const int k = 2 * q, dn = w - sn;
    float* gs = g + k;
    float* gd = g + sn + k;
    if (k + 1 < sn && ((uintptr_t)gs & 7) == 0) {
        *(uint2*)gs = make_uint2(__float_as_uint(s0), __float_as_uint(s1));
    } else {
        if (k < sn) gs[0] = s0;
        if (k + 1 < sn) gs[1] = s1;
    }
    if (k + 1 < dn && ((uintptr_t)gd & 7) == 0) {
        *(uint2*)gd = make_uint2(__float_as_uint(d0), __float_as_uint(d1));
    } else {
        if (k < dn) gd[0] = d0;
        if (k + 1 < dn) gd[1] = d1;
    }
}

// the inverse: natural samples p0 - 4 .. p0 + 7 of quad q gathered from a
// staged packed line (s at [0, sn), d at [sn, w)), reflected at the line's
// ends, scaled and lifted in registers, natural p0 .. p0 + 3 stored to g
template <int PX>
__device__ __forceinline__ void inv97_quad(const float* s, float* g, int q, int w, int sn) {
    const int p0 = 4 * q;
    const float* d = s + sn;
    float v[12];
    if (p0 >= 4 && p0 + 8 <= w) {
        // natural p0 - 4 + 2i is (PX ? d : s)[2q - 2 + i], p0 - 3 + 2i the other's
        float ev[6], od[6];
        load_pairs<6>((PX ? d : s) + 2 * q - 2, ev);
        load_pairs<6>((PX ? s : d) + 2 * q - 2, od);
#pragma unroll
        for (int i = 0; i < 6; ++i) v[2 * i] = ev[i], v[2 * i + 1] = od[i];
    } else {
#pragma unroll
        for (int i = 0; i < 12; ++i) {
            const int n = reflect(p0 - 4 + i, w);
            v[i] = ((n & 1) == PX ? s : d)[n >> 1];
        }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = __fmul_rn(v[i], (i & 1) == PX ? K97 : IK97);
    window_step<12, PX, true>(v, D97);
    window_step<12, 1 - PX, true>(v, G97);
    window_step<12, PX, true>(v, B97);
    window_step<12, 1 - PX, true>(v, A97);
    float* o = g + p0;
    if (p0 + 3 < w && ((uintptr_t)o & 15) == 0) {
        *(uint4*)o = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                                __float_as_uint(v[6]), __float_as_uint(v[7]));
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
            if (p0 + c < w) o[c] = v[4 + c];
    }
}

// the 9/7 "smem" form: block b stages rows [y0, y0 + rows) of plane b / bps,
// then each thread lifts its quads in registers and writes them in place
template <bool FWD>
__global__ void __launch_bounds__(H_THREADS) dwt97_rows(const __grid_constant__ HArgs a) {
    extern __shared__ __align__(16) int32_t s_rows[];
    float* s_f = (float*)s_rows;
    const int p = blockIdx.x / a.bps, y0 = (blockIdx.x - p * a.bps) * a.rows;
    const int nr = min(a.rows, a.h - y0), w = a.w, px = a.px, nq = (w + 3) >> 2;
    const int sn = px ? w >> 1 : (w + 1) >> 1;
    float* g0 = (float*)a.plane[p] + y0 * a.ld;
    if (w == 1) return;  // a lone sample stays as it is
    const Share sh(a.tpr_log);
    stage_rows(g0, a.ld, nr, w, a.pitch, s_f, sh);
    __syncthreads();
    for (int r = sh.r0; r < nr; r += sh.rstep) {
        float* g = g0 + r * a.ld;
        const float* x = staged(s_f, a.pitch, r, g);
        for (int q = sh.lt; q < nq; q += sh.tpr) {
            if (FWD) {
                if (px) fwd97_quad<1>(x, g, q, w, sn); else fwd97_quad<0>(x, g, q, w, sn);
            } else {
                if (px) inv97_quad<1>(x, g, q, w, sn); else inv97_quad<0>(x, g, q, w, sn);
            }
        }
    }
}

// ---------------------------------------------------------------- the 5/3 "scratch" form
struct Line {
    const int32_t* p;
    int64_t step;
    __device__ __forceinline__ int32_t at(int i) const { return p[i * step]; }
};

__device__ __forceinline__ int32_t s_at(const Line& L, int i, int par) {
    return L.at(2 * i + par);
}

__device__ __forceinline__ int32_t d_at(const Line& L, int j, int par) {
    return L.at(2 * j + 1 - par);
}

// high-pass output j after the predict step
__device__ __forceinline__ int32_t dprime(const Line& L, int j, int par, int sn) {
    const int sl = par == 0 ? j : max(j - 1, 0);
    const int sr = min(par == 0 ? j + 1 : j, sn - 1);
    return wsub(d_at(L, j, par), wadd(s_at(L, sl, par), s_at(L, sr, par)) >> 1);
}

// Mallat-packed output o of a length-n line: [low | high]
__device__ __forceinline__ int32_t lift_out(const Line& L, int n, int par, int o) {
    if (n == 1) return par ? wadd(L.at(0), L.at(0)) : L.at(0);
    const int sn = par ? n / 2 : (n + 1) / 2;
    const int dn = n - sn;
    if (o >= sn) return dprime(L, o - sn, par, sn);
    const int dl = par == 0 ? max(o - 1, 0) : o;
    const int dr = min(par == 0 ? o : o + 1, dn - 1);
    return wadd(s_at(L, o, par),
                wadd(wadd(dprime(L, dl, par, sn), dprime(L, dr, par, sn)), 2) >> 2);
}

// tmp: the planes' sub-blocks back to back, each h x w compact
__global__ void dwt53_horz(const int32_t* __restrict__ tmp, const __grid_constant__ HArgs a) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (o >= a.w || y >= a.h) return;
    const Line L{tmp + ((int64_t)blockIdx.z * a.h + y) * a.w, 1};
    ((int32_t*)a.plane[blockIdx.z])[(int64_t)y * a.ld + o] = lift_out(L, a.w, a.px, o);
}

// the inverse: low-pass sample i after the update step: s[i] - (d[l] + d[r] + 2) >> 2;
// the packed line holds s in [0, sn) and d in [sn, n)
__device__ __forceinline__ int32_t s_out(const Line& L, int i, int par, int sn, int dn) {
    const int dl = par == 0 ? max(i - 1, 0) : i;
    const int dr = min(par == 0 ? i : i + 1, dn - 1);
    return wsub(L.at(i), wadd(wadd(L.at(sn + dl), L.at(sn + dr)), 2) >> 2);
}

// natural-order output o of a length-n packed line
__device__ __forceinline__ int32_t unlift_out(const Line& L, int n, int par, int o) {
    if (n == 1) return par ? (L.at(0) >> 1) : L.at(0);
    const int sn = par ? n / 2 : (n + 1) / 2;
    const int dn = n - sn;
    const int k = o >> 1;
    if ((o & 1) == par) return s_out(L, k, par, sn, dn);
    const int sl = par == 0 ? k : max(k - 1, 0);
    const int sr = min(par == 0 ? k + 1 : k, sn - 1);
    return wadd(L.at(sn + k), wadd(s_out(L, sl, par, sn, dn), s_out(L, sr, par, sn, dn)) >> 1);
}

// tmp: the planes' natural-order sub-blocks back to back, each h x w compact
__global__ void dwt53_inv_horz(int32_t* __restrict__ tmp, const __grid_constant__ HArgs a) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (o >= a.w || y >= a.h) return;
    const Line L{(const int32_t*)a.plane[blockIdx.z] + (int64_t)y * a.ld, 1};
    tmp[((int64_t)blockIdx.z * a.h + y) * a.w + o] = unlift_out(L, a.w, a.px, o);
}

// ---------------------------------------------------------------- the 9/7 "scratch" form
// One plane's lines through tmp: h lines of n samples, each [s | d],
// compact. Each kernel takes an item a thread (a 1-d grid over h * n or
// h * nt items).

// forward: tmp = the natural-order lines of plane (row stride ld),
// deinterleaved; inverse: tmp = the packed lines, s * K and d / K
template <bool FWD>
__global__ void dwt97_scratch_in(const float* __restrict__ plane, float* __restrict__ tmp,
                                 int64_t ld, int h, int n, int par) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)h * n) return;
    const int64_t y = i / n;
    const int k = (int)(i - y * n), sn = par ? n / 2 : (n + 1) / 2;
    if (FWD)
        tmp[i] = plane[y * ld + (k < sn ? 2 * k + par : 2 * (k - sn) + 1 - par)];
    else
        tmp[i] = __fmul_rn(plane[y * ld + k], k < sn ? K97 : IK97);
}

// one lifting step on every line of tmp: tgt[t] +- c (src[l] + src[r]) for
// the target phase's nt samples at to, from the source phase's ns at so,
// neighbours t + lo and t + hi clamped into [0, ns)
__global__ void dwt97_scratch_step(float* __restrict__ tmp, int h, int n, int to, int nt,
                                   int so, int ns, int lo, int hi, float c, bool sub) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)h * nt) return;
    const int64_t y = i / nt;
    const int t = (int)(i - y * nt);
    float* line = tmp + y * n;
    const int l = min(max(t + lo, 0), ns - 1), r = min(max(t + hi, 0), ns - 1);
    line[to + t] = lifted(line[to + t], line[so + l], line[so + r], c, sub);
}

// forward: plane's lines = tmp's, s / K and d * K; inverse: plane's lines
// = tmp's interleaved into natural order
template <bool FWD>
__global__ void dwt97_scratch_out(const float* __restrict__ tmp, float* __restrict__ plane,
                                  int64_t ld, int h, int n, int par) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)h * n) return;
    const int64_t y = i / n;
    const int k = (int)(i - y * n), sn = par ? n / 2 : (n + 1) / 2;
    if (FWD)
        plane[y * ld + k] = __fmul_rn(tmp[i], k < sn ? IK97 : K97);
    else
        plane[y * ld + k] = tmp[y * n + ((k & 1) == par ? k >> 1 : sn + (k >> 1))];
}

// One plane's "scratch" launches in order, each through launch(kernel,
// items, arguments...), which runs kernel over a 1-d grid of at least
// items threads. The neighbour offsets are T.800's symmetric extension as
// a clamp: a d sample's s neighbours are (j, j + 1) for parity 0 and
// (j - 1, j) for parity 1; an s sample's d neighbours (i - 1, i) for
// parity 0 and (i, i + 1) for parity 1.
template <bool FWD, class Launch>
static int scratch_lines(const Launch& launch, float* plane, float* tmp, int64_t ld, int h,
                         int n, int par) {
    if (n <= 1 || h <= 0) return 0;  // a lone sample stays as it is
    const int sn = par ? n / 2 : (n + 1) / 2, dn = n - sn;
    const int d_lo = par ? -1 : 0, d_hi = par ? 0 : 1;  // d's s neighbours
    const int s_lo = par ? 0 : -1, s_hi = par ? 1 : 0;  // s's d neighbours
    auto step = [&](bool to_d, float c) {  // the d phase from s, or the s phase from d
        return to_d ? launch(dwt97_scratch_step, (int64_t)h * dn, tmp, h, n, sn, dn, 0, sn, d_lo,
                             d_hi, c, !FWD)
                    : launch(dwt97_scratch_step, (int64_t)h * sn, tmp, h, n, 0, sn, sn, dn, s_lo,
                             s_hi, c, !FWD);
    };
    int rc = launch(dwt97_scratch_in<FWD>, (int64_t)h * n, plane, tmp, ld, h, n, par);
    const bool to_d[4] = {FWD, !FWD, FWD, !FWD};  // forward A, B, G, D; inverse D, G, B, A
    const float coef[4] = {FWD ? A97 : D97, FWD ? B97 : G97, FWD ? G97 : B97, FWD ? D97 : A97};
    for (int k = 0; k < 4 && !rc; ++k) rc = step(to_d[k], coef[k]);
    if (!rc) rc = launch(dwt97_scratch_out<FWD>, (int64_t)h * n, tmp, plane, ld, h, n, par);
    return rc;
}

// ---------------------------------------------------------------- the C entries
typedef void (*RowsKernel)(HArgs);

// let a "smem" block have smem bytes of shared memory; the limit is raised
// only past the 48 KB every kernel may have (lowering it below a later
// launch's need would refuse that launch)
static int allow_smem(RowsKernel kernel, int smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the "smem" form's launch at w columns and h rows a plane: threads, rows
// and shared bytes a block, and its blocks resident on one SM
static int occupancy(RowsKernel kernel, int h, int w, int* threads, int* rows, int* smem,
                     int* blocks) {
    HArgs a;
    const int64_t zero = 0;
    if (w > H_MAX_LINE || !make_args(a, &zero, 1, w, h, w, 0))
        return (int)cudaErrorInvalidValue;
    *threads = H_THREADS;
    *rows = a.rows;
    *smem = a.rows * a.pitch * (int)sizeof(int32_t);
    int rc = allow_smem(kernel, *smem);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, *smem);
}

extern "C" int dwt53_fwd_h_occupancy(int h, int w, int* threads, int* rows, int* smem,
                                     int* blocks) {
    return occupancy(dwt53_fwd_rows, h, w, threads, rows, smem, blocks);
}

extern "C" int dwt53_inv_h_occupancy(int h, int w, int* threads, int* rows, int* smem,
                                     int* blocks) {
    return occupancy(dwt53_inv_rows, h, w, threads, rows, smem, blocks);
}

extern "C" int dwt97_fwd_h_occupancy(int h, int w, int* threads, int* rows, int* smem,
                                     int* blocks) {
    return occupancy(dwt97_rows<true>, h, w, threads, rows, smem, blocks);
}

extern "C" int dwt97_inv_h_occupancy(int h, int w, int* threads, int* rows, int* smem,
                                     int* blocks) {
    return occupancy(dwt97_rows<false>, h, w, threads, rows, smem, blocks);
}

// sub-block i of the planes to or from its place in tmp (n * h * w words)
static int copy_sub(const HArgs& a, int i, int32_t* tmp, bool to_tmp, cudaStream_t st) {
    int32_t* t = tmp + (int64_t)i * a.h * a.w;
    void* p = (void*)a.plane[i];
    const size_t row = (size_t)a.w * 4, ld = (size_t)a.ld * 4;
    return (int)(to_tmp ? cudaMemcpy2DAsync(t, row, p, ld, row, a.h, cudaMemcpyDeviceToDevice, st)
                        : cudaMemcpy2DAsync(p, ld, t, row, row, a.h, cudaMemcpyDeviceToDevice, st));
}

// the 5/3 "scratch" form over the planes: a 2-D copy a plane and one launch
template <bool FWD>
static int scratch53(const HArgs& a, void* tmp, cudaStream_t st) {
    if ((a.h + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
    const dim3 block(32, 8);
    const dim3 grid((a.w + 31) / 32, (a.h + 7) / 8, a.n);
    int rc = 0;
    for (int i = 0; FWD && i < a.n && !rc; ++i) rc = copy_sub(a, i, (int32_t*)tmp, true, st);
    if (rc) return rc;
    if (FWD)
        dwt53_horz<<<grid, block, 0, st>>>((const int32_t*)tmp, a);
    else
        dwt53_inv_horz<<<grid, block, 0, st>>>((int32_t*)tmp, a);
    rc = (int)cudaGetLastError();
    for (int i = 0; !FWD && i < a.n && !rc; ++i) rc = copy_sub(a, i, (int32_t*)tmp, false, st);
    return rc;
}

// a launch of the 9/7 "scratch" form on the card: 256 threads a block
struct CudaLaunch {
    cudaStream_t st;
    template <class... P, class... A>
    int operator()(void (*kernel)(P...), int64_t items, A... args) const {
        kernel<<<(unsigned)((items + 255) / 256), 256, 0, st>>>(args...);
        return (int)cudaGetLastError();
    }
};

// the 9/7 "scratch" form over the planes: scratch_lines on each in turn,
// through its h x w part of tmp
template <bool FWD>
static int scratch97(const HArgs& a, void* tmp, cudaStream_t st) {
    int rc = 0;
    for (int i = 0; i < a.n && !rc; ++i)
        rc = scratch_lines<FWD>(CudaLaunch{st}, (float*)a.plane[i],
                                (float*)tmp + (int64_t)i * a.h * a.w, a.ld, a.h, a.w, a.px);
    return rc;
}

// The half over the n planes at planes[0 .. n) (host addresses of their
// sub-blocks, h x w of row stride ld each), in place: the "smem" form's
// kernel where tmp is null (lines of up to H_MAX_LINE samples), else the
// "scratch" form through tmp (n * h * w samples).
static int strip_half(const int64_t* planes, int n, int64_t ld, int h, int w, int px, void* tmp,
                      cudaStream_t st, RowsKernel kernel,
                      int (*scratch)(const HArgs&, void*, cudaStream_t)) {
    if (h <= 0 || w <= 0) return 0;
    HArgs a;
    if (!make_args(a, planes, n, ld, h, w, px)) return (int)cudaErrorInvalidValue;
    if (tmp != nullptr) return scratch(a, tmp, st);
    const int smem = a.rows * a.pitch * (int)sizeof(int32_t);
    if (w > H_MAX_LINE || smem > H_MAX_SMEM) return (int)cudaErrorInvalidValue;
    int rc = allow_smem(kernel, smem);
    if (rc) return rc;
    kernel<<<n * a.bps, H_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int dwt53_fwd_h(const int64_t* planes, int n, int64_t ld, int h, int w, int px,
                           void* tmp, void* stream) {
    return strip_half(planes, n, ld, h, w, px, tmp, (cudaStream_t)stream, dwt53_fwd_rows,
                      scratch53<true>);
}

extern "C" int dwt53_inv_h(const int64_t* planes, int n, int64_t ld, int h, int w, int px,
                           void* tmp, void* stream) {
    return strip_half(planes, n, ld, h, w, px, tmp, (cudaStream_t)stream, dwt53_inv_rows,
                      scratch53<false>);
}

extern "C" int dwt97_fwd_h(const int64_t* planes, int n, int64_t ld, int h, int w, int px,
                           void* tmp, void* stream) {
    return strip_half(planes, n, ld, h, w, px, tmp, (cudaStream_t)stream, dwt97_rows<true>,
                      scratch97<true>);
}

extern "C" int dwt97_inv_h(const int64_t* planes, int n, int64_t ld, int h, int w, int px,
                           void* tmp, void* stream) {
    return strip_half(planes, n, ld, h, w, px, tmp, (cudaStream_t)stream, dwt97_rows<false>,
                      scratch97<false>);
}
