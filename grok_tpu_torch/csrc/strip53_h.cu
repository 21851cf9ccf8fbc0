// dwt53_fwd_h and dwt53_inv_h: the horizontal halves of the 5/3 strip
// wavelet (K6's _fwd53_h_local and _inv53_h_local, grok_tpu/parallel/
// mesh.py:118, :130, with the origin parity px), in place: each row of the
// h x w sub-block of a plane (row stride ld) becomes [s | d] (forward), or
// goes from [s | d] back to natural order (inverse). The lifting is K-b's
// and K-g's (dwt53.cu, dwt53_inv.cu) along one axis: forward
// d -= (s + s) >> 1, then s += (d + d + 2) >> 2; inverse the two steps
// undone in reverse. Sums wrap as the reference's wadd/wsub
// (native/pipeline.cpp:37-46): they are done in uint32_t and converted back
// before each shift. A line of one sample is doubled (forward) or halved
// (inverse) at odd origin and kept at even origin (ops/dwt.py:118-119).
//
// The line length and the lines a launch pick one of two forms
// (transform.h_form), each counted in Kernel.forms:
//
// "smem", lines of up to H_MAX_LINE samples. Bound on an H100: bytes, the
// sub-block read once and written once (8 bytes a sample: the 1024 x 4096
// level-0 sub-block of the 4096x4096 strip moves 33.5 MB, 0.0100 ms at 3.35
// TB/s). A block owns R whole rows of one plane (as many as H_ROWS_SMEM
// holds, at least one: one at 4,096 columns, where 2, 3 and 4 rows a block
// measured slower on an H100): it stages them in shared
// memory by cp.async, 16 bytes at a time over each row's 16-byte aligned
// body and 4 at its ends (a row sits in shared memory at its address modulo
// 16, so the copies line up); runs the two steps in place, a thread a quad
// of four samples (one 16-byte shared load where aligned; the threads of a
// row are a power of two, so a block spreads over its rows without a
// division), the forward in natural order, the inverse in the packed
// layout; and stores each row, 16 bytes at a time where aligned (the
// forward's two 16-byte shared loads give four s and four d, the inverse's
// four s and four d give eight natural samples) and word by word at the
// ends, with __syncthreads() between staging, each step and the store. The
// rows belong to the block, which reads all of them before it writes any:
// no scratch and no copy. One launch takes up to H_PLANES planes of one
// shape (the shards on one card): their addresses travel by value in the
// parameters (HArgs, __grid_constant__) and the grid runs over the rows of
// all of them. In natural order sample p's neighbours p - 1 and p + 1 are
// reflected at the line's ends (-1 to 1, w to w - 2), the clamps of the
// packed form (dwt97.cu's header proves the two the same).
//
// A "smem" block lifts its rows alone, so a launch of few long lines
// leaves SMs idle: transform.h_form gives such a launch the "scratch" form.
//
// "scratch", longer lines: one thread an output sample, which recomputes
// its lifting neighbourhood with clamped indices (at most five source
// samples forward, seven inverse), one launch over every plane (blockIdx.z a
// plane) from a compact copy of each sub-block (forward) or into one, copied
// back (inverse).

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
    __device__ __forceinline__ Run(const int32_t* g, int n_) : n(n_) {
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
__device__ __forceinline__ int32_t* staged(int32_t* s, int pitch, int r, const int32_t* g) {
    return s + r * pitch + (int)(((uintptr_t)g >> 2) & 3);
}

// rows [0, nr) of width w from g0 (stride ld) into shared memory, by cp.async
__device__ __forceinline__ void stage_rows(const int32_t* g0, int64_t ld, int nr, int w,
                                           int pitch, int32_t* s, const Share& sh) {
    for (int r = sh.r0; r < nr; r += sh.rstep) {
        const int32_t* g = g0 + r * ld;
        int32_t* x = staged(s, pitch, r, g);
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

// staged words x[0 .. 3] into e[0 .. 3]: one 16-byte load where aligned
__device__ __forceinline__ void load4(const int32_t* x, int32_t* e) {
    if (((uintptr_t)x & 15) == 0) {
        const uint4 v = *(const uint4*)x;
        e[0] = (int32_t)v.x, e[1] = (int32_t)v.y, e[2] = (int32_t)v.z, e[3] = (int32_t)v.w;
    } else {
        e[0] = x[0], e[1] = x[1], e[2] = x[2], e[3] = x[3];
    }
}

// ---------------------------------------------------------------- the forward
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

// ---------------------------------------------------------------- the inverse
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

// ---------------------------------------------------------------- the "scratch" form
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

// ---------------------------------------------------------------- the C entries
// let a "smem" block have smem bytes of shared memory; the limit is raised
// only past the 48 KB every kernel may have (lowering it below a later
// launch's need would refuse that launch)
static int allow_smem(void (*kernel)(HArgs), int smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the "smem" form's launch at w columns and h rows a plane: threads, rows
// and shared bytes a block, and its blocks resident on one SM
template <bool FWD>
static int occupancy(int h, int w, int* threads, int* rows, int* smem, int* blocks) {
    HArgs a;
    const int64_t zero = 0;
    if (w > H_MAX_LINE || !make_args(a, &zero, 1, w, h, w, 0))
        return (int)cudaErrorInvalidValue;
    void (*kernel)(HArgs) = FWD ? dwt53_fwd_rows : dwt53_inv_rows;
    *threads = H_THREADS;
    *rows = a.rows;
    *smem = a.rows * a.pitch * (int)sizeof(int32_t);
    int rc = allow_smem(kernel, *smem);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, *smem);
}

extern "C" int dwt53_fwd_h_occupancy(int h, int w, int* threads, int* rows, int* smem,
                                     int* blocks) {
    return occupancy<true>(h, w, threads, rows, smem, blocks);
}

extern "C" int dwt53_inv_h_occupancy(int h, int w, int* threads, int* rows, int* smem,
                                     int* blocks) {
    return occupancy<false>(h, w, threads, rows, smem, blocks);
}

// sub-block i of the planes to or from its place in tmp (n * h * w words)
static int copy_sub(const HArgs& a, int i, int32_t* tmp, bool to_tmp, cudaStream_t st) {
    int32_t* t = tmp + (int64_t)i * a.h * a.w;
    void* p = (void*)a.plane[i];
    const size_t row = (size_t)a.w * 4, ld = (size_t)a.ld * 4;
    return (int)(to_tmp ? cudaMemcpy2DAsync(t, row, p, ld, row, a.h, cudaMemcpyDeviceToDevice, st)
                        : cudaMemcpy2DAsync(p, ld, t, row, row, a.h, cudaMemcpyDeviceToDevice, st));
}

// The half over the n planes at planes[0 .. n) (host addresses of their
// sub-blocks, h x w of row stride ld each), in place: the "smem" form
// where tmp is null (lines of up to H_MAX_LINE samples), else the "scratch"
// form through tmp (n * h * w words).
template <bool FWD>
static int strip_half(const int64_t* planes, int n, int64_t ld, int h, int w, int px, void* tmp,
                      cudaStream_t st) {
    if (h <= 0 || w <= 0) return 0;
    HArgs a;
    if (!make_args(a, planes, n, ld, h, w, px)) return (int)cudaErrorInvalidValue;
    if (tmp == nullptr) {
        void (*kernel)(HArgs) = FWD ? dwt53_fwd_rows : dwt53_inv_rows;
        const int smem = a.rows * a.pitch * (int)sizeof(int32_t);
        if (w > H_MAX_LINE || smem > H_MAX_SMEM) return (int)cudaErrorInvalidValue;
        int rc = allow_smem(kernel, smem);
        if (rc) return rc;
        kernel<<<n * a.bps, H_THREADS, smem, st>>>(a);
        return (int)cudaGetLastError();
    }
    if ((h + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8, n);
    int rc = 0;
    for (int i = 0; FWD && i < n && !rc; ++i) rc = copy_sub(a, i, (int32_t*)tmp, true, st);
    if (rc) return rc;
    if (FWD)
        dwt53_horz<<<grid, block, 0, st>>>((const int32_t*)tmp, a);
    else
        dwt53_inv_horz<<<grid, block, 0, st>>>((int32_t*)tmp, a);
    rc = (int)cudaGetLastError();
    for (int i = 0; !FWD && i < n && !rc; ++i) rc = copy_sub(a, i, (int32_t*)tmp, false, st);
    return rc;
}

extern "C" int dwt53_fwd_h(const int64_t* planes, int n, int64_t ld, int h, int w, int px,
                           void* tmp, void* stream) {
    return strip_half<true>(planes, n, ld, h, w, px, tmp, (cudaStream_t)stream);
}

extern "C" int dwt53_inv_h(const int64_t* planes, int n, int64_t ld, int h, int w, int px,
                           void* tmp, void* stream) {
    return strip_half<false>(planes, n, ld, h, w, px, tmp, (cudaStream_t)stream);
}
