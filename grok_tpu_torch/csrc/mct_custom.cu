// K-r dc_mct_fwd and K-s mct_inv_round_clip: the Part-2 array-based
// multiple component transform (T.801 Annex J), forward with the DC level
// shift, inverse with the offsets, rounding and each component's clip.
//
// Replaces: the mct == 2 branches of grok_tpu/ops/jax_pipeline.py
// make_forward_fn (:70-79) and make_inverse_fn (:192-197, with the finish
// :206-217), each an [N, N] float32 matmul over the component axis; held to
// the reference's default host path, tile/tile_processor.py:327-337 (encode)
// and :1599-1602 with :1636-1650 (decode), which compute it as numpy's
// float32 `matrix @ flat` (ops/mct.py:83-89). That product is a sequential
// fused multiply-add chain in k = 0..N-1 in every output, so each output
// here is __fmul_rn(m[o][0], x_0), then __fmaf_rn(m[o][k], x_k, acc) for
// k = 1..N-1: explicit fused operations, which -fmad=false leaves alone
// (the ICT kernels K-j and K-o must not fuse; this one must). The finish of
// K-s is native/pipeline.cpp finish_irrev (:597-611): floor(v + add) with
// add = float32(0.5 + offset), the clip in float before the cast, NaN to
// the low end.
//
// Bound on an H100 (3.35 TB/s): bytes. N int32 (K-r) or float32 (K-s)
// planes in and N planes out, 8N bytes a pixel: 3840x2160x3 moves 199 MB,
// 0.06 ms; the 2N^2 float operations a pixel stay far below the FP32 rate
// for any N the codestream allows.
//
// Parameters: a launch's plane addresses and per-component constants
// travel by value in the kernel's parameters (MctArgs, __grid_constant__:
// read in place, never copied per thread), so a call makes no copy to the
// card and needs no scratch; the matrix is a device array the wrapper
// uploads once per distinct matrix (transform._mct_matrix). N is at most
// MAX_COMPS, the reference's own limit (one MCT marker segment holds at
// most 127 x 127 float32 elements), which keeps MctArgs under the 4 KB of
// a launch's parameters.
//
// K-r: a thread takes a quad, 4 consecutive samples of every plane, at a
// time (a grid-stride loop over the quads). Quads start at the samples
// 4k - shift, where shift puts out[0]'s quads on 16-byte boundaries; where
// every plane has out[0]'s address modulo 16 (vec), a quad wholly inside
// the planes is read from each input once with a 16-byte load and written
// to each output with a 16-byte store, else (a partial quad at either end,
// or planes at other alignments) sample by sample. For N up to MAX_REG the
// kernel is instantiated for its N: the N x 4 inputs and the N x N matrix
// sit in registers (the matrix read once a thread); a larger N re-reads
// each input quad and the matrix row from L1 for every output. K-s keeps
// its sample a thread, each output re-reading the pixel's inputs. Where a
// kernel indexes the per-component parameters by a loop variable (K-s, K-r
// past MAX_REG), a block first copies them to shared memory (MctShared).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_COMPS 127  // components a launch (transform.MCT_MAX_COMPS)
#define MAX_REG 8      // K-r's largest N with its inputs and matrix in registers
#define THREADS 256

struct MctArgs {
    const void* in[MAX_COMPS];  // the input planes (K-r int32, K-s float32)
    void* out[MAX_COMPS];       // the output planes (K-r float32, K-s int32)
    const float* m;             // the [N, N] matrix, row-major, on the card
    union {
        int32_t dc[MAX_COMPS];  // K-r: each input's DC level shift
        float add[MAX_COMPS];   // K-s: float32(0.5 + offset) of each output
    };
    int32_t lo[MAX_COMPS], hi[MAX_COMPS];  // K-s: each output's range
    long long n;                           // samples a plane
    int N;
    int shift;  // (out[0] / 4) mod 4: quads start at the samples 4k - shift
    int vec;    // every plane has out[0]'s address modulo 16
};

// a block's copy of a launch's per-component parameters, for the kernels
// that index them by a loop variable (K-s, and K-r past MAX_REG): read
// through a generic pointer into the parameters, each would be reloaded
// after every store to a plane, which the compiler must assume may alias
// it (K-s ran 3.2x slower so, PERF.md §6); from shared memory they are not
struct MctShared {
    const void* in[MAX_COMPS];
    void* out[MAX_COMPS];
    int32_t k0[MAX_COMPS];  // K-r: dc; K-s: add's bits
    int32_t lo[MAX_COMPS], hi[MAX_COMPS];
};

__device__ __forceinline__ void stage(const MctArgs& a, MctShared& s) {
    for (int k = threadIdx.x; k < a.N; k += blockDim.x) {
        s.in[k] = a.in[k];
        s.out[k] = a.out[k];
        s.k0[k] = a.dc[k];
        s.lo[k] = a.lo[k];
        s.hi[k] = a.hi[k];
    }
    __syncthreads();
}

__device__ __forceinline__ int32_t finish(float v, float add, int lo, int hi) {
    float f = floorf(__fadd_rn(v, add));
    if (!(f > (float)lo)) f = (float)lo;
    if (f > (float)hi) f = (float)hi;
    return (int32_t)f;
}

// the quad of samples i0 .. i0 + 3 of an int32 input plane, less its DC
// shift, as floats (0 outside the plane's n samples)
__device__ __forceinline__ void load_quad(const void* plane, int32_t dc, int64_t n, int64_t i0,
                                          bool whole, float (&x)[4]) {
    const int32_t* p = (const int32_t*)plane + i0;
    if (whole) {
        const uint4 v = __ldg((const uint4*)p);
        x[0] = (float)((int32_t)v.x - dc);
        x[1] = (float)((int32_t)v.y - dc);
        x[2] = (float)((int32_t)v.z - dc);
        x[3] = (float)((int32_t)v.w - dc);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            x[j] = i0 + j >= 0 && i0 + j < n ? (float)(__ldg(p + j) - dc) : 0.0f;
    }
}

__device__ __forceinline__ void store_quad(void* plane, int64_t n, int64_t i0, bool whole,
                                           const float (&y)[4]) {
    float* p = (float*)plane + i0;
    if (whole) {
        __stwb((uint4*)p, make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]),
                                     __float_as_uint(y[2]), __float_as_uint(y[3])));
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (i0 + j >= 0 && i0 + j < n) p[j] = y[j];
    }
}

// K-r, NT = N for N up to MAX_REG, 0 for any N
template <int NT>
__global__ void __launch_bounds__(THREADS) mct_fwd(const __grid_constant__ MctArgs a) {
    static __shared__ MctShared s;
    const int N = NT ? NT : a.N;
    float m[NT ? NT : 1][NT ? NT : 1];
    if (!NT) stage(a, s);
    if (NT) {
#pragma unroll
        for (int o = 0; o < (NT ? NT : 1); ++o)
#pragma unroll
            for (int k = 0; k < (NT ? NT : 1); ++k) m[o][k] = __ldg(a.m + o * N + k);
    }
    const int64_t nq = (a.n + a.shift + 3) >> 2;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < nq; q += stride) {
        const int64_t i0 = 4 * q - a.shift;
        const bool whole = a.vec && i0 >= 0 && i0 + 4 <= a.n;
        if (NT) {
            float x[NT ? NT : 1][4];
#pragma unroll
            for (int k = 0; k < (NT ? NT : 1); ++k)
                load_quad(a.in[k], a.dc[k], a.n, i0, whole, x[k]);
#pragma unroll
            for (int o = 0; o < (NT ? NT : 1); ++o) {
                float y[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    y[j] = __fmul_rn(m[o][0], x[0][j]);
#pragma unroll
                    for (int k = 1; k < (NT ? NT : 1); ++k)
                        y[j] = __fmaf_rn(m[o][k], x[k][j], y[j]);
                }
                store_quad(a.out[o], a.n, i0, whole, y);
            }
        } else {
            for (int o = 0; o < N; ++o) {
                const float* row = a.m + o * N;
                float x[4], y[4];
                load_quad(s.in[0], s.k0[0], a.n, i0, whole, x);
                const float m0 = __ldg(row);
#pragma unroll
                for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(m0, x[j]);
                for (int k = 1; k < N; ++k) {
                    load_quad(s.in[k], s.k0[k], a.n, i0, whole, x);
                    const float mk = __ldg(row + k);
#pragma unroll
                    for (int j = 0; j < 4; ++j) y[j] = __fmaf_rn(mk, x[j], y[j]);
                }
                store_quad(s.out[o], a.n, i0, whole, y);
            }
        }
    }
}

// K-s
__global__ void __launch_bounds__(THREADS) mct_inv(const __grid_constant__ MctArgs a) {
    static __shared__ MctShared s;
    stage(a, s);
    const int N = a.N;
    const float* __restrict__ m = a.m;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
        for (int o = 0; o < N; ++o) {
            const float* row = m + o * N;
            float acc = __fmul_rn(__ldg(row), ((const float*)s.in[0])[i]);
            for (int k = 1; k < N; ++k)
                acc = __fmaf_rn(__ldg(row + k), ((const float*)s.in[k])[i], acc);
            ((int32_t*)s.out[o])[i] = finish(acc, __int_as_float(s.k0[o]), s.lo[o], s.hi[o]);
        }
    }
}

// blocks of a grid-stride launch over `items`
static unsigned grid_for(int64_t items) {
    int64_t blocks = (items + THREADS - 1) / THREADS;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)blocks;
}

// The launch's parameters: ptrs, host int64 [2N], the N input planes'
// addresses and then the N output planes'; m, the device matrix; per, the
// nper host arrays of N 4-byte constants (K-r: dc; K-s: add, lo, hi); n
// samples a plane. Returns -1 for N out of range.
static int make_args(MctArgs& a, const int64_t* ptrs, const float* m, const void* const* per,
                     int nper, int64_t n, int N) {
    if (N < 1 || N > MAX_COMPS) return -1;
    memset(&a, 0, sizeof(a));
    const uint64_t base = (uint64_t)ptrs[N];
    a.vec = 1;
    for (int k = 0; k < N; ++k) {
        a.in[k] = (const void*)ptrs[k];
        a.out[k] = (void*)ptrs[N + k];
        a.vec &= (((uint64_t)ptrs[k] ^ base) & 15) == 0 &&
                 (((uint64_t)ptrs[N + k] ^ base) & 15) == 0;
    }
    a.m = m;
    int32_t* dst[3] = {a.dc, a.lo, a.hi};
    for (int j = 0; j < nper; ++j) memcpy(dst[j], per[j], 4 * (size_t)N);
    a.n = n;
    a.N = N;
    a.shift = (int)((base >> 2) & 3);
    return 0;
}

static_assert(sizeof(MctArgs) <= 4096, "a launch's parameters hold at most 4 KB");

static int launch(bool fwd, const int64_t* ptrs, const float* m, const void* const* per,
                  int nper, int64_t n, int N, void* stream) {
    MctArgs a;
    if (make_args(a, ptrs, m, per, nper, n, N)) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (!fwd) {
        mct_inv<<<grid_for(n), THREADS, 0, st>>>(a);
        return (int)cudaGetLastError();
    }
    const unsigned grid = grid_for((n + a.shift + 3) / 4);
    switch (N) {
        case 1: mct_fwd<1><<<grid, THREADS, 0, st>>>(a); break;
        case 2: mct_fwd<2><<<grid, THREADS, 0, st>>>(a); break;
        case 3: mct_fwd<3><<<grid, THREADS, 0, st>>>(a); break;
        case 4: mct_fwd<4><<<grid, THREADS, 0, st>>>(a); break;
        case 5: mct_fwd<5><<<grid, THREADS, 0, st>>>(a); break;
        case 6: mct_fwd<6><<<grid, THREADS, 0, st>>>(a); break;
        case 7: mct_fwd<7><<<grid, THREADS, 0, st>>>(a); break;
        case 8: mct_fwd<8><<<grid, THREADS, 0, st>>>(a); break;
        default: mct_fwd<0><<<grid, THREADS, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

// K-r's registers and blocks an SM at N (templated up to MAX_REG), for the
// check line
extern "C" int dc_mct_fwd_occupancy(int N, int* threads, int* regs, int* blocks) {
    const void* fns[MAX_REG + 1] = {(const void*)mct_fwd<0>, (const void*)mct_fwd<1>,
                                    (const void*)mct_fwd<2>, (const void*)mct_fwd<3>,
                                    (const void*)mct_fwd<4>, (const void*)mct_fwd<5>,
                                    (const void*)mct_fwd<6>, (const void*)mct_fwd<7>,
                                    (const void*)mct_fwd<8>};
    const void* fn = fns[N >= 1 && N <= MAX_REG ? N : 0];
    cudaFuncAttributes attr;
    int rc = (int)cudaFuncGetAttributes(&attr, fn);
    if (rc) return rc;
    *threads = THREADS;
    *regs = attr.numRegs;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, 0);
}

// ptrs: host int64 [2N], the N int32 input planes' addresses, then the N
// float32 output planes' (n samples each); m: the device float32 [N, N]
// row-major encoding matrix; dc: host int32 [N] DC level shifts.
extern "C" int dc_mct_fwd(const int64_t* ptrs, const float* m, const int32_t* dc, int64_t n,
                          int N, void* stream) {
    const void* per[1] = {dc};
    return launch(true, ptrs, m, per, 1, n, N, stream);
}

// ptrs: host int64 [2N], the N float32 input planes' addresses, then the N
// int32 output planes'; m: the device float32 [N, N] row-major decoding
// matrix; add: host float32 [N]; lo, hi: host int32 [N] each component's
// range.
extern "C" int mct_inv_round_clip(const int64_t* ptrs, const float* m, const float* add,
                                  const int32_t* lo, const int32_t* hi, int64_t n, int N,
                                  void* stream) {
    const void* per[3] = {add, lo, hi};
    return launch(false, ptrs, m, per, 3, n, N, stream);
}
