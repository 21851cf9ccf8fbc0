// K-u strip53_step / strip97_step and K-v strip_pack_v / strip_unpack_v:
// the vertical half of one level of the Y-sharded strip wavelet, on one
// shard's top-left h x w sub-block (rows ld apart), in place.
//
// Replaces: K6, grok_tpu/parallel/mesh.py _fwd53_v_sharded (:65),
// _inv53_v_sharded (:93), _fwd97_v_sharded (:146) and _inv97_v_sharded
// (:177), whose one-row halos ride jax.lax.ppermute (_halo_from_next :36,
// _halo_from_prev :45), and their concatenate / .at[0::2].set packing.
//
// Bound on an H100 (3.35 TB/s): bytes. A lifting step reads the half of the
// rows it updates and the other half once (a row of the other phase feeds two
// targets, which the L2 serves) and writes the half it updates: 12 bytes per
// target sample. The packing has its own note below.
//
// Design. The rows stay interleaved while the steps run, as x[0::2] (s) and
// x[1::2] (d) at mesh.py:71-72: the reference packs at the end, and a row
// permutation commutes with the elementwise steps, so the values are the
// same. One thread a target sample; the target phase is never read by its
// own step, so the step works in place without synchronisation. The row past
// the sub-block's edge comes from the one-row halo buffer (the neighbouring
// shard's row, copied there by the caller before the step), or, at the edge
// of the mesh (a null halo), from the clamp to the shard's own row: the
// symmetric extension of mesh.py:79, :87. The kernels never read a
// neighbour's shard directly, so the copy path of several cards is the path
// of one. The 5/3 steps are int32 with arithmetic shifts; the 9/7 steps
// compute x +- c * (a + b) as the sum, then the product, then the add or
// subtract, each rounded on its own (__fadd_rn/__fmul_rn/__fsub_rn, built
// with -fmad=false): numpy's float32 order with a weak Python scalar, so the
// strip equals grok_tpu/ops/dwt.py forward bit for bit through the layout
// bridge.

#include <cuda_runtime.h>
#include <stdint.h>

// the constants of native/pipeline.cpp:28-33 (as in dwt97.cu)
#define K97 ((float)1.230174104914001)
#define IK97 ((float)(1.0 / 1.230174104914001))

// the row a step reads at interleaved index r of a sub-block of h rows:
// inside, the shard's own row; past the bottom or the top, the halo, or
// (null halo) the clamped row of the same phase
template <typename T>
__device__ __forceinline__ T nbr(const T* plane, int64_t ld, int h, int r, int x,
                                 const T* halo, int clamp_row) {
    if (r >= 0 && r < h) return plane[(int64_t)r * ld + x];
    return halo ? halo[x] : plane[(int64_t)clamp_row * ld + x];
}

// update = 0: predict, the odd rows d[j] (row 2j + 1) from s[j] (row 2j) and
// s[j + 1] (row 2j + 2; past the bottom the next shard's first s row, or
// the clamp to s[j]); update = 1: the even rows s[i] (row 2i) from d[i - 1]
// (row 2i - 1; past the top the previous shard's last d row, or the clamp to
// d[0] = row 1) and d[i] (row 2i + 1)
__global__ void step53(int32_t* plane, int64_t ld, int h, int w, const int32_t* halo,
                       int update, int inverse) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int t = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || t >= h / 2) return;
    if (!update) {
        const int32_t a = plane[(int64_t)(2 * t) * ld + x];
        const int32_t b = nbr(plane, ld, h, 2 * t + 2, x, halo, 2 * t);
        int32_t& d = plane[(int64_t)(2 * t + 1) * ld + x];
        const int32_t p = (a + b) >> 1;
        d = inverse ? d + p : d - p;
    } else {
        const int32_t a = nbr(plane, ld, h, 2 * t - 1, x, halo, 1);
        const int32_t b = plane[(int64_t)(2 * t + 1) * ld + x];
        int32_t& s = plane[(int64_t)(2 * t) * ld + x];
        const int32_t p = (a + b + 2) >> 2;
        s = inverse ? s - p : s + p;
    }
}

__global__ void step97(float* plane, int64_t ld, int h, int w, const float* halo,
                       int update, float c, int inverse) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int t = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || t >= h / 2) return;
    float a, b;
    float* tgt;
    if (!update) {
        a = plane[(int64_t)(2 * t) * ld + x];
        b = nbr(plane, ld, h, 2 * t + 2, x, halo, 2 * t);
        tgt = &plane[(int64_t)(2 * t + 1) * ld + x];
    } else {
        a = nbr(plane, ld, h, 2 * t - 1, x, halo, 1);
        b = plane[(int64_t)(2 * t + 1) * ld + x];
        tgt = &plane[(int64_t)(2 * t) * ld + x];
    }
    const float p = __fmul_rn(c, __fadd_rn(a, b));
    *tgt = inverse ? __fsub_rn(*tgt, p) : __fadd_rn(*tgt, p);
}

static dim3 grid_of(int h, int w, dim3 block) {
    return dim3((w + block.x - 1) / block.x, (h / 2 + block.y - 1) / block.y);
}

// plane: int32, row stride ld; the sub-block is its top-left h x w, h even;
// halo: w int32 or null (an edge of the mesh)
extern "C" int strip53_step(void* plane, void* halo, int64_t ld, int h, int w, int update,
                            int inverse, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    const dim3 block(32, 8);
    step53<<<grid_of(h, w, block), block, 0, (cudaStream_t)stream>>>(
        (int32_t*)plane, ld, h, w, (const int32_t*)halo, update, inverse);
    return (int)cudaGetLastError();
}

// the same on a float32 plane: x += c * (a + b), or with inverse x -= c * (a + b)
extern "C" int strip97_step(void* plane, void* halo, int64_t ld, int h, int w, int update,
                            float c, int inverse, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    const dim3 block(32, 8);
    step97<<<grid_of(h, w, block), block, 0, (cudaStream_t)stream>>>(
        (float*)plane, ld, h, w, (const float*)halo, update, c, inverse);
    return (int)cudaGetLastError();
}

// ---- K-v: the packing
//
// Replaces the reference's [s | d] packing (mesh.py:90; 9/7 :172-174,
// s * 1/K and d * K) and its unpacking through .at[0::2] / .at[1::2]
// (:110-114, :181-203): a permutation of the sub-block's rows, the low half
// scaled by 1/K and the high half by K on the way in (9/7, float32 bits),
// by K and 1/K on the way out; the 5/3 int32 bits move as they are.
//
// Bound on an H100 (3.35 TB/s): bytes. Each sample read once and written
// once, 8 bytes a sample: a 1024x4096 sub-block moves 34 MB, 0.0100 ms.
//
// Design. The permutation moves samples only within a column, so one block
// owns a column band of the sub-block (BAND columns, all h rows): it stages
// the band in shared memory with cp.async (16-byte copies where the base and
// ld keep every row's band 16-byte aligned, else 4-byte ones), waits, and
// writes each row to its packed or unpacked row in place, applying the 9/7
// scale with one __fmul_rn on the store. One read and one write of each
// sample, one launch, no scratch. The form rule (parallel/ops.py pack_form):
// h rows x BAND x 4 bytes must fit the 227 KB a block can have; a sub-block
// taller than that at 8 columns (7,264 rows) takes the two-pass form,
// pack_v into a compact scratch and a 2-D copy back, which no path of the
// port reaches today (the tallest K-v launch is a shard's 1,024 rows).

#define PACK_THREADS 256
#define SMEM_MAX 232448  // the shared memory one block can have on Hopper

// the row read for row r written, and its 9/7 factor: pack writes s (rows
// 2i) then d (rows 2j + 1); unpack interleaves them back
__device__ __forceinline__ int src_row(int r, int half, int unpack) {
    if (!unpack) return r < half ? 2 * r : 2 * (r - half) + 1;
    return (r & 1) ? half + (r >> 1) : r >> 1;
}

__device__ __forceinline__ float row_factor(int r, int half, int unpack) {
    const bool low = unpack ? (r & 1) == 0 : r < half;
    return low != (bool)unpack ? IK97 : K97;
}

__device__ __forceinline__ uint32_t scaled(uint32_t v, float k) {
    return __float_as_uint(__fmul_rn(__uint_as_float(v), k));
}

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// one block a column band; VEC: 16-byte copies (the band's rows 16-byte
// aligned), the ragged last band's odd columns 4 bytes at a time
template <int BAND, bool VEC>
__global__ void __launch_bounds__(PACK_THREADS)
    pack_band(uint32_t* __restrict__ plane, int64_t ld, int h, int w, int unpack, int scale) {
    extern __shared__ __align__(16) uint32_t band[];  // h rows of BAND samples
    constexpr int UNIT = VEC ? 4 : 1;                  // samples a copy
    constexpr int UNITS = BAND / UNIT;                 // copies a row
    const int c0 = blockIdx.x * BAND;
    const int wb = min(BAND, w - c0);
    const int half = h >> 1;
    uint32_t* base = plane + c0;
    for (int i = threadIdx.x; i < h * UNITS; i += PACK_THREADS) {
        const int r = i / UNITS, c = (i % UNITS) * UNIT;
        const uint32_t* g = base + (int64_t)r * ld + c;
        uint32_t* s = band + r * BAND + c;
        if (c + UNIT <= wb) {
            if (VEC) cp_async16(s, g);
            else cp_async4(s, g);
        } else {
            for (int k = c; k < wb; ++k) cp_async4(s + k - c, g + k - c);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int i = threadIdx.x; i < h * UNITS; i += PACK_THREADS) {
        const int r = i / UNITS, c = (i % UNITS) * UNIT;
        const uint32_t* s = band + src_row(r, half, unpack) * BAND + c;
        uint32_t* g = base + (int64_t)r * ld + c;
        const float k = row_factor(r, half, unpack);
        if (VEC && c + UNIT <= wb) {
            uint4 v = *reinterpret_cast<const uint4*>(s);
            if (scale) v = make_uint4(scaled(v.x, k), scaled(v.y, k), scaled(v.z, k),
                                      scaled(v.w, k));
            *reinterpret_cast<uint4*>(g) = v;
        } else {
            for (int j = 0; j < UNIT && c + j < wb; ++j) g[j] = scale ? scaled(s[j], k) : s[j];
        }
    }
}

template <int BAND, bool VEC>
static int band_run(uint32_t* plane, int64_t ld, int h, int w, int unpack, int scale,
                    cudaStream_t st) {
    const size_t smem = (size_t)h * BAND * 4;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pack_band<BAND, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    pack_band<BAND, VEC><<<(w + BAND - 1) / BAND, PACK_THREADS, smem, st>>>(plane, ld, h, w,
                                                                          unpack, scale);
    return (int)cudaGetLastError();
}

template <int BAND>
static int band_form(void* plane, int64_t ld, int h, int w, int unpack, int scale,
                     cudaStream_t st) {
    const bool vec = ((uintptr_t)plane & 15) == 0 && (ld & 3) == 0;
    return vec ? band_run<BAND, true>((uint32_t*)plane, ld, h, w, unpack, scale, st)
               : band_run<BAND, false>((uint32_t*)plane, ld, h, w, unpack, scale, st);
}

// the two-pass form: interleaved rows of plane -> tmp [s | d] (compact
// h x w), or [s | d] -> tmp interleaved, then tmp copied back
__global__ void pack_v(const uint32_t* plane, uint32_t* tmp, int64_t ld, int h, int w,
                       int unpack, int scale) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y * blockDim.y + threadIdx.y;  // the row written
    if (x >= w || r >= h) return;
    const int half = h / 2;
    const uint32_t v = plane[(int64_t)src_row(r, half, unpack) * ld + x];
    tmp[(int64_t)r * w + x] = scale ? scaled(v, row_factor(r, half, unpack)) : v;
}

static int pack_run(void* plane, void* tmp, int64_t ld, int h, int w, int scale, int band,
                    int unpack, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (band) {
        if ((size_t)h * band * 4 > SMEM_MAX) return (int)cudaErrorInvalidValue;
        switch (band) {
            case 8: return band_form<8>(plane, ld, h, w, unpack, scale, st);
            case 16: return band_form<16>(plane, ld, h, w, unpack, scale, st);
            case 32: return band_form<32>(plane, ld, h, w, unpack, scale, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (!tmp) return (int)cudaErrorInvalidValue;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    pack_v<<<grid, block, 0, st>>>((const uint32_t*)plane, (uint32_t*)tmp, ld, h, w, unpack,
                                   scale);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
    return (int)cudaMemcpy2DAsync(plane, (size_t)ld * 4, tmp, (size_t)w * 4, (size_t)w * 4,
                                  (size_t)h, cudaMemcpyDeviceToDevice, st);
}

// plane: 4-byte samples, row stride ld, the sub-block its top-left h x w (h
// even); band 8, 16 or 32: the one-pass form with that column band (tmp
// unused); band 0: the two-pass form through tmp, >= h*w samples of scratch
extern "C" int strip_pack_v(void* plane, void* tmp, int64_t ld, int h, int w, int scale,
                            int band, void* stream) {
    return pack_run(plane, tmp, ld, h, w, scale, band, 0, stream);
}

extern "C" int strip_unpack_v(void* plane, void* tmp, int64_t ld, int h, int w, int scale,
                              int band, void* stream) {
    return pack_run(plane, tmp, ld, h, w, scale, band, 1, stream);
}
