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
// target sample; a pack or unpack reads and writes every sample once through
// a scratch copy, 16 bytes per sample.
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

// pack: interleaved rows of plane -> tmp [s | d] (compact h x w); unpack:
// plane [s | d] -> tmp interleaved. With scale (9/7, float32 bits) the low
// half is multiplied by 1/K and the high half by K on the way in (pack), or
// by K and 1/K (unpack), one rounding each (mesh.py:172-173, :182-183);
// without (5/3, int32) the bits move as they are.
__global__ void pack_v(const uint32_t* plane, uint32_t* tmp, int64_t ld, int h, int w,
                       int unpack, int scale) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y * blockDim.y + threadIdx.y;  // the row written
    if (x >= w || r >= h) return;
    const int half = h / 2;
    int src;
    bool low;
    if (!unpack) {
        low = r < half;
        src = low ? 2 * r : 2 * (r - half) + 1;
    } else {
        low = (r & 1) == 0;
        src = low ? r >> 1 : half + (r >> 1);
    }
    uint32_t v = plane[(int64_t)src * ld + x];
    if (scale) {
        const float f = __uint_as_float(v);
        const float k = (low != (bool)unpack) ? IK97 : K97;
        v = __float_as_uint(__fmul_rn(f, k));
    }
    tmp[(int64_t)r * w + x] = v;
}

static int pack_run(void* plane, void* tmp, int64_t ld, int h, int w, int unpack, int scale,
                    void* stream) {
    if (h <= 0 || w <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 block(32, 8);
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    pack_v<<<grid, block, 0, st>>>((const uint32_t*)plane, (uint32_t*)tmp, ld, h, w, unpack,
                                   scale);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    return (int)cudaMemcpy2DAsync(plane, (size_t)ld * 4, tmp, (size_t)w * 4, (size_t)w * 4,
                                  (size_t)h, cudaMemcpyDeviceToDevice, st);
}

// plane: 4-byte samples, row stride ld; tmp: >= h*w samples of scratch
extern "C" int strip_pack_v(void* plane, void* tmp, int64_t ld, int h, int w, int scale,
                            void* stream) {
    return pack_run(plane, tmp, ld, h, w, 0, scale, stream);
}

extern "C" int strip_unpack_v(void* plane, void* tmp, int64_t ld, int h, int w, int scale,
                              void* stream) {
    return pack_run(plane, tmp, ld, h, w, 1, scale, stream);
}
