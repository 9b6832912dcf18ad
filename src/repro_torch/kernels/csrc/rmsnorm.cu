// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` / `rmsnorm` of the reference's
// kernels/rmsnorm.py: per row of x (rows, d), the fp32 mean of squares, then
// x * rsqrt(var + eps) * scale, cast back to x's type.
//
// What bounds it on this card: bytes.  The function reads x once and writes
// the output once (2 * rows * d * sizeof(x)); there are three operations per
// element, far below the ~295 FLOP/byte where the H100 turns compute-bound.
// What the design does about it: one block per row, 16-byte loads and stores
// with neighbouring threads on neighbouring addresses, the row parked in
// shared memory between the two passes so device memory sees it once, and the
// sum of squares reduced in fp32 by warp shuffles plus one small shared-memory
// step.  A row too long for the 40 KB cache is read a second time (it is then
// still in L2).  With few rows (decode: 8) the launch itself dominates.
//
// Plain C interface; the caller passes device pointers and the CUDA stream.
// The kernel does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRowCacheBytes = 40 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    float total = lane < n_warps ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
    return total;
}

// VEC elements of T fill one 16-byte load; VEC == 1 is the scalar path for
// rows whose length or address is not 16-byte aligned.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               int d, float eps, int use_cache) {
    extern __shared__ __align__(16) unsigned char row_cache_raw[];
    __shared__ float warp_sums[32];
    T* row_cache = reinterpret_cast<T*>(row_cache_raw);

    const int64_t row = blockIdx.x;
    const T* xr = x + row * d;
    T* outr = out + row * d;
    const int tid = threadIdx.x, nt = blockDim.x;

    float ss = 0.f;
    if (VEC > 1) {
        const int n_vec = d / VEC;
        const uint4* xv = reinterpret_cast<const uint4*>(xr);
        uint4* cv = reinterpret_cast<uint4*>(row_cache);
        for (int i = tid; i < n_vec; i += nt) {
            uint4 raw = xv[i];
            if (use_cache) cv[i] = raw;
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                float f = to_f32(e[j]);
                ss += f * f;
            }
        }
    } else {
        for (int i = tid; i < d; i += nt) {
            T raw = xr[i];
            if (use_cache) row_cache[i] = raw;
            float f = to_f32(raw);
            ss += f * f;
        }
    }
    // block_sum's barrier also makes the cached row visible to every thread
    const float total = block_sum(ss, warp_sums);
    const float inv = rsqrtf(total / static_cast<float>(d) + eps);

    const T* src = use_cache ? row_cache : xr;
    if (VEC > 1) {
        const int n_vec = d / VEC;
        const uint4* sv = reinterpret_cast<const uint4*>(src);
        uint4* ov = reinterpret_cast<uint4*>(outr);
        for (int i = tid; i < n_vec; i += nt) {
            uint4 raw = sv[i];
            uint4 res;
            const T* e = reinterpret_cast<const T*>(&raw);
            T* r = reinterpret_cast<T*>(&res);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                r[j] = from_f32<T>(to_f32(e[j]) * inv * to_f32(scale[i * VEC + j]));
            }
            ov[i] = res;
        }
    } else {
        for (int i = tid; i < d; i += nt) {
            outr[i] = from_f32<T>(to_f32(src[i]) * inv * to_f32(scale[i]));
        }
    }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int64_t rows, int d,
                   float eps, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool aligned = d % VEC == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int per_thread = aligned ? VEC : 1;
    int threads = (d + per_thread - 1) / per_thread;
    threads = ((threads + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
    const int use_cache = row_bytes <= static_cast<size_t>(kRowCacheBytes);
    const size_t smem = use_cache ? ((row_bytes + 15) / 16) * 16 : 0;
    const dim3 grid(static_cast<unsigned>(rows));
    if (aligned) {
        rmsnorm_kernel<T, S, VEC><<<grid, threads, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
            d, eps, use_cache);
    } else {
        rmsnorm_kernel<T, S, 1><<<grid, threads, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
            d, eps, use_cache);
    }
    return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int x_dtype,
                           int scale_dtype, long long rows, int d, float eps, void* stream) {
    if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (x_dtype == 0 && scale_dtype == 0) {
        err = launch<float, float>(x, scale, out, rows, d, eps, s);
    } else if (x_dtype == 0 && scale_dtype == 1) {
        err = launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
    } else if (x_dtype == 1 && scale_dtype == 0) {
        err = launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
    } else if (x_dtype == 1 && scale_dtype == 1) {
        err = launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
    }
    return static_cast<int>(err);
}
