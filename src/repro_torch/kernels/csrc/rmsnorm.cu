// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` / `rmsnorm` of the reference's
// kernels/rmsnorm.py: per row of x (rows, d), the fp32 mean of squares, then
// x * rsqrt(var + eps) * scale, cast back to x's type.
//
// What bounds it on this card: bytes.  The function reads x once and writes
// the output once (2 * rows * d * sizeof(x)); there are a few operations per
// element, far below the ~295 FLOP/byte where the H100 turns compute-bound.
// The route is chosen in Python (kernels/rmsnorm.py, `rmsnorm_plan`) and
// validated here.  Two kernels:
//
//  * rmsnorm_warp_kernel -- at least as many bf16 rows as the card has SMs,
//    an fp32 scale (the models' norm scales are fp32), 16-byte-aligned
//    addresses (x, out, scale) and a width of at most 24 * 256 (every width
//    of the repo's configs: 384 ... 6144).  One warp per row, four rows per
//    block.  The row stays in registers as 16-byte
//    vectors, VPL per lane (a compile-time count, lanes past the end of the
//    row masked), so device memory sees it once and nothing is parked in
//    shared memory; the sum of squares is reduced by warp shuffles alone,
//    with no block barrier; scale is read as 16-byte vectors, issued with the
//    row's loads so that its round trip (L2) overlaps theirs.
//  * rmsnorm_kernel -- every other row (fp32 x, a bf16 scale, unaligned,
//    wider, or so few rows that one warp each would leave most SMs idle:
//    decode's 8 rows run faster with a whole block per row): one block per
//    row, 16-byte loads and stores where the row allows (else scalar), the
//    row parked in shared memory between the two passes, the sum of squares
//    reduced by warp shuffles plus one shared-memory step.  A row too long
//    for the 40 KB cache is read a second time (it is then still in L2).
//
// Both kernels take the reference's statistics: the squares summed in fp32
// (each in its own order, so a row's mean may differ from the plain
// version's in its last bit), rsqrt(mean + eps) in fp32.
//
// With few rows (decode: 8) the launch itself dominates either kernel.
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

// ---------------------------------------------------------------------------
// bf16 rows held in registers, one warp per row
// ---------------------------------------------------------------------------

constexpr int WARP_ROWS = 4;   // rows (warps) per block

__device__ __forceinline__ void load_scale8(const float* s, float (&f)[8]) {
    const float4 a = reinterpret_cast<const float4*>(s)[0];
    const float4 b = reinterpret_cast<const float4*>(s)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Vector i of lane `lane` is the row's vector lane + 32 i (8 bf16), so the
// lanes of a warp read neighbouring 16-byte pieces.
template <int VPL>
__global__ void __launch_bounds__(32 * WARP_ROWS)
rmsnorm_warp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, long long rows, int d, float eps) {
    const int lane = threadIdx.x % 32;
    const long long row = static_cast<long long>(blockIdx.x) * WARP_ROWS + threadIdx.x / 32;
    if (row >= rows) return;
    const int n_vec = d / 8;
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
    uint4* ov = reinterpret_cast<uint4*>(out + row * d);

    uint4 v[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int j = lane + 32 * i;
        v[i] = j < n_vec ? xv[j] : make_uint4(0u, 0u, 0u, 0u);
    }
    // scale's vectors are loaded with the row's, so the two round trips to
    // memory overlap (up to 16 vectors a lane: 8 VPL registers more)
    constexpr bool kEarlyScale = VPL <= 16;
    float sc[kEarlyScale ? VPL : 1][8];
    if constexpr (kEarlyScale) {
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const int j = lane + 32 * i;
            if (j < n_vec) load_scale8(scale + 8 * j, sc[i]);
        }
    }
    float ss = 0.f;   // masked lanes hold zeros
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float f = __bfloat162float(e[j]);
            ss += f * f;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    // the mean as torch's takes it: the sum times 1/d rounded to fp32
    const float inv = rsqrtf(ss * (1.f / static_cast<float>(d)) + eps);

#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int j = lane + 32 * i;
        if (j < n_vec) {
            if constexpr (!kEarlyScale) load_scale8(scale + 8 * j, sc[0]);
            const float(&si)[8] = sc[kEarlyScale ? i : 0];
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
            uint4 res;
            __nv_bfloat16* r = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
            for (int k = 0; k < 8; ++k) r[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * inv * si[k]);
            ov[j] = res;
        }
    }
}

// Vectors per lane that are built: the widths of the repo's configs in bf16
// (384 -> 2 ... 6144 -> 24); a row takes the smallest count that covers it.
constexpr int VPLS[] = {2, 4, 9, 10, 12, 16, 24};

template <int VPL>
cudaError_t launch_warp(const void* x, const void* scale, void* out, long long rows, int d,
                        float eps, cudaStream_t stream) {
    const long long blocks = (rows + WARP_ROWS - 1) / WARP_ROWS;
    rmsnorm_warp_kernel<VPL><<<static_cast<unsigned>(blocks), 32 * WARP_ROWS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), rows, d, eps);
    return cudaGetLastError();
}

cudaError_t dispatch_warp(int vpl, const void* x, const void* scale, void* out, long long rows,
                          int d, float eps, cudaStream_t stream) {
    switch (vpl) {
        case 2: return launch_warp<2>(x, scale, out, rows, d, eps, stream);
        case 4: return launch_warp<4>(x, scale, out, rows, d, eps, stream);
        case 9: return launch_warp<9>(x, scale, out, rows, d, eps, stream);
        case 10: return launch_warp<10>(x, scale, out, rows, d, eps, stream);
        case 12: return launch_warp<12>(x, scale, out, rows, d, eps, stream);
        case 16: return launch_warp<16>(x, scale, out, rows, d, eps, stream);
        case 24: return launch_warp<24>(x, scale, out, rows, d, eps, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The register route's rule, checked again on the plan it is given.
bool warp_route_ok(const void* x, const void* scale, const void* out, int d, int vpl) {
    int covering = 0;   // the smallest built count that covers the row
    for (int v : VPLS)
        if (covering == 0 && 256 * v >= d) covering = v;
    return covering == vpl && d % 8 == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(scale) % 16 == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  route: 0 = block per row, 1 = warp
// per row with `vpl` 16-byte vectors per lane (bf16 x, fp32 scale only).
// Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int x_dtype,
                           int scale_dtype, long long rows, int d, float eps, int route, int vpl,
                           void* stream) {
    if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        if (x_dtype != 1 || scale_dtype != 0 || !warp_route_ok(x, scale, out, d, vpl) ||
            (rows + WARP_ROWS - 1) / WARP_ROWS > 2147483647LL)
            return static_cast<int>(cudaErrorInvalidValue);
        return static_cast<int>(dispatch_warp(vpl, x, scale, out, rows, d, eps, s));
    }
    if (route != 0 || rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
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
