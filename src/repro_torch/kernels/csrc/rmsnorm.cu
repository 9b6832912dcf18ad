// Fused RMSNorm forward and backward for Hopper (sm_90a).
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

// ---------------------------------------------------------------------------
// Backward (training): dx and dscale
// ---------------------------------------------------------------------------
//
// The TPU kernel has no backward (the reference differentiates its plain jnp
// RMSNorm), so this is the port's own.  With r = rsqrt(mean(x^2) + eps) and
// g = dy * scale, per row: dx = r g - x r^3 mean(g x); dscale = sum over rows
// of dy x r.  Bound by bytes, as the forward: x and dy read, dx written.
//
//  * Each row recomputes r in fp32 from x, with the forward kernel of the same
//    route's threads, vectors and reductions, so in the forward's summation
//    order (the wrapper takes the route by the forward's rule).
//  * dscale is reduced in two passes with no atomics, so it is deterministic:
//    a fixed grid of blocks walks the rows (block b takes rows b, b + grid,
//    ...), each keeping its columns' partial sums in fp32 in shared memory
//    (a thread, or on the warp route a warp, adds only into columns it owns)
//    and writing one row of a (blocks, d) workspace; then
//    rmsnorm_dscale_kernel sums each column over the blocks in order.

// Sum of two values over the block (the order of block_sum for each); every
// thread gets both totals.  The caller syncs before the next call.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* warp_sums) {
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = make_float2(a, b);
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    float2 t = lane < n_warps ? warp_sums[lane] : make_float2(0.f, 0.f);
    for (int o = 16; o > 0; o >>= 1) {
        t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
        t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
    }
    return t;
}

// VEC elements of T from vector i of p (one 16-byte load, or a scalar), as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, int i, float (&f)[VEC]) {
    if constexpr (VEC > 1) {
        const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = to_f32(e[j]);
    } else {
        f[0] = to_f32(p[i]);
    }
}

// Block route: the forward's rmsnorm_kernel, with the same blockDim and VEC.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partials, long long rows, int d,
                   float eps) {
    extern __shared__ float dscale_acc[];   // d floats; a thread touches only its own columns
    __shared__ float2 warp_sums[32];
    const int tid = threadIdx.x, nt = blockDim.x;
    const int n_vec = d / VEC;
    for (int i = tid; i < n_vec; i += nt)
#pragma unroll
        for (int j = 0; j < VEC; ++j) dscale_acc[i * VEC + j] = 0.f;

    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
        const T* xr = x + row * d;
        const T* dyr = dy + row * d;
        T* dxr = dx + row * d;
        float ss = 0.f, gx = 0.f;
        for (int i = tid; i < n_vec; i += nt) {
            float xf[VEC], df[VEC];
            load_f32<T, VEC>(xr, i, xf);
            load_f32<T, VEC>(dyr, i, df);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                ss += xf[j] * xf[j];
                gx += df[j] * to_f32(scale[i * VEC + j]) * xf[j];
            }
        }
        const float2 tot = block_sum2(ss, gx, warp_sums);
        const float inv = rsqrtf(tot.x / static_cast<float>(d) + eps);
        const float coef = inv * inv * inv * (tot.y / static_cast<float>(d));
        for (int i = tid; i < n_vec; i += nt) {
            float xf[VEC], df[VEC];
            load_f32<T, VEC>(xr, i, xf);
            load_f32<T, VEC>(dyr, i, df);
            uint4 res;   // VEC results in one 16-byte store (the first element alone if VEC == 1)
            T* r = reinterpret_cast<T*>(&res);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                r[j] = from_f32<T>(inv * df[j] * to_f32(scale[i * VEC + j]) - xf[j] * coef);
                dscale_acc[i * VEC + j] += df[j] * xf[j] * inv;
            }
            if constexpr (VEC > 1) reinterpret_cast<uint4*>(dxr)[i] = res;
            else dxr[i] = r[0];
        }
        __syncthreads();   // warp_sums is read before the next row writes it
    }
    for (int i = tid; i < n_vec; i += nt)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            partials[static_cast<long long>(blockIdx.x) * d + i * VEC + j] = dscale_acc[i * VEC + j];
}

// Register route: the forward's rmsnorm_warp_kernel (one warp per row, the row
// in registers, VPL 16-byte vectors a lane); warp w of block b takes rows
// 4 b + w, 4 (b + grid) + w, ...  Each warp keeps its dscale partials in a
// shared-memory row of its own (in registers they would spill from 16 vectors
// a lane up), and the block adds the four rows in warp order.
template <int VPL>
__global__ void __launch_bounds__(32 * WARP_ROWS)
rmsnorm_bwd_warp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ partials, long long rows, int d, float eps) {
    extern __shared__ float warp_acc_all[];   // WARP_ROWS rows of d floats
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int n_vec = d / 8;
    float* acc = warp_acc_all + warp * d;     // element 8 j + e of vector j
    for (int i = lane; i < d; i += 32) acc[i] = 0.f;
    __syncwarp();   // a lane later adds into columns another lane zeroed

    for (long long row = static_cast<long long>(blockIdx.x) * WARP_ROWS + warp; row < rows;
         row += static_cast<long long>(gridDim.x) * WARP_ROWS) {
        const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
        const uint4* dv = reinterpret_cast<const uint4*>(dy + row * d);
        uint4 xr[VPL], dr[VPL];
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const int j = lane + 32 * i;
            xr[i] = j < n_vec ? xv[j] : make_uint4(0u, 0u, 0u, 0u);
            dr[i] = j < n_vec ? dv[j] : make_uint4(0u, 0u, 0u, 0u);
        }
        float ss = 0.f, gx = 0.f;   // masked lanes hold zeros
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const int j = lane + 32 * i;
            const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr[i]);
            const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dr[i]);
            float sc[8];
            if (j < n_vec) load_scale8(scale + 8 * j, sc);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float f = __bfloat162float(xe[e]);
                ss += f * f;
                if (j < n_vec) gx += __bfloat162float(de[e]) * sc[e] * f;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            ss += __shfl_xor_sync(0xffffffffu, ss, o);
            gx += __shfl_xor_sync(0xffffffffu, gx, o);
        }
        const float inv = rsqrtf(ss * (1.f / static_cast<float>(d)) + eps);
        const float coef = inv * inv * inv * (gx * (1.f / static_cast<float>(d)));
        uint4* ov = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const int j = lane + 32 * i;
            if (j < n_vec) {
                float sc[8];
                load_scale8(scale + 8 * j, sc);
                const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr[i]);
                const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dr[i]);
                uint4 res;
                __nv_bfloat16* r = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float f = __bfloat162float(xe[e]), g = __bfloat162float(de[e]);
                    r[e] = __float2bfloat16_rn(inv * g * sc[e] - f * coef);
                    acc[8 * j + e] += g * f * inv;
                }
                ov[j] = res;
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d; i += 32 * WARP_ROWS) {
        float sum = warp_acc_all[i];
#pragma unroll
        for (int w = 1; w < WARP_ROWS; ++w) sum += warp_acc_all[w * d + i];
        partials[static_cast<long long>(blockIdx.x) * d + i] = sum;
    }
}

// dscale[c] = sum over blocks, in order, of partials[block][c].
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partials, float* __restrict__ dscale,
                                      int blocks, int d) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= d) return;
    float sum = 0.f;
    for (int b = 0; b < blocks; ++b) sum += partials[static_cast<long long>(b) * d + c];
    dscale[c] = sum;
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
                       float* partials, long long rows, int d, float eps, int blocks,
                       int threads, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    // the forward's rule (launch above), with dy and dx in the place of out
    const bool aligned = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dx) % 16 == 0;
    const int per_thread = aligned ? VEC : 1;
    int want = (d + per_thread - 1) / per_thread;
    want = ((want + 31) / 32) * 32;
    if (want > kMaxThreads) want = kMaxThreads;
    if (threads != want) return cudaErrorInvalidValue;
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    auto kernel = aligned ? rmsnorm_bwd_kernel<T, S, VEC> : rmsnorm_bwd_kernel<T, S, 1>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
        static_cast<T*>(dx), partials, rows, d, eps);
    return cudaGetLastError();
}

template <int VPL>
cudaError_t launch_bwd_warp(const void* x, const void* scale, const void* dy, void* dx,
                            float* partials, long long rows, int d, float eps, int blocks,
                            cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(WARP_ROWS) * d * sizeof(float);   // <= 96 KB
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(rmsnorm_bwd_warp_kernel<VPL>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    rmsnorm_bwd_warp_kernel<VPL><<<blocks, 32 * WARP_ROWS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), partials, rows, d,
        eps);
    return cudaGetLastError();
}

cudaError_t dispatch_bwd_warp(int vpl, const void* x, const void* scale, const void* dy, void* dx,
                              float* partials, long long rows, int d, float eps, int blocks,
                              cudaStream_t stream) {
    switch (vpl) {
        case 2: return launch_bwd_warp<2>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        case 4: return launch_bwd_warp<4>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        case 9: return launch_bwd_warp<9>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        case 10: return launch_bwd_warp<10>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        case 12: return launch_bwd_warp<12>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        case 16: return launch_bwd_warp<16>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        case 24: return launch_bwd_warp<24>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
        default: return cudaErrorInvalidValue;
    }
}

constexpr int DSCALE_THREADS = 256;
constexpr int kMaxBwdWidth = 32768;   // dscale partials of a row in shared memory: 128 KB

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

// The backward.  Codes as rmsnorm_fwd; dy has x's dtype, `dscale` is fp32,
// `partials` a (blocks, d) fp32 workspace; `blocks` blocks walk the rows
// (four rows at a time on route 1); `threads` is the block route's block
// size, which must be the forward's for that row (0 on route 1).  Returns a
// cudaError_t (0 = both kernels launched).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           float* dscale, float* partials, int x_dtype, int scale_dtype,
                           long long rows, int d, float eps, int route, int vpl, int blocks,
                           int threads, void* stream) {
    if (rows <= 0 || d <= 0 || d > kMaxBwdWidth || blocks <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (route == 1) {
        if (x_dtype != 1 || scale_dtype != 0 || threads != 0 ||
            !warp_route_ok(x, scale, dx, d, vpl) || reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
            blocks > (rows + WARP_ROWS - 1) / WARP_ROWS)
            return static_cast<int>(cudaErrorInvalidValue);
        err = dispatch_bwd_warp(vpl, x, scale, dy, dx, partials, rows, d, eps, blocks, s);
    } else if (route == 0 && blocks <= rows) {
        if (x_dtype == 0 && scale_dtype == 0) {
            err = launch_bwd<float, float>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, s);
        } else if (x_dtype == 0 && scale_dtype == 1) {
            err = launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, s);
        } else if (x_dtype == 1 && scale_dtype == 0) {
            err = launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, s);
        } else if (x_dtype == 1 && scale_dtype == 1) {
            err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, s);
        }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    rmsnorm_dscale_kernel<<<(d + DSCALE_THREADS - 1) / DSCALE_THREADS, DSCALE_THREADS, 0, s>>>(
        partials, dscale, blocks, d);
    return static_cast<int>(cudaGetLastError());
}
