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
//  * Each row recomputes r in fp32 from x with the forward kernel of the same
//    route's threads, vectors and reductions, so in the forward's summation
//    order (the wrapper takes the route by the forward's rule).
//  * x and dy leave device memory once.  A thread copies its own 16-byte
//    pieces of the next rows it walks into a ring in shared memory (cp.async)
//    while it works on the current one, and reads them back into registers;
//    a thread reads only what it copied, so the ring needs no barrier.  Rows
//    that are not 16-byte aligned are read element by element into registers.
//  * A thread owns the same columns on every row it walks and adds dy x r
//    into fp32 partial sums of them: in registers where they fit (the block
//    route, and the register route up to 12 vectors a lane), else in shared
//    memory laid out so that a warp's accesses are conflict-free.  Each block
//    writes one row of a (blocks, d) workspace, its warps added in warp order;
//    then rmsnorm_dscale_kernel sums the workspace column by column in a fixed
//    order, spread over the card.  No atomics: two calls give the same bits.

constexpr int kRing = 2;   // ring slots of a thread: rows in flight beyond the one worked on

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum of two values over the block (the order of block_sum for each); every
// thread gets both totals.  A caller that calls again before a barrier passes
// the other of two warp_sums arrays.
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

// VEC elements of T from a 16-byte piece, as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[VEC]) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f32(e[j]);
}

// Block route: the forward's rmsnorm_kernel, with the same blockDim and VEC.
// Thread t owns units (16-byte vectors, or elements where the row is not
// aligned) t, t + nt, ..., KV of them at most, on every row, and keeps them
// and their partials (and on the vector path their scale) in registers;
// block b walks rows b, b + grid, ...  Its piece (slot, tensor, k) of the ring
// is at ring[((2 slot + tensor) KV + k) nt + t].
template <typename T, typename S, int VEC, int KV>
__global__ void __launch_bounds__(kMaxThreads, KV * VEC <= 8 ? 2 : 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partials, long long rows, int d,
                   float eps) {
    extern __shared__ uint4 ring[];
    __shared__ float2 warp_sums[2][32];
    const int tid = threadIdx.x, nt = blockDim.x;
    const int units = VEC > 1 ? d / VEC : d;

    float sc[VEC > 1 ? KV : 1][VEC], acc[KV][VEC];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
        const int u = tid + k * nt;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            acc[k][j] = 0.f;
            if constexpr (VEC > 1) sc[k][j] = u < units ? to_f32(scale[u * VEC + j]) : 0.f;
        }
    }
    // the element path reads scale where it is used: its registers go to the row
    auto scale_of = [&](int k, int j) -> float {
        if constexpr (VEC > 1) return sc[k][j];
        else return tid + k * nt < units ? to_f32(scale[tid + k * nt]) : 0.f;
    };

    auto fetch = [&](long long row, int slot) {
        if constexpr (VEC > 1) {
            if (row < rows) {
                const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
                const uint4* dv = reinterpret_cast<const uint4*>(dy + row * d);
#pragma unroll
                for (int k = 0; k < KV; ++k) {
                    const int u = tid + k * nt;
                    if (u < units) {
                        cp_async16(&ring[((2 * slot) * KV + k) * nt + tid], xv + u);
                        cp_async16(&ring[((2 * slot + 1) * KV + k) * nt + tid], dv + u);
                    }
                }
            }
            cp_async_commit();   // one group a row, empty past the end
        }
    };
    for (int s = 0; s < kRing; ++s) fetch(blockIdx.x + static_cast<long long>(s) * gridDim.x, s);

    int slot = 0, parity = 0;
    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
        float xf[KV][VEC], df[KV][VEC];   // masked units hold zeros
        if constexpr (VEC > 1) {
            cp_async_wait<kRing - 1>();   // this row's group has landed
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int k = 0; k < KV; ++k) {
                const int u = tid + k * nt;
                unpack<T, VEC>(u < units ? ring[((2 * slot) * KV + k) * nt + tid] : z, xf[k]);
                unpack<T, VEC>(u < units ? ring[((2 * slot + 1) * KV + k) * nt + tid] : z, df[k]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < KV; ++k) {
                const int u = tid + k * nt;
                xf[k][0] = u < units ? to_f32(x[row * d + u]) : 0.f;
                df[k][0] = u < units ? to_f32(dy[row * d + u]) : 0.f;
            }
        }
        float ss = 0.f, gx = 0.f;
#pragma unroll
        for (int k = 0; k < KV; ++k)
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                ss += xf[k][j] * xf[k][j];
                gx += df[k][j] * scale_of(k, j) * xf[k][j];
            }
        const float2 tot = block_sum2(ss, gx, warp_sums[parity]);
        parity ^= 1;
        // this thread's pieces of the slot are in registers and summed: refill it
        fetch(row + static_cast<long long>(kRing) * gridDim.x, slot);
        slot = (slot + 1) % kRing;
        const float inv = rsqrtf(tot.x / static_cast<float>(d) + eps);
        const float coef = inv * inv * inv * (tot.y / static_cast<float>(d));
        T* dxr = dx + row * d;
#pragma unroll
        for (int k = 0; k < KV; ++k) {
            const int u = tid + k * nt;
            if (u < units) {
                uint4 res;   // VEC results in one 16-byte store (the first element alone if VEC == 1)
                T* r = reinterpret_cast<T*>(&res);
#pragma unroll
                for (int j = 0; j < VEC; ++j) {
                    r[j] = from_f32<T>(inv * df[k][j] * scale_of(k, j) - xf[k][j] * coef);
                    acc[k][j] += df[k][j] * xf[k][j] * inv;
                }
                if constexpr (VEC > 1) reinterpret_cast<uint4*>(dxr)[u] = res;
                else dxr[u] = r[0];
            }
        }
    }
    if constexpr (VEC > 1) cp_async_wait<0>();
    float* pr = partials + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
        const int u = tid + k * nt;
        if (u < units) {
            if constexpr (VEC % 4 == 0) {
#pragma unroll
                for (int q = 0; q < VEC / 4; ++q)
                    reinterpret_cast<float4*>(pr + u * VEC)[q] =
                        make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2], acc[k][4 * q + 3]);
            } else {
                pr[u] = acc[k][0];
            }
        }
    }
}

// Register route, by vectors per lane.  Up to 12 a lane keeps its row of x
// and dy (8 VPL registers) and its partials (8 VPL floats) in registers;
// past that both would spill, so the partials go to shared memory and the row
// is read from the ring twice (statistics, then dx).  A warp's shared memory:
// its ring (kRing slots of x's and dy's pieces, 512 bytes a vector) and,
// where they are shared, its partials; warps a block takes, at most: 8, or as
// many as shared memory holds.
__host__ __device__ constexpr bool shared_partials(int vpl) { return vpl > 12; }
__host__ __device__ constexpr int bwd_warp_smem(int vpl) {
    return (2 * kRing * vpl + (shared_partials(vpl) ? 2 * vpl : 0)) * 512;
}
constexpr int kBwdSmem = 232448 - 1024;   // dynamic shared memory a block may take
__host__ __device__ constexpr int bwd_max_warps(int vpl) {
    return kBwdSmem / bwd_warp_smem(vpl) < 8 ? kBwdSmem / bwd_warp_smem(vpl) : 8;
}

// Register route: the forward's rmsnorm_warp_kernel (one warp per row, VPL
// 16-byte vectors a lane, vector j = lane + 32 i); warp w of block b takes
// rows warps b + w, warps (b + grid) + w, ...  Lane l's piece (slot, tensor,
// i) of the ring is at [((2 slot + tensor) VPL + i) 32 + l]; its shared
// partials of vector j are float4 halves at [2 (j / 32) 32 + l] and 32 after
// it, so a warp's access is 512 contiguous bytes.
template <int VPL>
__global__ void __launch_bounds__(32 * bwd_max_warps(VPL), 1)
rmsnorm_bwd_warp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ partials, long long rows, int d, float eps) {
    constexpr bool kShared = shared_partials(VPL);
    constexpr int kWarpPieces = bwd_warp_smem(VPL) / 16;
    extern __shared__ uint4 smem[];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
    const int n_vec = d / 8;
    uint4* ring = smem + warp * kWarpPieces;
    float4* shared_acc = reinterpret_cast<float4*>(ring + 2 * kRing * VPL * 32);
    auto piece = [&](int slot, int tensor, int i) -> uint4& {
        return ring[((2 * slot + tensor) * VPL + i) * 32 + lane];
    };
    float acc[kShared ? 1 : VPL][8];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        if constexpr (kShared) {
            shared_acc[2 * i * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
            shared_acc[(2 * i + 1) * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
        }
    }

    const long long first = static_cast<long long>(blockIdx.x) * warps + warp;
    const long long stride = static_cast<long long>(gridDim.x) * warps;
    auto fetch = [&](long long row, int slot) {
        if (row < rows) {
            const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
            const uint4* dv = reinterpret_cast<const uint4*>(dy + row * d);
#pragma unroll
            for (int i = 0; i < VPL; ++i) {
                const int j = lane + 32 * i;
                if (j < n_vec) {
                    cp_async16(&piece(slot, 0, i), xv + j);
                    cp_async16(&piece(slot, 1, i), dv + j);
                }
            }
        }
        cp_async_commit();   // one group a row, empty past the end
    };
    for (int s = 0; s < kRing; ++s) fetch(first + s * stride, s);

    // Up to 12 vectors a lane the row's pieces are all loaded into registers
    // first; past that the passes take four vectors at a time, each chunk's
    // pieces and scale loaded before any is used.
    constexpr int kChunk = kShared ? 4 : VPL;
    static_assert(VPL % kChunk == 0, "the chunks cover the row");
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    int slot = 0;
    for (long long row = first; row < rows; row += stride) {
        cp_async_wait<kRing - 1>();   // this row's group has landed
        uint4 xr[kShared ? 1 : VPL], dr[kShared ? 1 : VPL];   // the row, where it stays
        float ss = 0.f, gx = 0.f;   // masked vectors add zeros, as the forward's do
        if constexpr (!kShared) {
#pragma unroll
            for (int i = 0; i < VPL; ++i) {
                const bool in = lane + 32 * i < n_vec;
                xr[i] = in ? piece(slot, 0, i) : zero;
                dr[i] = in ? piece(slot, 1, i) : zero;
            }
#pragma unroll
            for (int i = 0; i < VPL; ++i) {
                const int j = lane + 32 * i;
                const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr[i]);
                const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dr[i]);
                float sc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                if (j < n_vec) load_scale8(scale + 8 * j, sc);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float f = __bfloat162float(xe[e]);
                    ss += f * f;
                    gx += __bfloat162float(de[e]) * sc[e] * f;
                }
            }
        } else {
#pragma unroll
            for (int i0 = 0; i0 < VPL; i0 += kChunk) {
                uint4 xc[kChunk], dc[kChunk];
                float sc[kChunk][8];
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    const int i = i0 + c, j = lane + 32 * i;
                    const bool in = j < n_vec;
                    xc[c] = in ? piece(slot, 0, i) : zero;
                    dc[c] = in ? piece(slot, 1, i) : zero;
#pragma unroll
                    for (int e = 0; e < 8; ++e) sc[c][e] = 0.f;
                    if (in) load_scale8(scale + 8 * j, sc[c]);
                }
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xc[c]);
                    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dc[c]);
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const float f = __bfloat162float(xe[e]);
                        ss += f * f;
                        gx += __bfloat162float(de[e]) * sc[c][e] * f;
                    }
                }
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            ss += __shfl_xor_sync(0xffffffffu, ss, o);
            gx += __shfl_xor_sync(0xffffffffu, gx, o);
        }
        // the slot's pieces are in registers and summed: refill it now
        if constexpr (!kShared) fetch(row + kRing * stride, slot);
        const float inv = rsqrtf(ss * (1.f / static_cast<float>(d)) + eps);
        const float coef = inv * inv * inv * (gx * (1.f / static_cast<float>(d)));
        uint4* ov = reinterpret_cast<uint4*>(dx + row * d);
        if constexpr (!kShared) {
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
                        acc[i][e] += g * f * inv;
                    }
                    ov[j] = res;
                }
            }
        } else {
#pragma unroll
            for (int i0 = 0; i0 < VPL; i0 += kChunk) {
                uint4 xc[kChunk], dc[kChunk];
                float sc[kChunk][8], a[kChunk][8];   // a: the chunk's partials
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    const int i = i0 + c, j = lane + 32 * i;
                    const bool in = j < n_vec;
                    xc[c] = in ? piece(slot, 0, i) : zero;
                    dc[c] = in ? piece(slot, 1, i) : zero;
                    const float4 lo = shared_acc[2 * i * 32 + lane], hi = shared_acc[(2 * i + 1) * 32 + lane];
                    a[c][0] = lo.x; a[c][1] = lo.y; a[c][2] = lo.z; a[c][3] = lo.w;
                    a[c][4] = hi.x; a[c][5] = hi.y; a[c][6] = hi.z; a[c][7] = hi.w;
#pragma unroll
                    for (int e = 0; e < 8; ++e) sc[c][e] = 0.f;
                    if (in) load_scale8(scale + 8 * j, sc[c]);
                }
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    const int i = i0 + c, j = lane + 32 * i;
                    if (j < n_vec) {
                        const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xc[c]);
                        const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dc[c]);
                        uint4 res;
                        __nv_bfloat16* r = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
                        for (int e = 0; e < 8; ++e) {
                            const float f = __bfloat162float(xe[e]), g = __bfloat162float(de[e]);
                            r[e] = __float2bfloat16_rn(inv * g * sc[c][e] - f * coef);
                            a[c][e] += g * f * inv;
                        }
                        shared_acc[2 * i * 32 + lane] = make_float4(a[c][0], a[c][1], a[c][2], a[c][3]);
                        shared_acc[(2 * i + 1) * 32 + lane] = make_float4(a[c][4], a[c][5], a[c][6], a[c][7]);
                        ov[j] = res;
                    }
                }
            }
        }
        // read twice, the slot is refilled only now
        if constexpr (kShared) fetch(row + kRing * stride, slot);
        slot = (slot + 1) % kRing;
    }
    cp_async_wait<0>();
    // The block's partial row: each warp's sums in the shared layout (register
    // sums stored over the rings, which every warp has finished with), then
    // added in warp order.
    __syncthreads();
    auto warp_acc = [&](int w) -> const float4* {
        return reinterpret_cast<const float4*>(
            kShared ? smem + w * kWarpPieces + 2 * kRing * VPL * 32 : smem + w * 2 * VPL * 32);
    };
    if constexpr (!kShared) {
        float4* mine = reinterpret_cast<float4*>(smem + warp * 2 * VPL * 32);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            mine[2 * i * 32 + lane] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            mine[(2 * i + 1) * 32 + lane] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
    }
    __syncthreads();
    float* pr = partials + static_cast<long long>(blockIdx.x) * d;
    for (int j = threadIdx.x; j < n_vec; j += blockDim.x) {
        const int at = 2 * (j / 32) * 32 + j % 32;
        float4 lo = warp_acc(0)[at], hi = warp_acc(0)[at + 32];
        for (int w = 1; w < warps; ++w) {
            const float4 l = warp_acc(w)[at], h = warp_acc(w)[at + 32];
            lo.x += l.x; lo.y += l.y; lo.z += l.z; lo.w += l.w;
            hi.x += h.x; hi.y += h.y; hi.z += h.z; hi.w += h.w;
        }
        reinterpret_cast<float4*>(pr + 8 * j)[0] = lo;
        reinterpret_cast<float4*>(pr + 8 * j)[1] = hi;
    }
}

// dscale[c] = sum of partials[b][c] over the blocks b, in a fixed order: a
// block takes 32 columns, a lane each, its warp w the partial rows [w P / W,
// (w + 1) P / W) in order, DSCALE_CHUNK of them loaded before any is added
// (rows past the range add zeros), and warp 0 adds the warps' sums in warp
// order.  Spread over ceil(d / 32) blocks.
constexpr int DSCALE_WARPS = 8;
constexpr int DSCALE_CHUNK = 16;

__global__ void __launch_bounds__(32 * DSCALE_WARPS)
rmsnorm_dscale_kernel(const float* __restrict__ partials, float* __restrict__ dscale, int blocks,
                      int d) {
    __shared__ float sums[DSCALE_WARPS][32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int c = blockIdx.x * 32 + lane;
    const int lo = warp * blocks / DSCALE_WARPS, hi = (warp + 1) * blocks / DSCALE_WARPS;
    float s = 0.f;
    if (c < d) {
        for (int b0 = lo; b0 < hi; b0 += DSCALE_CHUNK) {
            float q[DSCALE_CHUNK];
#pragma unroll
            for (int t = 0; t < DSCALE_CHUNK; ++t)
                q[t] = b0 + t < hi ? partials[static_cast<long long>(b0 + t) * d + c] : 0.f;
#pragma unroll
            for (int t = 0; t < DSCALE_CHUNK; ++t) s += q[t];
        }
    }
    sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c < d) {
        float t = sums[0][lane];
#pragma unroll
        for (int w = 1; w < DSCALE_WARPS; ++w) t += sums[w][lane];
        dscale[c] = t;
    }
}

// Units a thread of the block route parks (the template counts built):
// 16-byte vectors where the row is aligned, elements where it is not.  A row
// takes the smallest count that covers it at the forward's threads.
constexpr int VECTOR_UNITS[] = {1, 2, 4};
constexpr int SCALAR_UNITS[] = {1, 2, 4, 8, 16};
constexpr int kMaxBwdWidth = 8192;   // 4 fp32 vectors or 16 elements a thread at 512 threads

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

template <typename T, typename S, int VEC, int KV>
cudaError_t launch_bwd_units(const void* x, const void* scale, const void* dy, void* dx,
                             float* partials, long long rows, int d, float eps, int blocks,
                             int threads, size_t smem, cudaStream_t stream) {
    auto kernel = rmsnorm_bwd_kernel<T, S, VEC, KV>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
        static_cast<T*>(dx), partials, rows, d, eps);
    return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
                       float* partials, long long rows, int d, float eps, int blocks,
                       int threads, int units, int smem_bytes, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    // the forward's rule (launch above), with dy and dx in the place of out
    const bool aligned = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dx) % 16 == 0;
    const int per_thread = aligned ? VEC : 1;
    const int n_units = (d + per_thread - 1) / per_thread;
    int want = ((n_units + 31) / 32) * 32;
    if (want > kMaxThreads) want = kMaxThreads;
    const int* counts = aligned ? VECTOR_UNITS : SCALAR_UNITS;
    const int n_counts = aligned ? 3 : 5;
    int kv = 0;   // the smallest built count that covers the row
    for (int i = 0; i < n_counts; ++i)
        if (kv == 0 && counts[i] * want >= n_units) kv = counts[i];
    const size_t smem = aligned ? static_cast<size_t>(2 * kRing) * kv * want * 16 : 0;   // the ring
    if (threads != want || units != kv || static_cast<size_t>(smem_bytes) != smem)
        return cudaErrorInvalidValue;
#define RMS_BWD_UNITS(V, K) launch_bwd_units<T, S, V, K>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, smem, stream)
    if (aligned) {
        switch (kv) {
            case 1: return RMS_BWD_UNITS(VEC, 1);
            case 2: return RMS_BWD_UNITS(VEC, 2);
            case 4:   // 4 bf16 vectors a thread would be rows past kMaxBwdWidth
                if constexpr (VEC == 4) return RMS_BWD_UNITS(VEC, 4);
                break;
        }
    } else {
        switch (kv) {
            case 1: return RMS_BWD_UNITS(1, 1);
            case 2: return RMS_BWD_UNITS(1, 2);
            case 4: return RMS_BWD_UNITS(1, 4);
            case 8: return RMS_BWD_UNITS(1, 8);
            case 16: return RMS_BWD_UNITS(1, 16);
        }
    }
#undef RMS_BWD_UNITS
    return cudaErrorInvalidValue;
}

template <int VPL>
cudaError_t launch_bwd_warp(const void* x, const void* scale, const void* dy, void* dx,
                            float* partials, long long rows, int d, float eps, int blocks,
                            int threads, int smem_bytes, cudaStream_t stream) {
    const int warps = threads / 32;
    if (threads % 32 != 0 || warps < 1 || warps > bwd_max_warps(VPL) ||
        smem_bytes != warps * bwd_warp_smem(VPL) || blocks > (rows + warps - 1) / warps)
        return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(rmsnorm_bwd_warp_kernel<VPL>, smem_bytes);
    if (err != cudaSuccess) return err;
    rmsnorm_bwd_warp_kernel<VPL><<<blocks, threads, smem_bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), partials, rows, d,
        eps);
    return cudaGetLastError();
}

cudaError_t dispatch_bwd_warp(int vpl, const void* x, const void* scale, const void* dy, void* dx,
                              float* partials, long long rows, int d, float eps, int blocks,
                              int threads, int smem_bytes, cudaStream_t stream) {
#define RMS_BWD_WARP(V) launch_bwd_warp<V>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, smem_bytes, stream)
    switch (vpl) {
        case 2: return RMS_BWD_WARP(2);
        case 4: return RMS_BWD_WARP(4);
        case 9: return RMS_BWD_WARP(9);
        case 10: return RMS_BWD_WARP(10);
        case 12: return RMS_BWD_WARP(12);
        case 16: return RMS_BWD_WARP(16);
        case 24: return RMS_BWD_WARP(24);
        default: return cudaErrorInvalidValue;
    }
#undef RMS_BWD_WARP
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

// The backward.  Codes as rmsnorm_fwd; dy has x's dtype, `dscale` is fp32,
// `partials` a (blocks, d) fp32 workspace, one row for each of the `blocks`
// blocks that walk the rows.  Route 1: `threads` = 32 x the warps of a block,
// `smem_bytes` = warps x their rings (and partials, past 12 vectors a lane);
// `units` 0.  Route 0: `threads` is the forward's block for that row, `units`
// the parked units a thread takes, `smem_bytes` the rings.  The C side checks
// each against its own rule.  Returns a cudaError_t (0 = both kernels launched).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           float* dscale, float* partials, int x_dtype, int scale_dtype,
                           long long rows, int d, float eps, int route, int vpl, int blocks,
                           int threads, int units, int smem_bytes, void* stream) {
    if (rows <= 0 || d <= 0 || d > kMaxBwdWidth || blocks <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (route == 1) {
        if (x_dtype != 1 || scale_dtype != 0 || units != 0 ||
            !warp_route_ok(x, scale, dx, d, vpl) || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
            return static_cast<int>(cudaErrorInvalidValue);
        err = dispatch_bwd_warp(vpl, x, scale, dy, dx, partials, rows, d, eps, blocks, threads,
                                smem_bytes, s);
    } else if (route == 0 && blocks <= rows) {
#define RMS_BWD(T, S) launch_bwd<T, S>(x, scale, dy, dx, partials, rows, d, eps, blocks, threads, units, smem_bytes, s)
        if (x_dtype == 0 && scale_dtype == 0) err = RMS_BWD(float, float);
        else if (x_dtype == 0 && scale_dtype == 1) err = RMS_BWD(float, __nv_bfloat16);
        else if (x_dtype == 1 && scale_dtype == 0) err = RMS_BWD(__nv_bfloat16, float);
        else if (x_dtype == 1 && scale_dtype == 1) err = RMS_BWD(__nv_bfloat16, __nv_bfloat16);
#undef RMS_BWD
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    rmsnorm_dscale_kernel<<<(d + 31) / 32, 32 * DSCALE_WARPS, 0, s>>>(partials, dscale, blocks, d);
    return static_cast<int>(cudaGetLastError());
}
