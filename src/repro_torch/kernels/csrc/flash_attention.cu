// Flash attention forward and backward (causal or full, grouped-query) for
// Hopper (sm_90a); the backward is described at its section below.
//
// Replaces the TPU kernel `_fa_kernel` / `flash_attention` of the reference's
// kernels/flash_attention.py: out = softmax(q k^T / sqrt(hd) + mask) v with an
// online softmax, fp32 running (m, l, acc), `acc / max(l, 1e-30)` at the end,
// q-head h reading kv-head h / (hq / hkv) so that K/V are never repeated in
// memory.  Mask: k_pos < skv and, if causal, q_pos + (skv - sq) >= k_pos.
//
// What differs from the TPU kernel's shape.  There the grid's fourth axis
// walks the kv blocks in order and carries (m, l, acc) in scratch memory.
// Here blocks run in no order, so one block owns a tile of query rows of one
// (batch, q-head) and loops over the kv tiles itself; the loop stops at the
// tile's causal limit, so fully masked kv tiles cost nothing.  Heavy (late)
// query tiles are scheduled first to shorten the tail.
//
// What bounds it on this card: operations (989 TFLOP/s in bf16 on the tensor
// cores).  At the prefill shapes the bytes of q, k, v and o are a few MB while
// the products need GFLOPs.  The launch plan (route, tiles, grid, shared
// memory, tensor maps) is computed in Python (kernels/flash_attention.py,
// `flash_plan`); this file validates it, encodes the tensor maps and launches.
// Two routes:
//
//  * flash_fwd_wgmma_kernel -- bf16 inputs whose rows are 16-byte aligned (the
//    serving and prefill paths).  Built the way Hopper reaches its tensor-core
//    rate:
//      - `wgmma` for both products: S = Q K^T with Q and K in shared memory
//        (K-major), O += P V with P in registers (the S accumulator rounded to
//        bf16 in place: its fragment layout is the A operand's) and V in
//        shared memory read MN-major (`tnspB`).  m, l and O stay fp32.
//      - TMA loads into a ring of WG_STAGES = 3 K/V stages with a "full" and
//        an "empty" mbarrier each; Q is loaded once per block.
//      - Warp specialisation: a block is BM = 128 query rows served by two
//        consumer warpgroups of 64 rows, plus one producer warpgroup whose
//        first thread issues every TMA load; `setmaxnreg` moves registers from
//        the producer (40) to the consumers (232).  Inside a warpgroup, tile
//        t's softmax runs while tile t - 1's P V is on the tensor cores; the
//        two warpgroups take turns to issue their products (ping-pong), so
//        one's softmax overlaps the other's products.  Where S, P and O do
//        not fit the registers together (hd 128, two warpgroups: ptxas
//        serialises the products, C7512) the tiles run one after the other.
//        Blocks walk the heads fastest and the query tiles from the heaviest
//        down, so every head's heavy tiles go first.
//      - Tensor maps are 4-D, dims (hd, s, h, b) with each tensor's own byte
//        strides, so the model's (b, s, h, hd) tensors go in as transposed
//        views and a box that runs past s is zero-filled inside its own head
//        (zero-filled keys are masked to -inf in the scores).  The head dim is
//        loaded in slabs of at most 64 columns, each with the widest swizzle
//        its row allows (16 -> 32 B, 32 -> 64 B, 64 -> 128 B): hd 80 = 64 + 16,
//        hd 96 = 64 + 32, hd 128 = 64 + 64; Q K^T runs one k-step per 16 columns of a slab and
//        P V one product per slab, so no column of hd 80 is padded.
//      - Only the tiles that cross the causal diagonal, and the ragged last
//        tile, are masked.
//    `cuTensorMapEncodeTiled` is a driver function; it is reached at run time
//    through `cudaGetDriverEntryPoint(ByVersion)`, so nothing links libcuda.
//  * flash_fwd_kernel -- everything else (fp32 inputs, unaligned bf16).  The
//    products run in exact fp32 on the CUDA cores (no TF32), whose 67 TFLOP/s
//    bound it: 4 x 8 register micro-tiles (4 x 4 beyond hd 64) read by
//    broadcast 16-byte shared-memory reads, K/V tiles in a two-stage cp.async
//    ring, P in fp32 like the TPU kernel (described at its section below).
//
// The training forward (lse written) of bf16 also writes `o_res`, what
// rounding out to bf16 dropped (bf16(o - bf16(o)), out's strides): the
// backward's D = rowsum(dO * O) reads out + o_res, the fp32 O.  D from the
// rounded out alone errs by 2^-9 of |dO| |O|, and where the keys or values of
// a row share a large common part (near-uniform attention over many keys: a
// randomly initialised encoder-decoder's cross-attention) dS = P (dP - D)
// is a small difference of nearly equal terms and takes that error whole.
//
// Layout: logical (b, h, s, hd) with the strides of b, h and s passed in
// (elements) and hd contiguous.  Head dims 16, 32, 64, 80 (zamba2's shared
// attention) and 128 are built.
//
// Plain C interface; the kernel launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

struct Strides {
    long long b, h, s;
};

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: register micro-tiles fed by a cp.async ring
// ---------------------------------------------------------------------------
//
// The forward and the backward's two kernels share these pieces.  A block is
// 128 threads, a 16 x 8 grid (ty, tx) in which a warp holds 4 rows of 8
// threads, and owns 64 rows; thread (ty, tx) owns rows ty + 16 i (i < 4).
//  * Products of two row-major tiles over the head dim (S = Q K^T, dP = dO V^T
//    and their transposes) give a thread the columns tx + 8 j of its rows and
//    read both operands as float4 along the head dim.  A warp's 4 rows of one
//    operand and 8 rows of the other are 12 distinct 16-byte groups, and its
//    threads broadcast them, so a read is one shared-memory wavefront and
//    feeds 4 x CJ (a 4 x 8 tile: 32, a 4 x 4 tile: 16) FMAs.
//  * Products of the P / dS tile with a walked or owned tile (O += P V, dQ +=
//    dS K, dV += P^T dO, dK += dS^T Q) give a thread hd / 8 output columns,
//    VW-vectors at VW tx + 8 VW g, and read P along its rows as float4.  A
//    step of 4 keys reads 4 float4 of P and 4 x hd / (8 VW) vectors of the
//    other tile for 16 hd / 8 FMAs: 10.7 FMAs a read at hd 64.
//  * The P / dS rows a thread reads are the ones its own warp wrote, so the
//    softmax needs __syncwarp and no block barrier.
//  * Rows are fp32 in shared memory, hd + 4 floats apart (an odd number of
//    16-byte groups: 8 consecutive rows at one column fall in 8 distinct
//    groups of banks); the P tile's rows are C + 8 apart (8 banks mod 32: a
//    warp's 4 rows x 8 columns of stores hit 32 distinct banks, its 4 rows'
//    float4 reads groups 0, 2, 4 and 6).
//  * Walked tiles arrive through a ring of STAGES stages: fp32 rows in
//    16-byte pieces (the plan's `vector_loads`) by cp.async, zero-filled past
//    the sequence.  One commit group a tile; at tile t a thread waits for its
//    own group t, then one __syncthreads makes every thread's copies visible
//    and frees the stage of tile t - 1, into which tile t + STAGES - 1 is
//    issued before tile t is computed.  bf16 rows (here never 16-byte
//    aligned) are copied element by element: loaded into registers where
//    cp.async would be issued and widened into the ring after the tile's
//    products, so their loads overlap the products too (up to hd 96 in the
//    forward, hd 80 in the backward);
//    unaligned fp32 (rare) is copied element by element in place.
//  * Arithmetic is fp32 FMA throughout (no TF32); e^x is ex2.approx of x
//    log2 e (relative error 2^-22), as on the wgmma route.  Masks are
//    selects, applied only in the tiles that cross the diagonal or a ragged
//    end.
//  * Measured choices (an H100, fp32 at minicpm-2b's (4, 36, 1024, 64)):
//    16-byte reads beat 8- and 4-byte ones; 4 x 8 tiles at one block of 4 or
//    8 warps an SM lost to 4 x 4 tiles at two blocks of 4; two or three
//    stages timed the same; full unrolling lost (code size); fusing the two
//    S-side products into one loop, or launch bounds of two or three blocks
//    an SM, gained nothing.
constexpr int CORE_ROWS = 64;                   // rows a block owns
constexpr int CORE_TY = 16, CORE_TX = 8;        // the thread grid
constexpr int CORE_NT = CORE_TY * CORE_TX;      // 128 threads
constexpr int CORE_RI = CORE_ROWS / CORE_TY;    // 4 owned rows a thread

// A thread's hd / 8 output columns: G vectors of VW, at VW tx + 8 VW g.
template <int HD>
struct CoreCols {
    static constexpr int N = HD / CORE_TX;
    static constexpr int VW = N % 4 == 0 ? 4 : 2;
    static constexpr int G = N / VW;
    static __device__ __forceinline__ int col(int tx, int c) {
        return VW * tx + CORE_TX * VW * (c / VW) + c % VW;
    }
};

__device__ __forceinline__ void core_cp16(float* dst, const float* src, bool in) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void core_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void core_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + ROWS of a head's (s, hd) slice into a shared tile of fp32
// rows hd + 4 apart, zeros past `limit`: by 16-byte cp.async where `vec`,
// else element by element.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void core_load(float* dst, const T* __restrict__ src, long long s_stride,
                                          int r0, int limit, bool vec) {
    constexpr int RS = HD + 4;
    if constexpr (sizeof(T) == 4) {
        if (vec) {
            constexpr int CH = HD / 4;   // 16-byte pieces a row
            static_assert(ROWS * CH % CORE_NT == 0, "pieces split evenly over the threads");
#pragma unroll
            for (int n = 0; n < ROWS * CH / CORE_NT; ++n) {
                const int idx = static_cast<int>(threadIdx.x) + CORE_NT * n;
                const int r = idx / CH, c = idx % CH;
                const int row = r0 + r;
                const bool in = row < limit;
                core_cp16(dst + r * RS + 4 * c,
                          reinterpret_cast<const float*>(src) + (in ? row * s_stride + 4 * c : 0), in);
            }
            return;
        }
    }
    static_assert(ROWS * HD % CORE_NT == 0, "elements split evenly over the threads");
#pragma unroll 8
    for (int n = 0; n < ROWS * HD / CORE_NT; ++n) {
        const int idx = static_cast<int>(threadIdx.x) + CORE_NT * n;
        const int r = idx / HD, d = idx % HD;
        const int row = r0 + r;
        dst[r * RS + d] = row < limit ? to_f32(src[row * s_stride + d]) : 0.f;
    }
}

// e^x as 2^(x log2 e) on the special-function unit (ex2.approx: relative
// error 2^-22, results below 2^-126 flushed to zero, where a probability no
// longer counts), as on the wgmma route.
__device__ __forceinline__ float core_exp(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
}

// bf16 rows of two walked tensors held in registers, two elements a register,
// from their loads (issued before a tile's products) to their stores into
// the ring as fp32 (after them), so that element copies overlap the products.
// Up to MAX_HD: the forward's kernel holds them up to hd 96, the backward's
// up to hd 80 (ptxas: at hd 96 the backward's dK/dV kernel would spill, at
// hd 128 both), and beyond that bf16 rows are copied in place as unaligned
// fp32 rows are.
constexpr int CORE_HELD_FWD_HD = 96, CORE_HELD_BWD_HD = 80;
template <typename T, int HD, int ROWS, int MAX_HD>
struct CoreHeld {
    static constexpr bool used = sizeof(T) == 2 && HD <= MAX_HD;
    static_assert(ROWS * HD % (2 * CORE_NT) == 0, "pairs of elements split evenly over the threads");
    static constexpr int N = used ? ROWS * HD / CORE_NT : 2;   // elements a tensor a thread
    unsigned v[2][N / 2];

    template <int WHICH>
    __device__ __forceinline__ void fetch(const T* __restrict__ src, long long s_stride, int r0,
                                          int limit) {
        const unsigned short* bits = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int n = 0; n < N; ++n) {
            const int idx = static_cast<int>(threadIdx.x) + CORE_NT * n;
            const int row = r0 + idx / HD;
            const unsigned u = row < limit ? bits[row * s_stride + idx % HD] : 0u;
            if (n % 2 == 0)
                v[WHICH][n / 2] = u;
            else
                v[WHICH][n / 2] |= u << 16;
        }
    }

    template <int WHICH>
    __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
        for (int n = 0; n < N; ++n) {
            const int idx = static_cast<int>(threadIdx.x) + CORE_NT * n;
            const unsigned u = n % 2 == 0 ? v[WHICH][n / 2] & 0xffffu : v[WHICH][n / 2] >> 16;
            dst[idx / HD * (HD + 4) + idx % HD] = __uint_as_float(u << 16);
        }
    }
};

// acc[i][j] += sum_{d < K} A[ty + 16 i][d] B[tx + 8 j][d]: rows of two tiles,
// summed in order of d.
template <int CJ, int K, int AS, int BS>
__device__ __forceinline__ void core_dot(float (&acc)[CORE_RI][CJ], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll 4
    for (int d = 0; d < K; d += 4) {
        float4 a[CORE_RI], b[CJ];
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
            a[i] = *reinterpret_cast<const float4*>(A + (ty + CORE_TY * i) * AS + d);
#pragma unroll
        for (int j = 0; j < CJ; ++j)
            b[j] = *reinterpret_cast<const float4*>(B + (tx + CORE_TX * j) * BS + d);
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
                acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
                acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
                acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
            }
    }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][c] += sum_{k < K} P[ty + 16 i][k] M[k][col(c)]: the (64, K) tile P
// times the (K, hd) tile M, summed in order of k.
template <int HD, int K, int PS, int MS>
__device__ __forceinline__ void core_mul(float (&acc)[CORE_RI][HD / CORE_TX], const float* P,
                                         const float* M, int ty, int tx) {
    using CC = CoreCols<HD>;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
        float4 p[CORE_RI];
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
            p[i] = *reinterpret_cast<const float4*>(P + (ty + CORE_TY * i) * PS + k);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float m[CC::N];
            const float* row = M + (k + e) * MS + CC::VW * tx;
#pragma unroll
            for (int g = 0; g < CC::G; ++g) {
                if constexpr (CC::VW == 4) {
                    const float4 t = *reinterpret_cast<const float4*>(row + CORE_TX * 4 * g);
                    m[4 * g] = t.x, m[4 * g + 1] = t.y, m[4 * g + 2] = t.z, m[4 * g + 3] = t.w;
                } else {
                    const float2 t = *reinterpret_cast<const float2*>(row + CORE_TX * 2 * g);
                    m[2 * g] = t.x, m[2 * g + 1] = t.y;
                }
            }
#pragma unroll
            for (int i = 0; i < CORE_RI; ++i) {
                const float pv = lane_of(p[i], e);
#pragma unroll
                for (int c = 0; c < CC::N; ++c) acc[i][c] = fmaf(pv, m[c], acc[i][c]);
            }
        }
    }
}

// One output row's hd / 8 columns of this thread, times `scale`: vectors
// where `vec` (fp32 rows in 16-byte pieces), else element by element.
template <typename T, int HD>
__device__ __forceinline__ void core_store(T* row, const float (&v)[HD / CORE_TX], float scale,
                                           int tx, bool vec) {
    using CC = CoreCols<HD>;
    if constexpr (sizeof(T) == 4) {
        if (vec) {
#pragma unroll
            for (int g = 0; g < CC::G; ++g) {
                float* dst = reinterpret_cast<float*>(row) + CoreCols<HD>::col(tx, CC::VW * g);
                if constexpr (CC::VW == 4)
                    *reinterpret_cast<float4*>(dst) = make_float4(
                        v[4 * g] * scale, v[4 * g + 1] * scale, v[4 * g + 2] * scale,
                        v[4 * g + 3] * scale);
                else
                    *reinterpret_cast<float2*>(dst) = make_float2(v[2 * g] * scale,
                                                                  v[2 * g + 1] * scale);
            }
            return;
        }
    }
#pragma unroll
    for (int c = 0; c < CC::N; ++c) row[CC::col(tx, c)] = from_f32<T>(v[c] * scale);
}

// The forward's shared memory in floats: the owned Q tile, STAGES stages of
// [K, V] of C keys, the (64, C) P tile (kernels/flash_attention.py,
// `core_fwd_layout`).  C = 64 keys up to hd 64, 32 beyond: two blocks an SM.
template <int HD>
struct CoreFwd {
    static constexpr int C = HD <= 64 ? 64 : 32;
    static constexpr int STAGES = 2;
    static constexpr int RS = HD + 4, PS = C + 8;
    static constexpr int STAGE = 2 * C * RS;
    static constexpr int floats = CORE_ROWS * RS + STAGES * STAGE + CORE_ROWS * PS;
    static constexpr size_t bytes = sizeof(float) * floats;
};

// One block a (64-query tile, q head, batch), heavy tiles first: S = Q K^T
// (4 x C / 8 micro-tiles), the online softmax on the 8 lanes that share a
// row, P into the warp's rows of the P tile, O += P V (4 x hd / 8).
template <typename T, int HD>
__global__ void __launch_bounds__(CORE_NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, T* __restrict__ o_res, float* __restrict__ lse, Strides qs,
                 Strides ks, Strides vs,
                 Strides os, int group, int sq, int skv, int n_q_tiles, float sm_scale,
                 int causal, int vec) {
    using L = CoreFwd<HD>;
    constexpr int C = L::C, CJ = C / CORE_TX, NC = HD / CORE_TX, RS = L::RS, PS = L::PS;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* ring = Qs + CORE_ROWS * RS;
    float* Ps = ring + L::STAGES * L::STAGE;

    const int tid = threadIdx.x, tx = tid % CORE_TX, ty = tid / CORE_TX;
    const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);   // heaviest first
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = q_tile * CORE_ROWS;
    const int off = skv - sq;   // causal offset: query i sees keys <= i + off
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + (h / group) * ks.h;
    const T* vb = v + b * vs.b + (h / group) * vs.h;
    const int kv_end = causal ? min(skv, min(q0 + CORE_ROWS, sq) + off) : skv;
    const int n_tiles = (kv_end + C - 1) / C;

    // K/V tile t into its stage, one commit group a call; bf16 rows are only
    // fetched into `held` here, and stored by place(t)
    CoreHeld<T, HD, C, CORE_HELD_FWD_HD> held;
    auto issue = [&](int t) {
        if (t < n_tiles) {
            if constexpr (CoreHeld<T, HD, C, CORE_HELD_FWD_HD>::used) {
                held.template fetch<0>(kb, ks.s, t * C, skv);
                held.template fetch<1>(vb, vs.s, t * C, skv);
            } else {
                float* st = ring + (t % L::STAGES) * L::STAGE;
                core_load<T, HD, C>(st, kb, ks.s, t * C, skv, vec);
                core_load<T, HD, C>(st + C * RS, vb, vs.s, t * C, skv, vec);
            }
        }
        core_commit();
    };
    auto place = [&](int t) {
        if constexpr (CoreHeld<T, HD, C, CORE_HELD_FWD_HD>::used) {
            if (t < n_tiles) {
                float* st = ring + (t % L::STAGES) * L::STAGE;
                held.template put<0>(st);
                held.template put<1>(st + C * RS);
            }
        }
    };
    core_load<T, HD, CORE_ROWS>(Qs, qb, qs.s, q0, sq, vec);   // in tile 0's group
#pragma unroll
    for (int t = 0; t < L::STAGES - 1; ++t) {
        issue(t);
        place(t);
    }

    float m[CORE_RI], l[CORE_RI], acc[CORE_RI][NC];
#pragma unroll
    for (int i = 0; i < CORE_RI; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
        core_wait<L::STAGES - 2>();
        __syncthreads();   // tile t has landed; every thread is done with tile t - 1
        issue(t + L::STAGES - 1);
        const float* Ks = ring + (t % L::STAGES) * L::STAGE;
        const float* Vs = Ks + C * RS;
        const int k0 = t * C;

        float s[CORE_RI][CJ];
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
        core_dot<CJ, HD, RS, RS>(s, Qs, Ks, ty, tx);

        // every query of the tile sees every key of it: no mask
        const bool full = k0 + C <= skv && (!causal || k0 + C - 1 <= q0 + off);
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i) {
            const int q_pos = q0 + ty + CORE_TY * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const int k_pos = k0 + tx + CORE_TX * j;
                const bool valid = full || (k_pos < skv && (!causal || q_pos + off >= k_pos));
                s[i][j] = valid ? s[i][j] * sm_scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int w = 1; w < CORE_TX; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float m_new = fmaxf(m[i], mx);
            const float corr = core_exp(m[i] - m_new);
            float row_sum = 0.f;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const float p = core_exp(s[i][j] - m_new);
                Ps[(ty + CORE_TY * i) * PS + tx + CORE_TX * j] = p;
                row_sum += p;
            }
#pragma unroll
            for (int w = 1; w < CORE_TX; w <<= 1)
                row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
            l[i] = l[i] * corr + row_sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
        }
        __syncwarp();   // the warp's P rows are written
        core_mul<HD, C, PS, RS>(acc, Ps, Vs, ty, tx);
        place(t + L::STAGES - 1);
    }

    T* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < CORE_RI; ++i) {
        const int row = q0 + ty + CORE_TY * i;
        if (row < sq) {
            const float inv = 1.f / fmaxf(l[i], 1e-30f);
            core_store<T, HD>(ob + row * os.s, acc[i], inv, tx, vec);
            if (o_res != nullptr) {   // bf16 training: what rounding out dropped
                T* lrow = o_res + b * os.b + h * os.h + row * os.s;
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const float x = acc[i][c] * inv;
                    lrow[CoreCols<HD>::col(tx, c)] = from_f32<T>(x - to_f32(from_f32<T>(x)));
                }
            }
            // m is the running max of the scaled scores, l the sum of exp(s - m)
            if (lse != nullptr && tx == 0)
                lse[(static_cast<long long>(b) * gridDim.y + h) * sq + row] = m[i] + logf(l[i]);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int WG_BN = 128;       // keys per K/V tile
constexpr int WG_STAGES = 3;     // K/V tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

// The head dim in slabs of at most 64 columns (see the note at the top).
template <int HD> struct Slabs;
template <> struct Slabs<16> { static constexpr int W0 = 16, W1 = 0; };
template <> struct Slabs<32> { static constexpr int W0 = 32, W1 = 0; };
template <> struct Slabs<64> { static constexpr int W0 = 64, W1 = 0; };
template <> struct Slabs<80> { static constexpr int W0 = 64, W1 = 16; };
template <> struct Slabs<96> { static constexpr int W0 = 64, W1 = 32; };
template <> struct Slabs<128> { static constexpr int W0 = 64, W1 = 64; };

// Shared memory in bytes from a 1024-byte-aligned base (the 128-byte swizzle
// repeats every 1024 bytes): Q (BM rows; slab 0, then slab 1), then WG_STAGES
// stages of [K slab 0, K slab 1, V slab 0, V slab 1].  A slab of width w holds
// rows of 2w bytes, as TMA writes them.
template <int HD>
struct WgLayout {
    static constexpr int BM = 128;   // two consumer warpgroups of 64 rows
    static constexpr int W0 = Slabs<HD>::W0, W1 = Slabs<HD>::W1;
    static constexpr int Q1 = BM * W0 * 2;
    static constexpr int KV = BM * HD * 2;
    static constexpr int K1 = WG_BN * W0 * 2;
    static constexpr int V0 = WG_BN * HD * 2;
    static constexpr int V1 = V0 + WG_BN * W0 * 2;
    static constexpr int STAGE = 2 * WG_BN * HD * 2;
    static constexpr int smem = 1024 + KV + WG_STAGES * STAGE;   // 1024: room to align the base
    static constexpr int threads = 384;   // the two consumers and the producer
    // Overlapping tile t's softmax with tile t - 1's P V keeps S, P and O live
    // at once (96 + HD / 2 registers a thread).  At hd 128 ptxas then
    // serialises the products (C7512, too few registers), so that kernel runs
    // the tiles one after the other; up to hd 96 it fits (ptxas: 168
    // registers, no spill, no C7512).
    static constexpr bool overlap = HD <= 96;
};

struct TmaMaps {
    CUtensorMap q[2], k[2], v[2];   // one per slab
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// mbar_wait that traps, rather than hang the card, if the phase has not
// completed after 2^34 cycles (about 9 s): a load that never lands becomes
// an error at the next synchronisation.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
    const long long start = clock64();
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (!done && clock64() - start > (1LL << 34)) __trap();
    } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`.  Coordinates (column, row, head, batch), innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle of a slab of width w bf16
// (mode 1 / 2 / 3 = 128 / 64 / 32 bytes, the whole row of the slab).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int w) {
    const uint64_t mode = w == 64 ? 1 : w == 32 ? 2 : 3;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand (Q, K: rows of the product, head dim contiguous): 8-row
// groups 16w bytes apart; a k-step of 16 columns advances the start by 32
// bytes inside the swizzled row (the leading offset is unused).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, int w) {
    return smem_desc(addr, 16, 16 * w, w);
}

// MN-major operand (V as B of P V: keys along the contraction, head dim
// contiguous): 8-key groups 16w bytes apart; the slab is one swizzle atom wide,
// so the leading offset (between atoms) is unused.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, int w) {
    return smem_desc(addr, 16 * w * 8, 16 * w, w);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, fp32) {+}= A (64 x 16) * B (16 x 128); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) * B (16 x 64); B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 in registers) * B (16 x 32); B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 16, fp32) += A (64 x 16, bf16 in registers) * B (16 x 16); B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b) {
    if constexpr (N == 64) {
        wgmma_rs_n64(d, a, desc_b);
    } else if constexpr (N == 32) {
        wgmma_rs_n32(d, a, desc_b);
    } else {
        static_assert(N == 16, "slab widths are 16, 32 or 64");
        wgmma_rs_n16(d, a, desc_b);
    }
}

// Named barriers over the 256 threads of the two consumer warpgroups.
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments (S and O) of a warpgroup: thread `lane` of warp w
// holds, for each 8-column chunk c, elements 4c + e at row w * 16 + lane / 4
// + 8 (e >> 1) and column 8c + 2 (lane % 4) + (e & 1).  kLse: also write each
// row's log-sum-exp (training); the serving instance has none of that code.
template <int HD, bool kLse>
__global__ void __launch_bounds__(WgLayout<HD>::threads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ TmaMaps maps, __nv_bfloat16* __restrict__ o,
                       __nv_bfloat16* __restrict__ o_res, float* __restrict__ lse, Strides os,
                       int group, int sq, int skv,
                       int n_q_tiles, float scale2, float sm_scale, int causal) {
    using L = WgLayout<HD>;
    constexpr int BM = L::BM, W0 = L::W0, W1 = L::W1;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t bars[1 + 2 * WG_STAGES];   // Q, K/V full[], K/V empty[]

    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_bar = smem_u32(&bars[0]);
    const uint32_t full0 = smem_u32(&bars[1]);
    const uint32_t empty0 = smem_u32(&bars[1 + WG_STAGES]);
    const int tid = threadIdx.x;
    // Blocks start in order of their linear index: walk the heads fastest and
    // the query tiles from the last (heaviest under the causal mask) down, so
    // the heaviest tiles of every head go first and the light ones fill the tail.
    const int hq = static_cast<int>(gridDim.y);
    const int lin = static_cast<int>(blockIdx.x + gridDim.x * blockIdx.y);
    const int q_tile = n_q_tiles - 1 - lin / hq;
    const int h = lin % hq, b = blockIdx.z;
    const int q0 = q_tile * BM;
    const int off = skv - sq;   // causal offset: query i sees keys <= i + off
    const int kv_end = causal ? min(skv, min(q0 + BM, sq) + off) : skv;
    const int n_tiles = (kv_end + WG_BN - 1) / WG_BN;

    if (tid == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < WG_STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 256);   // every consumer thread releases a stage
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // One if/else for the whole kernel: `setmaxnreg` is ignored where the
    // roles' paths meet again.
    if (tid >= 256) {
        // ---- producer warpgroup: its first thread issues every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == 256) {
            const int hk = h / group;
            mbar_expect_tx(q_bar, BM * HD * 2);
            tma_load_4d(base, &maps.q[0], q_bar, 0, q0, h, b);
            if constexpr (W1 > 0) tma_load_4d(base + L::Q1, &maps.q[1], q_bar, W0, q0, h, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % WG_STAGES;
                if (t >= WG_STAGES) mbar_wait(empty0 + 8 * s, (t / WG_STAGES - 1) & 1);
                const uint32_t full = full0 + 8 * s;
                const uint32_t st = base + L::KV + s * L::STAGE;
                const int k0 = t * WG_BN;
                mbar_expect_tx(full, L::STAGE);
                tma_load_4d(st, &maps.k[0], full, 0, k0, hk, b);
                if constexpr (W1 > 0) tma_load_4d(st + L::K1, &maps.k[1], full, W0, k0, hk, b);
                tma_load_4d(st + L::V0, &maps.v[0], full, 0, k0, hk, b);
                if constexpr (W1 > 0) tma_load_4d(st + L::V1, &maps.v[1], full, W0, k0, hk, b);
            }
        }
    } else {
        // ---- consumer warpgroups: 64 query rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = tid / 128;
        const int warp = (tid % 128) / 32, lane = tid % 32;
        const int row0 = warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
        const int col = 2 * (lane % 4);          // its first column in each 8-column chunk
        const int qw0 = q0 + 64 * wg;
        int n_mine = 0;                          // kv tiles this warpgroup's rows see
        if (qw0 < sq) {
            const int end = causal ? min(skv, min(qw0 + 64, sq) + off) : skv;
            n_mine = (end + WG_BN - 1) / WG_BN;
        }
        const uint32_t qa0 = base + 64 * wg * W0 * 2;
        const uint32_t qa1 = base + L::Q1 + 64 * wg * W1 * 2;

        float s[WG_BN / 2];
        uint32_t p[WG_BN / 4];
        float o_lo[W0 / 2];
        float o_hi[W1 > 0 ? W1 / 2 : 1];
#pragma unroll
        for (int i = 0; i < WG_BN / 2; ++i) s[i] = 0.f;
#pragma unroll
        for (int i = 0; i < W0 / 2; ++i) o_lo[i] = 0.f;
#pragma unroll
        for (int i = 0; i < (W1 > 0 ? W1 / 2 : 1); ++i) o_hi[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF};   // running max of the raw scores
        float l[2] = {0.f, 0.f};           // this thread's part of the running sum

        // S = Q K^T for the tile in `stage`, one k-step per 16 columns of each slab
        auto issue_qk = [&](int stage) {
            const uint32_t st = base + L::KV + stage * L::STAGE;
#pragma unroll
            for (int kk = 0; kk < W0 / 16; ++kk)
                wgmma_ss_n128(s, desc_k_major(qa0 + 32 * kk, W0), desc_k_major(st + 32 * kk, W0),
                              kk > 0);
            if constexpr (W1 > 0) {
#pragma unroll
                for (int kk = 0; kk < W1 / 16; ++kk)
                    wgmma_ss_n128(s, desc_k_major(qa1 + 32 * kk, W1),
                                  desc_k_major(st + L::K1 + 32 * kk, W1), 1);
            }
            wgmma_commit();
        };
        // O += P V for the tile in `stage`, one product per slab and 16 keys
        auto issue_pv = [&](int stage) {
            const uint32_t st = base + L::KV + stage * L::STAGE;
#pragma unroll
            for (int kk = 0; kk < WG_BN / 16; ++kk) {
                wgmma_rs<W0>(o_lo, p + 4 * kk, desc_mn_major(st + L::V0 + kk * 16 * W0 * 2, W0));
                if constexpr (W1 > 0)
                    wgmma_rs<W1>(o_hi, p + 4 * kk, desc_mn_major(st + L::V1 + kk * 16 * W1 * 2, W1));
            }
            wgmma_commit();
        };
        // Mask tile t where it crosses the diagonal or the end of the keys, then
        // the online softmax in log2 units: s becomes p, l and m are updated and
        // corr is the factor by which O must be rescaled.  A row is shared by the
        // 4 lanes of a quad.
        float corr[2];
        auto softmax = [&](int t) {
            const int k0 = t * WG_BN;
            if (k0 + WG_BN > skv || (causal && k0 + WG_BN - 1 > qw0 + off)) {
#pragma unroll
                for (int c = 0; c < WG_BN / 8; ++c)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int k_pos = k0 + 8 * c + col + (e & 1);
                        const int q_pos = qw0 + row0 + 8 * (e >> 1);
                        if (k_pos >= skv || (causal && q_pos + off < k_pos)) s[4 * c + e] = NEG_INF;
                    }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mx = m[r];
#pragma unroll
                for (int c = 0; c < WG_BN / 8; ++c)
                    mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                corr[r] = exp2f((m[r] - mx) * scale2);
                const float ms = mx * scale2;
                float sum = 0.f;
#pragma unroll
                for (int c = 0; c < WG_BN / 8; ++c)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float pe = exp2f(fmaf(s[4 * c + 2 * r + e], scale2, -ms));
                        s[4 * c + 2 * r + e] = pe;
                        sum += pe;
                    }
                l[r] = l[r] * corr[r] + sum;
                m[r] = mx;
            }
        };
        // O *= corr, then P = bf16(s): two neighbouring 8-key chunks are one
        // k16 A fragment
        auto rescale_and_pack = [&]() {
#pragma unroll
            for (int i = 0; i < W0 / 2; ++i) o_lo[i] *= corr[(i >> 1) & 1];
            if constexpr (W1 > 0) {
#pragma unroll
                for (int i = 0; i < W1 / 2; ++i) o_hi[i] *= corr[(i >> 1) & 1];
            }
#pragma unroll
            for (int kk = 0; kk < WG_BN / 16; ++kk) {
                p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
                p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
                p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
                p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
            }
        };
        auto wait_full = [&](int t) {
            mbar_wait(full0 + 8 * (t % WG_STAGES), (t / WG_STAGES) & 1);
        };
        auto release = [&](int t) { mbar_arrive(empty0 + 8 * (t % WG_STAGES)); };

        // Ping-pong: the two consumer warpgroups take turns to issue their
        // products (named barriers 1 and 2), so one's products run on the
        // tensor cores while the other's softmax runs on the CUDA cores.  Each
        // warpgroup takes n_tiles + 1 turns; warpgroup 0 takes the first, and
        // warpgroup 1 skips its last hand-over, which nobody waits for.
        constexpr bool ping_pong = L::overlap;
        int turns_left = n_tiles + 1;
        auto begin_turn = [&]() {
            if constexpr (ping_pong) named_sync(1 + wg);
        };
        auto end_turn = [&]() {
            if constexpr (ping_pong) {
                if (wg == 0 || --turns_left > 0) named_arrive(2 - wg);
            }
        };
        if constexpr (ping_pong) {
            if (wg == 1) named_arrive(1);
        }
        mbar_wait(q_bar, 0);
        if constexpr (L::overlap) {
            // Tile t's softmax runs while tile t - 1's P V is on the tensor cores.
            if (n_mine == 0) {
                begin_turn();
                end_turn();
            } else {
                wait_full(0);
                begin_turn();
                wgmma_fence();
                issue_qk(0);
                end_turn();
                wgmma_wait<0>();
                fence_regs(s);
                softmax(0);
                rescale_and_pack();
                for (int t = 1; t < n_mine; ++t) {
                    wait_full(t);
                    fence_regs(p);
                    fence_regs(o_lo);
                    fence_regs(o_hi);
                    begin_turn();
                    wgmma_fence();
                    issue_qk(t % WG_STAGES);
                    issue_pv((t - 1) % WG_STAGES);
                    end_turn();
                    wgmma_wait<1>();   // S of tile t is ready, P V of tile t - 1 may still run
                    fence_regs(s);
                    softmax(t);
                    wgmma_wait<0>();
                    fence_regs(o_lo);
                    fence_regs(o_hi);
                    release(t - 1);
                    rescale_and_pack();
                }
                fence_regs(p);
                fence_regs(o_lo);
                fence_regs(o_hi);
                begin_turn();
                wgmma_fence();
                issue_pv((n_mine - 1) % WG_STAGES);
                end_turn();
                wgmma_wait<0>();
                fence_regs(o_lo);
                fence_regs(o_hi);
                release(n_mine - 1);
            }
        } else {
            // One tile at a time: Q K^T, softmax, P V.
            for (int t = 0; t < n_mine; ++t) {
                wait_full(t);
                wgmma_fence();
                issue_qk(t % WG_STAGES);
                wgmma_wait<0>();
                fence_regs(s);
                softmax(t);
                rescale_and_pack();
                fence_regs(p);
                fence_regs(o_lo);
                fence_regs(o_hi);
                wgmma_fence();
                issue_pv(t % WG_STAGES);
                wgmma_wait<0>();
                fence_regs(o_lo);
                fence_regs(o_hi);
                release(t);
            }
        }
        // the block's later tiles, which this warpgroup's rows do not see
        for (int t = n_mine; t < n_tiles; ++t) {
            wait_full(t);
            if constexpr (L::overlap) {
                begin_turn();
                end_turn();
            }
            release(t);
        }

        __nv_bfloat16* out = o + b * os.b + h * os.h;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float lt = l[r];
            lt += __shfl_xor_sync(0xffffffffu, lt, 1);
            lt += __shfl_xor_sync(0xffffffffu, lt, 2);
            const float inv = 1.f / fmaxf(lt, 1e-30f);
            const int row = qw0 + row0 + 8 * r;
            // m holds the raw (unscaled) row max and lt the sum of
            // exp(sm_scale (s - m)) (the softmax runs in log2 units, scale2 =
            // sm_scale log2 e): lse = sm_scale m + ln(lt), natural log
            if constexpr (kLse) {
                if (row < sq && lane % 4 == 0)
                    lse[(static_cast<long long>(b) * hq + h) * sq + row] = fmaf(m[r], sm_scale, logf(lt));
            }
            if (row < sq) {
                __nv_bfloat16* orow = out + row * os.s + col;
                // kLse: also what rounding dropped, into o_res at out's offset
                __nv_bfloat16* lrow = kLse ? o_res + (orow - o) : nullptr;
                auto put = [&](int at, float x0, float x1) {
                    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
                    *reinterpret_cast<__nv_bfloat162*>(orow + at) = hi;
                    if constexpr (kLse) {
                        const float2 h2 = __bfloat1622float2(hi);
                        *reinterpret_cast<__nv_bfloat162*>(lrow + at) =
                            __floats2bfloat162_rn(x0 - h2.x, x1 - h2.y);
                    }
                };
#pragma unroll
                for (int c = 0; c < W0 / 8; ++c)
                    put(8 * c, o_lo[4 * c + 2 * r] * inv, o_lo[4 * c + 2 * r + 1] * inv);
                if constexpr (W1 > 0) {
#pragma unroll
                    for (int c = 0; c < W1 / 8; ++c)
                        put(W0 + 8 * c, o_hi[4 * c + 2 * r] * inv, o_hi[4 * c + 2 * r + 1] * inv);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Host side: the launch plan, tensor maps, launches
// ---------------------------------------------------------------------------

// The launch plan (kernels/flash_attention.py, `FlashPlan.as_array`), int64:
//   [0] route (0 = CUDA cores, 1 = wgmma), [1] BM, [2] BN, [3] stages,
//   [4] threads, [5..7] grid, [8] dynamic shared memory bytes, then for q, k, v
//   16 values each from [9]: dims (hd, s, h, b), byte strides (s, h, b), the
//   number of slabs and, per slab (two places), its first column, width,
//   swizzle bytes and box rows.
constexpr int PLAN_OPERANDS = 9;
constexpr int ENCODE_FAILED = 10000;   // + the CUresult of a failed encode

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

CUresult encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, const long long* op,
                    int slab) {
    const long long* sl = op + 8 + 4 * slab;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(op[0]), static_cast<cuuint64_t>(op[1]),
                                static_cast<cuuint64_t>(op[2]), static_cast<cuuint64_t>(op[3])};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(op[4]), static_cast<cuuint64_t>(op[5]),
                                   static_cast<cuuint64_t>(op[6])};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(sl[1]), static_cast<cuuint32_t>(sl[3]), 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle = sl[2] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : sl[2] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The plan must describe exactly the kernel built for HD.
template <int HD>
bool wgmma_plan_ok(const long long* plan, int b, int hq, int hkv, int sq, int skv) {
    using L = WgLayout<HD>;
    if (plan[1] != L::BM || plan[2] != WG_BN || plan[3] != WG_STAGES || plan[4] != L::threads ||
        plan[5] != (sq + L::BM - 1) / L::BM || plan[6] != hq || plan[7] != b || plan[8] != L::smem)
        return false;
    const long long rows[3] = {L::BM, WG_BN, WG_BN};
    const long long seq[3] = {sq, skv, skv};
    const long long heads[3] = {hq, hkv, hkv};
    const int n_slabs = L::W1 > 0 ? 2 : 1;
    for (int i = 0; i < 3; ++i) {
        const long long* op = plan + PLAN_OPERANDS + 16 * i;
        if (op[0] != HD || op[1] != seq[i] || op[2] != heads[i] || op[3] != b || op[7] != n_slabs)
            return false;
        for (int j = 4; j < 7; ++j)
            if (op[j] <= 0 || op[j] % 16 != 0 || op[j] >= (1LL << 40)) return false;
        for (int j = 0; j < n_slabs; ++j) {
            const long long* sl = op + 8 + 4 * j;
            const int width = j == 0 ? L::W0 : L::W1;
            if (sl[0] != (j == 0 ? 0 : L::W0) || sl[1] != width || sl[2] != 2 * width ||
                sl[3] != rows[i])
                return false;
        }
    }
    return true;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* o_res, float* lse,
                 Strides os, const long long* plan, int b, int hq, int hkv, int sq, int skv,
                 float sm_scale, int causal, cudaStream_t stream) {
    using L = WgLayout<HD>;
    if (!wgmma_plan_ok<HD>(plan, b, hq, hkv, sq, skv)) return cudaErrorInvalidValue;
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    TmaMaps maps;
    memset(&maps, 0, sizeof(maps));
    const void* bases[3] = {q, k, v};
    CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
    for (int i = 0; i < 3; ++i) {
        const long long* op = plan + PLAN_OPERANDS + 16 * i;
        for (int j = 0; j < op[7]; ++j) {
            const CUresult res = encode_map(encode, &dst[i][j], bases[i], op, j);
            if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);
        }
    }
    auto kernel =
        lse != nullptr ? flash_fwd_wgmma_kernel<HD, true> : flash_fwd_wgmma_kernel<HD, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem);
    if (err != cudaSuccess) return err;
    const int n_q_tiles = static_cast<int>(plan[5]);
    kernel<<<dim3(n_q_tiles, hq, b), L::threads, L::smem, stream>>>(
        maps, static_cast<__nv_bfloat16*>(o), static_cast<__nv_bfloat16*>(o_res), lse, os,
        hq / hkv, sq, skv, n_q_tiles,
        sm_scale * LOG2E, sm_scale, causal);
    return cudaGetLastError();
}

// The wgmma route's inputs: bf16 rows in 16-byte pieces, bf16 pairs stored.
bool rows_16_byte_aligned(const void* const* ptrs, const long long* strides) {
    for (int i = 0; i < 4; ++i)
        if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int i = 0; i < 12; ++i)
        if (strides[i] % 8 != 0) return false;
    return true;
}

// ---------------------------------------------------------------------------

// The CUDA-core route's `vector_loads`: fp32 whose bases are 16-byte aligned
// and whose (b, h, s) strides are multiples of 4 elements.
bool core_vector_loads(int dtype, const void* const* ptrs, int n, const long long* strides) {
    if (dtype != 0) return false;
    for (int i = 0; i < n; ++i)
        if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int i = 0; i < 3 * n; ++i)
        if (strides[i] % 4 != 0) return false;
    return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// The CUDA-core plan: [1] 64 query rows, [2] keys a K/V tile, [3] stages,
// [4] 128 threads, [5..7] grid, [8] shared bytes, [9] vector_loads.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* o_res, float* lse,
           Strides qs, Strides ks, Strides vs, Strides os, const long long* plan, int b, int hq,
           int hkv, int sq, int skv, float sm_scale, int causal, int vec, cudaStream_t stream) {
    using L = CoreFwd<HD>;
    auto kernel = flash_fwd_kernel<T, HD>;
    const int n_q_tiles = (sq + CORE_ROWS - 1) / CORE_ROWS;
    if (plan[1] != CORE_ROWS || plan[2] != L::C || plan[3] != L::STAGES || plan[4] != CORE_NT ||
        plan[5] != n_q_tiles || plan[6] != hq || plan[7] != b ||
        plan[8] != static_cast<long long>(L::bytes) || plan[9] != vec)
        return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(kernel, L::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n_q_tiles, hq, b), CORE_NT, L::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<T*>(o_res), lse, qs, ks, vs, os, hq / hkv, sq, skv,
        n_q_tiles, sm_scale, causal, vec);
    return cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, void* o_res,
                float* lse, Strides qs, Strides ks, Strides vs, Strides os,
                const long long* plan, int b, int hq, int hkv, int sq, int skv, float sm_scale,
                int causal, int vec, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, stream);
        case 32: return launch<T, 32>(q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, stream);
        case 64: return launch<T, 64>(q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, stream);
        case 80: return launch<T, 80>(q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, stream);
        case 96: return launch<T, 96>(q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, stream);
        case 128: return launch<T, 128>(q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, stream);
        default: return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// Backward (training): the gradient of out with respect to q, k and v
// ---------------------------------------------------------------------------
//
// The TPU kernel has no backward (the reference differentiates its plain jnp
// attention), so this is the port's own: FlashAttention-2's recomputation
// scheme, no atomics and a fixed order for every sum, so every result is
// deterministic.  P is recomputed from q, k and the forward's lse (natural
// log), never stored.  What bounds it on this card: operations (five
// products of 2 hd flops per visible (query, key) pair).  Two routes, chosen
// in Python (`flash_bwd_plan`) as the forward's are: bf16 whose rows are
// 16-byte aligned runs on the tensor cores (`wgmma`, described at its
// section below); fp32 and unaligned bf16 run in exact fp32 on the CUDA
// cores, whose 67 TFLOP/s they cannot pass, with the pieces above
// (micro-tiles, cp.async ring), two kernels and, for a split GQA group, the
// ordered sum a call:
//
//  * flash_bwd_dq_kernel, first -- one block per (64 queries, q head, batch)
//    holding Q and dO.  It computes its rows' D = rowsum(dO * O) and stores
//    D and lse, zeros past sq, in a (b, hq, sq_pad) workspace whose rows are
//    padded to the block's 64, so that the dK/dV kernel takes a walked
//    tile's pair by 16-byte cp.async.  Over the key tiles up to its causal
//    limit (32 keys a tile): S = Q K^T, dP = dO V^T (4 x 4 micro-tiles), P =
//    exp(s S - lse) masked, dS = P (dP - D) into the warp's rows, dQ += dS K.
//  * flash_bwd_dkv_kernel, second -- one block per (64 keys, kv head x
//    split, batch) holding K and V.  It walks the query heads of its share
//    of the group and, in each, the 32-query tiles that see its keys
//    (causally dead tiles are never loaded; the offset skv - sq is the
//    forward's): S^T = K Q^T and dP^T = V dO^T, P^T = exp(s S^T - lse)
//    masked into the warp's rows, dV += P^T dO, then dS^T = P^T (dP^T - D)
//    in its place and dK += dS^T Q.
//  * flash_bwd_sum_kernel -- only where the plan splits a GQA group's query
//    heads over `splits` dK/dV blocks (the fewest that give every SM a
//    block): the blocks write fp32 partial dK/dV and this pass sums the
//    splits in order.
//
// dQ has a kernel of its own so that no sum crosses blocks, at the cost of
// computing S and dP twice (seven products where five would do), as on the
// wgmma route.  Inputs are read through their (b, h, s) strides, as in the
// forward: dout may be the transposed view autograd hands back for the
// model's (b, s, h, hd) layout.

// Shared memory in floats (kernels/flash_attention.py, `core_bwd_layout`):
// the two owned (64, hd) tiles, STAGES stages of the two walked (32, hd)
// tiles (and, dK/dV, their 32 lse and 32 D), the (64, 32) P / dS tile.
// 3 stages up to hd 64, 2 beyond: two blocks an SM up to hd 96.
template <int HD>
struct CoreBwd {
    static constexpr int C = 32;
    static constexpr int STAGES = HD <= 64 ? 3 : 2;
    static constexpr int RS = HD + 4, PS = C + 8;
    static constexpr int TILE = C * RS;
    static constexpr int OWN = 2 * CORE_ROWS * RS;
    static constexpr int STAGE_DKV = 2 * TILE + 2 * C;
    static constexpr int STAGE_DQ = 2 * TILE;
    static constexpr size_t bytes_dkv = sizeof(float) * (OWN + STAGES * STAGE_DKV + CORE_ROWS * PS);
    static constexpr size_t bytes_dq = sizeof(float) * (OWN + STAGES * STAGE_DQ + CORE_ROWS * PS);
};

// `stats`: lse of each (b, hq) row at [0, rows_pad), D at [rows_pad, 2 rows_pad),
// rows sq_pad apart.
template <typename T, int HD>
__global__ void __launch_bounds__(CORE_NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ o_res, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ stats, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
                    int group, int sq, int skv, int sq_pad, long long rows_pad, int n_q_tiles,
                    float sm_scale, int causal, int vec) {
    using L = CoreBwd<HD>;
    using CC = CoreCols<HD>;
    constexpr int C = L::C, CJ = C / CORE_TX, NC = HD / CORE_TX, RS = L::RS, PS = L::PS;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* dOs = Qs + CORE_ROWS * RS;
    float* ring = smem + L::OWN;
    float* dSs = ring + L::STAGES * L::STAGE_DQ;

    const int tid = threadIdx.x, tx = tid % CORE_TX, ty = tid / CORE_TX;
    const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);   // heaviest first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hq = gridDim.y;
    const int q0 = q_tile * CORE_ROWS;
    const int off = skv - sq;
    const T* kb = k + b * ks.b + (h / group) * ks.h;
    const T* vb = v + b * vs.b + (h / group) * vs.h;
    const int kv_end = causal ? min(skv, min(q0 + CORE_ROWS, sq) + off) : skv;
    const int n_tiles = (kv_end + C - 1) / C;

    CoreHeld<T, HD, C, CORE_HELD_BWD_HD> held;   // as in the forward
    auto issue = [&](int t) {
        if (t < n_tiles) {
            if constexpr (CoreHeld<T, HD, C, CORE_HELD_BWD_HD>::used) {
                held.template fetch<0>(kb, ks.s, t * C, skv);
                held.template fetch<1>(vb, vs.s, t * C, skv);
            } else {
                float* st = ring + (t % L::STAGES) * L::STAGE_DQ;
                core_load<T, HD, C>(st, kb, ks.s, t * C, skv, vec);
                core_load<T, HD, C>(st + L::TILE, vb, vs.s, t * C, skv, vec);
            }
        }
        core_commit();
    };
    auto place = [&](int t) {
        if constexpr (CoreHeld<T, HD, C, CORE_HELD_BWD_HD>::used) {
            if (t < n_tiles) {
                float* st = ring + (t % L::STAGES) * L::STAGE_DQ;
                held.template put<0>(st);
                held.template put<1>(st + L::TILE);
            }
        }
    };
    core_load<T, HD, CORE_ROWS>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, sq, vec);
    core_load<T, HD, CORE_ROWS>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, sq, vec);
#pragma unroll
    for (int t = 0; t < L::STAGES - 1; ++t) {
        issue(t);
        place(t);
    }
    core_wait<L::STAGES - 2>();
    __syncthreads();   // Q, dO and the first K/V tile have landed

    // D = rowsum(dO * O) of the owned rows, over the 8 lanes that share a row;
    // O = out + o_res where the forward kept what rounding out dropped
    const long long row0 = (static_cast<long long>(b) * hq + h) * sq_pad + q0;
    const T* ob = o + b * os.b + h * os.h;
    const T* rb = o_res == nullptr ? nullptr : o_res + b * os.b + h * os.h;
    float lse_r[CORE_RI], d_r[CORE_RI], acc[CORE_RI][NC];
#pragma unroll
    for (int i = 0; i < CORE_RI; ++i) {
        const int r = ty + CORE_TY * i, row = q0 + r;
        float sum = 0.f;
        if (row < sq) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const long long at = row * os.s + CC::col(tx, c);
                const float ov = to_f32(ob[at]) + (rb == nullptr ? 0.f : to_f32(rb[at]));
                sum = fmaf(dOs[r * RS + CC::col(tx, c)], ov, sum);
            }
        }
#pragma unroll
        for (int w = 1; w < CORE_TX; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
        d_r[i] = sum;
        lse_r[i] = row < sq ? lse[(static_cast<long long>(b) * hq + h) * sq + row] : 0.f;
        if (tx == 0) {
            stats[row0 + r] = lse_r[i];
            stats[rows_pad + row0 + r] = d_r[i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
        if (t > 0) {
            core_wait<L::STAGES - 2>();
            __syncthreads();   // tile t has landed; every thread is done with tile t - 1
        }
        issue(t + L::STAGES - 1);
        const float* Ks = ring + (t % L::STAGES) * L::STAGE_DQ;
        const float* Vs = Ks + L::TILE;
        const int k0 = t * C;

        float s[CORE_RI][CJ], dp[CORE_RI][CJ];
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
        core_dot<CJ, HD, RS, RS>(s, Qs, Ks, ty, tx);
        core_dot<CJ, HD, RS, RS>(dp, dOs, Vs, ty, tx);
        const bool full = k0 + C <= skv && q0 + CORE_ROWS <= sq &&
                          (!causal || k0 + C - 1 <= q0 + off);
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const int q_pos = q0 + ty + CORE_TY * i, k_pos = k0 + tx + CORE_TX * j;
                const bool valid =
                    full || (q_pos < sq && k_pos < skv && (!causal || q_pos + off >= k_pos));
                const float p = valid ? core_exp(fmaf(s[i][j], sm_scale, -lse_r[i])) : 0.f;
                dSs[(ty + CORE_TY * i) * PS + tx + CORE_TX * j] = p * (dp[i][j] - d_r[i]);
            }
        __syncwarp();   // the warp's dS rows are written
        core_mul<HD, C, PS, RS>(acc, dSs, Ks, ty, tx);   // dQ += dS K
        __syncwarp();   // and read, before the next tile's are written
        place(t + L::STAGES - 1);
    }

    T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int i = 0; i < CORE_RI; ++i) {
        const int row = q0 + ty + CORE_TY * i;
        if (row < sq) core_store<T, HD>(dqb + row * dqs.s, acc[i], sm_scale, tx, vec);
    }
}

// `partial`: null (one split: dk and dv written here), or the fp32
// [2][splits][b][hkv][skv][hd] workspace of unscaled dK, then dV.
template <typename T, int HD>
__global__ void __launch_bounds__(CORE_NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ stats,
                     T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partial,
                     Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                     int group, int splits, int hq, int sq, int skv, int sq_pad,
                     long long rows_pad, float sm_scale, int causal, int vec) {
    using L = CoreBwd<HD>;
    constexpr int C = L::C, CJ = C / CORE_TX, NC = HD / CORE_TX, RS = L::RS, PS = L::PS;
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;
    float* Vs = Ks + CORE_ROWS * RS;
    float* ring = smem + L::OWN;
    float* Ps = ring + L::STAGES * L::STAGE_DKV;

    const int tid = threadIdx.x, tx = tid % CORE_TX, ty = tid / CORE_TX;
    const int hkv = gridDim.y / splits;
    const int hk = blockIdx.y / splits, split = blockIdx.y % splits, b = blockIdx.z;
    const int share = group / splits;
    const int h_first = hk * group + split * share;
    const int k0 = blockIdx.x * CORE_ROWS;
    const int off = skv - sq;   // causal offset: query i sees keys <= i + off
    // the first query tile that sees key k0, and the tiles a head walks
    const int first = causal ? max(0, k0 - off) / C : 0;
    const int per_head = (sq + C - 1) / C - first;
    const int n_walk = share * per_head;

    CoreHeld<T, HD, C, CORE_HELD_BWD_HD> held;   // as in the forward
    auto issue = [&](int w) {   // walked tile w: head h_first + w / per_head
        if (w < n_walk) {
            const int h = h_first + w / per_head, c0 = (first + w % per_head) * C;
            float* st = ring + (w % L::STAGES) * L::STAGE_DKV;
            if constexpr (CoreHeld<T, HD, C, CORE_HELD_BWD_HD>::used) {
                held.template fetch<0>(q + b * qs.b + h * qs.h, qs.s, c0, sq);
                held.template fetch<1>(dout + b * dos.b + h * dos.h, dos.s, c0, sq);
            } else {
                core_load<T, HD, C>(st, q + b * qs.b + h * qs.h, qs.s, c0, sq, vec);
                core_load<T, HD, C>(st + L::TILE, dout + b * dos.b + h * dos.h, dos.s, c0, sq, vec);
            }
            if (tid < 2 * C / 4) {   // lse and D: 16-byte pieces of the padded workspace
                const int half = tid / (C / 4), piece = tid % (C / 4);
                core_cp16(st + 2 * L::TILE + half * C + 4 * piece,
                          stats + half * rows_pad + (static_cast<long long>(b) * hq + h) * sq_pad +
                              c0 + 4 * piece,
                          true);
            }
        }
        core_commit();
    };
    auto place = [&](int w) {
        if constexpr (CoreHeld<T, HD, C, CORE_HELD_BWD_HD>::used) {
            if (w < n_walk) {
                float* st = ring + (w % L::STAGES) * L::STAGE_DKV;
                held.template put<0>(st);
                held.template put<1>(st + L::TILE);
            }
        }
    };
    core_load<T, HD, CORE_ROWS>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, skv, vec);
    core_load<T, HD, CORE_ROWS>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, skv, vec);
#pragma unroll
    for (int w = 0; w < L::STAGES - 1; ++w) {
        issue(w);
        place(w);
    }

    float acc_k[CORE_RI][NC], acc_v[CORE_RI][NC];
#pragma unroll
    for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    for (int w = 0; w < n_walk; ++w) {
        core_wait<L::STAGES - 2>();
        __syncthreads();   // tile w has landed; every thread is done with tile w - 1
        issue(w + L::STAGES - 1);
        const float* st = ring + (w % L::STAGES) * L::STAGE_DKV;
        const float* Qs = st;
        const float* dOs = st + L::TILE;
        const float* lse_s = st + 2 * L::TILE;
        const float* d_s = lse_s + C;
        const int c0 = (first + w % per_head) * C;

        float s[CORE_RI][CJ], dp[CORE_RI][CJ];
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
        core_dot<CJ, HD, RS, RS>(s, Ks, Qs, ty, tx);    // S^T: keys x queries
        core_dot<CJ, HD, RS, RS>(dp, Vs, dOs, ty, tx);  // dP^T
        const bool full = k0 + CORE_ROWS <= skv && c0 + C <= sq &&
                          (!causal || c0 + off >= k0 + CORE_ROWS - 1);
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const int col = tx + CORE_TX * j;
                const int k_pos = k0 + ty + CORE_TY * i, q_pos = c0 + col;
                const bool valid =
                    full || (k_pos < skv && q_pos < sq && (!causal || q_pos + off >= k_pos));
                const float p = valid ? core_exp(fmaf(s[i][j], sm_scale, -lse_s[col])) : 0.f;
                Ps[(ty + CORE_TY * i) * PS + col] = p;
                dp[i][j] = p * (dp[i][j] - d_s[col]);   // dS^T
            }
        __syncwarp();
        core_mul<HD, C, PS, RS>(acc_v, Ps, dOs, ty, tx);   // dV += P^T dO
        __syncwarp();
#pragma unroll
        for (int i = 0; i < CORE_RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) Ps[(ty + CORE_TY * i) * PS + tx + CORE_TX * j] = dp[i][j];
        __syncwarp();
        core_mul<HD, C, PS, RS>(acc_k, Ps, Qs, ty, tx);    // dK += dS^T Q
        __syncwarp();
        place(w + L::STAGES - 1);
    }

    using CC = CoreCols<HD>;
#pragma unroll
    for (int i = 0; i < CORE_RI; ++i) {
        const int row = k0 + ty + CORE_TY * i;
        if (row >= skv) continue;
        if (partial == nullptr) {
            core_store<T, HD>(dk + b * dks.b + hk * dks.h + row * dks.s, acc_k[i], sm_scale, tx, vec);
            core_store<T, HD>(dv + b * dvs.b + hk * dvs.h + row * dvs.s, acc_v[i], 1.f, tx, vec);
        } else {
            const long long elems = static_cast<long long>(gridDim.z) * hkv * skv * HD;
            const long long e = ((static_cast<long long>(b) * hkv + hk) * skv + row) * HD;
            float* pk = partial + split * elems + e;
            float* pv = partial + (splits + split) * elems + e;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                pk[CC::col(tx, c)] = acc_k[i][c];
                pv[CC::col(tx, c)] = acc_v[i][c];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Backward, bf16 on the tensor cores: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------
//
// Aligned bf16 (the training path) takes this route, built from the
// forward's pieces.  Two launches of one kernel template, each block owning
// 128 rows of one side (two consumer warpgroups of 64) and walking tiles of
// the other side, and for a split GQA group a sum after them:
//
//  * flash_bwd_wgmma_kernel<HD, false> (dQ), first -- owns 128 queries of a
//    q head (Q and dO), computes their D = rowsum(dO * O) and lse * log2(e)
//    and stores them, zeros past sq, in a (b, hq, sq_pad) workspace whose
//    rows are padded to the block's 128, so that a walked tile's lse and D
//    are one 16-byte-aligned bulk copy for the dK/dV kernel.  It walks the
//    key tiles up to the forward's causal limit (64 keys a tile): S = Q K^T
//    and dP = dO V^T (SS), dQ += dS K (RS, K read MN-major).
//  * flash_bwd_wgmma_kernel<HD, true> (dK/dV), second -- owns 128 keys of
//    a kv head (K and V loaded once), walks the query heads of its share of
//    the group and, in each, the query tiles that see its keys (64 queries a
//    tile, 32 at hd 128).  Per tile: S^T = K Q^T and dP^T = V dO^T are SS products (both
//    operands K-major, as the forward's Q K^T); P^T = exp2(S^T scale2 - lse2)
//    masked and dS^T = P^T (dP^T - D) are rounded to bf16 in registers as A
//    fragments (the accumulator layout is the A layout, as the forward's P);
//    dV += P^T dO and dK += dS^T Q are RS products with dO and Q read
//    MN-major, as V in the forward's P V.
//  * flash_bwd_sum_kernel -- only when the plan splits a GQA group's query
//    heads over `splits` dK/dV blocks (so that the blocks fill the card: 16
//    of glm4-9b's 1024-key tiles x kv heads would leave 116 of 132 SMs idle):
//    each block then writes fp32 partial dK/dV into a workspace, and this
//    pass sums the splits in order and stores dk/dv in bf16.
//
// Each kernel runs a persistent grid, a block an SM walking work items (row
// tiles x heads x batch) heavy first; an item's owned rows load into one of
// two buffers while the other's item is computed.  One producer warp keeps
// the walked tiles in flight through a ring of BW_STAGES stages with
// full/empty mbarriers (Q, dO, lse and D for dK/dV; K and V for dQ), and
// `setmaxnreg` hands the producer's registers to the two consumer
// warpgroups, as in the forward.  ptxas allocates at most 168 registers a
// thread (384 threads a block) whatever `setmaxnreg` grants, and that sets
// the walked tiles' widths (64 rows; 32 queries in the dK/dV kernel at hd
// 128) and how a warpgroup runs them: in the dQ kernel a tile's RS product
// is issued with the next tile's S and dP and runs while its exponentials
// are computed, the two warpgroups taking turns to issue (ping-pong); the
// dK/dV kernel, whose dK and dV accumulators leave no room for that, runs
// its tiles one after the other.  No product is issued on a path that only
// some threads of a warpgroup take: every walked tile is computed, masked
// whole where none of a warpgroup's pairs sees it (a conditional issue made
// ptxas serialise every product, C7520).
//
// dQ has a kernel of its own so that no sum crosses blocks: the result is
// deterministic without a per-key-tile dQ workspace (16 tiles x 37.7 MB at
// minicpm-2b's step) and without atomics.  The cost is that S and dP are
// computed twice, seven products where five would do: the bound below counts
// five, so this design can reach at most 5/7 of it.  Heavy tiles go first:
// dK/dV blocks start at key tile 0 (which every query sees), dQ blocks at
// the last query tile; dK/dV starts at the first query tile that sees its
// keys (max(0, k0 - (skv - sq))), and dQ stops at the forward's limit.  Only
// tiles that cross the diagonal or a ragged end are masked.

constexpr int BW_ROWS = 128;      // rows a block owns: two consumer warpgroups of 64
constexpr int BW_STAGES = 3;      // walked tiles in flight
constexpr int BW_THREADS = 384;   // the two consumers and the producer

// Shared memory in bytes from a 1024-byte-aligned base: the two owned
// tensors (BW_ROWS rows each; slab 0, then slab 1), then BW_STAGES stages of
// [walked tensor 0 slab 0, slab 1, walked tensor 1 slab 0, slab 1, lse2, D].
// dK/dV: owned K, V; walked Q, dO and their lse2 and D.  dQ: owned Q, dO;
// walked K, V (the widths: `bwd_cols` in kernels/flash_attention.py).
template <int HD, bool kDKV>
struct BwLayout {
    static constexpr int W0 = Slabs<HD>::W0, W1 = Slabs<HD>::W1;
    static constexpr int COLS = kDKV && HD >= 128 ? 32 : 64;
    // dQ: a tile's products overlap the next tile's S, dP and exponentials.
    // dK/dV, whose dK and dV accumulators leave no room for a second tile's
    // (ptxas gives a thread 168 registers at 384 a block), runs its tiles one
    // after the other, 64 queries wide, which on an H100 was faster than
    // 32-query tiles overlapped.
    static constexpr bool overlap = !kDKV;
    static constexpr int OWN1 = BW_ROWS * W0 * 2;    // slab 1 of an owned tensor
    static constexpr int OWN_B = BW_ROWS * HD * 2;   // owned tensor 1
    static constexpr int OWN = 2 * OWN_B;
    static constexpr int T1 = COLS * W0 * 2;         // slab 1 of a walked tensor
    static constexpr int TB = COLS * HD * 2;         // walked tensor 1
    static constexpr int VEC = 2 * TB;               // lse2, then D (dK/dV)
    static constexpr int LOADED = 2 * TB + (kDKV ? 2 * COLS * 4 : 0);
    static constexpr int STAGE = (LOADED + 1023) / 1024 * 1024;
    static constexpr int smem = 1024 + 2 * OWN + BW_STAGES * STAGE;
};

struct BwdMaps {
    CUtensorMap own[2][2], walk[2][2];   // [tensor][slab]
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}

// D (64 x 64, fp32) {+}= A (64 x 16) * B (16 x 64); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, fp32) {+}= A (64 x 16) * B (16 x 32); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
    if constexpr (N == 64) {
        wgmma_ss_n64(d, desc_a, desc_b, accumulate);
    } else {
        static_assert(N == 32, "walked tiles are 32 or 64 rows");
        wgmma_ss_n32(d, desc_a, desc_b, accumulate);
    }
}

// 2^x on the special-function unit (relative error 2^-22; results below
// 2^-126 flush to zero, where a probability no longer counts).
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// kDKV: the dK/dV kernel (out0 = dk, out1 = dv, grid (key tiles, hkv *
// splits, b)); else the dQ kernel (out0 = dq, grid (query tiles, hq, b)).
// `partial`: null, or (splits > 1) the fp32 [2][splits][b][hkv][skv][hd]
// workspace of dK, then dV.  Accumulator fragments as in the forward: thread
// `lane` of warp w holds, for each 8-column chunk c, elements 4c + e at row
// w * 16 + lane / 4 + 8 (e >> 1) and column 8c + 2 (lane % 4) + (e & 1).
template <int HD, bool kDKV>
__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ BwdMaps maps, float* __restrict__ stats,
                       const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ o_res,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, Strides os, Strides dos,
                       __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1,
                       float* __restrict__ partial, Strides s0, Strides s1, int group, int splits,
                       int hq, int sq, int skv, int sq_pad, long long rows_pad, float scale2,
                       float sm_scale, int causal, int work_x, int work_y, int work_z) {
    using L = BwLayout<HD, kDKV>;
    constexpr int W0 = L::W0, W1 = L::W1, COLS = L::COLS;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // owned full[2], owned empty[2], walked full[], walked empty[]
    __shared__ __align__(8) uint64_t bars[4 + 2 * BW_STAGES];

    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* const base_ptr = smem_raw + (base - raw);
    const uint32_t stages = base + 2 * L::OWN;   // the walked tiles' ring, after two owned buffers
    const uint32_t own_full0 = smem_u32(&bars[0]);
    const uint32_t own_empty0 = smem_u32(&bars[2]);
    const uint32_t full0 = smem_u32(&bars[4]);
    const uint32_t empty0 = smem_u32(&bars[4 + BW_STAGES]);
    const int tid = threadIdx.x;
    const int off = skv - sq;   // causal offset: query i sees keys <= i + off
    // The work is a grid of items (row tiles, heads [x splits], batch), walked
    // by a persistent grid: block k takes items k, k + gridDim.x, ...; item
    // order is batch by batch, and in a batch the heavy row tiles of every
    // head first.  An item's owned rows load into one of two buffers while
    // the other's item is computed.
    struct Item {
        int b, r0, hk, split, h0, first, per_head, n_steps;
    };
    const int n_items = work_x * work_y * work_z;
    const int n_heads = kDKV ? group / splits : 1;
    const int hkv = kDKV ? work_y / splits : hq / group;
    auto decode = [&](int item) {
        Item it;
        it.b = item / (work_x * work_y);
        const int lin = item % (work_x * work_y);
        const int tile = kDKV ? lin / work_y : work_x - 1 - lin / work_y;
        it.r0 = tile * BW_ROWS;
        const int idx = lin % work_y;
        // dK/dV: kv head and split; dQ: q head and its kv head
        it.hk = kDKV ? idx / splits : idx / group;
        it.split = kDKV ? idx % splits : 0;
        it.h0 = kDKV ? it.hk * group + it.split * n_heads : idx;
        // the walked tiles: dK/dV, in each of its heads, the query tiles from
        // the first that sees key r0; dQ, the key tiles up to its last row's limit
        int n_walk;
        it.first = 0;
        if (kDKV) {
            it.first = causal ? max(0, it.r0 - off) / COLS : 0;
            n_walk = (sq + COLS - 1) / COLS;
        } else {
            const int end = causal ? min(skv, min(it.r0 + BW_ROWS, sq) + off) : skv;
            n_walk = (end + COLS - 1) / COLS;
        }
        // step u walks tile first + u % per_head of head h0 + u / per_head
        it.per_head = max(0, n_walk - it.first);
        it.n_steps = n_heads * it.per_head;
        return it;
    };

    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(own_full0 + 8 * i, 1);
            mbar_init(own_empty0 + 8 * i, 256);
        }
        for (int s = 0; s < BW_STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 256);   // every consumer thread releases a stage
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // One if/else for the whole kernel: `setmaxnreg` is ignored where the
    // roles' paths meet again.
    if (tid >= 256) {
        // ---- producer warpgroup: its first thread issues every load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == 256) {
            int t = 0;   // the ring's step, across items
            for (int item = blockIdx.x, j = 0; item < n_items; item += gridDim.x, ++j) {
                const Item it = decode(item);
                // owned rows: dK/dV K, V of kv head hk; dQ Q, dO of q head h0
                const int ob = j & 1;
                if (j >= 2) mbar_wait_or_trap(own_empty0 + 8 * ob, ((j >> 1) - 1) & 1);
                const uint32_t own_full = own_full0 + 8 * ob;
                const uint32_t ow = base + ob * L::OWN;
                const int oh = kDKV ? it.hk : it.h0;
                mbar_expect_tx(own_full, L::OWN);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    tma_load_4d(ow + i * L::OWN_B, &maps.own[i][0], own_full, 0, it.r0, oh, it.b);
                    if constexpr (W1 > 0)
                        tma_load_4d(ow + i * L::OWN_B + L::OWN1, &maps.own[i][1], own_full, W0, it.r0,
                                    oh, it.b);
                }
                for (int u = 0; u < it.n_steps; ++u, ++t) {
                    const int wh = kDKV ? it.h0 + u / it.per_head : it.hk;   // the walked head
                    const int s = t % BW_STAGES;
                    if (t >= BW_STAGES) mbar_wait_or_trap(empty0 + 8 * s, (t / BW_STAGES - 1) & 1);
                    const uint32_t full = full0 + 8 * s;
                    const uint32_t st = stages + s * L::STAGE;
                    const int c0 = (it.first + u % it.per_head) * COLS;
                    mbar_expect_tx(full, L::LOADED);
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        tma_load_4d(st + i * L::TB, &maps.walk[i][0], full, 0, c0, wh, it.b);
                        if constexpr (W1 > 0)
                            tma_load_4d(st + i * L::TB + L::T1, &maps.walk[i][1], full, W0, c0, wh, it.b);
                    }
                    if constexpr (kDKV) {
                        const float* lse_row =
                            stats + (static_cast<long long>(it.b) * hq + wh) * sq_pad + c0;
                        bulk_load(st + L::VEC, lse_row, COLS * 4, full);
                        bulk_load(st + L::VEC + COLS * 4, lse_row + rows_pad, COLS * 4, full);
                    }
                }
            }
        }
    } else {
        // ---- consumer warpgroups: 64 owned rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = tid / 128;
        const int warp = (tid % 128) / 32, lane = tid % 32;
        const int row0 = warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
        const int col = 2 * (lane % 4);          // its first column in each 8-column chunk
        const int rows_end = kDKV ? skv : sq;
        int t0 = 0;   // the ring's step of the item's first tile
        for (int item = blockIdx.x, j = 0; item < n_items; item += gridDim.x, ++j) {
            const Item it = decode(item);
            const int b = it.b, hk = it.hk, split = it.split, h0 = it.h0;
            const int first = it.first, per_head = it.per_head, n_steps = it.n_steps;
            const int rw0 = it.r0 + 64 * wg;         // the warpgroup's first owned row
            const uint32_t ow = base + (j & 1) * L::OWN;
            const uint32_t a0 = ow + 64 * wg * W0 * 2;              // owned tensor 0 (K or Q)
            const uint32_t a1 = ow + L::OWN1 + 64 * wg * W1 * 2;
            const uint32_t b0 = a0 + L::OWN_B;                      // owned tensor 1 (V or dO)
            const uint32_t b1 = a1 + L::OWN_B;

            float s[COLS / 2], dp[COLS / 2];
            uint32_t pa[COLS / 4], da[COLS / 4];
#pragma unroll
            for (int i = 0; i < COLS / 2; ++i) s[i] = dp[i] = 0.f;
            float acc0_lo[W0 / 2], acc0_hi[W1 > 0 ? W1 / 2 : 1];   // dK or dQ
            float acc1_lo[kDKV ? W0 / 2 : 1], acc1_hi[kDKV && W1 > 0 ? W1 / 2 : 1];   // dV
#pragma unroll
            for (int i = 0; i < W0 / 2; ++i) acc0_lo[i] = 0.f;
#pragma unroll
            for (int i = 0; i < (W1 > 0 ? W1 / 2 : 1); ++i) acc0_hi[i] = 0.f;
#pragma unroll
            for (int i = 0; i < (kDKV ? W0 / 2 : 1); ++i) acc1_lo[i] = 0.f;
#pragma unroll
            for (int i = 0; i < (kDKV && W1 > 0 ? W1 / 2 : 1); ++i) acc1_hi[i] = 0.f;
            // dQ: lse2 = lse log2(e) and D = rowsum(dO * O) of this thread's two
            // rows (zeros past sq), each lane of a quad summing a quarter of the
            // row in order; stored in the padded workspace for the dK/dV kernel,
            // which runs after this one
            float row_l2[2] = {0.f, 0.f}, row_d[2] = {0.f, 0.f};
            if constexpr (!kDKV) {
                const int quarter = (lane % 4) * (HD / 4);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int row = rw0 + row0 + 8 * e;
                    float sum = 0.f;
                    if (row < sq) {
                        const long long at = b * os.b + h0 * os.h + row * os.s + quarter;
                        const __nv_bfloat16* orow = o + at;
                        const __nv_bfloat16* drow = dout + b * dos.b + h0 * dos.h + row * dos.s + quarter;
#pragma unroll
                        for (int p = 0; p < HD / 8; ++p) {
                            float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(orow)[p]);
                            if (o_res != nullptr) {   // O = out + what rounding dropped
                                const float2 lo = __bfloat1622float2(
                                    reinterpret_cast<const __nv_bfloat162*>(o_res + at)[p]);
                                x.x += lo.x;
                                x.y += lo.y;
                            }
                            const float2 d = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(drow)[p]);
                            sum = fmaf(d.y, x.y, fmaf(d.x, x.x, sum));
                        }
                        row_l2[e] = lse[(static_cast<long long>(b) * hq + h0) * sq + row] * LOG2E;
                    }
                    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
                    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
                    row_d[e] = sum;
                    if (lane % 4 == 0) {
                        const long long r = (static_cast<long long>(b) * hq + h0) * sq_pad + row;
                        stats[r] = row_l2[e];
                        stats[rows_pad + r] = sum;
                    }
                }
            }

            // S (S^T) and dP (dP^T) of the tile in stage `st`, one k-step per 16
            // columns of each head-dim slab.  A descriptor's low 14 bits are the
            // address in 16-byte units, so a k-step (32 bytes) adds 2 to it.
            const uint64_t own_a0 = desc_k_major(a0, W0), own_a1 = desc_k_major(a1, W1);
            const uint64_t own_b0 = desc_k_major(b0, W0), own_b1 = desc_k_major(b1, W1);
            auto issue_ss = [&](uint32_t st) {
                const uint64_t w0 = desc_k_major(st, W0), w1 = desc_k_major(st + L::T1, W1);
                const uint64_t x0 = desc_k_major(st + L::TB, W0), x1 = desc_k_major(st + L::TB + L::T1, W1);
#pragma unroll
                for (int kk = 0; kk < W0 / 16; ++kk)
                    wgmma_ss<COLS>(s, own_a0 + 2 * kk, w0 + 2 * kk, kk > 0);
                if constexpr (W1 > 0) {
#pragma unroll
                    for (int kk = 0; kk < W1 / 16; ++kk) wgmma_ss<COLS>(s, own_a1 + 2 * kk, w1 + 2 * kk, 1);
                }
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < W0 / 16; ++kk)
                    wgmma_ss<COLS>(dp, own_b0 + 2 * kk, x0 + 2 * kk, kk > 0);
                if constexpr (W1 > 0) {
#pragma unroll
                    for (int kk = 0; kk < W1 / 16; ++kk) wgmma_ss<COLS>(dp, own_b1 + 2 * kk, x1 + 2 * kk, 1);
                }
                wgmma_commit();
            };
            // acc {+}= frag (64 x COLS, bf16 A fragments) times the walked tensor
            // at `addr` (COLS x HD, read MN-major), one product per slab and 16
            // rows (16 rows of a slab of width w: 32 w bytes, 2 w in the descriptor)
            auto issue_rs = [&](float (&lo)[W0 / 2], float (&hi)[W1 > 0 ? W1 / 2 : 1],
                                const uint32_t* frag, uint32_t addr) {
                const uint64_t m0 = desc_mn_major(addr, W0), m1 = desc_mn_major(addr + L::T1, W1);
#pragma unroll
                for (int kk = 0; kk < COLS / 16; ++kk) {
                    wgmma_rs<W0>(lo, frag + 4 * kk, m0 + 2 * W0 * kk);
                    if constexpr (W1 > 0) wgmma_rs<W1>(hi, frag + 4 * kk, m1 + 2 * W1 * kk);
                }
            };
            auto pack = [&](uint32_t (&frag)[COLS / 4], const float (&x)[COLS / 2]) {
#pragma unroll
                for (int kk = 0; kk < COLS / 16; ++kk) {
                    frag[4 * kk + 0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
                    frag[4 * kk + 1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
                    frag[4 * kk + 2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
                    frag[4 * kk + 3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
                }
            };

            // Ping-pong, as in the forward: the two consumer warpgroups take turns
            // to issue their products (named barriers 1 and 2), so that one's
            // exponentials run while the other's products hold the tensor cores.
            // Each takes one turn a walked tile and one to finish; warpgroup 0
            // takes the first, warpgroup 1 skips its last hand-over.
            constexpr bool ping_pong = L::overlap;
            int turns_left = n_steps + 1;
            auto begin_turn = [&]() {
                if constexpr (ping_pong) named_sync(1 + wg);
            };
            auto end_turn = [&]() {
                if constexpr (ping_pong) {
                    if (wg == 0 || --turns_left > 0) named_arrive(2 - wg);
                }
            };
            if constexpr (ping_pong) {
                if (wg == 1) named_arrive(1);
            }
            auto fence_all = [&]() {
                fence_regs(pa);
                fence_regs(da);
                fence_regs(acc0_lo);
                fence_regs(acc0_hi);
                fence_regs(acc1_lo);
                fence_regs(acc1_hi);
            };
            // step u of the item is the ring's step t0 + u
            auto stage_addr = [&](int u) { return stages + ((t0 + u) % BW_STAGES) * L::STAGE; };
            // dV += P^T dO and dK += dS^T Q, or dQ += dS K, from step u's tile
            auto issue_products = [&](int u) {
                const uint32_t st = stage_addr(u);
                if constexpr (kDKV) issue_rs(acc1_lo, acc1_hi, pa, st + L::TB);
                issue_rs(acc0_lo, acc0_hi, da, st);
                wgmma_commit();
            };
            auto wait_full = [&](int u) {
                const int t = t0 + u;
                mbar_wait_or_trap(full0 + 8 * (t % BW_STAGES), (t / BW_STAGES) & 1);
            };
            auto release = [&](int u) { mbar_arrive(empty0 + 8 * ((t0 + u) % BW_STAGES)); };
            auto issue_ss_of = [&](int u) { issue_ss(stage_addr(u)); };
            // Once step t's S is ready (dP may still run): P, then dS, both packed
            // as bf16 A fragments.  Every tile is computed: one that none of this
            // warpgroup's pairs sees is masked whole, so that no product is
            // issued on a path that only some warpgroups take (ptxas would then
            // serialise every product, C7520).
            auto grads = [&](int u) {
                const int c0 = (first + u % per_head) * COLS;   // the tile's first walked row
                const float* vec = reinterpret_cast<const float*>(
                    base_ptr + (stage_addr(u) - base) + L::VEC);
                const bool masked = kDKV ? c0 + COLS > sq || (causal && c0 + off < rw0 + 63)
                                         : c0 + COLS > skv || (causal && c0 + COLS - 1 > rw0 + off);
                fence_regs(s);
                // P = exp2(S scale2 - lse2)
#pragma unroll
                for (int c = 0; c < COLS / 8; ++c) {
                    float2 l2 = make_float2(row_l2[0], row_l2[1]);
                    if constexpr (kDKV) l2 = *reinterpret_cast<const float2*>(vec + 8 * c + col);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float lv = kDKV ? ((e & 1) ? l2.y : l2.x) : ((e >> 1) ? l2.y : l2.x);
                        s[4 * c + e] = fast_exp2(fmaf(s[4 * c + e], scale2, -lv));
                    }
                }
                // zero where masked, only in tiles that cross the diagonal or an end
                if (masked) {
#pragma unroll
                    for (int c = 0; c < COLS / 8; ++c)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int r = rw0 + row0 + 8 * (e >> 1);
                            const int w = c0 + 8 * c + col + (e & 1);
                            // dK/dV: r is a key, w a query; dQ: r a query, w a key
                            const int qp = kDKV ? w : r, kp = kDKV ? r : w;
                            const bool out = kDKV ? qp >= sq : kp >= skv;
                            if (out || (causal && qp + off < kp)) s[4 * c + e] = 0.f;
                        }
                }
                wgmma_wait<0>();
                fence_regs(dp);
                // dS = P (dP - D)
#pragma unroll
                for (int c = 0; c < COLS / 8; ++c) {
                    float2 dd = make_float2(row_d[0], row_d[1]);
                    if constexpr (kDKV) dd = *reinterpret_cast<const float2*>(vec + COLS + 8 * c + col);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float dv = kDKV ? ((e & 1) ? dd.y : dd.x) : ((e >> 1) ? dd.y : dd.x);
                        dp[4 * c + e] = s[4 * c + e] * (dp[4 * c + e] - dv);
                    }
                }
                pack(da, dp);
                if constexpr (kDKV) pack(pa, s);
            };

            mbar_wait_or_trap(own_full0 + 8 * (j & 1), (j >> 1) & 1);
            if (n_steps == 0) {
                begin_turn();
                end_turn();
            } else if constexpr (L::overlap) {
                // Step u's products are issued with step u + 1's S and dP and run
                // while its exponentials are computed.
                wait_full(0);
                fence_all();
                begin_turn();
                wgmma_fence();
                issue_ss_of(0);
                end_turn();
                wgmma_wait<1>();
                grads(0);
                for (int u = 1; u < n_steps; ++u) {
                    wait_full(u);
                    fence_all();
                    begin_turn();
                    wgmma_fence();
                    issue_products(u - 1);
                    issue_ss_of(u);
                    end_turn();
                    wgmma_wait<1>();   // step u - 1's products and step u's S are done
                    fence_all();
                    release(u - 1);
                    grads(u);
                }
                fence_all();
                begin_turn();
                wgmma_fence();
                issue_products(n_steps - 1);
                end_turn();
                wgmma_wait<0>();
                fence_all();
                release(n_steps - 1);
            } else {
                // One tile after the other: S and dP, P and dS, then the products.
                for (int u = 0; u < n_steps; ++u) {
                    wait_full(u);
                    fence_all();
                    wgmma_fence();
                    issue_ss_of(u);
                    wgmma_wait<1>();
                    grads(u);
                    fence_all();
                    wgmma_fence();
                    issue_products(u);
                    wgmma_wait<0>();
                    fence_all();
                    release(u);
                }
            }
            // the owned buffer is free: every product that read it has completed
            mbar_arrive(own_empty0 + 8 * (j & 1));
            t0 += n_steps;

            // epilogue: rows below rows_end; dK and dQ carry the softmax scale
            const int hb = kDKV ? hk : h0;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = rw0 + row0 + 8 * r;
                if (row >= rows_end) continue;
                if constexpr (kDKV) {
                    if (partial != nullptr) {
                        const long long elems = static_cast<long long>(work_z) * hkv * skv * HD;
                        float* pk = partial + split * elems +
                                    ((static_cast<long long>(b) * hkv + hk) * skv + row) * HD;
                        float* pv = pk + splits * elems;
#pragma unroll
                        for (int c = 0; c < W0 / 8; ++c) {
                            *reinterpret_cast<float2*>(pk + 8 * c + col) =
                                make_float2(acc0_lo[4 * c + 2 * r], acc0_lo[4 * c + 2 * r + 1]);
                            *reinterpret_cast<float2*>(pv + 8 * c + col) =
                                make_float2(acc1_lo[4 * c + 2 * r], acc1_lo[4 * c + 2 * r + 1]);
                        }
                        if constexpr (W1 > 0) {
#pragma unroll
                            for (int c = 0; c < W1 / 8; ++c) {
                                *reinterpret_cast<float2*>(pk + W0 + 8 * c + col) =
                                    make_float2(acc0_hi[4 * c + 2 * r], acc0_hi[4 * c + 2 * r + 1]);
                                *reinterpret_cast<float2*>(pv + W0 + 8 * c + col) =
                                    make_float2(acc1_hi[4 * c + 2 * r], acc1_hi[4 * c + 2 * r + 1]);
                            }
                        }
                        continue;
                    }
                }
                __nv_bfloat16* o0 = out0 + b * s0.b + hb * s0.h + row * s0.s + col;
#pragma unroll
                for (int c = 0; c < W0 / 8; ++c)
                    *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * c) = __floats2bfloat162_rn(
                        acc0_lo[4 * c + 2 * r] * sm_scale, acc0_lo[4 * c + 2 * r + 1] * sm_scale);
                if constexpr (W1 > 0) {
#pragma unroll
                    for (int c = 0; c < W1 / 8; ++c)
                        *reinterpret_cast<__nv_bfloat162*>(o0 + W0 + 8 * c) = __floats2bfloat162_rn(
                            acc0_hi[4 * c + 2 * r] * sm_scale, acc0_hi[4 * c + 2 * r + 1] * sm_scale);
                }
                if constexpr (kDKV) {
                    __nv_bfloat16* o1 = out1 + b * s1.b + hb * s1.h + row * s1.s + col;
#pragma unroll
                    for (int c = 0; c < W0 / 8; ++c)
                        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * c) =
                            __floats2bfloat162_rn(acc1_lo[4 * c + 2 * r], acc1_lo[4 * c + 2 * r + 1]);
                    if constexpr (W1 > 0) {
#pragma unroll
                        for (int c = 0; c < W1 / 8; ++c)
                            *reinterpret_cast<__nv_bfloat162*>(o1 + W0 + 8 * c) =
                                __floats2bfloat162_rn(acc1_hi[4 * c + 2 * r], acc1_hi[4 * c + 2 * r + 1]);
                    }
                }
            }
        }
    }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// dk = T(sm_scale * sum_j partial_k[j]) and dv = T(sum_j partial_v[j]), the
// splits summed in order; one thread per pair of columns (both routes).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ partial, T* __restrict__ dk, T* __restrict__ dv,
                     Strides dks, Strides dvs, int splits, int hkv, int skv, int hd,
                     long long pairs, float sm_scale) {
    const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    if (i >= pairs) return;
    const long long e = 2 * i, elems = 2 * pairs;
    const int d = static_cast<int>(e % hd);
    const long long rest = e / hd;
    const int row = static_cast<int>(rest % skv);
    const int hk = static_cast<int>((rest / skv) % hkv);
    const long long b = rest / (static_cast<long long>(skv) * hkv);
    float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
    for (int j = 0; j < splits; ++j) {
        const float2 pk = *reinterpret_cast<const float2*>(partial + j * elems + e);
        const float2 pv = *reinterpret_cast<const float2*>(partial + (splits + j) * elems + e);
        sk.x += pk.x;
        sk.y += pk.y;
        sv.x += pv.x;
        sv.y += pv.y;
    }
    store_pair(dk + b * dks.b + hk * dks.h + row * dks.s + d, sk.x * sm_scale, sk.y * sm_scale);
    store_pair(dv + b * dvs.b + hk * dvs.h + row * dvs.s + d, sv.x, sv.y);
}

// The backward's launch plan (kernels/flash_attention.py, `FlashBwdPlan.as_array`),
// int64: [0] route (0 = CUDA cores, 1 = wgmma), [1] rows a block owns, [2]
// queries of a tile the dK/dV kernel walks, [3] keys of a tile the dQ kernel
// walks, [4] stages, [5] threads, [6..8] the dQ grid, [9..11] the dK/dV grid,
// [12] / [13] the dK/dV / dQ kernel's dynamic shared memory bytes, [14] D-pass
// blocks (0: both routes compute D in the dQ kernel), [15] splits of a GQA
// group, [16] sq_pad (the lse / D row stride), [17] workspace bytes of the
// partial dK/dV, then on the wgmma route 8 tensor maps of 16 values each
// (PLAN_OPERANDS's layout): the dK/dV kernel's k, v, q, dout, then the dQ
// kernel's q, dout, k, v; on the CUDA cores [18] vector_loads.
constexpr int BWD_MAPS = 18;
constexpr int BWD_PLAN_LEN = BWD_MAPS + 8 * 16;

struct BwdArgs {
    const void *q, *k, *v, *o, *o_res, *dout;
    const float* lse;
    float* delta;
    float* workspace;
    void *dq, *dk, *dv;
    Strides qs, ks, vs, os, dos, dqs, dks, dvs;
    int b, hq, hkv, sq, skv, hd;
    float sm_scale;
    int causal;
};

// The plan's shared entries: grids and the D pass.
bool bwd_plan_grids_ok(const long long* plan, const BwdArgs& a, int rows, int dkv_y,
                       long long dot_blocks) {
    return plan[1] == rows && plan[6] == (a.sq + rows - 1) / rows && plan[7] == a.hq &&
           plan[8] == a.b && plan[9] == (a.skv + rows - 1) / rows && plan[10] == dkv_y &&
           plan[11] == a.b && plan[14] == dot_blocks && plan[14] <= 2147483647LL;
}

// The CUDA-core plan: 64 rows a block, 32-row walked tiles, the stages and
// both shared sizes of CoreBwd<HD>, 128 threads, no D pass, splits of a GQA
// group (a divisor), sq_pad = sq rounded up to 64, the partials' bytes, and
// at [18] vector_loads.
template <typename T, int HD>
int launch_bwd(const BwdArgs& a, const long long* plan, int vec, cudaStream_t stream) {
    using L = CoreBwd<HD>;
    const int group = a.hq / a.hkv;
    const long long splits = plan[15];
    const long long sq_pad = (a.sq + CORE_ROWS - 1) / CORE_ROWS * CORE_ROWS;
    if (splits < 1 || group % splits != 0 || a.hkv * splits > 65535) return cudaErrorInvalidValue;
    const long long workspace =
        splits > 1 ? 2 * splits * a.b * a.hkv * static_cast<long long>(a.skv) * HD * 4 : 0;
    if (plan[0] != 0 ||
        !bwd_plan_grids_ok(plan, a, CORE_ROWS, static_cast<int>(a.hkv * splits), 0) ||
        plan[2] != L::C || plan[3] != L::C || plan[4] != L::STAGES || plan[5] != CORE_NT ||
        plan[12] != static_cast<long long>(L::bytes_dkv) ||
        plan[13] != static_cast<long long>(L::bytes_dq) || plan[16] != sq_pad ||
        plan[17] != workspace || plan[BWD_MAPS] != vec)
        return cudaErrorInvalidValue;
    if ((splits > 1) != (a.workspace != nullptr)) return cudaErrorInvalidValue;
    if (splits > 1) {   // the ordered sum stores pairs of columns
        const void* outs[2] = {a.dk, a.dv};
        const Strides st[2] = {a.dks, a.dvs};
        for (int i = 0; i < 2; ++i)
            if (reinterpret_cast<uintptr_t>(outs[i]) % 8 != 0 || st[i].b % 2 || st[i].h % 2 ||
                st[i].s % 2)
                return cudaErrorInvalidValue;
    }
    auto dkv = flash_bwd_dkv_kernel<T, HD>;
    auto dq = flash_bwd_dq_kernel<T, HD>;
    cudaError_t err = allow_smem(dkv, L::bytes_dkv);
    if (err == cudaSuccess) err = allow_smem(dq, L::bytes_dq);
    if (err != cudaSuccess) return err;
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const long long rows_pad = static_cast<long long>(a.b) * a.hq * sq_pad;
    // dQ first: it also writes lse and D, which the dK/dV kernel reads
    dq<<<dim3(plan[6], a.hq, a.b), CORE_NT, L::bytes_dq, stream>>>(
        q, k, v, static_cast<const T*>(a.o), static_cast<const T*>(a.o_res), dout, a.lse, a.delta,
        static_cast<T*>(a.dq), a.qs,
        a.ks, a.vs, a.os, a.dos, a.dqs, group, a.sq, a.skv, static_cast<int>(sq_pad), rows_pad,
        static_cast<int>(plan[6]), a.sm_scale, a.causal, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkv<<<dim3(plan[9], plan[10], a.b), CORE_NT, L::bytes_dkv, stream>>>(
        q, k, v, dout, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.workspace, a.qs,
        a.ks, a.vs, a.dos, a.dks, a.dvs, group, static_cast<int>(splits), a.hq, a.sq, a.skv,
        static_cast<int>(sq_pad), rows_pad, a.sm_scale, a.causal, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const long long pairs = static_cast<long long>(a.b) * a.hkv * a.skv * HD / 2;
    flash_bwd_sum_kernel<T><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
        a.workspace, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dks, a.dvs,
        static_cast<int>(splits), a.hkv, a.skv, HD, pairs, a.sm_scale);
    return cudaGetLastError();
}

// The wgmma route's plan must describe exactly the kernels built for HD.
template <int HD>
bool bwd_wgmma_plan_ok(const long long* plan, const BwdArgs& a) {
    using KV = BwLayout<HD, true>;
    using Q = BwLayout<HD, false>;
    const int group = a.hq / a.hkv;
    const long long splits = plan[15];
    const long long sq_pad = (a.sq + BW_ROWS - 1) / BW_ROWS * BW_ROWS;
    if (splits < 1 || group % splits != 0 || a.hkv * splits > 65535) return false;
    const long long workspace =
        splits > 1 ? 2 * splits * a.b * a.hkv * static_cast<long long>(a.skv) * HD * 4 : 0;
    if (plan[0] != 1 || !bwd_plan_grids_ok(plan, a, BW_ROWS, static_cast<int>(a.hkv * splits), 0) ||
        plan[2] != KV::COLS || plan[3] != Q::COLS || plan[4] != BW_STAGES ||
        plan[5] != BW_THREADS || plan[12] != KV::smem || plan[13] != Q::smem ||
        plan[16] != sq_pad || plan[17] != workspace)
        return false;
    // per map: its tensor's rows and heads, and the box rows of its kernel
    const long long seq[8] = {a.skv, a.skv, a.sq, a.sq, a.sq, a.sq, a.skv, a.skv};
    const long long heads[8] = {a.hkv, a.hkv, a.hq, a.hq, a.hq, a.hq, a.hkv, a.hkv};
    const long long box[8] = {BW_ROWS, BW_ROWS, KV::COLS, KV::COLS, BW_ROWS, BW_ROWS, Q::COLS, Q::COLS};
    const int n_slabs = KV::W1 > 0 ? 2 : 1;
    for (int i = 0; i < 8; ++i) {
        const long long* op = plan + BWD_MAPS + 16 * i;
        if (op[0] != HD || op[1] != seq[i] || op[2] != heads[i] || op[3] != a.b || op[7] != n_slabs)
            return false;
        for (int j = 4; j < 7; ++j)
            if (op[j] <= 0 || op[j] % 16 != 0 || op[j] >= (1LL << 40)) return false;
        for (int j = 0; j < n_slabs; ++j) {
            const long long* sl = op + 8 + 4 * j;
            const int width = j == 0 ? KV::W0 : KV::W1;
            if (sl[0] != (j == 0 ? 0 : KV::W0) || sl[1] != width || sl[2] != 2 * width ||
                sl[3] != box[i])
                return false;
        }
    }
    return true;
}

template <int HD>
int launch_bwd_wgmma(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    using KV = BwLayout<HD, true>;
    using Q = BwLayout<HD, false>;
    if (!bwd_wgmma_plan_ok<HD>(plan, a)) return cudaErrorInvalidValue;
    const int splits = static_cast<int>(plan[15]);
    if ((splits > 1) != (a.workspace != nullptr)) return cudaErrorInvalidValue;
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    BwdMaps maps[2];   // the dK/dV kernel's, the dQ kernel's
    memset(maps, 0, sizeof(maps));
    const void* bases[8] = {a.k, a.v, a.q, a.dout, a.q, a.dout, a.k, a.v};
    for (int i = 0; i < 8; ++i) {
        const long long* op = plan + BWD_MAPS + 16 * i;
        BwdMaps& m = maps[i / 4];
        CUtensorMap* dst = i % 4 < 2 ? m.own[i % 2] : m.walk[i % 2];
        for (int j = 0; j < op[7]; ++j) {
            const CUresult res = encode_map(encode, &dst[j], bases[i], op, j);
            if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);
        }
    }
    auto dkv = flash_bwd_wgmma_kernel<HD, true>;
    auto dq = flash_bwd_wgmma_kernel<HD, false>;
    cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, KV::smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::smem);
    if (err != cudaSuccess) return err;
    const int sq_pad = static_cast<int>(plan[16]);
    const long long rows_pad = static_cast<long long>(a.b) * a.hq * sq_pad;
    using B = __nv_bfloat16;
    const int group = a.hq / a.hkv;
    const float scale2 = a.sm_scale * LOG2E;
    // persistent grids: one block an SM, or one an item where there are fewer
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long dq_items = plan[6] * plan[7] * plan[8], dkv_items = plan[9] * plan[10] * plan[11];
    if (dq_items > 2147483647LL || dkv_items > 2147483647LL) return cudaErrorInvalidValue;
    // dQ first: it also writes lse2 and D, which the dK/dV kernel reads
    dq<<<static_cast<unsigned>(std::min<long long>(dq_items, sms)), BW_THREADS, Q::smem, stream>>>(
        maps[1], a.delta, static_cast<const B*>(a.o), static_cast<const B*>(a.o_res),
        static_cast<const B*>(a.dout), a.lse, a.os,
        a.dos, static_cast<B*>(a.dq), nullptr, nullptr, a.dqs, a.dqs, group, 1, a.hq, a.sq, a.skv,
        sq_pad, rows_pad, scale2, a.sm_scale, a.causal, static_cast<int>(plan[6]),
        static_cast<int>(plan[7]), static_cast<int>(plan[8]));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkv<<<static_cast<unsigned>(std::min<long long>(dkv_items, sms)), BW_THREADS, KV::smem, stream>>>(
        maps[0], a.delta, nullptr, nullptr, nullptr, nullptr, a.os, a.dos, static_cast<B*>(a.dk),
        static_cast<B*>(a.dv), a.workspace, a.dks, a.dvs, group, splits, a.hq, a.sq, a.skv, sq_pad,
        rows_pad, scale2, a.sm_scale, a.causal, static_cast<int>(plan[9]),
        static_cast<int>(plan[10]), static_cast<int>(plan[11]));
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const long long pairs = static_cast<long long>(a.b) * a.hkv * a.skv * HD / 2;
    flash_bwd_sum_kernel<B><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
        a.workspace, static_cast<B*>(a.dk), static_cast<B*>(a.dv), a.dks, a.dvs, splits, a.hkv,
        a.skv, HD, pairs, a.sm_scale);
    return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const BwdArgs& a, const long long* plan, int vec, cudaStream_t stream) {
    switch (a.hd) {
        case 16: return launch_bwd<T, 16>(a, plan, vec, stream);
        case 32: return launch_bwd<T, 32>(a, plan, vec, stream);
        case 64: return launch_bwd<T, 64>(a, plan, vec, stream);
        case 80: return launch_bwd<T, 80>(a, plan, vec, stream);
        case 96: return launch_bwd<T, 96>(a, plan, vec, stream);
        case 128: return launch_bwd<T, 128>(a, plan, vec, stream);
        default: return cudaErrorInvalidValue;
    }
}

int dispatch_bwd_wgmma(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    switch (a.hd) {
        case 16: return launch_bwd_wgmma<16>(a, plan, stream);
        case 32: return launch_bwd_wgmma<32>(a, plan, stream);
        case 64: return launch_bwd_wgmma<64>(a, plan, stream);
        case 80: return launch_bwd_wgmma<80>(a, plan, stream);
        case 96: return launch_bwd_wgmma<96>(a, plan, stream);
        case 128: return launch_bwd_wgmma<128>(a, plan, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace


// dtype codes: 0 = float32, 1 = bfloat16.  `strides` holds (batch, head, seq)
// element strides of q, k, v, o in that order (12 values); the head_dim stride
// is 1.  `lse`: null, or a contiguous (b, hq, sq) fp32 buffer that receives each
// row's natural-log sum of exp(sm_scale q k^T) over its visible keys (the
// backward's input; the serving calls pass null and nothing is written).
// `o_res`: with `lse` and bf16, a buffer with o's strides that receives what
// rounding o to bf16 dropped (the backward's D reads o + o_res); else null.
// `plan`: see PLAN_OPERANDS above (on the CUDA cores [9] is vector_loads:
// fp32 rows in 16-byte pieces).  Returns 0 when launched, else a
// cudaError_t, or ENCODE_FAILED + the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, void* o_res, int dtype, int b, int hq, int hkv,
                                   int sq, int skv, int hd, const long long* strides,
                                   float sm_scale, int causal, const long long* plan,
                                   void* stream) {
    if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || hq % hkv != 0 ||
        hq > 65535 || b > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    // the residual comes with lse for bf16 and never for fp32
    if ((o_res != nullptr) != (dtype == 1 && lse != nullptr) ||
        (o_res != nullptr &&
         reinterpret_cast<uintptr_t>(o_res) % 16 != reinterpret_cast<uintptr_t>(o) % 16))
        return static_cast<int>(cudaErrorInvalidValue);
    const Strides qs{strides[0], strides[1], strides[2]};
    const Strides ks{strides[3], strides[4], strides[5]};
    const Strides vs{strides[6], strides[7], strides[8]};
    const Strides os{strides[9], strides[10], strides[11]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* ptrs[4] = {q, k, v, o};
    if (plan[0] == 1) {
        if (dtype != 1 || !rows_16_byte_aligned(ptrs, strides)) return cudaErrorInvalidValue;
        switch (hd) {
            case 16: return launch_wgmma<16>(q, k, v, o, o_res, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 32: return launch_wgmma<32>(q, k, v, o, o_res, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 64: return launch_wgmma<64>(q, k, v, o, o_res, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 80: return launch_wgmma<80>(q, k, v, o, o_res, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 96: return launch_wgmma<96>(q, k, v, o, o_res, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 128: return launch_wgmma<128>(q, k, v, o, o_res, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            default: return cudaErrorInvalidValue;
        }
    }
    if (plan[0] != 0) return cudaErrorInvalidValue;
    const int vec = plan[9] != 0;
    if (vec && !core_vector_loads(dtype, ptrs, 4, strides)) return cudaErrorInvalidValue;
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, s);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, o_res, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, vec, s);
    return cudaErrorInvalidValue;
}


// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// share it).  `strides` holds (batch, head, seq) element strides of q, k, v,
// o, dout, dq, dk, dv in that order (24 values); the head_dim stride is 1.
// `o_res`: null, or the bf16 forward's residual of o (o's strides), added to o
// for D.  `lse`: the forward's (b, hq, sq) fp32 log-sum-exp.  `delta`: an fp32
// workspace of 2 x (b, hq, sq_pad): lse (on the wgmma route lse * log2(e)),
// then D.  `workspace`: null, or the fp32
// partial dK/dV of a split GQA group (the plan's bytes).  `plan`: see
// BWD_PLAN_LEN above (route 1, wgmma, takes bf16 whose rows are 16-byte
// aligned).  Returns 0 when every kernel was launched, else a cudaError_t, or
// ENCODE_FAILED + the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* o_res, const void* dout, const float* lse,
                                   float* delta,
                                   float* workspace, void* dq, void* dk, void* dv, int dtype, int b,
                                   int hq, int hkv, int sq, int skv, int hd,
                                   const long long* strides, float sm_scale, int causal,
                                   const long long* plan, void* stream) {
    if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || hq % hkv != 0 || hq > 65535 ||
        b > 65535 || (causal && sq > skv) ||
        (o_res != nullptr &&
         (dtype != 1 || reinterpret_cast<uintptr_t>(o_res) % 16 != reinterpret_cast<uintptr_t>(o) % 16)))
        return static_cast<int>(cudaErrorInvalidValue);
    auto st = [&](int i) { return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]}; };
    const BwdArgs a{q, k, v, o, o_res, dout, lse, delta, workspace, dq, dk, dv,
                    st(0), st(1), st(2), st(3), st(4), st(5), st(6), st(7),
                    b, hq, hkv, sq, skv, hd, sm_scale, causal};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (plan[0] == 1) {   // the wgmma route: bf16 rows in 16-byte pieces, bf16 pairs stored
        const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
        for (int i = 0; i < 8; ++i)
            if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return cudaErrorInvalidValue;
        for (int i = 0; i < 24; ++i)
            if (strides[i] % 8 != 0) return cudaErrorInvalidValue;
        if (dtype != 1) return cudaErrorInvalidValue;
        return dispatch_bwd_wgmma(a, plan, s);
    }
    if (plan[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int vec = plan[BWD_MAPS] != 0;
    const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
    if (vec && !core_vector_loads(dtype, ptrs, 8, strides)) return cudaErrorInvalidValue;
    if (dtype == 0) return dispatch_bwd<float>(a, plan, vec, s);
    if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, plan, vec, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
