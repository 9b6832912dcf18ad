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
//        hd 128 = 64 + 64; Q K^T runs one k-step per 16 columns of a slab and
//        P V one product per slab, so no column of hd 80 is padded.
//      - Only the tiles that cross the causal diagonal, and the ragged last
//        tile, are masked.
//    `cuTensorMapEncodeTiled` is a driver function; it is reached at run time
//    through `cudaGetDriverEntryPoint(ByVersion)`, so nothing links libcuda.
//  * flash_fwd_kernel -- everything else (fp32 inputs, unaligned bf16).  The
//    products run in fp32 on the CUDA cores from fp32 shared-memory tiles,
//    with a 4-row micro-tile per thread and 16-byte shared-memory reads along
//    the contraction, padded against bank conflicts; p stays fp32 like the
//    TPU kernel.  It cannot pass the card's 67 TFLOP/s fp32 rate.  Its fp32
//    rows of hd + 4 floats (84 at hd 80) keep float4 reads aligned and put 8
//    rows in 8 distinct bank groups.
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

namespace {

constexpr int BM = 64;         // query rows per block
constexpr int TX = 16;         // threads along the key / output-column axis
constexpr int TY = 16;         // threads along the query-row axis
constexpr int NT = TX * TY;    // 256 threads
constexpr int RI = BM / TY;    // 4 query rows per thread: ty + TY * i
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

template <int HD, int BN>
struct Smem {
    static constexpr int QS = HD + 4;   // row strides in floats, padded so that
    static constexpr int KS = HD + 4;   // 16-byte reads of 8 rows hit 8 bank groups
    static constexpr int VS = HD;
    static constexpr int PS = BN + 4;
    static constexpr int floats = BM * QS + BN * KS + BN * VS + BM * PS;
    static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int HD, int BN>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int group, int sq, int skv, int n_q_tiles, float sm_scale,
                 int causal) {
    using L = Smem<HD, BN>;
    constexpr int NJ = BN / TX;   // score columns per thread: tx + TX * j
    constexpr int NC = HD / TX;   // output columns per thread: tx + TX * c

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Ks = Qs + BM * L::QS;
    float* Vs = Ks + BN * L::KS;
    float* Ps = Vs + BN * L::VS;

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / group;
    const int q0 = q_tile * BM;
    const int off = skv - sq;   // causal offset: query i sees keys <= i + off

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + hk * ks.h;
    const T* vb = v + b * vs.b + hk * vs.h;
    T* ob = o + b * os.b + h * os.h;

    for (int idx = tid; idx < BM * HD; idx += NT) {
        const int r = idx / HD, d = idx % HD;
        const int row = q0 + r;
        Qs[r * L::QS + d] = row < sq ? to_f32(qb[row * qs.s + d]) : 0.f;
    }

    float m[RI], l[RI], acc[RI][NC];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    int kv_end = skv;
    if (causal) {
        const int last_q = min(q0 + BM, sq) - 1;
        kv_end = min(skv, last_q + off + 1);
    }
    const int n_tiles = (kv_end + BN - 1) / BN;

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * BN;
        __syncthreads();   // the previous tile's products are done with Ks, Vs, Ps
        for (int idx = tid; idx < BN * HD; idx += NT) {
            const int r = idx / HD, d = idx % HD;
            const int row = k0 + r;
            const bool in = row < skv;
            Ks[r * L::KS + d] = in ? to_f32(kb[row * ks.s + d]) : 0.f;
            Vs[r * L::VS + d] = in ? to_f32(vb[row * vs.s + d]) : 0.f;
        }
        __syncthreads();

        // scores of this thread's RI x NJ micro-tile
        float s[RI][NJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
            float4 qv[RI], kv[NJ];
#pragma unroll
            for (int i = 0; i < RI; ++i)
                qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + TY * i) * L::QS + d]);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + TX * j) * L::KS + d]);
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }

        // online softmax; the 16 threads sharing a row are 16 neighbouring lanes
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int q_pos = q0 + ty + TY * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int k_pos = k0 + tx + TX * j;
                const bool valid = k_pos < skv && (!causal || q_pos + off >= k_pos);
                s[i][j] = valid ? s[i][j] * sm_scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            for (int w = TX / 2; w > 0; w >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float row_sum = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float p = expf(s[i][j] - m_new);
                Ps[(ty + TY * i) * L::PS + tx + TX * j] = p;
                row_sum += p;
            }
            for (int w = TX / 2; w > 0; w >>= 1)
                row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
            l[i] = l[i] * corr + row_sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

        // acc += P V
#pragma unroll 2
        for (int kk = 0; kk < BN; kk += 4) {
            float4 pv[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i)
                pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + TY * i) * L::PS + kk]);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float v0 = Vs[(kk + 0) * L::VS + tx + TX * c];
                const float v1 = Vs[(kk + 1) * L::VS + tx + TX * c];
                const float v2 = Vs[(kk + 2) * L::VS + tx + TX * c];
                const float v3 = Vs[(kk + 3) * L::VS + tx + TX * c];
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
                    acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
                    acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
                    acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + TY * i;
        if (row < sq) {
            const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
            for (int c = 0; c < NC; ++c)
                ob[row * os.s + tx + TX * c] = from_f32<T>(acc[i][c] / denom);
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
    // the tiles one after the other.
    static constexpr bool overlap = HD <= 80;
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
                       float* __restrict__ lse, Strides os, int group, int sq, int skv,
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
#pragma unroll
                for (int c = 0; c < W0 / 8; ++c)
                    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
                        __floats2bfloat162_rn(o_lo[4 * c + 2 * r] * inv, o_lo[4 * c + 2 * r + 1] * inv);
                if constexpr (W1 > 0) {
#pragma unroll
                    for (int c = 0; c < W1 / 8; ++c)
                        *reinterpret_cast<__nv_bfloat162*>(orow + W0 + 8 * c) = __floats2bfloat162_rn(
                            o_hi[4 * c + 2 * r] * inv, o_hi[4 * c + 2 * r + 1] * inv);
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
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, Strides os,
                 const long long* plan, int b, int hq, int hkv, int sq, int skv, float sm_scale,
                 int causal, cudaStream_t stream) {
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
        maps, static_cast<__nv_bfloat16*>(o), lse, os, hq / hkv, sq, skv, n_q_tiles,
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides qs,
           Strides ks, Strides vs, Strides os, const long long* plan, int b, int hq, int hkv,
           int sq, int skv, float sm_scale, int causal, cudaStream_t stream) {
    constexpr int BN = HD >= 128 ? 32 : 64;
    auto kernel = flash_fwd_kernel<T, HD, BN>;
    constexpr size_t smem = Smem<HD, BN>::bytes;
    const int n_q_tiles = (sq + BM - 1) / BM;
    if (plan[1] != BM || plan[2] != BN || plan[3] != 1 || plan[4] != NT || plan[5] != n_q_tiles ||
        plan[6] != hq || plan[7] != b || plan[8] != static_cast<long long>(smem))
        return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const dim3 grid(n_q_tiles, hq, b);
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, qs, ks, vs, os, hq / hkv, sq, skv, n_q_tiles, sm_scale, causal);
    return cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                Strides qs, Strides ks, Strides vs, Strides os, const long long* plan, int b,
                int hq, int hkv, int sq, int skv, float sm_scale, int causal,
                cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 32: return launch<T, 32>(q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 64: return launch<T, 64>(q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 80: return launch<T, 80>(q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 128: return launch<T, 128>(q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        default: return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// Backward (training): the gradient of out with respect to q, k and v
// ---------------------------------------------------------------------------
//
// The TPU kernel has no backward (the reference differentiates its plain jnp
// attention), so this is the port's own: FlashAttention-2's recomputation
// scheme, three kernels a call, no atomics, so every result is deterministic.
//
//  * flash_bwd_dot_kernel -- D = rowsum(dO * O) in fp32, one warp per row.
//  * flash_bwd_dkv_kernel -- one block per (kv tile of 64 keys, kv head,
//    batch).  It holds its K and V tiles and dK, dV in fp32 registers and
//    walks the query heads of its group and, in each, the query tiles that see
//    its keys (causally dead tiles are never loaded; the offset skv - sq is the
//    forward's), so a kv head's sum over its group needs no second pass.  Per
//    query tile: S^T = K Q^T and dP^T = V dO^T, P^T = exp(s S^T - lse) masked,
//    dV += P^T dO, dS^T = P^T (dP^T - D), dK += dS^T Q.
//  * flash_bwd_dq_kernel -- one block per (q tile of 64 queries, q head,
//    batch), over the kv tiles up to its causal limit: S = Q K^T, dP = dO V^T,
//    P = exp(s S - lse) masked, dS = P (dP - D), dQ += dS K.
//
// P is recomputed from q, k and the forward's lse (natural log), never stored.
// What bounds it on this card: operations (five products of 2 hd flops per
// visible (query, key) pair).  Two routes, chosen in Python (`flash_bwd_plan`)
// as the forward's are: bf16 whose rows are 16-byte aligned runs its products
// on the tensor cores (the *_mma_kernel pair below); fp32 and unaligned bf16
// run them in fp32 on the CUDA cores (the two kernels that follow), from fp32
// shared-memory tiles (bf16 widened as it is loaded) with the forward
// CUDA-core kernel's 4-row micro-tiles and 16-byte shared-memory reads, so
// they cannot pass the card's 67 TFLOP/s fp32 rate.  Inputs are read through
// their (b, h, s) strides, as in the forward: dout may be the transposed view
// autograd hands back for the model's (b, s, h, hd) layout.

constexpr int BWD_ROWS = 64;                // rows a block owns: queries (dQ) or keys (dK/dV)
constexpr int BWD_THREADS = TX * TY;        // 256
constexpr int BWD_RI = BWD_ROWS / TY;       // 4 rows a thread: ty + TY * i
constexpr int DOT_ROWS = 8;                 // rows of the D pass per block, one warp each

// Shared memory of both kernels: two (64, hd) tiles of the side a block owns,
// two (C, hd) tiles of the side it walks, the (64, C) P / dS tile, and lse and
// D of the C walked rows.  C = 64 keys or queries, 32 at hd 128.
template <int HD>
struct BwdSmem {
    static constexpr int C = HD >= 128 ? 32 : 64;
    static constexpr int RS = HD + 4;   // padded row strides in floats (as Smem above)
    static constexpr int PS = C + 4;
    static constexpr int floats = 2 * BWD_ROWS * RS + 2 * C * RS + BWD_ROWS * PS + 2 * C;
    static constexpr size_t bytes = sizeof(float) * floats;
};

// Rows r0 .. r0 + n of a head's (s, hd) slice into shared memory as fp32,
// zeros past `limit`.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long s_stride,
                                          int r0, int n, int limit) {
    constexpr int RS = HD + 4;
    for (int idx = threadIdx.x; idx < n * HD; idx += BWD_THREADS) {
        const int r = idx / HD, d = idx % HD;
        const int row = r0 + r;
        dst[r * RS + d] = row < limit ? to_f32(src[row * s_stride + d]) : 0.f;
    }
}

// acc[i][j] = A[ty + TY i] . B[tx + TX j] over hd (rows of two tiles).
template <int HD, int NJ>
__device__ __forceinline__ void row_dots(float (&acc)[BWD_RI][NJ], const float* A, const float* B) {
    constexpr int RS = HD + 4;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
    for (int i = 0; i < BWD_RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
        float4 a[BWD_RI], bv[NJ];
#pragma unroll
        for (int i = 0; i < BWD_RI; ++i)
            a[i] = *reinterpret_cast<const float4*>(&A[(ty + TY * i) * RS + d]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            bv[j] = *reinterpret_cast<const float4*>(&B[(tx + TX * j) * RS + d]);
#pragma unroll
        for (int i = 0; i < BWD_RI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
                acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
                acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
                acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
            }
    }
}

// out[i][c] += sum_j P[ty + TY i][j] M[j][tx + TX c]: the (64, C) tile P
// times the (C, hd) tile M.
template <int HD, int C>
__device__ __forceinline__ void tile_product(float (&out)[BWD_RI][HD / TX], const float* P,
                                             const float* M) {
    constexpr int RS = HD + 4, PS = C + 4, NC = HD / TX;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll 2
    for (int kk = 0; kk < C; kk += 4) {
        float4 pv[BWD_RI];
#pragma unroll
        for (int i = 0; i < BWD_RI; ++i)
            pv[i] = *reinterpret_cast<const float4*>(&P[(ty + TY * i) * PS + kk]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const float m0 = M[(kk + 0) * RS + tx + TX * c];
            const float m1 = M[(kk + 1) * RS + tx + TX * c];
            const float m2 = M[(kk + 2) * RS + tx + TX * c];
            const float m3 = M[(kk + 3) * RS + tx + TX * c];
#pragma unroll
            for (int i = 0; i < BWD_RI; ++i) {
                out[i][c] = fmaf(pv[i].x, m0, out[i][c]);
                out[i][c] = fmaf(pv[i].y, m1, out[i][c]);
                out[i][c] = fmaf(pv[i].z, m2, out[i][c]);
                out[i][c] = fmaf(pv[i].w, m3, out[i][c]);
            }
        }
    }
}

// D = rowsum(dO * O) over the logical (b, hq, sq) rows, into a contiguous buffer.
template <typename T>
__global__ void __launch_bounds__(32 * DOT_ROWS)
flash_bwd_dot_kernel(const T* __restrict__ dout, const T* __restrict__ o, float* __restrict__ delta,
                     Strides dos, Strides os, int hq, int sq, int hd, long long rows) {
    const long long row = static_cast<long long>(blockIdx.x) * DOT_ROWS + threadIdx.x / 32;
    if (row >= rows) return;
    const int lane = threadIdx.x % 32;
    const int i = static_cast<int>(row % sq);
    const int h = static_cast<int>((row / sq) % hq);
    const long long b = row / (static_cast<long long>(sq) * hq);
    const T* dr = dout + b * dos.b + h * dos.h + i * dos.s;
    const T* orow = o + b * os.b + h * os.h + i * os.s;
    float sum = 0.f;
    for (int d = lane; d < hd; d += 32) sum = fmaf(to_f32(dr[d]), to_f32(orow[d]), sum);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) delta[row] = sum;
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                     int group, int hq, int sq, int skv, float sm_scale, int causal) {
    using L = BwdSmem<HD>;
    constexpr int C = L::C, NJ = C / TX, NC = HD / TX, RS = L::RS, PS = L::PS;
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;
    float* Vs = Ks + BWD_ROWS * RS;
    float* Qs = Vs + BWD_ROWS * RS;
    float* dOs = Qs + C * RS;
    float* Ps = dOs + C * RS;
    float* lse_s = Ps + BWD_ROWS * PS;
    float* d_s = lse_s + C;

    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int hk = blockIdx.y, b = blockIdx.z;
    const int k0 = blockIdx.x * BWD_ROWS;
    const int off = skv - sq;   // causal offset: query i sees keys <= i + off
    load_rows<T, HD>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BWD_ROWS, skv);
    load_rows<T, HD>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BWD_ROWS, skv);

    float acc_k[BWD_RI][NC], acc_v[BWD_RI][NC];
#pragma unroll
    for (int i = 0; i < BWD_RI; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    // the first query that sees key k0, and so the first query tile to load
    const int first_tile = causal ? max(0, k0 - off) / C : 0;
    const int n_q_tiles = (sq + C - 1) / C;
    for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        const T* qb = q + b * qs.b + h * qs.h;
        const T* dob = dout + b * dos.b + h * dos.h;
        const long long rows0 = (static_cast<long long>(b) * hq + h) * sq;
        for (int u = first_tile; u < n_q_tiles; ++u) {
            const int c0 = u * C;
            __syncthreads();   // the previous tile's products are done with Qs, dOs, Ps
            load_rows<T, HD>(Qs, qb, qs.s, c0, C, sq);
            load_rows<T, HD>(dOs, dob, dos.s, c0, C, sq);
            for (int j = tid; j < C; j += BWD_THREADS) {
                const bool in = c0 + j < sq;
                lse_s[j] = in ? lse[rows0 + c0 + j] : 0.f;
                d_s[j] = in ? delta[rows0 + c0 + j] : 0.f;
            }
            __syncthreads();

            float s[BWD_RI][NJ], dp[BWD_RI][NJ];
            row_dots<HD, NJ>(s, Ks, Qs);    // S^T: keys x queries
            row_dots<HD, NJ>(dp, Vs, dOs);  // dP^T
#pragma unroll
            for (int i = 0; i < BWD_RI; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int k_pos = k0 + ty + TY * i, q_pos = c0 + tx + TX * j;
                    const bool valid = k_pos < skv && q_pos < sq && (!causal || q_pos + off >= k_pos);
                    s[i][j] = valid ? expf(fmaf(s[i][j], sm_scale, -lse_s[tx + TX * j])) : 0.f;
                    Ps[(ty + TY * i) * PS + tx + TX * j] = s[i][j];
                }
            __syncthreads();
            tile_product<HD, C>(acc_v, Ps, dOs);   // dV += P^T dO
            __syncthreads();
#pragma unroll
            for (int i = 0; i < BWD_RI; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    Ps[(ty + TY * i) * PS + tx + TX * j] = s[i][j] * (dp[i][j] - d_s[tx + TX * j]);
            __syncthreads();
            tile_product<HD, C>(acc_k, Ps, Qs);    // dK += dS^T Q
        }
    }

    T* dkb = dk + b * dks.b + hk * dks.h;
    T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
    for (int i = 0; i < BWD_RI; ++i) {
        const int row = k0 + ty + TY * i;
        if (row < skv) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                dkb[row * dks.s + tx + TX * c] = from_f32<T>(acc_k[i][c] * sm_scale);
                dvb[row * dvs.s + tx + TX * c] = from_f32<T>(acc_v[i][c]);
            }
        }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int group, int sq, int skv,
                    int n_q_tiles, float sm_scale, int causal) {
    using L = BwdSmem<HD>;
    constexpr int C = L::C, NJ = C / TX, NC = HD / TX, RS = L::RS, PS = L::PS;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* dOs = Qs + BWD_ROWS * RS;
    float* Ks = dOs + BWD_ROWS * RS;
    float* Vs = Ks + C * RS;
    float* dSs = Vs + C * RS;

    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);   // heaviest first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / group;
    const int q0 = q_tile * BWD_ROWS;
    const int off = skv - sq;
    load_rows<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BWD_ROWS, sq);
    load_rows<T, HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BWD_ROWS, sq);
    const T* kb = k + b * ks.b + hk * ks.h;
    const T* vb = v + b * vs.b + hk * vs.h;

    const long long rows0 = (static_cast<long long>(b) * gridDim.y + h) * sq;
    float lse_r[BWD_RI], d_r[BWD_RI], acc[BWD_RI][NC];
#pragma unroll
    for (int i = 0; i < BWD_RI; ++i) {
        const int row = q0 + ty + TY * i;
        lse_r[i] = row < sq ? lse[rows0 + row] : 0.f;
        d_r[i] = row < sq ? delta[rows0 + row] : 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    const int kv_end = causal ? min(skv, min(q0 + BWD_ROWS, sq) + off) : skv;
    const int n_tiles = (kv_end + C - 1) / C;
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * C;
        __syncthreads();   // the previous tile's product is done with Ks, dSs
        load_rows<T, HD>(Ks, kb, ks.s, k0, C, skv);
        load_rows<T, HD>(Vs, vb, vs.s, k0, C, skv);
        __syncthreads();

        float s[BWD_RI][NJ], dp[BWD_RI][NJ];
        row_dots<HD, NJ>(s, Qs, Ks);
        row_dots<HD, NJ>(dp, dOs, Vs);
#pragma unroll
        for (int i = 0; i < BWD_RI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int q_pos = q0 + ty + TY * i, k_pos = k0 + tx + TX * j;
                const bool valid = q_pos < sq && k_pos < skv && (!causal || q_pos + off >= k_pos);
                const float p = valid ? expf(fmaf(s[i][j], sm_scale, -lse_r[i])) : 0.f;
                dSs[(ty + TY * i) * PS + tx + TX * j] = p * (dp[i][j] - d_r[i]);
            }
        __syncthreads();
        tile_product<HD, C>(acc, dSs, Ks);   // dQ += dS K
    }

    T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int i = 0; i < BWD_RI; ++i) {
        const int row = q0 + ty + TY * i;
        if (row < sq) {
#pragma unroll
            for (int c = 0; c < NC; ++c)
                dqb[row * dqs.s + tx + TX * c] = from_f32<T>(acc[i][c] * sm_scale);
        }
    }
}

// ---------------------------------------------------------------------------
// Backward, bf16 on the tensor cores: mma.sync.m16n8k16, fp32 accumulators
// ---------------------------------------------------------------------------
//
// Aligned bf16 (the training path) takes these two kernels in place of the
// CUDA-core ones, with the same blocks, loops and masks: four warps own 16 of
// the block's 64 rows each; Q, K, V, dO tiles sit in shared memory as bf16 in
// rows of hd + 8 elements (16-byte rows whose 8 ldmatrix rows fall in 8 bank
// groups); S and dP (fp32) come from ldmatrix fragments, and P and dS are
// rounded to bf16 and become the A fragments of the next products without
// leaving registers (the accumulator of two neighbouring 8-column tiles is one
// 16-wide A fragment), as FlashAttention-2 does.  Tiles are loaded with
// 16-byte loads and no pipelining: a simple first version.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;   // 64 rows: 16 a warp

template <int HD>
struct MmaSmem {
    static constexpr int C = HD >= 128 ? 32 : 64;   // walked rows per tile (registers at hd 128)
    static constexpr int RS = HD + 8;               // bf16 row stride
    static constexpr int elems = 2 * BWD_ROWS * RS + 2 * C * RS;
    static constexpr size_t bytes = 2 * elems + 2 * C * sizeof(float);   // + lse and D of the walked rows
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// D (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16); with g = lane / 4 and
// i = lane % 4: A a0 (g, 2i..2i+1), a1 (g + 8, 2i..), a2 (g, 8 + 2i..),
// a3 (g + 8, 8 + 2i..); B b0 (k 2i..2i+1, n g), b1 (k 8 + 2i.., n g);
// D d0, d1 (g, 2i..2i+1), d2, d3 (g + 8, 2i..2i+1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0 .. r0 + n of a head's (s, hd) bf16 slice into shared memory (row
// stride hd + 8), 16 bytes a load, zeros past `limit`.
template <int HD>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                               long long s_stride, int r0, int n, int limit) {
    constexpr int RS = HD + 8, V = HD / 8;
    for (int idx = threadIdx.x; idx < n * V; idx += MMA_THREADS) {
        const int r = idx / V, c = (idx % V) * 8;
        const int row = r0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < limit) val = *reinterpret_cast<const uint4*>(src + row * s_stride + c);
        *reinterpret_cast<uint4*>(dst + r * RS + c) = val;
    }
}

// acc[j] = A[16 rows from a] . B[rows 8 j .. 8 j + 7 from b] over hd, for the
// NT 16 x 8 tiles of A B^T; A and B (rows, hd) bf16 in shared memory.
template <int HD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], uint32_t a, uint32_t b) {
    constexpr int RS = HD + 8;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
        uint32_t af[4];
        ldsm_x4(af, a + 2 * ((lane % 16) * RS + kk + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
            uint32_t bf[4];   // b0, b1 of tile j, then of tile j + 1
            ldsm_x4(bf, b + 2 * ((8 * j + (lane & 7) + (lane >> 4) * 8) * RS + kk +
                                 ((lane >> 3) & 1) * 8));
            mma16816(acc[j], af, bf[0], bf[1]);
            mma16816(acc[j + 1], af, bf[2], bf[3]);
        }
    }
}

// out (16 x hd) += P (16 x C, bf16 A fragments) M (C x hd, row-major bf16 in
// shared memory at m).
template <int HD, int C>
__device__ __forceinline__ void mma_pm(float (&out)[HD / 8][4], const uint32_t (&pa)[C / 16][4],
                                       uint32_t m) {
    constexpr int RS = HD + 8;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int n = 0; n < HD / 8; n += 2) {
            uint32_t bf[4];   // b0, b1 of column tile n, then of n + 1 (transposed loads)
            ldsm_x4_t(bf, m + 2 * ((16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + 8 * n +
                                   (lane >> 4) * 8));
            mma16816(out[n], pa[kk], bf[0], bf[1]);
            mma16816(out[n + 1], pa[kk], bf[2], bf[3]);
        }
}

// The accumulators of tiles 2 kk and 2 kk + 1 as the bf16 A fragment kk.
template <int NT>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[NT / 2][4], const float (&acc)[NT][4]) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
        pa[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
        pa[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
        pa[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
    }
}

// A warp's 16 x hd accumulator rows (row0, row0 + 8) times `mul` to bf16 rows
// of `dst` (head slice, row stride s) below `limit`.
template <int HD>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, long long s, int row0, int limit,
                                                const float (&acc)[HD / 8][4], float mul) {
    const int col = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < limit) {
#pragma unroll
            for (int n = 0; n < HD / 8; ++n)
                *reinterpret_cast<__nv_bfloat162*>(dst + row * s + 8 * n + col) =
                    __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides qs,
                         Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int group,
                         int hq, int sq, int skv, float sm_scale, int causal) {
    using L = MmaSmem<HD>;
    constexpr int C = L::C, NT = C / 8, RS = L::RS;
    extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
    __nv_bfloat16* Ks = smem_bf;
    __nv_bfloat16* Vs = Ks + BWD_ROWS * RS;
    __nv_bfloat16* Qs = Vs + BWD_ROWS * RS;
    __nv_bfloat16* dOs = Qs + C * RS;
    float* lse_s = reinterpret_cast<float*>(dOs + C * RS);
    float* d_s = lse_s + C;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int hk = blockIdx.y, b = blockIdx.z;
    const int k0 = blockIdx.x * BWD_ROWS;
    const int off = skv - sq;
    load_rows_bf16<HD>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BWD_ROWS, skv);
    load_rows_bf16<HD>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BWD_ROWS, skv);
    const int row0 = k0 + 16 * warp + lane / 4;   // this thread's keys: row0, row0 + 8
    const uint32_t k_frag = smem_u32(Ks + 16 * warp * RS);
    const uint32_t v_frag = smem_u32(Vs + 16 * warp * RS);

    float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    const int first_tile = causal ? max(0, k0 - off) / C : 0;
    const int n_q_tiles = (sq + C - 1) / C;
    for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
        const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
        const long long rows0 = (static_cast<long long>(b) * hq + h) * sq;
        for (int u = first_tile; u < n_q_tiles; ++u) {
            const int c0 = u * C;
            __syncthreads();   // every warp is done with the previous tile
            load_rows_bf16<HD>(Qs, qb, qs.s, c0, C, sq);
            load_rows_bf16<HD>(dOs, dob, dos.s, c0, C, sq);
            for (int j = tid; j < C; j += MMA_THREADS) {
                const bool in = c0 + j < sq;
                lse_s[j] = in ? lse[rows0 + c0 + j] : 0.f;
                d_s[j] = in ? delta[rows0 + c0 + j] : 0.f;
            }
            __syncthreads();

            float s[NT][4], dp[NT][4];
            mma_abt<HD, NT>(s, k_frag, smem_u32(Qs));    // S^T: keys x queries
            mma_abt<HD, NT>(dp, v_frag, smem_u32(dOs));  // dP^T
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int k_pos = row0 + 8 * (e >> 1);
                    const int qc = 8 * j + 2 * (lane % 4) + (e & 1);
                    const int q_pos = c0 + qc;
                    const bool valid = k_pos < skv && q_pos < sq && (!causal || q_pos + off >= k_pos);
                    const float p = valid ? expf(fmaf(s[j][e], sm_scale, -lse_s[qc])) : 0.f;
                    s[j][e] = p;
                    dp[j][e] = p * (dp[j][e] - d_s[qc]);
                }
            uint32_t pa[NT / 2][4], da[NT / 2][4];
            to_a_frags<NT>(pa, s);
            to_a_frags<NT>(da, dp);
            mma_pm<HD, C>(acc_v, pa, smem_u32(dOs));   // dV += P^T dO
            mma_pm<HD, C>(acc_k, da, smem_u32(Qs));    // dK += dS^T Q
        }
    }
    store_rows_bf16<HD>(dk + b * dks.b + hk * dks.h, dks.s, row0, skv, acc_k, sm_scale);
    store_rows_bf16<HD>(dv + b * dvs.b + hk * dvs.h, dvs.s, row0, skv, acc_v, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                        Strides dos, Strides dqs, int group, int sq, int skv, int n_q_tiles,
                        float sm_scale, int causal) {
    using L = MmaSmem<HD>;
    constexpr int C = L::C, NT = C / 8, RS = L::RS;
    extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
    __nv_bfloat16* Qs = smem_bf;
    __nv_bfloat16* dOs = Qs + BWD_ROWS * RS;
    __nv_bfloat16* Ks = dOs + BWD_ROWS * RS;
    __nv_bfloat16* Vs = Ks + C * RS;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);   // heaviest first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / group;
    const int q0 = q_tile * BWD_ROWS;
    const int off = skv - sq;
    load_rows_bf16<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BWD_ROWS, sq);
    load_rows_bf16<HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BWD_ROWS, sq);
    const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
    const int row0 = q0 + 16 * warp + lane / 4;   // this thread's queries: row0, row0 + 8
    const long long rows0 = (static_cast<long long>(b) * gridDim.y + h) * sq;
    float lse_r[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        lse_r[r] = row < sq ? lse[rows0 + row] : 0.f;
        d_r[r] = row < sq ? delta[rows0 + row] : 0.f;
    }
    const uint32_t q_frag = smem_u32(Qs + 16 * warp * RS);
    const uint32_t do_frag = smem_u32(dOs + 16 * warp * RS);

    float acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    const int kv_end = causal ? min(skv, min(q0 + BWD_ROWS, sq) + off) : skv;
    const int n_tiles = (kv_end + C - 1) / C;
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * C;
        __syncthreads();   // every warp is done with the previous tile
        load_rows_bf16<HD>(Ks, kb, ks.s, k0, C, skv);
        load_rows_bf16<HD>(Vs, vb, vs.s, k0, C, skv);
        __syncthreads();

        float s[NT][4], dp[NT][4];
        mma_abt<HD, NT>(s, q_frag, smem_u32(Ks));
        mma_abt<HD, NT>(dp, do_frag, smem_u32(Vs));
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int q_pos = row0 + 8 * (e >> 1);
                const int k_pos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
                const bool valid = q_pos < sq && k_pos < skv && (!causal || q_pos + off >= k_pos);
                const float p = valid ? expf(fmaf(s[j][e], sm_scale, -lse_r[e >> 1])) : 0.f;
                s[j][e] = p * (dp[j][e] - d_r[e >> 1]);
            }
        uint32_t da[NT / 2][4];
        to_a_frags<NT>(da, s);
        mma_pm<HD, C>(acc, da, smem_u32(Ks));   // dQ += dS K
    }
    store_rows_bf16<HD>(dq + b * dqs.b + h * dqs.h, dqs.s, row0, sq, acc, sm_scale);
}

// The backward's launch plan (kernels/flash_attention.py, `FlashBwdPlan.as_array`),
// int64: [0] route (0 = CUDA cores, 1 = mma), [1] rows a block owns (64), [2] C,
// [3] threads, [4..6] the dQ grid, [7..9] the dK/dV grid, [10] dynamic shared
// memory bytes, [11] D-pass blocks.
constexpr int BWD_PLAN_LEN = 12;

struct BwdArgs {
    const void *q, *k, *v, *o, *dout;
    const float* lse;
    float* delta;
    void *dq, *dk, *dv;
    Strides qs, ks, vs, os, dos, dqs, dks, dvs;
    int b, hq, hkv, sq, skv, hd;
    float sm_scale;
    int causal;
};

// The plan must describe the kernels built for this route and HD.
bool bwd_plan_ok(const long long* plan, const BwdArgs& a, int route, int cols, int threads,
                 size_t smem) {
    const long long rows = static_cast<long long>(a.b) * a.hq * a.sq;
    return plan[0] == route && plan[1] == BWD_ROWS && plan[2] == cols && plan[3] == threads &&
           plan[4] == (a.sq + BWD_ROWS - 1) / BWD_ROWS && plan[5] == a.hq && plan[6] == a.b &&
           plan[7] == (a.skv + BWD_ROWS - 1) / BWD_ROWS && plan[8] == a.hkv && plan[9] == a.b &&
           plan[10] == static_cast<long long>(smem) && plan[11] == (rows + DOT_ROWS - 1) / DOT_ROWS &&
           plan[11] <= 2147483647LL;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_dot(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    flash_bwd_dot_kernel<T><<<static_cast<unsigned>(plan[11]), 32 * DOT_ROWS, 0, stream>>>(
        static_cast<const T*>(a.dout), static_cast<const T*>(a.o), a.delta, a.dos, a.os, a.hq,
        a.sq, a.hd, static_cast<long long>(a.b) * a.hq * a.sq);
    return cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    using L = BwdSmem<HD>;
    if (!bwd_plan_ok(plan, a, 0, L::C, BWD_THREADS, L::bytes)) return cudaErrorInvalidValue;
    auto dkv = flash_bwd_dkv_kernel<T, HD>;
    auto dq = flash_bwd_dq_kernel<T, HD>;
    cudaError_t err = allow_smem(dkv, L::bytes);
    if (err == cudaSuccess) err = allow_smem(dq, L::bytes);
    if (err == cudaSuccess) err = launch_dot<T>(a, plan, stream);
    if (err != cudaSuccess) return err;
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    dkv<<<dim3(plan[7], a.hkv, a.b), BWD_THREADS, L::bytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
        a.vs, a.dos, a.dks, a.dvs, a.hq / a.hkv, a.hq, a.sq, a.skv, a.sm_scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3(plan[4], a.hq, a.b), BWD_THREADS, L::bytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs,
        a.hq / a.hkv, a.sq, a.skv, static_cast<int>(plan[4]), a.sm_scale, a.causal);
    return cudaGetLastError();
}

template <int HD>
int launch_bwd_mma(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    using L = MmaSmem<HD>;
    using B = __nv_bfloat16;
    if (!bwd_plan_ok(plan, a, 1, L::C, MMA_THREADS, L::bytes)) return cudaErrorInvalidValue;
    auto dkv = flash_bwd_dkv_mma_kernel<HD>;
    auto dq = flash_bwd_dq_mma_kernel<HD>;
    cudaError_t err = allow_smem(dkv, L::bytes);
    if (err == cudaSuccess) err = allow_smem(dq, L::bytes);
    if (err == cudaSuccess) err = launch_dot<B>(a, plan, stream);
    if (err != cudaSuccess) return err;
    const B* q = static_cast<const B*>(a.q);
    const B* k = static_cast<const B*>(a.k);
    const B* v = static_cast<const B*>(a.v);
    const B* dout = static_cast<const B*>(a.dout);
    dkv<<<dim3(plan[7], a.hkv, a.b), MMA_THREADS, L::bytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<B*>(a.dk), static_cast<B*>(a.dv), a.qs, a.ks,
        a.vs, a.dos, a.dks, a.dvs, a.hq / a.hkv, a.hq, a.sq, a.skv, a.sm_scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3(plan[4], a.hq, a.b), MMA_THREADS, L::bytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<B*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs,
        a.hq / a.hkv, a.sq, a.skv, static_cast<int>(plan[4]), a.sm_scale, a.causal);
    return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    switch (a.hd) {
        case 16: return launch_bwd<T, 16>(a, plan, stream);
        case 32: return launch_bwd<T, 32>(a, plan, stream);
        case 64: return launch_bwd<T, 64>(a, plan, stream);
        case 80: return launch_bwd<T, 80>(a, plan, stream);
        case 128: return launch_bwd<T, 128>(a, plan, stream);
        default: return cudaErrorInvalidValue;
    }
}

int dispatch_bwd_mma(const BwdArgs& a, const long long* plan, cudaStream_t stream) {
    switch (a.hd) {
        case 16: return launch_bwd_mma<16>(a, plan, stream);
        case 32: return launch_bwd_mma<32>(a, plan, stream);
        case 64: return launch_bwd_mma<64>(a, plan, stream);
        case 80: return launch_bwd_mma<80>(a, plan, stream);
        case 128: return launch_bwd_mma<128>(a, plan, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `strides` holds (batch, head, seq)
// element strides of q, k, v, o in that order (12 values); the head_dim stride
// is 1.  `lse`: null, or a contiguous (b, hq, sq) fp32 buffer that receives each
// row's natural-log sum of exp(sm_scale q k^T) over its visible keys (the
// backward's input; the serving calls pass null and nothing is written).
// `plan`: see PLAN_OPERANDS above.  Returns 0 when launched, else a
// cudaError_t, or ENCODE_FAILED + the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int b, int hq, int hkv, int sq, int skv,
                                   int hd, const long long* strides, float sm_scale, int causal,
                                   const long long* plan, void* stream) {
    if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || hq % hkv != 0 ||
        hq > 65535 || b > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Strides qs{strides[0], strides[1], strides[2]};
    const Strides ks{strides[3], strides[4], strides[5]};
    const Strides vs{strides[6], strides[7], strides[8]};
    const Strides os{strides[9], strides[10], strides[11]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* ptrs[4] = {q, k, v, o};
    if (plan[0] == 1) {
        if (dtype != 1 || !rows_16_byte_aligned(ptrs, strides)) return cudaErrorInvalidValue;
        switch (hd) {
            case 16: return launch_wgmma<16>(q, k, v, o, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 32: return launch_wgmma<32>(q, k, v, o, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 64: return launch_wgmma<64>(q, k, v, o, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 80: return launch_wgmma<80>(q, k, v, o, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            case 128: return launch_wgmma<128>(q, k, v, o, lse, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
            default: return cudaErrorInvalidValue;
        }
    }
    if (plan[0] != 0) return cudaErrorInvalidValue;
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, qs, ks, vs, os, plan, b, hq, hkv, sq, skv, sm_scale, causal, s);
    return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// share it).  `strides` holds (batch, head, seq) element strides of q, k, v,
// o, dout, dq, dk, dv in that order (24 values); the head_dim stride is 1.
// `lse`: the forward's (b, hq, sq) fp32 log-sum-exp; `delta`: a (b, hq, sq)
// fp32 workspace for D.  `plan`: see BWD_PLAN_LEN above (route 1, the tensor
// cores, takes bf16 whose rows are 16-byte aligned).  Returns 0 when the three
// kernels were launched, else a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int dtype, int b, int hq, int hkv, int sq,
                                   int skv, int hd, const long long* strides, float sm_scale,
                                   int causal, const long long* plan, void* stream) {
    if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || hq % hkv != 0 || hq > 65535 ||
        b > 65535 || (causal && sq > skv))
        return static_cast<int>(cudaErrorInvalidValue);
    auto st = [&](int i) { return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]}; };
    const BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
                    st(0), st(1), st(2), st(3), st(4), st(5), st(6), st(7),
                    b, hq, hkv, sq, skv, hd, sm_scale, causal};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (plan[0] == 1) {   // the mma route: bf16 rows in 16-byte pieces, bf16 pairs stored
        const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
        for (int i = 0; i < 8; ++i)
            if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return cudaErrorInvalidValue;
        for (int i = 0; i < 24; ++i)
            if (strides[i] % 8 != 0) return cudaErrorInvalidValue;
        if (dtype != 1) return cudaErrorInvalidValue;
        return dispatch_bwd_mma(a, plan, s);
    }
    if (plan[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) return dispatch_bwd<float>(a, plan, s);
    if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, plan, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
