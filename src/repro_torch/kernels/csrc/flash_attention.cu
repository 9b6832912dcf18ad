// Flash attention forward (causal or full, grouped-query) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fa_kernel` / `flash_attention` of the reference's
// kernels/flash_attention.py: out = softmax(q k^T / sqrt(hd) + mask) v with an
// online softmax, fp32 running (m, l, acc), `acc / max(l, 1e-30)` at the end,
// q-head h reading kv-head h / (hq / hkv) so that K/V are never repeated in
// memory.  Mask: k_pos < skv and, if causal, q_pos + (skv - sq) >= k_pos.
//
// What differs from the TPU kernel's shape.  There the grid's fourth axis
// walks the kv blocks in order and carries (m, l, acc) in scratch memory.
// Here blocks run in no order, so one block owns a tile of BM = 64 query rows
// of one (batch, q-head) and loops over the kv tiles itself; the loop stops at
// the tile's causal limit, so fully masked kv tiles cost nothing.  Heavy
// (late) query tiles are scheduled first to shorten the tail.
//
// What bounds it on this card: operations.  At the prefill shapes the bytes of
// q, k, v and o are a few MB while the products need GFLOPs, so what matters
// is which arithmetic units do the two products.  There are two kernels and
// the launcher picks between them from what it can see of the inputs:
//
//  * flash_fwd_tc_kernel -- bf16 inputs whose rows are 16-byte aligned (the
//    serving path).  Both products run on the tensor cores through
//    `mma.sync.m16n8k16` (bf16 operands, fp32 accumulators): 4 warps, each
//    owning 16 query rows; q fragments stay in registers; K and V tiles are
//    staged in shared memory as bf16 with rows padded by 16 bytes, so the
//    fragment loads (32-bit loads for K, `ldmatrix.trans` for V) are free of
//    bank conflicts; the scores never leave registers: the accumulator
//    fragment of q k^T is, after the softmax, the A fragment of p v.  p is
//    rounded to bf16 for that product (the model's own attention casts the
//    probabilities to the compute type before p v as well); m, l and the
//    output accumulator stay fp32.  It is not pipelined (no cp.async/TMA, no
//    wgmma): loads and math of a block alternate, other blocks on the SM
//    cover for it.  That, and the softmax on the CUDA cores, is what keeps it
//    below the 989 TFLOP/s bound.
//  * flash_fwd_kernel -- everything else (fp32 inputs, unaligned bf16).  The
//    products run in fp32 on the CUDA cores from fp32 shared-memory tiles,
//    with a 4-row micro-tile per thread and 16-byte shared-memory reads along
//    the contraction, padded against bank conflicts; p stays fp32 like the
//    TPU kernel.  It cannot pass the card's 67 TFLOP/s fp32 rate.
//
// Layout: logical (b, h, s, hd) with the strides of b, h and s passed in
// (elements) and hd contiguous, so the model's (b, s, h, hd) tensors go in as
// transposed views without a copy.
//
// Plain C interface; the kernel launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                 T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
                 int group, int sq, int skv, int n_q_tiles, float sm_scale, int causal) {
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
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BM = 64;        // query rows per block: 16 per warp
constexpr int TC_BN = 64;        // keys per tile
constexpr int TC_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct TcSmem {
    static constexpr int LD = HD + 8;   // row stride in bf16: 16 bytes of padding
    static constexpr size_t bytes = sizeof(__nv_bfloat16) * (TC_BM + 2 * TC_BN) * LD;
};

// D += A * B for one m16n8k16 tile; A row-major (4 regs), B column-major (2 regs).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory; lane l supplies the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS x HD bf16 from global rows [row0, row0 + ROWS) into a padded
// shared-memory tile with 16-byte copies; rows >= limit are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int limit, int tid) {
    constexpr int CH = HD / 8;   // 16-byte chunks per row
    for (int idx = tid; idx < ROWS * CH; idx += TC_THREADS) {
        const int r = idx / CH, c = idx % CH;
        const int row = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < limit) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
        *reinterpret_cast<uint4*>(dst + r * TcSmem<HD>::LD + c * 8) = val;
    }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    Strides qs, Strides ks, Strides vs, Strides os, int group, int sq, int skv,
                    int n_q_tiles, float sm_scale, int causal) {
    constexpr int LD = TcSmem<HD>::LD;
    constexpr int KSTEPS = HD / 16;     // k-steps of q k^T
    constexpr int NT_S = TC_BN / 8;     // 8-key tiles of the scores
    constexpr int NT_O = HD / 8;        // 8-column tiles of the output

    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + TC_BM * LD;
    __nv_bfloat16* Vs = Ks + TC_BN * LD;

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;   // fragment coordinates: row group, column pair
    const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / group;
    const int q0 = q_tile * TC_BM;
    const int off = skv - sq;

    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
    __nv_bfloat16* ob = o + b * os.b + h * os.h;

    stage_tile<HD, TC_BM>(Qs, qb, qs.s, q0, sq, tid);
    __syncthreads();

    // this warp's 16 query rows as A fragments, kept in registers throughout
    const int qr = warp * 16 + g;   // the thread's rows in the tile: qr and qr + 8
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
        qf[s][0] = *reinterpret_cast<const uint32_t*>(&Qs[qr * LD + s * 16 + 2 * t]);
        qf[s][1] = *reinterpret_cast<const uint32_t*>(&Qs[(qr + 8) * LD + s * 16 + 2 * t]);
        qf[s][2] = *reinterpret_cast<const uint32_t*>(&Qs[qr * LD + s * 16 + 8 + 2 * t]);
        qf[s][3] = *reinterpret_cast<const uint32_t*>(&Qs[(qr + 8) * LD + s * 16 + 8 + 2 * t]);
    }

    float oacc[NT_O][4];
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // m in units of log2
    const float scale2 = sm_scale * LOG2E;

    int kv_end = skv;
    if (causal) {
        const int last_q = min(q0 + TC_BM, sq) - 1;
        kv_end = min(skv, last_q + off + 1);
    }
    const int n_tiles = (kv_end + TC_BN - 1) / TC_BN;

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = tile * TC_BN;
        __syncthreads();   // every warp is done with the previous K and V tiles
        stage_tile<HD, TC_BN>(Ks, kb, ks.s, k0, skv, tid);
        stage_tile<HD, TC_BN>(Vs, vb, vs.s, k0, skv, tid);
        __syncthreads();

        // scores: 16 rows x 64 keys per warp
        float s[NT_S][4];
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int ks_ = 0; ks_ < KSTEPS; ++ks_) {
                const __nv_bfloat16* kp = &Ks[(j * 8 + g) * LD + ks_ * 16 + 2 * t];
                mma_bf16(s[j], qf[ks_], *reinterpret_cast<const uint32_t*>(kp),
                         *reinterpret_cast<const uint32_t*>(kp + 8));
            }
        }

        // mask, scale (into log2 units) and online softmax; a row's 16 values
        // per thread sit in elements {0,1} (row qr) or {2,3} (row qr + 8), and
        // the row is shared by the 4 lanes of a quad
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int q_pos = q0 + qr + 8 * r;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < NT_S; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int k_pos = k0 + j * 8 + 2 * t + c;
                    const bool valid = k_pos < skv && (!causal || q_pos + off >= k_pos);
                    const float val = valid ? s[j][2 * r + c] * scale2 : NEG_INF;
                    s[j][2 * r + c] = val;
                    mx = fmaxf(mx, val);
                }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx);
            const float corr = exp2f(m[r] - m_new);
            float row_sum = 0.f;
#pragma unroll
            for (int j = 0; j < NT_S; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float p = exp2f(s[j][2 * r + c] - m_new);
                    s[j][2 * r + c] = p;
                    row_sum += p;
                }
            row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
            row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
            l[r] = l[r] * corr + row_sum;
            m[r] = m_new;
#pragma unroll
            for (int n = 0; n < NT_O; ++n) {
                oacc[n][2 * r] *= corr;
                oacc[n][2 * r + 1] *= corr;
            }
        }

        // acc += P V: two neighbouring score tiles are one A fragment
#pragma unroll
        for (int kk = 0; kk < TC_BN / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
            // lane -> row of V (a key) and which of the four 8x8 matrices:
            // keys +0/+8 (lane / 8 odd), output columns +0/+8 (lane >= 16)
            const __nv_bfloat16* vrow =
                &Vs[(kk * 16 + (lane % 8) + 8 * ((lane / 8) & 1)) * LD + 8 * (lane / 16)];
#pragma unroll
            for (int np = 0; np < NT_O / 2; ++np) {
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, vrow + np * 16);
                mma_bf16(oacc[2 * np], pa, vf[0], vf[1]);
                mma_bf16(oacc[2 * np + 1], pa, vf[2], vf[3]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + qr + 8 * r;
        if (row < sq) {
            const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
            for (int n = 0; n < NT_O; ++n) {
                const __nv_bfloat162 pair =
                    __floats2bfloat162_rn(oacc[n][2 * r] / denom, oacc[n][2 * r + 1] / denom);
                *reinterpret_cast<__nv_bfloat162*>(&ob[row * os.s + n * 8 + 2 * t]) = pair;
            }
        }
    }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, Strides qs,
                      Strides ks, Strides vs, Strides os, int b, int hq, int hkv, int sq,
                      int skv, float sm_scale, int causal, cudaStream_t stream) {
    auto kernel = flash_fwd_tc_kernel<HD>;
    constexpr size_t smem = TcSmem<HD>::bytes;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const int n_q_tiles = (sq + TC_BM - 1) / TC_BM;
    const dim3 grid(n_q_tiles, hq, b);
    kernel<<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), qs, ks, vs, os,
        hq / hkv, sq, skv, n_q_tiles, sm_scale, causal);
    return cudaGetLastError();
}

// The tensor-core kernel copies rows in 16-byte pieces and stores bf16 pairs.
bool rows_16_byte_aligned(const void* const* ptrs, const long long* strides) {
    for (int i = 0; i < 4; ++i)
        if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int i = 0; i < 12; ++i)
        if (strides[i] % 8 != 0) return false;
    return true;
}

// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int b, int hq, int hkv, int sq,
                   int skv, float sm_scale, int causal, cudaStream_t stream) {
    constexpr int BN = HD >= 128 ? 32 : 64;
    auto kernel = flash_fwd_kernel<T, HD, BN>;
    constexpr size_t smem = Smem<HD, BN>::bytes;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const int n_q_tiles = (sq + BM - 1) / BM;
    const dim3 grid(n_q_tiles, hq, b);
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), qs, ks, vs, os, hq / hkv, sq, skv, n_q_tiles, sm_scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        Strides qs, Strides ks, Strides vs, Strides os, int b, int hq,
                        int hkv, int sq, int skv, float sm_scale, int causal,
                        cudaStream_t stream) {
    switch (hd) {
        case 16:
            return launch<T, 16>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 32:
            return launch<T, 32>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 64:
            return launch<T, 64>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        case 128:
            return launch<T, 128>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `strides` holds (batch, head, seq)
// element strides of q, k, v, o in that order (12 values); the head_dim stride
// is 1.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int b, int hq, int hkv, int sq, int skv, int hd,
                                   const long long* strides, float sm_scale, int causal,
                                   void* stream) {
    if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || hq % hkv != 0 ||
        hq > 65535 || b > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Strides qs{strides[0], strides[1], strides[2]};
    const Strides ks{strides[3], strides[4], strides[5]};
    const Strides vs{strides[6], strides[7], strides[8]};
    const Strides os{strides[9], strides[10], strides[11]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == 0) {
        err = dispatch_hd<float>(hd, q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, s);
    } else if (dtype == 1) {
        const void* ptrs[4] = {q, k, v, o};
        if (rows_16_byte_aligned(ptrs, strides)) {
            switch (hd) {
                case 16: err = launch_tc<16>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, s); break;
                case 32: err = launch_tc<32>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, s); break;
                case 64: err = launch_tc<64>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, s); break;
                case 128: err = launch_tc<128>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, s); break;
                default: break;
            }
        } else {
            err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, qs, ks, vs, os, b, hq, hkv, sq, skv, sm_scale, causal, s);
        }
    }
    return static_cast<int>(err);
}
