// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_chunk_scan` of the reference's
// kernels/ssd_chunk.py:61.  Per (batch, head), over chunks in order, with the
// state S (P x N, fp32) starting at zero and carried from chunk to chunk:
//
//   cum  = cumsum(loga)                                   (within the chunk)
//   W    = where(t >= u, exp(cum_t - cum_u), 0) * (C B^T)[t, u] * dt_u
//   y    = W x + (C S^T) * exp(cum_t)
//   S   <- S * exp(cum_last) + (x * exp(cum_last - cum) * dt)^T B
//
// The mask is a select, never a product: for t < u, cum_t - cum_u > 0 and
// exp can overflow to inf, and inf * 0 would be NaN.
//
// Precision, both routes.  The gate exp(cum_t - cum_u) takes the difference
// of two prefix sums that reach |cum| ~ 100 within a chunk (ulp 7.6e-6), so
// two fp32 sums of loga in different orders move y by up to ~1e-5 of its size,
// more than the 1e-4 tolerance leaves at large |y|.  The prefix sum is
// therefore taken in fp64 and rounded once to fp32, here and in the plain
// version (kernels/ref.py), which makes cum the same number in both.  S stays
// fp32 from the first chunk to the last.
//
// What bounds it on this card.  At zamba2-2.7b's prefill shape
// (b, H, s, P, N) = (1, 80, 32768, 64, 64), bf16 x, fp32 y, chunk 128:
//   operations: 2 cs (cs (N + P) + 2 P N) = 6.3 MFLOP per chunk per (b, h),
//               129 GFLOP per layer; 0.13 ms at the bf16 tensor-core peak;
//   bytes:      x 335 MB + y (fp32) 671 MB + dt/loga 21 MB + B/C (shared by
//               all heads) 8 MB, about 1.04 GB; 0.31 ms at 3.35 TB/s.
// So the target is bytes.  The launch plan (route, segments, heads per block,
// grid, shared memory) is computed in Python (kernels/ssd_chunk.py,
// `ssd_plan`); this file validates it and launches.  Two routes:
//
//  * Tensor cores (ssd_tc_kernel) -- bf16 x, B and C with chunk 128, P 64 and
//    N 64 (zamba2's shapes), rows 16-byte aligned.
//      - Segments fill the card.  Each (b, h) is cut into G segments of whole
//        chunks, so b * H / HB * G blocks run instead of b * H.  Segment k's
//        incoming state is exact algebra,
//          S_in(k) = S_in(k-1) * D(k-1) + S_loc(k-1),
//        with S_loc(j) the state at the end of segment j started from zero and
//        D(j) the product of its chunks' exp(cum_last).  Pass A (STATE_ONLY)
//        runs segments 0 .. G-2 for S_loc and D only (x, B, dt, loga; no C,
//        no y); pass B starts each segment from S_in, composed in its
//        prologue from pass A's output, runs the full recurrence, writes y and,
//        in the last segment, S_final.  x is read twice; at G = 1 there is no
//        pass A.  A D that underflows to 0 is correct and meets no inf.
//      - Heads per block.  Where B and C are shared by the heads (head stride
//        0, as mamba2_fwd passes them) a block takes HB = 2 heads of one
//        segment, 4 warps each, and stages B and C once for both.
//      - Products on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
//        ldmatrix fragments from padded shared memory, all four of them:
//          C B^T   (A = C, B = B; both exact bf16),
//          C S^T   (A = C, B = S split in three),
//          W x     (A = W split in three, from registers, B = x),
//          (x w)^T B, w = exp(cum_last - cum) dt  (A = x w split in three, B = B).
//        W, S and x w are fp32.  One bf16 rounding of them (2^-9 relative)
//        would miss the 1e-4 rule on fp32 y, so each is split into bf16
//        terms v = t0 + t1 + t2 (t0 = bf16(v), t1 = bf16(v - t0), ...) whose
//        products go into one fp32 accumulator (residual ~2^-27 relative).
//        With two terms (residual ~2^-18) a y element that cancels to near 0
//        over 128 large terms can miss the rule; at one chunk with |cum| ~ 100
//        two terms reach 0.22 of it and three stay at fp32 level
//        (tests/test_torch_kernels.py::TestSSDSplitPrecision).  The state's
//        split feeds y too, through S.  Why mma.sync and not wgmma:
//        three of the four products take an operand that threads form in
//        registers (gate, dt, the split), and W never leaves them:
//        the C B^T accumulator of a 16 x 16 tile is, after gating and the
//        split, the A fragment of W x, one u-tile at a time.  wgmma would
//        take those operands through swizzled shared memory or 64-row
//        warpgroup tiles, whose causal halves cannot be skipped per 16 rows.
//      - The causal half is skipped.  Warp q of a head's 4 warps owns the
//        16-row tiles q and 7 - q of the chunk, so each warp has 9 of the 36
//        lower-triangular 16 x 16 tiles of C B^T and W x; it also owns the
//        state rows 16q .. 16q + 15, whose fp32 S stays in its accumulator
//        registers from chunk to chunk.  Above the diagonal the gate's
//        argument is selected away before exp.
//      - Staging is asynchronous: cp.async into a ring of two chunk stages,
//        so chunk c + 1's loads run under chunk c's products.  Three block
//        barriers per chunk (data, prefix sum, S rewritten as bf16 terms for
//        C S^T).  dt and loga arrive as 4-byte copies (head-minor layout).
//  * CUDA cores (ssd_chunk_kernel) -- everything else: fp32 inputs and the
//    reference's small shapes.  One block owns one (batch, head) and loops
//    over the chunks itself, S staying in shared memory.  Per chunk the block
//    stages x, B and C in fp32 shared memory, scans loga (one warp,
//    shuffles), forms the masked chunk x chunk weight W in shared memory, and
//    then computes y and the new S, all fp32 FMAs from shared memory, each
//    thread owning a register micro-tile (8x8 of W, 8x4 of y, 4x4 of S; 256
//    threads as 16 x 16).  Row strides of B, C, W and S are padded by one
//    float.  Limits: chunk <= 128, P <= 64, N <= 64 (184 KB of shared memory).
//    It cannot pass the card's 67 TFLOP/s fp32 rate.
//
// Layout: logical (b, H, s, .) for x, B, C and y, (b, H, s) for dt and loga,
// with the strides of b, H and s passed in (elements) and the last axis of
// x, B, C and y contiguous.  So the model's (b, s, H, P) x and y go in as
// transposed views, and its (b, s, N) B and C, shared by all heads, as
// expanded views with head stride 0, never materialised.  S_final is a
// contiguous (b, H, P, N) fp32 tensor; pass A's S_loc (b, H, G - 1, P, N) and
// D (b, H, G - 1) are fp32 workspaces the caller allocates.
//
// Plain C interface; the kernels launch on the given stream, do not
// synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CS_MAX = 128;
constexpr int P_MAX = 64;
constexpr int N_MAX = 64;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;   // 256 threads

constexpr int LDX = P_MAX;        // x: (u, p)
constexpr int LDB = N_MAX + 1;    // B, C: (t, n)
constexpr int LDW = CS_MAX + 1;   // W: (t, u)
constexpr int LDS = N_MAX + 1;    // S: (p, n)

struct Layout {   // offsets in floats
    static constexpr int X = 0;
    static constexpr int B = X + CS_MAX * LDX;
    static constexpr int C = B + CS_MAX * LDB;
    static constexpr int W = C + CS_MAX * LDB;
    static constexpr int S = W + CS_MAX * LDW;
    static constexpr int CUM = S + P_MAX * LDS;   // cumsum(loga)
    static constexpr int DT = CUM + CS_MAX;
    static constexpr int ECUM = DT + CS_MAX;      // exp(cum_t)
    static constexpr int WST = ECUM + CS_MAX;     // exp(cum_last - cum_u) * dt_u
    static constexpr int floats = WST + CS_MAX;
    static constexpr size_t bytes = sizeof(float) * floats;
};

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

template <typename T, typename O>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ B, const T* __restrict__ C,
                 const float* __restrict__ dt, const float* __restrict__ loga,
                 O* __restrict__ y, float* __restrict__ s_final, Strides xs, Strides bs,
                 Strides cs, Strides ds, Strides ls, Strides ys, int seq, int chunk, int P,
                 int N) {
    extern __shared__ __align__(16) float smem[];
    float* Xs = smem + Layout::X;
    float* Bs = smem + Layout::B;
    float* Cs = smem + Layout::C;
    float* Ws = smem + Layout::W;
    float* Ss = smem + Layout::S;
    float* CUM = smem + Layout::CUM;
    float* DTs = smem + Layout::DT;
    float* ECUM = smem + Layout::ECUM;
    float* WST = smem + Layout::WST;

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int h = blockIdx.x, b = blockIdx.y;
    const int H = gridDim.x;

    const T* xb = x + b * xs.b + h * xs.h;
    const T* bb = B + b * bs.b + h * bs.h;
    const T* cb = C + b * cs.b + h * cs.h;
    const float* db = dt + b * ds.b + h * ds.h;
    const float* lb = loga + b * ls.b + h * ls.h;
    O* yb = y + b * ys.b + h * ys.h;

    // Rows and columns past (chunk, P, N) stay zero, so the fixed-size
    // micro-tiles below read zeros there; S starts at zero.
    for (int i = tid; i < Layout::floats; i += NT) smem[i] = 0.f;
    __syncthreads();

    const int n_chunks = seq / chunk;
    for (int c = 0; c < n_chunks; ++c) {
        const long long t0 = static_cast<long long>(c) * chunk;

        // ---- stage the chunk in fp32
        for (int idx = tid; idx < chunk * P; idx += NT) {
            const int t = idx / P, p = idx % P;
            Xs[t * LDX + p] = to_f32(xb[(t0 + t) * xs.s + p]);
        }
        for (int idx = tid; idx < chunk * N; idx += NT) {
            const int t = idx / N, n = idx % N;
            Bs[t * LDB + n] = to_f32(bb[(t0 + t) * bs.s + n]);
            Cs[t * LDB + n] = to_f32(cb[(t0 + t) * cs.s + n]);
        }
        for (int t = tid; t < chunk; t += NT) {
            DTs[t] = db[(t0 + t) * ds.s];
            CUM[t] = lb[(t0 + t) * ls.s];
        }
        __syncthreads();

        // ---- cum = cumsum(loga): warp 0, four consecutive entries per lane, in
        // fp64 and rounded once to fp32 (see the note on precision above)
        if (tid < 32) {
            constexpr int E = CS_MAX / 32;
            double v[E];
            double run = 0.0;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int idx = tid * E + e;
                run += idx < chunk ? static_cast<double>(CUM[idx]) : 0.0;
                v[e] = run;
            }
            double incl = run;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const double o = __shfl_up_sync(0xffffffffu, incl, off);
                if (tid >= off) incl += o;
            }
            const double excl = incl - run;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int idx = tid * E + e;
                if (idx < chunk) CUM[idx] = static_cast<float>(v[e] + excl);
            }
        }
        __syncthreads();
        const float cum_last = CUM[chunk - 1];
        for (int t = tid; t < chunk; t += NT) {
            ECUM[t] = expf(CUM[t]);
            WST[t] = expf(cum_last - CUM[t]) * DTs[t];
        }

        // ---- W[t][u] = where(t >= u, exp(cum_t - cum_u), 0) * (C_t . B_u) * dt_u
        {
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                float cv[8], bv[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) cv[i] = Cs[(ty + TY * i) * LDB + n];
#pragma unroll
                for (int j = 0; j < 8; ++j) bv[j] = Bs[(tx + TX * j) * LDB + n];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int t = ty + TY * i;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int u = tx + TX * j;
                    if (t < chunk && u < chunk)
                        Ws[t * LDW + u] = t >= u ? expf(CUM[t] - CUM[u]) * acc[i][j] * DTs[u] : 0.f;
                }
            }
        }
        __syncthreads();

        // ---- y[t][p] = sum_u W[t][u] x[u][p] + exp(cum_t) * sum_n C[t][n] S[p][n]
        {
            float acc[8][4], st[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = st[i][j] = 0.f;
#pragma unroll 4
            for (int u = 0; u < chunk; ++u) {
                float wv[8], xv[4];
#pragma unroll
                for (int i = 0; i < 8; ++i) wv[i] = Ws[(ty + TY * i) * LDW + u];
#pragma unroll
                for (int j = 0; j < 4; ++j) xv[j] = Xs[u * LDX + tx + TX * j];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
            }
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                float cv[8], sv[4];
#pragma unroll
                for (int i = 0; i < 8; ++i) cv[i] = Cs[(ty + TY * i) * LDB + n];
#pragma unroll
                for (int j = 0; j < 4; ++j) sv[j] = Ss[(tx + TX * j) * LDS + n];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) st[i][j] = fmaf(cv[i], sv[j], st[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int t = ty + TY * i;
                if (t >= chunk) continue;
                const float e = ECUM[t];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int p = tx + TX * j;
                    if (p < P) yb[(t0 + t) * ys.s + p] = from_f32<O>(acc[i][j] + st[i][j] * e);
                }
            }
        }
        __syncthreads();   // every thread has read S for y before it changes

        // ---- S[p][n] <- S[p][n] exp(cum_last) + sum_u x[u][p] w_state[u] B[u][n]
        {
            const float decay = expf(cum_last);
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = Ss[(ty + TY * i) * LDS + tx + TX * j] * decay;
#pragma unroll 4
            for (int u = 0; u < chunk; ++u) {
                const float w = WST[u];
                float xv[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) xv[i] = Xs[u * LDX + ty + TY * i] * w;
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = Bs[u * LDB + tx + TX * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int p = ty + TY * i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = tx + TX * j;
                    if (p < P && n < N) Ss[p * LDS + n] = acc[i][j];
                }
            }
        }
        __syncthreads();   // the next chunk's staging overwrites x, B, C, cum
    }

    float* sf = s_final + (static_cast<long long>(b) * H + h) * P * N;
    for (int idx = tid; idx < P * N; idx += NT) {
        const int p = idx / N, n = idx % N;
        sf[idx] = Ss[p * LDS + n];
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: segments, mma.sync on split fp32 operands, cp.async
// ---------------------------------------------------------------------------

constexpr int TC_CS = 128;            // chunk rows
constexpr int TC_P = 64;              // head dim P
constexpr int TC_N = 64;              // state dim N
constexpr int TC_LD = 72;             // bf16 row stride in shared memory: 144 B, so the
                                      // 8 rows an ldmatrix reads fall in 8 bank groups
constexpr int TC_TILE = TC_CS * TC_LD * 2;   // bytes of one 128 x 64 operand
constexpr int TC_STILE = TC_P * TC_LD * 2;   // bytes of S hi or lo (64 x 64)
constexpr int TC_WARPS = 4;                  // warps per head
// bf16 terms each fp32 operand is split into (see the note on precision):
constexpr int TERMS_W = 3;    // W in W x
constexpr int TERMS_S = 3;    // S in C S^T
constexpr int TERMS_XW = 3;   // x w in (x w)^T B

// Shared memory in bytes: two stages of [x (HB heads), B, C (pass B only),
// dt (HB), loga (HB)], then S hi and S lo per head (pass B only).  loga's slot
// is overwritten in place by the chunk's prefix sum.
template <int HB, bool STATE_ONLY>
struct TcLayout {
    static constexpr int X = 0;
    static constexpr int B = X + HB * TC_TILE;
    static constexpr int C = B + TC_TILE;
    static constexpr int DT = C + (STATE_ONLY ? 0 : TC_TILE);
    static constexpr int LOGA = DT + HB * TC_CS * 4;
    static constexpr int STAGE = LOGA + HB * TC_CS * 4;
    static constexpr int S_SPLIT = 2 * STAGE;   // [term][head] 64 x 64 bf16
    static constexpr int bytes = S_SPLIT + (STATE_ONLY ? 0 : TERMS_S * HB * TC_STILE);
    static constexpr int threads = 32 * TC_WARPS * HB;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices; lane l gives the address of a row of matrix l / 8
// and receives, in register i, its two elements of matrix i (row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1; with .trans the transpose).
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

// D (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16).  Fragments, with
// g = lane / 4 and i = lane % 4: A a0 (g, 2i..2i+1), a1 (g + 8, 2i..),
// a2 (g, 8 + 2i..), a3 (g + 8, 8 + 2i..); B b0 (k 2i..2i+1, n g),
// b1 (k 8 + 2i.., n g); D d0, d1 (g, 2i..2i+1), d2, d3 (g + 8, 2i..2i+1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a, b) fp32 as K bf16 pairs whose sum approximates them: each term the
// bf16 rounding of what the terms before it left (a in the low halves).
template <int K>
__device__ __forceinline__ void split_terms(float a, float b, uint32_t* out, int stride) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(h);
        out[k * stride] = bf16x2_bits(h);
        a -= hf.x;
        b -= hf.y;
    }
}

template <typename O> __device__ __forceinline__ void store_pair(O* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                    float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One block: HB heads of one segment of one batch row; 4 warps per head.
// STATE_ONLY is pass A.  grid = (segments this pass runs, H / HB, b).
template <int HB, bool STATE_ONLY, typename O>
__global__ void __launch_bounds__(TcLayout<HB, STATE_ONLY>::threads, STATE_ONLY ? 2 : 1)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ B,
              const __nv_bfloat16* __restrict__ C, const float* __restrict__ dt,
              const float* __restrict__ loga, O* __restrict__ y, float* __restrict__ s_final,
              float* __restrict__ s_loc, float* __restrict__ seg_decay, Strides xs, Strides bs,
              Strides cs, Strides ds, Strides ls, Strides ys, int H, int n_chunks, int G) {
    using L = TcLayout<HB, STATE_ONLY>;
    constexpr int NT = L::threads;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    const uint32_t base = smem_u32(tc_smem);

    const int tid = threadIdx.x;
    const int grp = tid / (32 * TC_WARPS);            // this thread's head in the block
    const int wq = (tid / 32) % TC_WARPS;             // its warp within the head
    const int lane = tid % 32, g = lane / 4, qi = lane % 4;
    const int seg = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z;
    const int h = h0 + grp;
    const int c_begin = static_cast<int>(static_cast<long long>(seg) * n_chunks / G);
    const int c_end = static_cast<int>(static_cast<long long>(seg + 1) * n_chunks / G);
    const long long ws = (static_cast<long long>(b) * H + h) * (G - 1);   // workspace row

    // ---- staging: one chunk of x (HB heads), B, C, dt, loga into a stage
    auto issue = [&](int c, int stage) {
        const long long t0 = static_cast<long long>(c) * TC_CS;
        const uint32_t st = base + stage * L::STAGE;
        for (int i = tid; i < HB * TC_CS * 8; i += NT) {
            const int hh = i / (TC_CS * 8), r = (i / 8) % TC_CS, k = i % 8;
            cp_async16(st + L::X + hh * TC_TILE + (r * TC_LD + 8 * k) * 2,
                       x + b * xs.b + (h0 + hh) * xs.h + (t0 + r) * xs.s + 8 * k);
        }
        for (int i = tid; i < TC_CS * 8; i += NT) {
            const int r = i / 8, k = i % 8;
            const uint32_t off = (r * TC_LD + 8 * k) * 2;
            cp_async16(st + L::B + off, B + b * bs.b + h0 * bs.h + (t0 + r) * bs.s + 8 * k);
            if constexpr (!STATE_ONLY)
                cp_async16(st + L::C + off, C + b * cs.b + h0 * cs.h + (t0 + r) * cs.s + 8 * k);
        }
        for (int i = tid; i < HB * TC_CS; i += NT) {
            const int hh = i / TC_CS, r = i % TC_CS;
            cp_async4(st + L::DT + (hh * TC_CS + r) * 4,
                      dt + b * ds.b + (h0 + hh) * ds.h + (t0 + r) * ds.s);
            cp_async4(st + L::LOGA + (hh * TC_CS + r) * 4,
                      loga + b * ls.b + (h0 + hh) * ls.h + (t0 + r) * ls.s);
        }
        cp_async_commit();
    };

    // ---- S: this warp's state rows p = 16 wq + g (+ 8), columns n = 8 j + 2 qi (+ 1)
    float S[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
    if constexpr (!STATE_ONLY) {
        // S_in(seg) = S_in(seg - 1) * D(seg - 1) + S_loc(seg - 1), from S_in(0) = 0
        for (int k = 0; k < seg; ++k) {
            const float d = seg_decay[ws + k];
            const float* sl = s_loc + (ws + k) * (TC_P * TC_N);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int p = 16 * wq + g + 8 * (e >> 1), n = 8 * j + 2 * qi + (e & 1);
                    S[j][e] = S[j][e] * d + sl[p * TC_N + n];
                }
        }
    }
    // S as TERMS_S bf16 terms in shared memory, the B operand of C S^T
    const uint32_t s_split = base + L::S_SPLIT + grp * TC_STILE;
    auto write_s_split = [&]() {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                uint32_t t[TERMS_S];
                split_terms<TERMS_S>(S[j][2 * r], S[j][2 * r + 1], t, 1);
                const uint32_t off = ((16 * wq + g + 8 * r) * TC_LD + 8 * j + 2 * qi) * 2;
#pragma unroll
                for (int k = 0; k < TERMS_S; ++k)
                    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(s_split + k * HB * TC_STILE + off),
                                 "r"(t[k]) : "memory");
            }
    };
    if constexpr (!STATE_ONLY) write_s_split();

    float decay_prod = 1.f;   // pass A: D of this segment
    issue(c_begin, 0);
    for (int c = c_begin; c < c_end; ++c) {
        const int stage = (c - c_begin) & 1;
        cp_async_wait_all();   // chunk c's copies, the only ones in flight
        __syncthreads();       // ... visible to all; every thread is done with chunk c - 1
        if (c + 1 < c_end) issue(c + 1, stage ^ 1);

        const uint32_t st = base + stage * L::STAGE;
        float* cum = reinterpret_cast<float*>(tc_smem + stage * L::STAGE + L::LOGA) + grp * TC_CS;
        const float* dts = reinterpret_cast<const float*>(tc_smem + stage * L::STAGE + L::DT) + grp * TC_CS;
        const uint32_t xa = st + L::X + grp * TC_TILE;
        const uint32_t ba = st + L::B;

        // ---- cum = cumsum(loga) in fp64, rounded once: warp 0 of each head,
        // four consecutive entries per lane
        if (wq == 0) {
            double v[4];
            double run = 0.0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                run += static_cast<double>(cum[4 * lane + e]);
                v[e] = run;
            }
            double incl = run;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const double o = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += o;
            }
            const double excl = incl - run;
#pragma unroll
            for (int e = 0; e < 4; ++e) cum[4 * lane + e] = static_cast<float>(v[e] + excl);
        }
        __syncthreads();
        const float cum_last = cum[TC_CS - 1];

        if constexpr (!STATE_ONLY) {
            const uint32_t ca_base = st + L::C;
            O* yb = y + b * ys.b + h * ys.h + static_cast<long long>(c) * TC_CS * ys.s;
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
                const int r = half == 0 ? wq : 7 - wq;   // this warp's 16-row tile
                float acc[8][4];
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
                uint32_t ca[4][4];   // C rows of the tile, the A operand, 4 k-steps over n
#pragma unroll
                for (int kn = 0; kn < 4; ++kn)
                    ldsm_x4(ca[kn], ca_base + ((16 * r + lane % 16) * TC_LD + 16 * kn + (lane / 16) * 8) * 2);

                // y_state = (C S^T) * exp(cum_t); S^T's fragments from S[p][n] (n contiguous)
#pragma unroll
                for (int jp = 0; jp < 4; ++jp)
#pragma unroll
                    for (int kn = 0; kn < 4; ++kn) {
                        const uint32_t off =
                            ((16 * jp + lane % 8 + (lane / 16) * 8) * TC_LD + 16 * kn + ((lane / 8) % 2) * 8) * 2;
#pragma unroll
                        for (int k = 0; k < TERMS_S; ++k) {
                            uint32_t bs4[4];
                            ldsm_x4(bs4, s_split + k * HB * TC_STILE + off);
                            mma16816(acc[2 * jp], ca[kn], bs4[0], bs4[1]);
                            mma16816(acc[2 * jp + 1], ca[kn], bs4[2], bs4[3]);
                        }
                    }
                const int ta = 16 * r + g, tb = ta + 8;
                const float cta = cum[ta], ctb = cum[tb];
                const float ea = expf(cta), eb = expf(ctb);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    acc[j][0] *= ea;
                    acc[j][1] *= ea;
                    acc[j][2] *= eb;
                    acc[j][3] *= eb;
                }

                // y_intra = W x over the u-tiles at or below the diagonal
#pragma unroll 1
                for (int ut = 0; ut <= r; ++ut) {
                    float gt[2][4];   // (C B^T) for t in the tile, u in 16 ut .. 16 ut + 15
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) gt[j][e] = 0.f;
#pragma unroll
                    for (int kn = 0; kn < 4; ++kn) {
                        uint32_t bb[4];
                        ldsm_x4(bb, ba + ((16 * ut + lane % 8 + (lane / 16) * 8) * TC_LD + 16 * kn +
                                          ((lane / 8) % 2) * 8) * 2);
                        mma16816(gt[0], ca[kn], bb[0], bb[1]);
                        mma16816(gt[1], ca[kn], bb[2], bb[3]);
                    }
                    // W = where(t >= u, exp(cum_t - cum_u), 0) * (C B^T) * dt_u, split
                    // into the A fragments of W x (the accumulator's layout)
                    uint32_t aw[TERMS_W][4];
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int u0 = 16 * ut + 8 * j + 2 * qi;
                        const float cu0 = cum[u0], cu1 = cum[u0 + 1];
                        const float d0 = dts[u0], d1 = dts[u0 + 1];
                        const bool m00 = ta >= u0, m01 = ta >= u0 + 1, m10 = tb >= u0, m11 = tb >= u0 + 1;
                        const float w00 = m00 ? expf(m00 ? cta - cu0 : 0.f) * gt[j][0] * d0 : 0.f;
                        const float w01 = m01 ? expf(m01 ? cta - cu1 : 0.f) * gt[j][1] * d1 : 0.f;
                        const float w10 = m10 ? expf(m10 ? ctb - cu0 : 0.f) * gt[j][2] * d0 : 0.f;
                        const float w11 = m11 ? expf(m11 ? ctb - cu1 : 0.f) * gt[j][3] * d1 : 0.f;
                        split_terms<TERMS_W>(w00, w01, &aw[0][2 * j], 4);
                        split_terms<TERMS_W>(w10, w11, &aw[0][2 * j + 1], 4);
                    }
#pragma unroll
                    for (int jp = 0; jp < 4; ++jp) {
                        uint32_t xb[4];   // x[u][p] (p contiguous): transposed fragments
                        ldsm_x4_t(xb, xa + ((16 * ut + lane % 8 + ((lane / 8) % 2) * 8) * TC_LD + 16 * jp +
                                            (lane / 16) * 8) * 2);
#pragma unroll
                        for (int k = 0; k < TERMS_W; ++k) {
                            mma16816(acc[2 * jp], aw[k], xb[0], xb[1]);
                            mma16816(acc[2 * jp + 1], aw[k], xb[2], xb[3]);
                        }
                    }
                }
                O* ya = yb + static_cast<long long>(ta) * ys.s + 2 * qi;
                O* yt = yb + static_cast<long long>(tb) * ys.s + 2 * qi;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    store_pair<O>(ya + 8 * j, acc[j][0], acc[j][1]);
                    store_pair<O>(yt + 8 * j, acc[j][2], acc[j][3]);
                }
            }
        }

        // ---- S <- S exp(cum_last) + (x w)^T B, w = exp(cum_last - cum) dt, on this
        // warp's 16 state rows; (x w)^T's fragments are x's, transposed and scaled
        const float decay = expf(cum_last);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) S[j][e] *= decay;
#pragma unroll 2
        for (int ku = 0; ku < TC_CS / 16; ++ku) {
            uint32_t xf[4];
            ldsm_x4_t(xf, xa + ((16 * ku + lane % 8 + (lane / 16) * 8) * TC_LD + 16 * wq +
                                ((lane / 8) % 2) * 8) * 2);
            const int u0 = 16 * ku + 2 * qi;
            const float w0 = expf(cum_last - cum[u0]) * dts[u0];
            const float w1 = expf(cum_last - cum[u0 + 1]) * dts[u0 + 1];
            const float w2 = expf(cum_last - cum[u0 + 8]) * dts[u0 + 8];
            const float w3 = expf(cum_last - cum[u0 + 9]) * dts[u0 + 9];
            uint32_t axw[TERMS_XW][4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float2 v = unpack_bf16x2(xf[a]);   // a0, a1: u0, u0 + 1; a2, a3: u0 + 8, u0 + 9
                const float wa = a < 2 ? w0 : w2, wb = a < 2 ? w1 : w3;
                split_terms<TERMS_XW>(v.x * wa, v.y * wb, &axw[0][a], 4);
            }
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
                uint32_t bb[4];   // B[u][n] (n contiguous): transposed fragments
                ldsm_x4_t(bb, ba + ((16 * ku + lane % 8 + ((lane / 8) % 2) * 8) * TC_LD + 16 * jn +
                                    (lane / 16) * 8) * 2);
#pragma unroll
                for (int k = 0; k < TERMS_XW; ++k) {
                    mma16816(S[2 * jn], axw[k], bb[0], bb[1]);
                    mma16816(S[2 * jn + 1], axw[k], bb[2], bb[3]);
                }
            }
        }
        if constexpr (STATE_ONLY) {
            decay_prod *= decay;
        } else if (c + 1 < c_end) {
            __syncthreads();   // every warp has read the old S for C S^T
            write_s_split();
        }
    }

    float* out = nullptr;
    if constexpr (STATE_ONLY) {
        out = s_loc + (ws + seg) * (TC_P * TC_N);
        if (tid % (32 * TC_WARPS) == 0) seg_decay[ws + seg] = decay_prod;
    } else if (seg == G - 1) {
        out = s_final + (static_cast<long long>(b) * H + h) * (TC_P * TC_N);
    }
    if (out != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int p = 16 * wq + g + 8 * r, n = 8 * j + 2 * qi;
                *reinterpret_cast<float2*>(out + p * TC_N + n) = make_float2(S[j][2 * r], S[j][2 * r + 1]);
            }
    }
}

// ---------------------------------------------------------------------------
// Host side: the launch plan, launches
// ---------------------------------------------------------------------------

// The launch plan (kernels/ssd_chunk.py, `SSDPlan.as_array`), 9 int64:
//   [0] route (0 = CUDA cores, 1 = tensor cores), [1] heads per block,
//   [2] segments G, [3] threads, [4..6] pass B's grid (the CUDA-core kernel's:
//   H, b, 1), [7] pass B's dynamic shared memory bytes, [8] pass A's (0 where
//   there is no pass A).

template <typename T, typename O>
cudaError_t launch(const void* x, const void* B, const void* C, const float* dt,
                   const float* loga, void* y, float* s_final, const Strides* st, int b, int H,
                   int seq, int P, int N, int chunk, const long long* plan, cudaStream_t stream) {
    if (plan[1] != 1 || plan[2] != 1 || plan[3] != NT || plan[4] != H || plan[5] != b ||
        plan[6] != 1 || plan[7] != static_cast<long long>(Layout::bytes) || plan[8] != 0)
        return cudaErrorInvalidValue;
    auto kernel = ssd_chunk_kernel<T, O>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Layout::bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(H, b);
    kernel<<<grid, NT, Layout::bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(B), static_cast<const T*>(C), dt, loga,
        static_cast<O*>(y), s_final, st[0], st[1], st[2], st[3], st[4], st[5], seq, chunk, P, N);
    return cudaGetLastError();
}

// The tensor-core route's inputs: bf16 x, B, C with 16-byte-aligned rows
// (base addresses, and batch/head/sequence strides a multiple of 8 elements)
// and y's pairs aligned.
bool tc_inputs_ok(const void* x, const void* B, const void* C, const void* y,
                  const long long* strides) {
    const void* ptrs[4] = {x, B, C, y};
    for (int i = 0; i < 4; ++i)
        if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int i = 0; i < 9; ++i)   // x, B, C
        if (strides[i] % 8 != 0) return false;
    for (int i = 15; i < 18; ++i)   // y
        if (strides[i] % 2 != 0) return false;
    return true;
}

template <int HB, typename O>
int launch_tc(const void* x, const void* B, const void* C, const float* dt, const float* loga,
              void* y, float* s_final, float* s_loc, float* seg_decay, const Strides* st, int b,
              int H, int seq, const long long* plan, cudaStream_t stream) {
    using LA = TcLayout<HB, true>;
    using LB = TcLayout<HB, false>;
    const int n_chunks = seq / TC_CS;
    const long long G = plan[2];
    if (G < 1 || G > n_chunks || G > 65535 || H % HB != 0 || H / HB > 65535 ||
        plan[3] != LB::threads || plan[4] != G || plan[5] != H / HB || plan[6] != b ||
        plan[7] != LB::bytes || plan[8] != (G > 1 ? LA::bytes : 0))
        return cudaErrorInvalidValue;
    if (HB > 1 && (st[1].h != 0 || st[2].h != 0)) return cudaErrorInvalidValue;   // B, C shared
    if (G > 1 && (s_loc == nullptr || seg_decay == nullptr)) return cudaErrorInvalidValue;
    const int segs = static_cast<int>(G);
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* bp = static_cast<const __nv_bfloat16*>(B);
    const auto* cp = static_cast<const __nv_bfloat16*>(C);
    cudaError_t err;
    if (segs > 1) {
        auto pass_a = ssd_tc_kernel<HB, true, float>;   // writes no y
        err = cudaFuncSetAttribute(pass_a, cudaFuncAttributeMaxDynamicSharedMemorySize, LA::bytes);
        if (err != cudaSuccess) return err;
        pass_a<<<dim3(segs - 1, H / HB, b), LA::threads, LA::bytes, stream>>>(
            xp, bp, cp, dt, loga, nullptr, nullptr, s_loc, seg_decay, st[0], st[1], st[2], st[3],
            st[4], st[5], H, n_chunks, segs);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    auto pass_b = ssd_tc_kernel<HB, false, O>;
    err = cudaFuncSetAttribute(pass_b, cudaFuncAttributeMaxDynamicSharedMemorySize, LB::bytes);
    if (err != cudaSuccess) return err;
    pass_b<<<dim3(segs, H / HB, b), LB::threads, LB::bytes, stream>>>(
        xp, bp, cp, dt, loga, static_cast<O*>(y), s_final, s_loc, seg_decay, st[0], st[1], st[2],
        st[3], st[4], st[5], H, n_chunks, segs);
    return cudaGetLastError();
}

template <typename O>
int dispatch_tc(const void* x, const void* B, const void* C, const float* dt, const float* loga,
                void* y, float* s_final, float* s_loc, float* seg_decay, const Strides* st, int b,
                int H, int seq, const long long* plan, cudaStream_t stream) {
    if (plan[1] == 1)
        return launch_tc<1, O>(x, B, C, dt, loga, y, s_final, s_loc, seg_decay, st, b, H, seq, plan, stream);
    if (plan[1] == 2)
        return launch_tc<2, O>(x, B, C, dt, loga, y, s_final, s_loc, seg_decay, st, b, H, seq, plan, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; `in_dtype` is that of x, B and C
// (dt and loga are float32), `out_dtype` that of y.  `strides` holds the
// (batch, head, seq) element strides of x, B, C, dt, loga and y in that order
// (18 values); the last axis of x, B, C and y is contiguous.  `s_loc` and
// `seg_decay`: the tensor-core route's workspaces for G > 1 (else unused).
// `plan`: see the launch plan above.  Returns a cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan_fwd(const void* x, const void* B, const void* C, const float* dt,
                                  const float* loga, void* y, float* s_final, float* s_loc,
                                  float* seg_decay, int in_dtype, int out_dtype, int b, int H,
                                  int seq, int P, int N, int chunk, const long long* strides,
                                  const long long* plan, void* stream) {
    if (b <= 0 || H <= 0 || b > 65535 || chunk <= 0 || chunk > CS_MAX || seq <= 0 ||
        seq % chunk != 0 || P <= 0 || P > P_MAX || N <= 0 || N > N_MAX || out_dtype < 0 ||
        out_dtype > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Strides st[6];
    for (int i = 0; i < 6; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (plan[0] == 1) {
        if (in_dtype != 1 || chunk != TC_CS || P != TC_P || N != TC_N ||
            !tc_inputs_ok(x, B, C, y, strides))
            return static_cast<int>(cudaErrorInvalidValue);
        return out_dtype == 0
            ? dispatch_tc<float>(x, B, C, dt, loga, y, s_final, s_loc, seg_decay, st, b, H, seq, plan, s)
            : dispatch_tc<__nv_bfloat16>(x, B, C, dt, loga, y, s_final, s_loc, seg_decay, st, b, H, seq, plan, s);
    }
    if (plan[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaErrorInvalidValue;
    if (in_dtype == 0 && out_dtype == 0) {
        err = launch<float, float>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, plan, s);
    } else if (in_dtype == 0 && out_dtype == 1) {
        err = launch<float, __nv_bfloat16>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, plan, s);
    } else if (in_dtype == 1 && out_dtype == 0) {
        err = launch<__nv_bfloat16, float>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, plan, s);
    } else if (in_dtype == 1 && out_dtype == 1) {
        err = launch<__nv_bfloat16, __nv_bfloat16>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, plan, s);
    }
    return static_cast<int>(err);
}
