// Mamba2 SSD chunk scan, backward, for Hopper (sm_90a).
//
// The TPU kernel `_ssd_kernel` / `ssd_chunk_scan` of the reference's
// kernels/ssd_chunk.py:61 is forward-only; the reference differentiates the
// same chunk recurrence as jnp math (models/zamba.py's `lax.scan`).  This is
// the VJP of the forward in csrc/ssd_chunk.cu.  Per (batch, head) and chunk,
// with cum the chunk's prefix sum of loga, L its last step, S_in the state
// entering the chunk and dS the gradient of the state leaving it:
//
//   gcb[t,u] = where(t >= u, exp(cum_t - cum_u), 0) (C_t . B_u)
//   dW[t,u]  = dy_t . x_u,                 dcb = dW gate dt_u
//   dx_u     = dt_u (sum_t gcb[t,u] dy_t + exp(cum_L - cum_u) dS B_u)
//   dC_t     = sum_u dcb[t,u] B_u + exp(cum_t) dy_t S_in
//   dB_u     = sum_t dcb[t,u] C_t + exp(cum_L - cum_u) dt_u x_u dS
//   ddt_u    = sum_t dW gcb + exp(cum_L - cum_u) x_u . (dS B_u)
//   dcum_t   = rows of q - columns of q - h_t + exp(cum_t) dy_t . (C_t S_in^T),
//              q = dW gcb dt_u, h_u = dt_u ddt_u's state term; dcum_L also
//              gets sum_u h_u + exp(cum_L) sum(dS * S_in)
//   dloga    = reverse prefix sum of dcum (fp64, rounded once, as the forward
//              takes cum)
//   dS_in    = exp(cum_L) dS + sum_t exp(cum_t) dy_t^T C_t
//
// Three kernels, all fp32 FMAs on the CUDA cores, no atomics (every sum in a
// fixed order, so two calls agree bit for bit):
//
//  1. ssd_bwd_states_kernel, grid (H, b, 2): per (b, h) one block walks the
//     chunks forwards and writes each chunk's S_in (layout [p][n]); another
//     walks them backwards from dS_final and writes each chunk's outgoing dS
//     (layout [n][p]).  The states are recomputed here rather than saved by
//     the forward: at zamba2-2.7b's training shape (4, 80, 1024, 64, 64) each
//     workspace is 42 MB.
//  2. ssd_bwd_chunk_kernel, grid (groups, chunks, b): every chunk at once.  A
//     block takes one chunk of a group of heads; where B and C are shared by
//     the heads (head stride 0, as mamba2_fwd passes them) the group's dcb is
//     summed in registers over its heads, so the dB and dC products run once
//     a group, not once a head, and the group's dB/dC (fp32) go to a partial
//     per group.  Per head: dx, ddt and dloga.  Per-head B and C take groups
//     of one head.
//  3. ssd_bwd_reduce_kernel: dB and dC as the sum of the groups' partials in
//     group order, in B's dtype.
//
// What bounds it on this card.  At (4, 80, 1024, 64, 64), bf16 x, fp32 dy:
// bytes, each input read once and each output written once, ~175 MB (0.052
// ms at 3.35 TB/s); operations, per (b, h, chunk) five chunk x chunk x 64
// products over their causal half and five chunk x 64 x 64 products, 26.9
// GFLOP (0.40 ms at the 67 TFLOP/s fp32 rate).  So operations bound it.  The
// design is a first, simple one:
// 256 threads as 16 x 16 with register micro-tiles read from padded shared
// memory, the causal half of the chunk x chunk products skipped per tile
// pair, the chunk x chunk products of B and C shared by a group's heads.
// Tensor cores (the forward's three-term bf16 split), TMA and a segment split
// for b = 1 at long sequences are later work.
//
// Layout: logical (b, H, s, .) for x, B, C, dy and dx, (b, H, s) for dt,
// loga, ddt and dloga, with the (batch, head, seq) strides passed in
// (elements) and the last axis of x, B, C, dy and dx contiguous.  dB and dC
// are (b, J, s, N) with J = 1 (shared) or H, strides passed in.  Workspaces
// the caller allocates: S_in (b, H, chunks, P, N), dS (b, H, chunks, N, P),
// the partials (b, groups, s, N) for dB and dC, all fp32.
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
constexpr int NWARPS = NT / 32;

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

// cum[0 .. chunk) <- its prefix sum, in fp64 and rounded once to fp32 (the
// forward's arithmetic); one warp, four consecutive entries per lane.
__device__ __forceinline__ void chunk_cumsum(float* cum, int chunk, int lane) {
    constexpr int E = CS_MAX / 32;
    double v[E];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int idx = lane * E + e;
        run += idx < chunk ? static_cast<double>(cum[idx]) : 0.0;
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
    for (int e = 0; e < E; ++e) {
        const int idx = lane * E + e;
        if (idx < chunk) cum[idx] = static_cast<float>(v[e] + excl);
    }
}

// Sum over the 16 lanes that share this lane's half-warp (one row of 16 x 16).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ---------------------------------------------------------------------------
// 1. states: S_in of every chunk (forwards), dS of every chunk (backwards)
// ---------------------------------------------------------------------------

struct StatesLayout {   // offsets in floats
    static constexpr int R = 0;                          // row operand (k, row), ld 64
    static constexpr int K = R + CS_MAX * 64;            // column operand (k, col), ld 64
    static constexpr int CUM = K + CS_MAX * 64;
    static constexpr int W = CUM + CS_MAX;               // dt, then the k weights
    static constexpr int floats = W + CS_MAX;
    static constexpr size_t bytes = sizeof(float) * floats;
};

// blockIdx.z = 0: acc[p][n] = S, rows p = ty + 16 i, columns n = tx + 16 j;
//   S <- S e^{cum_L} + sum_u (x_u e^{cum_L - cum_u} dt_u)^T B_u; writes S_in.
// blockIdx.z = 1: acc[n][p] = dS^T, rows n, columns p, from dS_final;
//   dS <- dS e^{cum_L} + sum_t C_t^T (e^{cum_t} dy_t); writes each chunk's
//   outgoing dS before taking the chunk.
template <typename T, typename TY_>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_states_kernel(const T* __restrict__ x, const T* __restrict__ B, const T* __restrict__ C,
                      const float* __restrict__ dt, const float* __restrict__ loga,
                      const TY_* __restrict__ dy, const float* __restrict__ ds_final,
                      float* __restrict__ s_in, float* __restrict__ ds_out, Strides xs,
                      Strides bs, Strides cs, Strides ds, Strides ls, Strides ys, int seq,
                      int chunk, int P, int N) {
    extern __shared__ __align__(16) float smem[];
    float* R = smem + StatesLayout::R;
    float* K = smem + StatesLayout::K;
    float* CUM = smem + StatesLayout::CUM;
    float* W = smem + StatesLayout::W;

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
    const bool reverse = blockIdx.z == 1;
    const int n_chunks = seq / chunk;
    const int rows = reverse ? N : P, cols = reverse ? P : N;

    for (int i = tid; i < StatesLayout::floats; i += NT) smem[i] = 0.f;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int r = ty + TY * i, c = tx + TX * j;
            // dS_final is (b, H, P, N): acc[n][p] = dS_final[p][n]
            acc[i][j] = reverse && ds_final != nullptr && r < rows && c < cols
                ? ds_final[(static_cast<long long>(b) * H + h) * P * N + c * N + r] : 0.f;
        }
    __syncthreads();

    const long long bh = static_cast<long long>(b) * H + h;
    for (int step = 0; step < n_chunks; ++step) {
        const int c = reverse ? n_chunks - 1 - step : step;
        float* out = (reverse ? ds_out : s_in) + (bh * n_chunks + c) * P * N;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = ty + TY * i, col = tx + TX * j;
                if (r < rows && col < cols) out[r * cols + col] = acc[i][j];
            }
        if (reverse && c == 0) break;   // the state entering chunk 0 is a constant

        const long long t0 = static_cast<long long>(c) * chunk;
        if (reverse) {   // R = C (t, n), K = dy (t, p)
            for (int idx = tid; idx < chunk * N; idx += NT) {
                const int t = idx / N, n = idx % N;
                R[t * 64 + n] = to_f32(C[b * cs.b + h * cs.h + (t0 + t) * cs.s + n]);
            }
            for (int idx = tid; idx < chunk * P; idx += NT) {
                const int t = idx / P, p = idx % P;
                K[t * 64 + p] = to_f32(dy[b * ys.b + h * ys.h + (t0 + t) * ys.s + p]);
            }
        } else {         // R = x (u, p), K = B (u, n)
            for (int idx = tid; idx < chunk * P; idx += NT) {
                const int t = idx / P, p = idx % P;
                R[t * 64 + p] = to_f32(x[b * xs.b + h * xs.h + (t0 + t) * xs.s + p]);
            }
            for (int idx = tid; idx < chunk * N; idx += NT) {
                const int t = idx / N, n = idx % N;
                K[t * 64 + n] = to_f32(B[b * bs.b + h * bs.h + (t0 + t) * bs.s + n]);
            }
        }
        for (int t = tid; t < chunk; t += NT) {
            CUM[t] = loga[b * ls.b + h * ls.h + (t0 + t) * ls.s];
            W[t] = dt[b * ds.b + h * ds.h + (t0 + t) * ds.s];
        }
        __syncthreads();
        if (tid < 32) chunk_cumsum(CUM, chunk, tid);
        __syncthreads();
        const float cum_last = CUM[chunk - 1];
        for (int t = tid; t < chunk; t += NT)
            W[t] = reverse ? expf(CUM[t]) : expf(cum_last - CUM[t]) * W[t];
        __syncthreads();

        const float decay = expf(cum_last);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
#pragma unroll 4
        for (int k = 0; k < chunk; ++k) {
            const float w = W[k];
            float rv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) rv[i] = R[k * 64 + ty + TY * i] * w;
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = K[k * 64 + tx + TX * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(rv[i], kv[j], acc[i][j]);
        }
        __syncthreads();   // the next chunk's staging overwrites R, K, CUM, W
    }
}

// ---------------------------------------------------------------------------
// 2. every chunk at once: dx, ddt, dloga per head; dB, dC partials per group
// ---------------------------------------------------------------------------

constexpr int LDB = N_MAX + 1;    // B (u, n): read down a column by the C B^T tiles
constexpr int LDC = N_MAX;        // C (t, n)
constexpr int LDX = P_MAX + 1;    // x (u, p): read down a column by the dy x^T tiles
constexpr int LDY = P_MAX;        // dy (t, p)
constexpr int LDM = CS_MAX + 1;   // gcb, then the group's dcb (t, u)

struct ChunkLayout {   // offsets in floats
    static constexpr int B = 0;
    static constexpr int C = B + CS_MAX * LDB;
    static constexpr int X = C + CS_MAX * LDC;
    static constexpr int Y = X + CS_MAX * LDX;
    static constexpr int M = Y + CS_MAX * LDY;
    static constexpr int CUM = M + CS_MAX * LDM;
    static constexpr int DT = CUM + CS_MAX;
    static constexpr int ROWQ = DT + CS_MAX;     // row sums of q
    static constexpr int COLQ = ROWQ + CS_MAX;   // column sums of q
    static constexpr int COLR = COLQ + CS_MAX;   // column sums of r = dW gcb
    static constexpr int HS = COLR + CS_MAX;     // h_u
    static constexpr int DDTS = HS + CS_MAX;     // ddt's state term
    static constexpr int YST = DDTS + CS_MAX;    // dcum's y-state term
    static constexpr int SCRQ = YST + CS_MAX;    // per-warp column sums of q
    static constexpr int SCRR = SCRQ + NWARPS * CS_MAX;
    static constexpr int RED = SCRR + NWARPS * CS_MAX;   // per-warp sums of dS * S_in
    static constexpr int floats = RED + NWARPS;
    static constexpr size_t bytes = sizeof(float) * floats;
};

// Tile ownership: thread (tx, ty) holds rows ty + 16 i and columns tx + 16 j
// of each tile.  In a chunk x chunk tile, (t, u) with t >= u is i > j, or
// i == j and ty >= tx; i < j is never at or below the diagonal, so those
// entries are neither computed nor kept.
__device__ __forceinline__ bool lower(int i, int j, int ty, int tx) {
    return i > j || (i == j && ty >= tx);
}

template <typename T, typename TY_>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ B, const T* __restrict__ C,
                     const float* __restrict__ dt, const float* __restrict__ loga,
                     const TY_* __restrict__ dy, const float* __restrict__ s_in,
                     const float* __restrict__ ds_out, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dloga,
                     float* __restrict__ part_b, float* __restrict__ part_c, Strides xs,
                     Strides bs, Strides cs, Strides ds, Strides ls, Strides ys, Strides dxs,
                     Strides ddts, Strides dls, int H, int seq, int chunk, int P, int N,
                     int heads_per_group) {
    using L = ChunkLayout;
    extern __shared__ __align__(16) float smem[];
    float* Bs = smem + L::B;
    float* Cs = smem + L::C;
    float* Xs = smem + L::X;
    float* Ys = smem + L::Y;
    float* M = smem + L::M;
    float* CUM = smem + L::CUM;
    float* DT = smem + L::DT;

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int warp = tid / 32, lane = tid % 32;
    const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int G = gridDim.x, n_chunks = gridDim.y;
    const int h_begin = g * heads_per_group;
    const int h_end = min(H, h_begin + heads_per_group);
    const long long t0 = static_cast<long long>(c) * chunk;

    // Everything past (chunk, P, N) stays zero, so the fixed-size tiles read
    // zeros there.
    for (int i = tid; i < L::floats; i += NT) smem[i] = 0.f;
    __syncthreads();
    // B and C of the group's first head (the same for all its heads where
    // they are shared; a group of one head otherwise)
    for (int idx = tid; idx < chunk * N; idx += NT) {
        const int t = idx / N, n = idx % N;
        Bs[t * LDB + n] = to_f32(B[b * bs.b + h_begin * bs.h + (t0 + t) * bs.s + n]);
        Cs[t * LDC + n] = to_f32(C[b * cs.b + h_begin * cs.h + (t0 + t) * cs.s + n]);
    }

    float dcb_sum[8][8];   // the group's dcb; (i, j) with i < j unused
    float dc_state[8][4];  // dC's state terms: rows t, columns n
    float db_state[4][8];  // dB's state terms, transposed: rows n, columns u
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dcb_sum[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dc_state[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) db_state[i][j] = 0.f;

    for (int h = h_begin; h < h_end; ++h) {
        __syncthreads();   // the previous head is done with x, dy, M and the vectors
        for (int idx = tid; idx < chunk * P; idx += NT) {
            const int t = idx / P, p = idx % P;
            Xs[t * LDX + p] = to_f32(x[b * xs.b + h * xs.h + (t0 + t) * xs.s + p]);
            Ys[t * LDY + p] = to_f32(dy[b * ys.b + h * ys.h + (t0 + t) * ys.s + p]);
        }
        for (int t = tid; t < chunk; t += NT) {
            CUM[t] = loga[b * ls.b + h * ls.h + (t0 + t) * ls.s];
            DT[t] = dt[b * ds.b + h * ds.h + (t0 + t) * ds.s];
        }
        __syncthreads();
        if (tid < 32) chunk_cumsum(CUM, chunk, tid);
        __syncthreads();
        const float cum_last = CUM[chunk - 1];
        const long long bhc = (static_cast<long long>(b) * H + h) * n_chunks + c;
        const float* sin_c = s_in + bhc * P * N;     // [p][n]
        const float* dso_c = ds_out + bhc * P * N;   // [n][p]

        // ---- gcb = where(t >= u, exp(cum_t - cum_u), 0) (C B^T), into M
        {
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
            for (int n = 0; n < N; ++n) {
                float cv[8], bv[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) cv[i] = Cs[(ty + TY * i) * LDC + n];
#pragma unroll
                for (int j = 0; j < 8; ++j) bv[j] = Bs[(tx + TX * j) * LDB + n];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int t = ty + TY * i;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int u = tx + TX * j;
                    float v = 0.f;
                    if (j <= i && lower(i, j, ty, tx) && t < chunk)
                        v = expf(CUM[t] - CUM[u]) * acc[i][j];
                    M[t * LDM + u] = v;
                }
            }
        }

        // ---- dW = dy x^T; q, r and their sums; the group's dcb += dW gate dt_u
        {
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
            for (int p = 0; p < P; ++p) {
                float yv[8], xv[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) yv[i] = Ys[(ty + TY * i) * LDY + p];
#pragma unroll
                for (int j = 0; j < 8; ++j) xv[j] = Xs[(tx + TX * j) * LDX + p];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(yv[i], xv[j], acc[i][j]);
            }
            float colq[8], colr[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) colq[j] = colr[j] = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int t = ty + TY * i;
                float rowq = 0.f;
#pragma unroll
                for (int j = 0; j <= i; ++j) {
                    const int u = tx + TX * j;
                    const bool on = lower(i, j, ty, tx) && t < chunk;
                    const float gate = on ? expf(CUM[t] - CUM[u]) : 0.f;
                    const float r = acc[i][j] * M[t * LDM + u];   // this thread's own gcb
                    const float q = r * DT[u];
                    dcb_sum[i][j] = fmaf(acc[i][j] * gate, DT[u], dcb_sum[i][j]);
                    rowq += q;
                    colq[j] += q;
                    colr[j] += r;
                }
                rowq = sum16(rowq);
                if (tx == 0) smem[L::ROWQ + t] = rowq;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float a = colq[j] + __shfl_xor_sync(0xffffffffu, colq[j], 16);
                const float r = colr[j] + __shfl_xor_sync(0xffffffffu, colr[j], 16);
                if (lane < 16) {
                    smem[L::SCRQ + warp * CS_MAX + tx + TX * j] = a;
                    smem[L::SCRR + warp * CS_MAX + tx + TX * j] = r;
                }
            }
        }
        __syncthreads();   // M, ROWQ and the column-sum scratch are complete
        if (tid < CS_MAX) {
            float a = 0.f, r = 0.f;
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                a += smem[L::SCRQ + w * CS_MAX + tid];
                r += smem[L::SCRR + w * CS_MAX + tid];
            }
            smem[L::COLQ + tid] = a;
            smem[L::COLR + tid] = r;
        }

        // ---- dx[u][p] = dt_u (e^{cum_L - cum_u} V[u][p] + sum_t gcb[t][u] dy[t][p]),
        // V = B dS^T; ddt's state term and h_u from x . V
        {
            float acc[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
            for (int n = 0; n < N; ++n) {
                float bv[8], sv[4];
#pragma unroll
                for (int i = 0; i < 8; ++i) bv[i] = Bs[(ty + TY * i) * LDB + n];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int p = tx + TX * j;
                    sv[j] = p < P ? __ldg(dso_c + n * P + p) : 0.f;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], sv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int u = ty + TY * i;
                float xv = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) xv = fmaf(Xs[u * LDX + tx + TX * j], acc[i][j], xv);
                xv = sum16(xv);
                const float e = u < chunk ? expf(cum_last - CUM[u]) : 0.f;
                if (tx == 0) {
                    smem[L::DDTS + u] = e * xv;
                    smem[L::HS + u] = DT[u] * (e * xv);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] *= e;
            }
#pragma unroll 4
            for (int t = 0; t < chunk; ++t) {
                float mv[8], yv[4];
#pragma unroll
                for (int i = 0; i < 8; ++i) mv[i] = M[t * LDM + ty + TY * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) yv[j] = Ys[t * LDY + tx + TX * j];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], yv[j], acc[i][j]);
            }
            T* dxb = dx + b * dxs.b + h * dxs.h + t0 * dxs.s;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int u = ty + TY * i;
                if (u >= chunk) continue;
                const float d = DT[u];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int p = tx + TX * j;
                    if (p < P) dxb[u * dxs.s + p] = from_f32<T>(acc[i][j] * d);
                }
            }
        }

        // ---- dC's state term e^{cum_t} dy_t S_in, and dcum's y-state term
        {
            float acc[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
            for (int p = 0; p < P; ++p) {
                float yv[8], sv[4];
#pragma unroll
                for (int i = 0; i < 8; ++i) yv[i] = Ys[(ty + TY * i) * LDY + p];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = tx + TX * j;
                    sv[j] = n < N ? __ldg(sin_c + p * N + n) : 0.f;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yv[i], sv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int t = ty + TY * i;
                const float e = t < chunk ? expf(CUM[t]) : 0.f;
                float s = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float v = acc[i][j] * e;
                    s = fmaf(v, Cs[t * LDC + tx + TX * j], s);
                    dc_state[i][j] += v;
                }
                s = sum16(s);
                if (tx == 0) smem[L::YST + t] = s;
            }
        }

        // ---- dB's state term e^{cum_L - cum_u} dt_u x_u dS, transposed (rows n)
        {
            float acc[4][8];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
            for (int p = 0; p < P; ++p) {
                float sv[4], xv[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int n = ty + TY * i;
                    sv[i] = n < N ? __ldg(dso_c + n * P + p) : 0.f;
                }
#pragma unroll
                for (int j = 0; j < 8; ++j) xv[j] = Xs[(tx + TX * j) * LDX + p];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int u = tx + TX * j;
                const float w = u < chunk ? expf(cum_last - CUM[u]) * DT[u] : 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i) db_state[i][j] = fmaf(acc[i][j], w, db_state[i][j]);
            }
        }

        // ---- sum(dS * S_in), per warp
        {
            float s = 0.f;
            for (int idx = tid; idx < P * N; idx += NT) {
                const int p = idx / N, n = idx % N;
                s = fmaf(__ldg(sin_c + p * N + n), __ldg(dso_c + n * P + p), s);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == 0) smem[L::RED + warp] = s;
        }
        __syncthreads();

        // ---- this head's dcum, dloga (reverse prefix sum in fp64) and ddt: warp 0
        if (warp == 0) {
            float hsum = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) hsum += smem[L::HS + lane * 4 + e];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) hsum += __shfl_xor_sync(0xffffffffu, hsum, off);
            float red = 0.f;
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) red += smem[L::RED + w];
            const float extra = hsum + expf(cum_last) * red;
            double v[4];
            double run = 0.0;
#pragma unroll
            for (int e = 3; e >= 0; --e) {
                const int t = lane * 4 + e;
                float d = 0.f;
                if (t < chunk) {
                    d = smem[L::ROWQ + t] - smem[L::COLQ + t] - smem[L::HS + t] + smem[L::YST + t];
                    if (t == chunk - 1) d += extra;
                }
                run += static_cast<double>(d);
                v[e] = run;
            }
            double incl = run;   // sum over this lane and the lanes above it
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const double o = __shfl_down_sync(0xffffffffu, incl, off);
                if (lane + off < 32) incl += o;
            }
            const double above = incl - run;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = lane * 4 + e;
                if (t < chunk) {
                    dloga[b * dls.b + h * dls.h + (t0 + t) * dls.s] = static_cast<float>(v[e] + above);
                    ddt[b * ddts.b + h * ddts.h + (t0 + t) * ddts.s] =
                        smem[L::COLR + t] + smem[L::DDTS + t];
                }
            }
        }
    }

    // ---- the group's dC = dcb B + state terms, dB^T = C^T dcb + state terms
    __syncthreads();   // every head is done with M
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            M[(ty + TY * i) * LDM + tx + TX * j] = j <= i ? dcb_sum[i][j] : 0.f;
    __syncthreads();
    const long long part_row = (static_cast<long long>(b) * G + g) * seq + t0;   // (b, g, t0)
    {
#pragma unroll 4
        for (int u = 0; u < chunk; ++u) {
            float mv[8], bv[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) mv[i] = M[(ty + TY * i) * LDM + u];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[u * LDB + tx + TX * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) dc_state[i][j] = fmaf(mv[i], bv[j], dc_state[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = ty + TY * i;
            if (t >= chunk) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = tx + TX * j;
                if (n < N) part_c[(part_row + t) * N + n] = dc_state[i][j];
            }
        }
    }
    {
#pragma unroll 4
        for (int t = 0; t < chunk; ++t) {
            float cv[4], mv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[t * LDC + ty + TY * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) mv[j] = M[t * LDM + tx + TX * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) db_state[i][j] = fmaf(cv[i], mv[j], db_state[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int u = tx + TX * j;
            if (u >= chunk) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int n = ty + TY * i;
                if (n < N) part_b[(part_row + u) * N + n] = db_state[i][j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dB, dC: the sum of the partials over each output head's groups, in order
// ---------------------------------------------------------------------------

// out[b][j][t][n] = sum_{r < R} part[b][j R + r][t][n]; blockIdx.y picks dB (0)
// or dC (1); a grid-stride loop over b * J * seq * N elements.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                      T* __restrict__ db, T* __restrict__ dc, Strides dbs, Strides dcs, int b,
                      int J, int R, int seq, int N) {
    const float* part = blockIdx.y == 0 ? part_b : part_c;
    T* out = blockIdx.y == 0 ? db : dc;
    const Strides os = blockIdx.y == 0 ? dbs : dcs;
    const long long per_head = static_cast<long long>(seq) * N;
    const long long total = static_cast<long long>(b) * J * per_head;
    for (long long e = blockIdx.x * static_cast<long long>(NT) + threadIdx.x; e < total;
         e += static_cast<long long>(gridDim.x) * NT) {
        const long long bj = e / per_head, rest = e % per_head;
        const long long ib = bj / J, j = bj % J;
        const long long t = rest / N, n = rest % N;
        const float* src = part + ((ib * J + j) * R) * per_head + rest;
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += src[r * per_head];
        out[ib * os.b + j * os.h + t * os.s + n] = from_f32<T>(s);
    }
}

// ---------------------------------------------------------------------------
// Host side: the launch plan, launches
// ---------------------------------------------------------------------------

// The launch plan (kernels/ssd_chunk.py, `SSDBwdPlan.as_array`), 9 int64:
//   [0] route (0 = CUDA cores, the only one), [1] heads per group, [2] groups,
//   [3] threads, [4] the states kernel's dynamic shared memory bytes, [5] the
//   chunk kernel's, [6] reduce blocks, [7] partials per output head R
//   (groups where B and C are shared, else 1), [8] output heads J (1 shared,
//   else H).

template <typename T, typename TY_>
int launch_bwd(const void* x, const void* B, const void* C, const float* dt, const float* loga,
               const void* dy, const float* ds_final, void* dx, float* ddt, float* dloga,
               void* db, void* dc, float* s_in, float* ds_out, float* part_b, float* part_c,
               const Strides* st, int b, int H, int seq, int P, int N, int chunk,
               const long long* plan, cudaStream_t stream) {
    const long long hpg = plan[1], G = plan[2], R = plan[7], J = plan[8];
    const int n_chunks = seq / chunk;
    if (plan[0] != 0 || hpg < 1 || G < 1 || G > 65535 || (G - 1) * hpg >= H || G * hpg < H ||
        plan[3] != NT || plan[4] != static_cast<long long>(StatesLayout::bytes) ||
        plan[5] != static_cast<long long>(ChunkLayout::bytes) || plan[6] < 1 ||
        plan[6] > 65535 || n_chunks > 65535)
        return cudaErrorInvalidValue;
    // one output head (B/C shared, or H = 1): the groups' partials are summed,
    // and a group of several heads reads one B/C, so their head stride is 0;
    // else a group is one head and its partial is that head's gradient
    if (J == 1 ? (R != G || (hpg > 1 && (st[1].h != 0 || st[2].h != 0)))
               : (J != H || R != 1 || hpg != 1))
        return cudaErrorInvalidValue;
    const auto* xp = static_cast<const T*>(x);
    const auto* bp = static_cast<const T*>(B);
    const auto* cp = static_cast<const T*>(C);
    const auto* yp = static_cast<const TY_*>(dy);

    auto states = ssd_bwd_states_kernel<T, TY_>;
    cudaError_t err = cudaFuncSetAttribute(states, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(StatesLayout::bytes));
    if (err != cudaSuccess) return err;
    states<<<dim3(H, b, 2), NT, StatesLayout::bytes, stream>>>(
        xp, bp, cp, dt, loga, yp, ds_final, s_in, ds_out, st[0], st[1], st[2], st[3], st[4],
        st[5], seq, chunk, P, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto chunks = ssd_bwd_chunk_kernel<T, TY_>;
    err = cudaFuncSetAttribute(chunks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ChunkLayout::bytes));
    if (err != cudaSuccess) return err;
    chunks<<<dim3(static_cast<unsigned>(G), n_chunks, b), NT, ChunkLayout::bytes, stream>>>(
        xp, bp, cp, dt, loga, yp, s_in, ds_out, static_cast<T*>(dx), ddt, dloga, part_b, part_c,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], H, seq, chunk, P, N,
        static_cast<int>(hpg));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    ssd_bwd_reduce_kernel<T><<<dim3(static_cast<unsigned>(plan[6]), 2), NT, 0, stream>>>(
        part_b, part_c, static_cast<T*>(db), static_cast<T*>(dc), st[9], st[10], b,
        static_cast<int>(J), static_cast<int>(R), seq, N);
    return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; `in_dtype` is that of x, B, C, and
// so of dx, dB and dC; `dy_dtype` that of dy (dt, loga, ddt, dloga and the
// workspaces are float32).  `strides` holds the (batch, head, seq) element
// strides of x, B, C, dt, loga, dy, dx, ddt, dloga, dB and dC in that order
// (33 values; B's and C's head stride is 0 where they are shared, and dB's
// and dC's where they are (b, s, N)).  `ds_final` may be null (a zero
// gradient of S_final).  `plan`: see the launch plan above.  Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan_bwd(const void* x, const void* B, const void* C, const float* dt,
                                  const float* loga, const void* dy, const float* ds_final,
                                  void* dx, float* ddt, float* dloga, void* db, void* dc,
                                  float* s_in, float* ds_out, float* part_b, float* part_c,
                                  int in_dtype, int dy_dtype, int b, int H, int seq, int P, int N,
                                  int chunk, const long long* strides, const long long* plan,
                                  void* stream) {
    if (b <= 0 || H <= 0 || b > 65535 || H > 65535 || chunk <= 0 || chunk > CS_MAX || seq <= 0 ||
        seq % chunk != 0 || P <= 0 || P > P_MAX || N <= 0 || N > N_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    Strides st[11];
    for (int i = 0; i < 11; ++i)
        st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_dtype == 0 && dy_dtype == 0)
        return launch_bwd<float, float>(x, B, C, dt, loga, dy, ds_final, dx, ddt, dloga, db, dc,
                                        s_in, ds_out, part_b, part_c, st, b, H, seq, P, N, chunk,
                                        plan, s);
    if (in_dtype == 0 && dy_dtype == 1)
        return launch_bwd<float, __nv_bfloat16>(x, B, C, dt, loga, dy, ds_final, dx, ddt, dloga,
                                                db, dc, s_in, ds_out, part_b, part_c, st, b, H,
                                                seq, P, N, chunk, plan, s);
    if (in_dtype == 1 && dy_dtype == 0)
        return launch_bwd<__nv_bfloat16, float>(x, B, C, dt, loga, dy, ds_final, dx, ddt, dloga,
                                                db, dc, s_in, ds_out, part_b, part_c, st, b, H,
                                                seq, P, N, chunk, plan, s);
    if (in_dtype == 1 && dy_dtype == 1)
        return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, B, C, dt, loga, dy, ds_final, dx,
                                                        ddt, dloga, db, dc, s_in, ds_out, part_b,
                                                        part_c, st, b, H, seq, P, N, chunk, plan,
                                                        s);
    return static_cast<int>(cudaErrorInvalidValue);
}
