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
// What differs from the TPU kernel's shape.  There the grid's third axis walks
// the chunks in order and carries S in VMEM scratch.  Here one block owns one
// (batch, head) and loops over the chunks itself, S staying in shared memory
// from the first chunk to the last.  Per chunk the block stages x, B and C in
// fp32 shared memory, scans loga (one warp, shuffles), forms the masked
// chunk x chunk weight W in shared memory, and then computes y and the new S.
// All products are fp32 FMAs on the CUDA cores from shared memory, each thread
// owning a register micro-tile (8x8 of W, 8x4 of y, 4x4 of S; 256 threads as
// 16 x 16).  Row strides of B, C, W and S are padded by one float, so the 16
// rows a half-warp reads at one column fall in 16 banks.
//
// Precision.  The gate exp(cum_t - cum_u) takes the difference of two prefix
// sums that reach |cum| ~ 100 within a chunk (ulp 7.6e-6), so two fp32 sums of
// loga in different orders move y by up to ~1e-5 of its size, more than the
// 1e-4 tolerance leaves at large |y|.  The prefix sum is therefore taken in
// fp64 and rounded once to fp32, here and in the plain version
// (kernels/ref.py), which makes cum the same number in both; the products
// stay fp32.
//
// Limits: chunk <= 128, P <= 64, N <= 64 (zamba2-2.7b: 128, 64, 64); the
// shared-memory layout is sized for these maxima (184 KB, above the default
// 48 KB, so the launcher opts in).
//
// What bounds it on this card.  At zamba2-2.7b's prefill shape
// (b, H, s, P, N) = (1, 80, 32768, 64, 64), bf16 x, fp32 y, chunk 128:
//   operations: 2 cs (cs (N + P) + 2 P N) = 6.3 MFLOP per chunk per (b, h),
//               129 GFLOP per layer; 0.13 ms at the bf16 tensor-core peak;
//   bytes:      x 335 MB + y (fp32) 671 MB + dt/loga 21 MB + B/C (shared by
//               all heads) 8 MB, about 1.04 GB; 0.31 ms at 3.35 TB/s.
// So the design target is bytes.  As written, this simple kernel is bound by
// operations on the CUDA cores (fp32 FMA, 67 TFLOP/s peak, about 2 ms per
// layer at best) and by occupancy: one block per (b, h) is 80 blocks for 132
// SMs, one block per SM (184 KB of shared memory).  The way to the byte bound
// is later work: tensor cores (mma.sync/wgmma) for the three products, TMA
// staging, and a two-pass split (chunk states in parallel, then a short scan
// over chunks, then chunk outputs) that fills the card with b * H * n_chunks
// blocks.
//
// Layout: logical (b, H, s, .) for x, B, C and y, (b, H, s) for dt and loga,
// with the strides of b, H and s passed in (elements) and the last axis of
// x, B, C and y contiguous.  So the model's (b, s, H, P) x and y go in as
// transposed views, and its (b, s, N) B and C, shared by all heads, as
// expanded views with head stride 0, never materialised.  S_final is a
// contiguous (b, H, P, N) fp32 tensor.
//
// Plain C interface; the kernel launches on the given stream, does not
// synchronise and allocates nothing.

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

template <typename T, typename O>
cudaError_t launch(const void* x, const void* B, const void* C, const float* dt,
                   const float* loga, void* y, float* s_final, const Strides* st, int b, int H,
                   int seq, int P, int N, int chunk, cudaStream_t stream) {
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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; `in_dtype` is that of x, B and C
// (dt and loga are float32), `out_dtype` that of y.  `strides` holds the
// (batch, head, seq) element strides of x, B, C, dt, loga and y in that order
// (18 values); the last axis of x, B, C and y is contiguous.  Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan_fwd(const void* x, const void* B, const void* C, const float* dt,
                                  const float* loga, void* y, float* s_final, int in_dtype,
                                  int out_dtype, int b, int H, int seq, int P, int N, int chunk,
                                  const long long* strides, void* stream) {
    if (b <= 0 || H <= 0 || b > 65535 || chunk <= 0 || chunk > CS_MAX || seq <= 0 ||
        seq % chunk != 0 || P <= 0 || P > P_MAX || N <= 0 || N > N_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Strides st[6];
    for (int i = 0; i < 6; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (in_dtype == 0 && out_dtype == 0) {
        err = launch<float, float>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, s);
    } else if (in_dtype == 0 && out_dtype == 1) {
        err = launch<float, __nv_bfloat16>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, s);
    } else if (in_dtype == 1 && out_dtype == 0) {
        err = launch<__nv_bfloat16, float>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, s);
    } else if (in_dtype == 1 && out_dtype == 1) {
        err = launch<__nv_bfloat16, __nv_bfloat16>(x, B, C, dt, loga, y, s_final, st, b, H, seq, P, N, chunk, s);
    }
    return static_cast<int>(err);
}
