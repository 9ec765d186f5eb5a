// Chunked RWKV6 WKV with data-dependent decay for Hopper (sm_90a): the
// recurrent mixer of RWKV6 prefill, once per layer.
//
// Replaces the TPU kernel wkv6_chunked_pallas in
// src/repro/kernels/wkv6/wkv6.py. For each of the BH = B * H sequences,
// from a zero state S (K x V, float32), over chunks of C = 64 tokens with
// P the inclusive and E = P - lw the exclusive cumsum of the log-decay
// lw <= 0 inside the chunk:
//
//     y_i   = (r_i . exp(E_i)) @ S                            inter-chunk
//           + sum_{j<i} [sum_k r_ik k_jk exp(E_ik - P_jk)] v_j intra-chunk
//           + (r_i . u . k_i) v_i                             bonus
//     S_end = diag(exp(P_last)) S + sum_j (k_j . exp(P_last - P_j))^T v_j
//
// Every exponent is <= 0 (up to one rounding of E): the pairwise decay
// exp(E_i - P_j) is formed jointly for each (i, j, k) and never factored
// into exp(E_i) * exp(-P_j), which overflows (lw reaches -e^4, so P falls
// to about -3,500 over a chunk; inf * 0 = NaN). The library is built
// without fast-math, so expf is the accurate one.
//
// Design. The TPU kernel runs a (BH, T / C) grid in order and carries S
// in VMEM from one chunk to the next. CUDA blocks run concurrently, so
// here one block of 256 threads owns one sequence and walks its chunks
// in order, with S in shared memory. Per chunk, r, k and lw are staged
// transposed ([K][C], float32) and v row-major; P and E come from a warp
// shuffle scan per key channel. A thread owns a 4 x 4 tile of the
// chunk's (C, V) output and of S. The pairwise term, C (C - 1) / 2 * K
// = 129,024 exponentials a chunk, is spread evenly: warp w takes the 4-row
// blocks w and 15 - w of the lower triangle (17 tiles of 4 x 4 pairs), and
// each lane a contiguous run of 34 of the warp's 17 x 64 (tile, k) steps,
// adding its partial tile into the score matrix with shared atomics. Any
// T is taken: the rows of a ragged last chunk are zero (lw = 0 there, so
// P_last is the last real row's). r, k, v, lw, u and y are addressed
// through (b, h, t) strides, so the model hands over views of its
// (B, S, H, hd) projections and gets y in that layout without a copy.
//
// Bound: bytes. At the serve shape (B = 8, H = 32, T = 2,048,
// K = V = 64) r, k, v and y in bf16, lw in float32 and the final state
// move about 406 MB, 0.121 ms at 3.35 TB/s; the ~20 GFLOP take 0.02 ms at
// the bf16 tensor-core peak. This first version is bound by neither: it
// runs on the FMA pipes and the SFU (about 1.1 G accurate expf a launch,
// ~0.26 ms at 16 a clock per SM at best), and its 256 blocks give the 132
// SMs two each. The known way to fill the card is three passes: each
// (sequence, chunk) computes its local state contribution in parallel, a
// short scan over the chunk states, then each (sequence, chunk) computes
// its outputs from its start state in parallel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int C = 64, KD = 64, NT = 256, CK = C * KD;
constexpr unsigned kFull = 0xffffffffu;
// shared memory: rT, kT, ET, PT, sc, S ([64][64] each), vs ([C][V]),
// bonus (C), u (K)
constexpr int kSmemFloats = 7 * CK + C + KD;

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
    uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

__device__ __forceinline__ float at(const float4& f, int i) {
    return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// rows [t0, t0 + nt) of one sequence into dst[d * 64 + i] (transposed);
// rows at or past nt are zero. Rows run fastest across the threads, so
// the shared stores are conflict-free.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long st, int nt) {
    const int i = threadIdx.x % C;
#pragma unroll
    for (int d0 = (threadIdx.x / C) * 4; d0 < KD; d0 += (NT / C) * 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nt) x = load4<T>(src + i * st + d0);
        dst[(d0 + 0) * C + i] = x.x;
        dst[(d0 + 1) * C + i] = x.y;
        dst[(d0 + 2) * C + i] = x.z;
        dst[(d0 + 3) * C + i] = x.w;
    }
}

struct Strides {
    long long b, h, t;
};

template <typename T>
__global__ void __launch_bounds__(NT, 2) wkv6_kernel(
        const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ lw,
        const float* __restrict__ u, T* __restrict__ y,
        float* __restrict__ s_out, Strides rs, Strides ks, Strides vs_,
        Strides ls, Strides ys, long long usb, long long ush, int H,
        int Tlen) {
    extern __shared__ float4 smem4[];
    float* rT = reinterpret_cast<float*>(smem4);   // [K][C]
    float* kT = rT + CK;     // [K][C]; k_dec after the scores
    float* ET = kT + CK;     // [K][C]; lw, then E
    float* PT = ET + CK;     // [K][C]
    float* sc = PT + CK;     // [K][C] q_dec, then scores^T [j][i]
    float* S = sc + CK;      // [K][V] carried state
    float* vsm = S + CK;     // [C][V]
    float* bon = vsm + CK;   // [C]
    float* us = bon + C;     // [K]

    const int seq = blockIdx.x;
    const int b = seq / H, h = seq % H;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int ty = tid / 16, tx = tid % 16;

    const T* rp = r + b * rs.b + h * rs.h;
    const T* kp = k + b * ks.b + h * ks.h;
    const T* vp = v + b * vs_.b + h * vs_.h;
    const float* lp = lw + b * ls.b + h * ls.h;
    T* yp = y + b * ys.b + h * ys.h;

    for (int i = tid; i < CK; i += NT) S[i] = 0.0f;
    if (tid < KD) us[tid] = u[b * usb + h * ush + tid];

    for (int t0 = 0; t0 < Tlen; t0 += C) {
        const int nt = min(C, Tlen - t0);

        // ---- stage the chunk -------------------------------------------
        load_transposed<T>(rT, rp + t0 * rs.t, rs.t, nt);
        load_transposed<T>(kT, kp + t0 * ks.t, ks.t, nt);
        load_transposed<float>(ET, lp + t0 * ls.t, ls.t, nt);
        for (int idx = tid; idx < C * KD / 4; idx += NT) {
            const int j = idx / (KD / 4), c4 = (idx % (KD / 4)) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (j < nt) x = load4<T>(vp + (t0 + j) * vs_.t + c4);
            *reinterpret_cast<float4*>(vsm + j * KD + c4) = x;
        }
        __syncthreads();

        // ---- bonus diagonal, and P, E by a warp scan per key channel ----
        if (tid < C) {
            float acc = 0.0f;
            for (int kk = 0; kk < KD; ++kk)
                acc = fmaf(rT[kk * C + tid] * us[kk], kT[kk * C + tid], acc);
            bon[tid] = acc;
        }
        for (int kk = warp; kk < KD; kk += NT / 32) {
            const float a0 = ET[kk * C + lane], a1 = ET[kk * C + 32 + lane];
            float p0 = a0, p1 = a1;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float n0 = __shfl_up_sync(kFull, p0, off);
                const float n1 = __shfl_up_sync(kFull, p1, off);
                if (lane >= off) {
                    p0 += n0;
                    p1 += n1;
                }
            }
            p1 += __shfl_sync(kFull, p0, 31);
            PT[kk * C + lane] = p0;
            PT[kk * C + 32 + lane] = p1;
            ET[kk * C + lane] = p0 - a0;
            ET[kk * C + 32 + lane] = p1 - a1;
        }
        __syncthreads();

        // ---- inter-chunk: y = (r . exp(E)) @ S ---------------------------
        for (int i = tid; i < CK; i += NT) sc[i] = rT[i] * expf(ET[i]);
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
#pragma unroll 8
        for (int kk = 0; kk < KD; ++kk) {
            const float4 q = *reinterpret_cast<const float4*>(sc + kk * C + ty * 4);
            const float4 s = *reinterpret_cast<const float4*>(S + kk * KD + tx * 4);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[a][c] = fmaf(at(q, a), at(s, c), acc[a][c]);
        }
        __syncthreads();
        for (int i = tid; i < CK; i += NT) sc[i] = 0.0f;
        __syncthreads();

        // ---- intra-chunk scores, strictly causal, into sc[j][i] ---------
        // warp w: 4-row blocks w (tiles bj = 0..w) and 15 - w (bj =
        // 0..15 - w), 17 tiles; lane: the (tile, k) steps [34 l, 34 l + 34)
        {
            int f = lane * 34;
            const int fend = f + 34;
            while (f < fend) {
                const int t = f / KD, k0 = f % KD;
                const int k1 = min(KD, k0 + (fend - f));
                f += k1 - k0;
                const int bi = t <= warp ? warp : 15 - warp;
                const int bj = t <= warp ? t : t - warp - 1;
                const int i0 = bi * 4, j0 = bj * 4;
                if (i0 >= nt || j0 >= nt) continue;
                const bool diag = bi == bj;
                float s[4][4];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
                for (int kk = k0; kk < k1; ++kk) {
                    const float4 rr = *reinterpret_cast<const float4*>(rT + kk * C + i0);
                    const float4 ee = *reinterpret_cast<const float4*>(ET + kk * C + i0);
                    const float4 kq = *reinterpret_cast<const float4*>(kT + kk * C + j0);
                    const float4 pp = *reinterpret_cast<const float4*>(PT + kk * C + j0);
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            if (!diag || c < a)
                                s[a][c] = fmaf(at(rr, a) * at(kq, c),
                                               expf(at(ee, a) - at(pp, c)),
                                               s[a][c]);
                }
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        if (!diag || c < a)
                            atomicAdd(sc + (j0 + c) * C + i0 + a, s[a][c]);
            }
        }
        __syncthreads();

        // ---- y += scores @ v + bonus; write y ---------------------------
        const int jmax = ty * 4 + 3;           // scores[i][j] = 0 for j >= i
        for (int j = 0; j < jmax; ++j) {
            const float4 p = *reinterpret_cast<const float4*>(sc + j * C + ty * 4);
            const float4 w = *reinterpret_cast<const float4*>(vsm + j * KD + tx * 4);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[a][c] = fmaf(at(p, a), at(w, c), acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int i = ty * 4 + a;
            if (i >= nt) continue;
            const float4 w = *reinterpret_cast<const float4*>(vsm + i * KD + tx * 4);
            T* o = yp + (t0 + i) * ys.t + tx * 4;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                store(o + c, fmaf(bon[i], at(w, c), acc[a][c]));
        }
        // k_dec[k][j] = k[j, k] exp(P_last[k] - P[j, k]), in place of kT
        for (int i = tid; i < CK; i += NT) {
            const int kk = i / C;
            kT[i] *= expf(PT[kk * C + C - 1] - PT[i]);
        }
        __syncthreads();

        // ---- state: S = diag(exp(P_last)) S + k_dec^T v -----------------
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int kk = ty * 4 + a;
            const float dec = expf(PT[kk * C + C - 1]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = dec * S[kk * KD + tx * 4 + c];
        }
        for (int j = 0; j < nt; ++j) {
            const float4 w = *reinterpret_cast<const float4*>(vsm + j * KD + tx * 4);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float kd = kT[(ty * 4 + a) * C + j];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[a][c] = fmaf(kd, at(w, c), acc[a][c]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                S[(ty * 4 + a) * KD + tx * 4 + c] = acc[a][c];
        __syncthreads();                       // before the next chunk's loads
    }

    float* so = s_out + static_cast<long long>(seq) * CK;
    for (int i = tid; i < CK; i += NT) so[i] = S[i];
}

struct Args {
    const void *r, *k, *v, *lw, *u;
    void *y, *s;
    Strides rs, ks, vs, ls, ys;
    long long usb, ush;
    int B, H, T;
    cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
    constexpr int smem = kSmemFloats * sizeof(float);
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(
            wkv6_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
            100);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    wkv6_kernel<T><<<a.B * a.H, NT, smem, a.stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.lw),
        static_cast<const float*>(a.u), static_cast<T*>(a.y),
        static_cast<float*>(a.s), a.rs, a.ks, a.vs, a.ls, a.ys, a.usb,
        a.ush, a.H, a.T);
    return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (r, k, v and y alike; lw and u float32,
// the state float32 and contiguous (B * H, 64, 64)). For each of r, k, v,
// lw and y, three element strides: over b, over h and over t; the last
// (channel) axis is contiguous; u has strides over b and h. K = V = 64.
// The wrapper checks shapes, strides and alignment. Launches on the
// caller's stream and returns cudaGetLastError().
extern "C" int wkv6(int dtype, const void* r, const void* k, const void* v,
                    const void* lw, const void* u, void* y, void* s,
                    const long long* strides, long long usb, long long ush,
                    int B, int H, int T, int device, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long* q = strides;
    const Args a{r, k, v, lw, u, y, s,
                 {q[0], q[1], q[2]}, {q[3], q[4], q[5]}, {q[6], q[7], q[8]},
                 {q[9], q[10], q[11]}, {q[12], q[13], q[14]},
                 usb, ush, B, H, T, stream};
    if (dtype == 0) return static_cast<int>(launch<float>(a));
    if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(a));
    return static_cast<int>(cudaErrorInvalidValue);
}
