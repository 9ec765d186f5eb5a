// Causal, optionally sliding-window, GQA flash-attention forward for
// Hopper (sm_90a): the attention of prefill, once per layer.
//
// Replaces the TPU kernel swa_prefill_pallas in
// src/repro/kernels/swa/prefill.py. For request b, query head h (KV head
// h / G) and query position s, over the keys t with s - window < t <= s
// (every t <= s when window = 0):
//
//     out[b, s, h] = sum_t softmax_t(scale * <q[b, s, h], k[b, t, h / G]>)
//                    * v[b, t, h / G]
//
// with the TPU kernel's numerics: float32 scores, masked scores set to
// -1e30 (not -inf), the running max starting at -1e30, and the sum divided
// by max(l, 1e-30).
//
// Design. The TPU kernel runs a (B * H, S / bq, S / bk) grid with the
// online-softmax triple carried in VMEM across the sequential KV axis, and
// skips KV blocks outside the band with pl.when; it needs S to be a
// multiple of its tiles. Here one block of 256 threads owns a tile of 64
// query rows of one (request, query head) and loops, inside the block,
// over only the 64-row KV tiles that meet the causal/window band of its
// rows. The scaled Q tile (transposed) stays in shared memory; each KV
// tile is staged there as float32 (K transposed, V row-major). A thread
// computes a 4 x 4 block of the 64 x 64 score tile with float32 FMAs, the
// row max and row sum run over the 16 threads of a row group by warp
// shuffles, so each thread keeps m and l of its 4 rows in registers with
// its 4 x dh/16 block of the output accumulator. P goes back through
// shared memory (over the K tile) for the P.V product. Any S is taken: the
// ragged last tiles are zero-filled and masked. q, k and v are read
// through their (b, s, head) strides in the (B, S, heads, dh) layout that
// the model's projection produces, so prefill makes no transposed copy,
// and the output is written contiguous in that layout. Query tiles are
// issued last-first, so the longest bands start first.
//
// Bound: operations. The band holds S (S + 1) / 2 (query, key) pairs per
// (request, head) for window = 0, each 2 dh FLOPs for the score and 2 dh
// for P.V: at B = 8, H = 32, S = 2,048, dh = 128 that is 275 GFLOP a
// layer, 0.28 ms at the H100's 989 TFLOP/s bf16 tensor-core peak. This
// first version runs on the float32 FMA pipes (67 TFLOP/s peak), not the
// tensor cores; mma/wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr int BQP = BQ + 4, BKP = BK + 4;   // padded rows of transposed tiles
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// rows [r0, r0 + 64) of one head into dst[d * ld + r] (transposed), times
// `mul`; rows at or past S are zero. 4 consecutive d per thread, rows
// fastest across the threads (conflict-free shared stores).
template <typename T, int DH>
__device__ __forceinline__ void load_transposed(
        float* dst, int ld, const T* src, long long ss, int r0, int S,
        float mul) {
    const int r = threadIdx.x % 64;
#pragma unroll
    for (int d0 = (threadIdx.x / 64) * 4; d0 < DH; d0 += (NT / 64) * 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < S) x = load4<T>(src + (r0 + r) * ss + d0);
        dst[(d0 + 0) * ld + r] = x.x * mul;
        dst[(d0 + 1) * ld + r] = x.y * mul;
        dst[(d0 + 2) * ld + r] = x.z * mul;
        dst[(d0 + 3) * ld + r] = x.w * mul;
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) swa_prefill_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ out,
        long long qsb, long long qss, long long qsh,
        long long ksb, long long kss, long long ksh,
        long long vsb, long long vss, long long vsh,
        int S, int H, int Hkv, int window, float scale) {
    constexpr int NC = DH / 64;                  // float4 column groups
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);  // [DH][BQP], scaled
    float* Kt = Qt + DH * BQP;                    // [DH][BKP]; P^T [BK][BQP]
    float* Vs = Kt + DH * BKP;                    // [BK][DH]
    float* Pt = Kt;

    const int n_qt = gridDim.x;
    const int qt = n_qt - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

    const T* qp = q + b * qsb + h * qsh;
    const T* kp = k + b * ksb + kvh * ksh;
    const T* vp = v + b * vsb + kvh * vsh;
    load_transposed<T, DH>(Qt, BQP, qp, qss, q0, S, scale);

    float m[4], l[4], acc[4][4 * NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNeg;
        l[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.0f;
    }

    const int q_hi = min(q0 + BQ, S) - 1;
    const int kt_first = window ? max(0, q0 - window + 1) / BK : 0;
    const int kt_last = q_hi / BK;
    for (int kt = kt_first; kt <= kt_last; ++kt) {
        const int k0 = kt * BK;
        load_transposed<T, DH>(Kt, BKP, kp, kss, k0, S, 1.0f);
        for (int i = threadIdx.x; i < BK * DH / 4; i += NT) {
            const int c = i / (DH / 4), d0 = (i % (DH / 4)) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (k0 + c < S) x = load4<T>(vp + (k0 + c) * vss + d0);
            *reinterpret_cast<float4*>(Vs + c * DH + d0) = x;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
            const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQP + ty * 4);
            const float4 c = *reinterpret_cast<const float4*>(Kt + d * BKP + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(at(a, i), at(c, j), s[i][j]);
        }

        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty * 4 + i;
            float mx = kNeg;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx * 4 + j;
                const bool ok = kpos <= qpos && kpos < S
                                && (window == 0 || kpos > qpos - window);
                s[i][j] = ok ? s[i][j] : kNeg;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
            const float m_new = fmaxf(m[i], mx);
            alpha[i] = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                rs += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(kFull, rs, off);
            l[i] = l[i] * alpha[i] + rs;
            m[i] = m_new;
        }
        __syncthreads();                      // every thread is done with Kt
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * BQP + ty * 4) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncthreads();

#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float4 p = *reinterpret_cast<const float4*>(Pt + c * BQP + ty * 4);
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float4 w = *reinterpret_cast<const float4*>(
                    Vs + c * DH + n * 64 + tx * 4);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][n * 4 + j] = fmaf(at(p, i), at(w, j),
                                                 acc[i][n * 4 + j]);
            }
        }
        __syncthreads();                      // before the next tile's loads
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        if (qpos >= S) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
        T* o = out + ((static_cast<long long>(b) * S + qpos) * H + h) * DH;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                store(o + n * 64 + tx * 4 + j, acc[i][n * 4 + j] * inv);
    }
}

struct Args {
    const void *q, *k, *v;
    void* out;
    long long qs[3], ks[3], vs[3];
    int B, S, H, Hkv, window;
    float scale;
    cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch(const Args& a) {
    constexpr int smem = (DH * BQP + DH * BKP + BK * DH) * sizeof(float);
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            swa_prefill_kernel<T, DH>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
    swa_prefill_kernel<T, DH><<<grid, NT, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2],
        a.vs[0], a.vs[1], a.vs[2], a.S, a.H, a.Hkv, a.window, a.scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int dh, const Args& a) {
    switch (dh) {
        case 64: return launch<T, 64>(a);
        case 128: return launch<T, 128>(a);
        case 256: return launch<T, 256>(a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and out alike). Strides are in
// elements for the (b, s, head) axes; the dh axis is contiguous. The
// wrapper checks shapes, strides and alignment. Launches on the caller's
// stream and returns cudaGetLastError().
extern "C" int swa_prefill(int dtype, const void* q, const void* k,
                           const void* v, void* out, long long qsb,
                           long long qss, long long qsh, long long ksb,
                           long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, int B, int S, int H,
                           int Hkv, int dh, int window, float scale,
                           int device, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Args a{q, k, v, out, {qsb, qss, qsh}, {ksb, kss, ksh},
                 {vsb, vss, vsh}, B, S, H, Hkv, window, scale, stream};
    if (dtype == 0) return static_cast<int>(by_head_dim<float>(dh, a));
    if (dtype == 1) return static_cast<int>(by_head_dim<__nv_bfloat16>(dh, a));
    return static_cast<int>(cudaErrorInvalidValue);
}
