// Causal, optionally sliding-window, GQA flash-attention forward for
// Hopper (sm_90a): the attention of prefill, and of the training forward,
// once per layer.
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
// Two kernels, chosen by the wrapper (kernels/swa/ops.py) by dtype and
// head size:
//
// * swa_prefill_tc (bf16 q, k, v at head sizes 64 and 128: every launch
//   of the serve and training paths) runs both products on the tensor
//   cores with wgmma, fed by TMA.
// * swa_prefill (float32 at any of 64/128/256, and bf16 at 256) runs on
//   the float32 FMA pipes. float32 inputs feed the precision checks only
//   (tensor cores would need a 3 x TF32 split to keep float32 accuracy);
//   bf16 at 256 would need 128 accumulator registers for O alone beside
//   the scores and P, past what a thread can hold without spilling.
//
// Bound: operations. The band holds S (S + 1) / 2 (query, key) pairs per
// (request, head) for window = 0, each 2 dh FLOPs for the score and 2 dh
// for P.V: at B = 8, H = 32, S = 2,048, dh = 128 that is 275.0 GFLOP a
// layer, 0.278 ms at the H100's 989 TFLOP/s bf16 tensor-core peak.
//
// Why P.V costs two products. The output is checked against the float32
// plain version on the same bf16 inputs within rtol 2^-8 + atol 1e-5, and
// the bf16 rounding of the output alone may use up to 2^-8 relative. A
// flash kernel in the usual style rounds P to bf16 before P.V; emulated in
// float32 on the CPU (tests/test_torch_swa.py), that misses the limit by
// about two orders of magnitude. So P stays float32-exact: it is split
// into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi.V + P_lo.V
// (bf16 x bf16 products are exact in the float32 accumulator, and P_hi +
// P_lo carries 16 bits of P's mantissa). The emulation of the split
// reaches 0.98-0.99 of the limit, as a float32 P does. This costs 1.5x the
// tensor-core work of a one-product design: 412 GFLOP at the serve shape,
// a floor of 0.42 ms at peak.
//
// Design of swa_prefill_tc. The TPU kernel runs a (B * H, S / bq, S / bk)
// grid with the online-softmax triple carried in VMEM across the
// sequential KV axis. Here a block of 288 threads owns a 128-row query
// tile of one (request, query head): two consumer warpgroups of 64 rows
// each, and one producer warp. The producer's first lane loads the Q tile
// once and then streams the K and V tiles of the band (128 keys at head
// size 64, 64 at 128, where 128-key tiles spilled registers) through a
// 2-stage ring in shared memory with TMA (one tensor map per operand over
// the strided (B, S, heads, dh) views the projection produces, so no
// transposed or contiguous copy is made; TMA zero-fills rows past S);
// mbarriers carry "full" (TMA bytes landed) and "empty" (both warpgroups
// done) for each stage. Tiles are stored in 64-column panels of 128-byte
// rows in TMA's 128-byte swizzle, which the wgmma descriptors name as
// their layout (the pairing to check first when results are wrong but not
// NaN). Per KV tile a consumer warpgroup computes S = Q.K^T with
// m64n{128,64}k16 wgmma (Q and K both K-major in shared memory) into float32
// registers, multiplies by scale in float32 after the product (dh^-0.5 is
// not a power of two at dh 128, so scaling bf16 Q first would round), masks
// only on tiles that cross the diagonal, the window edge or S, and runs
// the online softmax on the accumulator fragments: a row lies across the 4
// threads of a quad, so its max takes 2 shuffles, and the row sum stays a
// per-thread partial until the end. O is rescaled by exp(m_old - m_new);
// P_hi and P_lo are packed straight from the score fragments into wgmma's
// register-A layout, and O += P_hi.V + P_lo.V runs as m64n{dh}k16 wgmma
// with V read MN-major through the descriptor's transpose bit. The two
// warpgroups overlap one's softmax with the other's products. KV tiles
// outside the band are never loaded (kt_first / kt_last), a warpgroup
// skips a tile that is masked for all its rows, and query tiles are issued
// last-first, so the longest bands start first. The output, O / max(l,
// 1e-30) in bf16, goes through shared memory to 16-byte stores into the
// contiguous (B, S, H, dh) output. Shared memory at dh 128: Q 32 KB + (K
// 16 KB + V 16 KB) x 2 stages + 34 KB of output staging. A barrier phase
// that never completes traps rather than hanging the card.
//
// Design of swa_prefill (FMA). One block of 256 threads owns a tile of 64
// query rows of one (request, query head) and loops over only the 64-row
// KV tiles that meet the band of its rows. The scaled Q tile (transposed)
// stays in shared memory; each KV tile is staged there as float32 (K
// transposed, V row-major). A thread computes a 4 x 4 block of the 64 x 64
// score tile with float32 FMAs, the row max and row sum run over the 16
// threads of a row group by warp shuffles, so each thread keeps m and l of
// its 4 rows in registers with its 4 x dh/16 block of the output
// accumulator. P goes back through shared memory (over the K tile) for the
// P.V product. Any S is taken: the ragged last tiles are zero-filled and
// masked. q, k and v are read through their (b, s, head) strides, and the
// output is written contiguous. Query tiles are issued last-first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dtype 0: float32 at head sizes 64, 128 and 256; 1: bfloat16 at 256
// (q, k, v and out alike; bf16 at 64 and 128 goes to swa_prefill_tc
// below). Strides are in elements for the (b, s, head) axes; the dh axis
// is contiguous. The wrapper checks shapes, strides and alignment.
// Launches on the caller's stream and returns cudaGetLastError().
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
    if (dtype == 1 && dh == 256)
        return static_cast<int>(launch<__nv_bfloat16, 256>(a));
    return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// swa_prefill_tc: bf16, head sizes 64 and 128, wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;           // query rows a block: two warpgroups of 64
// keys a KV tile: 128 at head size 64; 64 at 128, where 128-key tiles
// spilled (ptxas gives a 288-thread block at most 168 registers a thread)
template <int DH> constexpr int kv_tile() { return DH == 128 ? 64 : 128; }
constexpr int STAGES = 2;         // KV tiles in flight
constexpr int NT = 288;           // two consumer warpgroups + a producer warp
constexpr int ROW = 128;          // bytes of a swizzled row: 64 bf16
constexpr float kNeg = -1e30f;

// Shared-memory layout (byte offsets from a 1024-byte-aligned base). A tile
// of R rows is DH / 64 panels of R x 128 bytes, each in TMA's 128-byte
// swizzle (8-row atoms of 1024 bytes).
template <int DH>
struct Layout {
    static constexpr int BK = kv_tile<DH>();
    static constexpr int panels = DH / 64;
    static constexpr int q_bytes = panels * BQ * ROW;
    static constexpr int kv_bytes = panels * BK * ROW;  // one K or V tile
    static constexpr int o_ld = DH + 8;                 // staging row, bf16
    static constexpr int q = 0;
    static constexpr int k = q + q_bytes;               // + stage * kv_bytes
    static constexpr int v = k + STAGES * kv_bytes;
    static constexpr int o = v + STAGES * kv_bytes;     // 2 x 64 rows
    static constexpr int bar = o + 2 * 64 * o_ld * 2;   // full, empty, q
    static constexpr int bytes = bar + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// phase that never completes (a fault in the pipeline) traps after ~2^26
// polls, so the launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        if (polls == (1u << 26)) asm volatile("trap;\n");
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// one TMA box of the 4-d tensor map into shared memory; completion is
// counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128-byte swizzle in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3ffff) >> 4)
           | (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16)
           | (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32)
           | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving registers an asynchronous wgmma owns
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// d[0:64] (+)= A (smem, K-major) x B (smem, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
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
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A (smem, K-major) x B (smem, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
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
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] += A (registers) x B (smem, MN-major: transposed), m64n128k16
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
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
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:32] += A (registers) x B (smem, MN-major: transposed), m64n64k16
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
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
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// Per thread t of a consumer warpgroup (warp w = t / 32, lane l): the
// accumulator element i of an m64nN product lies at row
// 16 w + l / 4 + 8 ((i % 4) / 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.
// Rows "a" (i % 4 < 2) and "b" (i % 4 >= 2) are a thread's two rows.
template <int DH>
__global__ void __launch_bounds__(NT, 1) swa_prefill_tc_kernel(
        const __grid_constant__ CUtensorMap map_q,
        const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v,
        int perm_q, int perm_k, int perm_v, __nv_bfloat16* __restrict__ out,
        int S, int H, int Hkv, int window, float scale) {
    using L = Layout<DH>;
    constexpr int BK = L::BK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* smem = smem_raw + (base - raw);
    const uint32_t full0 = base + L::bar, empty0 = full0 + 8 * STAGES;
    const uint32_t qbar = empty0 + 8 * STAGES;

    const int n_qt = gridDim.x;
    const int qt = n_qt - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int q_hi = min(q0 + BQ, S) - 1;
    const int kt_first = window ? max(0, q0 - window + 1) / BK : 0;
    const int n_tiles = q_hi / BK - kt_first + 1;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 256);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 8) {
        // ---- producer: one lane issues every TMA load ----------------------
        if (lane == 0) {
            // tensor-map coordinates: the head column, then the (s, head,
            // b) axes in the order the wrapper sorted them by stride
            mbar_expect_tx(qbar, L::q_bytes);
#pragma unroll
            for (int p = 0; p < L::panels; ++p) {
                const int ax[3] = {q0, h, b};
                tma_load(base + L::q + p * BQ * ROW, &map_q, qbar, 64 * p,
                         ax[perm_q & 3], ax[(perm_q >> 2) & 3],
                         ax[(perm_q >> 4) & 3]);
            }
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % STAGES, n = i / STAGES;
                if (n > 0) mbar_wait(empty0 + 8 * st, (n - 1) & 1);
                const uint32_t full = full0 + 8 * st;
                mbar_expect_tx(full, 2 * L::kv_bytes);
                const int k0 = (kt_first + i) * BK;
                const int ak[3] = {k0, kvh, b};
#pragma unroll
                for (int p = 0; p < L::panels; ++p) {
                    tma_load(base + L::k + st * L::kv_bytes + p * BK * ROW,
                             &map_k, full, 64 * p, ak[perm_k & 3],
                             ak[(perm_k >> 2) & 3], ak[(perm_k >> 4) & 3]);
                    tma_load(base + L::v + st * L::kv_bytes + p * BK * ROW,
                             &map_v, full, 64 * p, ak[perm_v & 3],
                             ak[(perm_v >> 2) & 3], ak[(perm_v >> 4) & 3]);
                }
            }
        }
        return;
    }

    // ---- consumers: warpgroup g owns query rows r0 .. r0 + 63 -------------
    const int g = warp / 4, t = threadIdx.x % 128, w = t / 32;
    const int r0 = q0 + 64 * g;
    const int qa = r0 + 16 * w + lane / 4, qb = qa + 8;
    const int cq = 2 * (lane % 4);
    // Q: this warpgroup's 64 rows of each panel, K-major, 8-row atoms 1024 B
    const uint32_t q_base = base + L::q + g * 64 * ROW;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m_a = kNeg, m_b = kNeg, l_a = 0.0f, l_b = 0.0f;

    mbar_wait(qbar, 0);
    __syncwarp();
    for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const int k0 = (kt_first + i) * BK;
        const bool skip = k0 > r0 + 63
                          || (window > 0 && k0 + BK - 1 <= r0 - window);
        mbar_wait(full0 + 8 * st, (i / STAGES) & 1);
        __syncwarp();
        if (!skip) {
            const uint32_t k_base = base + L::k + st * L::kv_bytes;
            const uint32_t v_base = base + L::v + st * L::kv_bytes;

            // S = Q . K^T: dh / 16 k-steps; a k-step is 32 bytes into a
            // panel's 128-byte rows, the next panel every 4 steps
            float s[BK / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                const uint64_t da = sw128_desc(
                    q_base + (kk / 4) * BQ * ROW + off, 16, 1024);
                const uint64_t db = sw128_desc(
                    k_base + (kk / 4) * BK * ROW + off, 16, 1024);
                wgmma_ss(s, da, db, kk > 0);
            }
            wgmma_commit_and_wait();
            pin(s);

            // scale in float32, mask the tiles that need it, online softmax
#pragma unroll
            for (int e = 0; e < BK / 2; ++e) s[e] *= scale;
            const bool need_mask = k0 + BK - 1 > r0 || k0 + BK > S
                                   || (window > 0 && k0 <= r0 + 63 - window);
            if (need_mask) {
#pragma unroll
                for (int e = 0; e < BK / 2; ++e) {
                    const int kp = k0 + 8 * (e / 4) + cq + (e % 2);
                    const int qp = (e % 4) < 2 ? qa : qb;
                    const bool ok = kp <= qp && kp < S
                                    && (window == 0 || kp > qp - window);
                    s[e] = ok ? s[e] : kNeg;
                }
            }
            float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
            for (int e = 0; e < BK / 2; ++e) {
                if ((e % 4) < 2) mx_a = fmaxf(mx_a, s[e]);
                else mx_b = fmaxf(mx_b, s[e]);
            }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
                mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
            }
            const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
            const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
            m_a = mn_a;
            m_b = mn_b;
            float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
            for (int e = 0; e < BK / 2; ++e) {
                if ((e % 4) < 2) {
                    s[e] = expf(s[e] - mn_a);
                    rs_a += s[e];
                } else {
                    s[e] = expf(s[e] - mn_b);
                    rs_b += s[e];
                }
            }
            l_a = l_a * al_a + rs_a;
            l_b = l_b * al_b + rs_b;
#pragma unroll
            for (int e = 0; e < DH / 2; ++e) o[e] *= (e % 4) < 2 ? al_a : al_b;

            // P = P_hi + P_lo in wgmma's register-A layout: for the k-step
            // of keys 16 kk .. 16 kk + 15, register r holds the score pair
            // s[8 kk + 2 r], s[8 kk + 2 r + 1]
            uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float x = s[8 * kk + 2 * r];
                    const float y = s[8 * kk + 2 * r + 1];
                    const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
                    const float2 hf = __bfloat1622float2(hi);
                    ph[kk][r] = pack_bf16(hi);
                    pl[kk][r] = pack_bf16(__floats2bfloat162_rn(x - hf.x,
                                                                y - hf.y));
                }
            }

            // O += P_hi . V + P_lo . V: V is MN-major (dh contiguous); a
            // k-step is 16 key rows = 2 atoms, the next 64 dh columns one
            // panel (BK rows) further
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs(o, ph[kk], sw128_desc(v_base + kk * 16 * ROW,
                                               BK * ROW, 1024));
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs(o, pl[kk], sw128_desc(v_base + kk * 16 * ROW,
                                               BK * ROW, 1024));
            wgmma_commit_and_wait();
            pin(o);
            pin(ph);
            pin(pl);
        }
        mbar_arrive(empty0 + 8 * st);
    }

    // ---- epilogue: O / max(l, 1e-30) in bf16 through shared memory --------
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
        smem + L::o) + g * 64 * L::o_ld;
    const int ra = 16 * w + lane / 4;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(stage + ra * L::o_ld + 8 * j + cq) =
            __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        *reinterpret_cast<__nv_bfloat162*>(stage + (ra + 8) * L::o_ld + 8 * j
                                           + cq) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + g) : "memory");
    constexpr int CH = DH / 8;                    // 16-byte chunks a row
    for (int idx = t; idx < 64 * CH; idx += 128) {
        const int row = idx / CH, ch = idx % CH;
        const int qp = r0 + row;
        if (qp >= S) continue;
        const uint4 x = *reinterpret_cast<const uint4*>(
            stage + row * L::o_ld + ch * 8);
        *reinterpret_cast<uint4*>(
            out + ((static_cast<long long>(b) * S + qp) * H + h) * DH
            + ch * 8) = x;
    }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// does not link libcuda)
cudaError_t encoder(EncodeTiled* fn) {
    static EncodeTiled cached = nullptr;
    if (cached == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || p == nullptr)
            return cudaErrorSymbolNotFound;
        cached = reinterpret_cast<EncodeTiled>(p);
    }
    *fn = cached;
    return cudaSuccess;
}

// A 4-d tensor map over one operand's (B, S, heads, dh) view: the dh axis
// first, then the s, head and b axes sorted by stride (strides in
// elements; the wrapper checks they are multiples of 8). The box is 64
// head columns by `rows` positions of one (b, head), 128-byte swizzled.
// *perm gets, 2 bits per map axis, which of (s, head, b) it is.
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     const long long (&stride)[3], const int (&extent)[3],
                     int dh, int rows, int* perm) {
    int order[3] = {0, 1, 2};
    for (int i = 1; i < 3; ++i)
        for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]];
             --j) {
            const int x = order[j];
            order[j] = order[j - 1];
            order[j - 1] = x;
        }
    cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), 0, 0, 0};
    cuuint64_t strides[3];
    cuuint32_t box[4] = {64, 1, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    for (int i = 0; i < 3; ++i) {
        dims[i + 1] = static_cast<cuuint64_t>(extent[order[i]]);
        strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 2;
        if (order[i] == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
    }
    *perm = order[0] | (order[1] << 2) | (order[2] << 4);
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(const CUtensorMap (&maps)[3], const int (&perm)[3],
                   void* out, int B, int S, int H, int Hkv, int window,
                   float scale, cudaStream_t stream) {
    constexpr int smem = Layout<DH>::bytes + 1024;   // + alignment slack
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            swa_prefill_tc_kernel<DH>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    swa_prefill_tc_kernel<DH><<<grid, NT, smem, stream>>>(
        maps[0], maps[1], maps[2], perm[0], perm[1], perm[2],
        static_cast<__nv_bfloat16*>(out), S, H, Hkv, window, scale);
    return cudaGetLastError();
}

}  // namespace tc

// bf16 q, k, v at head size 64 or 128 on the tensor cores. Strides are in
// elements for the (b, s, head) axes; the dh axis is contiguous. The
// wrapper checks shapes, 16-byte-aligned bases and strides that are
// positive multiples of 8 elements (TMA's rules). Launches on the caller's
// stream and returns a cudaError_t: cudaErrorInvalidValue if a tensor map
// is refused, else cudaGetLastError().
extern "C" int swa_prefill_tc(const void* q, const void* k, const void* v,
                              void* out, long long qsb, long long qss,
                              long long qsh, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss,
                              long long vsh, int B, int S, int H, int Hkv,
                              int dh, int window, float scale, int device,
                              cudaStream_t stream) {
    if (dh != 64 && dh != 128) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::EncodeTiled encode;
    err = tc::encoder(&encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap maps[3];
    int perm[3];
    const void* ptrs[3] = {q, k, v};
    const long long strides[3][3] = {{qss, qsh, qsb}, {kss, ksh, ksb},
                                     {vss, vsh, vsb}};
    const int heads[3] = {H, Hkv, Hkv};
    const int bk = dh == 64 ? tc::kv_tile<64>() : tc::kv_tile<128>();
    const int rows[3] = {tc::BQ, bk, bk};
    for (int i = 0; i < 3; ++i) {
        const int extent[3] = {S, heads[i], B};
        err = tc::make_map(encode, &maps[i], ptrs[i], strides[i], extent, dh,
                           rows[i], &perm[i]);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = dh == 64 ? tc::launch<64>(maps, perm, out, B, S, H, Hkv, window,
                                    scale, stream)
                   : tc::launch<128>(maps, perm, out, B, S, H, Hkv, window,
                                     scale, stream);
    return static_cast<int>(err);
}
