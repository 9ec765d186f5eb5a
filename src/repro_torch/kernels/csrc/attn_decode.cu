// One-token GQA attention over a KV cache for Hopper (sm_90a): the
// attention of every decode step, once per layer.
//
// Replaces the TPU kernel attn_decode_pallas in
// src/repro/kernels/swa/swa.py. Per request b and query head h (KV head
// h / G, G = H / Hkv), over the first len_b = lengths[b] rows of a cache of
// Wc rows:
//
//     s[w]   = scale * <q[b, h], k[b, h / G, w]>      for w < len_b
//     out    = sum_w softmax(s)[w] * v[b, h / G, w]   (float32 softmax)
//
// Design. The TPU kernel walks a (B, H, Wc / block_w) grid with the
// (m, l, acc) online-softmax triple carried in VMEM across the sequential
// third axis, and its index map reads every KV slab once per query head.
// Here the cache axis is split (flash-decoding): block (split, kv head,
// request) owns `chunk` cache rows and all G query heads of the KV head,
// so each K/V row is read from memory once for the whole group. B * Hkv
// blocks alone (64 for Qwen3-8B at B = 8) cannot fill 132 SMs; the wrapper
// picks the number of splits so that about 1024 blocks run. Each of the 4
// warps walks every 4th row of the chunk, a lane holding dh / 32 elements
// of the row, and keeps an (m, l, acc) triple per query head in registers;
// the warps merge theirs in shared memory and the block writes one float32
// partial (m, l, acc[dh]) per query head to scratch the wrapper allocates.
// A second kernel merges the partials of the splits that hold valid rows.
// Blocks whose rows all lie at or past len_b return at once (their partial
// is never read), and the ragged end of the cache (Wc need not be a
// multiple of anything) is the loop bound, so no cache row past len_b is
// read. Scores, exponentials (accurate expf, no fast-math) and sums are
// float32; the output is written in q's dtype (bf16 or float32). A
// request with len_b = 0 gets 0 / 0 = NaN, as the plain version gives.
//
// Bound: bytes. A step reads each valid K and V row once: at B = 8,
// Hkv = 8, dh = 128, bf16 and 2,049-2,079 valid rows that is 67-68 MB a
// layer, 0.020 ms at 3.35 TB/s; the partials add B * H * splits * 130
// floats (2 MB) written and read back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// E contiguous elements at p, 16-byte aligned when E >= 4, as float32.
template <int E>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&o)[E]) {
    if constexpr (E % 4 == 0) {
#pragma unroll
        for (int i = 0; i < E; i += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
            o[i] = t.x; o[i + 1] = t.y; o[i + 2] = t.z; o[i + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < E; ++i) o[i] = __ldg(p + i);
    }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&o)[E]) {
    if constexpr (E % 4 == 0) {
#pragma unroll
        for (int i = 0; i < E; i += 4) {
            uint2 t = __ldg(reinterpret_cast<const uint2*>(p + i));
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<__nv_bfloat162*>(&t.x));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<__nv_bfloat162*>(&t.y));
            o[i] = a.x; o[i + 1] = a.y; o[i + 2] = b.x; o[i + 3] = b.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < E; ++i) o[i] = __bfloat162float(p[i]);
    }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

__device__ __forceinline__ int valid_rows(const int* lengths, int b, int Wc) {
    return min(max(lengths[b], 0), Wc);
}

// Partial (m, l, acc) of one (split, kv head, request) for its G heads.
template <typename T, int DH, int GMAX>
__global__ void __launch_bounds__(kWarps * 32) attn_decode_split(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ lengths,
        float* __restrict__ part_m, float* __restrict__ part_l,
        float* __restrict__ part_acc, int H, int Hkv, int Wc, int G,
        int chunk, int n_split, float scale) {
    constexpr int E = DH / 32;
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int len = valid_rows(lengths, b, Wc);
    const int start = split * chunk;
    if (start >= len) return;
    const int end = min(start + chunk, len);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    float qr[GMAX][E], acc[GMAX][E], m[GMAX], l[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
        m[g] = -INFINITY;
        l[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) { qr[g][e] = 0.0f; acc[g][e] = 0.0f; }
        if (g < G) {
            load_row<E>(q + (static_cast<long long>(b) * H + kvh * G + g) * DH
                        + lane * E, qr[g]);
#pragma unroll
            for (int e = 0; e < E; ++e) qr[g][e] *= scale;
        }
    }

    const long long base = (static_cast<long long>(b) * Hkv + kvh) * Wc * DH
                           + lane * E;
    for (int w = start + warp; w < end; w += kWarps) {
        float kr[E], vr[E];
        load_row<E>(k + base + static_cast<long long>(w) * DH, kr);
        load_row<E>(v + base + static_cast<long long>(w) * DH, vr);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            if (g >= G) break;
            float s = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kr[e], s);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_xor_sync(kFull, s, off);
            const float m_new = fmaxf(m[g], s);
            const float alpha = expf(m[g] - m_new);   // 0 on the first row
            const float p = expf(s - m_new);
            l[g] = l[g] * alpha + p;
#pragma unroll
            for (int e = 0; e < E; ++e)
                acc[g][e] = fmaf(p, vr[e], acc[g][e] * alpha);
            m[g] = m_new;
        }
    }

    // merge the warps' triples; warp 0 saw row `start`, so M is finite
    __shared__ float sm_m[kWarps][GMAX], sm_l[kWarps][GMAX];
    __shared__ float sm_acc[kWarps][GMAX][DH];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
        if (lane == 0) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
#pragma unroll
        for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * DH; i += kWarps * 32) {
        const int g = i / DH, d = i % DH;
        float M = sm_m[0][g];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
        float L = 0.0f, A = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float c = expf(sm_m[w][g] - M);   // 0 for an idle warp
            L = fmaf(c, sm_l[w][g], L);
            A = fmaf(c, sm_acc[w][g][d], A);
        }
        const long long row = (static_cast<long long>(b) * H + kvh * G + g)
                              * n_split + split;
        part_acc[row * DH + d] = A;
        if (d == 0) { part_m[row] = M; part_l[row] = L; }
    }
}

// Merge the partials of the splits that hold valid rows: one block per
// (request, query head), one thread per output element.
template <typename T, int DH>
__global__ void __launch_bounds__(DH) attn_decode_combine(
        const float* __restrict__ part_m, const float* __restrict__ part_l,
        const float* __restrict__ part_acc, const int* __restrict__ lengths,
        T* __restrict__ out, int H, int Wc, int chunk, int n_split) {
    const int bh = blockIdx.x, d = threadIdx.x;
    const int len = valid_rows(lengths, bh / H, Wc);
    const int n_valid = (len + chunk - 1) / chunk;
    const long long row0 = static_cast<long long>(bh) * n_split;
    float M = -INFINITY;
    for (int s = 0; s < n_valid; ++s) M = fmaxf(M, part_m[row0 + s]);
    float L = 0.0f, A = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
        const float c = expf(part_m[row0 + s] - M);
        L = fmaf(c, part_l[row0 + s], L);
        A = fmaf(c, part_acc[(row0 + s) * DH + d], A);
    }
    store(out + static_cast<long long>(bh) * DH + d, A / L);
}

struct Args {
    const void *q, *k, *v;
    const int* lengths;
    float *part_m, *part_l, *part_acc;
    void* out;
    int B, H, Hkv, Wc, G, chunk, n_split;
    float scale;
    cudaStream_t stream;
};

template <typename T, int DH, int GMAX>
cudaError_t launch(const Args& a) {
    const dim3 grid(a.n_split, a.Hkv, a.B);
    attn_decode_split<T, DH, GMAX><<<grid, kWarps * 32, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.lengths, a.part_m, a.part_l,
        a.part_acc, a.H, a.Hkv, a.Wc, a.G, a.chunk, a.n_split, a.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_decode_combine<T, DH><<<a.B * a.H, DH, 0, a.stream>>>(
        a.part_m, a.part_l, a.part_acc, a.lengths, static_cast<T*>(a.out),
        a.H, a.Wc, a.chunk, a.n_split);
    return cudaGetLastError();
}

// GMAX: the smallest of 1, 2, 4, 8, 16 that holds G; the warp-merge
// buffer (4 * GMAX * DH floats) stays within 32 KB of static shared memory.
template <typename T, int DH>
cudaError_t by_group(const Args& a) {
    if (a.G <= 1) return launch<T, DH, 1>(a);
    if (a.G <= 2) return launch<T, DH, 2>(a);
    if (a.G <= 4) return launch<T, DH, 4>(a);
    if (a.G <= 8) return launch<T, DH, 8>(a);
    if constexpr (DH <= 128) {
        if (a.G <= 16) return launch<T, DH, 16>(a);
    }
    return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_head_dim(int dh, const Args& a) {
    switch (dh) {
        case 64: return by_group<T, 64>(a);
        case 128: return by_group<T, 128>(a);
        case 256: return by_group<T, 256>(a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and out alike). The wrapper
// checks shapes, alignment and the supported (dh, G); an unsupported pair
// returns cudaErrorInvalidValue. Launches both kernels on the caller's
// stream and returns cudaGetLastError().
extern "C" int attn_decode(int dtype, const void* q, const void* k,
                           const void* v, const int* lengths, float* part_m,
                           float* part_l, float* part_acc, void* out, int B,
                           int H, int Hkv, int Wc, int dh, int chunk,
                           int n_split, float scale, int device,
                           cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Args a{q, k, v, lengths, part_m, part_l, part_acc, out, B, H, Hkv,
                 Wc, H / Hkv, chunk, n_split, scale, stream};
    if (dtype == 0) return static_cast<int>(by_head_dim<float>(dh, a));
    if (dtype == 1) return static_cast<int>(by_head_dim<__nv_bfloat16>(dh, a));
    return static_cast<int>(cudaErrorInvalidValue);
}
