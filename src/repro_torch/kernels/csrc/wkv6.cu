// Chunked RWKV6 WKV with data-dependent decay for Hopper (sm_90a): the
// recurrent mixer of RWKV6 prefill, once per layer.
//
// Replaces the TPU kernel wkv6_chunked_pallas in
// src/repro/kernels/wkv6/wkv6.py. For each of the BH = B * H sequences,
// from a zero state S (K x V, float32), over chunks of C = 64 tokens with
// P the inclusive and E the exclusive cumsum of the log-decay lw <= 0
// inside the chunk (E_i = P_{i-1}, E_0 = 0):
//
//     y_i   = (r_i . exp(E_i)) @ S                            inter-chunk
//           + sum_{j<i} [sum_k r_ik k_jk exp(E_ik - P_jk)] v_j intra-chunk
//           + (r_i . u . k_i) v_i                             bonus
//     S_end = diag(exp(P_last)) S + sum_j (k_j . exp(P_last - P_j))^T v_j
//
// No exponent here is positive: P falls monotonically inside a chunk
// (lw reaches -e^4, so P falls to about -3,500), and a factor
// exp(E_i) * exp(-P_j) would overflow (inf * 0 = NaN). The library is
// built without fast-math, so expf is the accurate one.
//
// Design: three passes, each parallel over (sequence, chunk group), a
// group being G consecutive chunks (the wrapper picks G in {4, 2, 1}:
// 4 unless that leaves fewer than two blocks an SM).
//
//   1. wkv6_group_states: the group's own state contribution dS (the
//      state update above, from a zero state, over its chunks) and its
//      total decay prod exp(P_last), to scratch the wrapper allocates.
//   2. wkv6_group_scan: per (sequence, k, v), S_{g+1} = decay_g S_g +
//      dS_g from S_0 = 0, in place: each group's start state replaces its
//      dS; the last S is the final state (the s output).
//   3. wkv6_group_outputs: from the group's start state, y of its chunks,
//      carrying S through them in order.
//
// A block of 128 threads (4 warps) owns one (sequence, group); warp w owns
// the 16-row sub-chunk w of every chunk, and rows 16w.. of S (by key
// channel) in the state update. The four 64 x 64 x 64 products of a chunk
// (k_dec^T v, (r . exp(E)) @ S, the intra-chunk scores, scores @ v) run on
// the tensor cores as mma.sync m16n8k16 on bf16 operands with float32
// accumulation. A float32 operand (every decayed factor, S, the scores,
// and v on the float32 path) is split into bf16 hi + lo and the product
// taken as hi.hi + hi.lo + lo.hi (about 2^-16 relative, where one rounding
// to bf16 is 2^-8 and fails the check); v on the bf16 path is exact in bf16
// and is not split. The intra-chunk decay is factored per 16-row
// sub-chunk: for query rows i >= i0 = 16w and key rows j < i0, with the
// anchor a = i0 - 1, exp(E_i - P_j) = exp(E_i - P_a) exp(P_a - P_j), both
// exponents <= 0, so the off-diagonal sub-blocks are one ordinary product
// of decayed q and k (a factor that underflows to 0 bounds a true term
// smaller still); the block computes the anchored keys of sub-chunks 1-3
// together (6,144 exponentials a chunk) into shared memory. Only the four
// diagonal 16 x 16 sub-blocks form exp(E_i - P_j) per (i, j, k): 4 x 120 x
// 64 = 30,720 accurate expf a chunk, on the FMA pipes; the bonus
// (r_i . u . k_i) sits on their diagonal, so scores @ v adds it.
//
// Shared memory holds r and k in their own dtype and P in float32 (rows
// padded to 72 elements, so the fragment loads are conflict-free), and
// v^T, S^T and the anchored keys as bf16 hi (and lo) planes: 97 KB for
// bf16, two blocks an SM. Any T is taken: the rows of a ragged last chunk
// are zero with lw = 0 there, so P_last is the last real row's. r, k, v,
// lw, u and y are addressed through (b, h, t) strides, so the model hands
// over views of its (B, S, H, hd) projections and gets y in that layout
// without a copy.
//
// Bound: bytes. At the serve shape (B = 8, H = 32, T = 2,048,
// K = V = 64) r, k, v and y in bf16, lw in float32 and the final state move
// 406.9 MB, 0.121 ms at 3.35 TB/s. The design reads k, v and lw twice
// (passes 1 and 3) and moves the group states four times (written by pass
// 1, read and rewritten by pass 2, read by pass 3): 0.81 GB at G = 4,
// 0.24 ms, its floor. What it spends beyond that goes to the FMA pipes,
// chiefly the diagonal sub-blocks' exponentials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64, D = 64, NT = 128, NW = NT / 32;
constexpr int RS = 72;   // row stride of every shared-memory tile, elements
constexpr unsigned kFull = 0xffffffffu;
static_assert(NT == 2 * D, "the decay scan takes two threads a channel");

// A float32 operand goes to the tensor cores as kParts bf16 parts (hi, lo;
// on the float32 path hi, mid, lo), and a product as the part pairs (i, j)
// with i + j < kParts. v has kVParts parts: 1 (exact in bf16) or kParts.
template <typename T>
constexpr int kParts = sizeof(T) == 4 ? 3 : 2;
template <typename T>
constexpr int kVParts = sizeof(T) == 4 ? 3 : 1;

// Shared memory, bytes. Pass 1: E/P (float32, C + 1 rows: row 0 is E_0 =
// 0, row i + 1 is P_i), k (T), exp(P_last) | v^T hi (, lo). Pass 3 adds r
// (T; the warps' y rows at the end), the diagonal blocks (NW x 16 x 16
// float32), u, S^T hi and lo, and the anchored keys of sub-chunks 1-3
// (16 + 32 + 48 rows, hi and lo).
constexpr int kPlane = D * RS * 2;                 // one bf16 plane
constexpr int kEP = (C + 1) * RS * 4;
constexpr int kAnchored = 96;                      // rows of anchored keys
template <typename T>
constexpr int smem_states() {
    return kEP + C * RS * int(sizeof(T)) + D * 4 + kVParts<T> * kPlane;
}
template <typename T>
constexpr int smem_outputs() {
    return kEP + 2 * C * RS * int(sizeof(T)) + NW * 256 * 4 + 2 * D * 4
           + (kVParts<T> + kParts<T>) * kPlane + kParts<T> * kAnchored * RS * 2;
}

struct Strides {
    long long b, h, t;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float at(const float4& f, int i) {
    return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// loads from shared memory as float32: one, two or four elements
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 ld2f(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2f(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 cvt4(float4 x) { return x; }
__device__ __forceinline__ float4 cvt4(uint2 t) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4f(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4f(const bf16* p) {
    return cvt4(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t ldu(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// (x0, x1) as the sum of N packed bf16 pairs (x0 in the low half), each
// part the bf16 rounding of what the parts before it leave
template <int N>
__device__ __forceinline__ void split(float x0, float x1, uint32_t (&p)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        p[i] = bits(h);
        const float2 f = __bfloat1622float2(h);
        x0 -= f.x;
        x1 -= f.y;
    }
}

// x as the sum of N bf16 parts, to planes N apart by `stride` elements
template <int N>
__device__ __forceinline__ void split_to(float x, bf16* dst, int stride) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const bf16 h = __float2bfloat16_rn(x);
        dst[i * stride] = h;
        x -= __bfloat162float(h);
    }
}

// d += a b: m16n8k16, A row-major (16 x 16), B column-major (16 x 8)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B over the part pairs (i, j) with i + j < NP, the smallest first
template <int NP, int NA, int NB>
__device__ __forceinline__ void mma_parts(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
#pragma unroll
    for (int sum = NP - 1; sum >= 0; --sum)
#pragma unroll
        for (int i = 0; i < NA; ++i)
            if (sum - i >= 0 && sum - i < NB)
                mma(d, a[i], b[sum - i][0], b[sum - i][1]);
}

// B fragments of N parts: planes `stride` elements apart, at offset o
template <int N>
__device__ __forceinline__ void ldb(uint32_t (&b)[N][2], const bf16* planes,
                                    int stride, int o) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        b[i][0] = ldu(planes + i * stride + o);
        b[i][1] = ldu(planes + i * stride + o + 8);
    }
}

// Raw 4-channel loads from global memory: a float4, or four packed bf16
template <typename T>
struct Raw;

template <>
struct Raw<float> {
    using type = float4;
    static __device__ __forceinline__ float4 load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ float4 zero() {
        return make_float4(0.f, 0.f, 0.f, 0.f);
    }
};

template <>
struct Raw<bf16> {
    using type = uint2;
    static __device__ __forceinline__ uint2 load(const bf16* p) {
        return __ldg(reinterpret_cast<const uint2*>(p));
    }
    static __device__ __forceinline__ uint2 zero() { return make_uint2(0u, 0u); }
};

// one sequence's rows of an input, from the chunk's first row
template <typename T>
struct Rows {
    const T* p;
    long long st;
};

// One chunk into shared memory, every global load issued before the first
// store: r (if WITH_R) and k as they are (rows [row * RS + c] of T), lw as
// float32 rows, v as the kVParts bf16 planes of v^T [c * RS + j]. Rows at
// or past nt are zero. v's rows run fastest across the threads, so its
// 16-bit stores are conflict-free.
template <typename T, bool WITH_R>
__device__ __forceinline__ void stage_chunk(T* rsm, T* ksm, float* P,
                                            bf16* vp_, Rows<T> r,
                                            Rows<T> k, Rows<float> lw,
                                            Rows<T> v, int nt) {
    using R = Raw<T>;
    using RT = typename R::type;
    // thread steps: 8 rows of r, k, lw; 8 channels of v^T
    constexpr int N = C * D / 4 / NT, STEP = NT / (D / 4), VSTEP = NT / C * 4;
    const int row0 = threadIdx.x / (D / 4), c4 = (threadIdx.x % (D / 4)) * 4;
    const int j = threadIdx.x % C, cv = (threadIdx.x / C) * 4;
    RT xr[N], xk[N], xv[N];
    float4 xl[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int row = row0 + STEP * i;
        const bool ok = row < nt;
        if constexpr (WITH_R) xr[i] = ok ? R::load(r.p + row * r.st + c4) : R::zero();
        xk[i] = ok ? R::load(k.p + row * k.st + c4) : R::zero();
        xl[i] = ok ? Raw<float>::load(lw.p + row * lw.st + c4) : Raw<float>::zero();
        xv[i] = j < nt ? R::load(v.p + j * v.st + cv + VSTEP * i) : R::zero();
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int o = (row0 + STEP * i) * RS + c4;
        if constexpr (WITH_R) *reinterpret_cast<RT*>(rsm + o) = xr[i];
        *reinterpret_cast<RT*>(ksm + o) = xk[i];
        *reinterpret_cast<float4*>(P + o) = xl[i];
        const float4 x = cvt4(xv[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            split_to<kVParts<T>>(at(x, e), vp_ + (cv + VSTEP * i + e) * RS + j,
                                 D * RS);
    }
}

// In place over the staged lw (rows P[0..63]): the inclusive cumsum of
// each channel in row order, then dc[c] = exp(P_last[c]). Thread (c, half)
// owns rows [32 half, +32); the second half first sums rows 0..31 in the
// same order as the first.
__device__ __forceinline__ void scan_decay(float* P, float* dc) {
    const int c = threadIdx.x % D, half = threadIdx.x / D;
    float x[32];
    float acc = 0.0f;
    if (half)
        for (int i = 0; i < 32; ++i) acc += P[i * RS + c];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = P[(32 * half + i) * RS + c];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        acc += x[i];
        P[(32 * half + i) * RS + c] = acc;
    }
    if (half) dc[c] = expf(acc);
}

// The state update on S[k][v] in fragments: acc[n] holds rows k = k0 + g
// (+8), columns v = 8 n + 2 t (+1). S = diag(exp(P_last)) S + k_dec^T v,
// with A = k_dec^T [k][j] = k[j][k] exp(P_last[k] - P[j][k]) formed here,
// each element once across the warps, and B = v from the v^T planes.
template <typename T>
__device__ __forceinline__ void update_state(float (&acc)[8][4], const T* ksm,
                                             const float* P, const bf16* vp_,
                                             const float* dc, int k0, int g,
                                             int t) {
    constexpr int NP = kParts<T>, NV = kVParts<T>;
    const float d0 = dc[k0 + g], d1 = dc[k0 + g + 8];
    const float last0 = P[(C - 1) * RS + k0 + g];
    const float last1 = P[(C - 1) * RS + k0 + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        acc[n][0] *= d0;
        acc[n][1] *= d0;
        acc[n][2] *= d1;
        acc[n][3] *= d1;
    }
#pragma unroll
    for (int js = 0; js < 4; ++js) {
        uint32_t a[NP][4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            const int j = 16 * js + 2 * t + ((f & 2) ? 8 : 0);
            const int kk = k0 + g + ((f & 1) ? 8 : 0);
            const float last = (f & 1) ? last1 : last0;
            uint32_t p[NP];
            split(ldf(ksm + j * RS + kk) * expf(last - P[j * RS + kk]),
                  ldf(ksm + (j + 1) * RS + kk)
                      * expf(last - P[(j + 1) * RS + kk]), p);
#pragma unroll
            for (int i = 0; i < NP; ++i) a[i][f] = p[i];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            uint32_t b[NV][2];
            ldb(b, vp_, D * RS, (8 * n + g) * RS + 16 * js + 2 * t);
            mma_parts<NP>(acc[n], a, b);
        }
    }
}

// ---- pass 1: each group's own state contribution and decay ------------
template <typename T>
__global__ void __launch_bounds__(NT, 4) wkv6_group_states(
        const T* __restrict__ k, const T* __restrict__ v,
        const float* __restrict__ lw, float* __restrict__ ds,
        float* __restrict__ decay, Strides ks_, Strides vs_, Strides ls_,
        int H, int Tlen, int G, int n_groups) {
    extern __shared__ float4 smem4[];
    float* E = reinterpret_cast<float*>(smem4);   // row i: E_i; row i + 1: P_i
    float* P = E + RS;
    float* dc = E + (C + 1) * RS;
    T* ksm = reinterpret_cast<T*>(dc + D);
    bf16* vp_ = reinterpret_cast<bf16*>(ksm + C * RS);   // v^T planes

    const int seq = blockIdx.x / n_groups, grp = blockIdx.x % n_groups;
    const int b = seq / H, h = seq % H;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const T* kp = k + b * ks_.b + h * ks_.h;
    const T* vp = v + b * vs_.b + h * vs_.h;
    const float* lp = lw + b * ls_.b + h * ls_.h;

    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    float prod = 1.0f;

    const int c_end = min(grp * G + G, (Tlen + C - 1) / C);
    for (int ch = grp * G; ch < c_end; ++ch) {
        const int t0 = ch * C, nt = min(C, Tlen - t0);
        stage_chunk<T, false>(nullptr, ksm, P, vp_, {nullptr, 0},
                              {kp + t0 * ks_.t, ks_.t},
                              {lp + t0 * ls_.t, ls_.t},
                              {vp + t0 * vs_.t, vs_.t}, nt);
        __syncthreads();
        scan_decay(P, dc);
        __syncthreads();
        update_state<T>(acc, ksm, P, vp_, dc, 16 * w, g, t);
        if (tid < D) prod *= dc[tid];
        __syncthreads();                       // before the next chunk's loads
    }

    const long long gs = static_cast<long long>(seq) * n_groups + grp;
    float* o = ds + gs * (D * D);              // dS[k][v]
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t;
        st2(o + (16 * w + g) * D + c, acc[n][0], acc[n][1]);
        st2(o + (16 * w + g + 8) * D + c, acc[n][2], acc[n][3]);
    }
    if (tid < D) decay[gs * D + tid] = prod;
}

// ---- pass 2: scan over the groups ----------------------------------------
__global__ void __launch_bounds__(256) wkv6_group_scan(
        float* __restrict__ ds, const float* __restrict__ decay,
        float* __restrict__ s_out, int n_groups) {
    const long long idx = blockIdx.x * 256LL + threadIdx.x;
    const long long seq = idx / (D * D);
    const int e = static_cast<int>(idx % (D * D)), kk = e / D;
    float S = 0.0f;
    for (int gi = 0; gi < n_groups; ++gi) {
        const long long gs = seq * n_groups + gi;
        float* p = ds + gs * (D * D) + e;
        const float d = *p;
        *p = S;                                // the group's start state
        S = fmaf(decay[gs * D + kk], S, d);
    }
    s_out[idx] = S;
}

// ---- pass 3: outputs from each group's start state -----------------------

// The diagonal 16 x 16 block of the sub-chunk at rows i0..i0+15 into
// dgw[a * 16 + b]: sum_c r[i0+a][c] k[i0+b][c] exp(E[i0+a][c] - P[i0+b][c])
// for b < a, the bonus sum_c r[i0+a][c] u[c] k[i0+a][c] for b = a (so that
// scores @ v adds (r_i . u . k_i) v_i), zero elsewhere. Lane 4 p + q takes
// rows p and 15 - p (15 pairs (a, b) together) over the channels
// 16 m + 4 q + e (m, e < 4); the four lanes of a row pair add their parts.
template <typename T>
__device__ __forceinline__ void diag_scores(const T* rsm, const T* ksm,
                                            const float* E, const float* us,
                                            float* dgw, int i0, int lane) {
    const int p = lane >> 2, q = lane & 3;
    for (int e = lane; e < 256; e += 32) dgw[e] = 0.0f;
    float ra[16], ea[16], rb[16], eb[16];
    float ba = 0.0f, bb = 0.0f;                   // the two rows' bonus parts
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int c = 16 * m + 4 * q;
        const float4 x0 = ld4f(rsm + (i0 + p) * RS + c);
        const float4 x1 = ld4f(E + (i0 + p) * RS + c);
        const float4 x2 = ld4f(rsm + (i0 + 15 - p) * RS + c);
        const float4 x3 = ld4f(E + (i0 + 15 - p) * RS + c);
        const float4 ka = ld4f(ksm + (i0 + p) * RS + c);
        const float4 kb = ld4f(ksm + (i0 + 15 - p) * RS + c);
        const float4 uu = ld4f(us + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            ra[4 * m + e] = at(x0, e);
            ea[4 * m + e] = at(x1, e);
            rb[4 * m + e] = at(x2, e);
            eb[4 * m + e] = at(x3, e);
            ba = fmaf(at(x0, e) * at(uu, e), at(ka, e), ba);
            bb = fmaf(at(x2, e) * at(uu, e), at(kb, e), bb);
        }
    }
    ba += __shfl_xor_sync(kFull, ba, 1);
    ba += __shfl_xor_sync(kFull, ba, 2);
    bb += __shfl_xor_sync(kFull, bb, 1);
    bb += __shfl_xor_sync(kFull, bb, 2);
    __syncwarp();
    if (q == 0) {
        dgw[p * 17] = ba;
        dgw[(15 - p) * 17] = bb;
    }
    for (int n = 0; n < 15; ++n) {
        const bool first = n < p;
        const int a = first ? p : 15 - p, bc = first ? n : n - p;
        const T* kr = ksm + (i0 + bc) * RS;
        const float* pr = E + (i0 + bc + 1) * RS;   // P row i0 + bc
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int c = 16 * m + 4 * q;
            const float4 kk = ld4f(kr + c);
            const float4 pp = ld4f(pr + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float rr = first ? ra[4 * m + e] : rb[4 * m + e];
                const float ee = first ? ea[4 * m + e] : eb[4 * m + e];
                const float x = rr * at(kk, e), ex = expf(ee - at(pp, e));
                if (e & 1) s1 = fmaf(x, ex, s1); else s0 = fmaf(x, ex, s0);
            }
        }
        float s = s0 + s1;
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        if (q == 0) dgw[a * 16 + bc] = s;
    }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) wkv6_group_outputs(
        const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ lw,
        const float* __restrict__ u, T* __restrict__ y,
        const float* __restrict__ s_start, Strides rs_, Strides ks_,
        Strides vs_, Strides ls_, Strides ys_, long long usb, long long ush,
        int H, int Tlen, int G, int n_groups) {
    extern __shared__ float4 smem4[];
    float* E = reinterpret_cast<float*>(smem4);   // row i: E_i; row i + 1: P_i
    float* P = E + RS;
    float* dgs = E + (C + 1) * RS;                // NW x 16 x 16
    float* us = dgs + NW * 256;
    float* dc = us + D;
    T* rsm = reinterpret_cast<T*>(dc + D);        // r, then the warp's y rows
    T* ksm = rsm + C * RS;
    constexpr int NP = kParts<T>, NV = kVParts<T>;
    constexpr int SP = D * RS, QP = kAnchored * RS;   // plane strides
    bf16* vp_ = reinterpret_cast<bf16*>(ksm + C * RS);   // v^T planes
    bf16* sp_ = vp_ + NV * SP;                    // S^T [v][k] planes
    bf16* qp_ = sp_ + NP * SP;                    // anchored keys [row][c]

    const int seq = blockIdx.x / n_groups, grp = blockIdx.x % n_groups;
    const int b = seq / H, h = seq % H;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int i0 = 16 * w;
    const T* rp = r + b * rs_.b + h * rs_.h;
    const T* kp = k + b * ks_.b + h * ks_.h;
    const T* vp = v + b * vs_.b + h * vs_.h;
    const float* lp = lw + b * ls_.b + h * ls_.h;
    T* yp = y + b * ys_.b + h * ys_.h;
    float* dgw = dgs + w * 256;

    if (tid < D) {
        us[tid] = u[b * usb + h * ush + tid];
        E[tid] = 0.0f;                            // E_0 = 0, never restaged
    }
    // the group's start state S[k][v]: rows k = i0 + g (+8), columns
    // 8 n + 2 t (+1)
    float accS[8][4];
    const float* s0 = s_start
        + (static_cast<long long>(seq) * n_groups + grp) * (D * D);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t;
        const float2 x0 = ld2f(s0 + (i0 + g) * D + c);
        const float2 x1 = ld2f(s0 + (i0 + g + 8) * D + c);
        accS[n][0] = x0.x;
        accS[n][1] = x0.y;
        accS[n][2] = x1.x;
        accS[n][3] = x1.y;
    }

    const int c_end = min(grp * G + G, (Tlen + C - 1) / C);
    for (int ch = grp * G; ch < c_end; ++ch) {
        const int t0 = ch * C, nt = min(C, Tlen - t0);
        stage_chunk<T, true>(rsm, ksm, P, vp_, {rp + t0 * rs_.t, rs_.t},
                             {kp + t0 * ks_.t, ks_.t},
                             {lp + t0 * ls_.t, ls_.t},
                             {vp + t0 * vs_.t, vs_.t}, nt);
        __syncthreads();
        scan_decay(P, dc);
        __syncthreads();
        // the anchored keys of sub-chunks I = 1, 2, 3 (anchor a = 16 I - 1):
        // k[j][c] exp(P_a[c] - P[j][c]) for j <= a, at plane rows
        // 8 I (I - 1) + j; two channels a thread-step, the block shares them
        for (int idx = tid; idx < kAnchored * D / 2; idx += NT) {
            const int row = idx / (D / 2), c = 2 * (idx % (D / 2));
            const int I = row < 16 ? 1 : row < 48 ? 2 : 3;
            const int j = row - 8 * I * (I - 1);
            const float2 pa = ld2f(P + (16 * I - 1) * RS + c);
            const float2 kk = ld2f(ksm + j * RS + c), pj = ld2f(P + j * RS + c);
            uint32_t q[NP];
            split(kk.x * expf(pa.x - pj.x), kk.y * expf(pa.y - pj.y), q);
#pragma unroll
            for (int i = 0; i < NP; ++i)
                *reinterpret_cast<uint32_t*>(qp_ + i * QP + row * RS + c) = q[i];
        }
        // S^T planes for every warp: S^T[v][k] = S[k][v]
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                split_to<NP>(accS[n][e],
                             sp_ + (c + (e & 1)) * RS + i0 + g + ((e & 2) ? 8 : 0),
                             SP);
            }
        }
        __syncthreads();

        // ---- the diagonal sub-block, pairwise ---------------------------
        diag_scores<T>(rsm, ksm, E, us, dgw, i0, lane);

        // ---- inter-chunk: y = (r . exp(E)) @ S --------------------------
        float accY[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) accY[n][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            const int c0 = 16 * ks + 2 * t;
            uint32_t a[NP][4];
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int o = (i0 + g + ((f & 1) ? 8 : 0)) * RS + c0
                              + ((f & 2) ? 8 : 0);
                const float2 x = ld2f(rsm + o), e = ld2f(E + o);
                uint32_t p[NP];
                split(x.x * expf(e.x), x.y * expf(e.y), p);
#pragma unroll
                for (int i = 0; i < NP; ++i) a[i][f] = p[i];
            }
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                uint32_t b[NP][2];
                ldb(b, sp_, SP, (8 * n + g) * RS + c0);
                mma_parts<NP>(accY[n], a, b);
            }
        }

        // ---- intra-chunk scores: key rows j < i0 through the anchor -----
        float sc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
        if (w > 0) {
            const float* pa = E + i0 * RS;        // P_a, a = i0 - 1
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
                const int c0 = 16 * ks + 2 * t;
                const float2 pa0 = ld2f(pa + c0), pa1 = ld2f(pa + c0 + 8);
                uint32_t a[NP][4];
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    const int o = (i0 + g + ((f & 1) ? 8 : 0)) * RS + c0
                                  + ((f & 2) ? 8 : 0);
                    const float2 an = (f & 2) ? pa1 : pa0;
                    const float2 x = ld2f(rsm + o), e = ld2f(E + o);
                    uint32_t p[NP];
                    split(x.x * expf(e.x - an.x), x.y * expf(e.y - an.y), p);
#pragma unroll
                    for (int i = 0; i < NP; ++i) a[i][f] = p[i];
                }
#pragma unroll
                for (int n = 0; n < 6; ++n) {
                    if (n >= 2 * w) break;
                    // key row 8 n + g of sub-chunk w's anchored keys
                    uint32_t b[NP][2];
                    ldb(b, qp_, QP, (8 * w * (w - 1) + 8 * n + g) * RS + c0);
                    mma_parts<NP>(sc[n], a, b);
                }
            }
        }
        __syncwarp();                              // dgw complete
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            if (n != 2 * w && n != 2 * w + 1) continue;
            const int c = 8 * (n - 2 * w) + 2 * t;
            sc[n][0] += dgw[g * 16 + c];
            sc[n][1] += dgw[g * 16 + c + 1];
            sc[n][2] += dgw[(g + 8) * 16 + c];
            sc[n][3] += dgw[(g + 8) * 16 + c + 1];
        }

        // ---- y += scores @ v --------------------------------------------
#pragma unroll
        for (int js = 0; js < 4; ++js) {
            if (js > w) break;
            uint32_t a[NP][4];
#pragma unroll
            for (int f = 0; f < 4; ++f) {             // A's layout: C's tiles
                const int n2 = 2 * js + (f >> 1), e0 = 2 * (f & 1);
                uint32_t p[NP];
                split(sc[n2][e0], sc[n2][e0 + 1], p);
#pragma unroll
                for (int i = 0; i < NP; ++i) a[i][f] = p[i];
            }
            const int c0 = 16 * js + 2 * t;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                uint32_t b[NV][2];
                ldb(b, vp_, SP, (8 * n + g) * RS + c0);
                mma_parts<NP>(accY[n], a, b);
            }
        }

        // ---- write y: through the warp's own r rows, 16 bytes a lane -----
        __syncwarp();
        T* yw = rsm + i0 * RS;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
            st2(yw + g * RS + c, accY[n][0], accY[n][1]);
            st2(yw + (g + 8) * RS + c, accY[n][2], accY[n][3]);
        }
        __syncwarp();
        {
            constexpr int E16 = 16 / sizeof(T), LPR = D / E16;  // lanes a row
#pragma unroll
            for (int it = 0; it < 16 * LPR / 32; ++it) {
                const int row = it * (32 / LPR) + lane / LPR;
                const int c = (lane % LPR) * E16;
                if (i0 + row < nt)
                    *reinterpret_cast<uint4*>(yp + (t0 + i0 + row) * ys_.t + c) =
                        *reinterpret_cast<const uint4*>(yw + row * RS + c);
            }
        }

        // ---- the carried state ------------------------------------------
        update_state<T>(accS, ksm, P, vp_, dc, i0, g, t);
        __syncthreads();                       // before the next chunk's loads
    }
}

struct Args {
    const void *r, *k, *v, *lw, *u;
    void *y, *s;
    float *ds, *decay;
    Strides rs, ks, vs, ls, ys;
    long long usb, ush;
    int B, H, T, G;
    cudaStream_t stream;
};

template <typename K>
cudaError_t configure(K kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

template <typename T>
cudaError_t launch(const Args& a) {
    constexpr int smem1 = smem_states<T>(), smem3 = smem_outputs<T>();
    static bool configured = false;
    if (!configured) {
        cudaError_t err = configure(wkv6_group_states<T>, smem1);
        if (err != cudaSuccess) return err;
        err = configure(wkv6_group_outputs<T>, smem3);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const int n_groups = ((a.T + C - 1) / C + a.G - 1) / a.G;
    const long long BH = static_cast<long long>(a.B) * a.H;
    const unsigned blocks = static_cast<unsigned>(BH * n_groups);
    wkv6_group_states<T><<<blocks, NT, smem1, a.stream>>>(
        static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.lw), a.ds, a.decay, a.ks, a.vs, a.ls,
        a.H, a.T, a.G, n_groups);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wkv6_group_scan<<<static_cast<unsigned>(BH * (D * D / 256)), 256, 0,
                      a.stream>>>(a.ds, a.decay, static_cast<float*>(a.s),
                                  n_groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wkv6_group_outputs<T><<<blocks, NT, smem3, a.stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.lw),
        static_cast<const float*>(a.u), static_cast<T*>(a.y), a.ds, a.rs,
        a.ks, a.vs, a.ls, a.ys, a.usb, a.ush, a.H, a.T, a.G, n_groups);
    return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (r, k, v and y alike; lw and u float32,
// the state float32 and contiguous (B * H, 64, 64)). For each of r, k, v,
// lw and y, three element strides: over b, over h and over t; the last
// (channel) axis is contiguous; u has strides over b and h. K = V = 64.
// G: chunks a group (1-4). ds: float32 scratch of B * H * n_groups * 64 *
// 64, decay: of B * H * n_groups * 64, n_groups = ceil(ceil(T / 64) / G).
// The wrapper checks shapes, strides and alignment. Launches the three
// passes on the caller's stream and returns cudaGetLastError().
extern "C" int wkv6(int dtype, const void* r, const void* k, const void* v,
                    const void* lw, const void* u, void* y, void* s,
                    float* ds, float* decay, const long long* strides,
                    long long usb, long long ush, int B, int H, int T, int G,
                    int device, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (G < 1 || G > 4 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long* q = strides;
    const Args a{r, k, v, lw, u, y, s, ds, decay,
                 {q[0], q[1], q[2]}, {q[3], q[4], q[5]}, {q[6], q[7], q[8]},
                 {q[9], q[10], q[11]}, {q[12], q[13], q[14]},
                 usb, ush, B, H, T, G, stream};
    if (dtype == 0) return static_cast<int>(launch<float>(a));
    if (dtype == 1) return static_cast<int>(launch<bf16>(a));
    return static_cast<int>(cudaErrorInvalidValue);
}
