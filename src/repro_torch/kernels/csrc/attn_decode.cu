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
// The TPU kernel walks a (B, H, Wc / block_w) grid with the (m, l, acc)
// online-softmax triple carried in VMEM across the sequential third axis,
// and its index map reads every KV slab once per query head. Here the
// cache axis is split (flash-decoding): block (split, kv head, request)
// owns `chunk` cache rows and all G query heads of the KV head, so each
// K/V row is read from memory once for the whole group. Blocks whose rows
// all lie at or past len_b do nothing, and the ragged end of the cache (Wc
// need not be a multiple of anything) is the loop bound, so no cache row
// past len_b is read. Scores, exponentials (accurate expf, no fast-math)
// and sums are float32; the output is written in q's dtype. A request with
// len_b = 0 gets 0 / 0 = NaN, as the plain version gives.
//
// Two kernels, picked by dtype:
//
// attn_decode_tc (bf16, head sizes 64, 128, 256; every call of the serve
// path): one launch. A block of 4 warps streams its rows in 64-row K/V
// tiles through a ring of 3 shared-memory stages (2 at head size 256) fed
// by cp.async, so several tiles' bytes are in flight; warp w takes rows
// 16w..16w+15 of each tile. A tile's scores for all G query heads are one
// mma.sync m16n8k16 product (q's G rows padded to 16, bf16 operands,
// float32 sums), scaled in float32, masked at the length; one max and one
// rescale per warp and tile; then O += P_hi.V + P_lo.V (P split into bf16
// hi + lo: a P rounded once to bf16 fails the check's rtol 2^-8), V's
// fragments read with ldmatrix.trans. The warps' triples merge in shared
// memory into one (m, l, acc) partial a block. The last block of a
// (request, KV head) to finish, by an atomic ticket after a fence, merges
// the partials of every split and writes the output, then resets its
// ticket counter to 0 for the next call. Groups of 9-16 query heads
// (RecurrentGemma's 10 at head size 256) fill all 16 rows of the product;
// at head size 256 their fragments of q are read from shared memory each
// tile rather than held in 64 registers beside the 128 of the accumulator.
//
// attn_decode (float32): split and combine. Each of the 4 warps walks
// every 4th row of the chunk, a lane holding dh / 32 elements of the row,
// and keeps an (m, l, acc) triple per query head in registers; the warps
// merge theirs in shared memory and the block writes one float32 partial
// per query head to scratch. A block holds at most 8 query heads at head
// size 256 (16 below), so a larger group runs as several blocks a split.
// A second kernel merges the partials of the splits that hold valid rows. Its limit is rtol 1e-5, which a
// bf16-operand product cannot be shown to meet.
//
// Rank-partial mode (both kernels): where the caller passes out_m, out_l
// and out_acc in place of out, the merge over the splits writes the
// unnormalised float32 triple (acc = sum_w exp(s_w - m) v[w], the row max
// m, the exp-sum l) of each query head instead of acc / l. A sequence-split
// KV cache runs it on each rank's block of the ring's rows (lengths: the
// block's valid rows); a block with no valid row writes m = -inf, l = 0,
// acc = 0. attn_decode_merge merges n such triples of each (request, query
// head) through the split path's combine kernel, the same work as the merge
// over splits: a triple with m = -inf gets weight 0, and n empty triples
// give 0 / 0 = NaN, as a request of length 0 does.
//
// Bound: bytes. A step reads each valid K and V row once: at B = 8,
// Hkv = 8, dh = 128, bf16 and 2,049-2,079 valid rows that is 67-68 MB a
// layer, 0.020 ms at 3.35 TB/s; the partials add B * H * splits * 130
// floats written and read back (0.27 MB at 4 splits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

using bf16 = __nv_bfloat16;
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
    const int split = blockIdx.x % n_split, kvh = blockIdx.y, b = blockIdx.z;
    // the block's query heads: GMAX of the group from g0 (fewer at its end)
    const int g0 = blockIdx.x / n_split * GMAX;
    const int Gc = min(GMAX, G - g0);
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
        if (g < Gc) {
            load_row<E>(q + (static_cast<long long>(b) * H + kvh * G + g0 + g)
                        * DH + lane * E, qr[g]);
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
            if (g >= Gc) break;
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
    for (int i = threadIdx.x; i < Gc * DH; i += kWarps * 32) {
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
        const long long row = (static_cast<long long>(b) * H + kvh * G + g0
                               + g) * n_split + split;
        part_acc[row * DH + d] = A;
        if (d == 0) { part_m[row] = M; part_l[row] = L; }
    }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
    *p = __float2bfloat16(x);
}

// Strides, in floats, of the partials a combine reads: partial s of
// (request, query head) bh has its m and l at bh * ml_bh + s * ml_s and
// its acc row at bh * acc_bh + s * acc_s. The split path writes them
// (bh, s)-major; the rank merge reads the ranks' gathered (s, bh) rows in
// place.
struct PartStrides {
    long long ml_bh, ml_s, acc_bh, acc_s;
};

// Merge the partials of the splits that hold valid rows (all n_split of
// them where lengths is null: the rank merge): one block per (request,
// query head), one thread per output element. A partial with m = -inf
// (an empty block) gets weight 0. Writes acc / l to out, or, where out is
// null, the merged triple to out_acc, out_m and out_l.
template <typename T, int DH>
__global__ void __launch_bounds__(DH) attn_decode_combine(
        const float* __restrict__ part_m, const float* __restrict__ part_l,
        const float* __restrict__ part_acc, const int* __restrict__ lengths,
        T* __restrict__ out, float* __restrict__ out_m,
        float* __restrict__ out_l, float* __restrict__ out_acc, int H,
        int Wc, int chunk, int n_split, PartStrides st) {
    const int bh = blockIdx.x, d = threadIdx.x;
    const int n_valid = lengths == nullptr ? n_split
        : (valid_rows(lengths, bh / H, Wc) + chunk - 1) / chunk;
    const float* pm = part_m + bh * st.ml_bh;
    const float* pl = part_l + bh * st.ml_bh;
    const float* pa = part_acc + bh * st.acc_bh + d;
    float M = -INFINITY;
    for (int s = 0; s < n_valid; ++s) M = fmaxf(M, pm[s * st.ml_s]);
    float L = 0.0f, A = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
        const float c = M == -INFINITY ? 0.0f : expf(pm[s * st.ml_s] - M);
        L = fmaf(c, pl[s * st.ml_s], L);
        A = fmaf(c, pa[s * st.acc_s], A);
    }
    const long long o = static_cast<long long>(bh) * DH + d;
    if (out != nullptr) {
        store(out + o, A / L);
    } else {
        out_acc[o] = A;
        if (d == 0) { out_m[bh] = M; out_l[bh] = L; }
    }
}

struct Args {
    const void *q, *k, *v;
    const int* lengths;
    float *part_m, *part_l, *part_acc;
    void* out;
    float *out_m, *out_l, *out_acc;     // rank-partial mode: out is null
    int B, H, Hkv, Wc, G, chunk, n_split;
    float scale;
    cudaStream_t stream;
};

template <typename T, int DH, int GMAX>
cudaError_t launch(const Args& a) {
    const int n_gc = (a.G + GMAX - 1) / GMAX;    // blocks a (split, kv head)
    const dim3 grid(a.n_split * n_gc, a.Hkv, a.B);
    attn_decode_split<T, DH, GMAX><<<grid, kWarps * 32, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.lengths, a.part_m, a.part_l,
        a.part_acc, a.H, a.Hkv, a.Wc, a.G, a.chunk, a.n_split, a.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const PartStrides st{a.n_split, 1,
                         static_cast<long long>(a.n_split) * DH, DH};
    attn_decode_combine<T, DH><<<a.B * a.H, DH, 0, a.stream>>>(
        a.part_m, a.part_l, a.part_acc, a.lengths, static_cast<T*>(a.out),
        a.out_m, a.out_l, a.out_acc, a.H, a.Wc, a.chunk, a.n_split, st);
    return cudaGetLastError();
}

// GMAX: the smallest of 1, 2, 4, 8, 16 that holds G; the warp-merge
// buffer (4 * GMAX * DH floats) stays within 32 KB of static shared memory.
// At head size 256 a block takes at most 8 query heads: a group of 9-16
// runs as two blocks a (split, kv head), each reading the rows once.
template <typename T, int DH>
cudaError_t by_group(const Args& a) {
    if (a.G > 16) return cudaErrorInvalidValue;
    if (a.G <= 1) return launch<T, DH, 1>(a);
    if (a.G <= 2) return launch<T, DH, 2>(a);
    if (a.G <= 4) return launch<T, DH, 4>(a);
    if (a.G <= 8 || DH > 128) return launch<T, DH, 8>(a);
    if constexpr (DH <= 128) return launch<T, DH, 16>(a);
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

// ---- attn_decode_tc: bf16, one launch, staged tiles, tensor cores -------

constexpr int kTile = 64;       // cache rows a stage
constexpr int kTcThreads = 128;

template <int DH, int GM>
struct TcShape {
    static constexpr int kStages = DH == 256 ? 2 : 3;
    static constexpr int kRow = DH + 8;           // bf16 row stride in smem
    static constexpr int kStage = 2 * kTile * kRow;  // K then V, elements
    // at (256, 16) q's A fragments (64 registers) are read from a padded
    // copy of q's 16 rows in shared memory, after the stages, instead of
    // being held in registers beside the 128 of the accumulator
    static constexpr bool kQSmem = DH == 256 && GM == 16;
    static constexpr int kSmem = (kStages * kStage
                                  + (kQSmem ? 16 * kRow : 0)) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 bf16 matrices, transposed: B fragments of two n8 tiles
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
        : "memory");
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + lo, each a packed bf16 pair (x0 in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 f = __bfloat1622float2(h);
    hi = bf16_bits(h);
    lo = bf16_bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

// d += a b, m16n8k16 (A 16 x 16 row-major, B 16 x 8 column-major). With
// GM = 8 only A's rows 0..7 exist (G <= 8): rows 8..15 are zero and their
// outputs are dropped, so d[2], d[3] stay untouched.
template <int GM>
__device__ __forceinline__ void mma_rows(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    if constexpr (GM == 16) {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    } else {
        float x2, x3;
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%9,%5,%9}, {%6,%7}, {%0,%1,%8,%8};\n"
            : "+f"(d[0]), "+f"(d[1]), "=f"(x2), "=f"(x3)
            : "r"(a[0]), "r"(a[2]), "r"(b0), "r"(b1), "f"(0.0f), "r"(0u));
    }
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
    return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(kFull, x, 1);
    return x + __shfl_xor_sync(kFull, x, 2);
}

// One (split, kv head, request). GM: 8 when G <= 8, else 16.
template <int DH, int GM>
__global__ void __launch_bounds__(kTcThreads) attn_decode_tc_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const int* __restrict__ lengths,
        float* __restrict__ part_m, float* __restrict__ part_l,
        float* __restrict__ part_acc, int* __restrict__ tickets,
        bf16* __restrict__ out, float* __restrict__ out_m,
        float* __restrict__ out_l, float* __restrict__ out_acc, int H,
        int Hkv, int Wc, int G, int chunk, int n_split, float scale) {
    using S = TcShape<DH, GM>;
    constexpr int KS = DH / 16, ND = DH / 8;
    extern __shared__ float4 smem4[];
    bf16* stages = reinterpret_cast<bf16*>(smem4);
    __shared__ int s_last;

    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int len = valid_rows(lengths, b, Wc);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long head0 = static_cast<long long>(b) * H
                            + static_cast<long long>(kvh) * G;
    if (len == 0) {         // 0 / 0, as the plain version; or the empty triple
        if (split == 0) {
            for (int i = tid; i < G * DH; i += kTcThreads) {
                if (out != nullptr) {
                    out[head0 * DH + i] = __float2bfloat16(nanf(""));
                } else {
                    out_acc[head0 * DH + i] = 0.0f;
                    if (i % DH == 0) {
                        out_m[head0 + i / DH] = -INFINITY;
                        out_l[head0 + i / DH] = 0.0f;
                    }
                }
            }
        }
        return;
    }
    const int n_valid = (len + chunk - 1) / chunk;
    if (split >= n_valid) return;
    const int start = split * chunk, end = min(start + chunk, len);
    const int n_tiles = (end - start + kTile - 1) / kTile;
    const long long kv0 = (static_cast<long long>(b) * Hkv + kvh) * Wc;
    const bf16* kb = k + kv0 * DH;
    const bf16* vb = v + kv0 * DH;

    auto load_tile = [&](int slot, int row0) {
        bf16* ks = stages + slot * S::kStage;
        bf16* vs = ks + kTile * S::kRow;
        for (int idx = tid; idx < kTile * (DH / 8); idx += kTcThreads) {
            const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
            const bool ok = row0 + r < end;
            const long long off = ok ? static_cast<long long>(row0 + r) * DH + c
                                     : 0;
            cp_async16(smem_addr(ks + r * S::kRow + c), kb + off, ok);
            cp_async16(smem_addr(vs + r * S::kRow + c), vb + off, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < S::kStages - 1; ++s) {
        if (s < n_tiles) load_tile(s, start + s * kTile);
        cp_commit();
    }

    // q's A fragments: rows g (and g + 8) are query heads kvh * G + row;
    // in registers, or at (256, 16) rows of a zero-padded copy in smem
    uint32_t qa[S::kQSmem ? 1 : KS][4];
    bf16* qs = stages + S::kStages * S::kStage;
    if constexpr (S::kQSmem) {
        const bf16* q0 = q + head0 * DH;
        for (int idx = tid; idx < 16 * (DH / 8); idx += kTcThreads) {
            const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
            const uint4 val = r < G
                ? *reinterpret_cast<const uint4*>(q0 + r * DH + c)
                : make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(qs + r * S::kRow + c) = val;
        }
    } else {
        const bf16* q0 = q + head0 * DH;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const int c = 16 * ks + 2 * t;
            qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(q0 + g * DH + c) : 0u;
            qa[ks][2] = g < G ? *reinterpret_cast<const uint32_t*>(q0 + g * DH + c + 8) : 0u;
            qa[ks][1] = qa[ks][3] = 0u;
            if constexpr (GM == 16) {
                if (g + 8 < G) {
                    qa[ks][1] = *reinterpret_cast<const uint32_t*>(q0 + (g + 8) * DH + c);
                    qa[ks][3] = *reinterpret_cast<const uint32_t*>(q0 + (g + 8) * DH + c + 8);
                }
            }
        }
    }

    // the warp's online softmax: rows g and g + 8; l is the lane's part
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_wait<S::kStages - 2>();
        __syncthreads();
        const int nxt = tile + S::kStages - 1;
        if (nxt < n_tiles) load_tile(nxt % S::kStages, start + nxt * kTile);
        cp_commit();

        const bf16* ks = stages + (tile % S::kStages) * S::kStage;
        const bf16* vs = ks + kTile * S::kRow;
        const int row0 = start + tile * kTile + 16 * w;   // the warp's rows
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
            uint32_t a[4];
            if constexpr (S::kQSmem) {
                const bf16* qr = qs + g * S::kRow + 16 * s + 2 * t;
                a[0] = *reinterpret_cast<const uint32_t*>(qr);
                a[1] = *reinterpret_cast<const uint32_t*>(qr + 8 * S::kRow);
                a[2] = *reinterpret_cast<const uint32_t*>(qr + 8);
                a[3] = *reinterpret_cast<const uint32_t*>(qr + 8 * S::kRow + 8);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) a[e] = qa[s][e];
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const bf16* kr = ks + (16 * w + 8 * n + g) * S::kRow + 2 * t
                                 + 16 * s;
                mma_rows<GM>(sc[n], a, *reinterpret_cast<const uint32_t*>(kr),
                             *reinterpret_cast<const uint32_t*>(kr + 8));
            }
        }
        // scale in float32; rows at or past the length are -inf
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                sc[n][e] = row0 + 8 * n + 2 * t + (e & 1) < end
                               ? sc[n][e] * scale : -INFINITY;
        const float mn0 = fmaxf(m0, quad_max(fmaxf(fmaxf(sc[0][0], sc[0][1]),
                                                   fmaxf(sc[1][0], sc[1][1]))));
        const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
        const float a0 = expf(m0 - mu0);
        m0 = mn0;
        float a1 = 1.0f, mu1 = 0.0f;
        if constexpr (GM == 16) {
            const float mn1 = fmaxf(m1, quad_max(fmaxf(fmaxf(sc[0][2], sc[0][3]),
                                                       fmaxf(sc[1][2], sc[1][3]))));
            mu1 = mn1 == -INFINITY ? 0.0f : mn1;
            a1 = expf(m1 - mu1);
            m1 = mn1;
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            sc[n][0] = expf(sc[n][0] - mu0);
            sc[n][1] = expf(sc[n][1] - mu0);
            if constexpr (GM == 16) {
                sc[n][2] = expf(sc[n][2] - mu1);
                sc[n][3] = expf(sc[n][3] - mu1);
            }
        }
        l0 = l0 * a0 + (sc[0][0] + sc[0][1] + sc[1][0] + sc[1][1]);
        if constexpr (GM == 16)
            l1 = l1 * a1 + (sc[0][2] + sc[0][3] + sc[1][2] + sc[1][3]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            acc[n][0] *= a0;
            acc[n][1] *= a0;
            if constexpr (GM == 16) {
                acc[n][2] *= a1;
                acc[n][3] *= a1;
            }
        }
        // O += P_hi V + P_lo V; P's score fragments are A's layout
        uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
        split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
        split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
        if constexpr (GM == 16) {
            split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
            split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
        }
        const uint32_t vaddr = smem_addr(
            vs + (16 * w + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::kRow
            + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
            uint32_t bv[4];
            ldsm_x4_t(bv, vaddr + dp * 32);
            mma_rows<GM>(acc[2 * dp], ph, bv[0], bv[1]);
            mma_rows<GM>(acc[2 * dp], pl, bv[0], bv[1]);
            mma_rows<GM>(acc[2 * dp + 1], ph, bv[2], bv[3]);
            mma_rows<GM>(acc[2 * dp + 1], pl, bv[2], bv[3]);
        }
    }
    cp_wait<0>();
    __syncthreads();                              // the stages are free

    // merge the warps' triples in shared memory; warp 0 saw row `start`,
    // so the block's M is finite
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    float* sm_acc = reinterpret_cast<float*>(smem4);        // [4][GM][DH]
    float* sm_m = sm_acc + 4 * GM * DH;                     // [4][GM]
    float* sm_l = sm_m + 4 * GM;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        const int c = 8 * n + 2 * t;
        sm_acc[(w * GM + g) * DH + c] = acc[n][0];
        sm_acc[(w * GM + g) * DH + c + 1] = acc[n][1];
        if constexpr (GM == 16) {
            sm_acc[(w * GM + g + 8) * DH + c] = acc[n][2];
            sm_acc[(w * GM + g + 8) * DH + c + 1] = acc[n][3];
        }
    }
    if (t == 0) {
        sm_m[w * GM + g] = m0;
        sm_l[w * GM + g] = l0;
        if constexpr (GM == 16) {
            sm_m[w * GM + g + 8] = m1;
            sm_l[w * GM + g + 8] = l1;
        }
    }
    __syncthreads();
    for (int i = tid; i < G * DH; i += kTcThreads) {
        const int gq = i / DH, d = i % DH;
        float M = sm_m[gq];
#pragma unroll
        for (int ww = 1; ww < 4; ++ww) M = fmaxf(M, sm_m[ww * GM + gq]);
        float L = 0.0f, A = 0.0f;
#pragma unroll
        for (int ww = 0; ww < 4; ++ww) {
            const float c = expf(sm_m[ww * GM + gq] - M);  // 0 for an idle warp
            L = fmaf(c, sm_l[ww * GM + gq], L);
            A = fmaf(c, sm_acc[(ww * GM + gq) * DH + d], A);
        }
        const long long row = (head0 + gq) * n_split + split;
        part_acc[row * DH + d] = A;
        if (d == 0) {
            part_m[row] = M;
            part_l[row] = L;
        }
    }

    // the last block of this (request, kv head) merges every split
    __threadfence();
    __syncthreads();
    int* ticket = tickets + static_cast<long long>(b) * Hkv + kvh;
    if (tid == 0) s_last = atomicAdd(ticket, 1) == n_valid - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int i = tid; i < G * DH; i += kTcThreads) {
        const int gq = i / DH, d = i % DH;
        const long long row0 = (head0 + gq) * n_split;
        float M = -INFINITY;
        for (int s = 0; s < n_valid; ++s) M = fmaxf(M, __ldcg(part_m + row0 + s));
        float L = 0.0f, A = 0.0f;
        for (int s = 0; s < n_valid; ++s) {
            const float c = expf(__ldcg(part_m + row0 + s) - M);
            L = fmaf(c, __ldcg(part_l + row0 + s), L);
            A = fmaf(c, __ldcg(part_acc + (row0 + s) * DH + d), A);
        }
        if (out != nullptr) {
            out[(head0 + gq) * DH + d] = __float2bfloat16(A / L);
        } else {
            out_acc[(head0 + gq) * DH + d] = A;
            if (d == 0) {
                out_m[head0 + gq] = M;
                out_l[head0 + gq] = L;
            }
        }
    }
    if (tid == 0) *ticket = 0;                    // ready for the next call
}

struct TcArgs {
    const bf16 *q, *k, *v;
    const int* lengths;
    float *part_m, *part_l, *part_acc;
    int* tickets;
    bf16* out;
    float *out_m, *out_l, *out_acc;     // rank-partial mode: out is null
    int B, H, Hkv, Wc, G, chunk, n_split;
    float scale;
    cudaStream_t stream;
};

template <int DH, int GM>
cudaError_t launch_tc(const TcArgs& a) {
    using S = TcShape<DH, GM>;
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            attn_decode_tc_kernel<DH, GM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const dim3 grid(a.n_split, a.Hkv, a.B);
    attn_decode_tc_kernel<DH, GM><<<grid, kTcThreads, S::kSmem, a.stream>>>(
        a.q, a.k, a.v, a.lengths, a.part_m, a.part_l, a.part_acc, a.tickets,
        a.out, a.out_m, a.out_l, a.out_acc, a.H, a.Hkv, a.Wc, a.G, a.chunk,
        a.n_split, a.scale);
    return cudaGetLastError();
}

template <int DH>
cudaError_t tc_by_group(const TcArgs& a) {
    if (a.G <= 8) return launch_tc<DH, 8>(a);
    if (a.G <= 16) return launch_tc<DH, 16>(a);
    return cudaErrorInvalidValue;
}

}  // namespace

// float32 q, k, v and out. out null: the rank-partial mode, which writes
// the float32 triple to out_m, out_l (B * H) and out_acc (B * H * dh).
// The wrapper checks shapes, alignment and the supported (dh, G); an
// unsupported pair returns cudaErrorInvalidValue. Launches both kernels on
// the caller's stream and returns cudaGetLastError().
extern "C" int attn_decode(const void* q, const void* k,
                           const void* v, const int* lengths, float* part_m,
                           float* part_l, float* part_acc, void* out,
                           float* out_m, float* out_l, float* out_acc, int B,
                           int H, int Hkv, int Wc, int dh, int chunk,
                           int n_split, float scale, int device,
                           cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Args a{q, k, v, lengths, part_m, part_l, part_acc, out, out_m,
                 out_l, out_acc, B, H, Hkv, Wc, H / Hkv, chunk, n_split,
                 scale, stream};
    return static_cast<int>(by_head_dim<float>(dh, a));
}

// bf16 q, k, v and out; head sizes 64, 128 and 256; G <= 16.
// chunk: cache rows a split, a multiple of 64. part_*: float32 scratch of
// B * H * n_split (m, l) and B * H * n_split * dh (acc). tickets: B * Hkv
// int32, zero before the call and zero after it. The wrapper checks
// shapes, alignment and the supported (dh, G); an unsupported pair returns
// cudaErrorInvalidValue. out null: the rank-partial mode (float32 out_m,
// out_l, out_acc as for attn_decode). One launch on the caller's stream;
// returns cudaGetLastError().
extern "C" int attn_decode_tc(const void* q, const void* k, const void* v,
                              const int* lengths, float* part_m,
                              float* part_l, float* part_acc, int* tickets,
                              void* out, float* out_m, float* out_l,
                              float* out_acc, int B, int H, int Hkv, int Wc,
                              int dh, int chunk, int n_split, float scale,
                              int device, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (chunk % kTile) return static_cast<int>(cudaErrorInvalidValue);
    const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), lengths, part_m, part_l,
                   part_acc, tickets, static_cast<bf16*>(out), out_m, out_l,
                   out_acc, B, H, Hkv, Wc, H / Hkv, chunk, n_split, scale,
                   stream};
    switch (dh) {
        case 64: return static_cast<int>(tc_by_group<64>(a));
        case 128: return static_cast<int>(tc_by_group<128>(a));
        case 256: return static_cast<int>(tc_by_group<256>(a));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Merge n rank-partial triples of each of BH (request, query head) rows:
// float32 part_m, part_l and part_acc (dh floats a row) at the strides
// (in floats) ml_bh, ml_s, acc_bh, acc_s of PartStrides -> out (BH * dh)
// in float32 (dtype 0) or bf16 (dtype 1), through the combine kernel of
// the split path. One launch on the caller's stream; returns
// cudaGetLastError().
extern "C" int attn_decode_merge(const float* part_m, const float* part_l,
                                 const float* part_acc, void* out, int dtype,
                                 int BH, int n, int dh, long long ml_bh,
                                 long long ml_s, long long acc_bh,
                                 long long acc_s, int device,
                                 cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (BH <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    auto go = [&](auto tag, auto dh_tag) {
        using T = decltype(tag);
        constexpr int DH = decltype(dh_tag)::value;
        attn_decode_combine<T, DH><<<BH, DH, 0, stream>>>(
            part_m, part_l, part_acc, nullptr, static_cast<T*>(out), nullptr,
            nullptr, nullptr, 1, 0, 1, n,
            PartStrides{ml_bh, ml_s, acc_bh, acc_s});
        return cudaGetLastError();
    };
    using D64 = std::integral_constant<int, 64>;
    using D128 = std::integral_constant<int, 128>;
    using D256 = std::integral_constant<int, 256>;
    if (dtype != 0 && dtype != 1)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (dh) {
        case 64: return static_cast<int>(dtype ? go(bf16{}, D64{})
                                               : go(0.0f, D64{}));
        case 128: return static_cast<int>(dtype ? go(bf16{}, D128{})
                                                : go(0.0f, D128{}));
        case 256: return static_cast<int>(dtype ? go(bf16{}, D256{})
                                                : go(0.0f, D256{}));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
