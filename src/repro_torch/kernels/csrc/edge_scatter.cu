// Push-sum edge scatter for Hopper (sm_90a): the delivery and integration
// half of one robust push-sum round.
//
// Replaces the TPU kernel edge_scatter_pallas in
// src/repro/kernels/pushsum_edge/pushsum_edge.py. Per directed edge e
// (src[e] -> receiver v) and column c of D = d + 1 (value columns, then
// the mass column):
//
//     rho_new[e, c] = live[e] ? sigma[src[e], c] : rho[e, c]
//     recv[v, c]    = sum over v's in-edges e of (rho_new[e, c] - rho[e, c])
//
// The TPU kernel keeps one resident recv that a sequential grid
// accumulates into; CUDA blocks run concurrently and in no order, so that
// design does not carry over. Here the edge index is dst-sorted and its
// CSR offsets (offsets[v] .. offsets[v + 1], the in-edge run of v) are
// built once on the host. Each receiver's increments are added in edge
// order, from 0, in float32, in one thread: there are no atomics, so the
// result is deterministic, and every sum stays local to its run; a global
// prefix sum with boundary differences would cancel catastrophically once
// the mass decays (the z / m ratio amplifies absolute error by 1 / m).
// Padding edges (valid = False, so live = False) add exactly 0. rho is
// not updated in place: rho_new is a separate output. Two kernels, by D:
//
// edge_scatter_tiled (D <= TILED_D_MAX; the engines, D = m + 1): a block
// owns RB = 256 / D consecutive receivers and so one contiguous range of
// edges, which it takes in tiles of TILE_FLOATS / D edges. In a tile the
// threads stride over the edges: each reads src[e], live[e] and rho[e, :]
// once (one 16-byte vector a row where D is a multiple of 4 and the rows
// are aligned), gathers sigma[src[e], :] where the edge is live, writes
// rho_new[e, :] and puts the increments into shared memory. Then thread
// (receiver, column) adds its run's increments that lie in the tile, in
// edge order, carrying its sum into the next tile, and writes recv once.
// A warp's loads are contiguous runs of 512 bytes.
//
// edge_scatter_walk (wide D; the training aggregator pushsum_sparse, 8
// workers and up to 2^24 + 1 columns): one thread owns one (receiver,
// column) pair and walks the run, so a warp reads 32 consecutive columns
// of one edge row, coalesced as they are.
//
// Both give the same recv bit for bit: the same float32 subtractions,
// added in the same order.
//
// Storage. Both kernels are templates on the storage type T of sigma, rho
// and rho_new: float, or __nv_bfloat16 / __half for the precision
// policy's half storage (edge_scatter_half). The latch copies T's bits;
// each increment is float(rho_new) - float(rho), exact conversions of the
// 16 stored bits and one float32 subtraction, and recv, the shared-memory increments and the
// edge-order sums stay float32, so a half recv is bit-equal to the
// float32 edge-order sum of the storage differences. A row moves as one
// vector of 4 elements where D is a multiple of 4 and the rows are
// aligned to it (16 bytes of float, 8 of a half type: D = 4's bf16 row),
// else element by element (D = 5's 10-byte bf16 row).
//
// Bound: bytes. Per round the kernel reads sigma, rho, live, src and the
// offsets and writes rho_new and recv, two to three flops per element; at
// E = 917,504, D = 4, N = 131,072 that is about 39 MB in all in float32
// and 23 MB with half storage.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int THREADS = 256;
constexpr int TILED_D_MAX = 32;       // receivers a block: 256 / D >= 8
constexpr int TILE_FLOATS = 2048;     // a tile's increments: 8 KB

// A storage type's values as the kernels move them: Bits (float, or the
// 16 bits of a half type), and their exact float32 value.
template <typename T> struct Storage;
template <> struct Storage<float> {
    using Bits = float;
    __device__ static float value(float b) { return b; }
};
template <> struct Storage<__nv_bfloat16> {
    using Bits = unsigned short;
    __device__ static float value(unsigned short b) {
        return __uint_as_float(static_cast<unsigned>(b) << 16);
    }
};
template <> struct Storage<__half> {
    using Bits = unsigned short;
    __device__ static float value(unsigned short b) {
        return __half2float(__ushort_as_half(b));
    }
};

// VEC consecutive elements of a row as one vector: 16 bytes of float, 8
// bytes of a half type; or one element
template <typename B, int VEC> struct Row;
template <> struct Row<float, 4> {
    __device__ static void load(const float* p, float (&v)[4]) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    }
    __device__ static void store(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Row<unsigned short, 4> {
    __device__ static void load(const unsigned short* p,
                                unsigned short (&v)[4]) {
        const uint2 t = *reinterpret_cast<const uint2*>(p);
        v[0] = t.x & 0xffffu; v[1] = t.x >> 16;
        v[2] = t.y & 0xffffu; v[3] = t.y >> 16;
    }
    __device__ static void store(unsigned short* p,
                                 const unsigned short (&v)[4]) {
        *reinterpret_cast<uint2*>(p) = make_uint2(
            v[0] | (static_cast<unsigned>(v[1]) << 16),
            v[2] | (static_cast<unsigned>(v[3]) << 16));
    }
};
template <typename B> struct Row<B, 1> {
    __device__ static void load(const B* p, B (&v)[1]) { v[0] = *p; }
    __device__ static void store(B* p, const B (&v)[1]) { *p = v[0]; }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
edge_scatter_tiled(const typename Storage<T>::Bits* __restrict__ sigma,
                   const typename Storage<T>::Bits* __restrict__ rho,
                   const bool* __restrict__ live,
                   const int* __restrict__ src,
                   const int* __restrict__ offsets,
                   typename Storage<T>::Bits* __restrict__ rho_new,
                   float* __restrict__ recv, int n, int D) {
    using B = typename Storage<T>::Bits;
    __shared__ __align__(16) float inc[TILE_FLOATS];
    const int rb = THREADS / D;
    const int v0 = blockIdx.x * rb;
    const int v1 = min(v0 + rb, n);
    const int e0 = offsets[v0];
    const int e1 = offsets[v1];
    // this thread's (receiver, column) of the sums, if it has one
    const int v = v0 + threadIdx.x / D;
    const int c = threadIdx.x % D;
    const bool sums = threadIdx.x < rb * D && v < v1;
    const int lo = sums ? offsets[v] : 0;
    const int hi = sums ? offsets[v + 1] : 0;
    const int per_edge = D / VEC;
    const int tile = TILE_FLOATS / D;
    float acc = 0.0f;
    for (int t0 = e0; t0 < e1; t0 += tile) {
        const int t1 = min(t0 + tile, e1);
        for (int i = threadIdx.x; i < (t1 - t0) * per_edge; i += THREADS) {
            const int e = t0 + i / per_edge;
            const int col = (i % per_edge) * VEC;
            const long long ec = static_cast<long long>(e) * D + col;
            B old[VEC], val[VEC];
            Row<B, VEC>::load(rho + ec, old);
            if (live[e]) {
                Row<B, VEC>::load(sigma + static_cast<long long>(src[e]) * D
                                  + col, val);
            } else {
#pragma unroll
                for (int j = 0; j < VEC; ++j) val[j] = old[j];
            }
            Row<B, VEC>::store(rho_new + ec, val);
            float d[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                d[j] = Storage<T>::value(val[j]) - Storage<T>::value(old[j]);
            Row<float, VEC>::store(inc + (e - t0) * D + col, d);
        }
        __syncthreads();
        for (int e = max(lo, t0); e < min(hi, t1); ++e)
            acc += inc[(e - t0) * D + c];
        __syncthreads();
    }
    if (sums) recv[static_cast<long long>(v) * D + c] = acc;
}

template <typename T>
__global__ void edge_scatter_walk(
        const typename Storage<T>::Bits* __restrict__ sigma,
        const typename Storage<T>::Bits* __restrict__ rho,
        const bool* __restrict__ live, const int* __restrict__ src,
        const int* __restrict__ offsets,
        typename Storage<T>::Bits* __restrict__ rho_new,
        float* __restrict__ recv, int n, int D) {
    using B = typename Storage<T>::Bits;
    const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
    if (i >= static_cast<long long>(n) * D) return;
    const int v = static_cast<int>(i / D);
    const int c = static_cast<int>(i % D);
    const int hi = offsets[v + 1];
    float acc = 0.0f;
    for (int e = offsets[v]; e < hi; ++e) {
        const long long ec = static_cast<long long>(e) * D + c;
        const B old = rho[ec];
        const B val = live[e]
            ? sigma[static_cast<long long>(src[e]) * D + c] : old;
        rho_new[ec] = val;
        acc += Storage<T>::value(val) - Storage<T>::value(old);
    }
    recv[i] = acc;
}

template <typename T>
static bool aligned_rows(const void* p) {
    return reinterpret_cast<unsigned long long>(p) % (4 * sizeof(T)) == 0;
}

template <typename T>
static int launch(const void* sigma_p, const void* rho_p, const bool* live,
                  const int* src, const int* offsets, void* rho_new_p,
                  float* recv, int n, int D, int tiled, int device,
                  cudaStream_t stream) {
    using B = typename Storage<T>::Bits;
    const B* sigma = static_cast<const B*>(sigma_p);
    const B* rho = static_cast<const B*>(rho_p);
    B* rho_new = static_cast<B*>(rho_new_p);
    if (n < 1 || D < 1 || (tiled && D > TILED_D_MAX))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tiled) {
        const unsigned blocks = static_cast<unsigned>(
            (n + THREADS / D - 1) / (THREADS / D));
        if (D % 4 == 0 && aligned_rows<T>(sigma) && aligned_rows<T>(rho)
                && aligned_rows<T>(rho_new)) {
            edge_scatter_tiled<T, 4><<<blocks, THREADS, 0, stream>>>(
                sigma, rho, live, src, offsets, rho_new, recv, n, D);
        } else {
            edge_scatter_tiled<T, 1><<<blocks, THREADS, 0, stream>>>(
                sigma, rho, live, src, offsets, rho_new, recv, n, D);
        }
    } else {
        const long long work = static_cast<long long>(n) * D;
        const unsigned blocks = static_cast<unsigned>((work + THREADS - 1)
                                                      / THREADS);
        edge_scatter_walk<T><<<blocks, THREADS, 0, stream>>>(
            sigma, rho, live, src, offsets, rho_new, recv, n, D);
    }
    return static_cast<int>(cudaGetLastError());
}

// tiled: 1 for edge_scatter_tiled (needs D <= TILED_D_MAX), 0 for
// edge_scatter_walk. Launches on the caller's stream and returns
// cudaGetLastError().
extern "C" int edge_scatter_f32(const float* sigma, const float* rho,
                                const bool* live, const int* src,
                                const int* offsets, float* rho_new,
                                float* recv, int n, int D, int tiled,
                                int device, cudaStream_t stream) {
    return launch<float>(sigma, rho, live, src, offsets, rho_new, recv, n,
                         D, tiled, device, stream);
}

// The same on half storage: sigma, rho and rho_new of storage 1
// (__nv_bfloat16) or 2 (__half), recv float32.
extern "C" int edge_scatter_half(const void* sigma, const void* rho,
                                 const bool* live, const int* src,
                                 const int* offsets, void* rho_new,
                                 float* recv, int n, int D, int tiled,
                                 int device, int storage,
                                 cudaStream_t stream) {
    if (storage == 1)
        return launch<__nv_bfloat16>(sigma, rho, live, src, offsets, rho_new,
                                     recv, n, D, tiled, device, stream);
    if (storage == 2)
        return launch<__half>(sigma, rho, live, src, offsets, rho_new, recv,
                              n, D, tiled, device, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
