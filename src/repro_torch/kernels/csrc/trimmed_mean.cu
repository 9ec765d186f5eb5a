// Coordinate-wise trimmed mean for Hopper (sm_90a): Algorithm 2's
// extreme-value filter applied to every gradient coordinate over a worker
// axis, the robust aggregation of decentralized training.
//
// Replaces the TPU kernel trimmed_mean_pallas in
// src/repro/kernels/trimmed_mean/trimmed_mean.py. For x (W, D) float32
// and every coordinate d independently:
//
//     drop the F largest of x[:, d] and the F smallest, and
//     out[d] = (sum of the W - 2F survivors) / (W - 2F)
//
// F = 0 is the plain mean sum / W. The order is IEEE's with NaN above
// +inf, as a sort puts it, so the survivors are the multiset of a sorted
// column's ranks F .. W-F-1 and the result is the plain version's (a NaN
// or inf that survives the trim makes the coordinate NaN or inf there
// too).
//
// Design. The TPU kernel streams (W, 2048) blocks through VMEM and runs F
// argmax/argmin rounds over the whole block. Here one thread owns CPT
// consecutive coordinates and reads them from each worker row with one
// vector load, so a warp reads 32 * CPT * 4 contiguous bytes a row. The
// W x CPT values stay in a register array of compile-time size WMAX (4,
// 8, 16, 32 or 64, the smallest that holds W; the wrapper raises above
// 64): CPT is 4 up to 32 workers and 2 at 64, so a thread holds at most
// 128 values. F is a runtime argument.
//
// The trim has no data-dependent branch and no serial chain. Each value
// becomes a 32-bit key whose unsigned order is the sort order: every NaN
// first becomes the one positive quiet NaN (a NaN with its sign bit set
// would sort below -inf), then the key is bits ^ ((bits >> 31) | 2^31),
// the shift arithmetic, which flips a positive value's sign bit and every
// bit of a negative one; -0 sorts just below +0. The slots W .. WMAX-1
// hold the largest key, above the NaN's. A compile-time sorting network
// (Batcher's odd-even merge sort: 19 compare-exchanges of depth 6 at 8
// slots, 543 at 64) sorts the keys in registers with unsigned min / max,
// and the sum runs over ranks F .. W-F-1 in rank order, the order of the
// plain version's sort(...)[F:W-F], each key decoded back to its value bit
// for bit. Survivors are summed, never taken as total minus extremes,
// which cancels when a Byzantine row is ~1e6 times the honest scale. F = 0
// skips the keys and sums in worker order. Rows are read through a row
// stride, so a column range of a larger buffer goes in without a copy;
// where the base or the stride is not aligned to the vector, or at the
// ragged end of D, the thread reads scalars instead.
//
// Bound: bytes. Each call reads W * D floats and writes D; at W = 8 and
// D = 99.5 M that is 3.58 GB, 1.07 ms at 3.35 TB/s. At W = 8 the trim
// costs about 100 integer and float instructions a coordinate (8 keys, 38
// min / max, 8 decodes and predicated adds), some 0.3 ms of instruction
// issue over the card, under the bytes' time.

#include <cuda_runtime.h>
#include <math.h>

#include <utility>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---- Batcher's odd-even merge sort on n = 2^k slots ------------------------
// The network's compare-exchanges in the order of Knuth's loops (TAOCP
// 5.3.4, Algorithm M): for each merge size p and stride k, the pairs
// (i + j, i + j + k) that lie in one block of 2p. Evaluated at compile
// time, so every index into the key array is a constant.

struct Pair { int a, b; };

__host__ __device__ constexpr int batcher_size(int n) {
    int count = 0;
    for (int p = 1; p < n; p <<= 1)
        for (int k = p; k >= 1; k >>= 1)
            for (int j = k % p; j + k < n; j += 2 * k)
                for (int i = 0; i < k && i + j + k < n; ++i)
                    if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) ++count;
    return count;
}

__host__ __device__ constexpr Pair batcher_pair(int n, int index) {
    int count = 0;
    for (int p = 1; p < n; p <<= 1)
        for (int k = p; k >= 1; k >>= 1)
            for (int j = k % p; j + k < n; j += 2 * k)
                for (int i = 0; i < k && i + j + k < n; ++i)
                    if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
                        if (count == index) return Pair{i + j, i + j + k};
                        ++count;
                    }
    return Pair{0, 0};
}

template <int N, int I>
__device__ __forceinline__ void compare_exchange(unsigned (&k)[N]) {
    constexpr Pair p = batcher_pair(N, I);
    static_assert(p.a < p.b && p.b < N, "a compare-exchange out of range");
    const unsigned lo = min(k[p.a], k[p.b]);
    k[p.b] = max(k[p.a], k[p.b]);
    k[p.a] = lo;
}

template <int N, int... I>
__device__ __forceinline__ void run_network(unsigned (&k)[N],
                                            std::integer_sequence<int, I...>) {
    (compare_exchange<N, I>(k), ...);
}

// sort N keys ascending in registers
template <int N>
__device__ __forceinline__ void sort_keys(unsigned (&k)[N]) {
    run_network<N>(k, std::make_integer_sequence<int, batcher_size(N)>{});
}

// ---- ordered keys ----------------------------------------------------------

__device__ __forceinline__ unsigned order_key(float v) {
    const unsigned b = isnan(v) ? 0x7fc00000u : __float_as_uint(v);
    return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31)
                | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
    return __uint_as_float(
        k ^ (static_cast<unsigned>(static_cast<int>(~k) >> 31) | 0x80000000u));
}

// CPT consecutive floats in one aligned vector load or store
template <int CPT> struct Vec;
template <> struct Vec<4> {
    __device__ static void load(const float* p, float (&v)[4]) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    }
    __device__ static void store(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Vec<2> {
    __device__ static void load(const float* p, float (&v)[2]) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x; v[1] = t.y;
    }
    __device__ static void store(float* p, const float (&v)[2]) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
};

template <int WMAX, int CPT>
__device__ __forceinline__ float trim_one(const float (&v)[WMAX][CPT], int j,
                                          int W, int F) {
    float s = 0.0f;
    if (F == 0) {                              // the plain mean
#pragma unroll
        for (int w = 0; w < WMAX; ++w)
            if (w < W) s += v[w][j];
        return s / static_cast<float>(W);
    }
    unsigned k[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        k[w] = w < W ? order_key(v[w][j]) : 0xffffffffu;
    sort_keys<WMAX>(k);
#pragma unroll
    for (int r = 0; r < WMAX; ++r)
        if (r >= F && r < W - F) s += key_value(k[r]);
    return s / static_cast<float>(W - 2 * F);
}

template <int WMAX, int CPT>
__global__ void __launch_bounds__(128)
trimmed_mean_kernel(const float* __restrict__ x, long long ld, long long D,
                    int W, int F, float* __restrict__ out, int vec_in,
                    int vec_out) {
    const long long c0 = (blockIdx.x * static_cast<long long>(blockDim.x)
                          + threadIdx.x) * CPT;
    if (c0 >= D) return;
    const int n = D - c0 < CPT ? static_cast<int>(D - c0) : CPT;

    float v[WMAX][CPT];
    if (vec_in && n == CPT) {
#pragma unroll
        for (int w = 0; w < WMAX; ++w)
            if (w < W) Vec<CPT>::load(x + w * ld + c0, v[w]);
    } else {
#pragma unroll
        for (int w = 0; w < WMAX; ++w) {
#pragma unroll
            for (int j = 0; j < CPT; ++j)
                v[w][j] = (w < W && j < n) ? x[w * ld + c0 + j] : 0.0f;
        }
    }

    float r[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) r[j] = trim_one<WMAX, CPT>(v, j, W, F);

    if (vec_out && n == CPT) {
        Vec<CPT>::store(out + c0, r);
    } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j)
            if (j < n) out[c0 + j] = r[j];
    }
}

template <int WMAX, int CPT>
cudaError_t launch(const float* x, long long ld, long long D, int W, int F,
                   float* out, cudaStream_t stream) {
    const int threads = 128;
    const long long groups = (D + CPT - 1) / CPT;
    const long long blocks = (groups + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int vec_in = (reinterpret_cast<unsigned long long>(x)
                        % (4 * CPT) == 0) && (ld % CPT == 0);
    const int vec_out = reinterpret_cast<unsigned long long>(out)
                        % (4 * CPT) == 0;
    trimmed_mean_kernel<WMAX, CPT><<<static_cast<unsigned>(blocks), threads,
                                     0, stream>>>(x, ld, D, W, F, out,
                                                  vec_in, vec_out);
    return cudaGetLastError();
}

// x: W rows of D floats, row r at x + r * ld; out: D floats. Returns a
// cudaError_t (0 on success) of the launch.
extern "C" int trimmed_mean_f32(const float* x, long long ld, long long D,
                                int W, int F, float* out, int device,
                                cudaStream_t stream) {
    if (D < 1 || W < 1 || W > 64 || F < 0 || W <= 2 * F || ld < D)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (W <= 4) err = launch<4, 4>(x, ld, D, W, F, out, stream);
    else if (W <= 8) err = launch<8, 4>(x, ld, D, W, F, out, stream);
    else if (W <= 16) err = launch<16, 4>(x, ld, D, W, F, out, stream);
    else if (W <= 32) err = launch<32, 4>(x, ld, D, W, F, out, stream);
    else err = launch<64, 2>(x, ld, D, W, F, out, stream);
    return static_cast<int>(err);
}
