// Byzantine trim-gather for Hopper (sm_90a): the gossip half of one
// Algorithm 2 round.
//
// Replaces the TPU kernel trim_gather_pallas in
// src/repro/kernels/byz_trim/byz_trim.py. Per receiver j of the padded
// in-neighbor lists (deg_max slots) and pair coordinate p of P:
//
//     vals[k] = byz_nbr[j, k] ? byz_msgs[j, k, p] : r[nbr_idx[j, k], p]
//     drop invalid slots, then the F largest and the F smallest values
//     tsum[j, p] = sum of the survivors;  kept[j] = max(deg_j - 2F, 0)
//
// F is one count for every receiver, or F[j], receiver j's own (a grid of
// scenarios stacked into one graph trims each scenario's receivers by its
// own F).
//
// The order is IEEE's with every NaN above +inf, as a sort puts it (the
// TPU kernel's argmax, too, takes a NaN as the largest value), so a NaN or
// inf lie among the F largest or smallest is trimmed away.
//
// Design. The TPU kernel keeps r resident in VMEM and unrolls a static F
// over a (block_n, deg_max, P) tile. Here a block of 64 threads owns rb =
// 64 / P consecutive receivers (7 at P = 9), in two phases:
//
// 1. The slot table. Thread e takes entry e = (receiver jl, slot k) of
//    the block's rb x CAP entries, so a warp reads 32 consecutive slots of
//    nbr_idx, nbr_valid and byz_nbr, coalesced, in one round trip for the
//    block. The entry says where coordinate p of the slot is read, as src
//    + p * step: the sender's row of r (step 1), the slot's message
//    (byz_msgs through its element strides, so a broadcast attack's
//    stride-0 view needs no copy), or, for an invalid slot or k >= deg_max,
//    one NaN constant (step 0). The choice keys on valid and byz_nbr, never
//    on a loaded value (invalid slots may hold NaN messages). A warp vote
//    on valid gives each receiver's degree (its CAP entries lie in one
//    warp's lanes; at 64 slots, two warps' popcounts). No coordinate thread
//    reads a receiver's metadata from device memory.
// 2. The trim. Thread (jl, p), p fastest, issues its CAP loads through the
//    table before it uses any: no branch, and every address is known as
//    soon as the table is. The trim is K4's (csrc/trimmed_mean.cu): each
//    value becomes a 32-bit key whose unsigned order is the sort order
//    (every NaN first made the card's one positive NaN by an add of -0,
//    then bits ^ ((bits >> 31) | 2^31), the shift arithmetic); Batcher's
//    odd-even merge sort runs unrolled at compile time in registers at
//    the smallest width CAP in {8, 16, 32, 64} that holds deg_max (19
//    compare-exchanges at 8 slots, 543 at 64); the survivors, ranks F ..
//    deg - F - 1 (a bit mask of the ranks), are decoded bit for bit and
//    added in rank order from 0. An invalid slot's NaN ties with a valid
//    NaN above every other key, so ranks below deg hold the valid values
//    in sort order whatever the ties; with deg <= 2F no rank qualifies and
//    tsum is exactly 0. Survivors are summed, never taken as total minus
//    extremes, which cancels at the 1e3..1e6 attack magnitudes beside O(1)
//    honest values. F is a runtime argument: one int, or a per-receiver
//    array that each thread reads for its own receiver, so the receivers
//    of one block may have different rank windows. Either is clamped to
//    [0, CAP]: a larger F keeps nothing, as F = CAP does.
//
// Storage. The kernel is a template on the storage type T of r and
// byz_msgs: float, or __nv_bfloat16 / __half for the precision policy's
// half storage (byz_trim_half), stride-0 lies included. A loaded value is
// converted to float32 (exactly) before it becomes an ordered key, so the
// network, the slot table and the rank-order float32 sum are those of the
// float32 kernel, and tsum is bit-equal to the float32 rank-order sum of
// the upcast survivors; tsum and kept are float32. An invalid slot reads
// the NaN of its storage type.
//
// Bound: bytes. Per round the kernel reads r, nbr_idx, nbr_valid, byz_nbr
// and (where it is not a broadcast view) byz_msgs, and writes tsum and
// kept; at N = 131,072, deg_max = 7, P = 9 that is 15.5 MB with a stride-0
// byz_msgs and 48.5 MB with a materialized one. A per-receiver F adds 4
// bytes a receiver (0.5 MB there). What holds it above that
// is instruction issue and each block's two dependent round trips (the
// table's, then its gathers'): at 8 slots the kernel is 320 SASS
// instructions, most of them issued once by every one of a round's 1.18 M
// (receiver, coordinate) threads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <algorithm>
#include <type_traits>
#include <utility>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int THREADS = 64;    // a block's threads
constexpr int SLOTS = 512;     // a block's slot-table entries: rb * CAP
constexpr int CAP_MAX = 64;    // the widest network: deg_max <= 64

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
    // v + (-0) is v bit for bit, and every NaN comes out as the card's one
    // positive NaN, 0x7fffffff (an add the compiler may not fold)
    float c;
    asm("add.rn.f32 %0, %1, 0f80000000;" : "=f"(c) : "f"(v));
    const unsigned b = __float_as_uint(c);
    return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31)
                | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
    const unsigned s = static_cast<unsigned>(static_cast<int>(k) >> 31);
    return __uint_as_float(k ^ (~s | 0x80000000u));
}

// The value an invalid slot reads: a NaN, whose key ties with a valid
// NaN's above every other key (see the note at the top); 0x7fff is a NaN
// of both half types.
__device__ const float k_invalid_slot = __builtin_nanf("");
__device__ const unsigned short k_invalid_half = 0x7fff;

template <typename T> __device__ __forceinline__ const T* invalid_slot();
template <> __device__ __forceinline__ const float* invalid_slot<float>() {
    return &k_invalid_slot;
}
template <>
__device__ __forceinline__ const __nv_bfloat16* invalid_slot<__nv_bfloat16>() {
    return reinterpret_cast<const __nv_bfloat16*>(&k_invalid_half);
}
template <> __device__ __forceinline__ const __half* invalid_slot<__half>() {
    return reinterpret_cast<const __half*>(&k_invalid_half);
}

// one stored value, read through the read-only path, as float32
__device__ __forceinline__ float load_float(const float* p) {
    return __ldg(p);
}
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
    const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float load_float(const __half* p) {
    const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __half2float(__ushort_as_half(b));
}

template <typename T, int CAP>
__global__ void __launch_bounds__(THREADS)
trim_gather_kernel(const T* __restrict__ r,
                   const int* __restrict__ nbr_idx,
                   const bool* __restrict__ nbr_valid,
                   const T* __restrict__ byz_msgs,
                   long long ms0, long long ms1, long long ms2,
                   const bool* __restrict__ byz_nbr,
                   float* __restrict__ tsum, float* __restrict__ kept,
                   int n, int dm, int P, int F,
                   const int* __restrict__ f_recv, int rb) {
    // a receiver's CAP table entries lie in one warp's lanes (in two
    // warps', PARTS popcounts, at 64 slots)
    constexpr int PARTS = CAP > 32 ? CAP / 32 : 1;
    __shared__ const T* s_src[SLOTS];
    __shared__ int s_step[SLOTS];
    __shared__ int s_deg[THREADS * PARTS];

    const int v0 = blockIdx.x * rb;
    const int nv = min(rb, n - v0);
    const int entries = nv * CAP;

    // the slot table: entry (jl, k) is where coordinate p of slot k of
    // receiver v0 + jl is read, src + p * step
    for (int s0 = 0; s0 < entries; s0 += blockDim.x) {
        const int e = s0 + threadIdx.x;
        const int jl = e / CAP;
        const int k = e % CAP;
        const T* src = invalid_slot<T>();
        int step = 0;
        bool valid = false;
        if (e < entries && k < dm) {
            const long long at = static_cast<long long>(v0 + jl) * dm + k;
            const int ix = nbr_idx[at];
            const bool byz = byz_nbr[at];
            valid = nbr_valid[at];
            if (valid && byz) {
                src = byz_msgs + (v0 + jl) * ms0 + k * ms1;
                step = static_cast<int>(ms2);
            } else if (valid) {
                src = r + static_cast<long long>(ix) * P;
                step = 1;
            }
        }
        const unsigned vote = __ballot_sync(0xffffffffu, valid);
        if (e < entries) {
            s_src[e] = src;
            s_step[e] = step;
            if (k % 32 == 0) {
                const int lane = threadIdx.x % 32;
                const unsigned seg = CAP >= 32
                    ? 0xffffffffu : ((1u << (CAP % 32)) - 1u) << lane;
                s_deg[jl * PARTS + k / 32] = __popc(vote & seg);
            }
        }
    }
    __syncthreads();

    for (int t = threadIdx.x; t < nv * P; t += blockDim.x) {
        const int jl = static_cast<unsigned>(t) / static_cast<unsigned>(P);
        const int p = t - jl * P;
        const T* const* src = s_src + jl * CAP;
        const int* step = s_step + jl * CAP;
        unsigned key[CAP];
#pragma unroll
        for (int k = 0; k < CAP; ++k)
            key[k] = order_key(load_float(src[k] + p * step[k]));
        sort_keys<CAP>(key);

        int deg = s_deg[jl * PARTS];
        if (PARTS > 1) deg += s_deg[jl * PARTS + 1];
        using Mask = typename std::conditional<(CAP <= 32), unsigned,
                                               unsigned long long>::type;
        // this receiver's F: with deg > 2f, f < CAP / 2 and cnt + f <= CAP
        const int f = f_recv == nullptr ? F
            : min(max(__ldg(f_recv + v0 + jl), 0), CAP);
        const int cnt = max(deg - 2 * f, 0);
        const Mask win = cnt == 0 ? Mask{0}
            : ((~Mask{0}) >> (8 * sizeof(Mask) - cnt)) << f;
        float sum = 0.0f;
#pragma unroll
        for (int q = 0; q < CAP; ++q)
            if ((win >> q) & 1u) sum += key_value(key[q]);
        tsum[static_cast<long long>(v0 + jl) * P + p] = sum;
        if (p == 0) kept[v0 + jl] = static_cast<float>(cnt);
    }
}

template <typename T, int CAP>
cudaError_t launch(const T* r, const int* nbr_idx, const bool* nbr_valid,
                   const T* byz_msgs, long long ms0, long long ms1,
                   long long ms2, const bool* byz_nbr, float* tsum,
                   float* kept, int n, int dm, int P, int F,
                   const int* f_recv, cudaStream_t stream) {
    const int rb = std::max(1, std::min(THREADS / P, SLOTS / CAP));
    const int threads = std::min(THREADS, (rb * P + 31) / 32 * 32);
    const unsigned blocks = static_cast<unsigned>((n + rb - 1) / rb);
    trim_gather_kernel<T, CAP><<<blocks, threads, 0, stream>>>(
        r, nbr_idx, nbr_valid, byz_msgs, ms0, ms1, ms2, byz_nbr, tsum, kept,
        n, dm, P, std::min(F, CAP), f_recv, rb);
    return cudaGetLastError();
}

template <typename T>
static int launch_any(const T* r, const int* nbr_idx, const bool* nbr_valid,
                      const T* byz_msgs, long long ms0, long long ms1,
                      long long ms2, const bool* byz_nbr, float* tsum,
                      float* kept, int n, int dm, int P, int F,
                      const int* f_recv, int device, cudaStream_t stream) {
    if (n < 1 || P < 1 || dm < 1 || dm > CAP_MAX || F < 0
        || ms2 > INT_MAX / P)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dm <= 8)
        err = launch<T, 8>(r, nbr_idx, nbr_valid, byz_msgs, ms0, ms1, ms2,
                           byz_nbr, tsum, kept, n, dm, P, F, f_recv, stream);
    else if (dm <= 16)
        err = launch<T, 16>(r, nbr_idx, nbr_valid, byz_msgs, ms0, ms1, ms2,
                            byz_nbr, tsum, kept, n, dm, P, F, f_recv, stream);
    else if (dm <= 32)
        err = launch<T, 32>(r, nbr_idx, nbr_valid, byz_msgs, ms0, ms1, ms2,
                            byz_nbr, tsum, kept, n, dm, P, F, f_recv, stream);
    else
        err = launch<T, 64>(r, nbr_idx, nbr_valid, byz_msgs, ms0, ms1, ms2,
                            byz_nbr, tsum, kept, n, dm, P, F, f_recv, stream);
    return static_cast<int>(err);
}

// Launches on the caller's stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take. f_recv is
// null (every receiver trims F) or n per-receiver counts on the device.
extern "C" int byz_trim_f32(const float* r, const int* nbr_idx,
                            const bool* nbr_valid, const float* byz_msgs,
                            long long ms0, long long ms1, long long ms2,
                            const bool* byz_nbr, float* tsum, float* kept,
                            int n, int dm, int P, int F, const int* f_recv,
                            int device, cudaStream_t stream) {
    return launch_any<float>(r, nbr_idx, nbr_valid, byz_msgs, ms0, ms1, ms2,
                             byz_nbr, tsum, kept, n, dm, P, F, f_recv, device,
                             stream);
}

// The same on half storage: r and byz_msgs of storage 1 (__nv_bfloat16)
// or 2 (__half); tsum and kept float32.
extern "C" int byz_trim_half(const void* r, const int* nbr_idx,
                             const bool* nbr_valid, const void* byz_msgs,
                             long long ms0, long long ms1, long long ms2,
                             const bool* byz_nbr, float* tsum, float* kept,
                             int n, int dm, int P, int F, const int* f_recv,
                             int device, int storage, cudaStream_t stream) {
    if (storage == 1) {
        using T = __nv_bfloat16;
        return launch_any<T>(static_cast<const T*>(r), nbr_idx, nbr_valid,
                             static_cast<const T*>(byz_msgs), ms0, ms1, ms2,
                             byz_nbr, tsum, kept, n, dm, P, F, f_recv, device,
                             stream);
    }
    if (storage == 2) {
        using T = __half;
        return launch_any<T>(static_cast<const T*>(r), nbr_idx, nbr_valid,
                             static_cast<const T*>(byz_msgs), ms0, ms1, ms2,
                             byz_nbr, tsum, kept, n, dm, P, F, f_recv, device,
                             stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
