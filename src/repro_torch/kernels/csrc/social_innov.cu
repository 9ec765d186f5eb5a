// Innovation and belief step of Algorithm 3 for Hopper (sm_90a).
//
// Replaces the TPU kernel innovation_pallas in
// src/repro/kernels/social_innov/social_innov.py. Per agent j:
//
//     sig      = min(#{s : u[j] > cdf[j, s]}, S - 1)   inverse-CDF signal
//     z_new[j] = z[j] + log_tables[j, :, sig]          dual accumulator
//     mu[j]    = softmax(z_new[j] / max(mass[j], 1e-30))
//
// The clamp to S - 1 matters: an fp32 cumsum can end below 1.0, and a
// uniform above it must map to the last letter, not past the alphabet.
// The softmax subtracts the row maximum and uses the accurate expf (never
// __expf, and the build uses no fast-math flag).
//
// Design. A block, one warp, owns A consecutive agents: A = 32 where
// their rows fit the 48 KB of shared memory a block has without opt-in,
// else the largest power of two that fits (16 at m = 16, S = 32), else one
// agent in up to 227 KB (the opt-in limit); the wrapper picks A from
// (m, S). Its ranges of z (A m), mass, u, cdf (A S) and log_tables (A m S)
// are contiguous, and the block copies all five into shared memory in one
// pass: cp.async 16-byte copies over the aligned body of each range and
// bytes at the ragged ends, all in flight before the block waits for any.
// The full table rows come along, so there is no second, sig-dependent
// round trip to device memory. Then thread t < A computes agent t from
// shared memory: its letter, its m table entries (read once; the 4-way
// bank conflict of the m S = 12-float row stride costs m reads), z_new
// into shared memory (an odd stride of m = 3 floats: no conflict), then
// the softmax from those values: z_new is one add, each ratio z_new / den,
// the maximum, the sum of expf(ratio - top) over k in order, then each
// expf(ratio - top) / total. The block stores both output ranges with
// 16-byte stores.
//
// Storage. The kernel is a template on the storage type T of z, mass and
// z_new: float, or __nv_bfloat16 / __half for the precision policy's half
// storage (social_innov_half); u, cdf, log_tables and mu stay float32.
// The staging moves byte ranges, so a half range stages like a float one:
// A = 32 agents' bf16 z at m = 3 is 192 contiguous bytes, whose aligned
// body goes by cp.async and whose ragged ends (a 6-byte row's) go by
// bytes. Each sum z + log_tables is taken in float32 and kept in
// registers and in mu's staging region: z_new is that sum rounded to T
// (round to nearest even), and the softmax reads the unrounded sum, as
// the plain version's accum-dtype belief does.
//
// Bound: bytes. Per agent it reads z (m), mass, u, cdf (S) and
// log_tables (m S) and writes z_new (m) and mu (m): 27 floats at m = 3,
// S = 4, against a few dozen flops; 14.2 MB at N = 131,072 in float32,
// 12.6 MB with half z, mass and z_new.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int THREADS = 32;             // a block: one warp
constexpr int SMEM = 48 * 1024;         // shared memory without opt-in
constexpr int SMEM_OPTIN = 227 * 1024;  // with it (sm_90)

// Staging a contiguous byte range of device memory in shared memory. The n
// bytes at g land at s + (g mod 16), so that the range's 16-byte-aligned
// body sits on 16-byte-aligned shared addresses and moves by cp.async, 16
// bytes a copy, all of them in flight at once; the ragged ends (under 16
// bytes each, at most 30 in all) move as single bytes, one a thread (the
// block has at least 32 threads). s must be 16-byte aligned and hold n + 16
// bytes. A block stages its ranges in three steps, so that every range's
// loads are issued before any is waited for: stage_body for each range,
// then stage_end for each (a load into a register), then put_end for each
// (its store), then stage_wait.

__device__ __forceinline__ void stage_body(const unsigned char* g, int n,
                                           unsigned char* s) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(g);
    const uintptr_t base = a0 & ~uintptr_t{15};
    const uintptr_t b0 = (a0 + 15) & ~uintptr_t{15};
    const uintptr_t b1 = (a0 + n) & ~uintptr_t{15};
    for (uintptr_t c = b0 + 16 * threadIdx.x; c < b1; c += 16 * blockDim.x) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(s + (c - base)));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(dst), "l"(c));
    }
}

struct EndByte {
    int at;             // shared offset, or -1 where this thread has none
    unsigned char b;
};

// this thread's byte of the range's ragged ends, loaded
__device__ __forceinline__ EndByte stage_end(const unsigned char* g, int n) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(g);
    const uintptr_t b0 = (a0 + 15) & ~uintptr_t{15};
    const uintptr_t b1 = (a0 + n) & ~uintptr_t{15};
    int head = n, tail = 0;             // no aligned body: bytes throughout
    if (b0 < b1) {
        head = static_cast<int>(b0 - a0);
        tail = static_cast<int>(a0 + n - b1);
    }
    const int i = threadIdx.x;
    if (i >= head + tail) return EndByte{-1, 0};
    const int off = i < head ? i : n - tail + (i - head);
    return EndByte{static_cast<int>(a0 & 15) + off, __ldg(g + off)};
}

__device__ __forceinline__ void put_end(unsigned char* s, EndByte e) {
    if (e.at >= 0) s[e.at] = e.b;
}

// wait for this thread's copies, then for the block's
__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

// The reverse of staging: the n bytes at s + (g mod 16) to g, 16-byte
// stores over the aligned body, bytes at the ragged ends.
__device__ __forceinline__ void unstage(unsigned char* g, int n,
                                        const unsigned char* s) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(g);
    const uintptr_t a1 = a0 + n;
    const uintptr_t base = a0 & ~uintptr_t{15};
    const uintptr_t b0 = (a0 + 15) & ~uintptr_t{15};
    const uintptr_t b1 = a1 & ~uintptr_t{15};
    int head = n, tail = 0;
    if (b0 < b1) {
        for (uintptr_t c = b0 + 16 * threadIdx.x; c < b1;
             c += 16 * blockDim.x)
            *reinterpret_cast<uint4*>(c) =
                *reinterpret_cast<const uint4*>(s + (c - base));
        head = static_cast<int>(b0 - a0);
        tail = static_cast<int>(a1 - b1);
    }
    for (int i = threadIdx.x; i < head + tail; i += blockDim.x) {
        const int off = i < head ? i : n - tail + (i - head);
        g[off] = s[(a0 - base) + off];
    }
}

__device__ __forceinline__ int phase(const void* g) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
}

// a shared region of `bytes` bytes, its 16-byte phase slack included
__host__ __device__ constexpr long long region_bytes(long long bytes) {
    return (bytes + 15) / 16 * 16 + 16;
}

// a block's shared memory: z, mass and z_new take sb bytes an element
__host__ __device__ constexpr long long staged_bytes(long long A,
                                                    long long m,
                                                    long long S,
                                                    long long sb) {
    return region_bytes(sb * A * m) * 2 + region_bytes(4 * A * m)
           + region_bytes(sb * A) + region_bytes(4 * A)
           + region_bytes(4 * A * S) + region_bytes(4 * A * m * S);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
    return __float2half_rn(x);
}

// one agent's step, from its rows in shared memory to its outputs there;
// mo holds the float32 sums until the softmax overwrites them
template <typename T>
__device__ __forceinline__ void agent_step(const T* zr, float mass_j,
                                           float uj, const float* c,
                                           const float* lt_row, T* zo,
                                           float* mo, int m, int S) {
    int sig = 0;
    for (int s = 0; s < S; ++s) sig += (uj > c[s]) ? 1 : 0;
    sig = min(sig, S - 1);
    const float* lt = lt_row + sig;
    const float den = fmaxf(mass_j, 1e-30f);

    float top = -INFINITY;
    for (int k = 0; k < m; ++k) {
        const float zn = to_float(zr[k]) + lt[k * S];
        mo[k] = zn;
        zo[k] = from_float<T>(zn);
        top = fmaxf(top, zn / den);
    }
    float total = 0.0f;
    for (int k = 0; k < m; ++k) total += expf(mo[k] / den - top);
    for (int k = 0; k < m; ++k) mo[k] = expf(mo[k] / den - top) / total;
}

template <typename T>
__global__ void social_innov_staged(const T* __restrict__ z,
                                    const T* __restrict__ mass,
                                    const float* __restrict__ u,
                                    const float* __restrict__ cdf,
                                    const float* __restrict__ log_tables,
                                    T* __restrict__ z_new,
                                    float* __restrict__ mu,
                                    int n, int m, int S, int A) {
    constexpr int sb = sizeof(T);
    extern __shared__ __align__(16) unsigned char smem[];
    const long long j0 = static_cast<long long>(blockIdx.x) * A;
    const int na = static_cast<int>(min(static_cast<long long>(A), n - j0));
    unsigned char* sz = smem;
    unsigned char* smass = sz + region_bytes(sb * A * m);
    unsigned char* su = smass + region_bytes(sb * A);
    unsigned char* scdf = su + region_bytes(4 * A);
    unsigned char* slt = scdf + region_bytes(4 * A * S);
    unsigned char* szo = slt + region_bytes(4 * A * m * S);
    unsigned char* smo = szo + region_bytes(sb * A * m);

    const T* gz = z + j0 * m;
    const T* gmass = mass + j0;
    const float* gu = u + j0;
    const float* gcdf = cdf + j0 * S;
    const float* glt = log_tables + j0 * m * S;
    T* gzo = z_new + j0 * m;
    float* gmo = mu + j0 * m;
    const auto* bz = reinterpret_cast<const unsigned char*>(gz);
    const auto* bmass = reinterpret_cast<const unsigned char*>(gmass);
    const auto* bu = reinterpret_cast<const unsigned char*>(gu);
    const auto* bcdf = reinterpret_cast<const unsigned char*>(gcdf);
    const auto* blt = reinterpret_cast<const unsigned char*>(glt);
    stage_body(bz, sb * na * m, sz);
    stage_body(bmass, sb * na, smass);
    stage_body(bu, 4 * na, su);
    stage_body(bcdf, 4 * na * S, scdf);
    stage_body(blt, 4 * na * m * S, slt);
    const EndByte e_z = stage_end(bz, sb * na * m);
    const EndByte e_mass = stage_end(bmass, sb * na);
    const EndByte e_u = stage_end(bu, 4 * na);
    const EndByte e_cdf = stage_end(bcdf, 4 * na * S);
    const EndByte e_lt = stage_end(blt, 4 * na * m * S);
    put_end(sz, e_z);
    put_end(smass, e_mass);
    put_end(su, e_u);
    put_end(scdf, e_cdf);
    put_end(slt, e_lt);
    stage_wait();

    const int t = threadIdx.x;
    if (t < na) {
        const T* z_s = reinterpret_cast<const T*>(sz + phase(gz));
        const float* cdf_s = reinterpret_cast<const float*>(scdf
                                                            + phase(gcdf));
        const float* lt_s = reinterpret_cast<const float*>(slt + phase(glt));
        T* zo_s = reinterpret_cast<T*>(szo + phase(gzo));
        float* mo_s = reinterpret_cast<float*>(smo + phase(gmo));
        agent_step<T>(z_s + t * m,
                   to_float(reinterpret_cast<const T*>(smass
                                                       + phase(gmass))[t]),
                   reinterpret_cast<const float*>(su + phase(gu))[t],
                   cdf_s + t * S, lt_s + t * m * S, zo_s + t * m,
                   mo_s + t * m, m, S);
    }
    __syncthreads();
    unstage(reinterpret_cast<unsigned char*>(gzo), sb * na * m, szo);
    unstage(reinterpret_cast<unsigned char*>(gmo), 4 * na * m, smo);
}

template <typename T>
static int launch(const T* z, const T* mass, const float* u, const float* cdf,
                  const float* log_tables, T* z_new, float* mu, int n, int m,
                  int S, int A, int device, cudaStream_t stream) {
    if (n < 1 || m < 1 || S < 1 || A < 1 || A > THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = staged_bytes(A, m, S, sizeof(T));
    if (smem > SMEM_OPTIN) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > SMEM) {
        err = cudaFuncSetAttribute(social_innov_staged<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const unsigned blocks = static_cast<unsigned>((n + A - 1) / A);
    social_innov_staged<T><<<blocks, THREADS, static_cast<int>(smem),
                             stream>>>(z, mass, u, cdf, log_tables, z_new, mu,
                                       n, m, S, A);
    return static_cast<int>(cudaGetLastError());
}

// Launches on the caller's stream with A agents a block and returns
// cudaGetLastError(), or cudaErrorInvalidValue where A is out of [1, 32]
// or the block's rows do not fit SMEM_OPTIN.
extern "C" int social_innov_f32(const float* z, const float* mass,
                                const float* u, const float* cdf,
                                const float* log_tables, float* z_new,
                                float* mu, int n, int m, int S, int A,
                                int device, cudaStream_t stream) {
    return launch<float>(z, mass, u, cdf, log_tables, z_new, mu, n, m, S, A,
                         device, stream);
}

// The same on half storage: z, mass and z_new of storage 1
// (__nv_bfloat16) or 2 (__half); u, cdf, log_tables and mu float32.
extern "C" int social_innov_half(const void* z, const void* mass,
                                 const float* u, const float* cdf,
                                 const float* log_tables, void* z_new,
                                 float* mu, int n, int m, int S, int A,
                                 int device, int storage,
                                 cudaStream_t stream) {
    if (storage == 1) {
        using T = __nv_bfloat16;
        return launch<T>(static_cast<const T*>(z),
                         static_cast<const T*>(mass), u, cdf, log_tables,
                         static_cast<T*>(z_new), mu, n, m, S, A, device,
                         stream);
    }
    if (storage == 2) {
        using T = __half;
        return launch<T>(static_cast<const T*>(z),
                         static_cast<const T*>(mass), u, cdf, log_tables,
                         static_cast<T*>(z_new), mu, n, m, S, A, device,
                         stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
