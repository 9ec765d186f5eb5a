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
//
// Design. One thread per agent; the m hypotheses and S letters are a few
// each (3 and 4 on the main path), so the whole row lives in registers and
// L1. The softmax subtracts the row maximum and uses the accurate expf
// (never __expf, and the build uses no fast-math flag). Each ratio is
// recomputed from the same inputs in the same order on every pass, so the
// three passes see identical values without an array indexed at run time.
//
// Bound: bytes. Per agent it reads z (m), mass, u, cdf (S) and
// log_tables (m * S) and writes z_new (m) and mu (m): 27 floats at m = 3,
// S = 4, against a few dozen flops.

#include <cuda_runtime.h>
#include <math.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__global__ void social_innov_kernel(const float* __restrict__ z,
                                    const float* __restrict__ mass,
                                    const float* __restrict__ u,
                                    const float* __restrict__ cdf,
                                    const float* __restrict__ log_tables,
                                    float* __restrict__ z_new,
                                    float* __restrict__ mu,
                                    int n, int m, int S) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const float uj = u[j];
    const float* c = cdf + static_cast<long long>(j) * S;
    int sig = 0;
    for (int s = 0; s < S; ++s) sig += (uj > c[s]) ? 1 : 0;
    sig = min(sig, S - 1);

    const float* zr = z + static_cast<long long>(j) * m;
    const float* lt = log_tables + static_cast<long long>(j) * m * S + sig;
    float* zo = z_new + static_cast<long long>(j) * m;
    float* mo = mu + static_cast<long long>(j) * m;
    const float den = fmaxf(mass[j], 1e-30f);

    float top = -INFINITY;
    for (int k = 0; k < m; ++k) {
        const float zn = zr[k] + lt[k * S];
        zo[k] = zn;
        top = fmaxf(top, zn / den);
    }
    float total = 0.0f;
    for (int k = 0; k < m; ++k) {
        total += expf((zr[k] + lt[k * S]) / den - top);
    }
    for (int k = 0; k < m; ++k) {
        mo[k] = expf((zr[k] + lt[k * S]) / den - top) / total;
    }
}

// Launches on the caller's stream and returns cudaGetLastError().
extern "C" int social_innov_f32(const float* z, const float* mass,
                                const float* u, const float* cdf,
                                const float* log_tables, float* z_new,
                                float* mu, int n, int m, int S, int device,
                                cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1)
                                                  / threads);
    social_innov_kernel<<<blocks, threads, 0, stream>>>(
        z, mass, u, cdf, log_tables, z_new, mu, n, m, S);
    return static_cast<int>(cudaGetLastError());
}
