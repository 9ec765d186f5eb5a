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
// Design. The TPU kernel keeps one resident recv that a sequential grid
// accumulates into; CUDA blocks run concurrently and in no order, so that
// design does not carry over. Here the edge index is dst-sorted and its
// CSR offsets (offsets[v] .. offsets[v + 1], the in-edge run of v) are
// built once on the host. One thread owns one (receiver, column) pair: it
// walks v's run in edge order, latches the new value, writes rho_new and
// adds the increment in a register, then writes recv[v, c] once. There are
// no atomics, so the result is deterministic, and every sum stays local to
// its run; a global prefix sum with boundary differences would cancel
// catastrophically once the mass decays (the z / m ratio amplifies absolute
// error by 1 / m). Padding edges (valid = False, so live = False) add
// exactly 0. rho is not updated in place: rho_new is a separate output.
//
// Bound: bytes. Per round the kernel reads sigma, rho, live, src and the
// offsets and writes rho_new and recv, two to three flops per element; at
// E = 917,504, D = 4, N = 131,072 that is about 39 MB each way in all.

#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__global__ void edge_scatter_kernel(const float* __restrict__ sigma,
                                    const float* __restrict__ rho,
                                    const bool* __restrict__ live,
                                    const int* __restrict__ src,
                                    const int* __restrict__ offsets,
                                    float* __restrict__ rho_new,
                                    float* __restrict__ recv,
                                    int n, int D) {
    const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
    if (i >= static_cast<long long>(n) * D) return;
    const int v = static_cast<int>(i / D);
    const int c = static_cast<int>(i % D);
    const int hi = offsets[v + 1];
    float acc = 0.0f;
    for (int e = offsets[v]; e < hi; ++e) {
        const long long ec = static_cast<long long>(e) * D + c;
        const float old = rho[ec];
        const float val = live[e]
            ? sigma[static_cast<long long>(src[e]) * D + c] : old;
        rho_new[ec] = val;
        acc += val - old;
    }
    recv[i] = acc;
}

// Launches on the caller's stream and returns cudaGetLastError().
extern "C" int edge_scatter_f32(const float* sigma, const float* rho,
                                const bool* live, const int* src,
                                const int* offsets, float* rho_new,
                                float* recv, int n, int D, int device,
                                cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 256;
    const long long work = static_cast<long long>(n) * D;
    const unsigned blocks = static_cast<unsigned>((work + threads - 1)
                                                  / threads);
    edge_scatter_kernel<<<blocks, threads, 0, stream>>>(
        sigma, rho, live, src, offsets, rho_new, recv, n, D);
    return static_cast<int>(cudaGetLastError());
}
