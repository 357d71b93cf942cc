// RG-LRU gated linear recurrence: y_t = a_t * y_{t-1} + x_t over (B, S, W),
// elementwise over the W lanes, with y_{-1} = 0.  a, x and y are fp32 and
// contiguous.  Each step rounds the product and the sum apart (no fused
// multiply-add), so the result equals the plain PyTorch recurrence bit for
// bit.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:_rglru_kernel
// (rglru_pallas), which walks time blocks of T_BLK steps in order and
// carries y (1 x W, fp32) across grid steps in VMEM scratch.  Here the
// carry is a register: one thread per (batch, lane) walks all of time, so
// nothing crosses blocks and the sequence needs no padding (the tail of a
// ragged S is masked).
//
// Bound: memory.  a, x and y are read or written once each (12 bytes per
// element; at recurrentgemma-2b's longest prefill, S = 1168 and W = 2560,
// 35.9 MB, about 10.7 us at 3.35 TB/s) against two flops per element.
// Neighbouring threads hold neighbouring lanes, so each step's loads and
// stores are coalesced, and the next U steps' a and x are loaded before
// the current U steps are computed: they do not depend on y, so their
// latency hides behind the chain of dependent steps.  At batch 1 this is
// only W threads (20 blocks of 128 for W = 2560), far too few to fill the
// card's 132 SMs; a chunked two-pass scan over time would fill it.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;   // time steps loaded ahead

__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ x,
                                           long long t0, int S, int W,
                                           float (&av)[U], float (&xv)[U]) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
        const long long t = t0 + i;
        const bool in = t < S;
        av[i] = in ? __ldg(a + t * W) : 0.f;
        xv[i] = in ? __ldg(x + t * W) : 0.f;
    }
}

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
             float* __restrict__ y, int S, int W) {
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= W) return;
    const long long base = (long long)blockIdx.y * S * W + lane;
    a += base;
    x += base;
    y += base;

    float a_cur[U], x_cur[U], a_nxt[U], x_nxt[U];
    load_steps(a, x, 0, S, W, a_cur, x_cur);
    float carry = 0.f;
    for (long long t0 = 0; t0 < S; t0 += U) {
        load_steps(a, x, t0 + U, S, W, a_nxt, x_nxt);
#pragma unroll
        for (int i = 0; i < U; ++i) {
            if (t0 + i < S) {
                carry = __fadd_rn(__fmul_rn(a_cur[i], carry), x_cur[i]);
                y[(t0 + i) * W] = carry;
            }
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
            a_cur[i] = a_nxt[i];
            x_cur[i] = x_nxt[i];
        }
    }
}

}  // namespace

// a, x, y: (B, S, W) fp32, contiguous.  Returns cudaGetLastError() after
// the launch.
extern "C" int rglru_launch(const void* a, const void* x, void* y, int B,
                            int S, int W, void* stream) {
    if (B < 0 || S < 0 || W < 0) return cudaErrorInvalidValue;
    if (B == 0 || S == 0 || W == 0) return cudaSuccess;
    const dim3 grid((W + THREADS - 1) / THREADS, B);
    rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<float*>(y), S, W);
    return static_cast<int>(cudaGetLastError());
}
