// RG-LRU gated linear recurrence: y_t = a_t * y_{t-1} + x_t over (B, S, W),
// elementwise over the W lanes, with y_{-1} = 0.  a, x and y are fp32 and
// contiguous; any S, no padding.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:_rglru_kernel
// (rglru_pallas), which walks time blocks of T_BLK steps in order and
// carries y (1 x W, fp32) across grid steps in VMEM scratch.  On the TPU the
// W lanes fill the vector unit; here one thread per lane walking all of time
// would fill 20 of 132 SMs at batch 1 and W = 2560.  So time is split too.
//
// A segmented scan over time.  A block owns a strip of LW contiguous lanes
// of one batch row and splits time into super-chunks of T segments of L
// steps; thread (j, k) holds lane j and segment k.  A warp's loads and stores
// are then whole rows of LW lanes.  For each super-chunk, in order:
//   pass A  each thread loads its segment's L steps of a and x into
//           registers (none depends on y, so all are in flight at once) and
//           computes the segment's end value Y_k from 0 and its decay
//           product A_k = a_first ... a_last;
//   carry   (A_k, Y_k) go to shared memory; thread k combines those of the
//           segments before it, in order, into its carry-in
//           c_k = A_{k-1} c_{k-1} + Y_{k-1}, with c_0 the block's carry;
//   pass C  it reruns the recurrence over the same registers from c_k and
//           stores y; the last segment's last y is the next carry.
// Every product and sum is rounded apart (__fmul_rn, __fadd_rn, no fused
// multiply-add), as in the plain recurrence.  So every y_t equals
// a_t * y_{t-1} + x_t as the plain version rounds it, except at the start of
// a segment k > 0, where c_k stands for y_{t-1}: the first segment (the
// first L steps) equals the plain version bit for bit, the rest differ by
// the carry's rounding only.  Every order is fixed, so a repeated call gives
// the same bits.  Masked steps (past S) take a = 1 and x = 0, which leave
// both Y and A unchanged.
//
// Bound: memory.  a, x and y are read or written once each (12 bytes per
// element; at recurrentgemma-2b's longest prefill, B = 1, S = 1168 and
// W = 2560, 35.9 MB, about 10.7 us at 3.35 TB/s) against two flops per
// element.  The grid is (W / LW strips, B); every thread has its 2 L loads
// in flight at once in pass A.  The layout, 16 lanes x 32 segments x 16
// steps (512 threads of 64 registers, 160 blocks at W = 2560 and B = 1),
// was the fastest without a spill of the layouts measured on an H100,
// summed over the served lengths (PERF.md).
#include <cuda_runtime.h>

namespace {

// The layout; repro_torch/kernels/rglru.py:layout() reads these three lines.
constexpr int LW = 16;   // lanes a block owns
constexpr int T = 32;    // segments of a super-chunk
constexpr int L = 16;    // steps of a segment
constexpr int THREADS = LW * T;
static_assert(32 % LW == 0 || LW % 32 == 0, "a warp holds whole strips");
static_assert(THREADS <= 1024, "at most 1024 threads a block");

__device__ __forceinline__ float step(float a, float y, float x) {
    return __fadd_rn(__fmul_rn(a, y), x);
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ y, int S, int W) {
    __shared__ float seg_a[T][LW], seg_y[T][LW], carry[LW];
    const int j = threadIdx.x % LW;
    const int k = threadIdx.x / LW;
    const int lane = blockIdx.x * LW + j;
    const bool live = lane < W;
    const long long base = (long long)blockIdx.y * S * W + lane;
    a += base;
    x += base;
    y += base;
    if (k == 0) carry[j] = 0.f;

    for (int t0 = 0; t0 < S; t0 += T * L) {
        const int s0 = t0 + k * L;
        // pass A
        float av[L], xv[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
            const bool in = live && s0 + i < S;
            av[i] = in ? __ldg(a + (long long)(s0 + i) * W) : 1.f;
            xv[i] = in ? __ldg(x + (long long)(s0 + i) * W) : 0.f;
        }
        float A = 1.f, Y = 0.f;
#pragma unroll
        for (int i = 0; i < L; ++i) {
            Y = step(av[i], Y, xv[i]);
            A = __fmul_rn(A, av[i]);
        }
        seg_a[k][j] = A;
        seg_y[k][j] = Y;
        __syncthreads();

        // carry-in, combined in segment order
        float c = carry[j];
        for (int m = 0; m < k; ++m) c = step(seg_a[m][j], c, seg_y[m][j]);

        // pass C
#pragma unroll
        for (int i = 0; i < L; ++i) {
            c = step(av[i], c, xv[i]);
            if (live && s0 + i < S) y[(long long)(s0 + i) * W] = c;
        }
        __syncthreads();              // every read of seg_* and carry is done
        if (k == T - 1) carry[j] = c;
    }
}

}  // namespace

// a, x, y: (B, S, W) fp32, contiguous.  Returns cudaGetLastError() after
// the launch.
extern "C" int rglru_launch(const void* a, const void* x, void* y, int B,
                            int S, int W, void* stream) {
    if (B < 0 || S < 0 || W < 0) return cudaErrorInvalidValue;
    if (B == 0 || S == 0 || W == 0) return cudaSuccess;
    const dim3 grid((W + LW - 1) / LW, B);
    rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<float*>(y), S, W);
    return static_cast<int>(cudaGetLastError());
}
