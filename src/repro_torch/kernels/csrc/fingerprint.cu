// Attestation fingerprint: sum over words w of (w * 0x9E3779B9) ^ (w >> 16),
// modulo 2^32, where a word is the raw 16 bits of a bf16/f16 value or the
// raw 32 bits of an f32/int32/uint32 value, widened to 32 bits.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint.py:_fp_kernel
// (fingerprint_pallas), which walks a 1-D grid of 4096-word blocks in order
// and carries the sum in an SMEM scalar.  Blocks on this card run in
// parallel and in no order, so each thread keeps its own partial sum, a
// warp-shuffle reduce folds a block into one value, and one atomicAdd per
// block adds it to the result.  Addition mod 2^32 is associative and
// commutative, so the digest is exact and the same for any order.
//
// Bound: memory.  Every word is read once and a few integer operations
// follow, far below the card's rate, so the floor is bytes / 3.35 TB/s
// (gemma3-1b's 2.0 GB of bf16 weights: about 0.6 ms).  The kernel therefore
// reads the caller's words where they lie, 16 bytes a load where the
// pointer is aligned, and widens them in registers: no widened copy is made
// (at gemma3-1b that copy would be a 4 GB temporary).  uint32_t arithmetic
// wraps by itself.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t MIX = 0x9E3779B9u;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix(uint32_t w) {
    return (w * MIX) ^ (w >> 16);
}

// Sum of the mixed words in one 16-byte load: eight 16-bit words...
__device__ __forceinline__ uint32_t mix16(uint4 v, uint16_t) {
    uint32_t s = 0;
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) s += mix(u[i] & 0xFFFFu) + mix(u[i] >> 16);
    return s;
}

// ...or four 32-bit words.
__device__ __forceinline__ uint32_t mix16(uint4 v, uint32_t) {
    return mix(v.x) + mix(v.y) + mix(v.z) + mix(v.w);
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
fingerprint_kernel(const W* __restrict__ x, long long n, uint32_t* out) {
    constexpr long long PER_LOAD = 16 / sizeof(W);
    const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    uint32_t acc = 0;
    long long n_vec = 0;
    if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
        n_vec = n / PER_LOAD;
        const uint4* xv = reinterpret_cast<const uint4*>(x);
        for (long long i = tid; i < n_vec; i += stride) {
            acc += mix16(__ldg(xv + i), W{});
        }
    }
    for (long long i = n_vec * PER_LOAD + tid; i < n; i += stride) {
        acc += mix(static_cast<uint32_t>(x[i]));
    }

    __shared__ uint32_t warp_sums[THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < THREADS / 32 ? warp_sums[lane] : 0u;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) atomicAdd(out, acc);
    }
}

}  // namespace

// x: n words of word_bytes (2 or 4) bytes each; out: one uint32 that the
// caller has zeroed.  Launches on `stream` and returns cudaGetLastError().
extern "C" int fingerprint_launch(const void* x, long long n, int word_bytes,
                                  void* out, void* stream) {
    if (word_bytes != 2 && word_bytes != 4) return cudaErrorInvalidValue;
    const long long per_load = 16 / word_bytes;
    const long long loads = (n + per_load - 1) / per_load;
    long long blocks = (loads + THREADS - 1) / THREADS;
    // a grid-stride loop: enough blocks to fill 132 SMs several times over
    if (blocks > 132 * 16) blocks = 132 * 16;
    if (blocks < 1) blocks = 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint32_t* o = static_cast<uint32_t*>(out);
    if (word_bytes == 2) {
        fingerprint_kernel<uint16_t><<<(unsigned)blocks, THREADS, 0, s>>>(
            static_cast<const uint16_t*>(x), n, o);
    } else {
        fingerprint_kernel<uint32_t><<<(unsigned)blocks, THREADS, 0, s>>>(
            static_cast<const uint32_t*>(x), n, o);
    }
    return static_cast<int>(cudaGetLastError());
}
