// Sliding-window causal attention, forward: a query at position p attends
// to keys p-w+1 .. p.  q: (B, S, H, dh); k, v: (B, S, KV, dh), GQA with
// query head h reading kv head h / (H / KV); out: (B, S, H, dh), contiguous,
// in the type of q.  Softmax state (m, l, acc) and P.V are fp32, and
// denom = max(l, 1e-30), as in the TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/swa.py:_swa_kernel (swa_pallas).
// That kernel takes chunk = window and keeps a w x w fp32 score tile in
// VMEM; at w = 512 such a tile is 1 MiB, far over the 227 KB of shared
// memory a block may have here.  So the tiles do not depend on the window:
// one block per (query tile of BQ rows, query head, batch) walks the key
// tiles of BK keys in [q0 - w + 1, q_end] with an online softmax, masking
// 0 <= qpos - kpos < w and kpos < S itself, so no padding is needed.  K
// and V are read with strides straight from (B, S, KV, dh) at the query
// head's kv head: nothing is repeated or transposed.
//
// Bound: at gemma3-1b's prefill (w = 512, dh = 256, H = 4, KV = 1) the
// bytes (q, k, v, out once each) and the operations (4 dh per query-key
// pair in the band) both give a floor of a few microseconds on this card.
// This first version is simple, not fast: scores and P.V run in fp32 on
// the CUDA cores (P.V must be fp32 to match the TPU kernel, which rounds
// nothing), tiles are staged in shared memory as fp32, and each warp owns
// BQ / 4 query rows with lane j holding key j of the tile.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;               // query rows per block
constexpr int BK = 32;               // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;     // query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DH = 256;
constexpr int DCOLS = MAX_DH / 32;   // head-dim columns per lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

struct Strides {
    long long b, s, h;   // in elements; the head-dim stride is 1
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
           int dh, int window, Strides qs, Strides ks, Strides vs,
           float scale) {
    extern __shared__ float smem[];
    const int ldk = dh + 1;              // padded: lanes hit distinct banks
    float* Qs = smem;                    // BQ x dh
    float* Ks = Qs + BQ * dh;            // BK x (dh + 1)
    float* Vs = Ks + BK * ldk;           // BK x dh
    float* Ps = Vs + BK * dh;            // BQ x BK probabilities

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;

    for (int idx = tid; idx < BQ * dh; idx += THREADS) {
        const int r = idx / dh, d = idx - r * dh;
        const int qp = q0 + r;
        Qs[idx] = qp < S ? to_f(qb[qp * qs.s + d]) : 0.f;
    }

    float m[ROWS], l[ROWS], acc[ROWS][DCOLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < DCOLS; ++c) acc[r][c] = 0.f;
    }

    const int q_last = min(q0 + BQ, S) - 1;
    const int k_first = max(0, q0 - window + 1);
    for (int k0 = k_first; k0 <= q_last; k0 += BK) {
        __syncthreads();   // the previous tile is consumed; Q is staged
        for (int idx = tid; idx < BK * dh; idx += THREADS) {
            const int r = idx / dh, d = idx - r * dh;
            const int kp = k0 + r;
            const bool in = kp < S;
            Ks[r * ldk + d] = in ? to_f(kb[kp * ks.s + d]) : 0.f;
            Vs[r * dh + d] = in ? to_f(vb[kp * vs.s + d]) : 0.f;
        }
        __syncthreads();

        // scores of this warp's rows against key `lane` of the tile
        float s[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
        const float* krow = Ks + lane * ldk;
        const float* qrows = Qs + warp * ROWS * dh;
        for (int d = 0; d < dh; ++d) {
            const float kd = krow[d];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) s[r] += qrows[r * dh + d] * kd;
        }

        const int kp = k0 + lane;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int row = warp * ROWS + r;
            const int delta = q0 + row - kp;
            const bool valid = q0 + row < S && kp < S && delta >= 0 &&
                               delta < window;
            const float sr = valid ? s[r] * scale : NEG_INF;
            const float m_new = fmaxf(m[r], warp_max(sr));
            const float p = valid ? expf(sr - m_new) : 0.f;
            const float alpha = expf(m[r] - m_new);
            l[r] = l[r] * alpha + warp_sum(p);
            m[r] = m_new;
            Ps[row * BK + lane] = p;
#pragma unroll
            for (int c = 0; c < DCOLS; ++c) acc[r][c] *= alpha;
        }
        __syncwarp();

        // acc[r][c] += sum_j P[row r, j] * V[j, lane + 32 c]
        const float* prow = Ps + warp * ROWS * BK;
        for (int j = 0; j < BK; ++j) {
            float pj[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) pj[r] = prow[r * BK + j];
#pragma unroll
            for (int c = 0; c < DCOLS; ++c) {
                const int d = lane + 32 * c;
                if (d < dh) {
                    const float vd = Vs[j * dh + d];
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) acc[r][c] += pj[r] * vd;
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int qp = q0 + warp * ROWS + r;
        if (qp >= S) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        T* orow = o + ((long long)(b * S + qp) * H + h) * dh;
#pragma unroll
        for (int c = 0; c < DCOLS; ++c) {
            const int d = lane + 32 * c;
            if (d < dh) store(orow + d, acc[r][c] * inv);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int dh, int window, Strides qs, Strides ks,
           Strides vs, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) *
        (size_t)(BQ * dh + BK * (dh + 1) + BK * dh + BQ * BK);
    cudaError_t err = cudaFuncSetAttribute(
        swa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    swa_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, dh, window,
        qs, ks, vs, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and out alike).
// Strides are in elements.  Returns cudaGetLastError() after the launch.
extern "C" int swa_launch(const void* q, const void* k, const void* v,
                          void* o, int dtype, int B, int S, int H, int KV,
                          int dh, int window, long long q_sb, long long q_ss,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, float scale, void* stream) {
    if (dh < 1 || dh > MAX_DH || KV < 1 || H % KV != 0 || window < 1)
        return cudaErrorInvalidValue;
    if (S < 1 || B < 1) return cudaSuccess;
    const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
        vs{v_sb, v_ss, v_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float>(q, k, v, o, B, S, H, KV, dh, window, qs,
                                     ks, vs, scale, s);
        case 1: return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, dh,
                                             window, qs, ks, vs, scale, s);
        case 2: return launch<__half>(q, k, v, o, B, S, H, KV, dh, window, qs,
                                      ks, vs, scale, s);
        default: return cudaErrorInvalidValue;
    }
}
