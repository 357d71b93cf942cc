// Chunkwise mLSTM forward (xLSTM's matrix-LSTM), one plane per (batch,
// head).  q, k, v: (B, S, H, dh) in one type T, read through strides;
// it, ft: (B, S, H) fp32 gate pre-activations, contiguous; S is a multiple
// of the chunk c.  Within a chunk, with csum the cumulative log-sigmoid
// forget gates from the chunk start and m_prev the carried stabiliser:
//   a[t,s]  = csum_t - csum_s + i_s           (s <= t)
//   m_t     = max(max_s a[t,s], csum_t + m_prev)
//   W[t,s]  = (q_t . k_s) exp(a[t,s] - m_t),  sq_t = exp(csum_t + m_prev - m_t)
//   h_t     = (sum_s W[t,s] v_s + sq_t q_t C) / max(|sum_s W[t,s] + sq_t q_t.n|, 1)
// then the carried state (C: dh x dh, n: dh, m: scalar, all fp32, from
// C = 0, n = 0, m = -1e30) moves to the chunk's end:
//   m' = max(tot + m_prev, max_s (tot - csum_s + i_s)),  dec = exp(tot + m_prev - m')
//   w_s = exp(tot - csum_s + i_s - m'),  C' = dec C + sum_s w_s k_s v_s^T,
//   n' = dec n + sum_s w_s k_s.
// h is written in T; the final (C, n, m) in fp32.  Everything but the
// output rounding is fp32, as in the TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/mlstm.py:_mlstm_kernel
// (mlstm_pallas).  That kernel walks the chunks of a plane in order and
// holds C whole in VMEM; at xlstm-1.3b (dh = 512) C is 1 MiB of fp32, and
// its c x c fp32 D matrix at c = 256 is 256 KB: each is far over the
// 227 KB of shared memory a block may have here.  And at batch 1 there are
// only 4 planes, which would fill 4 of the card's 132 SMs.  So C is cut by
// columns: one block per (plane, tile of TV value columns) keeps
// C[:, tile] (dh x TV fp32, 64 KB at dh = 512) and n in shared memory and
// walks the chunks in order.  Within a chunk it walks tiles of TQ query
// rows, computing their scores q.k^T over dh in slices of DK and the D
// entries from the chunk's gates, a TQ x c tile at a time.  The scores and
// the denominator do not depend on the value tile, so every block of a
// plane computes them again: dh / TV times the work of one pass over the
// scores, accepted in this simple version.  Every sum runs in a fixed
// order and no atomics are used, so the result is the same bits on every
// call.
//
// Bound: operations.  At xlstm-1.3b's prefill of 1168 tokens (padded to
// 1280, 5 chunks of 256, 4 planes) the products q.k^T, W.V, q.C and the C
// update are about 4 c^2 dh + 4 c dh^2 = 0.40 GFLOP per chunk and plane,
// 8.1 GFLOP in all (8.1 us at the bf16 tensor-core rate) against about
// 25 MB of q, k, v, h and state (7.5 us at 3.35 TB/s).  This version runs
// all of it in fp32 on the CUDA cores, with the redundancy above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TV = 32;               // value columns per block: one per lane
constexpr int TQ = 32;               // query rows per tile
constexpr int RPW = TQ / WARPS;      // query rows per warp (4)
constexpr int DK = 32;               // head-dim slice staged at a time
constexpr int MAX_C = 256;           // chunk: key column lane + 32 j, j < 8
constexpr int KJ = MAX_C / 32;
constexpr int MAX_DH = 512;          // 176 KB of shared memory at c = 256
constexpr float NEG_INF = -1e30f;
static_assert(WARPS * RPW == DK, "the C update gives each warp RPW rows of a slice");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
    long long b, s, h;   // in elements; the head-dim stride is 1
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ float log_sigmoid(float f) {
    return -(fmaxf(-f, 0.f) + log1pf(expf(-fabsf(f))));
}

// Shared memory, in floats (dhp = dh rounded up to DK):
//   Cs dhp x TV | ns dhp | csum c | ig c | mrow c | sq c | ws c |
//   Vs c x TV | Ks c x (DK + 1) | Qs TQ x DK | Ws TQ x c | scal 2
size_t smem_floats(int dhp, int c) {
    return (size_t)dhp * TV + dhp + 5 * (size_t)c + (size_t)c * TV +
           (size_t)c * (DK + 1) + TQ * DK + (size_t)TQ * c + 2;
}

template <typename T>
__device__ __forceinline__ void stage_keys(float* Ks, const T* kb, Strides ks,
                                           int s_base, int n_keys, int d0,
                                           int dh) {
    for (int idx = threadIdx.x; idx < n_keys * DK; idx += THREADS) {
        const int s = idx / DK, d = idx - s * DK;
        Ks[s * (DK + 1) + d] =
            d0 + d < dh ? to_f(kb[(long long)(s_base + s) * ks.s + d0 + d]) : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ it,
             const float* __restrict__ ft, T* __restrict__ h,
             float* __restrict__ C_out, float* __restrict__ n_out,
             float* __restrict__ m_out, int S, int H, int dh, int c,
             Strides qs, Strides ks, Strides vs) {
    extern __shared__ float smem[];
    const int dhp = (dh + DK - 1) / DK * DK;
    float* Cs = smem;
    float* ns = Cs + dhp * TV;
    float* csum = ns + dhp;
    float* ig = csum + c;
    float* mrow = ig + c;
    float* sq = mrow + c;
    float* ws = sq + c;
    float* Vs = ws + c;
    float* Ks = Vs + c * TV;
    float* Qs = Ks + c * (DK + 1);
    float* Ws = Qs + TQ * DK;
    float* scal = Ws + TQ * c;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int col0 = blockIdx.x * TV;
    const int col = col0 + lane;
    const int plane = blockIdx.y;
    const int b = plane / H, hh = plane - b * H;

    const T* qb = q + b * qs.b + hh * qs.h;
    const T* kb = k + b * ks.b + hh * ks.h;
    const T* vb = v + b * vs.b + hh * vs.h;
    const float* itb = it + (long long)b * S * H + hh;
    const float* ftb = ft + (long long)b * S * H + hh;

    for (int i = tid; i < dhp * TV + dhp; i += THREADS) Cs[i] = 0.f;
    float m_prev = NEG_INF;

    for (int c0 = 0; c0 < S; c0 += c) {
        __syncthreads();   // the previous chunk's state update is done
        for (int i = tid; i < c; i += THREADS) {
            csum[i] = log_sigmoid(ftb[(long long)(c0 + i) * H]);
            ig[i] = itb[(long long)(c0 + i) * H];
        }
        for (int idx = tid; idx < c * TV; idx += THREADS) {
            const int s = idx / TV, j = idx - s * TV;
            Vs[idx] = col0 + j < dh
                ? to_f(vb[(long long)(c0 + s) * vs.s + col0 + j]) : 0.f;
        }
        __syncthreads();
        if (tid == 0) {    // cumulative sum in order
            float acc = 0.f;
            for (int i = 0; i < c; ++i) {
                acc += csum[i];
                csum[i] = acc;
            }
        }
        __syncthreads();
        const float tot = csum[c - 1];
        // each row's stabiliser and inter-chunk scale
        for (int t = tid; t < c; t += THREADS) {
            const float ct = csum[t];
            float mx = NEG_INF;
            for (int s = 0; s <= t; ++s) mx = fmaxf(mx, (ct - csum[s]) + ig[s]);
            const float bt = ct + m_prev;
            const float mn = fmaxf(mx, bt);
            mrow[t] = mn;
            sq[t] = expf(bt - mn);
        }

        for (int t0 = 0; t0 < c; t0 += TQ) {
            const int rows = min(TQ, c - t0);
            const int kend = t0 + rows;              // keys 0 .. kend - 1
            const int jmax = (kend + 31) / 32;
            float acc_s[RPW][KJ], acc_i[RPW], acc_n[RPW];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                acc_i[i] = 0.f;
                acc_n[i] = 0.f;
#pragma unroll
                for (int j = 0; j < KJ; ++j) acc_s[i][j] = 0.f;
            }
            for (int d0 = 0; d0 < dhp; d0 += DK) {
                __syncthreads();   // the previous slice (or tile) is consumed
                for (int idx = tid; idx < TQ * DK; idx += THREADS) {
                    const int r = idx / DK, d = idx - r * DK;
                    Qs[idx] = r < rows && d0 + d < dh
                        ? to_f(qb[(long long)(c0 + t0 + r) * qs.s + d0 + d]) : 0.f;
                }
                stage_keys(Ks, kb, ks, c0, kend, d0, dh);
                __syncthreads();
#pragma unroll 4
                for (int d = 0; d < DK; ++d) {
                    float qv[RPW];
#pragma unroll
                    for (int i = 0; i < RPW; ++i) qv[i] = Qs[(warp * RPW + i) * DK + d];
                    const float cv = Cs[(d0 + d) * TV + lane];
                    const float nv = ns[d0 + d];
#pragma unroll
                    for (int i = 0; i < RPW; ++i) {
                        acc_i[i] += qv[i] * cv;
                        acc_n[i] += qv[i] * nv;
                    }
#pragma unroll
                    for (int j = 0; j < KJ; ++j) {
                        if (j < jmax) {
                            const int s = lane + 32 * j;
                            const float kv = s < kend ? Ks[s * (DK + 1) + d] : 0.f;
#pragma unroll
                            for (int i = 0; i < RPW; ++i) acc_s[i][j] += qv[i] * kv;
                        }
                    }
                }
            }
            // W = scores * D, zero above the diagonal
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const int r = warp * RPW + i;
                const int t = t0 + r;
#pragma unroll
                for (int j = 0; j < KJ; ++j) {
                    const int s = lane + 32 * j;
                    if (j < jmax && s < kend) {
                        float w = 0.f;
                        if (r < rows && s <= t)
                            w = acc_s[i][j] *
                                expf(((csum[t] - csum[s]) + ig[s]) - mrow[t]);
                        Ws[r * c + s] = w;
                    }
                }
            }
            __syncthreads();
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const int r = warp * RPW + i;
                if (r >= rows) continue;             // warp-uniform
                const int t = t0 + r;
                const float* wrow = Ws + r * c;
                float part = 0.f;
                for (int s = lane; s < kend; s += 32) part += wrow[s];
                const float n_intra = warp_sum(part);
                float intra = 0.f;
                for (int s = 0; s < kend; ++s) intra += wrow[s] * Vs[s * TV + lane];
                const float num = intra + acc_i[i] * sq[t];
                const float denom = fmaxf(fabsf(n_intra + acc_n[i] * sq[t]), 1.f);
                if (col < dh)
                    store(h + ((long long)(b * S + c0 + t) * H + hh) * dh + col,
                          num / denom);
            }
        }

        // carry the state to the chunk's end
        if (tid == 0) {
            float mx = tot + m_prev;
            for (int s = 0; s < c; ++s) mx = fmaxf(mx, (tot - csum[s]) + ig[s]);
            scal[0] = mx;
        }
        __syncthreads();
        const float m_next = scal[0];
        const float dec = expf((tot + m_prev) - m_next);
        for (int s = tid; s < c; s += THREADS)
            ws[s] = expf(((tot - csum[s]) + ig[s]) - m_next);
        for (int d0 = 0; d0 < dhp; d0 += DK) {
            __syncthreads();   // ws is written; the previous slice is consumed
            stage_keys(Ks, kb, ks, c0, c, d0, dh);
            __syncthreads();
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const int dr = warp * RPW + i;
                float acc = 0.f;
                for (int s = 0; s < c; ++s)
                    acc += (Ks[s * (DK + 1) + dr] * ws[s]) * Vs[s * TV + lane];
                float* cp = Cs + (d0 + dr) * TV + lane;
                *cp = *cp * dec + acc;
            }
            if (tid < DK) {
                float acc = 0.f;
                for (int s = 0; s < c; ++s) acc += Ks[s * (DK + 1) + tid] * ws[s];
                ns[d0 + tid] = ns[d0 + tid] * dec + acc;
            }
        }
        m_prev = m_next;
    }

    __syncthreads();
    float* Cp = C_out + (long long)plane * dh * dh;
    for (int idx = tid; idx < dh * TV; idx += THREADS) {
        const int d = idx / TV, j = idx - d * TV;
        if (col0 + j < dh) Cp[(long long)d * dh + col0 + j] = Cs[d * TV + j];
    }
    if (blockIdx.x == 0) {
        for (int d = tid; d < dh; d += THREADS) n_out[(long long)plane * dh + d] = ns[d];
        if (tid == 0) m_out[plane] = m_prev;
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* it,
           const float* ft, void* h, float* C, float* n, float* m, int B,
           int S, int H, int dh, int c, Strides qs, Strides ks, Strides vs,
           cudaStream_t stream) {
    const int dhp = (dh + DK - 1) / DK * DK;
    const size_t smem = sizeof(float) * smem_floats(dhp, c);
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((dh + TV - 1) / TV, B * H);
    mlstm_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), it, ft, static_cast<T*>(h), C, n, m, S, H,
        dh, c, qs, ks, vs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and h alike).
// Strides are in elements.  h: (B, S, H, dh) contiguous; C: (B, H, dh, dh),
// n: (B, H, dh), m: (B, H), fp32 and contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int mlstm_launch(const void* q, const void* k, const void* v,
                            const void* it, const void* ft, void* h, void* C,
                            void* n, void* m, int dtype, int B, int S, int H,
                            int dh, int chunk, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, void* stream) {
    if (B < 1 || H < 1 || dh < 1 || dh > MAX_DH || chunk < 1 ||
        chunk > MAX_C || S < 0 || S % chunk != 0)
        return cudaErrorInvalidValue;
    if (S == 0) return cudaErrorInvalidValue;   // the state would be unset
    const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
        vs{v_sb, v_ss, v_sh};
    const float* itf = static_cast<const float*>(it);
    const float* ftf = static_cast<const float*>(ft);
    float* Cf = static_cast<float*>(C);
    float* nf = static_cast<float*>(n);
    float* mf = static_cast<float*>(m);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float>(q, k, v, itf, ftf, h, Cf, nf, mf, B, S,
                                     H, dh, chunk, qs, ks, vs, s);
        case 1: return launch<__nv_bfloat16>(q, k, v, itf, ftf, h, Cf, nf, mf,
                                             B, S, H, dh, chunk, qs, ks, vs, s);
        default: return cudaErrorInvalidValue;
    }
}
