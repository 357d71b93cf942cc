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
// h is written in T; the final (C, n, m) in fp32, which the model's decode
// starts from.
//
// Replaces the TPU kernel src/repro/kernels/mlstm.py:_mlstm_kernel
// (mlstm_pallas).  That kernel walks the chunks of a plane in order and
// holds C whole in VMEM; at xlstm-1.3b (dh = 512) C is 1 MiB of fp32, far
// over the 227 KB of shared memory a block may have here, and at batch 1
// there are only 4 planes for the card's 132 SMs.
//
// Bound on this card (chip_smoke.mlstm_bound_ms): at xlstm-1.3b's longest
// prefill (S 1024 after padding, H 4, dh 512, c 256, bf16) the products
// q.k^T and W.V over the c(c+1)/2 causal pairs and q.C and the C update
// over c x dh x dh come to 5.4 GFLOP, 5.4 us at the bf16 tensor-core rate,
// and the bytes of q, k, v, h, the gates and the state to 21 MB, 6.3 us at
// 3.35 TB/s: bound by bytes, barely.  What the design does about it:
//  - Two facts split the work.  The stabiliser chain m and every D entry,
//    sq_t, w_s and dec depend on the gates alone; only q.C_{j-1} and
//    q.n_{j-1} need the carried state.  So bf16 inputs (the served path)
//    run two launches on one stream, with no host synchronisation:
//    * mlstm_state_kernel, one block per (plane, 64 rows of C, 128 columns
//      of C): 128 blocks at xlstm-1.3b.  Each block scans its plane's
//      gates chunk by chunk (cumulative sums in a fixed order by one warp)
//      and walks the chunks, keeping its C tile in fp32 registers.  Before
//      chunk j it writes the tile to scratch, C_in[plane, j], the state
//      entering chunk j, as a bf16 hi/lo pair (blocks of column tile 0 also
//      write n_in, one block m_in); then C <- dec C + (k w)^T V.
//    * mlstm_out_kernel, one block per (plane, chunk, 64 query rows, 128
//      value columns): 256 blocks at S 1024, all chunks at once.  It keeps
//      its Q tile in shared memory, computes num = sq (q . C_in) first, then
//      for each key tile at or below the diagonal the scores q.k^T over dh,
//      W = scores * D (stabilisers from a prefix max of i_s - csum_s),
//      n_intra = rowsum W and num += W V; h = num / max(|n_intra + sq q.n_in|, 1).
//      Scores are recomputed once per value tile: dh / 128 = 4 times.
//  - Every product runs on the tensor cores as mma.sync.m16n8k16 (bf16 in,
//    fp32 accumulate), fed by ldmatrix from shared memory; tiles arrive by
//    16-byte cp.async, double-buffered, the next in flight while the current
//    one is computed.  mma.sync and not wgmma: the kernel moves a few GFLOP,
//    leaving the CUDA cores is the whole gain, and its fragment layouts can
//    be checked lane by lane (csrc/mma.cuh).  q.k^T and k.V of bf16 inputs
//    are exact in fp32.  The fp32 operands (k w, W and C_in) enter as
//    hi = bf16(x) and lo = bf16(x - hi), two MMAs into one accumulator,
//    which keeps about 16 bits: the TPU kernel rounds nothing.
//  - fp32 inputs (parity checks only) run mlstm_kernel, the first version of
//    this kernel on the CUDA cores: one block per (plane, 32 value columns)
//    walking the chunks with C[:, tile] in shared memory.
// Every sum runs in a fixed order and no atomics are used, so a repeated
// call gives the same bits, which the replicas sharing the card rely on.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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

using tc::Strides;

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

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): a state pass and an output pass
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using Op = tc::Ops<bf16>;

constexpr int TB = 64;               // rows of a tile: query rows, C rows, keys
constexpr int TE = 128;              // value columns of a tile
constexpr int TC_THREADS = 128;      // 4 warps
constexpr int PAD = 8;               // elements added to each shared row
constexpr int LDK = TB + PAD;        // shared row of 64 values
constexpr int LDE = TE + PAD;        // shared row of 128 values

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

// Starts the copy of a TB x NCOLS tile (tc::load_tile) by the block's
// threads.
template <int NCOLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows_ok,
                                          int cols_ok) {
    tc::load_tile<TB, NCOLS, TC_THREADS>(dst, ld, src, stride, rows_ok,
                                         cols_ok);
}

// Inclusive scan (sum, or max if kMax) of x[0 .. n), n <= 256, in shared
// memory, by one warp in a fixed order: lane l runs over x[8l .. 8l + 7],
// then the lanes' totals are scanned by shuffles.
template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
    return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__device__ void warp_scan(float* x, int n, int lane) {
    const float id = kMax ? NEG_INF : 0.f;
    float part[8];
    float run = id;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int j = lane * 8 + i;
        if (j < n) run = combine<kMax>(run, x[j]);
        part[i] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot = combine<kMax>(y, tot);
    }
    float before = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) before = id;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int j = lane * 8 + i;
        if (j < n) x[j] = combine<kMax>(before, part[i]);
    }
}

// Chunk [c0, c0 + c)'s gates into shared memory: csum (the cumulative
// log-sigmoid forget gates) and ig (the input gates).  All threads call it.
__device__ void chunk_gates(const float* itb, const float* ftb, int H, int c0,
                            int c, float* csum, float* ig) {
    for (int s = threadIdx.x; s < c; s += TC_THREADS) {
        csum[s] = log_sigmoid(ftb[(long long)(c0 + s) * H]);
        ig[s] = itb[(long long)(c0 + s) * H];
    }
    __syncthreads();
    if (threadIdx.x < 32) warp_scan<false>(csum, c, threadIdx.x);
    __syncthreads();
}

// State pass.  Grid (column tile of TE, row tile of TB, plane).  Writes, for
// every chunk j, the state entering it: C_in[plane, j] as (hi, lo) bf16
// (plane, nc, 2, dh, dh), n_in (plane, nc, dh) and m_in (plane, nc); and the
// final C, n, m.  Warps split the 64 x 128 C tile 2 x 2 (32 x 64 each).
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ it, const float* __restrict__ ft,
                   bf16* __restrict__ C_in, float* __restrict__ n_in,
                   float* __restrict__ m_in, float* __restrict__ C_out,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   int S, int H, int dh, int c, Strides ks, Strides vs) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Kst = reinterpret_cast<bf16*>(smem_raw);   // 2 stages of TB x LDK
    bf16* Vst = Kst + 2 * TB * LDK;                   // 2 stages of TB x LDE
    bf16* Khi = Vst + 2 * TB * LDE;                   // TB x LDK: (k w) hi
    bf16* Klo = Khi + TB * LDK;                       // TB x LDK: (k w) lo
    float* csum = reinterpret_cast<float*>(Klo + TB * LDK);   // MAX_C
    float* ig = csum + MAX_C;
    float* ws = ig + MAX_C;
    float* red = ws + MAX_C;                          // 4

    const int e0 = blockIdx.x * TE;
    const int d0 = blockIdx.y * TB;
    const int plane = blockIdx.z;
    const int b = plane / H, hh = plane - b * H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;   // warp's sub-tile
    const bool with_n = blockIdx.x == 0 && tid < TB && d0 + tid < dh;

    const bf16* kb = k + b * ks.b + hh * ks.h + d0;
    const bf16* vb = v + b * vs.b + hh * vs.h + e0;
    const float* itb = it + (long long)b * S * H + hh;
    const float* ftb = ft + (long long)b * S * H + hh;

    const int nc = S / c;
    const int nsub = (c + TB - 1) / TB;      // key tiles a chunk
    const int total = nc * nsub;
    auto issue = [&](int step) {
        const int j = step / nsub, sub = step - j * nsub;
        const long long s0 = (long long)j * c + sub * TB;
        const int st = step & 1;
        load_tile<TB>(Kst + st * TB * LDK, LDK, kb + s0 * ks.s, ks.s,
                      c - sub * TB, dh - d0);
        load_tile<TE>(Vst + st * TB * LDE, LDE, vb + s0 * vs.s, vs.s,
                      c - sub * TB, dh - e0);
        tc::cp_async_commit();
    };
    issue(0);

    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
            acc[mt][nb][0] = acc[mt][nb][1] = acc[mt][nb][2] = acc[mt][nb][3] = 0.f;
    float n_run = 0.f, m_prev = NEG_INF;

    for (int j = 0; j < nc; ++j) {
        chunk_gates(itb, ftb, H, j * c, c, csum, ig);
        const float tot = csum[c - 1];
        float mx = NEG_INF;
        for (int s = tid; s < c; s += TC_THREADS)
            mx = fmaxf(mx, (tot - csum[s]) + ig[s]);
        mx = warp_max(mx);
        if (lane == 0) red[warp] = mx;
        __syncthreads();
        mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
        const float m_next = fmaxf(tot + m_prev, mx);
        const float dec = expf((tot + m_prev) - m_next);
        for (int s = tid; s < nsub * TB; s += TC_THREADS)
            ws[s] = s < c ? expf(((tot - csum[s]) + ig[s]) - m_next) : 0.f;

        // the state entering chunk j
        const long long cin = ((long long)plane * nc + j) * 2 * dh * dh;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int d = d0 + wm + mt * 16 + g + 8 * hr;
                    const int e = e0 + wn + nb * 8 + 2 * t4;
                    if (d < dh && e < dh) {
                        uint32_t hi, lo;
                        Op::split(acc[mt][nb][2 * hr], acc[mt][nb][2 * hr + 1],
                                  hi, lo);
                        bf16* p = C_in + cin + (long long)d * dh + e;
                        *reinterpret_cast<uint32_t*>(p) = hi;
                        *reinterpret_cast<uint32_t*>(p + (long long)dh * dh) = lo;
                    }
                }
            }
        }
        if (with_n) n_in[((long long)plane * nc + j) * dh + d0 + tid] = n_run;
        if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
            m_in[(long long)plane * nc + j] = m_prev;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[mt][nb][i] *= dec;

        float n_chunk = 0.f;
        for (int sub = 0; sub < nsub; ++sub) {
            const int step = j * nsub + sub;
            if (step + 1 < total) {
                issue(step + 1);
                tc::cp_async_wait<1>();
            } else {
                tc::cp_async_wait<0>();
            }
            __syncthreads();
            const bf16* Kt = Kst + (step & 1) * TB * LDK;
            const bf16* Vt = Vst + (step & 1) * TB * LDE;
            const float* w = ws + sub * TB;
            // k w as hi + lo, row s of the tile scaled by w_s
            for (int idx = tid; idx < TB * (TB / 2); idx += TC_THREADS) {
                const int r = idx / (TB / 2), c2 = (idx - r * (TB / 2)) * 2;
                const float2 kf = Op::unpack(
                    *reinterpret_cast<const uint32_t*>(Kt + r * LDK + c2));
                uint32_t hi, lo;
                Op::split(kf.x * w[r], kf.y * w[r], hi, lo);
                *reinterpret_cast<uint32_t*>(Khi + r * LDK + c2) = hi;
                *reinterpret_cast<uint32_t*>(Klo + r * LDK + c2) = lo;
            }
            if (with_n) {
                for (int r = 0; r < TB; ++r)
                    n_chunk += __bfloat162float(Kt[r * LDK + tid]) * w[r];
            }
            __syncthreads();
            // C[d, e] += sum_s (k w)[s, d] v[s, e]
#pragma unroll
            for (int kk = 0; kk < TB / 16; ++kk) {
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    tc::ldsm_x4_t(ah[mt], tc::at_frag(Khi, LDK, kk * 16,
                                                      wm + mt * 16, lane));
                    tc::ldsm_x4_t(al[mt], tc::at_frag(Klo, LDK, kk * 16,
                                                      wm + mt * 16, lane));
                }
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) {
                    uint32_t bv[4];
                    tc::ldsm_x4_t(bv, tc::bt_frag(Vt, LDE, kk * 16,
                                                  wn + nb * 16, lane));
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt) {
                        Op::mma(acc[mt][2 * nb], ah[mt], bv[0], bv[1]);
                        Op::mma(acc[mt][2 * nb + 1], ah[mt], bv[2], bv[3]);
                        Op::mma(acc[mt][2 * nb], al[mt], bv[0], bv[1]);
                        Op::mma(acc[mt][2 * nb + 1], al[mt], bv[2], bv[3]);
                    }
                }
            }
            __syncthreads();   // this stage is refilled two steps on
        }
        n_run = n_run * dec + n_chunk;
        m_prev = m_next;
    }

    float* Cp = C_out + (long long)plane * dh * dh;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int d = d0 + wm + mt * 16 + g + 8 * hr;
                const int e = e0 + wn + nb * 8 + 2 * t4;
                if (d < dh && e < dh)
                    *reinterpret_cast<float2*>(Cp + (long long)d * dh + e) =
                        make_float2(acc[mt][nb][2 * hr], acc[mt][nb][2 * hr + 1]);
            }
        }
    }
    if (with_n) n_out[(long long)plane * dh + d0 + tid] = n_run;
    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) m_out[plane] = m_prev;
}

// Output pass.  Grid (value tile of TE, query tile of TB, plane * nc + chunk).
// Warp w owns query rows 16 w .. 16 w + 15 of the tile.
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_out_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ it,
                 const float* __restrict__ ft, const bf16* __restrict__ C_in,
                 const float* __restrict__ n_in, const float* __restrict__ m_in,
                 bf16* __restrict__ h, int S, int H, int dh, int c, Strides qs,
                 Strides ks, Strides vs) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int dhp = (dh + TB - 1) / TB * TB;     // dh in whole 64-slices
    const int ldq = dhp + PAD;
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // TB x ldq
    bf16* Kst = Qs + TB * ldq;                        // 2 stages of TB x LDK
    bf16* Vst = Kst + 2 * TB * LDK;                   // 2 stages of TB x LDE
    bf16* Cst = Vst + 2 * TB * LDE;                   // 2 stages of (hi, lo) TB x LDE
    float* csum = reinterpret_cast<float*>(Cst + 4 * TB * LDE);   // MAX_C
    float* ig = csum + MAX_C;
    float* pm = ig + MAX_C;                           // prefix max of i_s - csum_s
    float* ns = pm + MAX_C;                           // n_in, dhp
    float* qn = ns + dhp;                             // q . n_in, TB

    const int e0 = blockIdx.x * TE;
    const int qt = gridDim.y - 1 - blockIdx.y;   // longest rows first
    const int t0 = qt * TB;
    const int nc = S / c;
    const int plane = blockIdx.z / nc, j = blockIdx.z - plane * (S / c);
    const int b = plane / H, hh = plane - b * H;
    const int c0 = j * c;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int nds = dhp / TB;                    // 64-slices of dh

    const bf16* qb = q + b * qs.b + hh * qs.h + (long long)(c0 + t0) * qs.s;
    const bf16* kb = k + b * ks.b + hh * ks.h + (long long)c0 * ks.s;
    const bf16* vb = v + b * vs.b + hh * vs.h + (long long)c0 * vs.s + e0;
    const bf16* cb = C_in + ((long long)plane * nc + j) * 2 * dh * dh + e0;
    const float* itb = it + (long long)b * S * H + hh;
    const float* ftb = ft + (long long)b * S * H + hh;

    for (int ds = 0; ds < dhp / TB; ++ds)
        load_tile<TB>(Qs + ds * TB, ldq, qb + ds * TB, qs.s, c - t0,
                      dh - ds * TB);
    tc::cp_async_commit();

    // steps: nA slices of q.C_in, then (qt + 1) key tiles x nds slices
    const int nA = nds;
    const int total = nA + (qt + 1) * nds;
    auto issue = [&](int step) {
        if (step < nA) {
            bf16* dst = Cst + (step & 1) * 2 * TB * LDE;
            const bf16* src = cb + (long long)step * TB * dh;
            load_tile<TE>(dst, LDE, src, dh, dh - step * TB, dh - e0);
            load_tile<TE>(dst + TB * LDE, LDE, src + (long long)dh * dh, dh,
                          dh - step * TB, dh - e0);
        } else {
            const int u = step - nA, kt = u / nds, ds = u - kt * nds;
            load_tile<TB>(Kst + (u & 1) * TB * LDK, LDK,
                          kb + (long long)kt * TB * ks.s + ds * TB, ks.s,
                          c - kt * TB, dh - ds * TB);
            if (ds == 0)
                load_tile<TE>(Vst + (kt & 1) * TB * LDE, LDE,
                              vb + (long long)kt * TB * vs.s, vs.s,
                              c - kt * TB, dh - e0);
        }
        tc::cp_async_commit();
    };
    issue(0);

    // gates, stabilisers and n_in while the first tiles are in flight
    chunk_gates(itb, ftb, H, c0, c, csum, ig);
    for (int s = tid; s < c; s += TC_THREADS) pm[s] = ig[s] - csum[s];
    const float* nsrc = n_in + ((long long)plane * nc + j) * dh;
    for (int d = tid; d < dhp; d += TC_THREADS) ns[d] = d < dh ? nsrc[d] : 0.f;
    __syncthreads();
    if (tid < 32) warp_scan<true>(pm, c, tid);
    __syncthreads();
    const float m_prev = m_in[(long long)plane * nc + j];
    const int ta = t0 + warp * 16 + g;           // this thread's rows: ta, ta + 8
    float cs[2], mr[2], sq[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int t = ta + 8 * i;
        if (t < c) {
            cs[i] = csum[t];
            const float bt = cs[i] + m_prev;
            mr[i] = fmaxf(cs[i] + pm[t], bt);
            sq[i] = expf(bt - mr[i]);
        } else {
            cs[i] = mr[i] = sq[i] = 0.f;
        }
    }

    float acc[TE / 8][4];
#pragma unroll
    for (int nb = 0; nb < TE / 8; ++nb)
        acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
    float sc[8][4];
    float nsum[2] = {0.f, 0.f};

    for (int step = 0; step < total; ++step) {
        if (step + 1 < total) {
            issue(step + 1);
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();
        if (step < nA) {
            // acc += q C_in[slice, value tile], C_in as hi + lo
            const bf16* Ch = Cst + (step & 1) * 2 * TB * LDE;
            const bf16* Cl = Ch + TB * LDE;
#pragma unroll
            for (int kk = 0; kk < TB / 16; ++kk) {
                uint32_t a[4];
                tc::ldsm_x4(a, tc::a_frag(Qs, ldq, warp * 16,
                                          step * TB + kk * 16, lane));
#pragma unroll
                for (int nb = 0; nb < TE / 16; ++nb) {
                    uint32_t bh[4], bl[4];
                    tc::ldsm_x4_t(bh, tc::bt_frag(Ch, LDE, kk * 16, nb * 16, lane));
                    tc::ldsm_x4_t(bl, tc::bt_frag(Cl, LDE, kk * 16, nb * 16, lane));
                    Op::mma(acc[2 * nb], a, bh[0], bh[1]);
                    Op::mma(acc[2 * nb + 1], a, bh[2], bh[3]);
                    Op::mma(acc[2 * nb], a, bl[0], bl[1]);
                    Op::mma(acc[2 * nb + 1], a, bl[2], bl[3]);
                }
            }
            if (step == nA - 1) {
#pragma unroll
                for (int nb = 0; nb < TE / 8; ++nb) {
                    acc[nb][0] *= sq[0];
                    acc[nb][1] *= sq[0];
                    acc[nb][2] *= sq[1];
                    acc[nb][3] *= sq[1];
                }
            }
        } else {
            const int u = step - nA, kt = u / nds, ds = u - kt * nds;
            if (ds == 0) {
#pragma unroll
                for (int nb = 0; nb < 8; ++nb)
                    sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
            }
            // scores q.k^T over this slice of dh
            const bf16* Kt = Kst + (u & 1) * TB * LDK;
#pragma unroll
            for (int kk = 0; kk < TB / 16; ++kk) {
                uint32_t a[4];
                tc::ldsm_x4(a, tc::a_frag(Qs, ldq, warp * 16, ds * TB + kk * 16,
                                          lane));
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) {
                    uint32_t bk[4];
                    tc::ldsm_x4(bk, tc::b_frag(Kt, LDK, nb * 16, kk * 16, lane));
                    Op::mma(sc[2 * nb], a, bk[0], bk[1]);
                    Op::mma(sc[2 * nb + 1], a, bk[2], bk[3]);
                }
            }
            if (ds == nds - 1) {
                // W = scores * D, zero above the diagonal and past the chunk
                const bool full = kt < qt && t0 + TB <= c;
#pragma unroll
                for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e >> 1;
                        const int t = ta + 8 * i;
                        const int s = kt * TB + nb * 8 + 2 * t4 + (e & 1);
                        float w = 0.f;
                        if (full || (s <= t && t < c))
                            w = sc[nb][e] *
                                expf(((cs[i] - csum[s]) + ig[s]) - mr[i]);
                        sc[nb][e] = w;
                        nsum[i] += w;
                    }
                }
                // acc += W V, W as hi + lo
                const bf16* Vt = Vst + (kt & 1) * TB * LDE;
#pragma unroll
                for (int kk = 0; kk < TB / 16; ++kk) {
                    uint32_t wh[4], wl[4];
                    Op::split(sc[2 * kk][0], sc[2 * kk][1], wh[0], wl[0]);
                    Op::split(sc[2 * kk][2], sc[2 * kk][3], wh[1], wl[1]);
                    Op::split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], wh[2], wl[2]);
                    Op::split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], wh[3], wl[3]);
#pragma unroll
                    for (int nb = 0; nb < TE / 16; ++nb) {
                        uint32_t bv[4];
                        tc::ldsm_x4_t(bv, tc::bt_frag(Vt, LDE, kk * 16, nb * 16,
                                                      lane));
                        Op::mma(acc[2 * nb], wh, bv[0], bv[1]);
                        Op::mma(acc[2 * nb + 1], wh, bv[2], bv[3]);
                        Op::mma(acc[2 * nb], wl, bv[0], bv[1]);
                        Op::mma(acc[2 * nb + 1], wl, bv[2], bv[3]);
                    }
                }
            }
        }
        __syncthreads();   // this stage is refilled two steps on
    }

    // q . n_in for the warp's 16 rows, on the CUDA cores
    for (int r = 0; r < 16; ++r) {
        const bf16* qrow = Qs + (warp * 16 + r) * ldq;
        float part = 0.f;
        for (int d = lane; d < dhp; d += 32)
            part += __bfloat162float(qrow[d]) * ns[d];
        part = warp_sum(part);
        if (lane == 0) qn[warp * 16 + r] = part;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int t = ta + 8 * i;
        float n_intra = nsum[i];
        n_intra += __shfl_xor_sync(0xffffffffu, n_intra, 1);
        n_intra += __shfl_xor_sync(0xffffffffu, n_intra, 2);
        if (t >= c) continue;
        const float n_inter = qn[warp * 16 + g + 8 * i] * sq[i];
        const float den = fmaxf(fabsf(n_intra + n_inter), 1.f);
        bf16* hrow = h + ((long long)(b * S + c0 + t) * H + hh) * dh + 2 * t4;
#pragma unroll
        for (int nb = 0; nb < TE / 8; ++nb) {
            if (e0 + nb * 8 < dh)
                *reinterpret_cast<uint32_t*>(hrow + e0 + nb * 8) = Op::pack(
                    acc[nb][2 * i] / den, acc[nb][2 * i + 1] / den);
        }
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
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

int launch_tc(const void* q, const void* k, const void* v, const float* it,
              const float* ft, void* h, float* C, float* n, float* m,
              void* C_in, float* n_in, float* m_in, int B, int S, int H,
              int dh, int c, Strides qs, Strides ks, Strides vs,
              cudaStream_t stream) {
    if (dh % 8 != 0 || !tc::aligned16(q, qs) || !tc::aligned16(k, ks) ||
        !tc::aligned16(v, vs) || C_in == nullptr || n_in == nullptr ||
        m_in == nullptr)
        return cudaErrorInvalidValue;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* cin = static_cast<bf16*>(C_in);
    const int nc = S / c;
    const int P = B * H;

    const size_t smem_state = sizeof(bf16) * (size_t)(4 * TB * LDK + 2 * TB * LDE) +
                              sizeof(float) * (3 * MAX_C + 4);
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_state);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_state((dh + TE - 1) / TE, (dh + TB - 1) / TB, P);
    mlstm_state_kernel<<<grid_state, TC_THREADS, smem_state, stream>>>(
        kp, vp, it, ft, cin, n_in, m_in, C, n, m, S, H, dh, c, ks, vs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const int dhp = (dh + TB - 1) / TB * TB;
    const size_t smem_out =
        sizeof(bf16) * ((size_t)TB * (dhp + PAD) + 2 * TB * LDK + 6 * TB * LDE) +
        sizeof(float) * (3 * MAX_C + dhp + TB);
    err = cudaFuncSetAttribute(mlstm_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_out);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_out((dh + TE - 1) / TE, (c + TB - 1) / TB, P * nc);
    mlstm_out_kernel<<<grid_out, TC_THREADS, smem_out, stream>>>(
        qp, kp, vp, it, ft, cin, n_in, m_in, static_cast<bf16*>(h), S, H, dh,
        c, qs, ks, vs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the two
// tensor-core passes, which take dh a multiple of 8, 16-byte aligned q, k
// and v with strides that are multiples of 8 elements, and the scratch
// C_in: (B H, S / chunk, 2, dh, dh) bf16, n_in: (B H, S / chunk, dh) fp32,
// m_in: (B H, S / chunk) fp32, all contiguous); q, k, v and h alike.
// Strides are in elements.  h: (B, S, H, dh) contiguous; C: (B, H, dh, dh),
// n: (B, H, dh), m: (B, H), fp32 and contiguous.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int mlstm_launch(const void* q, const void* k, const void* v,
                            const void* it, const void* ft, void* h, void* C,
                            void* n, void* m, void* C_in, void* n_in,
                            void* m_in, int dtype, int B, int S, int H,
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
        case 1: return launch_tc(q, k, v, itf, ftf, h, Cf, nf, mf, C_in,
                                 static_cast<float*>(n_in),
                                 static_cast<float*>(m_in), B, S, H, dh,
                                 chunk, qs, ks, vs, s);
        default: return cudaErrorInvalidValue;
    }
}
