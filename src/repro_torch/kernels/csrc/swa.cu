// Sliding-window causal attention, forward: a query at position p attends
// to keys p-w+1 .. p.  q: (B, S, H, dh); k, v: (B, S, KV, dh), GQA with
// query head h reading kv head h / (H / KV); out: (B, S, H, dh), contiguous,
// in the type of q.  Softmax state (m, l, acc) is fp32 and
// denom = max(l, 1e-30), as in the TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/swa.py:_swa_kernel (swa_pallas).
// That kernel takes chunk = window and keeps a w x w fp32 score tile in
// VMEM; at w = 512 such a tile is 1 MiB, far over the 227 KB of shared
// memory a block may have here.  So the tiles do not depend on the window:
// one block per (query tile, query head, batch) walks the key tiles in
// [q0 - w + 1, q_end] with an online softmax, masking 0 <= qpos - kpos < w
// and kpos < S itself, so no padding is needed.  K and V are read with
// strides straight from (B, S, KV, dh) at the query head's kv head: nothing
// is repeated or transposed.
//
// Bound on this card: at gemma3-1b's prefill (S 1168, H 4, KV 1, dh 256,
// w 512) the operations, 4 dh per (query, key) pair in the band, take
// 1.9 us at the bf16 tensor-core rate, and the bytes of q, k, v and out
// 1.0 us at 3.35 TB/s; at recurrentgemma-2b's (H 10, w 2048) 7.1 us of
// operations.  Both are products of two matrices, so the design puts them
// on the tensor cores:
//  - bf16 and fp16 inputs (the served paths) run swa_tc_kernel: 64 query
//    rows a block, walking 64-key tiles.  S = Q K^T and O += P V are
//    mma.sync.m16n8k16 with fp32 accumulators fed by ldmatrix.  mma.sync and
//    not wgmma: at batch 1 the kernel moves a few GFLOP, leaving the CUDA
//    cores is the whole gain, and its fragment layouts can be checked lane
//    by lane (csrc/mma.cuh).  Q (64 x dh) stays in shared memory; K and V
//    tiles are double-buffered by 16-byte cp.async, the next tile in flight
//    while the current one is computed (about 165 KB at dh 256, so one
//    block an SM).  Rows are padded by 16 bytes so that ldmatrix is free of
//    bank conflicts.  Only tiles that meet the band are visited and only
//    the edge tiles are masked.  The grid puts heads before query tiles, so
//    the longest bands of every head start in the first wave: ordered the
//    other way, recurrentgemma-2b's three longest blocks (19 key tiles)
//    waited for a second wave, and the kernel took 39% longer on an H100.
//    Q K^T of two 16-bit inputs is exact in fp32.  P is fp32, as in the
//    TPU kernel, which rounds nothing: it enters the product as
//    hi = T(P) and lo = T(P - hi), two MMAs into one accumulator, which
//    keeps about 16 bits of it.
//  - With one block an SM, a warp per scheduler would leave every latency
//    (ldmatrix, MMA, exp) exposed.  So a block has 8 warps: warps w and
//    w + 4 share query rows 16 (w % 4) .. + 15 and take keys 0..31 and
//    32..63 of every tile, each with its own online softmax (m, l and the
//    16 x dh accumulator); at the end the second hands its state to the
//    first through shared memory, which merges the two and stores the rows.
//    The softmax runs in log2 units (exp2, with log2(e) folded into the
//    scale), and the P V products are ordered so that no MMA waits on the
//    one just before it.  The unrolled loops over the head dimension run
//    to MAX_DH with no bound known only at run time (columns past dh are
//    zero in shared memory): such a bound cut them into basic blocks that
//    the compiler could not overlap.
//  - fp32 inputs (parity checks only) run swa_kernel, the first version of
//    this kernel on the CUDA cores: scores and P.V in fp32, tiles of 16
//    query rows and 32 keys staged in shared memory as fp32.
// Every sum runs in a fixed order and no atomics are used: a repeated call
// gives the same bits, which the replicas sharing the card rely on.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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

using tc::Strides;

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

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64;            // query rows per block
constexpr int TC_BN = 64;            // keys per tile
constexpr int TC_WARPS = 8;          // warp w: rows 16 (w % 4) .. + 15 and
                                     // keys 32 (w / 4) .. + 31 of each tile
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_PAD = 8;            // elements added to each shared row
constexpr int ND = MAX_DH / 8;       // 8-column blocks of a row of out
constexpr float LOG2E = 1.4426950408889634f;

// Starts the copy of rows row0 .. row0 + 63 (dh elements each, then zeros
// to MAX_DH) of a strided array into dst (ld elements a row): a warp copies
// a row, 16 bytes a lane.  Rows at or past `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride, int row0,
                                          int limit, int dh) {
    tc::load_tile<TC_BM, MAX_DH, TC_THREADS, false>(
        dst, ld, src + row0 * stride, stride, limit - row0, dh);
}

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 1)
swa_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int KV, int dh, int window, Strides qs, Strides ks, Strides vs,
              float scale) {
    using Op = tc::Ops<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int ld = MAX_DH + TC_PAD;          // rows of MAX_DH columns
    T* Qs = reinterpret_cast<T*>(smem_raw);      // TC_BM x ld
    T* Ks = Qs + TC_BM * ld;                     // 2 buffers of TC_BN x ld
    T* Vs = Ks + 2 * TC_BN * ld;                 // 2 buffers of TC_BN x ld

    // the longest bands of every head first: they set the kernel's time
    const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BM;
    const int h = blockIdx.x;
    const int b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int t4 = lane & 3;
    const int wr = (warp & 3) * 16;               // the warp's rows
    const int kh = (warp >> 2) * 32;              // the warp's keys of a tile
    const int row_a = q0 + wr + (lane >> 2);      // this thread's rows: row_a, row_a + 8
    const float sl2 = scale * LOG2E;              // scores in log2 units

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;

    // key tiles that meet the band of rows q0 .. min(q0 + 63, S - 1)
    const int kt0 = max(0, q0 - window + 1) / TC_BN;
    const int kt1 = (min(q0 + TC_BM, S) - 1) / TC_BN;

    // Columns dh .. MAX_DH - 1 of every row are zero-filled by the copies,
    // so that the products below run over MAX_DH columns with no bound
    // known only at run time: a runtime bound inside the unrolled loops
    // would cut them into blocks that the compiler cannot overlap.
    load_tile(Qs, ld, qb, qs.s, q0, S, dh);
    load_tile(Ks, ld, kb, ks.s, kt0 * TC_BN, S, dh);
    load_tile(Vs, ld, vb, vs.s, kt0 * TC_BN, S, dh);
    tc::cp_async_commit();

    float acc[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // online softmax state of the thread's two rows over the warp's keys
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    for (int kt = kt0; kt <= kt1; ++kt) {
        const int buf = (kt - kt0) & 1;
        if (kt < kt1) {    // the next tile's copy overlaps this tile's work
            load_tile(Ks + (buf ^ 1) * TC_BN * ld, ld, kb, ks.s,
                      (kt + 1) * TC_BN, S, dh);
            load_tile(Vs + (buf ^ 1) * TC_BN * ld, ld, vb, vs.s,
                      (kt + 1) * TC_BN, S, dh);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();
        const T* Kt = Ks + buf * TC_BN * ld;
        const T* Vt = Vs + buf * TC_BN * ld;

        // s = Q K^T for the warp's 16 rows and 32 keys
        float s[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MAX_DH / 16; ++kk) {
            uint32_t a[4], bk0[4], bk1[4];
            tc::ldsm_x4(a, tc::a_frag(Qs, ld, wr, kk * 16, lane));
            tc::ldsm_x4(bk0, tc::b_frag(Kt, ld, kh, kk * 16, lane));
            tc::ldsm_x4(bk1, tc::b_frag(Kt, ld, kh + 16, kk * 16, lane));
            Op::mma(s[0], a, bk0[0], bk0[1]);
            Op::mma(s[1], a, bk0[2], bk0[3]);
            Op::mma(s[2], a, bk1[0], bk1[1]);
            Op::mma(s[3], a, bk1[2], bk1[3]);
        }

        // scale and mask; only tiles on the band's edges need the mask
        const int k0 = kt * TC_BN + kh;
        const bool full = k0 + 31 <= q0 && k0 > q0 + TC_BM - 1 - window;
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[nb][e] * sl2;
                if (!full) {
                    const int qp = row_a + ((e >> 1) << 3);
                    const int kp = k0 + nb * 8 + 2 * t4 + (e & 1);
                    const int delta = qp - kp;
                    if (!(delta >= 0 && delta < window && kp < S)) x = NEG_INF;
                }
                s[nb][e] = x;
                if (e < 2) mx0 = fmaxf(mx0, x);
                else mx1 = fmaxf(mx1, x);
            }
        }
        // a row's 32 scores lie in the 4 lanes of a quad
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = s[nb][e];
                const float mn = e < 2 ? mn0 : mn1;
                const float p = full || x != NEG_INF ? exp2f(x - mn) : 0.f;
                s[nb][e] = p;
                if (e < 2) sum0 += p;
                else sum1 += p;
            }
        }
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        l0 = l0 * al0 + sum0;
        l1 = l1 * al1 + sum1;
        m0 = mn0;
        m1 = mn1;
        // a scale of exactly 1 changes nothing: skip it when no row of the
        // warp has a new maximum, as happens for most tiles of a long band
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
            for (int j = 0; j < ND; ++j) {
                acc[j][0] *= al0;
                acc[j][1] *= al0;
                acc[j][2] *= al1;
                acc[j][3] *= al1;
            }
        }

        // acc += P V, P as hi + lo; the score fragments are P's A fragments.
        // Four accumulators at a time, so that an MMA's result is not
        // needed by the next three.
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            uint32_t ph[4], pl[4];
            Op::split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
            Op::split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
            Op::split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
            Op::split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
            for (int nd = 0; nd < MAX_DH / 16; nd += 2) {
                uint32_t b0[4], b1[4];
                tc::ldsm_x4_t(b0, tc::bt_frag(Vt, ld, kh + kk * 16, nd * 16, lane));
                tc::ldsm_x4_t(b1, tc::bt_frag(Vt, ld, kh + kk * 16, nd * 16 + 16,
                                              lane));
                Op::mma(acc[2 * nd], ph, b0[0], b0[1]);
                Op::mma(acc[2 * nd + 1], ph, b0[2], b0[3]);
                Op::mma(acc[2 * nd + 2], ph, b1[0], b1[1]);
                Op::mma(acc[2 * nd + 3], ph, b1[2], b1[3]);
                Op::mma(acc[2 * nd], pl, b0[0], b0[1]);
                Op::mma(acc[2 * nd + 1], pl, b0[2], b0[3]);
                Op::mma(acc[2 * nd + 2], pl, b1[0], b1[1]);
                Op::mma(acc[2 * nd + 3], pl, b1[2], b1[3]);
            }
        }
        __syncthreads();   // this buffer is refilled two tiles on
    }

    // Merge the two warps of a row group: the warp of keys 32..63 of every
    // tile hands (m, l, acc) to the warp of keys 0..31 through the K and V
    // buffers, which are free now, in fragment order: (ND + 1) * 128 floats
    // a warp, half of the buffers' size.
    float* xb = reinterpret_cast<float*>(Ks) + (warp & 3) * (ND + 1) * 128;
    float* xm = xb + ND * 128;                   // m0, m1, l0, l1 by lane
    if (kh) {
#pragma unroll
        for (int j = 0; j < ND; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) xb[(j * 4 + e) * 32 + lane] = acc[j][e];
        xm[lane] = m0;
        xm[32 + lane] = m1;
        xm[64 + lane] = l0;
        xm[96 + lane] = l1;
    }
    __syncthreads();
    if (kh) return;
    const float mb0 = xm[lane], mb1 = xm[32 + lane];
    const float mx0 = fmaxf(m0, mb0), mx1 = fmaxf(m1, mb1);
    const float fa0 = exp2f(m0 - mx0), fb0 = exp2f(mb0 - mx0);
    const float fa1 = exp2f(m1 - mx1), fb1 = exp2f(mb1 - mx1);
    const float d0 = fmaxf(l0 * fa0 + xm[64 + lane] * fb0, 1e-30f);
    const float d1 = fmaxf(l1 * fa1 + xm[96 + lane] * fb1, 1e-30f);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int qp = row_a + 8 * hr;
        if (qp >= S) continue;
        const float fa = hr ? fa1 : fa0, fb = hr ? fb1 : fb0;
        const float den = hr ? d1 : d0;
        T* orow = o + ((long long)(b * S + qp) * H + h) * dh + 2 * t4;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            if (j * 8 < dh) {
                const float x0 = acc[j][2 * hr] * fa +
                                 xb[(j * 4 + 2 * hr) * 32 + lane] * fb;
                const float x1 = acc[j][2 * hr + 1] * fa +
                                 xb[(j * 4 + 2 * hr + 1) * 32 + lane] * fb;
                *reinterpret_cast<uint32_t*>(orow + j * 8) =
                    Op::pack(x0 / den, x1 / den);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
int launch_core(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int dh, int window, Strides qs,
                Strides ks, Strides vs, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) *
        (size_t)(BQ * dh + BK * (dh + 1) + BK * dh + BQ * BK);
    cudaError_t err = cudaFuncSetAttribute(
        swa_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    swa_kernel<float><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, dh,
        window, qs, ks, vs, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int dh, int window, Strides qs,
              Strides ks, Strides vs, float scale, cudaStream_t stream) {
    if (dh % 16 != 0 || !tc::aligned16(q, qs) || !tc::aligned16(k, ks) ||
        !tc::aligned16(v, vs))
        return cudaErrorInvalidValue;
    const size_t smem =
        sizeof(T) * (size_t)(TC_BM + 4 * TC_BN) * (size_t)(MAX_DH + TC_PAD);
    cudaError_t err = cudaFuncSetAttribute(
        swa_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(H, (S + TC_BM - 1) / TC_BM, B);
    swa_tc_kernel<T><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, dh, window,
        qs, ks, vs, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16, 2 = float16 (the
// tensor-core kernel, which takes dh a multiple of 16, 16-byte aligned q, k
// and v, and strides that are multiples of 8 elements); q, k, v and out
// alike.  Strides are in elements.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
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
        case 0: return launch_core(q, k, v, o, B, S, H, KV, dh, window, qs,
                                   ks, vs, scale, s);
        case 1: return launch_tc<__nv_bfloat16>(q, k, v, o, B, S, H, KV, dh,
                                                window, qs, ks, vs, scale, s);
        case 2: return launch_tc<__half>(q, k, v, o, B, S, H, KV, dh, window,
                                         qs, ks, vs, scale, s);
        default: return cudaErrorInvalidValue;
    }
}
