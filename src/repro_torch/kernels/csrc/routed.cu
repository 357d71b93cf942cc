// Routed experts of an MoE FFN for a few tokens (T <= 32, T * k <= the
// experts held): for each (token, slot) whose expert e lies in
// [e0, e0 + e_local),
//   h = x W_gate[e],  u = x W_up[e],  y = (silu(h) * u) W_down[e],
// and each token's output is the sum of bf16(y * bf16(w)) over its held
// slots, added one at a time in ascending expert index, in the activation
// dtype.  That is what models/moe.py's buffer path computes when nothing is
// dropped, rounded at the same places: h, u, silu(h), the product and y to
// the activation dtype, the sums in fp32.
//
// Replaces no TPU kernel: the JAX package leaves its routed FFN to XLA over
// an (E, C, D) buffer, and so did the port.  At T = 1 that buffer streams
// every held expert's three matrices for one token's k experts (128 of them
// in Qwen3-235B-A22B), where the work needs only the routed ones.
//
// Bound: memory.  A slot's three D x F matrices are read once each, two
// flops a weight, so the floor is the routed, held experts' bytes over
// 3.35 TB/s (Qwen3-235B-A22B: 8 x 37.7 MB a layer, 90 us; K-EXAONE's held
// 16 of 128: about one expert, 75.5 MB, 23 us).  The weights are read where
// they lie, through their strides: no gather copy.  A token's single held
// slot has to keep the whole card streaming, so both reductions are cut
// over a cluster of 8 blocks (Hopper's distributed shared memory):
//   gate_up  a cluster owns (slot, 64 columns of F) and splits D in 8; a
//            block reads its D-chunk of W_gate and W_up, 16 bytes a thread,
//            8 threads across a row's 64 columns, 32 row lanes with 2 rows
//            each in flight; the cluster's partial sums meet in rank order,
//            and each rank finishes 8 of the columns: h, u, silu, the
//            product -> p.  Grid row j takes the j-th held route in slot
//            order, so the held routes' blocks come first and a route not
//            held costs a row of blocks that look at the routes and exit.
//   down     a cluster owns (token, 128 columns of D) and splits F in 8;
//            it walks the token's held slots in ascending expert order,
//            each block reading its F-chunk of W_down (16 threads across a
//            row, 16 row lanes with 4 rows each in flight), then each rank
//            sums the 8 partials of its 16 columns in rank order, rounds y,
//            weighs it and adds it to the token's output.
// Both take at most 64 registers a thread, so 4 blocks share an SM and
// their loads overlap one another's reductions and cluster barriers.  The tile widths,
// rows in flight and blocks an SM were the fastest of those measured on an
// H100 (PERF.md).
// Every sum has a fixed order (rows in a thread, then the warp's row
// lanes by shuffles, then the 8 warps, then the 8 ranks) and there are no
// atomics, so a repeated call gives the same bits.  In fp32 (4 columns a
// load) a tile is half as wide; products and sums outside the fp32
// accumulations are rounded apart (__fmul_rn, __fadd_rn), as PyTorch's
// separate operators round them.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;                 // blocks that split a reduction
// threads across a row's 16-byte column groups, and rows a thread has in
// flight, for gate_up (A) and down (B)
constexpr int CT_A = 8, U_A = 2;
constexpr int CT_B = 16, U_B = 4;
constexpr int KMAX = 16;                   // slots a token
constexpr unsigned FULL = 0xffffffffu;

// bf16 activations and weights: 8 to a 16-byte load
struct Bf16 {
    using T = __nv_bfloat16;
    static constexpr int N = 8;
    __device__ static void unpack(uint4 r, float* f) {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    __device__ static float get(const T* p) { return __bfloat162float(*p); }
    __device__ static T make(float v) { return __float2bfloat16_rn(v); }
    __device__ static float rnd(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
};

// fp32: 4 to a load, nothing to round
struct F32 {
    using T = float;
    static constexpr int N = 4;
    __device__ static void unpack(uint4 r, float* f) {
        f[0] = __uint_as_float(r.x);
        f[1] = __uint_as_float(r.y);
        f[2] = __uint_as_float(r.z);
        f[3] = __uint_as_float(r.w);
    }
    __device__ static float get(const T* p) { return *p; }
    __device__ static T make(float v) { return v; }
    __device__ static float rnd(float v) { return v; }
};

__device__ __forceinline__ bool held(long long e, long long e0, int e_local) {
    return e >= e0 && e < e0 + e_local;
}

// The slot of the j-th held route of the n = T * k routes, in slot order,
// or -1 where fewer are held.  Warp 0 looks at 32 routes a round; every
// thread gets the answer.
__device__ int jth_held(const int64_t* top_e, long long ld_e, int n, int k,
                        long long e0, int e_local, int j, int* s_slot) {
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int found = -1, before = 0;
        for (int base = 0; base < n && found < 0; base += 32) {
            const int i = base + lane;
            const bool h = i < n &&
                held(top_e[(i / k) * ld_e + i % k], e0, e_local);
            const unsigned mask = __ballot_sync(FULL, h);
            const int want = j - before;
            if (want < __popc(mask)) {
                const bool me = h && __popc(mask & ((1u << lane) - 1)) == want;
                found = base + __ffs(__ballot_sync(FULL, me)) - 1;
            }
            before += __popc(mask);
        }
        if (lane == 0) *s_slot = found;
    }
    __syncthreads();
    return *s_slot;
}

// Adds the row lanes of a warp (lanes CT apart): every lane gets the sum.
template <int N, int CT>
__device__ __forceinline__ void warp_rows(float* a) {
#pragma unroll
    for (int off = CT; off < 32; off <<= 1) {
#pragma unroll
        for (int v = 0; v < N; ++v) a[v] += __shfl_xor_sync(FULL, a[v], off);
    }
}

// gate_up: block row j finds the j-th held route (so held routes come first
// in the grid and the rows past them exit at once); its cluster owns 64
// columns of F (32 in fp32) and splits D over its 8 ranks.
template <class E>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 4)
gate_up_kernel(const typename E::T* __restrict__ x, long long ld_x,
               const int64_t* __restrict__ top_e, long long ld_e,
               const typename E::T* __restrict__ wg, long long sg_e,
               long long sg_d, const typename E::T* __restrict__ wu,
               long long su_e, long long su_d, typename E::T* __restrict__ p,
               int n, int k, int D, int F, long long e0, int e_local) {
    using T = typename E::T;
    constexpr int N = E::N, CT = CT_A, U = U_A, LANES = THREADS / CT;
    constexpr int TC = CT * N, OWN = TC / CLUSTER;
    __shared__ float red[WARPS][2][TC];
    __shared__ float part[2][TC];
    __shared__ int s_slot;
    const int slot = jth_held(top_e, ld_e, n, k, e0, e_local, blockIdx.y,
                              &s_slot);
    if (slot < 0) return;                 // the same in the whole cluster
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tile = blockIdx.x / CLUSTER;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int ct = lane % CT;
    const int rl = warp * (32 / CT) + lane / CT;
    const int col = tile * TC + ct * N;
    const int chunk = (D + CLUSTER - 1) / CLUSTER;
    const int r0 = rank * chunk, r1 = min(D, r0 + chunk);
    const int tok = slot / k;
    const long long e = top_e[tok * ld_e + slot % k] - e0;
    const T* xr = x + tok * ld_x;
    const T* g = wg + e * sg_e + col;
    const T* u = wu + e * su_e + col;

    float ag[N], au[N];
#pragma unroll
    for (int v = 0; v < N; ++v) ag[v] = au[v] = 0.f;
    if (col < F) {
        for (int r = r0 + rl; r < r1; r += LANES * U) {
            uint4 rg[U], ru[U];
            float xv[U];
#pragma unroll
            for (int i = 0; i < U; ++i) {
                const int row = r + i * LANES;
                if (row < r1) {
                    rg[i] = __ldg(reinterpret_cast<const uint4*>(
                        g + row * sg_d));
                    ru[i] = __ldg(reinterpret_cast<const uint4*>(
                        u + row * su_d));
                    xv[i] = E::get(xr + row);
                } else {
                    rg[i] = ru[i] = make_uint4(0, 0, 0, 0);
                    xv[i] = 0.f;
                }
            }
#pragma unroll
            for (int i = 0; i < U; ++i) {
                float fg[N], fu[N];
                E::unpack(rg[i], fg);
                E::unpack(ru[i], fu);
#pragma unroll
                for (int v = 0; v < N; ++v) {
                    ag[v] = fmaf(xv[i], fg[v], ag[v]);
                    au[v] = fmaf(xv[i], fu[v], au[v]);
                }
            }
        }
    }
    warp_rows<N, CT>(ag);
    warp_rows<N, CT>(au);
    if (lane < CT) {
#pragma unroll
        for (int v = 0; v < N; ++v) {
            red[warp][0][ct * N + v] = ag[v];
            red[warp][1][ct * N + v] = au[v];
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * TC) {
        const int which = threadIdx.x / TC, c = threadIdx.x % TC;
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[w][which][c];
        part[which][c] = s;
    }
    cluster.sync();
    if (threadIdx.x < OWN) {
        const int c = rank * OWN + threadIdx.x;
        const int f = tile * TC + c;
        if (f < F) {
            float sg = 0.f, su = 0.f;
            for (int q = 0; q < CLUSTER; ++q) {
                const float* rp = cluster.map_shared_rank(&part[0][0], q);
                sg += rp[c];
                su += rp[TC + c];
            }
            const float h = E::rnd(sg), uu = E::rnd(su);
            // silu as PyTorch's kernel computes it: h / (1 + exp(-h))
            const float a = E::rnd(__fdiv_rn(h, __fadd_rn(1.f, expf(-h))));
            p[(long long)slot * F + f] = E::make(__fmul_rn(a, uu));
        }
    }
    cluster.sync();                // no rank leaves while its part is read
}

// down: a cluster owns (token, 128 columns of D, 64 in fp32) and splits F
// over its 8 ranks; it walks the token's held slots in ascending expert
// order.
template <class E>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 4)
down_kernel(const typename E::T* __restrict__ p,
            const int64_t* __restrict__ top_e, long long ld_e,
            const float* __restrict__ top_w, long long ld_w,
            const typename E::T* __restrict__ wd, long long sd_e,
            long long sd_f, typename E::T* __restrict__ out, int k, int D,
            int F, long long e0, int e_local) {
    using T = typename E::T;
    constexpr int N = E::N, CT = CT_B, U = U_B, LANES = THREADS / CT;
    constexpr int TC = CT * N, OWN = TC / CLUSTER;
    // each held position's warp partials, k x WARPS x TC floats (dynamic);
    // a position's first row then holds the block's partial, which the
    // other ranks read
    extern __shared__ float red[];
    __shared__ int s_slot[KMAX];
    __shared__ long long s_e[KMAX];           // local expert, -1: not held
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tile = blockIdx.x / CLUSTER;
    const int tok = blockIdx.y;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int ct = lane % CT;
    const int rl = warp * (32 / CT) + lane / CT;
    const int col = tile * TC + ct * N;
    const int chunk = (F + CLUSTER - 1) / CLUSTER;
    const int f0 = rank * chunk, f1 = min(F, f0 + chunk);

    // the token's slots in ascending expert order (ties by slot)
    if (threadIdx.x < k) {
        const int j = threadIdx.x;
        const int64_t ej = top_e[tok * ld_e + j];
        int pos = 0;
        for (int i = 0; i < k; ++i) {
            const int64_t ei = top_e[tok * ld_e + i];
            pos += ei < ej || (ei == ej && i < j);
        }
        s_slot[pos] = j;
        s_e[pos] = held(ej, e0, e_local) ? ej - e0 : -1;
    }
    __syncthreads();

    for (int pos = 0; pos < k; ++pos) {
        const long long e = s_e[pos];
        if (e < 0) continue;                  // the same in the whole cluster
        const T* w = wd + e * sd_e + col;
        const T* pr = p + (long long)(tok * k + s_slot[pos]) * F;
        float acc[N];
#pragma unroll
        for (int v = 0; v < N; ++v) acc[v] = 0.f;
        if (col < D) {
            for (int r = f0 + rl; r < f1; r += LANES * U) {
                uint4 rw[U];
                float pv[U];
#pragma unroll
                for (int i = 0; i < U; ++i) {
                    const int row = r + i * LANES;
                    if (row < f1) {
                        rw[i] = __ldg(reinterpret_cast<const uint4*>(
                            w + row * sd_f));
                        pv[i] = E::get(pr + row);
                    } else {
                        rw[i] = make_uint4(0, 0, 0, 0);
                        pv[i] = 0.f;
                    }
                }
#pragma unroll
                for (int i = 0; i < U; ++i) {
                    float fw[N];
                    E::unpack(rw[i], fw);
#pragma unroll
                    for (int v = 0; v < N; ++v)
                        acc[v] = fmaf(pv[i], fw[v], acc[v]);
                }
            }
        }
        warp_rows<N, CT>(acc);
        if (lane < CT) {
#pragma unroll
            for (int v = 0; v < N; ++v)
                red[(pos * WARPS + warp) * TC + ct * N + v] = acc[v];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k * TC; i += THREADS) {
        const int pos = i / TC, c = i % TC;
        if (s_e[pos] < 0) continue;
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[(pos * WARPS + w) * TC + c];
        red[pos * WARPS * TC + c] = s;
    }
    cluster.sync();
    if (threadIdx.x < OWN) {
        const int c = rank * OWN + threadIdx.x;
        const int d = tile * TC + c;
        if (d < D) {
            float o = 0.f;
            for (int pos = 0; pos < k; ++pos) {
                if (s_e[pos] < 0) continue;
                float y = 0.f;
                for (int q = 0; q < CLUSTER; ++q)
                    y += cluster.map_shared_rank(red, q)[pos * WARPS * TC
                                                         + c];
                const float wt = E::rnd(top_w[tok * ld_w + s_slot[pos]]);
                o = E::rnd(__fadd_rn(o, E::rnd(__fmul_rn(E::rnd(y), wt))));
            }
            out[(long long)tok * D + d] = E::make(o);
        }
    }
    cluster.sync();                // no rank leaves while its red is read
}

template <class E>
int launch(const void* x, long long ld_x, const void* top_e, long long ld_e,
           const void* top_w, long long ld_w, const void* wg, long long sg_e,
           long long sg_d, const void* wu, long long su_e, long long su_d,
           const void* wd, long long sd_e, long long sd_f, void* p, void* out,
           int T, int k, int D, int F, long long e0, int e_local,
           cudaStream_t s) {
    using V = typename E::T;
    const int n = T * k;
    const int tiles_f = (F + CT_A * E::N - 1) / (CT_A * E::N);
    const int tiles_d = (D + CT_B * E::N - 1) / (CT_B * E::N);
    gate_up_kernel<E><<<dim3(CLUSTER * tiles_f, n), THREADS, 0, s>>>(
        static_cast<const V*>(x), ld_x, static_cast<const int64_t*>(top_e),
        ld_e, static_cast<const V*>(wg), sg_e, sg_d,
        static_cast<const V*>(wu), su_e, su_d, static_cast<V*>(p), n, k, D,
        F, e0, e_local);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the down pass's partials: k x WARPS x its tile's floats
    const size_t smem = (size_t)k * WARPS * CT_B * E::N * sizeof(float);
    static bool sized = false;     // room for KMAX slots, set once
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            down_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            KMAX * WARPS * CT_B * E::N * (int)sizeof(float));
        if (e != cudaSuccess) return static_cast<int>(e);
        sized = true;
    }
    down_kernel<E><<<dim3(CLUSTER * tiles_d, T), THREADS, smem, s>>>(
        static_cast<const V*>(p), static_cast<const int64_t*>(top_e), ld_e,
        static_cast<const float*>(top_w), ld_w, static_cast<const V*>(wd),
        sd_e, sd_f, static_cast<V*>(out), k, D, F, e0, e_local);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (T, D) rows ld_x apart; top_e: (T, k) int64 and top_w: (T, k) fp32,
// rows ld_e / ld_w apart; w_gate, w_up: (E_held, D, F) and w_down:
// (E_held, F, D), strides in elements, the last dimension contiguous;
// p: (T * k, F) scratch; out: (T, D) contiguous.  elem_bytes 2 (bf16) or 4
// (fp32).  Every pointer 16-byte aligned and every weight stride a multiple
// of 16 bytes.  Launches both kernels on `stream` and returns
// cudaGetLastError().
extern "C" int routed_launch(int elem_bytes, const void* x, long long ld_x,
                             const void* top_e, long long ld_e,
                             const void* top_w, long long ld_w,
                             const void* w_gate, long long sg_e,
                             long long sg_d, const void* w_up, long long su_e,
                             long long su_d, const void* w_down,
                             long long sd_e, long long sd_f, void* p,
                             void* out, int T, int k, int D, int F,
                             long long e0, int e_local, void* stream) {
    if (T < 1 || k < 1 || k > KMAX || D < 1 || F < 1 || e_local < 1)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem_bytes == 2)
        return launch<Bf16>(x, ld_x, top_e, ld_e, top_w, ld_w, w_gate, sg_e,
                            sg_d, w_up, su_e, su_d, w_down, sd_e, sd_f, p,
                            out, T, k, D, F, e0, e_local, s);
    if (elem_bytes == 4)
        return launch<F32>(x, ld_x, top_e, ld_e, top_w, ld_w, w_gate, sg_e,
                           sg_d, w_up, su_e, su_d, w_down, sd_e, sd_f, p,
                           out, T, k, D, F, e0, e_local, s);
    return cudaErrorInvalidValue;
}
