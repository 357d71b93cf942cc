// Tensor-core building blocks shared by swa.cu and mlstm.cu: strided
// operands and their alignment rule, 16-byte cp.async tile copies, ldmatrix,
// mma.sync.m16n8k16 (bf16 or fp16 in, fp32 accumulate) and the hi/lo split
// of an fp32 operand.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 registers of two 16-bit values:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B (16 x 8, k x n), 2 registers:  b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C (16 x 8, fp32): c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// The low 16 bits of a register hold the lower column (or k) index.
//
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values; lanes 8i..8i+7
// give the row addresses of matrix i, and lane l receives row l / 4,
// columns 2 (l % 4) .. +1 of each (with .trans, column l / 4, rows
// 2 (l % 4) .. +1).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tc {

// Strides of a (B, S, H, dh) operand in elements; the head-dim stride is 1.
struct Strides {
    long long b, s, h;
};

// The tensor-core kernels copy rows 16 bytes at a time: the base must be
// 16-byte aligned and every stride a multiple of 8 16-bit elements.  (The
// Python wrappers check the same first, with a readable error.)
inline bool aligned16(const void* p, Strides s) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 8 == 0 &&
           s.s % 8 == 0 && s.h % 8 == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global to shared memory asynchronously, or writes
// 16 zero bytes when !pred (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Starts the copy of a ROWS x NCOLS tile of 16-bit values (row r at
// src + r * stride) into dst (ld elements a row), 16 bytes a thread at a
// time over a block of THREADS threads: consecutive threads take
// consecutive 8-column pieces of a row.  Rows at or past rows_ok and pieces
// at or past column cols_ok are zero-filled (src is then not read).  With
// UNROLL false the loop stays rolled: a caller short of registers (SWA's
// main loop holds a 16 x 256 fp32 accumulator a warp) would otherwise keep
// every step's address live at once, and spill.
template <int ROWS, int NCOLS, int THREADS, bool UNROLL = true, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride, int rows_ok,
                                          int cols_ok) {
    constexpr int CPR = NCOLS / 8;
    static_assert(ROWS * CPR % THREADS == 0, "whole steps of the block");
#pragma unroll (UNROLL ? ROWS * CPR / THREADS : 1)
    for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        const int r = idx / CPR, c8 = (idx % CPR) * 8;
        const bool ok = r < rows_ok && c8 < cols_ok;
        const T* g = ok ? src + (long long)r * stride + c8 : src;
        cp_async16(dst + r * ld + c8, g, ok);
    }
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// Row addresses for ldmatrix.x4 (lane l, tile origin (r0, c0) of a row-major
// 16-bit array with ld elements a row):
//  a_frag:  the A fragment of rows r0..r0+15, columns c0..c0+15;
//  b_frag:  B fragments (b0, b1) of two n blocks, n0..n0+7 in r[0..1] and
//           n0+8..n0+15 in r[2..3], from an n-major array X[n][k]
//           (row r0 = n0, column c0 = k0), without .trans;
//  bt_frag: the same from a k-major array X[k][n] (row r0 = k0, column
//           c0 = n0), with .trans;
//  at_frag: the A fragment of rows m0..m0+15, columns k0..k0+15 from a
//           k-major array X[k][m] (row r0 = k0, column c0 = m0), with .trans.
template <typename T>
__device__ __forceinline__ const T* a_frag(const T* base, int ld, int r0,
                                           int c0, int lane) {
    return base + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ const T* b_frag(const T* base, int ld, int r0,
                                           int c0, int lane) {
    return base + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
           (((lane >> 3) & 1) << 3);
}
template <typename T>
__device__ __forceinline__ const T* bt_frag(const T* base, int ld, int r0,
                                            int c0, int lane) {
    return base + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 +
           ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ const T* at_frag(const T* base, int ld, int r0,
                                            int c0, int lane) {
    return base + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
           (((lane >> 3) & 1) << 3);
}

// The 16-bit input type's conversions and product.
template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
    __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
    // x = hi + lo + O(2^-18 |x|): hi = bf16(x), lo = bf16(x - hi)
    __device__ static __forceinline__ void split(float x0, float x1,
                                                 uint32_t& hi, uint32_t& lo) {
        __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        hi = *reinterpret_cast<uint32_t*>(&h);
        lo = *reinterpret_cast<uint32_t*>(&l);
    }
    __device__ static __forceinline__ float2 unpack(uint32_t v) {
        return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
    }
    __device__ static __forceinline__ void mma(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

template <>
struct Ops<__half> {
    __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
    __device__ static __forceinline__ void split(float x0, float x1,
                                                 uint32_t& hi, uint32_t& lo) {
        __half2 h = __floats2half2_rn(x0, x1);
        const float2 hf = __half22float2(h);
        __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
        hi = *reinterpret_cast<uint32_t*>(&h);
        lo = *reinterpret_cast<uint32_t*>(&l);
    }
    __device__ static __forceinline__ float2 unpack(uint32_t v) {
        return __half22float2(*reinterpret_cast<__half2*>(&v));
    }
    __device__ static __forceinline__ void mma(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

}  // namespace tc
