// Device helpers shared by the GRU kernels (gru_seq_fwd.cu, gru_seq_bwd.cu):
// 3xTF32 on mma.sync m16n8k8, cp.async, and the shared-memory layout of wh
// that both tensor-core recurrences use.
//
// Precision: each float32 operand x becomes big = x rounded to TF32 (as
// cvt.rna.tf32 rounds) and small = x - big, and a float32-accurate product
// is small*big' + big*small' + big*big' with float32 accumulation, which
// keeps its error near 2^-21. The tensor core truncates when it adds into
// its float32 accumulator, so the kernels keep each mma chain short and add
// the chains together with rounded float32 adds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// big = x rounded to TF32 to nearest, ties away (what cvt.rna.tf32.f32
// gives, done with two integer ops instead of the conversion unit);
// small = x - big, exact in float32; the mma reads the top 19 bits of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a * b on m16n8k8. A float32-accurate product takes three:
// small*big', big*small' and big*big'. The kernels issue them as three
// passes over the accumulator tiles that share a B fragment, so
// consecutive mma do not wait on each other.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of m16n8k8 (rows g, g+8; columns q, q+4) from a row-major
// shared tile, each element split into big and small.
__device__ __forceinline__ void load_a_frag(const float* base, int ld, int g, int q,
                                            uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split_tf32(base[g * ld + q], ab[0], as[0]);
  split_tf32(base[(g + 8) * ld + q], ab[1], as[1]);
  split_tf32(base[g * ld + q + 4], ab[2], as[2]);
  split_tf32(base[(g + 8) * ld + q + 4], ab[3], as[3]);
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The layout of both tensor-core recurrences: a block owns RB rows (two
// m16 tiles); a warp owns 16 hidden columns of all three gates, JN
// 8-column mma tiles each (the backward: H / 16 warps over both m16 tiles;
// the forward: H / 16 warps for each m16 tile).
constexpr int RB = 32;
constexpr int JN = 2;

// Column swizzle of row k of wh (H x 3H) in shared memory: element (k, n)
// sits at k * 3H + (n ^ wh_swz(k)). With 3H a multiple of 32 the gh B
// fragments (lanes vary k by q and n by g) and the dh B fragments (lanes
// vary the row by g and the column by q) both hit 32 distinct banks. The
// XOR moves bits 2-4 only, so aligned 4-float chunks stay whole for
// cp.async.
__device__ __forceinline__ int wh_swz(int k) { return ((k & 3) << 3) | (k & 4); }

// Copy wh into shared memory, swizzled, with nthreads threads.
template <int H>
__device__ __forceinline__ void load_wh_swz(float* whs, const float* __restrict__ wh, int tid,
                                            int nthreads) {
  constexpr int H3 = 3 * H;
  for (int i = tid; i < H * H3 / 4; i += nthreads) {
    const int k = i / (H3 / 4), n = (i % (H3 / 4)) * 4;
    cp_async16(whs + k * H3 + (n ^ wh_swz(k)), wh + (size_t)k * H3 + n, 16);
  }
}
