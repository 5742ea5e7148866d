// Peak issue rate of TF32 mma.sync m16n8k8 on the card: the ceiling of the
// GRU tensor-core kernels (gru_seq_fwd.cu, gru_seq_bwd.cu), which issue
// nothing else on the tensor cores. Every warp issues independent mma into
// eight accumulators, `iters` times (2*16*8*8 FLOP per mma);
// chip_smoke.py:mma_ceiling times it.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_rate_kernel(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x * 7u, threadIdx.x * 3u, threadIdx.x, 5u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// out must hold blocks * threads floats.
extern "C" int mma_rate_launch(int blocks, int threads, int iters, float* out, void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" const char* mma_rate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
