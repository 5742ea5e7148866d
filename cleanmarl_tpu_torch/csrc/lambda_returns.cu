// Masked lambda-returns over an auto-reset rollout stream, fused with the
// advantage A = G - V.
//
// Replaces the TPU kernel cleanmarl_tpu/ops/pallas_returns.py:_kernel
// (launched by _lambda_returns_2d, pl.pallas_call at :70):
//
//     G_t = r_t + gamma * (1 - e_t) * (lam * G_{t+1} + (1 - lam) * V_{t+1})
//
// starting from G_T = V_T = bootstrap, over a (T, B) block.
//
// Design for Hopper: one thread per column, the reverse loop over T
// inside the thread. At every t the 32 threads of a warp read 32
// neighbouring columns, so each load is coalesced and no padding of B is
// needed (the ragged last block is masked). V_{t+1} is the V_t read one
// iteration earlier (the bootstrap at t = T-1), so the (T, B) next-value
// array the TPU path concatenates is never built. The advantage is
// written in the same pass, which makes lambda_advantages one launch.
//
// Bound: bytes. Each element is read once (r, V f32; e one byte) and
// written once (G, A f32): 17 bytes per element and 4 FLOP-ish, far
// below the card's ratio of operations to bytes.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void lambda_returns_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ e,
    const float* __restrict__ v, const float* __restrict__ boot,
    float* __restrict__ g_out, float* __restrict__ a_out,
    int T, long long B, float gamma, float lam) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  float g = boot[col];
  float v_next = g;
  for (int t = T - 1; t >= 0; --t) {
    const long long i = (long long)t * B + col;
    const float vt = v[i];
    const float not_ended = 1.0f - (float)e[i];
    g = r[i] + gamma * not_ended * (lam * g + (1.0f - lam) * v_next);
    g_out[i] = g;
    a_out[i] = g - vt;
    v_next = vt;
  }
}

extern "C" int lambda_returns_launch(
    const float* r, const uint8_t* e, const float* v, const float* boot,
    float* g_out, float* a_out, int T, long long B, float gamma, float lam,
    void* stream) {
  if (T <= 0 || B <= 0) return 0;
  const int threads = 256;
  const long long blocks = (B + threads - 1) / threads;
  lambda_returns_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      r, e, v, boot, g_out, a_out, T, B, gamma, lam);
  return (int)cudaGetLastError();
}

extern "C" const char* lambda_returns_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
