// Masked lambda-returns over an auto-reset rollout stream, fused with the
// advantage A = G - V.
//
// Replaces the TPU kernel cleanmarl_tpu/ops/pallas_returns.py:_kernel
// (launched by _lambda_returns_2d, pl.pallas_call at :70):
//
//     G_t = r_t + gamma * (1 - e_t) * (lam * G_{t+1} + (1 - lam) * V_{t+1})
//
// starting from G_T = V_T = bootstrap, over a (T, B) block, reverse in t,
// independent per column.
//
// Bound: bytes. Per element the kernel writes G and A (8 bytes) and reads
// V, r and e, and does about 8 operations: far below the card's ratio of
// operations to bytes. The serial chain over t is two dependent FMAs a
// step; the time depends on keeping enough loads in flight to cover the
// memory latency (Little's law: about 3 MB on this card) while the few
// warps there are (one thread per column) issue few instructions a step.
//
// Inputs that repeat over trailing axes are read without copies. Column
// `col` reads r and e at col / Rr of a (T, B / Rr) base, and V and the
// bootstrap at col / Rv of a (T, B / Rv) base: on the MAPPO main path the
// team reward, the end flag and the centralized critic's value are one per
// env, broadcast over the agents (Rr = Rv = n_agents); Rr = Rv = 1 is a
// full (T, B) input.
//
// Design for Hopper: one thread per column, COLS = 64 columns a block, so
// B = 24,576 (8192 envs x 3 agents) gives 384 blocks, about three on each
// of the 132 SMs. Each thread walks its column in chunks of TC = 20 time
// steps held in registers, three chunks in flight: chunk k + 2's loads are
// issued before chunk k's arithmetic, so at T = 60 the whole column is
// requested before the first step and the chain waits only on the oldest
// chunk. (A ring of shared-memory stages filled by 4-byte cp.async was
// built first and was slower at every block size tried: with about six
// warps an SM the extra copy, address and shared-load instructions of each
// step, not the memory, set its time.) G and A are written in the same
// pass, a warp's 32 stores on 128 neighbouring bytes. The arithmetic is the
// plain loop's, in its order, so results are the same bits on every launch.
// Offsets are 32-bit: the wrapper refuses T * B >= 2^31.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int COLS = 64;  // columns (threads) a block
constexpr int TC = 20;    // time steps a chunk

// One chunk of a column's inputs; slot j holds t = T - 1 - k * TC - j.
struct Chunk {
  float v[TC], r[TC];
  uint32_t e[TC];
};

}  // namespace

__global__ void __launch_bounds__(COLS) lambda_returns_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ e,
    const float* __restrict__ v, const float* __restrict__ boot,
    float* __restrict__ g_out, float* __restrict__ a_out,
    int T, int B, int Rr, int Rv, float gamma, float lam) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= B) return;
  const int Br = B / Rr, cr = col / Rr;  // r, e: (T, Br)
  const int Bv = B / Rv, cv = col / Rv;  // V: (T, Bv), bootstrap (Bv)
  const int chunks = (T + TC - 1) / TC;
  float g = __ldg(boot + cv);
  float v_next = g;

  auto load = [&](Chunk& c, int k) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int t = T - 1 - k * TC - j;
      if (t >= 0) {
        c.v[j] = __ldg(v + (t * Bv + cv));
        c.r[j] = __ldg(r + (t * Br + cr));
        c.e[j] = __ldg(e + (t * Br + cr));
      }
    }
  };
  auto step = [&](const Chunk& c, int k) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int t = T - 1 - k * TC - j;
      if (t >= 0) {
        const int i = t * B + col;
        const float vt = c.v[j];
        const float not_ended = 1.0f - (float)c.e[j];
        g = c.r[j] + gamma * not_ended * (lam * g + (1.0f - lam) * v_next);
        g_out[i] = g;
        a_out[i] = g - vt;
        v_next = vt;
      }
    }
  };

  // three register buffers in rotation; the loop is unrolled by three so
  // that every buffer index is known at compile time
  Chunk c0, c1, c2;
  load(c0, 0);
  if (1 < chunks) load(c1, 1);
  for (int k = 0; k < chunks; k += 3) {
    if (k + 2 < chunks) load(c2, k + 2);
    step(c0, k);
    if (k + 3 < chunks) load(c0, k + 3);
    if (k + 1 < chunks) step(c1, k + 1);
    if (k + 4 < chunks) load(c1, k + 4);
    if (k + 2 < chunks) step(c2, k + 2);
  }
}

extern "C" int lambda_returns_launch(
    const float* r, const uint8_t* e, const float* v, const float* boot,
    float* g_out, float* a_out, int T, long long B, int Rr, int Rv, float gamma,
    float lam, void* stream) {
  if (Rr <= 0 || Rv <= 0 || B % Rr || B % Rv || (long long)T * B > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0) return 0;
  const long long blocks = (B + COLS - 1) / COLS;
  lambda_returns_kernel<<<(unsigned)blocks, COLS, 0, (cudaStream_t)stream>>>(
      r, e, v, boot, g_out, a_out, T, (int)B, Rr, Rv, gamma, lam);
  return (int)cudaGetLastError();
}

extern "C" const char* lambda_returns_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
