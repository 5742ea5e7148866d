// Fused GRU sequence forward: the whole T-step recurrence for a tile of
// rows in one block, the hidden state resident in shared memory.
//
// Replaces the TPU kernel cleanmarl_tpu/ops/pallas_gru.py:_fwd_kernel
// (launched by _fwd, pl.pallas_call at :94). Per step, for every row m:
//
//     gh = h @ wh + bh                       (wh is (H, 3H), gates r, z, n)
//     r = sig(gi_r + gh_r); z = sig(gi_z + gh_z); n = tanh(gi_n + r * gh_n)
//     h2 = (1 - z) * n + z * h               emitted as h_seq[t] (pre-mask)
//     carry <- keep[t] * h2
//
// Design for Hopper: a block owns TM rows of M and loops over all T; its
// H threads each own one hidden column j and compute gh at the three
// gate columns j, H+j, 2H+j for all TM rows, so the gating needs no
// exchange between threads. h for the tile is double-buffered in shared
// memory (one barrier per step) and read as float4 broadcasts. wh is
// 192 KiB at H = 128 (768 KiB at H = 256), too large to keep in a
// block's shared memory, so it is streamed through the read-only path:
// every block reads it each step and it stays resident in the 50 MB L2.
// The contraction is plain float32 FMA (no TF32), so results match the
// float32 scan to rounding.
//
// Bound: operations. 2*T*M*H*3H FLOP (18.1 GFLOP at T=60, M=3072,
// H=128) against about 0.38 GB moved.
#include <cuda_runtime.h>

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Rows per block: 16 up to H = 256 (256 threads, ~160 registers each),
// 8 above it so that H = 512 threads still fit the register file.
template <int TM>
__global__ void __launch_bounds__(TM == 16 ? 256 : 512) gru_seq_fwd_kernel(
    const float* __restrict__ wh, const float* __restrict__ bh,
    const float* __restrict__ h0, const float* __restrict__ gi,
    const float* __restrict__ keep, float* __restrict__ hseq,
    float* __restrict__ hfinal, int T, int M, int H) {
  extern __shared__ float4 smem4[];
  float* hcur = reinterpret_cast<float*>(smem4);
  float* hnext = hcur + TM * H;
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int H3 = 3 * H;

  for (int r = 0; r < TM; ++r) {
    const int m = row0 + r;
    hcur[r * H + j] = (m < M) ? h0[(size_t)m * H + j] : 0.0f;
  }
  const float bhr = bh[j], bhz = bh[H + j], bhn = bh[2 * H + j];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float ar[TM], az[TM], an[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) { ar[r] = 0.0f; az[r] = 0.0f; an[r] = 0.0f; }
    for (int k = 0; k < H; k += 4) {
      float wr[4], wz[4], wn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wrow = wh + (size_t)(k + q) * H3;
        wr[q] = __ldg(wrow + j);
        wz[q] = __ldg(wrow + H + j);
        wn[q] = __ldg(wrow + 2 * H + j);
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 hk = *reinterpret_cast<const float4*>(hcur + r * H + k);
        const float hv[4] = {hk.x, hk.y, hk.z, hk.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[r] = fmaf(hv[q], wr[q], ar[r]);
          az[r] = fmaf(hv[q], wz[q], az[r]);
          an[r] = fmaf(hv[q], wn[q], an[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = row0 + r;
      float hn = 0.0f;
      if (m < M) {
        const size_t gidx = ((size_t)t * M + m) * H3;
        const float rg = sigmoidf_(gi[gidx + j] + (ar[r] + bhr));
        const float zg = sigmoidf_(gi[gidx + H + j] + (az[r] + bhz));
        const float ng = tanhf(gi[gidx + 2 * H + j] + rg * (an[r] + bhn));
        const float h2 = (1.0f - zg) * ng + zg * hcur[r * H + j];
        hseq[((size_t)t * M + m) * H + j] = h2;
        hn = keep[(size_t)t * M + m] * h2;
      }
      hnext[r * H + j] = hn;
    }
    __syncthreads();
    float* tmp = hcur; hcur = hnext; hnext = tmp;
  }
  for (int r = 0; r < TM; ++r) {
    const int m = row0 + r;
    if (m < M) hfinal[(size_t)m * H + j] = hcur[r * H + j];
  }
}

extern "C" int gru_seq_fwd_launch(
    const float* wh, const float* bh, const float* h0, const float* gi,
    const float* keep, float* hseq, float* hfinal, int T, int M, int H,
    void* stream) {
  if (M <= 0 || H <= 0) return 0;
  const int tm = (H <= 256) ? 16 : 8;
  const size_t smem = 2 * (size_t)tm * H * sizeof(float);
  const int blocks = (M + tm - 1) / tm;
  if (tm == 16) {
    gru_seq_fwd_kernel<16><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, bh, h0, gi, keep, hseq, hfinal, T, M, H);
  } else {
    gru_seq_fwd_kernel<8><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, bh, h0, gi, keep, hseq, hfinal, T, M, H);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gru_seq_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
