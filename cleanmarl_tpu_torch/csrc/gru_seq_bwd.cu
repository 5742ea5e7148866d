// Fused GRU sequence backward, in two kernels.
//
// Replaces the TPU kernel cleanmarl_tpu/ops/pallas_gru.py:_make_bwd_kernel
// (launched by _bwd_call, pl.pallas_call at :197), which walks the
// sequence in reverse, recomputes the gates from gi and
// h_prev = keep[t-1] * h_seq[t-1] (h0 at t = 0), emits dgi and dh0, and
// accumulates dwh, dbh over all steps and all row tiles with `+=` into
// one output block. That accumulation is safe on the TPU, whose grid runs
// in order, and a race on Hopper, whose blocks run at the same time. So
// the work is split:
//
// 1. gru_seq_bwd_kernel (the recurrence). A block owns TM rows and walks
//    t = T-1 .. 0 with the carry gradient dh for its rows in registers
//    (thread j owns column j). Per step it recomputes gh = h_prev @ wh + bh
//    for the three gate columns of j, forms
//        dh2  = g_hseq[t] + keep[t] * dh
//        da_r, da_z, da_n         (the gate pre-activation gradients)
//        dgh  = [da_r, da_z, da_n * r]
//        dh   = dh2 * z + dgh @ wh^T
//    and writes dgi[t] = [da_r, da_z, da_n] and the n block of dgh,
//    da_n * r, to dghn[t]. dgh for the tile goes through shared memory
//    for the dgh @ wh^T product, read against wh^T (3H, H) so the loads
//    of a warp are coalesced.
// 2. gru_seq_dw_partial_kernel + gru_seq_dw_reduce_kernel (the weight
//    gradient). dwh = sum over (t, m) of h_prev^T dgh and dbh = sum of
//    dgh, over R = T*M rows. Blocks tile the (H, 3H) output by 64 x 64 and
//    split the rows into S contiguous ranges; each block writes its
//    partial sum to a scratch slot, and the reduce kernel adds the S
//    partials in a fixed order. No float atomics: the result is the same
//    on every run.
//
// Bound: operations. The recurrence does 2 * 2*T*M*H*3H FLOP (gh
// recompute and dh), the weight gradient 2*T*M*H*3H, all plain float32
// FMA (no TF32).
#include <cuda_runtime.h>

#define BM 64
#define BN 64
#define BK 16

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Rows per block: 16 up to H = 256, 8 above it (register file at 512
// threads).
template <int TM>
__global__ void __launch_bounds__(TM == 16 ? 256 : 512) gru_seq_bwd_kernel(
    const float* __restrict__ wh, const float* __restrict__ whT,
    const float* __restrict__ bh, const float* __restrict__ h0,
    const float* __restrict__ hseq, const float* __restrict__ gi,
    const float* __restrict__ keep, const float* __restrict__ g_hseq,
    const float* __restrict__ g_hfinal, float* __restrict__ dgi,
    float* __restrict__ dghn, float* __restrict__ dh0, int T, int M, int H) {
  extern __shared__ float4 smem4[];
  float* hprev = reinterpret_cast<float*>(smem4);  // TM x H
  float* dgh = hprev + TM * H;                      // TM x 3H
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int H3 = 3 * H;
  const float bhr = bh[j], bhz = bh[H + j], bhn = bh[2 * H + j];

  float dh[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = row0 + r;
    dh[r] = (m < M) ? g_hfinal[(size_t)m * H + j] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = row0 + r;
      float hp = 0.0f;
      if (m < M) {
        hp = (t > 0) ? keep[(size_t)(t - 1) * M + m] *
                           hseq[((size_t)(t - 1) * M + m) * H + j]
                     : h0[(size_t)m * H + j];
      }
      hprev[r * H + j] = hp;
    }
    __syncthreads();

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
        const float4 hk = *reinterpret_cast<const float4*>(hprev + r * H + k);
        const float hv[4] = {hk.x, hk.y, hk.z, hk.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[r] = fmaf(hv[q], wr[q], ar[r]);
          az[r] = fmaf(hv[q], wz[q], az[r]);
          an[r] = fmaf(hv[q], wn[q], an[r]);
        }
      }
    }

    // gates and their gradients; dh2 * z is kept in ar[] for the carry
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = row0 + r;
      float da_r = 0.0f, da_z = 0.0f, dgn = 0.0f, dhz = 0.0f;
      if (m < M) {
        const size_t row = (size_t)t * M + m;
        const size_t gidx = row * H3;
        const float rg = sigmoidf_(gi[gidx + j] + (ar[r] + bhr));
        const float zg = sigmoidf_(gi[gidx + H + j] + (az[r] + bhz));
        const float hn = an[r] + bhn;
        const float ng = tanhf(gi[gidx + 2 * H + j] + rg * hn);
        const float hp = hprev[r * H + j];
        const float dh2 = g_hseq[row * H + j] + keep[row] * dh[r];
        const float dz = dh2 * (hp - ng);
        const float dn = dh2 * (1.0f - zg);
        const float da_n = dn * (1.0f - ng * ng);
        const float dr = da_n * hn;
        da_r = dr * rg * (1.0f - rg);
        da_z = dz * zg * (1.0f - zg);
        dgn = da_n * rg;
        dhz = dh2 * zg;
        dgi[gidx + j] = da_r;
        dgi[gidx + H + j] = da_z;
        dgi[gidx + 2 * H + j] = da_n;
        dghn[row * H + j] = dgn;
      }
      dgh[r * H3 + j] = da_r;
      dgh[r * H3 + H + j] = da_z;
      dgh[r * H3 + 2 * H + j] = dgn;
      ar[r] = dhz;
    }
    __syncthreads();

    // dh = dh2 * z + dgh @ wh^T  (column j of the carry gradient)
#pragma unroll
    for (int r = 0; r < TM; ++r) az[r] = 0.0f;
    for (int c = 0; c < H3; c += 4) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = __ldg(whT + (size_t)(c + q) * H + j);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 g4 = *reinterpret_cast<const float4*>(dgh + r * H3 + c);
        az[r] = fmaf(g4.x, w[0], az[r]);
        az[r] = fmaf(g4.y, w[1], az[r]);
        az[r] = fmaf(g4.z, w[2], az[r]);
        az[r] = fmaf(g4.w, w[3], az[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) dh[r] = ar[r] + az[r];
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = row0 + r;
    if (m < M) dh0[(size_t)m * H + j] = dh[r];
  }
}

// Partial weight gradient over one contiguous range of rows (t, m) of
// R = T*M. Block (16 x 16 threads) computes a BM x BN tile of dwh (k of
// H by c of 3H), 4 x 4 outputs per thread, staging BK rows of h_prev and
// dgh at a time in shared memory. Blocks of the first k tile also sum
// the dgh columns for dbh.
__global__ void __launch_bounds__(256) gru_seq_dw_partial_kernel(
    const float* __restrict__ h0, const float* __restrict__ hseq,
    const float* __restrict__ keep, const float* __restrict__ dgi,
    const float* __restrict__ dghn, float* __restrict__ part_w,
    float* __restrict__ part_b, int T, int M, int H, long long rows_per_split) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int H3 = 3 * H;
  const long long R = (long long)T * M;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > R) r_end = R;
  const bool do_bias = (blockIdx.y == 0) && (ty == 0);

  float acc[4][4];
  float bacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (long long rb = r_begin; rb < r_end; rb += BK) {
    for (int i = tid; i < BK * BM; i += 256) {
      const int kk = i / BM, mm = i % BM;
      const long long row = rb + kk;
      const int k = k0 + mm;
      float v = 0.0f;
      if (row < r_end && k < H) {
        v = (row < M) ? h0[row * H + k]
                      : keep[row - M] * hseq[(row - M) * H + k];
      }
      As[kk][mm] = v;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int kk = i / BN, nn = i % BN;
      const long long row = rb + kk;
      const int c = c0 + nn;
      float v = 0.0f;
      if (row < r_end && c < H3) {
        v = (c < 2 * H) ? dgi[row * H3 + c] : dghn[row * H + (c - 2 * H)];
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      if (do_bias) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bacc[q] += b[q];
      }
    }
    __syncthreads();
  }

  float* pw = part_w + (size_t)blockIdx.z * H * H3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx * 4 + q;
      if (c < H3) pw[(size_t)k * H3 + c] = acc[i][q];
    }
  }
  if (do_bias) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx * 4 + q;
      if (c < H3) part_b[(size_t)blockIdx.z * H3 + c] = bacc[q];
    }
  }
}

// dwh[e] = sum_s part_w[s][e] and dbh[c] = sum_s part_b[s][c], s in order.
__global__ void gru_seq_dw_reduce_kernel(
    const float* __restrict__ part_w, const float* __restrict__ part_b,
    float* __restrict__ dwh, float* __restrict__ dbh, int S, int H) {
  const int H3 = 3 * H;
  const long long n_w = (long long)H * H3;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n_w) {
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += part_w[(size_t)i * n_w + e];
    dwh[e] = s;
  } else if (e < n_w + H3) {
    const long long c = e - n_w;
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += part_b[(size_t)i * H3 + c];
    dbh[c] = s;
  }
}

extern "C" int gru_seq_bwd_launch(
    const float* wh, const float* whT, const float* bh, const float* h0,
    const float* hseq, const float* gi, const float* keep,
    const float* g_hseq, const float* g_hfinal, float* dgi, float* dghn,
    float* dh0, int T, int M, int H, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  const int tm = (H <= 256) ? 16 : 8;
  const size_t smem = (size_t)tm * 4 * H * sizeof(float);
  const int blocks = (M + tm - 1) / tm;
  cudaError_t err = cudaSuccess;
  if (tm == 16) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gru_seq_bwd_kernel<16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    gru_seq_bwd_kernel<16><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, whT, bh, h0, hseq, gi, keep, g_hseq, g_hfinal, dgi, dghn, dh0, T,
        M, H);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gru_seq_bwd_kernel<8>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    gru_seq_bwd_kernel<8><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, whT, bh, h0, hseq, gi, keep, g_hseq, g_hfinal, dgi, dghn, dh0, T,
        M, H);
  }
  return (int)cudaGetLastError();
}

// part_w must hold S * H * 3H floats and part_b S * 3H floats.
extern "C" int gru_seq_dw_launch(
    const float* h0, const float* hseq, const float* keep, const float* dgi,
    const float* dghn, float* part_w, float* part_b, float* dwh, float* dbh,
    int T, int M, int H, int S, long long rows_per_split, void* stream) {
  if (H <= 0 || S <= 0) return 0;
  const int H3 = 3 * H;
  dim3 grid((H3 + BN - 1) / BN, (H + BM - 1) / BM, S);
  gru_seq_dw_partial_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      h0, hseq, keep, dgi, dghn, part_w, part_b, T, M, H, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)H * H3 + H3;
  const int threads = 256;
  gru_seq_dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                             0, (cudaStream_t)stream>>>(part_w, part_b, dwh,
                                                        dbh, S, H);
  return (int)cudaGetLastError();
}

extern "C" const char* gru_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
