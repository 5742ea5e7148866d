// Fused GRU sequence forward for Hopper (sm_90a): the whole T-step
// recurrence for a tile of rows in one block.
//
// Replaces the TPU kernel cleanmarl_tpu/ops/pallas_gru.py:_fwd_kernel
// (launched by _fwd, pl.pallas_call at :94). Per step, for every row m:
//
//     gh = h @ wh + bh                       (wh is (H, 3H), gates r, z, n)
//     r = sig(gi_r + gh_r); z = sig(gi_z + gh_z); n = tanh(gi_n + r * gh_n)
//     h2 = (1 - z) * n + z * h               emitted as h_seq[t] (pre-mask)
//     carry <- keep[t] * h2                  h_final is the last carry
//
// Bound (T = 60, M = 3072, H = 128; benchmark/yardstick.py:gru_least_s): 2*T*M*H*3H
// = 18.1 GFLOP against 0.38 GB (gi, h_seq and the rest, each once). As
// float32 FMA that is 0.274 ms of operations; as 3xTF32 on the tensor
// cores (three TF32 products per float32 product) 0.113 ms of operations
// and 0.114 ms of bytes, so on the tensor cores the bytes bound it. The
// step chain is serial: each step needs the whole previous h of its rows.
//
// 1. gru_seq_fwd_tc_kernel (H in {32, 64, 96, 128}). The product runs on
//    the tensor cores, mma.sync m16n8k8 in 3xTF32 (tf32_mma.cuh): float32
//    accuracy whatever torch.backends.cuda.matmul.allow_tf32 says, and a
//    fixed summation order, so a run gives the same bits every time.
//    - wh (196,608 B at H = 128) is copied once per block into shared
//      memory, swizzled (wh_swz) so the B-fragment loads are free of bank
//      conflicts, and bh beside it; no step reads wh from L2.
//    - A block owns RB = 32 rows, 96 blocks at M = 3072, one per SM. Its
//      rows form two groups of 16 (one m16 tile) with H / 16 warps each;
//      warp w of a group owns hidden columns [16w, 16w + 16) of all three
//      gates, so the gating needs no exchange between warps. The groups
//      are independent recurrences and wait only for their own warps (a
//      named barrier per group, one per step), so one group's gating
//      overlaps the other's product. The first layout, 8 warps of two m16
//      tiles each behind one block barrier, ran slower (PERF.md).
//    - The carry: each thread's h at its own (row, column) positions stays
//      in registers in the mma accumulator layout for the whole walk, so
//      z * h reads no memory. keep * h2 also goes into the other half of a
//      double-buffered 32 x (H + 4) h tile in shared memory, the next step's
//      A operand. Shared memory at H = 128: wh 196,608 + 2 x 16,896 (h
//      tiles) + 1,536 (bh) = 231,936 of 232,448 B.
//    - The step's inputs that do not depend on the carry (gi[t] at the
//      thread's accumulator positions, 24 floats, and keep[t]) are loaded
//      into registers before the barrier, so their latency hides behind the
//      product; gi_r, gi_z and bh are added into the accumulators after the
//      first round of the product, which frees their registers (512 threads
//      leave 128 a thread); h_seq[t] is stored from registers as float2.
//    - The tensor core truncates as it adds into its float32 accumulator,
//      so gh is summed in rounds of KC = 4 k-steps (12 mma per accumulator),
//      each in fresh accumulators added into the total with rounded float32
//      adds: h stays as close to a float64 recurrence as the float32 scan's
//      (one 48-mma chain per accumulator runs faster and drifts further).
// 2. gru_seq_fwd_l2_kernel (every other width up to H = 512, where wh does
//    not fit in shared memory beside the h tiles): float32 FMA, one thread
//    per hidden column, h of the tile double-buffered in shared memory and
//    wh streamed from L2 every step. The wrapper picks the kernel by width
//    (ops/gru_kernel.py:fwd_route).
#include "tf32_mma.cuh"

// --------------------------------------------------------------------------
// 1. the recurrence on the tensor cores, wh resident in shared memory
// --------------------------------------------------------------------------

constexpr int KC = 4;         // k-steps per accumulator round (12 mma per chain)
constexpr int GR = RB / 16;   // row groups of a block, one m16 tile each

// One round of the gh product of a warp: out = h[:, 8*k0 : 8*(k0 + KC)] @
// wh[8*k0 : 8*(k0 + KC), the warp's columns of all three gates] in fresh
// accumulators, 3xTF32, from the group's h tile (16 rows, row-major, LD).
template <int H>
__device__ __forceinline__ void gh_round(float (&out)[3][JN][4], const float* hcur,
                                         const float* whs, int k0, int jw, int g, int q) {
  constexpr int H3 = 3 * H, LD = H + 4;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int jn = 0; jn < JN; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[a][jn][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const int ks = k0 + kk, k = ks * 8 + q;
    uint32_t ab[4], as[4];
    load_a_frag(hcur + ks * 8, LD, g, q, ab, as);
    const float* w0 = whs + k * H3;
    const float* w1 = w0 + 4 * H3;
    const int s0 = wh_swz(k), s1 = wh_swz(k + 4);
    uint32_t bb[3][JN][2], bs[3][JN][2];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int jn = 0; jn < JN; ++jn) {
        const int n = a * H + jw + 8 * jn + g;
        split_tf32(w0[n ^ s0], bb[a][jn][0], bs[a][jn][0]);
        split_tf32(w1[n ^ s1], bb[a][jn][1], bs[a][jn][1]);
      }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int jn = 0; jn < JN; ++jn) {
          const uint32_t(&b)[2] = pass == 1 ? bs[a][jn] : bb[a][jn];
          mma_tf32(out[a][jn], pass == 0 ? as : ab, b[0], b[1]);
        }
  }
}

// GR groups of H / 16 warps (512 threads at H = 128), one block per SM at
// H = 128. Warp w of group p owns rows [16p, 16p + 16) of the block and
// hidden columns [16w, 16w + 16) of all three gates. The groups' rows are
// independent recurrences, so after the first step a group waits only for
// its own warps, on its own named barrier.
template <int H>
__global__ void __launch_bounds__(GR * 2 * H, 1) gru_seq_fwd_tc_kernel(
    const float* __restrict__ wh, const float* __restrict__ bh,
    const float* __restrict__ h0, const float* __restrict__ gi,
    const float* __restrict__ keep, float* __restrict__ hseq,
    float* __restrict__ hfinal, int T, int M) {
  constexpr int H3 = 3 * H, LD = H + 4, WG = H / 16, NT = GR * WG * 32;
  static_assert((H / 8) % KC == 0, "KC must divide the k-steps");
  extern __shared__ float4 smem4[];
  float* whs = reinterpret_cast<float*>(smem4);  // H x 3H, swizzled
  float* hbuf = whs + H * H3;                    // 2 x RB x LD: h entering the step
  float* bhs = hbuf + 2 * RB * LD;               // 3H
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int warp = tid >> 5, grp = warp / WG;
  const int jw = (warp % WG) * 8 * JN;           // the warp's hidden columns
  const int row0 = blockIdx.x * RB + 16 * grp;   // the group's first row

  load_wh_swz<H>(whs, wh, tid, NT);
  for (int i = tid; i < RB * (H / 4); i += NT) {
    const int r = i / (H / 4), c = (i % (H / 4)) * 4;
    const int m = blockIdx.x * RB + r;
    cp_async16(hbuf + r * LD + c, h0 + (size_t)(m < M ? m : 0) * H + c, m < M ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < H3; i += NT) bhs[i] = bh[i];

  // The carry, in the m16n8 accumulator layout: [jn][e] is row
  // row0 + g + 8*(e >> 1), hidden column jw + 8*jn + 2*q + (e & 1).
  float hc[JN][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = row0 + g + 8 * hh;
#pragma unroll
    for (int jn = 0; jn < JN; ++jn) {
      float2 v = make_float2(0.0f, 0.0f);
      if (m < M) v = *reinterpret_cast<const float2*>(h0 + (size_t)m * H + jw + 8 * jn + 2 * q);
      hc[jn][2 * hh] = v.x;
      hc[jn][2 * hh + 1] = v.y;
    }
  }

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + ((t & 1) * RB + 16 * grp) * LD;
    float* hnext = hbuf + (((t & 1) ^ 1) * RB + 16 * grp) * LD;
    // inputs of step t that do not depend on the carry
    float2 xr[2][JN], xz[2][JN], xn[2][JN];  // [hh][jn]
    float kt[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = row0 + g + 8 * hh;
      const bool ok = m < M;
      const size_t row = (size_t)t * M + (ok ? m : 0);
      kt[hh] = ok ? keep[row] : 0.0f;
#pragma unroll
      for (int jn = 0; jn < JN; ++jn) {
        const float* x = gi + row * H3 + jw + 8 * jn + 2 * q;
        const float2 z2 = make_float2(0.0f, 0.0f);
        xr[hh][jn] = ok ? *reinterpret_cast<const float2*>(x) : z2;
        xz[hh][jn] = ok ? *reinterpret_cast<const float2*>(x + H) : z2;
        xn[hh][jn] = ok ? *reinterpret_cast<const float2*>(x + 2 * H) : z2;
      }
    }
    // hcur is complete; every warp of the group is done reading hnext
    if (t == 0) {
      cp_async_wait<0>();
      __syncthreads();  // wh, bh and the h0 tile of the whole block
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(WG * 32) : "memory");
    }

    // acc = gi + bh + h @ wh for the r and z gates, bh + h @ wh for n (gi_n
    // is added after the reset gate), in rounds of KC k-steps. gi and bh are
    // folded in after the first round, which frees the registers of gi_r
    // and gi_z for the rest of the product.
    float acc[3][JN][4];
    gh_round<H>(acc, hcur, whs, 0, jw, g, q);
#pragma unroll
    for (int jn = 0; jn < JN; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, u = e & 1, j = jw + 8 * jn + 2 * q + u;
        acc[0][jn][e] += (u ? xr[hh][jn].y : xr[hh][jn].x) + bhs[j];
        acc[1][jn][e] += (u ? xz[hh][jn].y : xz[hh][jn].x) + bhs[H + j];
        acc[2][jn][e] += bhs[2 * H + j];
      }
#pragma unroll 1
    for (int k0 = KC; k0 < H / 8; k0 += KC) {
      float part[3][JN][4];
      gh_round<H>(part, hcur, whs, k0, jw, g, q);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int jn = 0; jn < JN; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][jn][e] += part[a][jn][e];
    }

    // the gates; h_seq[t] = h2, the carry and the next A tile = keep * h2
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = g + 8 * hh;  // row in the group
      const int m = row0 + rl;
#pragma unroll
      for (int jn = 0; jn < JN; ++jn) {
        const int j = jw + 8 * jn + 2 * q;
        float h2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * hh + u;
          const float rg = sigmoidf_(acc[0][jn][e]);
          const float zg = sigmoidf_(acc[1][jn][e]);
          const float ng = tanhf((u ? xn[hh][jn].y : xn[hh][jn].x) + rg * acc[2][jn][e]);
          h2[u] = (1.0f - zg) * ng + zg * hc[jn][e];
          hc[jn][e] = kt[hh] * h2[u];
        }
        *reinterpret_cast<float2*>(hnext + rl * LD + j) =
            make_float2(hc[jn][2 * hh], hc[jn][2 * hh + 1]);
        if (m < M)
          *reinterpret_cast<float2*>(hseq + ((size_t)t * M + m) * H + j) =
              make_float2(h2[0], h2[1]);
      }
    }
  }
  cp_async_wait<0>();  // T = 0: the h0 copy is still in flight

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = row0 + g + 8 * hh;
    if (m >= M) continue;
#pragma unroll
    for (int jn = 0; jn < JN; ++jn)
      *reinterpret_cast<float2*>(hfinal + (size_t)m * H + jw + 8 * jn + 2 * q) =
          make_float2(hc[jn][2 * hh], hc[jn][2 * hh + 1]);
  }
}

// --------------------------------------------------------------------------
// 2. every other width: float32 FMA, wh streamed from L2
// --------------------------------------------------------------------------

// A block owns TM rows and loops over all T; its H threads each own one
// hidden column j and compute gh at the three gate columns j, H+j, 2H+j
// for all TM rows, so the gating needs no exchange between threads. h for
// the tile is double-buffered in shared memory (one barrier per step) and
// read as float4 broadcasts; wh is read through the read-only path every
// step. Rows per block: 16 up to H = 256, 8 above it so that H = 512
// threads still fit the register file.
template <int TM>
__global__ void __launch_bounds__(TM == 16 ? 256 : 512) gru_seq_fwd_l2_kernel(
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

// --------------------------------------------------------------------------
// C interface (ctypes); each returns a cudaError_t code, 0 on success
// --------------------------------------------------------------------------

// The tensor-core forward: H in {32, 64, 96, 128}.
extern "C" int gru_seq_fwd_launch(
    const float* wh, const float* bh, const float* h0, const float* gi,
    const float* keep, float* hseq, float* hfinal, int T, int M, int H,
    void* stream) {
  if (M <= 0) return 0;
  void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                 float*, float*, int, int);
  switch (H) {
    case 32: kernel = gru_seq_fwd_tc_kernel<32>; break;
    case 64: kernel = gru_seq_fwd_tc_kernel<64>; break;
    case 96: kernel = gru_seq_fwd_tc_kernel<96>; break;
    case 128: kernel = gru_seq_fwd_tc_kernel<128>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(H * 3 * H + 2 * RB * (H + 4) + 3 * H) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(M + RB - 1) / RB, GR * 2 * H, smem, (cudaStream_t)stream>>>(
      wh, bh, h0, gi, keep, hseq, hfinal, T, M);
  return (int)cudaGetLastError();
}

// The L2-streaming forward: H % 4 == 0, H <= 512.
extern "C" int gru_seq_fwd_l2_launch(
    const float* wh, const float* bh, const float* h0, const float* gi,
    const float* keep, float* hseq, float* hfinal, int T, int M, int H,
    void* stream) {
  if (M <= 0 || H <= 0) return 0;
  const int tm = (H <= 256) ? 16 : 8;
  const size_t smem = 2 * (size_t)tm * H * sizeof(float);
  const int blocks = (M + tm - 1) / tm;
  if (tm == 16) {
    gru_seq_fwd_l2_kernel<16><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, bh, h0, gi, keep, hseq, hfinal, T, M, H);
  } else {
    gru_seq_fwd_l2_kernel<8><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, bh, h0, gi, keep, hseq, hfinal, T, M, H);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gru_seq_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
