// Fused GRU sequence backward, in two kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernel cleanmarl_tpu/ops/pallas_gru.py:_make_bwd_kernel
// (launched by _bwd_call, pl.pallas_call at :197), which walks the
// sequence in reverse, recomputes the gates from gi and
// h_prev = keep[t-1] * h_seq[t-1] (h0 at t = 0), emits dgi and dh0, and
// accumulates dwh, dbh over all steps and all row tiles with `+=` into
// one output block. That accumulation is safe on the TPU, whose grid runs
// in order, and a race on Hopper, whose blocks run at the same time. So
// the work is split into the recurrence and a weight-gradient GEMM.
//
// Precision: both products run on the tensor cores with mma.sync
// m16n8k8 TF32 in the 3xTF32 split (helpers in tf32_mma.cuh). Each
// operand x becomes big = x rounded to TF32 (as cvt.rna.tf32 rounds) and
// small = x - big, and acc += small*big' + big*small' + big*big' with float32
// accumulation, which keeps each product's error near 2^-21 (float32
// accuracy). The tensor core truncates when it adds into its float32
// accumulator, so a long chain of mma into one accumulator drifts (2.5e-3
// at the main path's shape with 1,572 mma per chain): the weight gradient
// restarts its mma accumulators every 64-row slab, the recurrence every
// gate round, and both add them into their sums with rounded float32
// adds, which leaves dwh closer to a float64 reference than cuBLAS's
// float32 product. The kernels never read
// torch.backends.cuda.matmul.allow_tf32: the scheme is fixed. Every sum
// is taken in a fixed order, so the bits are the same on every run.
//
// 1. gru_seq_bwd_tc_kernel (the recurrence, H in {32, 64, 96, 128}).
//    A block owns RB = 32 rows (two m16 tiles) and walks t = T-1 .. 0.
//    wh (H x 3H, 192 KiB at H = 128) is copied once into shared memory and
//    serves both products: gh = h_prev @ wh reads it as (k, n), and
//    dgh @ wh^T reads the same array as (n, k) in its B fragments. The
//    columns are XOR-swizzled (wh_swz) so that the fragment loads of both
//    products are free of bank conflicts. Shared memory at H = 128:
//    wh 196,608 B + h_prev tile 32 x 132 floats (16,896 B) + one gate of
//    dgh 32 x 132 (16,896 B) + bh 1,536 B = 231,936 of the 232,448 B a
//    block may use, so one block per SM and RB = 32 rows per block:
//    3072 rows -> 96 blocks, one wave on 132 SMs (16-row blocks would be
//    192 blocks, two waves). Warp w (H/16 warps) owns hidden columns
//    [16w, 16w + 16): it computes gh at those columns of all three gates,
//    so the gating needs no exchange, and the carry dh for those columns
//    stays in registers in the mma accumulator layout for the whole walk.
//    Per step:
//      - the step's inputs that do not depend on the carry (gi[t],
//        g_hseq[t], keep) are loaded into registers first, so their
//        latency hides behind the gh product; h_prev[t] was copied into
//        shared memory with cp.async during the previous step;
//      - gh = keep[t-1] * (h_seq[t-1] @ wh) + bh (keep is 0 or 1, so the
//        scale moves from the operand to the product);
//      - the gates and their gradients, dgi[t] and dghn[t] stored;
//      - dh = dh2 * z + dgh @ wh^T in three rounds, one gate of dgh at a
//        time through one shared buffer (the whole 32 x 3H dgh does not
//        fit beside wh), each round's product in fresh accumulators added
//        into dh with rounded float32 adds; h_prev[t-1] starts loading
//        after the first round's barrier, when no warp reads the h_prev
//        tile any more.
//    The gh product stays at the head of each step, on the serial chain.
//    Issuing step t-1's gh (which needs only h_seq, not the carry) inside
//    step t's dh rounds was built and gave the same bits, and was no
//    faster: its accumulators (48 floats per thread) live across the rounds
//    on top of this kernel's 216 registers, so every variant hit the
//    255-register cap and spilled, with gi/bh folded into the accumulators
//    early, and with the gh k-steps interleaved with or after the dh
//    k-steps. 16 warps of one m16 tile each (4 per SM sub-partition instead
//    of 2) cap a thread at 128 registers and spilled more. The shared
//    memory holds no second h_prev tile to double-buffer.
// 2. gru_seq_bwd_l2_kernel (the recurrence at every other width, up to
//    H = 512): the float32 SIMT kernel that streams wh and wh^T from L2
//    each step, one thread per hidden column. The wrapper picks the kernel
//    by width (ops/gru_kernel.py:bwd_route); wh does not fit in shared
//    memory above H = 128.
// 3. gru_seq_dw_tc_kernel + gru_seq_dw_reduce_kernel (the weight
//    gradient), a split-K GEMM dwh = sum_r h_prev[r]^T dgh[r] over the
//    R = T*M rows (t, m), dbh = sum_r dgh[r], on mma.sync with fragments
//    loaded by hand: wgmma takes TF32 operands from shared memory only
//    K-major, and both operands here are contiguous along H / 3H, not along
//    the rows summed over. Output tiles of 128 x 128, S contiguous row
//    ranges (S * tiles <= the SM count: 3 tiles x 44 splits = 132 blocks at
//    H = 128), 8 warps of 64 x 32 outputs per block. Slabs of 64 rows of
//    h_prev (h0 for t = 0, raw h_seq[t-1] after) and dgh (the first 2H
//    columns from dgi, the n block from dghn) go through a 3-stage cp.async
//    ring, rows padded to 136 floats so the fragment reads are free of bank
//    conflicts; keep[t-1] scales the dgh fragments as they are read
//    (sum (keep h)^T dgh = sum h^T (keep dgh)), and the next k-step's
//    fragment values are read before this k-step's mma. dbh is summed from
//    the B fragments the warps already hold, each of the two warp rows
//    taking every second k-step (8 adds per 48 mma there), in the blocks
//    of the first k tile. Each block writes its partial, the reduce
//    kernel adds the S partials in a fixed order: no float atomics.
//
// dgi may be gi itself (ops/gru_kernel.py: GruSeq with consume_gi), so
// the two recurrences leave those two pointers without __restrict__: the
// thread that stores dgi[t] at a row and column is the one that loaded
// gi[t] there earlier in the same step, no thread reads another's, and no
// step reads gi[t] again. The dw kernel reads dgi and never gi.
//
// Bounds (T = 60, M = 3072, H = 128; benchmark/yardstick.py:gru_least_s): the
// recurrence does 2 * 2*T*M*H*3H FLOP against 853 MB, the weight gradient
// 2*T*M*H*3H against 378 MB (h0, h_seq[:T-1], keep[:T-1], dgi's first 2H
// columns, dghn, dwh, dbh); as 3xTF32 at 495 TFLOP/s both are bound by
// bytes (0.255 ms and 0.113 ms at 3.35 TB/s).
#include "tf32_mma.cuh"

// --------------------------------------------------------------------------
// 1. the recurrence on the tensor cores, wh resident in shared memory
// --------------------------------------------------------------------------

// Copy the rows entering step t (h0 at t = 0, raw h_seq[t-1] after) of the
// block's RB rows into the shared tile; rows past M are zero-filled.
template <int H>
__device__ __forceinline__ void load_hprev(float* hps, const float* __restrict__ h0,
                                           const float* __restrict__ hseq, int t, int M,
                                           int row0, int tid) {
  constexpr int LD = H + 4, CH = H / 4;
  for (int i = tid; i < RB * CH; i += 4 * H / JN) {
    const int r = i / CH, c = (i % CH) * 4;
    const int m = row0 + r;
    const bool ok = m < M;
    const size_t mm = ok ? (size_t)m : 0;
    const float* src = (t == 0 ? h0 + mm * H : hseq + ((size_t)(t - 1) * M + mm) * H) + c;
    cp_async16(hps + r * LD + c, src, ok ? 16 : 0);
  }
}

// H / 16 warps of 32 threads (256 at H = 128), one block per SM.
template <int H>
__global__ void __launch_bounds__(4 * H / JN, 1) gru_seq_bwd_tc_kernel(
    const float* __restrict__ wh, const float* __restrict__ bh,
    const float* __restrict__ h0, const float* __restrict__ hseq,
    const float* gi, const float* __restrict__ keep,
    const float* __restrict__ g_hseq, const float* __restrict__ g_hfinal,
    float* dgi, float* __restrict__ dghn, float* __restrict__ dh0, int T,
    int M) {
  constexpr int H3 = 3 * H, LD = H + 4, NT = 4 * H / JN;
  extern __shared__ float4 smem4[];
  float* whs = reinterpret_cast<float*>(smem4);  // H x 3H, swizzled
  float* hps = whs + H * H3;                     // RB x LD: rows entering step t
  float* dgs = hps + RB * LD;                    // RB x LD: one gate of dgh
  float* bhs = dgs + RB * LD;                    // 3H
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int jw = (tid >> 5) * 8 * JN;            // the warp's hidden columns
  const int row0 = blockIdx.x * RB;

  load_wh_swz<H>(whs, wh, tid, NT);
  for (int i = tid; i < H3; i += NT) bhs[i] = bh[i];
  if (T > 0) load_hprev<H>(hps, h0, hseq, T - 1, M, row0, tid);
  cp_async_commit();

  // The thread's elements, in the m16n8 accumulator layout: [jn][mi][e] is
  // row 16*mi + g + 8*(e >> 1), hidden column jw + 8*jn + 2*q + (e & 1).
  float dh[JN][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = row0 + 16 * mi + g + 8 * hh;
#pragma unroll
      for (int jn = 0; jn < JN; ++jn) {
        float2 v = make_float2(0.0f, 0.0f);
        if (m < M)
          v = *reinterpret_cast<const float2*>(g_hfinal + (size_t)m * H + jw + 8 * jn + 2 * q);
        dh[jn][mi][2 * hh] = v.x;
        dh[jn][mi][2 * hh + 1] = v.y;
      }
    }

  for (int t = T - 1; t >= 0; --t) {
    // inputs of step t that do not depend on the carry
    float2 xr[2][2][JN], xz[2][2][JN], xn[2][2][JN], gs[2][2][JN];  // [mi][hh][jn]
    float kt[2][2], sc[2][2];  // keep[t][m]; keep[t-1][m] (1 at t = 0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = row0 + 16 * mi + g + 8 * hh;
        const bool ok = m < M;
        const size_t row = (size_t)t * M + (ok ? m : 0);
        kt[mi][hh] = ok ? keep[row] : 0.0f;
        sc[mi][hh] = ok ? (t > 0 ? keep[row - M] : 1.0f) : 0.0f;
#pragma unroll
        for (int jn = 0; jn < JN; ++jn) {
          const int j = jw + 8 * jn + 2 * q;
          const float2 z2 = make_float2(0.0f, 0.0f);
          xr[mi][hh][jn] = ok ? *reinterpret_cast<const float2*>(gi + row * H3 + j) : z2;
          xz[mi][hh][jn] = ok ? *reinterpret_cast<const float2*>(gi + row * H3 + H + j) : z2;
          xn[mi][hh][jn] = ok ? *reinterpret_cast<const float2*>(gi + row * H3 + 2 * H + j) : z2;
          gs[mi][hh][jn] = ok ? *reinterpret_cast<const float2*>(g_hseq + row * H + j) : z2;
        }
      }
    cp_async_wait<0>();
    __syncthreads();

    // gh without bias or keep scale: raw rows @ wh, three gates x two
    // 8-column tiles x two m16 tiles
    float acc[3][JN][2][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int jn = 0; jn < JN; ++jn)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][jn][mi][e] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < H / 8; ++ks) {
      const int k = ks * 8 + q;
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a_frag(hps + 16 * mi * LD + ks * 8, LD, g, q, ab[mi], as[mi]);
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
          for (int jn = 0; jn < JN; ++jn)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const uint32_t(&b)[2] = pass == 1 ? bs[a][jn] : bb[a][jn];
              mma_tf32(acc[a][jn][mi], pass == 0 ? as[mi] : ab[mi], b[0], b[1]);
            }
    }

    // gates and their gradients; acc becomes dgh = [da_r, da_z, da_n * r],
    // dh becomes dh2 * z (the start of the dh product)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = 16 * mi + g + 8 * hh;
        const int m = row0 + rl;
        const size_t row = (size_t)t * M + m;
#pragma unroll
        for (int jn = 0; jn < JN; ++jn) {
          const int j = jw + 8 * jn + 2 * q;
          const float2 hraw = *reinterpret_cast<const float2*>(hps + rl * LD + j);
          float out_r[2], out_z[2], out_n[2], out_g[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * hh + u;
            const float s = sc[mi][hh];
            const float hp = s * (u ? hraw.y : hraw.x);
            const float ghr = s * acc[0][jn][mi][e] + bhs[j + u];
            const float ghz = s * acc[1][jn][mi][e] + bhs[H + j + u];
            const float ghn = s * acc[2][jn][mi][e] + bhs[2 * H + j + u];
            const float rg = sigmoidf_((u ? xr[mi][hh][jn].y : xr[mi][hh][jn].x) + ghr);
            const float zg = sigmoidf_((u ? xz[mi][hh][jn].y : xz[mi][hh][jn].x) + ghz);
            const float ng = tanhf((u ? xn[mi][hh][jn].y : xn[mi][hh][jn].x) + rg * ghn);
            const float dh2 =
                (u ? gs[mi][hh][jn].y : gs[mi][hh][jn].x) + kt[mi][hh] * dh[jn][mi][e];
            const float dz = dh2 * (hp - ng);
            const float dn = dh2 * (1.0f - zg);
            const float da_n = dn * (1.0f - ng * ng);
            const float da_r = da_n * ghn * rg * (1.0f - rg);
            const float da_z = dz * zg * (1.0f - zg);
            const float dgn = da_n * rg;
            out_r[u] = da_r; out_z[u] = da_z; out_n[u] = da_n; out_g[u] = dgn;
            acc[0][jn][mi][e] = da_r;
            acc[1][jn][mi][e] = da_z;
            acc[2][jn][mi][e] = dgn;
            dh[jn][mi][e] = dh2 * zg;
          }
          if (m < M) {
            float* d = dgi + row * H3 + j;
            *reinterpret_cast<float2*>(d) = make_float2(out_r[0], out_r[1]);
            *reinterpret_cast<float2*>(d + H) = make_float2(out_z[0], out_z[1]);
            *reinterpret_cast<float2*>(d + 2 * H) = make_float2(out_n[0], out_n[1]);
            *reinterpret_cast<float2*>(dghn + row * H + j) = make_float2(out_g[0], out_g[1]);
          }
        }
      }

    // dh += dgh @ wh^T, one gate of dgh at a time through dgs
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (a) __syncthreads();  // every warp is done reading the previous gate
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int jn = 0; jn < JN; ++jn)
            *reinterpret_cast<float2*>(dgs + (16 * mi + g + 8 * hh) * LD + jw + 8 * jn + 2 * q) =
                make_float2(acc[a][jn][mi][2 * hh], acc[a][jn][mi][2 * hh + 1]);
      __syncthreads();
      if (a == 0 && t > 0) {  // no warp reads the h_prev tile any more
        load_hprev<H>(hps, h0, hseq, t - 1, M, row0, tid);
        cp_async_commit();
      }
      float part[JN][2][4];  // this gate's product, added into dh with rounded adds
#pragma unroll
      for (int jn = 0; jn < JN; ++jn)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[jn][mi][e] = 0.0f;
#pragma unroll 2
      for (int ks = 0; ks < H / 8; ++ks) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          load_a_frag(dgs + 16 * mi * LD + ks * 8, LD, g, q, ab[mi], as[mi]);
        const int c = a * H + ks * 8 + q;
        uint32_t bb[JN][2], bs[JN][2];
#pragma unroll
        for (int jn = 0; jn < JN; ++jn) {
          const int jr = jw + 8 * jn + g;  // row of wh = column of wh^T
          const float* w = whs + jr * H3;
          const int s = wh_swz(jr);
          split_tf32(w[c ^ s], bb[jn][0], bs[jn][0]);
          split_tf32(w[(c + 4) ^ s], bb[jn][1], bs[jn][1]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int jn = 0; jn < JN; ++jn)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const uint32_t(&b)[2] = pass == 1 ? bs[jn] : bb[jn];
              mma_tf32(part[jn][mi], pass == 0 ? as[mi] : ab[mi], b[0], b[1]);
            }
      }
#pragma unroll
      for (int jn = 0; jn < JN; ++jn)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[jn][mi][e] += part[jn][mi][e];
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = row0 + 16 * mi + g + 8 * hh;
      if (m >= M) continue;
#pragma unroll
      for (int jn = 0; jn < JN; ++jn)
        *reinterpret_cast<float2*>(dh0 + (size_t)m * H + jw + 8 * jn + 2 * q) =
            make_float2(dh[jn][mi][2 * hh], dh[jn][mi][2 * hh + 1]);
    }
}

// --------------------------------------------------------------------------
// 2. the recurrence at other widths: float32 SIMT, wh streamed from L2
// --------------------------------------------------------------------------

// A block owns TM rows and walks t = T-1 .. 0 with the carry gradient dh
// for its rows in registers (thread j owns column j). Per step it
// recomputes gh for the three gate columns of j, forms the gate gradients,
// and takes dh = dh2 * z + dgh @ wh^T through shared memory, read against
// wh^T (3H, H) so the loads of a warp are coalesced. Rows per block: 16 up
// to H = 256, 8 above it (register file at 512 threads).
template <int TM>
__global__ void __launch_bounds__(TM == 16 ? 256 : 512) gru_seq_bwd_l2_kernel(
    const float* __restrict__ wh, const float* __restrict__ whT,
    const float* __restrict__ bh, const float* __restrict__ h0,
    const float* __restrict__ hseq, const float* gi,
    const float* __restrict__ keep, const float* __restrict__ g_hseq,
    const float* __restrict__ g_hfinal, float* dgi,
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

// --------------------------------------------------------------------------
// 3. the weight gradient: split-K GEMM on the tensor cores, fixed-order reduce
// --------------------------------------------------------------------------

constexpr int DW_BM = 128;    // rows of dwh (index k of H) per tile
constexpr int DW_BN = 128;    // columns of dwh (index c of 3H) per tile
constexpr int DW_BK = 64;     // rows (t, m) per slab
constexpr int DW_STAGES = 3;  // cp.async ring depth
constexpr int DW_LD = 136;    // padded slab row: 136 = 8 (mod 32 banks)
constexpr int DW_WARPS_M = 2;  // warps along k (rows of dwh)
constexpr int DW_WARPS_N = 4;  // warps along c; a warp owns DW_BN / DW_WARPS_N = 32 columns
constexpr int DW_MT = DW_BM / (16 * DW_WARPS_M);  // m16 tiles per warp
constexpr int DW_THREADS = 32 * DW_WARPS_M * DW_WARPS_N;
// one stage: A (DW_BK x DW_LD), B (DW_BK x DW_LD), the slab rows' keep scale
constexpr int DW_STAGE_FLOATS = 2 * DW_BK * DW_LD + DW_BK;
constexpr size_t DW_SMEM = (size_t)DW_STAGES * DW_STAGE_FLOATS * sizeof(float);

// 256 threads = 8 warps as 2 (k) x 4 (c); a warp owns 64 x 32 of the tile,
// 4 x 4 m16n8 accumulators. Each A fragment is split by the 4 warps of its
// row and each B fragment by 2, fewer than with 16 warps of 32 x 32 (which
// ran slower at the main path's shape: half the registers per thread,
// twice the redundant splits). The mma chain of one slab (24 mma
// deep) runs in acc, which is then added into tot with rounded float32
// adds (see the precision note above).
__global__ void __launch_bounds__(DW_THREADS, 1) gru_seq_dw_tc_kernel(
    const float* __restrict__ h0, const float* __restrict__ hseq,
    const float* __restrict__ keep, const float* __restrict__ dgi,
    const float* __restrict__ dghn, float* __restrict__ part_w,
    float* __restrict__ part_b, int T, int M, int H, long long rows_per_split) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp / DW_WARPS_N, wn = warp % DW_WARPS_N;
  const int H3 = 3 * H;
  const int k0 = blockIdx.y * DW_BM, c0 = blockIdx.x * DW_BN;
  const long long R = (long long)T * M;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  const long long r_end = r_begin + rows_per_split < R ? r_begin + rows_per_split : R;
  const int n_slabs = r_end > r_begin ? (int)((r_end - r_begin + DW_BK - 1) / DW_BK) : 0;
  const bool do_bias = blockIdx.y == 0;  // block-uniform

  // slab s -> its ring stage: A = raw h_prev rows (h0 or h_seq[t-1]), B = dgh
  auto load_slab = [&](int s) {
    float* A = ring + (s % DW_STAGES) * DW_STAGE_FLOATS;
    float* B = A + DW_BK * DW_LD;
    const long long rb = r_begin + (long long)s * DW_BK;
#pragma unroll
    for (int u = 0; u < DW_BK * DW_BM / 4 / DW_THREADS; ++u) {
      const int i = tid + DW_THREADS * u;
      const int rr = i >> 5, cc = (i & 31) * 4;
      const long long r = rb + rr;
      const bool rok = r < r_end;
      const int k = k0 + cc;
      const bool aok = rok && k < H;
      const float* a_src = !aok ? h0
                           : r < M ? h0 + r * H + k
                                   : hseq + (r - M) * H + k;
      cp_async16(A + rr * DW_LD + cc, a_src, aok ? 16 : 0);
      const int c = c0 + cc;
      const bool bok = rok && c < H3;
      const float* b_src = !bok ? dgi
                           : c < 2 * H ? dgi + r * H3 + c
                                       : dghn + r * H + (c - 2 * H);
      cp_async16(B + rr * DW_LD + cc, b_src, bok ? 16 : 0);
    }
  };
  // keep[t-1] of slab row tid (1 for t = 0, 0 past the range), tid < DW_BK
  auto row_scale = [&](int s) {
    const long long r = r_begin + (long long)s * DW_BK + tid;
    return r >= r_end ? 0.0f : r < M ? 1.0f : keep[r - M];
  };
  auto scale_slot = [&](int s) {
    return ring + (s % DW_STAGES) * DW_STAGE_FLOATS + 2 * DW_BK * DW_LD;
  };

  float acc[DW_MT][4][4];
#pragma unroll
  for (int i = 0; i < DW_MT; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
  float tot[DW_MT][4][4];
#pragma unroll
  for (int i = 0; i < DW_MT; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][n][e] = 0.0f;
  float bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < n_slabs) {
      load_slab(s);
      if (tid < DW_BK) scale_slot(s)[tid] = row_scale(s);
    }
    cp_async_commit();
  }
  // The scale of slab s + STAGES - 1 is read into a register while slab s
  // is computed and stored one iteration later, when it has arrived.
  float pending_scale = 0.0f;

  for (int s = 0; s < n_slabs; ++s) {
    if (s > 0 && tid < DW_BK && s + DW_STAGES - 2 < n_slabs)
      scale_slot(s + DW_STAGES - 2)[tid] = pending_scale;
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // slab s landed; every warp is done with slab s - 1
    if (s + DW_STAGES - 1 < n_slabs) {
      load_slab(s + DW_STAGES - 1);
      if (tid < DW_BK) pending_scale = row_scale(s + DW_STAGES - 1);
    }
    cp_async_commit();

    const float* A = ring + (s % DW_STAGES) * DW_STAGE_FLOATS;
    const float* B = A + DW_BK * DW_LD;
    const float* S = B + DW_BK * DW_LD;
    // raw fragment values of k-step kk, loaded one k-step ahead
    float xa[DW_MT][4], xb[4][2], xs[2];
    auto load_frag = [&](int kk) {
      const float* a_lo = A + (8 * kk + q) * DW_LD + 16 * DW_MT * wm + g;
      const float* a_hi = a_lo + 4 * DW_LD;
      const float* b_lo = B + (8 * kk + q) * DW_LD + 32 * wn + g;
      const float* b_hi = b_lo + 4 * DW_LD;
#pragma unroll
      for (int i = 0; i < DW_MT; ++i) {
        xa[i][0] = a_lo[16 * i]; xa[i][1] = a_lo[16 * i + 8];
        xa[i][2] = a_hi[16 * i]; xa[i][3] = a_hi[16 * i + 8];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) { xb[n][0] = b_lo[8 * n]; xb[n][1] = b_hi[8 * n]; }
      xs[0] = S[8 * kk + q]; xs[1] = S[8 * kk + q + 4];
    };
    load_frag(0);
#pragma unroll
    for (int kk = 0; kk < DW_BK / 8; ++kk) {
      uint32_t ab[DW_MT][4], as[DW_MT][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < DW_MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(xa[i][e], ab[i][e], as[i][e]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (do_bias && kk % DW_WARPS_M == wm) bsum[n] += xb[n][0] + xb[n][1];
        split_tf32(xs[0] * xb[n][0], bb[n][0], bs[n][0]);
        split_tf32(xs[1] * xb[n][1], bb[n][1], bs[n][1]);
      }
      if (kk + 1 < DW_BK / 8) load_frag(kk + 1);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int i = 0; i < DW_MT; ++i)
            mma_tf32(acc[i][n], pass == 0 ? as[i] : ab[i], pass == 1 ? bs[n][0] : bb[n][0],
                     pass == 1 ? bs[n][1] : bb[n][1]);
    }
#pragma unroll
    for (int i = 0; i < DW_MT; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[i][n][e] += acc[i][n][e];
          acc[i][n][e] = 0.0f;
        }
  }
  cp_async_wait<0>();

  float* pw = part_w + (size_t)blockIdx.z * H * H3;
#pragma unroll
  for (int i = 0; i < DW_MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = k0 + 16 * DW_MT * wm + 16 * i + g + 8 * hh;
      if (k >= H) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = c0 + 32 * wn + 8 * n + 2 * q;
        if (c < H3)
          *reinterpret_cast<float2*>(pw + (size_t)k * H3 + c) =
              make_float2(tot[i][n][2 * hh], tot[i][n][2 * hh + 1]);
      }
    }
  if (do_bias) {  // the warp rows' column sums, added in row order
    float* red = ring;  // DW_WARPS_M x DW_BN
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v = bsum[n];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) red[wm * DW_BN + 32 * wn + 8 * n + g] = v;
    }
    __syncthreads();
    if (tid < DW_BN && c0 + tid < H3) {
      float v = 0.0f;
      for (int w = 0; w < DW_WARPS_M; ++w) v += red[w * DW_BN + tid];
      part_b[(size_t)blockIdx.z * H3 + c0 + tid] = v;
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

// --------------------------------------------------------------------------
// C interface (ctypes); each returns a cudaError_t code, 0 on success
// --------------------------------------------------------------------------

// The tensor-core recurrence: H in {32, 64, 96, 128}.
extern "C" int gru_seq_bwd_launch(
    const float* wh, const float* bh, const float* h0, const float* hseq,
    const float* gi, const float* keep, const float* g_hseq, const float* g_hfinal,
    float* dgi, float* dghn, float* dh0, int T, int M, int H, void* stream) {
  if (M <= 0) return 0;
  void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                 const float*, const float*, const float*, float*, float*, float*, int, int);
  switch (H) {
    case 32: kernel = gru_seq_bwd_tc_kernel<32>; break;
    case 64: kernel = gru_seq_bwd_tc_kernel<64>; break;
    case 96: kernel = gru_seq_bwd_tc_kernel<96>; break;
    case 128: kernel = gru_seq_bwd_tc_kernel<128>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(H * 3 * H + 2 * RB * (H + 4) + 3 * H) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(M + RB - 1) / RB, 4 * H / JN, smem, (cudaStream_t)stream>>>(
      wh, bh, h0, hseq, gi, keep, g_hseq, g_hfinal, dgi, dghn, dh0, T, M);
  return (int)cudaGetLastError();
}

// The L2-streaming recurrence: H % 4 == 0, H <= 512.
extern "C" int gru_seq_bwd_l2_launch(
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
      err = cudaFuncSetAttribute(gru_seq_bwd_l2_kernel<16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    gru_seq_bwd_l2_kernel<16><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, whT, bh, h0, hseq, gi, keep, g_hseq, g_hfinal, dgi, dghn, dh0, T,
        M, H);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gru_seq_bwd_l2_kernel<8>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    gru_seq_bwd_l2_kernel<8><<<blocks, H, smem, (cudaStream_t)stream>>>(
        wh, whT, bh, h0, hseq, gi, keep, g_hseq, g_hfinal, dgi, dghn, dh0, T,
        M, H);
  }
  return (int)cudaGetLastError();
}

// The dw kernel's output tiles at width H and rows per slab, from which the
// wrapper picks S (ops/gru_kernel.py:dw_splits).
extern "C" int gru_seq_dw_tiles(int H) {
  return ((3 * H + DW_BN - 1) / DW_BN) * ((H + DW_BM - 1) / DW_BM);
}
extern "C" int gru_seq_dw_slab_rows() { return DW_BK; }

// part_w must hold S * H * 3H floats and part_b S * 3H floats; H % 4 == 0;
// rows_per_split * S >= T * M.
extern "C" int gru_seq_dw_launch(
    const float* h0, const float* hseq, const float* keep, const float* dgi,
    const float* dghn, float* part_w, float* part_b, float* dwh, float* dbh,
    int T, int M, int H, int S, long long rows_per_split, void* stream) {
  if (H <= 0 || S <= 0) return 0;
  const int H3 = 3 * H;
  cudaError_t err = cudaFuncSetAttribute(
      gru_seq_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H3 + DW_BN - 1) / DW_BN, (H + DW_BM - 1) / DW_BM, S);
  gru_seq_dw_tc_kernel<<<grid, DW_THREADS, DW_SMEM, (cudaStream_t)stream>>>(
      h0, hseq, keep, dgi, dghn, part_w, part_b, T, M, H, rows_per_split);
  err = cudaGetLastError();
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
