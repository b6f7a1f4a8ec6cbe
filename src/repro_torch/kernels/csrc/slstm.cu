// slstm_scan: the sLSTM recurrence over a whole sequence, one launch.
//
// Replaces no Pallas kernel: the reference steps `_slstm_cell` under a
// lax.scan over time (repro/models/xlstm.py:226-266; decode.py:318-346).
// The port's plain version is kernels/ref.py:slstm_scan_ref. Per step t,
// per head with hd columns, from the input's gate pre-activations xg_t
// (z, i, f, o; (4, nh, hd)) and the block-diagonal recurrent weights R
// (4, nh, hd, hd):
//   pre_g = xg_t[g] + h R[g]          (h R[g])_r = sum_p h_p R[g][p][r]
//   z = tanh(pre_z), o = sigmoid(pre_o), i = mean_r pre_i, f = mean_r pre_f
//   m' = max(log sigmoid(f) + m, i), i' = exp(i - m'), f' = exp(log sigmoid(f) + m - m')
//   c = f' c + i' z,  n = f' n + i',  h = o c / max(n, 1e-6),  m = m'
// xg in f32 or bf16 packed (B, S, 4 nh hd), R in f32 or bf16 packed, every
// sum in f32; outputs hs (B, S, nh, hd) f32 and the final (h, c, n, m);
// an optional initial state (else 0, 0, 0, -1e30).
//
// What bounds it: a chain of S dependent steps. Each step needs 4 hd^2
// MACs a head (at xlstm-1.3b's 2048-token prefill, 4 heads of 512: 17
// GFLOP in all), but step t + 1 cannot start before every column of step
// t's h is known, so the floor is S times one step's latency: the h R
// products spread over as many SMs as hold R, one exchange of h between
// them and one barrier (slstm_chain_kernel measures the last two alone).
// On an H100 (700 W) at xlstm-1.3b's prefill a step takes 2.64 us against
// 0.76 for the exchange and barrier alone; the h R products (0.6 us) and
// the exchange's stores (0.46) are most of the difference.
//
// Design: a thread-block cluster per (head, batch). The head's hd columns
// are split over `cluster` blocks of `cols` columns (kernels/slstm.py:plan:
// cluster = min(16, ceil(hd / 32)), cols = ceil(hd / cluster); 16 blocks
// of 32 columns at hd = 512, a non-portable cluster size). Each step
//   * every block reads the whole h of the step before from its own
//     shared memory (h is double-buffered);
//   * forms its columns' four pre-activations and updates (c, n, h);
//   * writes its new h columns into every peer's shared memory
//     (distributed shared memory), and one barrier.cluster arrive/wait
//     (release/acquire) ends the step.
// Two routes, a plain function of (hd, R's dtype):
//   * tensor (bf16 R, hd <= 512): the block's slice of R stays in registers
//     for the whole scan, as mma.sync m16n8k16 A fragments of R^T (its 4
//     gates x 32 columns are 8 tiles of 16 rows; 16 warps = 8 row tiles x
//     2 halves of the rows p of R, 64 registers a thread). h travels as
//     three bf16 terms (mma.cuh: splitn, about f32's 2^-24), the columns
//     0-2 of an 8-wide B operand, so one product per 16 x 16 piece of R^T
//     gives h R in f32 sums: 16 products a warp and step.
//   * streaming (R in f32, or hd above 512): f32 FMAs, a lane per column
//     and the 16 warps over rows p in groups of 8, the block's slice read
//     from L2 every step (1/cluster of the bytes the whole head needs).
// The head means of the i and f gates need every column. They come from
// the identity mean_r (h R_g)_r = h . rbar_g with rbar_g[p] = mean_r
// R_g[p][r]: the prologue forms each head's rbar_i and rbar_f (the rows
// dealt over the cluster, each written to every block) and the means of
// xg_i and xg_f of every step (into the scratch `xbar`, steps dealt over
// the cluster), then a cluster barrier. Every block forms the two dot
// products from its own copy of h in the same fixed order, so all blocks
// agree bitwise on m, and the step needs no second barrier. Clusters are
// independent: when B nh is above the clusters that fit at once they run
// in waves. A launch the card refuses raises in the wrapper: a cluster it
// cannot place (cudaOccupancyMaxActiveClusters is 0, checked before the
// first launch of each plan), or a launch error such as too much shared
// memory.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxHeadDim = 1024;
constexpr int kMaxCols = 64;       // a lane per column, at most two columns a lane
constexpr int kTensorMaxHd = 512;  // the tensor route: 32 columns a block, 16 pairs of k-steps
constexpr int kPairs = 8;          // pairs of 16-row k-steps a warp holds (kTensorMaxHd / 64)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// bytes of shared memory. tensor: h's terms twice (rows padded to 32, 16
// bytes a row), rbar_i and rbar_f, the two halves' partial sums of the 128
// gate columns, the warps' dot products. streaming: h twice, rbar_i and
// rbar_f, the warps' partial sums of the four gates and of the dot products
__host__ __device__ constexpr int slstm_smem_bytes(int hd, int cols, int tensor) {
  return tensor ? 2 * cdiv(hd, 32) * 32 * 16 + 4 * (2 * cdiv(hd, 32) * 32 + 2 * 128 + kWarps * 2)
                : 4 * (4 * cdiv(hd, 8) * 8 + kWarps * 4 * cdiv(cols, 32) * 32 + kWarps * 2);
}

struct SlstmArgs {
  const void* xg;   // (B, S, 4 nh hd)
  const void* R;    // (4, nh, hd, hd)
  const float* h0;  // (B, nh, hd) each, or null
  const float* c0;
  const float* n0;
  const float* m0;  // (B, nh) or null
  float* hs;        // (B, S, nh, hd)
  float* h;
  float* c;
  float* n;
  float* m;
  float* xbar;      // (B, nh, S, 2) scratch: mean_r xg_i, mean_r xg_f of each step
  int s, nh, hd, cluster, cols;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The prologue's head means, dealt over the cluster: rbar_i and rbar_f
// (row p = u % stride, gate i or f = u / stride) into every block's `rbar`
// ([2][stride], zero past hd), and xg's i and f means of every step into
// xbar. A warp a row, summed in the warp's fixed order.
template <typename T, typename TR>
__device__ __forceinline__ void head_means(cg::cluster_group& cluster, const SlstmArgs& a, const TR* Rg,
                                           const T* xgb, float* xbar, float* rbar, int stride) {
  const int hd = a.hd, CL = a.cluster, S = a.s;
  const int rank = static_cast<int>(cluster.block_rank()), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t D = static_cast<int64_t>(a.nh) * hd, gate = D * hd;
  for (int u = warp + kWarps * rank; u < 2 * stride; u += kWarps * CL) {
    const int gi = u / stride, p = u % stride;
    float sum = 0.0f;
    if (p < hd) {
      const TR* row = Rg + (1 + gi) * gate + static_cast<int64_t>(p) * hd;
      for (int r = lane; r < hd; r += 32) sum += rt::load_f32(row + r);
      sum = rt::warp_sum(sum);
    }
    const float mean = sum / static_cast<float>(hd);
    for (int k = lane; k < CL; k += 32) cluster.map_shared_rank(rbar, k)[u] = mean;
  }
  for (int u = warp + kWarps * rank; u < 2 * S; u += kWarps * CL) {
    const T* row = xgb + static_cast<int64_t>(u >> 1) * 4 * D + (1 + (u & 1)) * D;
    float sum = 0.0f;
    for (int r = lane; r < hd; r += 32) sum += rt::load_f32(row + r);
    sum = rt::warp_sum(sum);
    if (lane == 0) xbar[u] = sum / static_cast<float>(hd);
  }
}

// One column's cell update from its four pre-activations and the head's
// means it, ft; m is updated in every column thread alike.
__device__ __forceinline__ float cell(const float (&x)[4], float it, float ft, float& m, float& cv, float& nv,
                                      bool mine) {
  const float logf_ = log_sigmoid(ft);
  const float mnew = fmaxf(logf_ + m, it);
  const float ip = expf(it - mnew), fp = expf(logf_ + m - mnew);
  m = mnew;
  if (!mine) return 0.0f;
  const float z = tanhf(x[0]);
  const float o = 1.0f / (1.0f + expf(-x[3]));
  cv = fp * cv + ip * z;
  nv = fp * nv + ip;
  return o * cv / fmaxf(nv, 1e-6f);
}

// h as its three bf16 terms, the 8 bytes a row of the B operand starts with
__device__ __forceinline__ uint2 h_terms(float h) {
  uint32_t t[3];
  splitn<3>(h, 0.0f, t);
  return make_uint2((t[0] & 0xffffu) | (t[1] << 16), t[2] & 0xffffu);
}
__device__ __forceinline__ float h_of(uint2 w) {
  return __uint_as_float(w.x << 16) + __uint_as_float(w.x & 0xffff0000u) + __uint_as_float(w.y << 16);
}

// -- the tensor route ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) slstm_tensor_kernel(SlstmArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int hd = a.hd, nh = a.nh, S = a.s, CL = a.cluster, cols = a.cols;
  const int rank = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / CL, b = blockIdx.y;
  const int hr = cdiv(hd, 32) * 32;  // rows of h's terms: whole pairs of k-steps
  const int col0 = rank * cols, ncols = max(0, min(cols, hd - col0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bh = b * nh + head;
  const int64_t D = static_cast<int64_t>(nh) * hd;
  const int64_t gate = D * hd;

  bf16* hb = reinterpret_cast<bf16*>(smem);                 // [2][hr][8]: h's terms, columns 3-7 zero
  float* rbar = reinterpret_cast<float*>(hb + 2 * hr * 8);  // [2][hr]
  float* part = rbar + 2 * hr;                              // [2 halves][128 gate columns]
  float* red = part + 2 * 128;                              // [kWarps][2]
  const bf16* Rg = static_cast<const bf16*>(a.R) + static_cast<int64_t>(head) * hd * hd;
  const T* xgb = static_cast<const T*>(a.xg) + static_cast<int64_t>(b) * S * 4 * D +
                 static_cast<int64_t>(head) * hd;
  float* xbar = a.xbar + static_cast<int64_t>(bh) * S * 2;

  // the block's slice of R^T as A fragments: warp (row tile mt of the 128
  // gate columns gate * 32 + c, half kh of the pairs of k-steps)
  const int mt = warp & 7, kh = warp >> 3;
  const int npairs = hr / 32, half = cdiv(npairs, 2);
  const int pr0 = kh * half, pr1 = min(npairs, pr0 + half);  // this warp's pairs
  uint32_t af[2 * kPairs][4];
  {
    const unsigned short* Rb = reinterpret_cast<const unsigned short*>(Rg);
    auto rv = [&](int gc, int p) -> uint32_t {  // bits of R^T[gc][p]
      const int gt = gc >> 5, c = gc & 31;
      return (p < hd && c < ncols) ? Rb[gt * gate + static_cast<int64_t>(p) * hd + col0 + c] : 0u;
    };
    const int gc0 = mt * 16 + g, gc1 = gc0 + 8;
#pragma unroll
    for (int s = 0; s < 2 * kPairs; ++s) {
      const int k0 = (2 * pr0 + s) * 16 + 2 * t4;
      const bool in = pr0 + s / 2 < pr1;
      af[s][0] = in ? rv(gc0, k0) | (rv(gc0, k0 + 1) << 16) : 0u;
      af[s][1] = in ? rv(gc1, k0) | (rv(gc1, k0 + 1) << 16) : 0u;
      af[s][2] = in ? rv(gc0, k0 + 8) | (rv(gc0, k0 + 9) << 16) : 0u;
      af[s][3] = in ? rv(gc1, k0 + 8) | (rv(gc1, k0 + 9) << 16) : 0u;
    }
  }
  for (int e = tid; e < 2 * hr; e += kThreads) reinterpret_cast<uint4*>(hb)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int p = tid; p < hd; p += kThreads)
    *reinterpret_cast<uint2*>(hb + p * 8) = h_terms(a.h0 ? a.h0[static_cast<int64_t>(bh) * hd + p] : 0.0f);
  head_means(cluster, a, Rg, xgb, xbar, rbar, hr);
  cluster_barrier();  // rbar in every block and xbar are whole, h's terms staged

  const bool colt = tid < 32, mine = tid < ncols;
  const int64_t st = static_cast<int64_t>(bh) * hd + col0 + tid;
  float hv = 0.0f, cv = 0.0f, nv = 0.0f;
  if (mine && a.h0) {
    hv = a.h0[st];
    cv = a.c0[st];
    nv = a.n0[st];
  }
  float m = a.m0 ? a.m0[bh] : -1e30f;
  float xn[4] = {0.0f, 0.0f, 0.0f, 0.0f}, xbn[2] = {0.0f, 0.0f};
  auto fetch = [&](int t) {
    if (mine) {
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) xn[gt] = rt::load_f32(xgb + static_cast<int64_t>(t) * 4 * D + gt * D + col0 + tid);
    }
    xbn[0] = xbar[2 * t];
    xbn[1] = xbar[2 * t + 1];
  };
  if (colt && S > 0) fetch(0);

  for (int t = 0; t < S; ++t) {
    const bf16* hcur = hb + (t & 1) * hr * 8;
    bf16* hnext = hb + ((t + 1) & 1) * hr * 8;
    float x[4] = {xn[0], xn[1], xn[2], xn[3]};
    const float xbi = xbn[0], xbf = xbn[1];
    if (colt && t + 1 < S) fetch(t + 1);  // issued now, used a step later

    // h R over this warp's tile of gate columns and half of the rows:
    // B = h's terms, a pair of k-steps an ldmatrix, two chains of sums
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      if (pr0 + s < pr1) {
        uint32_t bfr[4];
        ldsm4t(bfr, hcur + ((pr0 + s) * 32 + lane) * 8);
        mma(d0, af[2 * s], bfr[0], bfr[1]);
        mma(d1, af[2 * s + 1], bfr[2], bfr[3]);
      }
    }
    // columns 0-2 of a row are h's three terms: their sum, over lanes t4 0 and 1
    float v0 = (d0[0] + d1[0]) + (d0[1] + d1[1]), v1 = (d0[2] + d1[2]) + (d0[3] + d1[3]);
    v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
    v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
    if (t4 == 0) {
      part[kh * 128 + mt * 16 + g] = v0;
      part[kh * 128 + mt * 16 + g + 8] = v1;
    }
    // the head means' dot products h . rbar, a row p a lane
    float di = 0.0f, df = 0.0f;
    for (int p = warp * 32 + lane; p < hr; p += kThreads) {
      const float hp = h_of(*reinterpret_cast<const uint2*>(hcur + p * 8));
      di = fmaf(hp, rbar[p], di);
      df = fmaf(hp, rbar[hr + p], df);
    }
    di = rt::warp_sum(di);
    df = rt::warp_sum(df);
    if (lane == 0) {
      red[2 * warp] = di;
      red[2 * warp + 1] = df;
    }
    __syncthreads();

    if (colt) {
      float it = 0.0f, ft = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        it += red[2 * w];
        ft += red[2 * w + 1];
      }
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) x[gt] += part[gt * 32 + tid] + part[128 + gt * 32 + tid];
      hv = cell(x, it + xbi, ft + xbf, m, cv, nv, mine);
      if (mine) {
        const uint2 w = h_terms(hv);
        for (int k = 0; k < CL; ++k)
          *reinterpret_cast<uint2*>(cluster.map_shared_rank(hnext, k) + (col0 + tid) * 8) = w;
        a.hs[(static_cast<int64_t>(b) * S + t) * D + static_cast<int64_t>(head) * hd + col0 + tid] = hv;
      }
    }
    cluster_barrier();  // the new h is in every block; part and red may be rewritten
  }
  if (mine) {
    a.h[st] = hv;
    a.c[st] = cv;
    a.n[st] = nv;
  }
  if (rank == 0 && tid == 0) a.m[bh] = m;
}

// -- the streaming route ------------------------------------------------------------

template <typename T, typename TR>
__global__ void __launch_bounds__(kThreads, 1) slstm_stream_kernel(SlstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int hd = a.hd, nh = a.nh, S = a.s, CL = a.cluster, cols = a.cols;
  const int rank = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / CL, b = blockIdx.y;
  const int cpad = cdiv(cols, 32) * 32, hd8 = cdiv(hd, 8), hp = hd8 * 8;
  const int col0 = rank * cols, ncols = max(0, min(cols, hd - col0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = b * nh + head;
  const int64_t D = static_cast<int64_t>(nh) * hd;
  const int64_t gate = D * hd;  // elements between two gates' R

  float* hbuf = reinterpret_cast<float*>(smem);  // [2][hp]
  float* rbar = hbuf + 2 * hp;                   // [2][hp]: rbar_i, rbar_f
  float* part = rbar + 2 * hp;                   // [kWarps][4][cpad]
  float* red = part + kWarps * 4 * cpad;         // [kWarps][2]
  const TR* Rg = static_cast<const TR*>(a.R) + static_cast<int64_t>(head) * hd * hd;
  const T* xgb = static_cast<const T*>(a.xg) + static_cast<int64_t>(b) * S * 4 * D +
                 static_cast<int64_t>(head) * hd;
  float* xbar = a.xbar + static_cast<int64_t>(bh) * S * 2;

  for (int e = tid; e < 2 * hp; e += kThreads)
    hbuf[e] = (e < hd && a.h0) ? a.h0[static_cast<int64_t>(bh) * hd + e] : 0.0f;
  head_means(cluster, a, Rg, xgb, xbar, rbar, hp);
  cluster_barrier();  // rbar in every block and xbar are whole

  // the column threads: thread tid < cpad owns column col0 + tid
  const bool colt = tid < cpad, mine = tid < ncols;
  const int64_t st = static_cast<int64_t>(bh) * hd + col0 + tid;
  float hv = 0.0f, cv = 0.0f, nv = 0.0f;
  if (mine && a.h0) {
    hv = a.h0[st];
    cv = a.c0[st];
    nv = a.n0[st];
  }
  float m = a.m0 ? a.m0[bh] : -1e30f;
  float xn[4] = {0.0f, 0.0f, 0.0f, 0.0f}, xbn[2] = {0.0f, 0.0f};
  auto fetch = [&](int t) {
    if (mine) {
#pragma unroll
      for (int g = 0; g < 4; ++g) xn[g] = rt::load_f32(xgb + static_cast<int64_t>(t) * 4 * D + g * D + col0 + tid);
    }
    xbn[0] = xbar[2 * t];
    xbn[1] = xbar[2 * t + 1];
  };
  if (colt && S > 0) fetch(0);

  for (int t = 0; t < S; ++t) {
    const float* hcur = hbuf + (t & 1) * hp;
    float* hnext = hbuf + ((t + 1) & 1) * hp;
    float x[4] = {xn[0], xn[1], xn[2], xn[3]};
    const float xbi = xbn[0], xbf = xbn[1];
    if (colt && t + 1 < S) fetch(t + 1);  // issued now, used a step later

    // h R[g] over this warp's groups of 8 rows, a lane per column (two where
    // cols > 32); the dot products with rbar on lanes 0-7 (i) and 8-15 (f)
    float acc[2][4] = {};
    float di = 0.0f, df = 0.0f;
    for (int p8 = warp; p8 < hd8; p8 += kWarps) {
      const float4 h0 = reinterpret_cast<const float4*>(hcur + p8 * 8)[0];
      const float4 h1 = reinterpret_cast<const float4*>(hcur + p8 * 8)[1];
      const float hr[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float hl = hcur[p8 * 8 + (lane & 7)];
      if (lane < 8)
        di = fmaf(hl, rbar[p8 * 8 + lane], di);
      else if (lane < 16)
        df = fmaf(hl, rbar[hp + p8 * 8 + (lane - 8)], df);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c >= cpad) break;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int p = p8 * 8 + k;
            const float rv = (p < hd && c < ncols)
                                 ? rt::load_f32(Rg + g * gate + static_cast<int64_t>(p) * hd + col0 + c)
                                 : 0.0f;
            acc[u][g] = fmaf(hr[k], rv, acc[u][g]);
          }
        }
      }
    }
    di = rt::warp_sum(di);
    df = rt::warp_sum(df);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= cpad) break;
#pragma unroll
      for (int g = 0; g < 4; ++g) part[(warp * 4 + g) * cpad + c] = acc[u][g];
    }
    if (lane == 0) {
      red[2 * warp] = di;
      red[2 * warp + 1] = df;
    }
    __syncthreads();

    if (colt) {
      float it = 0.0f, ft = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        it += red[2 * w];
        ft += red[2 * w + 1];
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] += part[(w * 4 + g) * cpad + tid];
      }
      hv = cell(x, it + xbi, ft + xbf, m, cv, nv, mine);
      if (mine) {
        for (int k = 0; k < CL; ++k) cluster.map_shared_rank(hnext, k)[col0 + tid] = hv;
        a.hs[(static_cast<int64_t>(b) * S + t) * D + static_cast<int64_t>(head) * hd + col0 + tid] = hv;
      }
    }
    cluster_barrier();  // the new h is in every block; part and red may be rewritten
  }
  if (mine) {
    a.h[st] = hv;
    a.c[st] = cv;
    a.n[st] = nv;
  }
  if (rank == 0 && tid == 0) a.m[bh] = m;
}

// The chain's floor: the same cluster doing S steps of the h exchange and
// the barrier, with no arithmetic (each column thread passes on a value it
// read from its own copy of h).
__global__ void __launch_bounds__(kThreads, 1) slstm_chain_kernel(float* out, int s, int hd, int cluster_size, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int hp = cdiv(hd, 8) * 8, col0 = rank * cols, ncols = max(0, min(cols, hd - col0));
  const int tid = threadIdx.x;
  float* hbuf = reinterpret_cast<float*>(smem);
  for (int e = tid; e < 2 * hp; e += kThreads) hbuf[e] = 0.0f;
  cluster_barrier();
  float hv = 0.0f;
  for (int t = 0; t < s; ++t) {
    const float* hcur = hbuf + (t & 1) * hp;
    float* hnext = hbuf + ((t + 1) & 1) * hp;
    if (tid < ncols) {
      hv = hcur[(col0 + tid + 1) % hd];
      for (int k = 0; k < cluster_size; ++k) cluster.map_shared_rank(hnext, k)[col0 + tid] = hv;
    }
    cluster_barrier();
  }
  if (tid < ncols) out[(static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * cols + tid] = hv;
}

// the launch configuration of a plan: a cluster of `cluster` blocks per
// (head, batch), non-portable above 8 blocks
template <typename K>
cudaError_t configure(K kern, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int nh,
                      int batch, int smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster * nh, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

using KernelFn = void (*)(SlstmArgs);

KernelFn pick(int xg_bf16, int r_bf16, int tensor) {
  using bf = __nv_bfloat16;
  if (tensor) return xg_bf16 ? slstm_tensor_kernel<bf> : slstm_tensor_kernel<float>;
  if (xg_bf16) return r_bf16 ? slstm_stream_kernel<bf, bf> : slstm_stream_kernel<bf, float>;
  return r_bf16 ? slstm_stream_kernel<float, bf> : slstm_stream_kernel<float, float>;
}

bool plan_ok(int hd, int cluster, int cols, int r_bf16, int tensor) {
  return hd >= 1 && hd <= kMaxHeadDim && cluster >= 1 && cluster <= kMaxCluster && cols >= 1 &&
         cols <= kMaxCols && cluster * cols >= hd && (cluster - 1) * cols < hd &&
         (!tensor || (r_bf16 && hd <= kTensorMaxHd && cols <= 32));
}

}  // namespace

// Bytes of shared memory a block of the plan takes.
extern "C" int rt_slstm_smem(int hd, int cols, int tensor) { return slstm_smem_bytes(hd, cols, tensor); }

// cudaOccupancyMaxActiveClusters for the plan (0: it cannot be placed), or
// minus a cudaError_t.
extern "C" int rt_slstm_max_clusters(int hd, int cluster, int cols, int xg_bf16, int r_bf16, int tensor) {
  if (!plan_ok(hd, cluster, cols, r_bf16, tensor)) return -static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kern = pick(xg_bf16, r_bf16, tensor);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(kern, cfg, attr, cluster, 1, 1, slstm_smem_bytes(hd, cols, tensor), nullptr);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// xg packed (batch, s, 4 nh hd), f32 (xg_bf16 = 0) or bf16; R packed (4,
// nh, hd, hd), f32 (r_bf16 = 0) or bf16; h0/c0/n0/m0 null for the zero
// state; xbar scratch of (batch, nh, s, 2) f32. The plan (cluster, cols,
// tensor) is kernels/slstm.py:plan's; the wrapper has checked with
// rt_slstm_max_clusters that the card places its cluster (once per plan,
// so no query runs while a CUDA graph captures the launch).
extern "C" int rt_slstm_scan(const void* xg, const void* R, const float* h0, const float* c0,
                             const float* n0, const float* m0, float* hs, float* h, float* c,
                             float* n, float* m, float* xbar, int batch, int s, int nh, int hd,
                             int cluster, int cols, int tensor, int xg_bf16, int r_bf16,
                             void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (s < 0 || !plan_ok(hd, cluster, cols, r_bf16, tensor)) return cudaErrorInvalidValue;
  const SlstmArgs args{xg, R, h0, c0, n0, m0, hs, h, c, n, m, xbar, s, nh, hd, cluster, cols};
  const KernelFn kern = pick(xg_bf16, r_bf16, tensor);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(kern, cfg, attr, cluster, nh, batch, slstm_smem_bytes(hd, cols, tensor),
                            static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kern, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The chain's floor at the plan's cluster shape: s steps of the h exchange
// and the cluster barrier; out takes (batch, cluster nh, cols) f32.
extern "C" int rt_slstm_chain_floor(float* out, int batch, int s, int nh, int hd, int cluster, int cols,
                                    void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (s < 0 || !plan_ok(hd, cluster, cols, 1, 0)) return cudaErrorInvalidValue;
  const int smem = 4 * 2 * cdiv(hd, 8) * 8;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(slstm_chain_kernel, cfg, attr, cluster, nh, batch, smem,
                            static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, slstm_chain_kernel, out, s, hd, cluster, cols);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
