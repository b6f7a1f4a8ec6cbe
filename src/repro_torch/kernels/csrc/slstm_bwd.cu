// slstm_scan_bwd: the gradient of the sLSTM recurrence (slstm.cu), for
// training.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// lax.scan of _slstm_cell (repro/models/xlstm.py); the port's forward on the
// card is slstm_scan, so the backward of its time loop is a kernel too. The
// plain version is kernels/ref.py:slstm_scan_bwd_ref (autograd of
// slstm_scan_ref). Per step t, head h and column r, from the pre-activations
// pre_t = xg_t + h_{t-1} R (the host forms them for every step at once
// from the forward's hs: h_{t-1} is known):
//   z = tanh(pre_z), o = sigmoid(pre_o), i~ = mean_r pre_i, f~ = mean_r pre_f,
//   m_t = max(logsigmoid(f~) + m_{t-1}, i~), i' = exp(i~ - m_t),
//   f' = exp(logsigmoid(f~) + m_{t-1} - m_t), c_t = f' c_{t-1} + i' z,
//   n_t = f' n_{t-1} + i', h_t = o c_t / max(n_t, 1e-6).
// Backwards, the chain runs from the last step to the first: the gradient
// of h_t (its output's plus the next step's dh_{t-1}) gives the four gates'
// dpre_t, elementwise but for two head sums (i~ and f~ are head means, so
// their gradient is one scalar a gate, the same in every column), and
//   dh_{t-1}[p] = sum_r R_z[p][r] dpre_z[r] + sum_r R_o[p][r] dpre_o[r]
//                 + sc_i rowsum(R_i)[p] + sc_f rowsum(R_f)[p],
// the forward's matvec chain run backwards, with half of it gone: dpre_i
// and dpre_f are the scalars sc_i, sc_f in every column, so their two gates
// of R enter only as row sums. m's max splits a tie's gradient in two, as
// autograd does; the clamp passes it where n_t >= 1e-6. dR = sum_t
// h_{t-1}^T dpre_t is one plain product of what this kernel writes, left
// to the host, as is pre.
//
// What bounds it: the chain. Step t - 1 needs every column of step t's
// dpre_z and dpre_o, so the floor is S times one step's latency: the
// elementwise terms, one exchange between the SMs that hold R, one barrier
// and the matvec (2 hd^2 MACs a head), as in the forward (slstm.cu). On an
// H100 (700 W) at xlstm-1.3b's shapes (4 heads of 512, 2048 steps) a step
// takes about 2.6 us on the tensor route, as the forward's step does, and
// 3.8-4.2 us streaming f32 R (scripts/torch_kernel_ablation.py --only
// scan_bwd).
//
// Design: the forward's plan turned around (kernels/slstm.py:bwd_plan, the
// forward's cluster and columns): a thread-block cluster per (head,
// batch), block j owning the columns J = [j cols, (j + 1) cols) of the
// elementwise terms and the same rows p in J of the matvec, so dh_{t-1}[J]
// lands where step t - 1 needs it and only dpre travels. Each step
//   * the column threads (a thread a column of J) form dpre_z, dpre_o, the
//     c and n carries and their warp's partials of the two head sums, and
//     write dpre_z[J], dpre_o[J] and the partials into every peer's shared
//     memory (distributed shared memory, double-buffered); one
//     barrier.cluster arrive/wait (release/acquire) ends the exchange;
//   * every block sums the cluster's partials in the same fixed order, so
//     all agree bitwise on the scalar routing through m and need no second
//     barrier, and forms dh_{t-1}[J] from its rows of R_z, R_o and the two
//     row sums (formed once in the prologue, as the forward forms rbar).
// Two routes, a plain function of (hd, R's dtype), as the forward's:
//   * tensor (bf16 R, hd <= 512, 32 columns a block at most): the block's
//     rows R_z[J, :] and R_o[J, :] stay in registers for the whole scan as
//     mma.sync m16n8k16 A fragments (16 warps = 2 row tiles x 8 warps over
//     the columns r, 2 pairs of k-steps and 2 gates a warp: 32 registers a
//     thread at hd 512). dpre_z and dpre_o travel as three bf16 terms each
//     (mma.cuh: splitn<3>, about f32's 2^-24) in one 16-byte row a column:
//     B's columns 0-2 are dpre_z's terms, 3-5 dpre_o's, so one ldmatrix
//     feeds both gates and R_z's product keeps columns 0-2, R_o's 3-5: the
//     sums are f32-accurate against the exact bf16 R. The 8 warps over r
//     meet in shared memory, summed in a fixed order: one __syncthreads.
//   * streaming (R in f32, or hd above 512, up to 4096): dpre travels in
//     f32; a warp a row of R_z[J] and R_o[J] (4 rows at once), lanes over r,
//     the block's slice read from L2 every step with f32 FMAs: 1/cluster of
//     the head's bytes, and two gates of four.
// The prologue: the head means of pre_i and pre_f of every step (steps
// dealt over the cluster's warps), the row sums of R_i[J] and R_f[J], a
// cluster barrier; then every column thread walks the steps forward,
// forming m alike and its column's c and n (8 steps' loads in flight at
// once), and another cluster barrier. Clusters are independent: when B nh
// is above the clusters that fit at once they run in waves. A launch the
// card refuses raises in the wrapper: a cluster it cannot place
// (cudaOccupancyMaxActiveClusters is 0, checked before the first launch of
// each plan) or a launch error. No atomics: a repeat is bitwise.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxHeadDim = 4096;
constexpr int kMaxCols = 256;                   // columns a block: 8 warps of column threads
constexpr int kTensorMaxHd = 512;               // the tensor route: 32 columns a block at most
constexpr int kKGroups = kWarps / 2;            // tensor route: 2 row tiles x 8 warps over r
constexpr int kPairs = kTensorMaxHd / 32 / kKGroups;  // pairs of k-steps a warp holds
constexpr int kSlots = kMaxCluster * kMaxCols / 32;   // head-sum partials a buffer holds
constexpr int kRowsAtOnce = 4;                  // streaming: rows of R a warp takes at once
constexpr int kAhead = 8;                       // prologue: steps' loads in flight at once
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// bytes of shared memory. tensor: the exchange's terms twice ([hr][8]
// bf16), the partial slots twice, the 8 warps' row sums over r, the row
// sums of R_i and R_f; streaming: dpre_z and dpre_o twice in f32, the
// partial slots twice, the matvec's rows, the row sums
__host__ __device__ constexpr int slstm_bwd_smem_bytes(int hd, int cols, int tensor) {
  return tensor ? 2 * cdiv(hd, 32) * 32 * 16 + 4 * (2 * kSlots * 2 + kKGroups * 32 + 2 * 32)
                : 4 * (2 * 2 * cdiv(hd, 32) * 32 + 2 * kSlots * 2 + 3 * cdiv(cols, 32) * 32);
}

struct Args {
  const float* pre;  // (B, S, 4, nh, hd) pre-activations
  const void* r;     // (4, nh, hd, hd): bf16 on the tensor route, else f32 or bf16
  const float* c0;   // (B, nh, hd) or null (then n0, m0 are null too)
  const float* n0;
  const float* m0;   // (B, nh)
  const float* dhs;  // (B, S, nh, hd)
  const float* dh;   // gradients of the final state, each null where unused
  const float* dc;
  const float* dn;
  const float* dm;
  float* dpre;       // (B, S, 4, nh, hd)
  float* dh0;        // gradients of the initial state, null without one
  float* dc0;
  float* dn0;
  float* dm0;
  float* cs;         // (B, nh, S, hd) c_t
  float* ns;         // (B, nh, S, hd) n_t
  float* gate;       // (B, nh, 3, S): i~, logsigmoid(f~), m_t
  int s, nh, hd, cluster, cols;
};

__device__ __forceinline__ float logsigmoid(float x) { return fminf(x, 0.f) - log1pf(expf(-fabsf(x))); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 4 consecutive values of a row of R (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// dpre_z's and dpre_o's three bf16 terms as one 16-byte row of B: columns
// 0-2 dpre_z's, 3-5 dpre_o's, 6-7 zero
__device__ __forceinline__ uint4 dpre_terms(float dz, float dov) {
  uint32_t t[3];
  splitn<3>(dz, dov, t);  // t[k]: dz's term k in the low half, do's in the high
  return make_uint4((t[0] & 0xffffu) | (t[1] << 16), (t[2] & 0xffffu) | (t[0] & 0xffff0000u),
                    (t[1] >> 16) | (t[2] & 0xffff0000u), 0u);
}

// The column's values of one step the reverse loop reads, loaded a step ahead
struct StepRegs {
  float dhs, pz, po, cp, np;  // dhs_t, pre_z, pre_o, c_{t-1}, n_{t-1}
  float it, lf, mt, mp;       // i~_t, logsigmoid(f~_t), m_t, m_{t-1}
};

template <bool kTensor, typename TR>
__global__ void __launch_bounds__(kThreads, 1) slstm_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.s, nh = a.nh, hd = a.hd, CL = a.cluster, cols = a.cols;
  const int rank = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / CL, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int hr = cdiv(hd, 32) * 32, cpad = cdiv(cols, 32) * 32, nw = cpad / 32;
  const int col0 = rank * cols, ncols = max(0, min(cols, hd - col0));
  const int64_t bh = static_cast<int64_t>(b) * nh + head;
  const int64_t D = static_cast<int64_t>(nh) * hd, row = 4 * D;  // row: one step of pre
  const int64_t gstride = D * hd;                                 // one gate of R
  const float* pre = a.pre + static_cast<int64_t>(b) * S * row + static_cast<int64_t>(head) * hd;
  float* dpre = a.dpre + static_cast<int64_t>(b) * S * row + static_cast<int64_t>(head) * hd;
  const float* dhs = a.dhs + static_cast<int64_t>(b) * S * D + static_cast<int64_t>(head) * hd;
  float* gi = a.gate + bh * 3 * S;  // i~
  float* gf = gi + S;                // logsigmoid(f~)
  float* gm = gf + S;                // m_t
  float* cs = a.cs + bh * S * hd;
  float* ns = a.ns + bh * S * hd;
  const TR* R = static_cast<const TR*>(a.r) + static_cast<int64_t>(head) * hd * hd;
  const float inv_hd = 1.f / hd;

  // shared memory (slstm_bwd_smem_bytes)
  bf16* ex = reinterpret_cast<bf16*>(smem);                      // tensor: [2][hr][8]
  float* exf = reinterpret_cast<float*>(smem);                   // streaming: [2][2][hr]
  float* slot = kTensor ? reinterpret_cast<float*>(ex + 2 * hr * 8) : exf + 4 * hr;  // [2][kSlots][2]
  float* part = slot + 2 * kSlots * 2;  // tensor: [kKGroups][32]; streaming: the rows' dh [cpad]
  float* rs = part + (kTensor ? kKGroups * 32 : cpad);  // [2][cpad]: rowsum(R_i), rowsum(R_f)

  for (int e = tid; e < (kTensor ? 2 * hr : hr); e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);

  // the head means of pre_i and pre_f, a warp a step, dealt over the cluster
  for (int t = warp + kWarps * rank; t < S; t += kWarps * CL) {
    float si = 0.f, sf = 0.f;
    for (int r = lane; r < hd; r += 32) {
      si += pre[t * row + D + r];
      sf += pre[t * row + 2 * D + r];
    }
    si = rt::warp_sum(si);
    sf = rt::warp_sum(sf);
    if (lane == 0) {
      gi[t] = si * inv_hd;
      gf[t] = logsigmoid(sf * inv_hd);
    }
  }
  // rowsum(R_i) and rowsum(R_f) over the block's rows, a warp a row
  for (int i = warp; i < cpad; i += kWarps) {
    float si = 0.f, sf = 0.f;
    if (i < ncols) {
      const TR* ri = R + gstride + static_cast<int64_t>(col0 + i) * hd;
      for (int r = lane; r < hd; r += 32) {
        si += rt::load_f32(ri + r);
        sf += rt::load_f32(ri + gstride + r);
      }
      si = rt::warp_sum(si);
      sf = rt::warp_sum(sf);
    }
    if (lane == 0) {
      rs[i] = si;
      rs[cpad + i] = sf;
    }
  }

  // tensor route: the block's rows of R_z and R_o as A fragments, warp =
  // (row tile mt, group kg over r), its pairs of k-steps kg and kg + kKGroups
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp / kKGroups, kg = warp % kKGroups, npairs = hr / 32;
  uint32_t af[2][2 * kPairs][4];
  if constexpr (kTensor) {
    const unsigned short* Rb = reinterpret_cast<const unsigned short*>(R);
    auto rv = [&](int gate, int m, int r) -> uint32_t {  // bits of R_gate[col0 + m][r]
      return (m < ncols && r < hd) ? Rb[gate * gstride + static_cast<int64_t>(col0 + m) * hd + r] : 0u;
    };
    const int m0 = mt * 16 + g, m1 = m0 + 8;
#pragma unroll
    for (int gt = 0; gt < 2; ++gt) {
      const int gate = gt ? 3 : 0;
#pragma unroll
      for (int u = 0; u < 2 * kPairs; ++u) {
        const int pp = kg + kKGroups * (u >> 1), k0 = pp * 32 + (u & 1) * 16 + 2 * t4;
        const bool in = pp < npairs;
        af[gt][u][0] = in ? rv(gate, m0, k0) | (rv(gate, m0, k0 + 1) << 16) : 0u;
        af[gt][u][1] = in ? rv(gate, m1, k0) | (rv(gate, m1, k0 + 1) << 16) : 0u;
        af[gt][u][2] = in ? rv(gate, m0, k0 + 8) | (rv(gate, m0, k0 + 9) << 16) : 0u;
        af[gt][u][3] = in ? rv(gate, m1, k0 + 8) | (rv(gate, m1, k0 + 9) << 16) : 0u;
      }
    }
  }
  cluster_barrier();  // the means are whole; the exchange buffers are zero

  // the forward's c, n and m, a thread a column of the block (m alike in
  // every column thread), kAhead steps' loads at once
  const bool colt = tid < cpad, mine = tid < ncols;
  const int r = col0 + tid;
  const float m_init = a.m0 ? a.m0[bh] : kNegInf;
  if (colt) {
    float c = (mine && a.c0) ? a.c0[bh * hd + r] : 0.f, n = (mine && a.n0) ? a.n0[bh * hd + r] : 0.f;
    float m = m_init;
    for (int t0 = 0; t0 < S; t0 += kAhead) {
      float it[kAhead], lf[kAhead], pz[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int t = t0 + u;
        it[u] = t < S ? __ldcg(gi + t) : 0.f;
        lf[u] = t < S ? __ldcg(gf + t) : 0.f;
        pz[u] = (mine && t < S) ? pre[t * row + r] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int t = t0 + u;
        if (t < S) {
          const float mt = fmaxf(lf[u] + m, it[u]);
          if (rank == 0 && tid == 0) gm[t] = mt;
          if (mine) {
            const float ip = expf(it[u] - mt), fp = expf(lf[u] + m - mt);
            c = fp * c + ip * tanhf(pz[u]);
            n = fp * n + ip;
            cs[static_cast<int64_t>(t) * hd + r] = c;
            ns[static_cast<int64_t>(t) * hd + r] = n;
          }
          m = mt;
        }
      }
    }
  }
  cluster_barrier();  // m_t is whole

  // the reverse loop
  float dcv = 0.f, dnv = 0.f, dhv = 0.f, dm = 0.f, ct = 0.f, nt = 0.f;
  StepRegs cur{}, nxt{};
  auto fetch = [&](int t, StepRegs& x) {  // step t's values; c_t, n_t are the step after's c_{t-1}
    x.it = __ldcg(gi + t);
    x.lf = __ldcg(gf + t);
    x.mt = __ldcg(gm + t);
    x.mp = t > 0 ? __ldcg(gm + t - 1) : m_init;
    if (mine) {
      x.dhs = dhs[static_cast<int64_t>(t) * D + r];
      x.pz = pre[t * row + r];
      x.po = pre[t * row + 3 * D + r];
      x.cp = t > 0 ? cs[static_cast<int64_t>(t - 1) * hd + r] : (a.c0 ? a.c0[bh * hd + r] : 0.f);
      x.np = t > 0 ? ns[static_cast<int64_t>(t - 1) * hd + r] : (a.n0 ? a.n0[bh * hd + r] : 0.f);
    }
  };
  if (colt) {
    if (mine) {
      dcv = a.dc ? a.dc[bh * hd + r] : 0.f;
      dnv = a.dn ? a.dn[bh * hd + r] : 0.f;
      dhv = a.dh ? a.dh[bh * hd + r] : 0.f;
      ct = cs[static_cast<int64_t>(S - 1) * hd + r];
      nt = ns[static_cast<int64_t>(S - 1) * hd + r];
    }
    dm = a.dm ? a.dm[bh] : 0.f;
    fetch(S - 1, cur);
  }
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(a.r) % 16 == 0;
  for (int t = S - 1; t >= 0; --t) {
    const int buf = t & 1;
    if (colt) {
      if (t > 0) fetch(t - 1, nxt);  // issued now, used a step later
      const float ip = expf(cur.it - cur.mt), fp = expf(cur.lf + cur.mp - cur.mt);
      float sa = 0.f, sb = 0.f, dpz = 0.f, dpo = 0.f;
      if (mine) {
        const float dht = cur.dhs + dhv;
        const float z = tanhf(cur.pz), o = sigmoid(cur.po);
        const float cl = fmaxf(nt, 1e-6f);
        const float dcn = dcv + dht * o / cl;
        const float dnn = dnv + (nt >= 1e-6f ? -dht * o * ct / (cl * cl) : 0.f);
        dpo = dht * ct / cl * o * (1.f - o);
        dpz = dcn * ip * (1.f - z * z);
        sa = (dcn * z + dnn) * ip;
        sb = (dcn * cur.cp + dnn * cur.np) * fp;
        dcv = dcn * fp;
        dnv = dnn * fp;
        dpre[t * row + r] = dpz;
        dpre[t * row + 3 * D + r] = dpo;
        if constexpr (kTensor) {
          const uint4 w = dpre_terms(dpz, dpo);
          for (int k = 0; k < CL; ++k)
            *reinterpret_cast<uint4*>(cluster.map_shared_rank(ex + buf * hr * 8, k) + r * 8) = w;
        } else {
          for (int k = 0; k < CL; ++k) {
            float* peer = cluster.map_shared_rank(exf + buf * 2 * hr, k);
            peer[r] = dpz;
            peer[hr + r] = dpo;
          }
        }
      }
      sa = rt::warp_sum(sa);
      sb = rt::warp_sum(sb);
      if (lane < CL)
        reinterpret_cast<float2*>(cluster.map_shared_rank(slot + buf * kSlots * 2, lane))[rank * nw + (tid >> 5)] =
            make_float2(sa, sb);
    }
    cluster_barrier();  // this step's dpre_z, dpre_o and partials are in every block

    // the head sums in slot order, then m's routing: every block alike
    float sc0 = 0.f, sc1 = 0.f;
    if (colt) {
      const float2* sl = reinterpret_cast<const float2*>(slot + buf * kSlots * 2);
      float sa = 0.f, sb = 0.f;
      for (int k = 0; k < CL * nw; ++k) {
        const float2 v = sl[k];
        sa += v.x;
        sb += v.y;
      }
      // i' = exp(i~ - m_t), f' = exp(lf + m_{t-1} - m_t), m_t = max(lf + m_{t-1}, i~)
      float di = sa, dlf = sb, dmp = sb;
      const float dmt = dm - sa - sb, x1 = cur.lf + cur.mp;
      if (x1 > cur.it) {
        dlf += dmt;
        dmp += dmt;
      } else if (cur.it > x1) {
        di += dmt;
      } else {
        dlf += 0.5f * dmt;
        dmp += 0.5f * dmt;
        di += 0.5f * dmt;
      }
      // lf = logsigmoid(f~): d lf / d f~ = sigmoid(-f~) = 1 - exp(lf)
      sc0 = di * inv_hd;
      sc1 = dlf * (1.f - expf(cur.lf)) * inv_hd;
      dm = dmp;
      if (mine) {
        dpre[t * row + D + r] = sc0;
        dpre[t * row + 2 * D + r] = sc1;
      }
    }

    // dh_{t-1} over the block's rows from R_z, R_o and this step's dpre
    if constexpr (kTensor) {
      float d1[2][4] = {}, d2[2][4] = {};  // R_z's, R_o's products, a chain a k-step of the pair
#pragma unroll
      for (int s = 0; s < kPairs; ++s) {
        const int pp = kg + kKGroups * s;
        if (pp < npairs) {
          uint32_t bfr[4];
          ldsm4t(bfr, ex + buf * hr * 8 + (pp * 32 + lane) * 8);
          mma(d1[0], af[0][2 * s], bfr[0], bfr[1]);
          mma(d1[1], af[0][2 * s + 1], bfr[2], bfr[3]);
          mma(d2[0], af[1][2 * s], bfr[0], bfr[1]);
          mma(d2[1], af[1][2 * s + 1], bfr[2], bfr[3]);
        }
      }
      // columns 0-2 of R_z's product and 3-5 of R_o's: lanes t4 0-2 hold them
      float z0[4], o0[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z0[e] = d1[0][e] + d1[1][e];
        o0[e] = d2[0][e] + d2[1][e];
      }
      float v0 = t4 == 0 ? z0[0] + z0[1] : t4 == 1 ? z0[0] + o0[1] : t4 == 2 ? o0[0] + o0[1] : 0.f;
      float v1 = t4 == 0 ? z0[2] + z0[3] : t4 == 1 ? z0[2] + o0[3] : t4 == 2 ? o0[2] + o0[3] : 0.f;
      v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
      v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
      if (t4 == 0) {
        part[kg * 32 + mt * 16 + g] = v0;
        part[kg * 32 + mt * 16 + g + 8] = v1;
      }
    } else {
      const float* dz = exf + buf * 2 * hr;
      for (int i0 = warp; i0 < ncols; i0 += kWarps * kRowsAtOnce) {
        float acc[kRowsAtOnce] = {};
#pragma unroll
        for (int gt = 0; gt < 2; ++gt) {
          const TR* rg = R + (gt ? 3 : 0) * gstride + static_cast<int64_t>(col0) * hd;
          const float* dg = dz + gt * hr;
          if (vec) {
            for (int q = lane; q < hd / 4; q += 32) {
              const float4 d = *reinterpret_cast<const float4*>(dg + 4 * q);
#pragma unroll
              for (int u = 0; u < kRowsAtOnce; ++u) {
                const int i = i0 + u * kWarps;
                if (i < ncols) {
                  const float4 x = load4(rg + static_cast<int64_t>(i) * hd + 4 * q);
                  acc[u] += x.x * d.x + x.y * d.y + x.z * d.z + x.w * d.w;
                }
              }
            }
          } else {
            for (int rr = lane; rr < hd; rr += 32) {
#pragma unroll
              for (int u = 0; u < kRowsAtOnce; ++u) {
                const int i = i0 + u * kWarps;
                if (i < ncols) acc[u] += rt::load_f32(rg + static_cast<int64_t>(i) * hd + rr) * dg[rr];
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) {
          const float v = rt::warp_sum(acc[u]);
          if (lane == 0 && i0 + u * kWarps < ncols) part[i0 + u * kWarps] = v;
        }
      }
    }
    __syncthreads();
    if (mine) {
      float v;
      if constexpr (kTensor) {
        v = 0.f;
#pragma unroll
        for (int k = 0; k < kKGroups; ++k) v += part[k * 32 + tid];
      } else {
        v = part[tid];
      }
      dhv = v + sc0 * rs[tid] + sc1 * rs[cpad + tid];
      ct = cur.cp;
      nt = cur.np;
    }
    if (colt && t > 0) cur = nxt;
  }
  if (mine) {
    if (a.dh0) a.dh0[bh * hd + r] = dhv;
    if (a.dc0) a.dc0[bh * hd + r] = dcv;
    if (a.dn0) a.dn0[bh * hd + r] = dnv;
  }
  if (rank == 0 && tid == 0 && a.dm0) a.dm0[bh] = dm;
}

using KernelFn = void (*)(Args);

KernelFn pick(int tensor, int r_bf16) {
  if (tensor) return slstm_bwd_kernel<true, bf16>;
  return r_bf16 ? slstm_bwd_kernel<false, bf16> : slstm_bwd_kernel<false, float>;
}

bool plan_ok(int hd, int cluster, int cols, int r_bf16, int tensor) {
  return hd >= 1 && hd <= kMaxHeadDim && cluster >= 1 && cluster <= kMaxCluster && cols >= 1 &&
         cols <= kMaxCols && cluster * cols >= hd && (cluster - 1) * cols < hd &&
         (!tensor || (r_bf16 && hd <= kTensorMaxHd && cols <= 32));
}

// a cluster of `cluster` blocks per (head, batch), non-portable above 8 blocks
cudaError_t configure(KernelFn kern, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int nh,
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

}  // namespace

// Bytes of shared memory a block of the backward plan takes.
extern "C" int rt_slstm_bwd_smem(int hd, int cols, int tensor) { return slstm_bwd_smem_bytes(hd, cols, tensor); }

// cudaOccupancyMaxActiveClusters for the backward plan (0: it cannot be
// placed), or minus a cudaError_t.
extern "C" int rt_slstm_bwd_max_clusters(int hd, int cluster, int cols, int r_bf16, int tensor) {
  if (!plan_ok(hd, cluster, cols, r_bf16, tensor)) return -static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kern = pick(tensor, r_bf16);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(kern, cfg, attr, cluster, 1, 1, slstm_bwd_smem_bytes(hd, cols, tensor), nullptr);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// pre packed (b, s, 4, nh, hd) f32; r packed (4, nh, hd, hd), bf16 (r_bf16)
// or f32; c0/n0/m0 null for the zero state; dh/dc/dn/dm each null where
// unused; dh0/dc0/dn0/dm0 null without a state; scratch f32 cs, ns (b, nh,
// s, hd) and gate (b, nh, 3, s). The plan (cluster, cols, tensor) is
// kernels/slstm.py:bwd_plan's; the wrapper has checked with
// rt_slstm_bwd_max_clusters that the card places its cluster.
extern "C" int rt_slstm_scan_bwd(const float* pre, const void* r, const float* c0, const float* n0,
                                 const float* m0, const float* dhs, const float* dh, const float* dc,
                                 const float* dn, const float* dm, float* dpre, float* dh0, float* dc0,
                                 float* dn0, float* dm0, float* cs, float* ns, float* gate, int b, int s,
                                 int nh, int hd, int cluster, int cols, int tensor, int r_bf16, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || !plan_ok(hd, cluster, cols, r_bf16, tensor)) return cudaErrorInvalidValue;
  const Args args{pre, r, c0, n0, m0, dhs, dh, dc, dn, dm, dpre, dh0, dc0, dn0, dm0, cs, ns, gate,
                  s, nh, hd, cluster, cols};
  const KernelFn kern = pick(tensor, r_bf16);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(kern, cfg, attr, cluster, nh, b, slstm_bwd_smem_bytes(hd, cols, tensor),
                            static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kern, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
