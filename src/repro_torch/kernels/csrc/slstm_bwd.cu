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
// dpre_t, elementwise but for the head sums of i' and f' terms (i and f are
// head means, so their gradient spreads over every column), and then
//   dh_{t-1} = sum_g dpre_{t,g} R_g^T,
// the forward's matvec chain run backwards. m's max splits a tie's gradient
// in two, as autograd does; the clamp passes it where n_t >= 1e-6.
// dR = sum_t h_{t-1}^T dpre_t is one plain product of what this kernel
// writes, left to the host.
//
// What bounds it: the chain. Each step's matvec needs the step before it,
// 4 hd^2 FMAs a (head, batch) on one block, R (4 hd^2 values) read from L2
// every step.
//
// Design (a simple first version): one block of kThreads threads per
// (head, batch), one launch. First the forward's state is recomputed from
// pre: the head means by a warp per step, m's scalar recurrence by one
// thread, c and n by a thread per column (no barrier inside the time loop).
// Then the reverse loop: a thread per column forms the elementwise terms,
// a fixed tree sums the head's two scalars, and a warp per row of R^T forms
// dh_{t-1} (lanes over R's contiguous columns, 16 bytes a load where hd
// allows, kRowsAtOnce rows' loads in flight together, one shuffle tree a
// row). R is read in f32: the host takes a bf16 R to f32 for the
// pre-activations' product anyway, and this loop ran faster on f32 rows
// than on bf16 ones unpacked in registers when both were tried on an H100.
// No atomics: a repeat is bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 2;  // columns a thread owns: hd up to kThreads * kCols
constexpr int kRowsAtOnce = 4;  // rows of R^T a warp of the matvec takes at once
constexpr float kNegInf = -1e30f;

// 4 values of a row of R against as many of dpre in shared memory, in order
__device__ __forceinline__ float dot4(const float* r, const float* d) {
  const float4 x = *reinterpret_cast<const float4*>(r);
  const float4 y = *reinterpret_cast<const float4*>(d);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float logsigmoid(float x) { return fminf(x, 0.f) - log1pf(expf(-fabsf(x))); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

struct Args {
  const float* pre;   // (B, S, 4, nh, hd) pre-activations
  const float* r;     // (4, nh, hd, hd), f32 (a bf16 R is taken to f32 by the host)
  const float* h0;    // (B, nh, hd) or null (then c0, n0, m0 are null too)
  const float* c0;
  const float* n0;
  const float* m0;    // (B, nh)
  const float* dhs;   // (B, S, nh, hd)
  const float* dh;    // gradients of the final state, each null where unused
  const float* dc;
  const float* dn;
  const float* dm;
  float* dpre;        // (B, S, 4, nh, hd)
  float* dh0;         // gradients of the initial state, null without one
  float* dc0;
  float* dn0;
  float* dm0;
  float* cs;          // (B, nh, S, hd) c_t
  float* ns;          // (B, nh, S, hd) n_t
  float* gate;        // (B, nh, S, 3): i~, logsigmoid(f~), m_t
  int b, s, nh, hd;
};

// Sum over the block (a fixed tree); every thread gets the total.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__global__ void __launch_bounds__(kThreads) slstm_bwd(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.s, nh = a.nh, hd = a.hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) float smem[];
  float* dpg = smem;              // (4, hd) this step's dpre (16-byte aligned rows where vec)
  float* dhp = dpg + 4 * hd;      // (hd) dh_{t-1} from the matvec
  float* red = dhp + hd;          // kWarps partials, twice
  float* sc = red + 2 * kWarps;   // scalars: the gradients of i~ and f~ / hd
  const int64_t bh = (int64_t)b * nh + h;
  const int64_t row = (int64_t)4 * nh * hd;  // one step of pre
  const float* pre = a.pre + (int64_t)b * S * row + (int64_t)h * hd;
  float* dpre = a.dpre + (int64_t)b * S * row + (int64_t)h * hd;
  float* gate = a.gate + bh * S * 3;
  float* cs = a.cs + bh * S * hd;
  float* ns = a.ns + bh * S * hd;
  const float* R = a.r + (int64_t)h * hd * hd;
  const int64_t gstride = (int64_t)nh * hd * hd;  // one gate of R
  const float inv_hd = 1.f / hd;
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(a.r) % 16 == 0;  // float4 loads

  // the head means of the i and f pre-activations, a warp per step
  for (int t = warp; t < S; t += kWarps) {
    float si = 0.f, sf = 0.f;
    for (int r = lane; r < hd; r += 32) {
      si += pre[t * row + 1 * nh * hd + r];
      sf += pre[t * row + 2 * nh * hd + r];
    }
    si = warp_sum(si);
    sf = warp_sum(sf);
    if (lane == 0) {
      gate[t * 3 + 0] = si * inv_hd;
      gate[t * 3 + 1] = logsigmoid(sf * inv_hd);
    }
  }
  __syncthreads();
  const float m_init = a.m0 ? a.m0[bh] : kNegInf;
  if (tid == 0) {
    float m = m_init;
    for (int t = 0; t < S; ++t) {
      m = fmaxf(gate[t * 3 + 1] + m, gate[t * 3 + 0]);
      gate[t * 3 + 2] = m;
    }
  }
  __syncthreads();
  // c and n forward, a thread per column
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int r = tid + k * kThreads;
    if (r < hd) {
      float c = a.c0 ? a.c0[bh * hd + r] : 0.f, n = a.n0 ? a.n0[bh * hd + r] : 0.f, mp = m_init;
      for (int t = 0; t < S; ++t) {
        const float mt = gate[t * 3 + 2];
        const float ip = expf(gate[t * 3 + 0] - mt), fp = expf(gate[t * 3 + 1] + mp - mt);
        c = fp * c + ip * tanhf(pre[t * row + r]);
        n = fp * n + ip;
        cs[(int64_t)t * hd + r] = c;
        ns[(int64_t)t * hd + r] = n;
        mp = mt;
      }
    }
  }
  // the reverse loop
  float dcv[kCols], dnv[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int r = tid + k * kThreads;
    dcv[k] = (r < hd && a.dc) ? a.dc[bh * hd + r] : 0.f;
    dnv[k] = (r < hd && a.dn) ? a.dn[bh * hd + r] : 0.f;
    if (r < hd) dhp[r] = a.dh ? a.dh[bh * hd + r] : 0.f;
  }
  float dm = a.dm ? a.dm[bh] : 0.f;  // thread 0's: the gradient of m_t
  __syncthreads();
  for (int t = S - 1; t >= 0; --t) {
    const float mt = gate[t * 3 + 2], mp = t > 0 ? gate[(t - 1) * 3 + 2] : m_init;
    const float it = gate[t * 3 + 0], lf = gate[t * 3 + 1];
    const float ip = expf(it - mt), fp = expf(lf + mp - mt);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int r = tid + k * kThreads;
      if (r < hd) {
        const float dht = a.dhs[(((int64_t)b * S + t) * nh + h) * hd + r] + dhp[r];
        const float z = tanhf(pre[t * row + r]);
        const float o = sigmoid(pre[t * row + 3 * nh * hd + r]);
        const float ct = cs[(int64_t)t * hd + r], nt = ns[(int64_t)t * hd + r];
        const float cp = t > 0 ? cs[(int64_t)(t - 1) * hd + r] : (a.c0 ? a.c0[bh * hd + r] : 0.f);
        const float np = t > 0 ? ns[(int64_t)(t - 1) * hd + r] : (a.n0 ? a.n0[bh * hd + r] : 0.f);
        const float cl = fmaxf(nt, 1e-6f);
        const float dcn = dcv[k] + dht * o / cl;
        const float dnn = dnv[k] + (nt >= 1e-6f ? -dht * o * ct / (cl * cl) : 0.f);
        const float dpo = dht * ct / cl * o * (1.f - o);
        const float dpz = dcn * ip * (1.f - z * z);
        sa += (dcn * z + dnn) * ip;
        sb += (dcn * cp + dnn * np) * fp;
        dcv[k] = dcn * fp;
        dnv[k] = dnn * fp;
        dpre[t * row + r] = dpz;
        dpre[t * row + 3 * nh * hd + r] = dpo;
        dpg[r] = dpz;
        dpg[3 * hd + r] = dpo;
      }
    }
    sa = block_sum(sa, red);
    sb = block_sum(sb, red + kWarps);
    if (tid == 0) {
      // i' = exp(i~ - m_t), f' = exp(lf + m_{t-1} - m_t), m_t = max(lf + m_{t-1}, i~)
      float di = sa, dlf = sb, dmp = sb, dmt = dm - sa - sb;
      const float x1 = lf + mp;
      if (x1 > it) {
        dlf += dmt;
        dmp += dmt;
      } else if (it > x1) {
        di += dmt;
      } else {
        dlf += 0.5f * dmt;
        dmp += 0.5f * dmt;
        di += 0.5f * dmt;
      }
      // lf = logsigmoid(f~): d lf / d f~ = sigmoid(-f~) = 1 - exp(lf)
      sc[0] = di * inv_hd;
      sc[1] = dlf * (1.f - expf(lf)) * inv_hd;
      dm = dmp;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int r = tid + k * kThreads;
      if (r < hd) {
        dpre[t * row + 1 * nh * hd + r] = sc[0];
        dpre[t * row + 2 * nh * hd + r] = sc[1];
        dpg[hd + r] = sc[0];
        dpg[2 * hd + r] = sc[1];
      }
    }
    __syncthreads();
    // dh_{t-1}[p] = sum_g sum_r R[g, h, p, r] dpre_g[r]: a warp takes kRowsAtOnce
    // rows p at once (their loads in flight together), lanes over r, 16
    // bytes of R a load where the rows allow it, then a shuffle tree a row
    for (int p0 = warp; p0 < hd; p0 += kWarps * kRowsAtOnce) {
      float acc[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) acc[u] = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* rg = R + g * gstride;
        const float* dg = dpg + g * hd;
        if (vec) {
          for (int q = lane; q < hd / 4; q += 32) {
#pragma unroll
            for (int u = 0; u < kRowsAtOnce; ++u) {
              const int p = p0 + u * kWarps;
              if (p < hd) acc[u] += dot4(rg + (int64_t)p * hd + 4 * q, dg + 4 * q);
            }
          }
        } else {
          for (int r = lane; r < hd; r += 32) {
#pragma unroll
            for (int u = 0; u < kRowsAtOnce; ++u) {
              const int p = p0 + u * kWarps;
              if (p < hd) acc[u] += rg[(int64_t)p * hd + r] * dg[r];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        const float v = warp_sum(acc[u]);
        if (lane == 0 && p0 + u * kWarps < hd) dhp[p0 + u * kWarps] = v;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int r = tid + k * kThreads;
    if (r < hd) {
      if (a.dh0) a.dh0[bh * hd + r] = dhp[r];
      if (a.dc0) a.dc0[bh * hd + r] = dcv[k];
      if (a.dn0) a.dn0[bh * hd + r] = dnv[k];
    }
  }
  if (tid == 0 && a.dm0) a.dm0[bh] = dm;
}

__host__ __device__ inline int smem_bytes(int hd) { return 4 * (5 * hd + 2 * kWarps + 2); }

}  // namespace

extern "C" int rt_slstm_scan_bwd(const float* pre, const float* r, const float* h0, const float* c0,
                                 const float* n0, const float* m0, const float* dhs, const float* dh,
                                 const float* dc, const float* dn, const float* dm, float* dpre,
                                 float* dh0, float* dc0, float* dn0, float* dm0, float* cs, float* ns,
                                 float* gate, int b, int s, int nh, int hd, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || hd < 1 || hd > kThreads * kCols) return cudaErrorInvalidValue;
  const Args a{pre, r, h0, c0, n0, m0, dhs, dh, dc, dn, dm, dpre, dh0, dc0, dn0, dm0, cs, ns, gate,
               b, s, nh, hd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = smem_bytes(hd);
  cudaFuncSetAttribute(slstm_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  slstm_bwd<<<dim3(nh, b), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}
