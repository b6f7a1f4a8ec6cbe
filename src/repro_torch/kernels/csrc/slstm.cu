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
// Design (the simplest right form): one block per (head, batch), a thread
// per column r (hd <= 1024 threads), h in shared memory. Each step a
// thread forms its column of the four gates' h R, reading R from global
// memory (the L2 holds it: 4 MiB a head in f32 at hd = 512), the block
// reduces the i and f columns for their head means (a shuffle tree per
// warp, then the warps' sums in order), and each thread updates its (c, n,
// h); two barriers a step. What bounds it: the card needs 4 hd^2 MACs a
// head and step (at xlstm-1.3b's 2048-token prefill, 4 heads of 512, 17
// GFLOP: 0.26 ms at the f32 rate, against 0.1 GB of xg, R and hs); this
// build streams all of R through one SM per (head, batch) every step, so
// it is bound by what one SM reads from L2, far above that. Spreading a
// head's columns over a cluster of blocks that exchange h through
// distributed shared memory is later work.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

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
  int s, nh, hd;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

template <typename T, typename TR>
__global__ void __launch_bounds__(kMaxThreads) slstm_scan_kernel(SlstmArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, nh = a.nh, S = a.s;
  float* hsh = smem;             // [hd]: h of the step before
  float* red = smem + hd;        // [2][warps]: the warps' sums of pre_i, pre_f
  const int head = blockIdx.x, b = blockIdx.y;
  const int r = threadIdx.x, warp = r >> 5, lane = r & 31;
  const int warps = (blockDim.x + 31) >> 5;
  const bool on = r < hd;
  const int bh = b * nh + head;
  const int64_t D = static_cast<int64_t>(nh) * hd;
  const int64_t gate = D * hd;  // elements between two gates' R
  const TR* R = static_cast<const TR*>(a.R) + static_cast<int64_t>(head) * hd * hd + r;
  const T* xg = static_cast<const T*>(a.xg) + static_cast<int64_t>(b) * S * 4 * D +
                static_cast<int64_t>(head) * hd + r;
  const int64_t st = static_cast<int64_t>(bh) * hd + r;

  float h = 0.0f, c = 0.0f, n = 0.0f;
  if (on && a.h0) {
    h = a.h0[st];
    c = a.c0[st];
    n = a.n0[st];
  }
  float m = a.m0 ? a.m0[bh] : -1e30f;
  if (on) hsh[r] = h;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = on ? rt::load_f32(xg + t * 4 * D + g * D) : 0.0f;
    if (on) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int p = 0; p < hd; ++p) {
        const float hp = hsh[p];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = fmaf(hp, rt::load_f32(R + g * gate + p * hd), acc[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] += acc[g];
    }
    float si = on ? pre[1] : 0.0f, sf = on ? pre[2] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      si += __shfl_xor_sync(0xffffffffu, si, o);
      sf += __shfl_xor_sync(0xffffffffu, sf, o);
    }
    if (lane == 0) {
      red[warp] = si;
      red[warps + warp] = sf;
    }
    __syncthreads();  // every thread has read h and written its warp's sums
    float it = 0.0f, ft = 0.0f;
    for (int w = 0; w < warps; ++w) {
      it += red[w];
      ft += red[warps + w];
    }
    it /= static_cast<float>(hd);
    ft /= static_cast<float>(hd);
    const float logf_ = log_sigmoid(ft);
    const float mnew = fmaxf(logf_ + m, it);
    const float ip = expf(it - mnew), fp = expf(logf_ + m - mnew);
    m = mnew;
    if (on) {
      const float z = tanhf(pre[0]);
      const float o = 1.0f / (1.0f + expf(-pre[3]));
      c = fp * c + ip * z;
      n = fp * n + ip;
      h = o * c / fmaxf(n, 1e-6f);
      hsh[r] = h;
      a.hs[(static_cast<int64_t>(b) * S + t) * D + static_cast<int64_t>(head) * hd + r] = h;
    }
    __syncthreads();  // the new h is whole, the sums read
  }
  if (on) {
    a.h[st] = h;
    a.c[st] = c;
    a.n[st] = n;
  }
  if (r == 0) a.m[bh] = m;
}

template <typename T, typename TR>
int launch(const SlstmArgs& args, int batch, cudaStream_t st) {
  const int threads = (args.hd + 31) / 32 * 32;
  const int smem = static_cast<int>(sizeof(float)) * (args.hd + 2 * (threads / 32));
  slstm_scan_kernel<T, TR><<<dim3(args.nh, batch), threads, smem, st>>>(args);
  return cudaGetLastError();
}

}  // namespace

// xg packed (batch, s, 4 nh hd), f32 (xg_bf16 = 0) or bf16; R packed (4,
// nh, hd, hd), f32 (r_bf16 = 0) or bf16; h0/c0/n0/m0 null for the zero state.
extern "C" int rt_slstm_scan(const void* xg, const void* R, const float* h0, const float* c0,
                             const float* n0, const float* m0, float* hs, float* h, float* c,
                             float* n, float* m, int batch, int s, int nh, int hd, int xg_bf16,
                             int r_bf16, void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (s < 0 || hd < 1 || hd > kMaxThreads) return cudaErrorInvalidValue;
  const SlstmArgs args{xg, R, h0, c0, n0, m0, hs, h, c, n, m, s, nh, hd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xg_bf16)
    return r_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(args, batch, st)
                  : launch<__nv_bfloat16, float>(args, batch, st);
  return r_bf16 ? launch<float, __nv_bfloat16>(args, batch, st) : launch<float, float>(args, batch, st);
}
