// K5 flash_attention: forward attention with an online softmax and an f32
// accumulator; causal and sliding-window masks; q heads share KV heads (GQA).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (pallas_call at :133). There the TPU walks the KV blocks as the innermost,
// sequential grid axis and carries (m, l, acc) in VMEM scratch; here one
// block owns (batch, q head, tile of kBQ query rows) and loops over the KV
// tiles itself, with (m, l, acc) in registers. The KV head of q head h is
// h / (H / KV), read in place: no repeated K/V is materialized.
//
// Bound by operations at the serving path's prompts (2 * 2 * hd per visible
// (q, k) pair; 34.4 GFLOP for a causal 2048-token prompt at 32 heads of
// 128). This first version uses plain f32 FMAs from shared memory, not the
// tensor cores: each thread holds a quarter of one query row's scores and
// output, K and V tiles are staged in shared memory as f32. Tiles past the
// causal frontier or before the window are skipped whole; inside a tile the
// mask is per element, as in the Pallas kernel (masked scores are -1e30,
// l is clamped at 1e-30, default scale hd^-0.5 is applied by the caller).
// Head dims 16, 32, 64, 80 (zamba2's shared block: HD / kRowLanes = 20
// columns per thread, 78.6 KB of shared memory) and 128; nothing assumes a
// power of two.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kRowLanes = 4;      // threads per query row
constexpr int kThreads = kBQ * kRowLanes;
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // element strides of q (B, Sq, H, hd); inner stride 1
  int64_t k_sb, k_ss, k_sh;  // k (B, Sk, KV, hd)
  int64_t v_sb, v_ss, v_sh;  // v (B, Sk, KV, hd)
  int64_t o_sb, o_ss, o_sh;  // o (B, Sq, H, hd)
  int sq, sk, h, kv;
  float scale;
  int causal;
  int window;  // 0 = full
};

template <int HD>
constexpr int flash_smem_floats() {
  return 2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int P = HD + 1;          // padded pitch: rows land on distinct banks
  constexpr int PP = kBK + 1;
  constexpr int NS = kBK / kRowLanes;  // scores per thread per tile
  constexpr int NA = HD / kRowLanes;   // output columns per thread
  float* qs = smem;                  // [kBQ][P], scaled query tile
  float* ks = qs + kBQ * P;          // [kBK][P]
  float* vs = ks + kBK * P;          // [kBK][HD]
  float* ps = vs + kBK * HD;         // [kBQ][PP], probabilities of the tile

  const int q_start = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (a.h / a.kv);
  const int tid = threadIdx.x;
  const int row = tid / kRowLanes;
  const int sub = tid % kRowLanes;
  const int q_pos = q_start + row;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + head * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int p = q_start + r;
    qs[r * P + d] = p < a.sq ? rt::load_f32(qb + p * a.q_ss + d) * a.scale : 0.0f;
  }

  // KV tiles this query tile can see: up to its last row (causal), from the
  // first key inside the window of its first row.
  int k_end = a.sk;
  if (a.causal) k_end = min(k_end, q_start + kBQ);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q_start - a.window + 1) / kBK * kBK;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int p = k0 + r;
      const bool in = p < a.sk;  // zero past Sk: masked, but 0 * v must stay finite
      ks[r * P + d] = in ? rt::load_f32(kb + p * a.k_ss + d) : 0.0f;
      vs[r * HD + d] = in ? rt::load_f32(vb + p * a.v_ss + d) : 0.0f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) s[c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[row * P + d];
#pragma unroll
      for (int c = 0; c < NS; ++c) s[c] = fmaf(qd, ks[(sub + kRowLanes * c) * P + d], s[c]);
    }

    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const int k_pos = k0 + sub + kRowLanes * c;
      bool ok = k_pos < a.sk;
      if (a.causal) ok = ok && k_pos <= q_pos;
      if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
      s[c] = ok ? s[c] : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    // the kRowLanes threads of a row are neighbouring lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float p = expf(s[c] - m_new);
      psum += p;
      ps[row * PP + sub + kRowLanes * c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities come from lanes of this warp

#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[row * PP + j];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(p, vs[j * HD + sub + kRowLanes * i], acc[i]);
    }
  }

  if (q_pos < a.sq) {
    const float lc = fmaxf(l, 1e-30f);
    T* ob = static_cast<T*>(a.o) + b * a.o_sb + q_pos * a.o_ss + head * a.o_sh;
#pragma unroll
    for (int i = 0; i < NA; ++i) rt::store_f32(ob + sub + kRowLanes * i, acc[i] / lc);
  }
}

template <typename T, int HD>
cudaError_t launch_flash(const FlashArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * flash_smem_floats<HD>();
  static bool attr_set = false;  // above 48 KB only after opting in, once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, batch);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const FlashArgs& a, int batch, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_flash<T, 16>(a, batch, stream);
    case 32: return launch_flash<T, 32>(a, batch, stream);
    case 64: return launch_flash<T, 64>(a, batch, stream);
    case 80: return launch_flash<T, 80>(a, batch, stream);
    case 128: return launch_flash<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 values, (batch, seq, head) element strides of q, k, v, o.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const int64_t* strides, int batch, int sq, int sk, int h,
                                  int kv, int hd, float scale, int causal, int window,
                                  int is_bf16, void* stream) {
  if (batch == 0 || sq == 0 || h == 0) return cudaSuccess;
  if (kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o,
              strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
              strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
              sq, sk, h, kv, scale, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(a, batch, hd, s) : dispatch_hd<float>(a, batch, hd, s);
}
