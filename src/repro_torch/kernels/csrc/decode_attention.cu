// K6 decode_attention: one query token per sequence against a KV cache of
// (B, S, KV, hd), scalar cache_len, optional window, GQA native.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:
// decode_attention (pallas_call at :111). As there, the G = H / KV q heads
// of one KV head are processed against one cache tile, so each cache
// element is read once. The TPU walks the cache tiles as a sequential grid
// axis; here that walk is split across blocks (flash-decoding): block
// (b * KV + kv head, split) runs the online softmax over its own range of
// positions and writes (m, l, acc) per q head; a second kernel merges the
// splits. At batch 1 and 8 KV heads one block per KV head would leave 124 of
// 132 SMs idle; the wrapper picks the split count from the SM count.
//
// Bound by bytes: 2 * cache_len * KV * hd * elem (the valid K and V read
// once). Valid positions are [max(0, cache_len - window), cache_len) (all
// below cache_len with no window). Every tile a block visits holds at
// least one valid position, so its running max is finite; masked scores
// are -1e30, l is clamped at 1e-30, and cache_len = 0 gives a zero row.
// Head dims 16, 32, 64, 80 (zamba2's shared block: 42 KB per split block
// at G = 1, HD = 80 threads in the combine pass) and 128.
#include "common.cuh"

namespace {

constexpr int kBS = 64;        // cache positions per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  float* part_acc;  // [B*KV][splits][G][hd]
  float* part_ml;   // [B*KV][splits][G][2]: running max, sum
  int64_t q_sb, q_sh;        // q (B, 1, H, hd): batch and head strides
  int64_t k_sb, k_ss, k_sh;  // k cache (B, S, KV, hd)
  int64_t v_sb, v_ss, v_sh;
  int kv, groups;
  int lo, hi;    // valid positions [lo, hi)
  int base;      // lo rounded down to a tile
  int chunk;     // positions per split, a multiple of kBS
  int splits;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
__host__ __device__ constexpr int decode_smem_floats(int g) {
  return 2 * g * HD + kBS * (HD + 1) + kBS * HD + g * kBS + 3 * g;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_split(DecodeArgs a) {
  extern __shared__ float smem[];
  constexpr int P = HD + 1;
  const int G = a.groups;
  float* qs = smem;             // [G][HD], scaled
  float* ks = qs + G * HD;      // [kBS][P]
  float* vs = ks + kBS * P;     // [kBS][HD]
  float* ss = vs + kBS * HD;    // [G][kBS]: scores, then probabilities
  float* accs = ss + G * kBS;   // [G][HD]
  float* ms = accs + G * HD;    // [G]
  float* ls = ms + G;           // [G]
  float* cs = ls + G;           // [G]: correction of the current tile

  const int bkv = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bkv / a.kv, kvh = bkv % a.kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    qs[i] = rt::load_f32(qb + (kvh * G + g) * a.q_sh + d) * a.scale;  // head kvh * G + g
    accs[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }

  const int begin = a.base + split * a.chunk;
  const int end = min(a.hi, begin + a.chunk);
  for (int t0 = begin; t0 < end; t0 += kBS) {
    __syncthreads();
    for (int i = tid; i < kBS * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int p = t0 + r;
      const bool in = p < a.hi;
      ks[r * P + d] = in ? rt::load_f32(kb + p * a.k_ss + d) : 0.0f;
      vs[r * HD + d] = in ? rt::load_f32(vb + p * a.v_ss + d) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < G * kBS; i += kThreads) {
      const int g = i / kBS, j = i % kBS;
      const int p = t0 + j;
      float s = kNegInf;
      if (p >= a.lo && p < a.hi) {
        s = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s = fmaf(qs[g * HD + d], ks[j * P + d], s);
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = ss[g * kBS + lane], s1 = ss[g * kBS + lane + 32];
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ss[g * kBS + lane] = p0;
      ss[g * kBS + lane + 32] = p1;
      const float psum = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        ls[g] = ls[g] * corr + psum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float acc = accs[i] * cs[g];
#pragma unroll 8
      for (int j = 0; j < kBS; ++j) acc = fmaf(ss[g * kBS + j], vs[j * HD + d], acc);
      accs[i] = acc;
    }
  }
  __syncthreads();
  const int64_t slot = static_cast<int64_t>(bkv) * a.splits + split;
  for (int i = tid; i < G * HD; i += kThreads) a.part_acc[slot * G * HD + i] = accs[i];
  for (int g = tid; g < G; g += kThreads) {
    a.part_ml[(slot * G + g) * 2] = ms[g];
    a.part_ml[(slot * G + g) * 2 + 1] = ls[g];
  }
}

// One block per (b * KV + kv head, g), one thread per output column.
template <typename T>
__global__ void decode_combine(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml, T* __restrict__ out,
                               int64_t o_sb, int64_t o_sh, int kv, int groups, int hd,
                               int splits) {
  const int bkv = blockIdx.x / groups, g = blockIdx.x % groups;
  const int b = bkv / kv, kvh = bkv % kv;
  const int d = threadIdx.x;
  const int64_t first = static_cast<int64_t>(bkv) * splits;
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[((first + s) * groups + g) * 2]);
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const int64_t slot = (first + s) * groups + g;
    const float w = expf(part_ml[slot * 2] - m);
    l += part_ml[slot * 2 + 1] * w;
    acc += part_acc[slot * hd + d] * w;
  }
  rt::store_f32(out + b * o_sb + (kvh * groups + g) * o_sh + d, acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch_decode(const DecodeArgs& a, T* out, int64_t o_sb, int64_t o_sh, int batch,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * decode_smem_floats<HD>(a.groups);
  // above 48 KB only after opting in; raise the limit as larger groups come
  static size_t attr_bytes = 0;
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  const dim3 grid(batch * a.kv, a.splits);
  decode_split<T, HD><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine<T><<<batch * a.kv * a.groups, HD, 0, stream>>>(
      a.part_acc, a.part_ml, out, o_sb, o_sh, a.kv, a.groups, HD, a.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const DecodeArgs& a, void* out, int64_t o_sb, int64_t o_sh, int batch,
                        int hd, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  switch (hd) {
    case 16: return launch_decode<T, 16>(a, o, o_sb, o_sh, batch, stream);
    case 32: return launch_decode<T, 32>(a, o, o_sb, o_sh, batch, stream);
    case 64: return launch_decode<T, 64>(a, o, o_sb, o_sh, batch, stream);
    case 80: return launch_decode<T, 80>(a, o, o_sb, o_sh, batch, stream);
    case 128: return launch_decode<T, 128>(a, o, o_sb, o_sh, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one split block takes for `groups` q heads per KV head.
extern "C" int rt_decode_attention_smem(int groups, int hd) {
  switch (hd) {
    case 16: return sizeof(float) * decode_smem_floats<16>(groups);
    case 32: return sizeof(float) * decode_smem_floats<32>(groups);
    case 64: return sizeof(float) * decode_smem_floats<64>(groups);
    case 80: return sizeof(float) * decode_smem_floats<80>(groups);
    case 128: return sizeof(float) * decode_smem_floats<128>(groups);
    default: return -1;
  }
}

// strides: 10 int64 values: q (batch, head), k (batch, seq, head),
// v (batch, seq, head), o (batch, head).
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   float* part_acc, float* part_ml, const int64_t* strides,
                                   int batch, int kv, int groups, int hd, int lo, int hi,
                                   int chunk, int splits, float scale, int is_bf16,
                                   void* stream) {
  if (batch == 0 || kv == 0 || groups == 0) return cudaSuccess;
  if (splits < 1 || chunk % kBS != 0) return cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, part_acc, part_ml,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7],
               kv, groups, lo, hi, lo / kBS * kBS, chunk, splits, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(a, o, strides[8], strides[9], batch, hd, s)
                 : dispatch_hd<float>(a, o, strides[8], strides[9], batch, hd, s);
}
