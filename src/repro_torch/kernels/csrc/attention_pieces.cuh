// The head-dim-in-pieces attention kernel of K5 and K6 for head dims above
// 192 (any head dim), f32 and bf16 inputs.
//
// Replaces, for those head dims, the Pallas kernels
// repro/kernels/flash_attention.py:flash_attention (pallas_call at :133) and
// repro/kernels/decode_attention.py:decode_attention (:111), which pad hd to
// the 128-lane tile and take any hd. The built kernels (flash_fwd_wg,
// flash_fwd_simt, decode_split) hold a row of q and O in registers, so
// their head dims are fixed at compile time and end at 192. This kernel
// keeps nothing of a row in registers:
//   * a block owns `rows` query rows that share one KV head: for K5, rows
//     consecutive positions of one q head; for K6, the q heads of one KV
//     head at the one query position;
//   * per tile of 64 keys, the scores S = q.k^T are summed over the head dim
//     in pieces of 64 columns (q piece and K piece staged in shared memory,
//     the partial scores accumulated in shared memory);
//   * the online softmax (running max m and sum l per row, in shared
//     memory) turns S into probabilities;
//   * O, `rows` x hd floats in shared memory, is rescaled and accumulated
//     piece by piece: each V piece is staged and every (row, column) of the
//     piece adds p . v.
// All in f32 FMAs; the output is O / max(l, 1e-30), stored in the input
// dtype. Masked scores are -inf, so a row that sees no key gets zeros, as
// in the built kernels. The host picks `rows` (32, halved until the block's
// shared memory fits: rt_attention_pieces_rows).
//
// Bound: K5 by operations (4 hd per visible (q, k) pair), K6 by bytes (K and
// V read once). This kernel issues f32 FMAs from shared memory and re-reads
// each q piece once per key tile: a simple, correct route, not a fast one.
#pragma once

#include "common.cuh"

namespace pieces {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;  // keys per tile
constexpr int kDP = 64;  // head-dim columns per piece
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // element strides of q (B, Sq, H, hd); inner stride 1
  int64_t k_sb, k_ss, k_sh;  // k (B, Sk, KV, hd)
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // o (B, Sq, H, hd)
  int sq, sk, h, kv, hd;
  float scale;
  int causal, window;  // K5: causal mask, window (0 = full)
  int lo, hi;          // K6: valid positions [lo, hi)
  int groups;          // K6: q heads per KV head
  int rows;            // query rows per block
};

__host__ __device__ inline int smem_floats(int rows, int hd) {
  return rows * (kDP + 1)     // q piece
         + kBK * (kDP + 1)    // K piece, then V piece
         + rows * (kBK + 1)   // scores, then probabilities
         + rows * hd          // O
         + 3 * rows;          // m, l, the tile's correction
}

// Rows per block: 32, halved until the block fits; 0 if one row does not.
inline int rows_for(int hd) {
  int rows = 32;
  while (rows > 0 && static_cast<int64_t>(sizeof(float)) * smem_floats(rows, hd) > kMaxSmem)
    rows /= 2;
  return rows;
}

// kDecode: K6 (rows are q heads of KV head blockIdx.y); else K5 (rows are
// positions of q head blockIdx.y).
template <typename T, bool kDecode>
__global__ void __launch_bounds__(kThreads) attention_pieces(Args a) {
  extern __shared__ float smem[];
  const int R = a.rows, HD = a.hd;
  constexpr int QP = kDP + 1, SP = kBK + 1;
  float* qs = smem;              // [R][QP]
  float* kvs = qs + R * QP;      // [kBK][QP]: a K piece, then a V piece
  float* ss = kvs + kBK * QP;    // [R][SP]
  float* os = ss + R * SP;       // [R][HD]
  float* ms = os + R * HD;       // [R]
  float* ls = ms + R;            // [R]
  float* cs = ls + R;            // [R]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * R;
  const int kvh = kDecode ? blockIdx.y : blockIdx.y / (a.h / a.kv);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // row r of the block: its q and o offsets (in elements), its query
  // position (K5) and whether it exists
  auto row_valid = [&](int r) { return kDecode ? r0 + r < a.groups : r0 + r < a.sq; };
  auto q_off = [&](int r) -> int64_t {
    return kDecode ? b * a.q_sb + static_cast<int64_t>(kvh * a.groups + r0 + r) * a.q_sh
                   : b * a.q_sb + static_cast<int64_t>(r0 + r) * a.q_ss + blockIdx.y * a.q_sh;
  };
  auto o_off = [&](int r) -> int64_t {
    return kDecode ? b * a.o_sb + static_cast<int64_t>(kvh * a.groups + r0 + r) * a.o_sh
                   : b * a.o_sb + static_cast<int64_t>(r0 + r) * a.o_ss + blockIdx.y * a.o_sh;
  };
  auto visible = [&](int r, int key) {
    if (kDecode) return key >= a.lo && key < a.hi;
    const int q_pos = r0 + r;
    bool ok = key < a.sk;
    if (a.causal) ok = ok && key <= q_pos;
    if (a.window > 0) ok = ok && key > q_pos - a.window;
    return ok;
  };

  // the keys any row of the block can see
  int k_begin, k_end;
  if (kDecode) {
    k_begin = a.lo / kBK * kBK;
    k_end = a.hi;
  } else {
    k_end = a.causal ? min(a.sk, r0 + R) : a.sk;
    k_begin = a.window > 0 ? max(0, r0 - a.window + 1) / kBK * kBK : 0;
  }

  for (int i = tid; i < R * HD; i += kThreads) os[i] = 0.0f;
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.0f;
  }
  const T* qbase = static_cast<const T*>(a.q);
  T* obase = static_cast<T*>(a.o);
  const float kInf = __int_as_float(0x7f800000);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < R * kBK; i += kThreads) ss[(i / kBK) * SP + i % kBK] = 0.0f;
    // S = q . k^T, summed over the head dim piece by piece
    for (int d0 = 0; d0 < HD; d0 += kDP) {
      const int dp = min(kDP, HD - d0);
      __syncthreads();  // the previous piece is consumed
      for (int i = tid; i < R * dp; i += kThreads) {
        const int r = i / dp, d = i % dp;
        qs[r * QP + d] =
            row_valid(r) ? rt::load_f32(qbase + q_off(r) + d0 + d) * a.scale : 0.0f;
      }
      for (int i = tid; i < kBK * dp; i += kThreads) {
        const int c = i / dp, d = i % dp;
        const int key = k0 + c;
        kvs[c * QP + d] = key < k_end ? rt::load_f32(kb + key * a.k_ss + d0 + d) : 0.0f;
      }
      __syncthreads();
      for (int i = tid; i < R * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        float acc = 0.0f;
        for (int d = 0; d < dp; ++d) acc = fmaf(qs[r * QP + d], kvs[c * QP + d], acc);
        ss[r * SP + c] += acc;
      }
    }
    __syncthreads();
    // online softmax: a warp per row, two keys a lane
    for (int r = warp; r < R; r += kWarps) {
      float s[kBK / 32];
      float mx = -kInf;
#pragma unroll
      for (int u = 0; u < kBK / 32; ++u) {
        const int c = lane + 32 * u;
        s[u] = visible(r, k0 + c) ? ss[r * SP + c] : -kInf;
        mx = fmaxf(mx, s[u]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(ms[r], mx);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kBK / 32; ++u) {
        const float p = expf(s[u] - m_new);
        ss[r * SP + lane + 32 * u] = p;
        psum += p;
      }
      psum = rt::warp_sum(psum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(ms[r] - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + psum;
        ms[r] = m_new;
      }
    }
    // O = O * corr + P . V, piece by piece
    for (int d0 = 0; d0 < HD; d0 += kDP) {
      const int dp = min(kDP, HD - d0);
      __syncthreads();  // probabilities written; the previous V piece consumed
      for (int i = tid; i < kBK * dp; i += kThreads) {
        const int c = i / dp, d = i % dp;
        const int key = k0 + c;
        // zero past the block's keys: masked (p = 0), but 0 * v must stay finite
        kvs[c * QP + d] = key < k_end ? rt::load_f32(vb + key * a.v_ss + d0 + d) : 0.0f;
      }
      __syncthreads();
      for (int i = tid; i < R * dp; i += kThreads) {
        const int r = i / dp, d = i % dp;
        float acc = os[r * HD + d0 + d] * cs[r];
        for (int c = 0; c < kBK; ++c) acc = fmaf(ss[r * SP + c], kvs[c * QP + d], acc);
        os[r * HD + d0 + d] = acc;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    if (row_valid(r)) rt::store_f32(obase + o_off(r) + d, os[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T, bool kDecode>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(a.rows, a.hd);
  // above 48 KB only after opting in; the attribute belongs to the current
  // device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(attention_pieces<T, kDecode>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attention_pieces<T, kDecode><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pieces
