// mlstm_scan: the chunked mLSTM scan (xLSTM's matrix-memory cell).
//
// Replaces no Pallas kernel: the reference computes this scan in jnp under
// jax.named_scope("kernel_mlstm_scan") (repro/models/xlstm.py:54-135,
// `mlstm_chunked`), a lax.scan over chunks that XLA lowers. The port's
// plain version is kernels/ref.py:mlstm_scan_ref. Per chunk of L positions
// of one (batch, head), with P the key/value width, log f = log sigmoid(f~),
// cumf its inclusive cumsum over the chunk, src_j = i~_j - cumf_j and the
// stabilizer m' = max(m, max_j src_j):
//   W_ij    = exp(cumf_i + src_j - m') (q_i . k_j) / sqrt(P)       (j <= i)
//   carry_i = exp(cumf_i + m - m') / sqrt(P)
//   y_i     = (sum_j W_ij v_j + carry_i C q_i)
//             / max(|sum_j W_ij + carry_i n . q_i|, exp(-m'))
//   C      <- exp(cumf_L + m - m') C + sum_j exp(cumf_L - cumf_j + i~_j - m') v_j k_j^T
//   n      <- the same with k_j in place of v_j k_j^T
// C[p][r] sums v_p k_r, so the carried state enters y as C q, as in the
// cell's decode (the reference's chunked form contracts q with C's other
// index there: ROADMAP, queue 3). Inputs q, k, v in f32 or bf16, packed
// (B, S, nh, P); the gates' pre-activations f32 packed (B, S, nh); every
// sum in f32. Outputs y (B, S, nh, P) f32 and the final C, n, m; an
// optional (C0, n0, m0) seeds the state (else 0, 0, -1e30).
//
// Ragged S: positions past S count as i~ = -inf (no input, no say in the
// stabilizer) and log f = 0 (no decay), which is a shorter last chunk.
//
// What bounds it: per (batch, head, chunk) L(L+1)/2 P MACs for q.k^T and
// as many for W.v, and L P^2 for C q and for the C update; at xlstm-1.3b's
// 2048-token prefill (4 heads of P = 1024, L = 64) 35 GFLOP, 35.9 us at
// the bf16 tensor-core rate, against 0.15 GB of inputs and outputs (46 us).
// Only the C work is sequential over chunks.
//
// Design: three launches, the parts that do not depend on the carried C
// split from the part that does.
//   1. mlstm_chunk, a block per (chunk, head, batch). It finds the chunk's
//      stabilizers itself (m' is a running max over chunks of each chunk's
//      max_j src_j, so the block scans the gates of every chunk up to its
//      own: B S nh scalars, 4 chunks' gates loaded at once), writes its
//      carry_i, to_end_j, decay and m' to the scratch `info`, forms q.k^T
//      once on the tensor cores, then W in registers (and sum_j W_ij into
//      `info`), y_i's intra-chunk numerator W.v, written to y, and the
//      chunk's own term of the n update, dn = sum_j to_end_j k_j, into the
//      scratch `dn`. Tiles of q and k (then v) go through two shared-memory
//      buffers, each loaded into registers a tile ahead: one barrier a tile.
//   2. mlstm_n, a block per (128 columns of n, group of 4 chunks, head and
//      batch): n_c = decay_c n_{c-1} + dn_c, an FMA a column and chunk, up to
//      the group's chunks, then n_{c-1} . q_i for the group's positions
//      (partial sums over its columns into the scratch `nq`). n and n q are
//      formed once per head, not in every block of launch 3.
//   3. mlstm_carry, a block per (tile of TP rows of C, head, batch) with
//      its C tile resident in shared memory in f32, walking the chunks in
//      order over tiles of kTile columns of q and k: (C q)_i on the tensor
//      cores (the tile's C as bf16 terms against q), then C <- decay C +
//      (v to_end)^T k (v to_end as bf16 terms against k), and at the
//      chunk's end y_i = (y_i + carry_i (C q)_i) / den_i with den_i from
//      `info` and the summed `nq`. Tiles are 128 columns with bf16 inputs
//      and 64 with f32 ones (Cfg::kTile); the next tile of q and k is
//      loaded into registers under the current tile's products, the next
//      chunk's terms under the current chunk. What bounds this launch:
//      every block of a head reads all of q and k (32 blocks at
//      xlstm-1.3b: 1 GB through L2 a call) and each tile costs two
//      barriers and a load its products do not hide (on an H100 at 700 W,
//      about 840 of the call's 944 us at xlstm-1.3b's prefill; the first
//      two launches 58 and 35).
// Products are mma.sync m16n8k16 on bf16 with f32 sums; q.k^T and C q,
// whose sums run over all of P, take each 16 columns in accumulators of
// their own and add them in f32 (the tensor cores' sums do not round to
// nearest, and a chain over P drifts). An operand the
// kernels compute in f32 (W, C, v to_end) enters as bf16 terms (mma.cuh:
// splitn): two (2^-16 relative) where the inputs are bf16, which are exact
// operands; three (about f32's 2^-24) where the inputs are f32, which then
// enter as three terms too, and each product keeps the pairs of terms whose
// orders sum below three (6 products for 1). TP is 32 rows where the f32
// tile and the staged tiles fit in a block's shared memory, else 16
// (kernels/mlstm.py:rows_per_block); chunks up to 64.
#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 64;        // L; a chunk's tiles hold 64 positions
constexpr int kNCols = 128;          // columns of n an n-block owns
constexpr int kMaxNBlocks = 24;      // n-blocks per head: P up to 3072
constexpr int kChunkThreads = 128;   // launch 1: 4 warps, 16 rows of the chunk each
constexpr int kNThreads = kNCols;    // launch 2: a column of n a thread
constexpr int kGroup = 4;            // launch 2: chunks a block forms n . q for
constexpr int kCarryThreads = 256;   // launch 3: 8 warps
constexpr int kInfo = 3 * kMaxChunk + 2;  // carry, to_end, sum_j W, decay, m'
constexpr int kChunkFloats = 2 * kMaxChunk + 2;  // launch 3, a chunk's carry, den, decay

// bf16 terms of an input (q, k, v) and of an operand computed in f32 (W, C,
// v to_end), and the columns of a staged tile of q and k in launch 3
// (launch 1: kChunkTile); a product keeps the pairs of terms whose orders
// sum below kOp
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int kIn = 1, kOp = 2, kTile = 128;
};
template <>
struct Cfg<float> {
  static constexpr int kIn = 3, kOp = 3, kTile = 64;
};
constexpr int kChunkTile = 64;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// row stride of the f32 C tile: columns padded to whole tiles, plus 8
// floats (a fragment's float2 accesses at distinct banks)
__host__ __device__ constexpr int c_stride(int p, int tile) { return cdiv(p, tile) * tile + 8; }
// bytes of one term of a staged tile of `rows` rows (row stride tile + 8:
// ldmatrix's 8 rows at distinct banks)
__host__ __device__ constexpr int tile_bytes(int rows, int tile) { return rows * (tile + 8) * 2; }

// launch 1: two buffers of (q, k) tiles, then cumf, src, to_end and 8 scalars
__host__ __device__ constexpr int chunk_smem(int in_terms, int tile) {
  return 2 * 2 * in_terms * tile_bytes(kMaxChunk, tile) + 4 * (3 * kMaxChunk + 8);
}

// launch 3: the f32 C tile, the C columns a tile reads as bf16 terms, the q
// and k tiles, v to_end's terms ([j][p]) and a chunk's carry, den and decay
__host__ __device__ constexpr int carry_smem(int p, int tp, int in_terms, int op_terms, int tile) {
  return 4 * tp * c_stride(p, tile) + op_terms * tile_bytes(tp, tile) +
         2 * in_terms * tile_bytes(kMaxChunk, tile) + op_terms * kMaxChunk * (tp + 8) * 2 +
         4 * kChunkFloats;
}

struct MlstmArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;  // (B, S, nh) i~
  const float* fg;  // (B, S, nh) f~
  const float* C0;  // (B, nh, P, P) or null
  const float* n0;  // (B, nh, P) or null
  const float* m0;  // (B, nh) or null
  float* y;         // (B, S, nh, P)
  float* C;
  float* n;
  float* m;
  float* info;      // (B, nh, nc, kInfo)
  float* dn;        // (B, nh, nc, P): each chunk's own term of the n update
  float* nq;        // (nb, B, nh, nc, kMaxChunk): n . q_i over each block of 128 columns
  int s, nh, p, chunk, nc, nb, tp, vec;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// -- a chunk's gates, by one warp: positions lane and lane + 32 ---------------------

struct GateIn {
  float ig[2], fg[2];
};

__device__ __forceinline__ int chunk_len(const MlstmArgs& a, int c) { return min(a.chunk, a.s - c * a.chunk); }

__device__ __forceinline__ GateIn gate_load(const MlstmArgs& a, int b, int head, int c, int lane) {
  const int s0 = c * a.chunk, lc = chunk_len(a, c);
  GateIn in;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    const int64_t g = (static_cast<int64_t>(b) * a.s + s0 + j) * a.nh + head;
    in.ig[u] = j < lc ? a.ig[g] : 0.0f;
    in.fg[u] = j < lc ? a.fg[g] : 0.0f;
  }
  return in;
}

// cumf (0 past the chunk's lc positions), src (-inf past lc), i~ (-inf past
// lc), the chunk's max_j src_j and cumf at its last position
struct Gates {
  float cf[2], sr[2], iv[2], mx, last;
};

__device__ __forceinline__ Gates gate_scan(const GateIn& in, int lc, int lane) {
  Gates G;
  float lf[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    G.iv[u] = j < lc ? in.ig[u] : -CUDART_INF_F;
    lf[u] = j < lc ? log_sigmoid(in.fg[u]) : 0.0f;
  }
  float c0 = lf[0], c1 = lf[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t0 = __shfl_up_sync(0xffffffffu, c0, o);
    const float t1 = __shfl_up_sync(0xffffffffu, c1, o);
    if (lane >= o) {
      c0 += t0;
      c1 += t1;
    }
  }
  c1 += __shfl_sync(0xffffffffu, c0, 31);
  G.cf[0] = c0;
  G.cf[1] = c1;
  G.sr[0] = G.iv[0] - c0;
  G.sr[1] = G.iv[1] - c1;
  float mx = fmaxf(G.sr[0], G.sr[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  G.mx = mx;
  const int jl = lc - 1;
  G.last = __shfl_sync(0xffffffffu, jl < 32 ? c0 : c1, jl & 31);
  return G;
}

// -- staging: 8 consecutive elements of one row as loaded, then as bf16 terms

template <typename T>
struct Piece;
template <>
struct Piece<bf16> {
  uint4 u;
};
template <>
struct Piece<float> {
  float4 a, b;
};

// elements [c, c + 8) of `row` (null: a row past the data), zero past P
__device__ __forceinline__ void load_piece(Piece<bf16>& pc, const bf16* row, int c, int P, bool vec) {
  if (row == nullptr || c >= P) {
    pc.u = make_uint4(0, 0, 0, 0);
  } else if (vec && c + 8 <= P) {
    pc.u = *reinterpret_cast<const uint4*>(row + c);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = c + 2 * i < P ? __bfloat16_as_ushort(row[c + 2 * i]) : 0u;
      const uint32_t hi = c + 2 * i + 1 < P ? __bfloat16_as_ushort(row[c + 2 * i + 1]) : 0u;
      w[i] = lo | (hi << 16);
    }
    pc.u = make_uint4(w[0], w[1], w[2], w[3]);
  }
}
__device__ __forceinline__ void load_piece(Piece<float>& pc, const float* row, int c, int P, bool vec) {
  if (row == nullptr || c >= P) {
    pc.a = pc.b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else if (vec && c + 8 <= P) {
    pc.a = reinterpret_cast<const float4*>(row + c)[0];
    pc.b = reinterpret_cast<const float4*>(row + c)[1];
  } else {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = c + i < P ? row[c + i] : 0.0f;
    pc.a = make_float4(x[0], x[1], x[2], x[3]);
    pc.b = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// the piece at element `off` of term 0 of a staged tile (terms `stride` apart)
__device__ __forceinline__ void store_piece(bf16* t, int stride, int off, const Piece<bf16>& pc) {
  (void)stride;
  *reinterpret_cast<uint4*>(t + off) = pc.u;
}
__device__ __forceinline__ void store_piece(bf16* t, int stride, int off, const Piece<float>& pc) {
  const float x[8] = {pc.a.x, pc.a.y, pc.a.z, pc.a.w, pc.b.x, pc.b.y, pc.b.z, pc.b.w};
  uint32_t w[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t tt[3];
    splitn<3>(x[2 * i], x[2 * i + 1], tt);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k][i] = tt[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    *reinterpret_cast<uint4*>(t + k * stride + off) = make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
}

// A tile of 64 positions x kT columns in registers, kThr threads.
template <typename T, int kThr, int kT>
struct Tile {
  static constexpr int kS = kT + 8, kPer = kMaxChunk * (kT / 8) / kThr;
  Piece<T> pc[kPer];

  // rows [0, lc) of x (position stride `row`), columns [c0, c0 + kT)
  __device__ __forceinline__ void load(const T* x, int64_t row, int lc, int c0, int P, bool vec) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + kThr * u, r = e / (kT / 8), c = c0 + (e % (kT / 8)) * 8;
      load_piece(pc[u], r < lc ? x + r * row : nullptr, c, P, vec);
    }
  }
  // into a staged tile's term 0 (its terms kMaxChunk * kS elements apart)
  __device__ __forceinline__ void store(bf16* t) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + kThr * u;
      store_piece(t, kMaxChunk * kS, (e / (kT / 8)) * kS + (e % (kT / 8)) * 8, pc[u]);
    }
  }
};


// -- launch 1 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kChunkThreads) mlstm_chunk(MlstmArgs a) {
  using CF = Cfg<T>;
  constexpr int kIn = CF::kIn, kOp = CF::kOp, kT = kChunkTile, kS = kT + 8;
  constexpr int kTerm = kMaxChunk * kS;  // elements of one term of a staged tile
  constexpr int kWarps = kChunkThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.p, S = a.s, nh = a.nh;
  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z, bh = b * nh + head;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int64_t row = static_cast<int64_t>(nh) * P;  // elements between positions
  const int64_t base = static_cast<int64_t>(b) * S * row + static_cast<int64_t>(head) * P;
  const bool vec = a.vec != 0;
  const int s0 = c * a.chunk, lc = chunk_len(a, c);
  const int lp = cdiv(a.chunk, 16) * 16;  // rows of the chunk's tiles in use

  bf16* qk = reinterpret_cast<bf16*>(smem);                          // [2 buf][q, k][kIn][64][kS]
  float* cumf = reinterpret_cast<float*>(qk + 2 * 2 * kIn * kTerm);  // [64]
  float* src = cumf + kMaxChunk;                                     // [64]
  float* te = src + kMaxChunk;                                       // [64]: to_end
  float* sc = te + kMaxChunk;                                        // [8]: warps' maxima, m'
  auto qbuf = [&](int buf) { return qk + (2 * buf) * kIn * kTerm; };
  auto kbuf = [&](int buf) { return qk + (2 * buf + 1) * kIn * kTerm; };
  float* info = a.info + (static_cast<int64_t>(bh) * a.nc + c) * kInfo;

  // the stabilizers: m' of the chunks before this one (a running max over
  // chunks, here a max over their maxima: chunks warp + 4 k, the gates of 4
  // chunks loaded at once), then this chunk's
  {
    float mx = -CUDART_INF_F;
    for (int c0 = warp; c0 < c; c0 += 4 * kWarps) {
      GateIn in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kWarps < c) in[u] = gate_load(a, b, head, c0 + u * kWarps, lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = c0 + u * kWarps;
        if (cc < c) mx = fmaxf(mx, gate_scan(in[u], chunk_len(a, cc), lane).mx);
      }
    }
    if (lane == 0) sc[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    float mprev = a.m0 ? a.m0[bh] : -1e30f;
    for (int w = 0; w < kWarps; ++w) mprev = fmaxf(mprev, sc[w]);
    const Gates G = gate_scan(gate_load(a, b, head, c, lane), lc, lane);
    const float mnew = fmaxf(mprev, G.mx);
    const float scale = rsqrtf(static_cast<float>(P));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      const float tj = j < lc ? expf(G.last - G.cf[u] + G.iv[u] - mnew) : 0.0f;
      cumf[j] = G.cf[u];
      src[j] = G.sr[u];
      te[j] = tj;
      info[j] = expf(G.cf[u] + mprev - mnew) * scale;  // carry
      info[kMaxChunk + j] = tj;
    }
    if (lane == 0) {
      info[3 * kMaxChunk] = expf(G.last + mprev - mnew);  // decay
      info[3 * kMaxChunk + 1] = mnew;
      sc[4] = mnew;
    }
  }
  const bool rows = warp * 16 < lp;  // this warp's 16 rows hold positions
  const int i0 = warp * 16 + g, i1 = i0 + 8;

  // tiles t < nkt: q and k's columns [t kT, t kT + kT), for S = q k^T and dn;
  // tiles nkt + t: v's, for W.v
  const T* q = static_cast<const T*>(a.q) + base + static_cast<int64_t>(s0) * row;
  const T* k = static_cast<const T*>(a.k) + base + static_cast<int64_t>(s0) * row;
  const T* v = static_cast<const T*>(a.v) + base + static_cast<int64_t>(s0) * row;
  const int nkt = cdiv(P, kT), tiles = 2 * nkt;
  Tile<T, kChunkThreads, kT> xq, xk;
  auto load = [&](int t) {
    if (t < nkt) {
      xq.load(q, row, lc, t * kT, P, vec);
      xk.load(k, row, lc, t * kT, P, vec);
    } else {
      xq.load(v, row, lc, (t - nkt) * kT, P, vec);
    }
  };
  auto store = [&](int t) {
    xq.store(qbuf(t & 1));
    if (t < nkt) xk.store(kbuf(t & 1));
  };
  load(0);
  store(0);
  load(1);
  __syncthreads();  // also the stabilizers of the prologue
  const float mnew = sc[4];
  const float scale = rsqrtf(static_cast<float>(P));
  float acc[8][4] = {};
  uint32_t wa[4][kOp][4];
  float* y = a.y + base + static_cast<int64_t>(s0) * row;
  float* dn = a.dn + (static_cast<int64_t>(bh) * a.nc + c) * P;
  for (int t = 0; t < tiles; ++t) {
    const bf16* qs = qbuf(t & 1);
    if (t < nkt) {
      // S = q k^T, causal pairs of 16 x 16 tiles only; each 16 columns
      // summed apart, then added to S in f32 (the tensor cores' f32
      // sums do not round to nearest: one chain over all of P left y several
      // times as far from float64 as the plain version, which the backward,
      // reading y, carried into every gradient but dv)
      const bf16* ks = kbuf(t & 1);
      if (rows) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp > warp) break;
#pragma unroll
          for (int kb = 0; kb < kT; kb += 16) {
            float part[2][4] = {};
            uint32_t af[kIn][4], bfr[kIn][4];
#pragma unroll
            for (int ti = 0; ti < kIn; ++ti)
              ldsm4(af[ti], qs + ti * kTerm + (warp * 16 + row_a(lane)) * kS + kb + col_a(lane));
#pragma unroll
            for (int tj = 0; tj < kIn; ++tj)
              ldsm4(bfr[tj], ks + tj * kTerm + (jp * 16 + row_b(lane)) * kS + kb + col_b(lane));
#pragma unroll
            for (int ti = 0; ti < kIn; ++ti)
#pragma unroll
              for (int tj = 0; tj < kIn; ++tj) {
                if (ti + tj >= kOp) continue;
                mma(part[0], af[ti], bfr[tj][0], bfr[tj][1]);
                mma(part[1], af[ti], bfr[tj][2], bfr[tj][3]);
              }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[2 * jp][e] += part[0][e];
              acc[2 * jp + 1][e] += part[1][e];
            }
          }
        }
      }
      // dn over the tile's columns: sum_j to_end_j k_j (0 past lc), a column a thread
      for (int cc = tid; cc < kT; cc += kChunkThreads) {
        float sum = 0.0f;
        for (int j = 0; j < lp; ++j) {
          float kj = 0.0f;
#pragma unroll
          for (int tj = 0; tj < kIn; ++tj) kj += __bfloat162float(ks[tj * kTerm + j * kS + cc]);
          sum = fmaf(te[j], kj, sum);
        }
        if (t * kT + cc < P) dn[t * kT + cc] = sum;
      }
      if (t == nkt - 1) {
        // W in registers (j <= i < lc), its row sums into info, then its
        // bf16 terms as A fragments: wa[kb] for key columns [16 kb, 16 kb + 16)
        const float ci0 = cumf[i0], ci1 = cumf[i1];
        float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1, j = nt * 8 + 2 * t4 + (e & 1);
            acc[nt][e] = (j <= i && i < lc)
                             ? expf((e < 2 ? ci0 : ci1) + src[j] - mnew) * (acc[nt][e] * scale)
                             : 0.0f;
          }
          r0 += acc[nt][0] + acc[nt][1];
          r1 += acc[nt][2] + acc[nt][3];
        }
        r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
        r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
        if (t4 == 0 && rows) {
          info[2 * kMaxChunk + i0] = r0;
          info[2 * kMaxChunk + i1] = r1;
        }
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          uint32_t t0[kOp], t1[kOp], t2[kOp], t3[kOp];
          splitn<kOp>(acc[2 * kb][0], acc[2 * kb][1], t0);
          splitn<kOp>(acc[2 * kb][2], acc[2 * kb][3], t1);
          splitn<kOp>(acc[2 * kb + 1][0], acc[2 * kb + 1][1], t2);
          splitn<kOp>(acc[2 * kb + 1][2], acc[2 * kb + 1][3], t3);
#pragma unroll
          for (int u = 0; u < kOp; ++u) {
            wa[kb][u][0] = t0[u];
            wa[kb][u][1] = t1[u];
            wa[kb][u][2] = t2[u];
            wa[kb][u][3] = t3[u];
          }
        }
      }
    } else if (rows) {
      // y_i's intra-chunk numerator W.v over v's columns [pt kT, pt kT + kT)
      const int pt = t - nkt;
      float out[kT / 8][4] = {};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb > warp) break;
#pragma unroll
        for (int np = 0; np < kT / 16; ++np) {
          uint32_t vf[kIn][4];
#pragma unroll
          for (int tv = 0; tv < kIn; ++tv)
            ldsm4t(vf[tv], qs + tv * kTerm + (kb * 16 + row_a(lane)) * kS + np * 16 + col_a(lane));
#pragma unroll
          for (int tw = 0; tw < kOp; ++tw)
#pragma unroll
            for (int tv = 0; tv < kIn; ++tv) {
              if (tw + tv >= kOp) continue;
              mma(out[2 * np], wa[kb][tw], vf[tv][0], vf[tv][1]);
              mma(out[2 * np + 1], wa[kb][tw], vf[tv][2], vf[tv][3]);
            }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const int pc = pt * kT + nt * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1, pp = pc + (e & 1);
          if (i < lc && pp < P) y[i * row + pp] = out[nt][e];
        }
      }
    }
    if (t + 1 < tiles) {
      store(t + 1);
      if (t + 2 < tiles) load(t + 2);
    }
    __syncthreads();
  }
}

// -- launch 2 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kNThreads) mlstm_n(MlstmArgs a) {
  __shared__ float nsm[kGroup][kNCols];  // n before each of the group's chunks
  const int P = a.p, S = a.s, nh = a.nh;
  const int nb = blockIdx.x, grp = blockIdx.y, bh = blockIdx.z, b = bh / nh, head = bh % nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = nb * kNCols + tid;
  const int c0 = grp * kGroup, c1 = min(a.nc, c0 + kGroup);
  const int64_t row = static_cast<int64_t>(nh) * P;
  const int64_t base = static_cast<int64_t>(b) * S * row + static_cast<int64_t>(head) * P;
  const float* info = a.info + static_cast<int64_t>(bh) * a.nc * kInfo;
  const float* dn = a.dn + static_cast<int64_t>(bh) * a.nc * P;

  // n_c = decay_c n_{c-1} + dn_c up to the group's last chunk, 4 chunks'
  // loads issued at once
  float n = (r < P && a.n0) ? a.n0[static_cast<int64_t>(bh) * P + r] : 0.0f;
  for (int cb = 0; cb < c1; cb += kGroup) {
    float dv[kGroup], dec[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int cc = cb + u;
      dv[u] = (cc < c1 && r < P) ? dn[static_cast<int64_t>(cc) * P + r] : 0.0f;
      dec[u] = cc < c1 ? info[cc * kInfo + 3 * kMaxChunk] : 1.0f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int cc = cb + u;
      if (cc < c1) {
        if (cc >= c0) nsm[cc - c0][tid] = n;
        n = dec[u] * n + dv[u];
      }
    }
  }
  if (c1 == a.nc) {  // the last group holds the final n and m
    if (r < P) a.n[static_cast<int64_t>(bh) * P + r] = n;
    if (nb == 0 && tid == 0)
      a.m[bh] = a.nc > 0 ? info[(a.nc - 1) * kInfo + 3 * kMaxChunk + 1] : (a.m0 ? a.m0[bh] : -1e30f);
  }
  __syncthreads();

  // n_{c-1} . q_i over this block's columns for the group's positions: a
  // warp a row (chunk, position), 4 columns a lane, 8 rows' loads at once
  const T* q = static_cast<const T*>(a.q) + base;
  float* nq = a.nq + (static_cast<int64_t>(nb) * gridDim.z + bh) * a.nc * kMaxChunk;
  const int rows = (c1 - c0) * kMaxChunk;
  for (int r0 = warp * 8; r0 < rows; r0 += 8 * (kNThreads / 32)) {
    float qv[8][kNCols / 32];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int rr = r0 + u, cc = c0 + rr / kMaxChunk, i = rr % kMaxChunk;
      const bool in = rr < rows && i < chunk_len(a, min(cc, a.nc - 1));
#pragma unroll
      for (int w = 0; w < kNCols / 32; ++w) {
        const int col = nb * kNCols + lane + 32 * w;
        qv[u][w] = in && col < P ? rt::load_f32(q + (static_cast<int64_t>(cc) * a.chunk + i) * row + col) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int rr = r0 + u;
      const float* nr = nsm[min(rr / kMaxChunk, kGroup - 1)];
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kNCols / 32; ++w) sum = fmaf(nr[lane + 32 * w], qv[u][w], sum);
      sum = rt::warp_sum(sum);
      if (lane == 0 && rr < rows) nq[(c0 + rr / kMaxChunk) * kMaxChunk + rr % kMaxChunk] = sum;
    }
  }
}

// -- launch 3 ---------------------------------------------------------------------

// A chunk's terms for launch 3, loaded into registers a chunk ahead: carry,
// sum_j W and the summed n . q of position tid (tid < 64); decay and m'; v
// and to_end of the thread's pairs of v to_end (at most 4: 64 TP / 2 pairs
// over 256 threads).
struct ChunkRegs {
  float cr, rw, nqs, mn, dec;
  float te[4], v0[4], v1[4];
};

template <typename T>
__global__ void __launch_bounds__(kCarryThreads, 1) mlstm_carry(MlstmArgs a) {
  using CF = Cfg<T>;
  constexpr int kIn = CF::kIn, kOp = CF::kOp, kT = CF::kTile, kS = kT + 8;
  constexpr int kTerm = kMaxChunk * kS;
  constexpr int kWarps = kCarryThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.p, S = a.s, nh = a.nh, TP = a.tp;
  const int CP = c_stride(P, kT), VS = TP + 8;
  const int p0 = blockIdx.x * TP, head = blockIdx.y, b = blockIdx.z, bh = b * nh + head;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int tpv = min(TP, P - p0);  // rows of C this block owns
  const int64_t row = static_cast<int64_t>(nh) * P;
  const int64_t base = static_cast<int64_t>(b) * S * row + static_cast<int64_t>(head) * P;
  const bool vec = a.vec != 0;

  float* Cs = reinterpret_cast<float*>(smem);            // [TP][CP]
  bf16* chs = reinterpret_cast<bf16*>(Cs + TP * CP);     // [kOp][TP][kS]
  bf16* qs = chs + kOp * TP * kS;                        // [kIn][64][kS]
  bf16* ks = qs + kIn * kTerm;                           // [kIn][64][kS]
  bf16* vws = ks + kIn * kTerm;                          // [kOp][64][VS]
  float* fl = reinterpret_cast<float*>(vws + kOp * kMaxChunk * VS);  // carry [64], den [64], decay

  for (int e = tid; e < TP * CP; e += kCarryThreads) {
    const int pr = e / CP, r = e % CP;
    Cs[e] = (a.C0 && pr < tpv && r < P) ? a.C0[(static_cast<int64_t>(bh) * P + p0 + pr) * P + r] : 0.0f;
  }

  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int nkt = cdiv(P, kT), lp = cdiv(a.chunk, 16) * 16;
  const int pairs = kMaxChunk * (TP / 2);  // v to_end's pairs (j, p, p + 1)

  ChunkRegs cd;
  auto prefetch = [&](int c) {
    const float* info = a.info + (static_cast<int64_t>(bh) * a.nc + c) * kInfo;
    const int s0 = c * a.chunk, lc = chunk_len(a, c);
    if (tid < kMaxChunk) {
      cd.cr = info[tid];
      cd.rw = info[2 * kMaxChunk + tid];
      cd.mn = info[3 * kMaxChunk + 1];
      // the column blocks' parts, every load issued before the first is summed
      float part[kMaxNBlocks];
#pragma unroll
      for (int nb = 0; nb < kMaxNBlocks; ++nb)
        part[nb] = nb < a.nb
                       ? a.nq[((static_cast<int64_t>(nb) * gridDim.z * nh + bh) * a.nc + c) * kMaxChunk + tid]
                       : 0.0f;
      float s = 0.0f;
#pragma unroll
      for (int nb = 0; nb < kMaxNBlocks; ++nb) s += part[nb];
      cd.nqs = s;
    }
    cd.dec = info[3 * kMaxChunk];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + kCarryThreads * u, j = e / (TP / 2), pc = 2 * (e % (TP / 2));
      const bool in = e < pairs && j < lc;
      const T* vr = v + static_cast<int64_t>(s0 + j) * row + p0 + pc;
      cd.te[u] = in ? info[kMaxChunk + j] : 0.0f;
      cd.v0[u] = in && pc < tpv ? rt::load_f32(vr) : 0.0f;
      cd.v1[u] = in && pc + 1 < tpv ? rt::load_f32(vr + 1) : 0.0f;
    }
  };
  auto commit = [&]() {
    if (tid < kMaxChunk) {
      fl[tid] = cd.cr;
      fl[kMaxChunk + tid] = fmaxf(fabsf(cd.rw + cd.cr * cd.nqs), expf(-cd.mn));
    }
    if (tid == 0) fl[2 * kMaxChunk] = cd.dec;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + kCarryThreads * u, j = e / (TP / 2), pc = 2 * (e % (TP / 2));
      if (e < pairs) {
        uint32_t t[kOp];
        splitn<kOp>(cd.v0[u] * cd.te[u], cd.v1[u] * cd.te[u], t);
#pragma unroll
        for (int w = 0; w < kOp; ++w) *reinterpret_cast<uint32_t*>(vws + (w * kMaxChunk + j) * VS + pc) = t[w];
      }
    }
  };

  // warps: (C q) over rows [16 mq, 16 mq + 16) of the chunk and rows
  // [16 jq, 16 jq + 16) of the tile (4 TP / 16 units, a warp each); the C
  // update over rows [16 mc, 16 mc + 16) of the tile and a tile's columns
  // [16 nc2, 16 nc2 + 16) (TP / 16 kT / 16 units)
  const int mt = TP / 16, cq_units = 4 * mt, dc_units = mt * (kT / 16);
  const int mq = warp & 3, jq = warp >> 2;
  Tile<T, kCarryThreads, kT> xq, xk;
  if (a.nc > 0) {
    prefetch(0);
    xq.load(q, row, chunk_len(a, 0), 0, P, vec);
    xk.load(k, row, chunk_len(a, 0), 0, P, vec);
  }
  __syncthreads();  // the C tile is whole
  for (int c = 0; c < a.nc; ++c) {
    const int s0 = c * a.chunk, lc = chunk_len(a, c);
    commit();
    if (c + 1 < a.nc) prefetch(c + 1);
    float cq[2][4] = {};
    // this warp's y_i (the intra-chunk numerators of launch 1), for the epilogue
    float* y = a.y + base + static_cast<int64_t>(s0) * row + p0;
    float yv[2][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mq * 16 + g + (e >> 1) * 8, pp = jq * 16 + h2 * 8 + 2 * t4 + (e & 1);
        yv[h2][e] = warp < cq_units && i < lc && pp < tpv ? y[i * row + pp] : 0.0f;
      }
    for (int kt = 0; kt < nkt; ++kt) {
      const int r0 = kt * kT;
      xq.store(qs);
      xk.store(ks);
      // the next tile into the registers just stored, in flight under this one
      if (kt + 1 < nkt) {
        xq.load(q + static_cast<int64_t>(s0) * row, row, lc, r0 + kT, P, vec);
        xk.load(k + static_cast<int64_t>(s0) * row, row, lc, r0 + kT, P, vec);
      } else if (c + 1 < a.nc) {
        const int s1 = s0 + a.chunk, lc1 = chunk_len(a, c + 1);
        xq.load(q + static_cast<int64_t>(s1) * row, row, lc1, 0, P, vec);
        xk.load(k + static_cast<int64_t>(s1) * row, row, lc1, 0, P, vec);
      }
      // the tile's C columns (before this chunk's update) as bf16 terms
      for (int e = tid; e < TP * (kT / 2); e += kCarryThreads) {
        const int pr = e / (kT / 2), cc = 2 * (e % (kT / 2));
        const float2 x = *reinterpret_cast<const float2*>(Cs + pr * CP + r0 + cc);
        uint32_t t[kOp];
        splitn<kOp>(x.x, x.y, t);
#pragma unroll
        for (int w = 0; w < kOp; ++w) *reinterpret_cast<uint32_t*>(chs + (w * TP + pr) * kS + cc) = t[w];
      }
      __syncthreads();
      // (C q)_i over the tile's columns: A = q (rows i), B = C's terms (rows p),
      // summed apart and added to (C q)_i in f32 (as S in mlstm_chunk)
      if (warp < cq_units && mq * 16 < lp) {
#pragma unroll
        for (int kb = 0; kb < kT; kb += 16) {
          float part[2][4] = {};
          uint32_t af[kIn][4], bfr[kOp][4];
#pragma unroll
          for (int ti = 0; ti < kIn; ++ti)
            ldsm4(af[ti], qs + ti * kTerm + (mq * 16 + row_a(lane)) * kS + kb + col_a(lane));
#pragma unroll
          for (int tc = 0; tc < kOp; ++tc)
            ldsm4(bfr[tc], chs + tc * TP * kS + (jq * 16 + row_b(lane)) * kS + kb + col_b(lane));
#pragma unroll
          for (int ti = 0; ti < kIn; ++ti)
#pragma unroll
            for (int tc = 0; tc < kOp; ++tc) {
              if (ti + tc >= kOp) continue;
              mma(part[0], af[ti], bfr[tc][0], bfr[tc][1]);
              mma(part[1], af[ti], bfr[tc][2], bfr[tc][3]);
            }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cq[0][e] += part[0][e];
            cq[1][e] += part[1][e];
          }
        }
      }
      // C <- decay C + (v to_end)^T k over the tile's columns: A = v to_end's
      // terms (rows p, read transposed from [j][p]), B = k ([j][r])
      const float decay = fl[2 * kMaxChunk];
      for (int unit = warp; unit < dc_units; unit += kWarps) {
        const int mc = unit % mt, nc2 = unit / mt;
        float dc[2][4] = {};
        for (int kb = 0; kb < lp; kb += 16) {
          uint32_t av[kOp][4], kf[kIn][4];
#pragma unroll
          for (int tw = 0; tw < kOp; ++tw)
            ldsm4t(av[tw], vws + (tw * kMaxChunk + kb + row_b(lane)) * VS + mc * 16 + col_b(lane));
#pragma unroll
          for (int tk = 0; tk < kIn; ++tk)
            ldsm4t(kf[tk], ks + tk * kTerm + (kb + row_a(lane)) * kS + nc2 * 16 + col_a(lane));
#pragma unroll
          for (int tw = 0; tw < kOp; ++tw)
#pragma unroll
            for (int tk = 0; tk < kIn; ++tk) {
              if (tw + tk >= kOp) continue;
              mma(dc[0], av[tw], kf[tk][0], kf[tk][1]);
              mma(dc[1], av[tw], kf[tk][2], kf[tk][3]);
            }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = r0 + nc2 * 16 + h2 * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* cp = reinterpret_cast<float2*>(Cs + (mc * 16 + g + 8 * h) * CP + r);
            const float2 old = *cp;
            *cp = make_float2(decay * old.x + dc[h2][2 * h], decay * old.y + dc[h2][2 * h + 1]);
          }
        }
      }
      __syncthreads();
    }
    // y_i = (y_i + carry_i (C q)_i) / den_i over this warp's rows and columns
    if (warp < cq_units && mq * 16 < lp) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mq * 16 + g + (e >> 1) * 8, pp = jq * 16 + h2 * 8 + 2 * t4 + (e & 1);
          if (i < lc && pp < tpv) y[i * row + pp] = (yv[h2][e] + fl[i] * cq[h2][e]) / fl[kMaxChunk + i];
        }
    }
    __syncthreads();  // carry, den and v to_end are rewritten by the next chunk
  }
  for (int e = tid; e < tpv * P; e += kCarryThreads) {
    const int pr = e / P, r = e % P;
    a.C[(static_cast<int64_t>(bh) * P + p0 + pr) * P + r] = Cs[pr * CP + r];
  }
}

template <typename T>
int launch(const MlstmArgs& args, int batch, cudaStream_t st) {
  using CF = Cfg<T>;
  const int s1 = chunk_smem(CF::kIn, kChunkTile);
  const int s3 = carry_smem(args.p, args.tp, CF::kIn, CF::kOp, CF::kTile);
  cudaError_t e = cudaFuncSetAttribute(mlstm_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mlstm_carry<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (e != cudaSuccess) return e;
  if (args.nc > 0) {
    mlstm_chunk<T><<<dim3(args.nc, args.nh, batch), kChunkThreads, s1, st>>>(args);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  mlstm_n<T><<<dim3(args.nb, max(1, cdiv(args.nc, kGroup)), args.nh * batch), kNThreads, 0, st>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mlstm_carry<T><<<dim3(cdiv(args.p, args.tp), args.nh, batch), kCarryThreads, s3, st>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of launch 3 takes at width p with tp rows of
// C (is_bf16: bf16 inputs, else f32).
extern "C" int rt_mlstm_scan_smem(int p, int tp, int is_bf16) {
  return is_bf16 ? carry_smem(p, tp, Cfg<bf16>::kIn, Cfg<bf16>::kOp, Cfg<bf16>::kTile)
                 : carry_smem(p, tp, Cfg<float>::kIn, Cfg<float>::kOp, Cfg<float>::kTile);
}

// q, k, v packed (batch, s, nh, p) f32 (is_bf16 = 0) or bf16; ig, fg
// packed (batch, s, nh) f32; C0/n0/m0 null for the zero state; scratch f32:
// info (batch, nh, nc, 3 * 64 + 2), dn (batch, nh, nc, p), nq (ceil(p /
// 128), batch, nh, nc, 64); tp (16 or 32) rows of C a block of launch 3
// (kernels/mlstm.py:rows_per_block); vec: q, k, v are read 16 bytes at a
// time.
extern "C" int rt_mlstm_scan(const void* q, const void* k, const void* v, const float* ig,
                             const float* fg, const float* C0, const float* n0, const float* m0,
                             float* y, float* C, float* n, float* m, float* info, float* dn, float* nq,
                             int batch, int s, int nh, int p, int chunk, int tp, int is_bf16,
                             int vec, void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  const int nc = cdiv(s, chunk), nb = cdiv(p, kNCols);
  if (p < 1 || s < 0 || chunk < 1 || chunk > kMaxChunk || (tp != 16 && tp != 32) || nb > kMaxNBlocks)
    return cudaErrorInvalidValue;
  const MlstmArgs args{q, k, v, ig, fg, C0, n0, m0, y, C, n, m, info, dn, nq,
                       s, nh, p, chunk, nc, nb, tp, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(args, batch, st) : launch<float>(args, batch, st);
}
