// flash_attention_bwd: the gradient of K5 (flash_attention.cu) with respect
// to q, k and v, for training.
//
// Replaces no Pallas kernel: the reference trains through jnp and no Pallas
// kernel of it has a custom_vjp. The port's forward on the card is K5, so
// its gradient is a kernel too. The plain version is
// kernels/ref.py:flash_attention_bwd_ref (autograd of the forward's plain
// version). With s_ij = scale q_i.k_j, the forward's per-row log-sum-exp
// lse_i (written by K5 under autograd) and the output o:
//   P_ij  = exp(s_ij - lse_i)                    (0 where masked)
//   D_i   = sum_d dO_id o_id
//   dS_ij = P_ij (dO_i.v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
// with the masks of the forward (causal j <= i, window j > i - window, keys
// below Sk), GQA (a KV head's dk and dv sum over its group of q heads) and
// Sq != Sk. q, k, v, o, dO in f32 or bf16 with any (batch, seq, head)
// strides and inner stride 1 (bf16: multiples of 16 bytes, as K5's); every
// sum in f32; dq, dk, dv written in the inputs' dtype.
//
// What bounds it: operations. Per visible (q, k) pair the gradient needs 5
// products of hd MACs (s, dO.v, dv, dk, dq): 10 hd FLOP, 85.9 GFLOP at
// qwen3-4b's causal 2048-token layer (32 q heads over 8 of 128), 86.9 us at
// the card's 989 bf16 TFLOP/s, against about 50 MB read and written. The
// two passes below form s and dO.v twice, 14 hd FLOP a pair. With v's own
// head dim hd_v (below): 2 (3 hd + 2 hd_v) FLOP a pair needed, 2 (4 hd + 3
// hd_v) done; 386.7 GFLOP (391 us) at nemotron-4-340b's layer, 446.9 (452
// us) at deepseek-v2's MLA layer.
//
// Three launches, no atomics, every sum in an order fixed by the shape, so
// a training step repeats bit for bit:
//   1. D_i = rowsum(dO o), a row per 16 threads (bf16: 16-byte loads) or a
//      warp (f32).
//   2. dk/dv: a block per (64 keys, KV head, batch). K and V's tiles stay in
//      shared memory; the block walks the GQA group's q heads in order and,
//      for each, the q tiles that can see its keys, forming P and dS for the
//      tile, then dv += P^T dO and dk += dS^T q; every sum in the order of
//      the steps (bf16: per set, then the two sets' in set order).
//   3. dq: a block per (64 q rows, q head, batch). q and dO stay in shared
//      memory; the block walks the K/V tiles the rows can see, forms P and dS
//      again, and dq += dS k.
// lse is +inf for a row that sees no key (K5's contract), so P = 0 there;
// rows past Sq and keys past Sk are zero-filled and masked to P = 0.
//
// Two builds, chosen by dtype in the C entry (a dispatch by type between two
// hand-written kernels, not a fallback):
//
// * bfloat16 (the training path): fa_bwd_dkdv_mma and fa_bwd_dq_mma, the five
//   products on the tensor cores as mma.sync m16n8k16 bf16 with f32 sums
//   (mma.cuh: ldmatrix fragments, as ssd.cu and mlstm.cu take them).
//   mma.sync rather than wgmma: each warp owns 16 rows of every product
//   (keys in dk/dv, q rows in dq), so S^T and dP^T land in registers in the
//   layout of the next product's A operand, and P and dS never go through
//   shared memory; the warps share no accumulator and meet only at the
//   tile barriers. wgmma's 64-row warpgroup tiles would need P^T and dS^T
//   written to shared memory in its swizzled layout and read back.
//   - Sets of 4 warps (128 threads): a dq block is one set, a dk/dv block
//     two. Operands stay bf16 in shared memory in rows of hd + 8 values
//     (hd + 8 is 16 bytes over a multiple of 128 at every built hd, 80 too:
//     the 8 rows an ldmatrix reads fall on distinct banks), filled by
//     16-byte cp.async copies. The tiles a set walks over (q and dO in
//     dk/dv, K and V in dq) are double-buffered: the copies of the next tile
//     fly while the current one is computed, one barrier on each side of a
//     tile. lse and D come in with their q tile by 4-byte copies.
//   - dk/dv: S^T = K Q^T and dP^T = V dO^T a half tile (32 q rows) at a
//     time; P^T = exp2((s scale - lse) log2 e) and dS^T = P^T (dP^T - D) in
//     f32 registers, masked per element only on tiles that cross the causal
//     or window frontier or the end of Sq or Sk, then rounded once to bf16
//     as the A operands of dv += P^T dO and dk += dS^T q (B from dO and q
//     by ldmatrix.trans). dk and dv stay in registers for the block's life:
//     hd / 2 f32 each a thread.
//   - dq: S and dP for 64 keys at a time, P and dS as above, dq += dS K.
//   - Rounding P and dS to bf16 once errs by about 2^-9 of an element; the
//     gradients stay within 2e-2 of their largest |value| (BWD_REL). No hi/lo
//     split is needed, unlike the forward's P, whose sum is the output itself.
//   - Balance: under a causal mask the first key tiles are seen by the most
//     q tiles (key tile 0 of qwen3-4b's layer by 4 heads x 32 q tiles, the
//     last by 4 x 1), and the heaviest dk/dv block alone set the pass's
//     length. So a dk/dv block's two sets take its steps, the (q head of
//     the group, q tile) pairs in order, alternately, each with its own
//     double buffers, and add their sums at the end, set 1's into set 0's
//     in shared memory; and the dk/dv pass takes the key tiles heaviest
//     first, the dq pass the q tiles heaviest first, from one plan the host
//     makes and uploads once per shape (kernels/flash_attention.py:bwd_plan,
//     the key tiles' entries then tile_plan's): block t of a pass takes
//     entry t / (heads * B).
//   - GQA without atomics: a dk/dv block walks its group's q heads, so a KV
//     head's sum over its group never leaves the block. At qwen3-4b's
//     shape the passes run 32 x 8 = 256 blocks of 8 warps (176 KB of shared
//     memory, one an SM) and 32 x 32 = 1024 of 4 (104 KB, two an SM).
// * float32 (the checks and the f32 training cut only): fa_bwd_dkdv and
//   fa_bwd_dq, SIMT f32 FMAs from shared memory, a 256-thread block holding
//   a 64 x 64 tile of s as rows ty + 16 u and columns tx + 16 w (u, w < 4).
//   The tensor cores take f32 only as TF32, which the 1e-4 f32 tolerance
//   does not admit.
//
// Two head dims: HD for q and k, HDV for v, o and dO. s = q.k^T, dk and dq
// run over HD; dP = dO.v^T, D and dv over HDV. The builds: HD = HDV in 16,
// 32, 64, 80, 128 and 192 (nemotron-4-340b), and HD 192 with HDV 128
// (deepseek-v2's MLA: q/k nope 128 + rope 64, v 128), which takes v, o and
// dO at their own width: padding them to 192 would add half again to the
// dO.v^T and dv products and to the V-side bytes. The C entry refuses any
// other pair (the wrapper pads up to one of these first).
//
// Head dim 192 (bf16): the design above does not fit (its dk/dv block would
// need 258 KB of shared memory, and dk and dv 192 f32 registers a thread
// before any S or dP fragment). Those builds run the wide build on wgmma,
// fa_bwd_rows_wide + fa_bwd_dkdv_wide + fa_bwd_dq_wide
// (flash_attention_bwd_wide.cu), reached from the C entry below.
//
// The f32 SIMT build holds q, k, v, dO tiles of 64 x (hd + 1) floats, P and
// dS: 231424 bytes at (192, 192), 198656 at (192, 128), within the block's
// 232448. rt_flash_attention_bwd_smem gives every build's bytes a block
// (kernels/flash_attention.py:bwd_smem is its twin).
#include "common.cuh"
#include "mma.cuh"

// the wide build at q/k head dim 192 (flash_attention_bwd_wide.cu): rows is
// scratch of 2 x (batch, h, sq rounded up to 64) f32; the rest as
// rt_flash_attention_bwd's
int flash_bwd_wide_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                          const float* lse, float* rows, const int* plan, void* dq, void* dk, void* dv,
                          const int64_t* strides, int batch, int sq, int sk, int h, int kv, int hd, int hd_v,
                          float scale, int causal, int window, cudaStream_t stream);
int flash_bwd_wide_smem(int hd, int hd_v, int pass);

namespace {

using bf16 = __nv_bfloat16;

constexpr int kB = 64;           // q rows and keys a tile
constexpr int kThreads = 256;    // the SIMT f32 kernels
constexpr int kTcThreads = 128;  // the tensor-core dq kernel, and a set of the dk/dv kernel: 4 warps of 16 rows
constexpr int kSets = 2;         // the dk/dv kernel's sets of 4 warps, each taking every other step
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* dsum;       // (B, H, Sq): D
  const int* kplan;  // bf16: (key tile, first q row, end q row) per dk/dv block order
  const int* qplan;  // bf16: (q tile, first key, end key) per dq block order
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;    // element strides of q (B, Sq, H, hd); inner stride 1
  int64_t k_sb, k_ss, k_sh;    // k (B, Sk, KV, hd)
  int64_t v_sb, v_ss, v_sh;    // v
  int64_t o_sb, o_ss, o_sh;    // o (B, Sq, H, hd)
  int64_t d_sb, d_ss, d_sh;    // dO
  int64_t dq_sb, dq_ss, dq_sh;  // dq, like q
  int64_t dk_sb, dk_ss, dk_sh;  // dk, like k
  int64_t dv_sb, dv_ss, dv_sh;  // dv, like v
  int batch, sq, sk, h, kv, hd, hd_v;  // hd: q and k; hd_v: v, o, dO
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int j) {
  bool ok = i < a.sq && j < a.sk;
  if (a.causal) ok = ok && j <= i;
  if (a.window > 0) ok = ok && j > i - a.window;
  return ok;
}

// whether some pair of the tile (q rows [i0, i0 + 64), keys [j0, j0 + 64)) is
// masked: past Sq or Sk, past the causal frontier or before the window
__device__ __forceinline__ bool crosses_mask(const BwdArgs& a, int i0, int j0) {
  return i0 + kB > a.sq || j0 + kB > a.sk || (a.causal && j0 + kB - 1 > i0) ||
         (a.window > 0 && j0 <= i0 + kB - 1 - a.window);
}

// ================================================================ bfloat16: tensor cores

template <int HD>
struct Tc {
  static constexpr int kLd = HD + 8;      // a shared row, in bf16 values
  static constexpr int kTile = kB * kLd;  // a shared tile, in bf16 values
};

// the bf16 build at (HD, HDV) below 192: one head dim for q/k and v
template <int HD, int HDV>
struct Plan {
  static_assert(HD == HDV && HD <= 128, "the mma.sync build takes one head dim up to 128");
  static constexpr int kTq = Tc<HD>::kTile, kTv = Tc<HDV>::kTile;
  // bytes: dq's q and dO, K and V twice; dk/dv's K and V, each set's q and
  // dO twice and with each q tile its lse and D
  static constexpr int kSmemDq = (kTq + kTv + 2 * (kTq + kTv)) * 2;
  static constexpr int kSmemDkdv = (2 + 4 * kSets) * kTq * 2 + 4 * kSets * kB * 4;
  static constexpr int kDkdvThreads = kSets * kTcThreads;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// rows [r0, r0 + 64) of a (B, S, heads, HD) bf16 tensor at `base` (its batch
// and head applied) into a shared tile of rows of kLd, zero past row n, by
// threads tid of nthr
template <int HD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* base, int64_t ss, int r0, int n, int tid,
                                          int nthr) {
  constexpr int kChunks = HD / 8;  // 16-byte copies a row
  for (int e = tid; e < kB * kChunks; e += nthr) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * Tc<HD>::kLd + c, in ? base + (r0 + r) * ss + c : base, in);
  }
}

// lse and D of rows [r0, r0 + 64) of one head (`row` points at its row 0),
// zero past Sq: threads tid 0-63 copy lse, 64-127 D
__device__ __forceinline__ void copy_rows(float* ls, float* dd, const BwdArgs& a, int64_t row, int r0, int tid) {
  const int t = tid % kB;
  const bool in = r0 + t < a.sq;
  if (tid < kB) {
    cp_async4(ls + t, in ? a.lse + row + r0 + t : a.lse, in);
  } else {
    cp_async4(dd + t, in ? a.dsum + row + r0 + t : a.dsum, in);
  }
}

// launch 1 (bf16): D_i, 16 threads a row, 16-byte chunks l, l + 16, ... of
// o and dO a thread (one at HDV up to 128), the xor tree over the 16
template <int HDV>
__global__ void __launch_bounds__(kThreads) fa_bwd_dot_bf16(BwdArgs a) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.h * a.sq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 16) + threadIdx.x / 16;
  const int l = threadIdx.x % 16;
  float sum = 0.0f;
  if (row < rows) {
    const int i = static_cast<int>(row % a.sq), head = static_cast<int>(row / a.sq % a.h);
    const int b = static_cast<int>(row / (static_cast<int64_t>(a.sq) * a.h));
    const bf16* o = static_cast<const bf16*>(a.o) + b * a.o_sb + i * a.o_ss + head * a.o_sh;
    const bf16* g = static_cast<const bf16*>(a.dout) + b * a.d_sb + i * a.d_ss + head * a.d_sh;
    for (int c = l; c < HDV / 8; c += 16) {
      float ov[8], gv[8];
      rt::unpack(__ldg(reinterpret_cast<const uint4*>(o + 8 * c)), ov);
      rt::unpack(__ldg(reinterpret_cast<const uint4*>(g + 8 * c)), gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = fmaf(ov[e], gv[e], sum);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (l == 0 && row < rows) a.dsum[row] = sum;  // row = (b H + head) Sq + i
}

// One q tile against the block's key tile in the dk/dv pass: warp w of a set
// owns keys 16 w .. 16 w + 15 of the tile, the rows of S^T and dP^T.
template <int HD>
__device__ __forceinline__ void dkdv_tile(const BwdArgs& a, const bf16* ks, const bf16* vs, const bf16* qs,
                                          const bf16* dos, const float* ls, const float* dd, int i0, int j0,
                                          float (&dk)[HD / 8][4], float (&dv)[HD / 8][4]) {
  constexpr int LD = Tc<HD>::kLd, NK = HD / 16;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool edge = crosses_mask(a, i0, j0);
  const float sl2 = a.scale * kLog2e;
  const bf16* kw = ks + 16 * warp * LD;
  const bf16* vw = vs + 16 * warp * LD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c0 = 32 * half;  // the half's first q row in the tile
    float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ka[4], va[4];
      ldsm4(ka, kw + row_a(lane) * LD + 16 * kk + col_a(lane));
      ldsm4(va, vw + row_a(lane) * LD + 16 * kk + col_a(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t qb[4], ob[4];
        const int off = (c0 + 16 * np + row_b(lane)) * LD + 16 * kk + col_b(lane);
        ldsm4(qb, qs + off);
        ldsm4(ob, dos + off);
        mma(st[2 * np], ka, qb[0], qb[1]);
        mma(st[2 * np + 1], ka, qb[2], qb[3]);
        mma(dpt[2 * np], va, ob[0], ob[1]);
        mma(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }
    // P^T and dS^T (keys x the half's 32 q rows) as bf16 A fragments: the
    // accumulator of column tile nt is half of k chunk nt / 2
    uint32_t pa[2][4], sa[2][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float p[4], d[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = c0 + 8 * nt + 2 * t + (r & 1);  // the q row in the tile
        float pv = exp2f(st[nt][r] * sl2 - ls[col] * kLog2e);
        if (edge && !visible(a, i0 + col, j0 + 16 * warp + g + 8 * (r >> 1))) pv = 0.0f;
        p[r] = pv;
        d[r] = pv * (dpt[nt][r] - dd[col]);
      }
      const int kc = nt / 2, x = (nt % 2) * 2;
      pa[kc][x] = rt::pack2_bf16(p[0], p[1]);
      pa[kc][x + 1] = rt::pack2_bf16(p[2], p[3]);
      sa[kc][x] = rt::pack2_bf16(d[0], d[1]);
      sa[kc][x + 1] = rt::pack2_bf16(d[2], d[3]);
    }
    // dv += P^T dO, dk += dS^T q over the half's q rows
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
#pragma unroll
      for (int np = 0; np < NK; ++np) {
        uint32_t ob[4], qb[4];
        const int off = (c0 + 16 * kc + row_a(lane)) * LD + 16 * np + col_a(lane);
        ldsm4t(ob, dos + off);
        ldsm4t(qb, qs + off);
        mma(dv[2 * np], pa[kc], ob[0], ob[1]);
        mma(dv[2 * np + 1], pa[kc], ob[2], ob[3]);
        mma(dk[2 * np], sa[kc], qb[0], qb[1]);
        mma(dk[2 * np + 1], sa[kc], qb[2], qb[3]);
      }
    }
  }
}

// a warp's 16 rows x 8 NT columns accumulator, times `mul`, as bf16 pairs
// at rows r0 + 16 w + g (+ 8) below n (w the warp of a set of 4)
template <int NT>
__device__ __forceinline__ void store_acc(bf16* base, int64_t ss, int r0, int n, const float (&acc)[NT][4],
                                          float mul) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + 16 * warp + g + 8 * u;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(base + r * ss + 8 * nt + 2 * t) =
          rt::pack2_bf16(acc[nt][2 * u] * mul, acc[nt][2 * u + 1] * mul);
  }
}

// launch 2 (bf16): dk and dv of 64 keys of one KV head. The block's steps
// are (q head of the group, q tile) pairs in order; set z of its two sets of
// 4 warps takes steps z, z + 2, ..., each with its own double-buffered q,
// dO, lse and D, so the heaviest key tile takes half as long; at the end set
// 1's sums are added to set 0's, in that order.
template <int HD>
__global__ void __launch_bounds__(kSets * kTcThreads, 1) fa_bwd_dkdv_mma(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = Tc<HD>::kTile;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T;
  bf16* qs = vs + T;               // [2 buffers][kSets][T]
  bf16* dos = qs + 2 * kSets * T;  // [2][kSets][T]
  float* ls = reinterpret_cast<float*>(dos + 2 * kSets * T);  // [2][kSets][kB]
  float* dd = ls + 2 * kSets * kB;                            // [2][kSets][kB]
  const int nb = a.kv * a.batch;
  const int* e = a.kplan + 3 * (blockIdx.x / nb);
  const int kvh = blockIdx.x % a.kv, b = blockIdx.x % nb / a.kv;
  const int j0 = e[0] * kB, q_begin = e[1], q_end = e[2];
  const int group = a.h / a.kv;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kB - 1) / kB : 0;
  const int steps = group * n_qt, rounds = (steps + kSets - 1) / kSets;
  const int set = threadIdx.x / kTcThreads, tid = threadIdx.x % kTcThreads;
  copy_tile<HD>(ks, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh, a.k_ss, j0, a.sk, threadIdx.x,
                kSets * kTcThreads);
  copy_tile<HD>(vs, static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.v_ss, j0, a.sk, threadIdx.x,
                kSets * kTcThreads);
  // the set's step of round p: q head kvh * group + s / n_qt, q rows from
  // q_begin + (s % n_qt) 64, into buffer buf
  auto copy_step = [&](int p, int buf) {
    const int s = kSets * p + set;
    if (s >= steps) return;
    const int head = kvh * group + s / n_qt, i0 = q_begin + s % n_qt * kB, at = buf * kSets + set;
    copy_tile<HD>(qs + at * T, static_cast<const bf16*>(a.q) + b * a.q_sb + head * a.q_sh, a.q_ss, i0, a.sq,
                  tid, kTcThreads);
    copy_tile<HD>(dos + at * T, static_cast<const bf16*>(a.dout) + b * a.d_sb + head * a.d_sh, a.d_ss, i0,
                  a.sq, tid, kTcThreads);
    copy_rows(ls + at * kB, dd + at * kB, a, (static_cast<int64_t>(b) * a.h + head) * a.sq, i0, tid);
  };
  if (rounds > 0) copy_step(0, 0);
  cp_commit();
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  for (int p = 0; p < rounds; ++p) {
    const int buf = p % 2, s = kSets * p + set, at = buf * kSets + set;
    if (p + 1 < rounds) {
      copy_step(p + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // round p's tiles have landed for every thread
    if (s < steps)
      dkdv_tile<HD>(a, ks, vs, qs + at * T, dos + at * T, ls + at * kB, dd + at * kB, q_begin + s % n_qt * kB,
                    j0, dk, dv);
    __syncthreads();  // every warp is done with buf before round p + 2's copies into it
  }
  cp_wait<0>();
  __syncthreads();  // no copy lands in the q and dO buffers any more
  // set 1's sums through shared memory (the q and dO buffers), added to set 0's
  float* red = reinterpret_cast<float*>(qs);
  constexpr int kAcc = HD / 8 * 4;
  if (set == 1) {
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        red[(nt * 4 + r) * kTcThreads + tid] = dk[nt][r];
        red[(kAcc + nt * 4 + r) * kTcThreads + tid] = dv[nt][r];
      }
  }
  __syncthreads();
  if (set == 0) {
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dk[nt][r] += red[(nt * 4 + r) * kTcThreads + tid];
        dv[nt][r] += red[(kAcc + nt * 4 + r) * kTcThreads + tid];
      }
    store_acc(static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh, a.dk_ss, j0, a.sk, dk, a.scale);
    store_acc(static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh, a.dv_ss, j0, a.sk, dv, 1.0f);
  }
}

// One K/V tile against the block's q tile in the dq pass: warp w owns q rows
// 16 w .. 16 w + 15 of the tile; l2 and dd are the log2-scaled lse and D of
// the thread's rows g and g + 8.
template <int HD, int HDV>
__device__ __forceinline__ void dq_tile(const BwdArgs& a, const bf16* qs, const bf16* dos, const bf16* ks,
                                        const bf16* vs, const float (&l2)[2], const float (&dd)[2], int i0,
                                        int j0, float (&dq)[HD / 8][4]) {
  constexpr int LQ = Tc<HD>::kLd, LV = Tc<HDV>::kLd, NQ = HD / 16;
  constexpr int NT = kB / 8;  // the tile's 8-column tiles of keys
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool edge = crosses_mask(a, i0, j0);
  const float sl2 = a.scale * kLog2e;
  float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < NQ; ++kk) {
    uint32_t qa[4];
    ldsm4(qa, qs + (16 * warp + row_a(lane)) * LQ + 16 * kk + col_a(lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kb[4];
      ldsm4(kb, ks + (16 * np + row_b(lane)) * LQ + 16 * kk + col_b(lane));
      mma(s[2 * np], qa, kb[0], kb[1]);
      mma(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < HDV / 16; ++kk) {
    uint32_t oa[4];
    ldsm4(oa, dos + (16 * warp + row_a(lane)) * LV + 16 * kk + col_a(lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t vb[4];
      ldsm4(vb, vs + (16 * np + row_b(lane)) * LV + 16 * kk + col_b(lane));
      mma(dp[2 * np], oa, vb[0], vb[1]);
      mma(dp[2 * np + 1], oa, vb[2], vb[3]);
    }
  }
  uint32_t sa[NT / 2][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float d[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = r / 2;
      float pv = exp2f(s[nt][r] * sl2 - l2[u]);
      if (edge && !visible(a, i0 + 16 * warp + g + 8 * u, j0 + 8 * nt + 2 * t + (r & 1))) pv = 0.0f;
      d[r] = pv * (dp[nt][r] - dd[u]);
    }
    const int kc = nt / 2, x = (nt % 2) * 2;
    sa[kc][x] = rt::pack2_bf16(d[0], d[1]);
    sa[kc][x + 1] = rt::pack2_bf16(d[2], d[3]);
  }
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
    for (int np = 0; np < NQ; ++np) {
      uint32_t kb[4];
      ldsm4t(kb, ks + (16 * kc + row_a(lane)) * LQ + 16 * np + col_a(lane));
      mma(dq[2 * np], sa[kc], kb[0], kb[1]);
      mma(dq[2 * np + 1], sa[kc], kb[2], kb[3]);
    }
  }
}

// launch 3 (bf16): dq of 64 q rows of one q head; K and V double-buffered
template <int HD, int HDV>
__global__ void __launch_bounds__(kTcThreads, 2) fa_bwd_dq_mma(BwdArgs a) {
  using Pl = Plan<HD, HDV>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TQ = Pl::kTq, TV = Pl::kTv;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + TQ;
  bf16* ks = dos + TV;      // [2][TQ]
  bf16* vs = ks + 2 * TQ;   // [2][TV]
  const int nb = a.h * a.batch;
  const int* e = a.qplan + 3 * (blockIdx.x / nb);
  const int head = blockIdx.x % a.h, b = blockIdx.x % nb / a.h;
  const int kvh = head / (a.h / a.kv);
  const int i0 = e[0] * kB, k_begin = e[1], k_end = e[2];
  const int steps = k_end > k_begin ? (k_end - k_begin + kB - 1) / kB : 0;
  copy_tile<HD>(qs, static_cast<const bf16*>(a.q) + b * a.q_sb + head * a.q_sh, a.q_ss, i0, a.sq, threadIdx.x,
                kTcThreads);
  copy_tile<HDV>(dos, static_cast<const bf16*>(a.dout) + b * a.d_sb + head * a.d_sh, a.d_ss, i0, a.sq,
                 threadIdx.x, kTcThreads);
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto copy_step = [&](int s, int buf) {
    copy_tile<HD>(ks + buf * TQ, kb, a.k_ss, k_begin + s * kB, a.sk, threadIdx.x, kTcThreads);
    copy_tile<HDV>(vs + buf * TV, vb, a.v_ss, k_begin + s * kB, a.sk, threadIdx.x, kTcThreads);
  };
  if (steps > 0) copy_step(0, 0);
  cp_commit();
  // the log2-scaled lse and D of the thread's rows (+inf lse: P = 0)
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  const int64_t row0 = (static_cast<int64_t>(b) * a.h + head) * a.sq;
  float l2[2], dd[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = i0 + 16 * warp + g + 8 * u;
    l2[u] = r < a.sq ? a.lse[row0 + r] * kLog2e : 0.0f;
    dd[u] = r < a.sq ? a.dsum[row0 + r] : 0.0f;
  }
  float dq[HD / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    const int buf = s % 2;
    if (s + 1 < steps) {
      copy_step(s + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    dq_tile<HD, HDV>(a, qs, dos, ks + buf * TQ, vs + buf * TV, l2, dd, i0, k_begin + s * kB, dq);
    __syncthreads();
  }
  cp_wait<0>();
  store_acc(static_cast<bf16*>(a.dq) + b * a.dq_sb + head * a.dq_sh, a.dq_ss, i0, a.sq, dq, a.scale);
}

template <int HD, int HDV>
cudaError_t launch_tc(const BwdArgs& a, cudaStream_t st) {
  using Pl = Plan<HD, HDV>;
  constexpr int smem_dkdv = Pl::kSmemDkdv, smem_dq = Pl::kSmemDq;
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fa_bwd_dq_mma<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return e;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.h * a.sq;
  fa_bwd_dot_bf16<HDV><<<static_cast<unsigned>((rows + kThreads / 16 - 1) / (kThreads / 16)), kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_kt = (a.sk + kB - 1) / kB, n_qt = (a.sq + kB - 1) / kB;
  if (n_kt > 0) {
    const unsigned blocks = static_cast<unsigned>(n_kt * a.kv * a.batch);
    fa_bwd_dkdv_mma<HD><<<blocks, Pl::kDkdvThreads, smem_dkdv, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  fa_bwd_dq_mma<HD, HDV><<<static_cast<unsigned>(n_qt * a.h * a.batch), kTcThreads, smem_dq, st>>>(a);
  return cudaGetLastError();
}

// ================================================================ float32: SIMT

// rows [r0, r0 + 64) of a (B, S, heads, W) tensor at (batch b, head) into
// a shared [64][W + 1] f32 tile, zero past `n` rows
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const void* src, int64_t sb, int64_t ss, int64_t sh,
                                          int b, int head, int r0, int n) {
  const float* base = static_cast<const float*>(src) + b * sb + head * sh;
  for (int e = threadIdx.x; e < kB * W; e += kThreads) {
    const int r = e / W, d = e % W;
    dst[r * (W + 1) + d] = r0 + r < n ? base[(r0 + r) * ss + d] : 0.0f;
  }
}

// the tile's P and dS into shared [64][65] arrays: s from qs and ks (rows of
// HD + 1), dO.v from dos and vs (rows of HDV + 1)
template <int HD, int HDV>
__device__ __forceinline__ void tile_p_ds(const BwdArgs& a, const float* qs, const float* ks, const float* dos,
                                          const float* vs, const float* lse, const float* dd, float* ps,
                                          float* dss, int i0, int j0) {
  constexpr int PQ = HD + 1, PV = HDV + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      qv[u] = qs[(ty + 16 * u) * PQ + d];
      kv[u] = ks[(tx + 16 * u) * PQ + d];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = fmaf(qv[u], kv[w], s[u][w]);
  }
#pragma unroll 4
  for (int d = 0; d < HDV; ++d) {
    float ov[4], vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ov[u] = dos[(ty + 16 * u) * PV + d];
      vv[u] = vs[(tx + 16 * u) * PV + d];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) dp[u][w] = fmaf(ov[u], vv[w], dp[u][w]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int c = tx + 16 * w;
      const float p = visible(a, i0 + r, j0 + c) ? expf(s[u][w] * a.scale - lse[r]) : 0.0f;
      ps[r * (kB + 1) + c] = p;
      dss[r * (kB + 1) + c] = p * (dp[u][w] - dd[r]);
    }
  }
}

template <int W>
__device__ __forceinline__ void store_rows(void* dst, int64_t sb, int64_t ss, int64_t sh, int b, int head, int r0,
                                           int n, const float (&acc)[4][W / 16], float mul) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* base = static_cast<float*>(dst) + b * sb + head * sh;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= n) continue;
#pragma unroll
    for (int w = 0; w < W / 16; ++w) base[r * ss + tx + 16 * w] = acc[u][w] * mul;
  }
}

// q and k tiles of rows HD + 1, v and dO of HDV + 1, P and dS, lse and D
template <int HD, int HDV>
constexpr int simt_smem_floats() {
  return 2 * kB * (HD + 1) + 2 * kB * (HDV + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

// launch 1 (f32): D_i, a warp a row
__global__ void __launch_bounds__(kThreads) fa_bwd_dot(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.batch) * a.h * a.sq) return;
  const int i = static_cast<int>(row % a.sq), head = static_cast<int>(row / a.sq % a.h);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.sq) * a.h));
  const float* o = static_cast<const float*>(a.o) + b * a.o_sb + i * a.o_ss + head * a.o_sh;
  const float* g = static_cast<const float*>(a.dout) + b * a.d_sb + i * a.d_ss + head * a.d_sh;
  float sum = 0.0f;
  for (int d = lane; d < a.hd_v; d += 32) sum = fmaf(o[d], g[d], sum);
  sum = rt::warp_sum(sum);
  if (lane == 0) a.dsum[row] = sum;  // row = (b H + head) Sq + i
}

// launch 2 (f32): K and V's tiles in shared memory; the block walks the
// group's q heads in order and, for each, the q tiles that can see its keys
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv(BwdArgs a) {
  extern __shared__ float sm[];
  constexpr int PQ = HD + 1, PV = HDV + 1, NQ = HD / 16, NV = HDV / 16;
  float* ks = sm;
  float* vs = ks + kB * PQ;
  float* qs = vs + kB * PV;
  float* dos = qs + kB * PQ;
  float* ps = dos + kB * PV;
  float* dss = ps + kB * (kB + 1);
  float* lse = dss + kB * (kB + 1);
  float* dd = lse + kB;
  const int j0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int group = a.h / a.kv;
  load_rows<HD>(ks, a.k, a.k_sb, a.k_ss, a.k_sh, b, kvh, j0, a.sk);
  load_rows<HDV>(vs, a.v, a.v_sb, a.v_ss, a.v_sh, b, kvh, j0, a.sk);
  // the q rows that can see a key of this tile
  const int q_begin = a.causal ? j0 / kB * kB : 0;
  const int q_end = a.window > 0 ? min(a.sq, j0 + kB - 1 + a.window) : a.sq;
  float dk[4][NQ] = {}, dv[4][NV] = {};
  for (int hh = 0; hh < group; ++hh) {
    const int head = kvh * group + hh;
    const float* lrow = a.lse + (static_cast<int64_t>(b) * a.h + head) * a.sq;
    const float* drow = a.dsum + (static_cast<int64_t>(b) * a.h + head) * a.sq;
    for (int i0 = q_begin; i0 < q_end; i0 += kB) {
      __syncthreads();  // the previous tile's ps, dss, qs and dos are consumed
      load_rows<HD>(qs, a.q, a.q_sb, a.q_ss, a.q_sh, b, head, i0, a.sq);
      load_rows<HDV>(dos, a.dout, a.d_sb, a.d_ss, a.d_sh, b, head, i0, a.sq);
      if (tid < kB) {
        lse[tid] = i0 + tid < a.sq ? lrow[i0 + tid] : 0.0f;
        dd[tid] = i0 + tid < a.sq ? drow[i0 + tid] : 0.0f;
      }
      __syncthreads();
      tile_p_ds<HD, HDV>(a, qs, ks, dos, vs, lse, dd, ps, dss, i0, j0);
      __syncthreads();
      // dv[j] += sum_i P_ij dO_i, dk[j] += sum_i dS_ij q_i over the tile's rows
#pragma unroll 2
      for (int i = 0; i < kB; ++i) {
        float pv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pv[u] = ps[i * (kB + 1) + ty + 16 * u];
          sv[u] = dss[i * (kB + 1) + ty + 16 * u];
        }
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          const float ov = dos[i * PV + tx + 16 * w];
#pragma unroll
          for (int u = 0; u < 4; ++u) dv[u][w] = fmaf(pv[u], ov, dv[u][w]);
        }
#pragma unroll
        for (int w = 0; w < NQ; ++w) {
          const float qv = qs[i * PQ + tx + 16 * w];
#pragma unroll
          for (int u = 0; u < 4; ++u) dk[u][w] = fmaf(sv[u], qv, dk[u][w]);
        }
      }
    }
  }
  store_rows<HD>(a.dk, a.dk_sb, a.dk_ss, a.dk_sh, b, kvh, j0, a.sk, dk, a.scale);
  store_rows<HDV>(a.dv, a.dv_sb, a.dv_ss, a.dv_sh, b, kvh, j0, a.sk, dv, 1.0f);
}

// launch 3 (f32): q and dO in shared memory; the block walks the K/V tiles
// the rows can see
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq(BwdArgs a) {
  extern __shared__ float sm[];
  constexpr int PQ = HD + 1, PV = HDV + 1, NQ = HD / 16;
  float* qs = sm;
  float* dos = qs + kB * PQ;
  float* ks = dos + kB * PV;
  float* vs = ks + kB * PQ;
  float* ps = vs + kB * PV;
  float* dss = ps + kB * (kB + 1);
  float* lse = dss + kB * (kB + 1);
  float* dd = lse + kB;
  const int i0 = blockIdx.x * kB, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kvh = head / (a.h / a.kv);
  load_rows<HD>(qs, a.q, a.q_sb, a.q_ss, a.q_sh, b, head, i0, a.sq);
  load_rows<HDV>(dos, a.dout, a.d_sb, a.d_ss, a.d_sh, b, head, i0, a.sq);
  if (tid < kB) {
    const int64_t r = (static_cast<int64_t>(b) * a.h + head) * a.sq + i0 + tid;
    lse[tid] = i0 + tid < a.sq ? a.lse[r] : 0.0f;
    dd[tid] = i0 + tid < a.sq ? a.dsum[r] : 0.0f;
  }
  // the keys these rows can see, as the forward's tile plan
  const int k_end = a.causal ? min(a.sk, i0 + kB) : a.sk;
  const int k_begin = a.window > 0 ? max(0, i0 - a.window + 1) / kB * kB : 0;
  float dq[4][NQ] = {};
  for (int j0 = k_begin; j0 < k_end; j0 += kB) {
    __syncthreads();  // the previous tile is consumed (and qs, dos, lse, dd are written)
    load_rows<HD>(ks, a.k, a.k_sb, a.k_ss, a.k_sh, b, kvh, j0, a.sk);
    load_rows<HDV>(vs, a.v, a.v_sb, a.v_ss, a.v_sh, b, kvh, j0, a.sk);
    __syncthreads();
    tile_p_ds<HD, HDV>(a, qs, ks, dos, vs, lse, dd, ps, dss, i0, j0);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float sv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) sv[u] = dss[(ty + 16 * u) * (kB + 1) + j];
#pragma unroll
      for (int w = 0; w < NQ; ++w) {
        const float kv = ks[j * PQ + tx + 16 * w];
#pragma unroll
        for (int u = 0; u < 4; ++u) dq[u][w] = fmaf(sv[u], kv, dq[u][w]);
      }
    }
  }
  store_rows<HD>(a.dq, a.dq_sb, a.dq_ss, a.dq_sh, b, head, i0, a.sq, dq, a.scale);
}

template <int HD, int HDV>
cudaError_t launch_simt(const BwdArgs& a, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * simt_smem_floats<HD, HDV>();
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fa_bwd_dq<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.h * a.sq;
  fa_bwd_dot<<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.sk > 0) {
    fa_bwd_dkdv<HD, HDV><<<dim3((a.sk + kB - 1) / kB, a.kv, a.batch), kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  fa_bwd_dq<HD, HDV><<<dim3((a.sq + kB - 1) / kB, a.h, a.batch), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD, int HDV>
cudaError_t launch_hd(const BwdArgs& a, bool is_bf16, cudaStream_t st) {
  return is_bf16 ? launch_tc<HD, HDV>(a, st) : launch_simt<HD, HDV>(a, st);
}

// bytes of shared memory a block of the build (hd, hd_v) takes: pass 0 the
// dk/dv kernel, 1 the dq kernel; -1 for a pair that is not built
template <int HD, int HDV>
int smem_of(int is_bf16, int pass) {
  if (!is_bf16) return static_cast<int>(sizeof(float)) * simt_smem_floats<HD, HDV>();
  return pass == 0 ? Plan<HD, HDV>::kSmemDkdv : Plan<HD, HDV>::kSmemDq;
}

}  // namespace

// strides: 24 int64 values, the (batch, seq, head) element strides of q, k,
// v, o, dout, dq, dk, dv. lse (batch, h, sq) from the forward; dsum
// (batch, h, sq) f32 scratch. plan (bf16 only, else null): the dk/dv pass's
// ceil(sk / 64) entries then the dq pass's ceil(sq / 64), three int32 each,
// on the card (kernels/flash_attention.py:bwd_plan). (hd, hd_v) one of (16,
// 16), (32, 32), (64, 64), (80, 80), (128, 128), (192, 192), (192, 128)
// (the wrapper zero-pads any other pair up to one of these). bf16 at 192
// takes the wide build, whose dsum is scratch of 2 x (batch, h, sq rounded
// up to 64) f32 (the wrapper allocates it).
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* dsum, const int* plan,
                                      void* dq, void* dk, void* dv, const int64_t* strides, int batch,
                                      int sq, int sk, int h, int kv, int hd, int hd_v, float scale,
                                      int causal, int window, int is_bf16, void* stream) {
  if (batch == 0 || sq == 0 || h == 0) return cudaSuccess;
  if (kv <= 0 || h % kv != 0 || (is_bf16 && plan == nullptr)) return cudaErrorInvalidValue;
  const int64_t* s = strides;
  const int* qplan = plan ? plan + 3 * ((sk + kB - 1) / kB) : nullptr;
  const BwdArgs a{q, k, v, o, dout, lse, dsum, plan, qplan, dq, dk, dv,
                  s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                  s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
                  batch, sq, sk, h, kv, hd, hd_v, scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  if (hd == 192 && (hd_v == 192 || hd_v == 128)) {
    if (bf)
      return flash_bwd_wide_launch(q, k, v, o, dout, lse, dsum, plan, dq, dk, dv, strides, batch, sq, sk, h, kv,
                                   hd, hd_v, scale, causal, window, st);
    return hd_v == 128 ? launch_simt<192, 128>(a, st) : launch_simt<192, 192>(a, st);
  }
  if (hd != hd_v) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_hd<16, 16>(a, bf, st);
    case 32: return launch_hd<32, 32>(a, bf, st);
    case 64: return launch_hd<64, 64>(a, bf, st);
    case 80: return launch_hd<80, 80>(a, bf, st);
    case 128: return launch_hd<128, 128>(a, bf, st);
    default: return cudaErrorInvalidValue;
  }
}

// bytes of shared memory a block of the build (hd, hd_v) in bf16 or f32
// takes, pass 0 the dk/dv kernel and 1 the dq kernel (bf16 at 192: pass 0
// the dk/dv kernel of one consumer, 2 that of two); -1 for a pair that is
// not built (kernels/flash_attention.py:bwd_smem is its twin)
extern "C" int rt_flash_attention_bwd_smem(int hd, int hd_v, int is_bf16, int pass) {
  if (hd == 192 && (hd_v == 192 || hd_v == 128)) {
    if (is_bf16) return flash_bwd_wide_smem(hd, hd_v, pass);
    return static_cast<int>(sizeof(float)) *
           (hd_v == 128 ? simt_smem_floats<192, 128>() : simt_smem_floats<192, 192>());
  }
  if (hd != hd_v) return -1;
  switch (hd) {
    case 16: return smem_of<16, 16>(is_bf16, pass);
    case 32: return smem_of<32, 32>(is_bf16, pass);
    case 64: return smem_of<64, 64>(is_bf16, pass);
    case 80: return smem_of<80, 80>(is_bf16, pass);
    case 128: return smem_of<128, 128>(is_bf16, pass);
    default: return -1;
  }
}
