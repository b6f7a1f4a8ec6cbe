// flash_attention_bwd, bfloat16 at q/k head dim 192 (nemotron-4-340b's
// (192, 192) and deepseek-v2's MLA (192, 128)): the wide build on wgmma,
// reached from rt_flash_attention_bwd (flash_attention_bwd.cu), whose header
// gives the algebra, the plan and the rules every build keeps: two passes
// and no atomics, every sum in an order fixed by the shape (a repeat is
// bitwise), a KV head's GQA group summed inside its dk/dv block, and the
// key-tiles-then-q-tiles plan (kernels/flash_attention.py:bwd_plan).
//
// What bounds it: operations, 2 (4 hd + 3 hd_v) FLOP a visible pair done
// (2 (3 hd + 2 hd_v) needed: the dq pass forms S and dP again), 617 GFLOP
// (624 us at 989 bf16 TFLOP/s) at MLA's causal 2048-token layer.
//
// Three launches:
//   1. fa_bwd_rows_wide: D_i = rowsum(dO o) and lse_i log2 e, a row per 16
//      threads, into two planes of (B, H, Sq rounded up to 128) f32, the rows
//      past Sq given lse +inf (P = 0) and D 0, so that the later passes copy
//      a step's values in one 16-byte-aligned bulk copy and never past the end.
//   2. fa_bwd_dkdv_wide: a block per (64 keys, KV head, batch): a producer
//      warpgroup (24 registers a thread after setmaxnreg) and NC consumer
//      warpgroups. NC is 1 (232 registers, two blocks an SM, one block's
//      first loads and last stores under the other's products) where a KV
//      head has one q head, as MLA's; 2 (240 registers, the block has the
//      SM) where it has a group: its key tiles walk group x their q steps
//      (nemotron's heaviest 768), and the two consumers take the steps in
//      turn, summing at the end through shared memory in a fixed order. The
//      producer's one thread loads the key tile's K and V once by TMA and
//      then, for each step (q head of the group, 32 q rows) in order, that
//      step's q, dO, lse and D into a ring of stages with full and empty
//      mbarriers. A consumer owns the 64 keys:
//      S^T = K·Qᵀ and dP^T = V·dOᵀ as m64n32k16 products over HD and HDV
//      (A and B from shared memory), P^T = exp2(s scale log2 e - lse log2 e)
//      and dS^T = P^T (dP^T - D) in f32 registers, masked per element only on
//      steps that cross a frontier, rounded once to bf16 (BWD_REL) in the
//      accumulator's layout, which is wgmma's register A operand; then dv +=
//      P^T·dO (m64nHDVk16) and dk += dS^T·Q (m64nHDk16) with dO and Q read
//      from the same tiles as MN-major B operands. dk and dv stay in
//      registers (96 + 64 or 96 + 96 a thread); a step of 32 q rows keeps
//      S^T and dP^T at 16 registers each, so they fit beside them, and the
//      consumer's next step's S^T and dP^T fly beside this step's dv and dk.
//   3. fa_bwd_dq_wide: a block per (128 q rows, q head, batch), the
//      forward's tile plan: a producer and two consumers of 64 q rows, one
//      block an SM. The producer loads q, dO, lse and D once and then the K
//      and V of 64 keys a step into a ring both consumers read (K/V bytes
//      half those of a block per 64 rows); a consumer forms S = Q·Kᵀ and
//      dP = dO·Vᵀ (m64n64k16: with A read from shared memory, n32 takes as
//      many bytes as the tensor cores take in its time), dS as above,
//      and dq += dS·K (m64nHDk16, K read again as an MN-major B). Under a
//      causal mask the first consumer issues nothing past its last row.
// Tiles are slab-major in 32-byte swizzle (flash_wg.cuh), written by TMA
// from 4-D tensor maps whose box is one 16-column slab of 32, 64 or 128
// rows; rows past Sq or Sk arrive as zeros. The rings' stages are sized from
// what the block's share of the SM leaves beside its fixed tiles.
#include "flash_wg.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kB = 64;          // keys of a dk/dv block (the plan's key tiles), q rows of a dq consumer
constexpr int kBQ = 128;        // q rows of a dq block (the plan's q tiles): two consumers of kB
constexpr int kStep = 32;       // q rows a dk/dv step
constexpr int kStepDq = 64;     // keys a dq step
constexpr int kDqThreads = 384;    // dq: a producer warpgroup and two consumers sharing the K/V ring
constexpr int kSmemBlock = 232448;  // the most shared memory a block may opt in to
constexpr int kBudget = 115712;     // shared memory a block of two an SM may take (228 KB / 2 less 1 KB)
constexpr int kBars = 128;
constexpr int kRowThreads = 256;  // launch 1: 16 rows a block

struct WideBwdArgs {
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, H, Sq)
  float* rows;       // 2 planes of (B, H, sq_pad): lse log2 e, D
  const int* kplan;  // (key tile, first q row, end q row) per dk/dv block order
  const int* qplan;  // (q tile, first key, end key) per dq block order
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t o_sb, o_ss, o_sh;
  int64_t d_sb, d_ss, d_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int batch, sq, sk, h, kv, sq_pad;  // sq_pad: sq rounded up to kBQ
  float scale;
  int causal, window;
};

// NC: the dk/dv block's consumers, taking steps in turn (1: two blocks an
// SM; 2: the block has the SM)
template <int HD, int HDV, int NC = 1>
struct WideBwd {
  static constexpr int kKV = kB * (HD + HDV) * 2;        // the dk/dv block's K and V
  static constexpr int kQO = kBQ * (HD + HDV) * 2;       // the dq block's q and dO
  static constexpr int kPart = kStep * (HD + HDV) * 2;   // a dk/dv step's q and dO
  static constexpr int kPartDq = kStepDq * (HD + HDV) * 2;  // a dq step's K and V
  static constexpr int kRowsDkdv = 2 * kStep * 4;       // a step's lse and D, beside the stage's tiles
  static constexpr int kDkdvThreads = 128 * (1 + NC);
  static constexpr int kStagesDkdv = ((NC == 1 ? kBudget : kSmemBlock) - 1024 - kKV - kBars) / (kPart + kRowsDkdv);
  static constexpr int kSmemDkdv = 1024 + kKV + kStagesDkdv * (kPart + kRowsDkdv) + kBars;
  static constexpr int kStagesDq = (kSmemBlock - 1024 - kQO - 2 * kBQ * 4 - kBars) / kPartDq;
  static constexpr int kSmemDq = 1024 + kQO + 2 * kBQ * 4 + kStagesDq * kPartDq + kBars;
  // a dk/dv consumer waits for step s + NC while it still holds step s - NC's
  // stage (released in step s's turn), the dq consumer for step s + 1
  static_assert(kStagesDkdv >= 2 * NC && kStagesDq >= 2, "the ring is too short for the steps in flight");
  // consumer 1's dk and dv go through the ring at the end
  static_assert(NC == 1 || kStagesDkdv * kPart >= (HD + HDV) / 2 * 128 * 4, "the ring cannot hold the sums");
};

__device__ __forceinline__ bool visible(const WideBwdArgs& a, int i, int j) {
  bool ok = i < a.sq && j < a.sk;
  if (a.causal) ok = ok && j <= i;
  if (a.window > 0) ok = ok && j > i - a.window;
  return ok;
}

// whether some pair of q rows [i0, i0 + ni) and keys [j0, j0 + nj) is masked
__device__ __forceinline__ bool crosses(const WideBwdArgs& a, int i0, int ni, int j0, int nj) {
  return i0 + ni > a.sq || j0 + nj > a.sk || (a.causal && j0 + nj - 1 > i0) ||
         (a.window > 0 && j0 <= i0 + ni - 1 - a.window);
}

// P = exp2(s scale log2 e - lse log2 e), masked, and dS = P (dP - D) for the
// N / 2 values of an m64nN accumulator, element e of n-tile n at row 16 w + g
// + 8 (e / 2), column 8 n + 2 t + e % 2; `l2` and `dd` give the lse log2 e
// and D of (row, column), `vis` whether the pair is visible. P and dS leave as
// the bf16 A fragments of the N / 16 k-steps over the N columns.
template <int N, class L2, class DD, class Vis>
__device__ __forceinline__ void p_ds(const float (&s)[N / 2], const float (&dp)[N / 2], float sl2, bool edge,
                                     L2 l2, DD dd, Vis vis, uint32_t (&pa)[N / 16][4], uint32_t (&sa)[N / 16][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    float p[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      float pv = exp2f(s[4 * n + e] * sl2 - l2(row, col));
      if (edge && !vis(row, col)) pv = 0.0f;
      p[e] = pv;
      d[e] = pv * (dp[4 * n + e] - dd(row, col));
    }
    pa[n / 2][2 * (n % 2)] = pack_bf16(p[0], p[1]);
    pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p[2], p[3]);
    sa[n / 2][2 * (n % 2)] = pack_bf16(d[0], d[1]);
    sa[n / 2][2 * (n % 2) + 1] = pack_bf16(d[2], d[3]);
  }
}

// an m64nN accumulator of the warpgroup, times `mul`, as bf16 pairs at rows
// r0 + 16 w + g (+ 8) below n
template <int N>
__device__ __forceinline__ void store_wg(bf16* base, int64_t ss, int r0, int n, const float (&acc)[N / 2],
                                         float mul) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + 16 * warp + g + 8 * u;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
      *reinterpret_cast<uint32_t*>(base + r * ss + 8 * c + 2 * t) =
          pack_bf16(acc[4 * c + 2 * u] * mul, acc[4 * c + 2 * u + 1] * mul);
  }
}

// launch 1: D and lse log2 e of every row of the padded planes
template <int HDV>
__global__ void __launch_bounds__(kRowThreads) fa_bwd_rows_wide(WideBwdArgs a) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.h * a.sq_pad;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kRowThreads / 16) + threadIdx.x / 16;
  const int l = threadIdx.x % 16;
  const int i = static_cast<int>(row % a.sq_pad);
  const int64_t bh = row / a.sq_pad;
  const bool in = row < rows && i < a.sq;
  float sum = 0.0f;
  if (in) {
    const int head = static_cast<int>(bh % a.h), b = static_cast<int>(bh / a.h);
    const bf16* o = a.o + b * a.o_sb + i * a.o_ss + head * a.o_sh;
    const bf16* g = a.dout + b * a.d_sb + i * a.d_ss + head * a.d_sh;
    for (int c = l; c < HDV / 8; c += 16) {
      const uint4 ou = __ldg(reinterpret_cast<const uint4*>(o + 8 * c));
      const uint4 gu = __ldg(reinterpret_cast<const uint4*>(g + 8 * c));
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ou);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gu);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(op[e]), gf = __bfloat1622float2(gp[e]);
        sum = fmaf(of.x, gf.x, sum);
        sum = fmaf(of.y, gf.y, sum);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (l == 0 && row < rows) {
    a.rows[row] = in ? a.lse[bh * a.sq + i] * kLog2e : __int_as_float(0x7f800000);
    a.rows[rows + row] = sum;
  }
}

// launch 2: dk and dv of 64 keys of one KV head
template <int HD, int HDV, int NC>
__global__ void __launch_bounds__(WideBwd<HD, HDV, NC>::kDkdvThreads, 3 - NC)
    fa_bwd_dkdv_wide(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     WideBwdArgs a) {
  using W = WideBwd<HD, HDV, NC>;
  constexpr int ST = W::kStagesDkdv;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ks = (smem_u32(smem_raw) + 1023) & ~1023u;  // K [HD/16][64][16], then V [HDV/16][64][16]
  const uint32_t vs = ks + kB * HD * 2;
  const uint32_t ring = ks + W::kKV;             // stage s: q [HD/16][32][16], dO [HDV/16][32][16]
  const uint32_t rs = ring + ST * W::kPart;       // stage s: lse log2 e [32], D [32]
  const uint32_t kvbar = rs + ST * W::kRowsDkdv;
  auto full = [&](int s) { return kvbar + 8 + 8 * (s % ST); };
  auto empty = [&](int s) { return kvbar + 8 + 8 * (ST + s % ST); };
  auto stage = [&](int s) { return ring + (s % ST) * W::kPart; };
  auto generic = [&](uint32_t addr) { return smem_raw + (addr - smem_u32(smem_raw)); };

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival from each warp of the consumer that took the step
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int nb = a.kv * a.batch;
  const int* e = a.kplan + 3 * (blockIdx.x / nb);
  const int kvh = blockIdx.x % a.kv, b = blockIdx.x % nb / a.kv;
  const int j0 = __ldg(e) * kB, q_begin = __ldg(e + 1), q_end = __ldg(e + 2);
  const int group = a.h / a.kv;
  const int n_qs = q_end > q_begin ? (q_end - q_begin + kStep - 1) / kStep : 0;
  const int steps = group * n_qs;

  if (wg == 0) {  // the producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect(kvbar, W::kKV);
      tma_tile<HD>(ks, &tk, kvbar, kB, j0, kvh, b);
      tma_tile<HDV>(vs, &tv, kvbar, kB, j0, kvh, b);
      const int64_t plane = static_cast<int64_t>(a.batch) * a.h * a.sq_pad;
      for (int s = 0; s < steps; ++s) {
        if (s >= ST) mbar_wait(empty(s), (s / ST - 1) & 1);
        const int head = kvh * group + s / n_qs, i0 = q_begin + s % n_qs * kStep;
        const int64_t row = (static_cast<int64_t>(b) * a.h + head) * a.sq_pad + i0;
        const uint32_t rw = rs + s % ST * W::kRowsDkdv;
        mbar_expect(full(s), W::kPart + W::kRowsDkdv);
        tma_tile<HD>(stage(s), &tq, full(s), kStep, i0, head, b);
        tma_tile<HDV>(stage(s) + kStep * HD * 2, &tdo, full(s), kStep, i0, head, b);
        bulk_load(rw, a.rows + row, kStep * 4, full(s));
        bulk_load(rw + kStep * 4, a.rows + plane + row, kStep * 4, full(s));
      }
    }
    return;
  }

  regs_inc<(NC == 1 ? 232 : 240)>();
  const int set = wg - 1;  // this consumer takes steps set, set + NC, ...
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const float sl2 = a.scale * kLog2e;
  const int key0 = j0 + 16 * warp;  // this warp's first key
  float dk[HD / 2], dv[HDV / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) dk[n] = 0.0f;
#pragma unroll
  for (int n = 0; n < HDV / 2; ++n) dv[n] = 0.0f;
  pin(dk);  // the zeros in place before any product flies
  pin(dv);
  float st[16], dpt[16];  // S^T and dP^T: the 64 keys x a step's 32 q rows
  uint32_t pa[2][4], sa[2][4];  // P^T and dS^T over a step's two k-steps of 16 q rows, read by dv and dk
  // S^T = K·Qᵀ and dP^T = V·dOᵀ of step s, one commit group
  auto products = [&](int s) {
    const uint32_t qt = stage(s), ot = qt + kStep * HD * 2;
    mbar_wait(full(s), (s / ST) & 1);
    wgmma_ss_n32_first(st, kmajor(ks, kB, 0), kmajor(qt, kStep, 0));
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk) wgmma_ss_n32(st, kmajor(ks, kB, kk), kmajor(qt, kStep, kk), 1);
    wgmma_ss_n32_first(dpt, kmajor(vs, kB, 0), kmajor(ot, kStep, 0));
#pragma unroll
    for (int kk = 1; kk < HDV / 16; ++kk) wgmma_ss_n32(dpt, kmajor(vs, kB, kk), kmajor(ot, kStep, kk), 1);
    wg_commit();
  };
  mbar_wait(kvbar, 0);
  if (set < steps) {
    wg_fence();
    products(set);
  }
  // Step s: its S^T and dP^T are in flight (issued in step s - NC's turn,
  // with that step's dv and dk products); the step forms P^T and dS^T, issues
  // dv += P^T·dO and dk += dS^T·Q, then the consumer's next step's S^T and
  // dP^T, so the products of two steps overlap its elementwise work.
  for (int s = set; s < steps; s += NC) {
    const int i0 = q_begin + s % n_qs * kStep;
    const uint32_t qt = stage(s), ot = qt + kStep * HD * 2;
    const float* l2 = reinterpret_cast<const float*>(generic(rs + s % ST * W::kRowsDkdv));
    const float* dd = l2 + kStep;
    wg_wait0();  // S^T and dP^T of step s, and step s - NC's dv and dk
    pin(st);
    pin(dpt);
    pin(dv);
    pin(dk);
    pin(pa);
    pin(sa);
    if (s >= NC && lane == 0) mbar_arrive(empty(s - NC));  // the warp is done with step s - NC's stage
    const bool edge = crosses(a, i0, kStep, j0, kB);
    p_ds<kStep>(st, dpt, sl2, edge, [&](int, int col) { return l2[col]; }, [&](int, int col) { return dd[col]; },
         [&](int row, int col) { return visible(a, i0 + col, key0 + row); }, pa, sa);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) wgmma_rs<HDV>(dv, pa[kc], mnmajor(ot, kStep, kc));
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) wgmma_rs<HD>(dk, sa[kc], mnmajor(qt, kStep, kc));
    wg_commit();
    if (s + NC < steps) products(s + NC);
  }
  wg_wait0();
  pin(dv);
  pin(dk);
  pin(pa);
  pin(sa);
  if constexpr (NC == 1) {
    store_wg<HD>(a.dk + b * a.dk_sb + kvh * a.dk_sh, a.dk_ss, j0, a.sk, dk, a.scale);
    store_wg<HDV>(a.dv + b * a.dv_sb + kvh * a.dv_sh, a.dv_ss, j0, a.sk, dv, 1.0f);
    return;
  }
  // consumer 1's sums through the ring's shared memory (every step has landed
  // and been taken), added to consumer 0's in that order
  named_sync(1, 256);
  float* red = reinterpret_cast<float*>(generic(ring));
  const int t = threadIdx.x % 128;
  if (set == 1) {
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) red[n * 128 + t] = dk[n];
#pragma unroll
    for (int n = 0; n < HDV / 2; ++n) red[(HD / 2 + n) * 128 + t] = dv[n];
  }
  named_sync(1, 256);
  if (set == 0) {
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) dk[n] += red[n * 128 + t];
#pragma unroll
    for (int n = 0; n < HDV / 2; ++n) dv[n] += red[(HD / 2 + n) * 128 + t];
    store_wg<HD>(a.dk + b * a.dk_sb + kvh * a.dk_sh, a.dk_ss, j0, a.sk, dk, a.scale);
    store_wg<HDV>(a.dv + b * a.dv_sb + kvh * a.dv_sh, a.dv_ss, j0, a.sk, dv, 1.0f);
  }
}

// launch 3: dq of 128 q rows of one q head
template <int HD, int HDV>
__global__ void __launch_bounds__(kDqThreads, 1)
    fa_bwd_dq_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   WideBwdArgs a) {
  using W = WideBwd<HD, HDV>;
  constexpr int ST = W::kStagesDq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;  // q [HD/16][128][16], then dO [HDV/16][128][16]
  const uint32_t os = qs + kBQ * HD * 2;
  const uint32_t ring = qs + W::kQO;           // stage s: K [HD/16][64][16], V [HDV/16][64][16]
  const uint32_t rs = ring + ST * W::kPartDq;  // lse log2 e [128], D [128]
  const uint32_t qbar = rs + 2 * kBQ * 4;
  auto full = [&](int s) { return qbar + 8 + 8 * (s % ST); };
  auto empty = [&](int s) { return qbar + 8 + 8 * (ST + s % ST); };
  auto stage = [&](int s) { return ring + (s % ST) * W::kPartDq; };
  const float* rows = reinterpret_cast<const float*>(smem_raw + (rs - smem_u32(smem_raw)));

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int nb = a.h * a.batch;
  const int* e = a.qplan + 3 * (blockIdx.x / nb);
  const int head = blockIdx.x % a.h, b = blockIdx.x % nb / a.h;
  const int kvh = head / (a.h / a.kv);
  const int i0 = __ldg(e) * kBQ, k_begin = __ldg(e + 1), k_end = __ldg(e + 2);
  const int steps = k_end > k_begin ? (k_end - k_begin + kStepDq - 1) / kStepDq : 0;

  if (wg == 0) {  // the producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      const int64_t row = (static_cast<int64_t>(b) * a.h + head) * a.sq_pad + i0;
      const int64_t plane = static_cast<int64_t>(a.batch) * a.h * a.sq_pad;
      mbar_expect(qbar, W::kQO + 2 * kBQ * 4);
      tma_tile<HD>(qs, &tq, qbar, kBQ, i0, head, b);
      tma_tile<HDV>(os, &tdo, qbar, kBQ, i0, head, b);
      bulk_load(rs, a.rows + row, kBQ * 4, qbar);
      bulk_load(rs + kBQ * 4, a.rows + plane + row, kBQ * 4, qbar);
      for (int s = 0; s < steps; ++s) {
        if (s >= ST) mbar_wait(empty(s), (s / ST - 1) & 1);
        const int k0 = k_begin + s * kStepDq;
        mbar_expect(full(s), W::kPartDq);
        tma_tile<HD>(stage(s), &tk, full(s), kStepDq, k0, kvh, b);
        tma_tile<HDV>(stage(s) + kStepDq * HD * 2, &tv, full(s), kStepDq, k0, kvh, b);
      }
    }
    return;
  }

  regs_inc<240>();
  const int cw = wg - 1;  // this consumer: q rows [64 cw, 64 cw + 64) of the tile
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4;
  const float sl2 = a.scale * kLog2e;
  const int qw = i0 + kB * cw;              // this consumer's first row
  const int row0 = kB * cw + 16 * warp + g;  // this thread's rows in the tile: row0, row0 + 8
  // the steps this consumer can see: under a causal mask none past its last row
  const int n_own = a.causal ? max(0, min(steps, (qw + kB - k_begin + kStepDq - 1) / kStepDq)) : steps;
  const uint32_t qa = qs + kB * cw * 32, oa = os + kB * cw * 32;  // this consumer's rows of q and dO
  float dq[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) dq[n] = 0.0f;
  pin(dq);  // the zeros in place before any product flies
  float sc[kStepDq / 2], dp[kStepDq / 2];  // S and dP: the consumer's 64 q rows x a step's 64 keys
  uint32_t pa[kStepDq / 16][4], sa[kStepDq / 16][4];  // P (unused: dq takes dS only) and dS, read by dq
  // S = Q·Kᵀ and dP = dO·Vᵀ of step s, one commit group
  auto products = [&](int s) {
    const uint32_t kt = stage(s), vt = kt + kStepDq * HD * 2;
    mbar_wait(full(s), (s / ST) & 1);
    wgmma_ss_n64_first(sc, kmajor(qa, kBQ, 0), kmajor(kt, kStepDq, 0));
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk) wgmma_ss_n64(sc, kmajor(qa, kBQ, kk), kmajor(kt, kStepDq, kk), 1);
    wgmma_ss_n64_first(dp, kmajor(oa, kBQ, 0), kmajor(vt, kStepDq, 0));
#pragma unroll
    for (int kk = 1; kk < HDV / 16; ++kk) wgmma_ss_n64(dp, kmajor(oa, kBQ, kk), kmajor(vt, kStepDq, kk), 1);
    wg_commit();
  };
  auto release = [&](int s) {  // the warp is done with step s's stage
    if (lane == 0) mbar_arrive(empty(s));
  };
  mbar_wait(qbar, 0);
  const float l2[2] = {rows[row0], rows[row0 + 8]};
  const float dd[2] = {rows[kBQ + row0], rows[kBQ + row0 + 8]};
  if (n_own > 0) {
    wg_fence();
    products(0);
  }
  // step s's S and dP fly with step s - 1's dq product, as in the dk/dv pass
  for (int s = 0; s < n_own; ++s) {
    const int k0 = k_begin + s * kStepDq;
    const uint32_t kt = stage(s);
    wg_wait0();
    pin(sc);
    pin(dp);
    pin(dq);
    pin(sa);
    if (s >= 1) release(s - 1);
    const bool edge = crosses(a, qw, kB, k0, kStepDq);
    p_ds<kStepDq>(sc, dp, sl2, edge, [&](int row, int) { return l2[row >> 3]; }, [&](int row, int) { return dd[row >> 3]; },
         [&](int row, int col) { return visible(a, qw + 16 * warp + row, k0 + col); }, pa, sa);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < kStepDq / 16; ++kc) wgmma_rs<HD>(dq, sa[kc], mnmajor(kt, kStepDq, kc));
    wg_commit();
    if (s + 1 < n_own) products(s + 1);
  }
  wg_wait0();
  pin(dq);
  pin(sa);
  if (n_own > 0) release(n_own - 1);
  for (int s = n_own; s < steps; ++s) {  // the stages past this consumer's rows
    mbar_wait(full(s), (s / ST) & 1);
    release(s);
  }
  store_wg<HD>(a.dq + b * a.dq_sb + head * a.dq_sh, a.dq_ss, qw, a.sq, dq, a.scale);
}

template <int HD, int HDV, int NC>
cudaError_t set_smem() {
  using W = WideBwd<HD, HDV, NC>;
  static bool attr_set = false;  // above 48 KB only after opting in, once per instantiation
  if (attr_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_wide<HD, HDV, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       W::kSmemDkdv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fa_bwd_dq_wide<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmemDq);
  attr_set = e == cudaSuccess;
  return e;
}

// The dk/dv pass takes two consumers a block where a KV head's group has more
// than one q head: its key tiles then walk group x their q steps, and a
// block's steps are shared by two warpgroups; with no group it takes one
// consumer and two blocks an SM, which overlap one block's first loads and
// last stores with the other's products.
template <int HD, int HDV>
cudaError_t launch_wide(const WideBwdArgs& a, const void* q, const void* k, const void* v,
                        const int64_t* s, cudaStream_t st) {
  const bool two = a.h / a.kv > 1;
  cudaError_t e = two ? set_smem<HD, HDV, 2>() : set_smem<HD, HDV, 1>();
  if (e != cudaSuccess) return e;
  // tensor maps of q, k, v, dO at the two passes' boxes: (batch, seq, head) strides s[0..2] q, s[3..5] k,
  // s[6..8] v, s[12..14] dO
  CUtensorMap q32, q128, k64, v64, do32, do128;
  const bool ok = slab_map(&q32, q, HD, a.sq, a.h, a.batch, s[0], s[1], s[2], kStep) &&
                  slab_map(&q128, q, HD, a.sq, a.h, a.batch, s[0], s[1], s[2], kBQ) &&
                  slab_map(&k64, k, HD, a.sk, a.kv, a.batch, s[3], s[4], s[5], kB) &&
                  slab_map(&v64, v, HDV, a.sk, a.kv, a.batch, s[6], s[7], s[8], kB) &&
                  slab_map(&do32, a.dout, HDV, a.sq, a.h, a.batch, s[12], s[13], s[14], kStep) &&
                  slab_map(&do128, a.dout, HDV, a.sq, a.h, a.batch, s[12], s[13], s[14], kBQ);
  if (!ok) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.h * a.sq_pad;
  fa_bwd_rows_wide<HDV><<<static_cast<unsigned>((rows + kRowThreads / 16 - 1) / (kRowThreads / 16)),
                          kRowThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_kt = (a.sk + kB - 1) / kB, n_qt = (a.sq + kBQ - 1) / kBQ;
  if (n_kt > 0) {
    const unsigned blocks = static_cast<unsigned>(n_kt * a.kv * a.batch);
    if (two)
      fa_bwd_dkdv_wide<HD, HDV, 2><<<blocks, WideBwd<HD, HDV, 2>::kDkdvThreads, WideBwd<HD, HDV, 2>::kSmemDkdv,
                                    st>>>(k64, v64, q32, do32, a);
    else
      fa_bwd_dkdv_wide<HD, HDV, 1><<<blocks, WideBwd<HD, HDV, 1>::kDkdvThreads, WideBwd<HD, HDV, 1>::kSmemDkdv,
                                    st>>>(k64, v64, q32, do32, a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  using W = WideBwd<HD, HDV>;
  fa_bwd_dq_wide<HD, HDV><<<static_cast<unsigned>(n_qt * a.h * a.batch), kDqThreads, W::kSmemDq, st>>>(
      q128, do128, k64, v64, a);
  return cudaGetLastError();
}

}  // namespace

int flash_bwd_wide_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                          const float* lse, float* rows, const int* plan, void* dq, void* dk, void* dv,
                          const int64_t* s, int batch, int sq, int sk, int h, int kv, int hd, int hd_v,
                          float scale, int causal, int window, cudaStream_t stream) {
  const int* qplan = plan + 3 * ((sk + kB - 1) / kB);
  const WideBwdArgs a{static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, rows, plan, qplan,
                      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                      s[9], s[10], s[11], s[12], s[13], s[14], s[15], s[16], s[17],
                      s[18], s[19], s[20], s[21], s[22], s[23],
                      batch, sq, sk, h, kv, (sq + kBQ - 1) / kBQ * kBQ, scale, causal, window};
  if (hd == 192 && hd_v == 192) return launch_wide<192, 192>(a, q, k, v, s, stream);
  if (hd == 192 && hd_v == 128) return launch_wide<192, 128>(a, q, k, v, s, stream);
  return cudaErrorInvalidValue;
}

// pass 0: the dk/dv kernel with one consumer, 1: the dq kernel, 2: the dk/dv
// kernel with two consumers
template <int HD, int HDV>
int smem_of_pass(int pass) {
  return pass == 0 ? WideBwd<HD, HDV, 1>::kSmemDkdv : pass == 1 ? WideBwd<HD, HDV>::kSmemDq
                                                                 : WideBwd<HD, HDV, 2>::kSmemDkdv;
}

int flash_bwd_wide_smem(int hd, int hd_v, int pass) {
  if (pass < 0 || pass > 2) return -1;
  if (hd == 192 && hd_v == 192) return smem_of_pass<192, 192>(pass);
  if (hd == 192 && hd_v == 128) return smem_of_pass<192, 128>(pass);
  return -1;
}
