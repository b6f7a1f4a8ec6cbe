// K5 flash_attention, bfloat16 at q/k head dim 192: flash_fwd_wide<HD, HDV>,
// with v, o at their own head dim HDV (192: nemotron-4-340b; 128:
// deepseek-v2's MLA, q/k nope 128 + rope 64). Replaces, with flash_fwd_wg
// (flash_attention.cu), the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention (pallas_call at :133);
// reached from that file's C entry, rt_flash_attention, for bf16 at hd 192.
//
// What bounds it: operations, 2 (hd + 2 hd_v) FLOP a visible (q, k) pair
// with P's two bf16 parts (below), 240 GFLOP at MLA's causal 2048-token layer
// (128 heads), 243 us at the card's 989 bf16 TFLOP/s.
//
// Why not flash_fwd_wg grown to 192: there Q (48 KB) and a three-stage K/V
// ring (144 KB) allow one block of 8 warps an SM, all 256 threads issue the
// cp.async copies and every tile ends at a __syncthreads, so nothing keeps
// copies in flight apart from the products; and MLA ran it with v
// zero-padded to 192 (route (a)), 22% of the tensor work on zero columns.
// The design here (FlashAttention-3's shape on this card):
//   - A block of three warpgroups, one an SM, walks work items of 128 query
//     rows of one q head: the plan's entries, round by round in snake order,
//     so that the heaviest-first order evens out the blocks. The first
//     warpgroup is the producer: setmaxnreg gives it 24 registers a thread
//     and one thread issues every copy by TMA: an item's Q (HD / 16 slabs of
//     128 rows), then its K and V tiles of 64 keys into a ring of stages in
//     shared memory, each stage with a full and an empty mbarrier. Q has a
//     pair of its own: the next item's Q is loaded once both consumers' last
//     S of an item is done, under their last P·V and stores, and the ring
//     runs on from one item into the next (a block per item left Q's load
//     and the first tiles' latency bare for each item: 457 against 436 µs at
//     nemotron-4-340b's layer on an H100 at 700 W). The other two warpgroups
//     are consumers of 64 query rows each, at 240 registers a thread.
//   - The ring is sized from what is left beside Q: at (192, 128) Q takes
//     48 KB and a stage 24 KB of K plus 16 KB of V, four stages; at (192,
//     192) three stages of 48 KB.
//   - A consumer runs the tile loop of flash_fwd_wg: S_j = Q·K_jᵀ (m64n64k16)
//     issued with O += P_{j-1}·V_{j-1} (m64nHDVk16, P from registers: no zero
//     columns at MLA), the softmax of S_j while the second product runs, then
//     its warps release the stage of V_{j-1} to the producer.
//   - The two consumers take turns at the tensor cores (two named barriers):
//     one issues its products and lets the other issue while it runs its
//     softmax, so the exp and the mask work of one overlap the other's
//     products. Under a causal mask a consumer issues nothing for the tiles
//     past its last row (the first consumer's last tile on the diagonal):
//     they would add exactly nothing.
// Kept from flash_fwd_wg: P as hi + lo bf16 parts (a single rounding errs
// outside ATTN_BF16_TOL), the heaviest-first tile plan (kernels/
// flash_attention.py:tile_plan), the per-element mask only on frontier
// tiles, max(l, 1e-30), zeros for a row that sees no key, and lse = m + log l
// in natural units (+inf for no key) under autograd.
//
// Copies: a 4-D tensor map a tensor (width, seq, heads, batch), box one
// 16-column slab of 64 or 128 rows in 32-byte swizzle, so the tiles land in
// the layout flash_fwd_wg's cp.async copies made and the same wgmma
// descriptors read them; rows past Sq or Sk arrive as zeros.
#include "flash_wg.cuh"

namespace {

constexpr int kWideThreads = 384;  // a producer warpgroup and two consumers
constexpr int kSmemBlock = 232448;  // the most shared memory a block may opt in to

template <int HD, int HDV>
struct WideFwd {
  static constexpr int kQ = kTcBQ * HD * 2;  // bytes
  static constexpr int kK = kTcBK * HD * 2;
  static constexpr int kStage = kK + kTcBK * HDV * 2;
  static constexpr int kBars = 128;  // Q's full and empty barriers, then each stage's
  static constexpr int kStages = (kSmemBlock - 1024 - kQ - kBars) / kStage;
  static constexpr int kBytes = 1024 + kQ + kStages * kStage + kBars;  // 1024: slack to align the base
  static_assert(2 * kStages * 8 + 16 <= kBars, "the barriers do not fit");
};

template <int HD, int HDV>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashArgs a) {
  using bf16 = __nv_bfloat16;
  using L = WideFwd<HD, HDV>;
  constexpr int ST = L::kStages, NO = HDV / 2;  // NO: accumulator registers of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;  // [HD/16][kTcBQ][16]
  const uint32_t ring = qs + L::kQ;                          // stage s: K [HD/16][64][16], V [HDV/16][64][16]
  const uint32_t qfull = ring + ST * L::kStage, qempty = qfull + 8;  // Q's pair of barriers
  // the ring's barriers by the block's running count of K/V tiles u
  auto full = [&](int u) { return qfull + 16 + 8 * (u % ST); };
  auto empty = [&](int u) { return qfull + 16 + 8 * (ST + u % ST); };
  auto k_tile = [&](int u) { return ring + (u % ST) * L::kStage; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warpgroup index, broadcast so that the compiler sees it uniform in the
  // warp (wgmma under a branch it takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);  // one arrival from each consumer warp, after its last S of the item
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block's work items (a q tile of the plan, a head, a batch): round k of
  // gridDim.x items in snake order, rounds alternating the direction, so that
  // the plan's heaviest-first order evens out the blocks.
  const int heads = a.h * a.batch, items = (a.sq + kTcBQ - 1) / kTcBQ * heads;
  auto item = [&](int k) {
    return static_cast<int>(k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
  };
  struct Tile {
    int q_start, k_begin, n_kt, head, b, kvh;
  };
  // item t: the q tile (heaviest first) and the keys it can see. A whole
  // warp reads it broadcast, so that the compiler sees the values uniform in
  // the warp (the consumers' K/V loop holds the wgmmas); the producer's one
  // thread reads it alone (a shuffle needs every lane of the warp).
  auto tile = [&](int t, bool warp_reads) {
    const int i = t / heads, hb = t % heads;
    auto read = [&](int n) {
      const int v = __ldg(a.plan + 3 * i + n);
      return warp_reads ? __shfl_sync(0xffffffffu, v, 0) : v;
    };
    Tile x;
    x.q_start = read(0) * kTcBQ;
    x.k_begin = read(1);
    const int k_end = read(2);
    x.n_kt = k_end > x.k_begin ? (k_end - x.k_begin + kTcBK - 1) / kTcBK : 0;
    x.head = hb % a.h;
    x.b = hb / a.h;
    x.kvh = x.head / (a.h / a.kv);
    return x;
  };

  if (wg == 0) {  // the producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      int u = 0;  // K/V tiles loaded so far
      for (int k = 0; item(k) < items; ++k) {
        const Tile x = tile(item(k), false);
        if (k > 0) mbar_wait(qempty, (k - 1) & 1);  // both consumers' last S of the previous item is done
        mbar_expect(qfull, L::kQ);
        tma_tile<HD>(qs, &tq, qfull, kTcBQ, x.q_start, x.head, x.b);
        for (int j = 0; j < x.n_kt; ++j, ++u) {
          if (u >= ST) mbar_wait(empty(u), (u / ST - 1) & 1);  // the consumers are done with tile u - ST
          const int k0 = x.k_begin + j * kTcBK;
          mbar_expect(full(u), L::kStage);
          tma_tile<HD>(k_tile(u), &tk, full(u), kTcBK, k0, x.kvh, x.b);
          tma_tile<HDV>(k_tile(u) + L::kK, &tv, full(u), kTcBK, k0, x.kvh, x.b);
        }
      }
    }
    return;
  }

  regs_inc<240>();
  const int cw = wg - 1;                    // this consumer: query rows [64 cw, 64 cw + 64) of each q tile
  const int mine = 1 + cw, other = 2 - cw;  // named barriers: this consumer's turn, the other's
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = a.scale * kLog2e;
  float o[NO];
  float s[32];                  // S of this consumer's 64 rows x 64 keys; n-tile n is s[4n..4n+3]
  uint32_t ph[4][4], pl[4][4];  // P of the previous tile, hi + lo bf16 parts
  float c0, c1;
  int base = 0;  // K/V tiles of the block's earlier items
  for (int k = 0; item(k) < items; ++k) {
    const Tile x = tile(item(k), true);
    const int q_start = x.q_start, k_begin = x.k_begin, n_kt = x.n_kt, head = x.head, b = x.b;
    const int qw = q_start + cw * 64;  // this consumer's first row
    const int row0 = qw + (warp % 4) * 16 + g;
    // the tiles this consumer can see: under a causal mask none past its last
    // row (the first consumer's last tile on the diagonal), which would add
    // exactly nothing; it takes their turns without products
    const int n_own = a.causal ? max(0, min(n_kt, (qw + 64 - k_begin + kTcBK - 1) / kTcBK)) : n_kt;
    auto edge = [&](int k0) {  // does the tile cross a frontier for this consumer's rows?
      return (a.causal && k0 + kTcBK - 1 > qw) || (a.window > 0 && k0 <= qw + 63 - a.window) ||
             k0 + kTcBK > a.sk;
    };
    auto release = [&](int j) {  // the warp is done with the item's tile j
      if (lane == 0) mbar_arrive(empty(base + j));
    };
    auto release_q = [&] {  // the warp's last product that reads Q is done
      if (lane == 0) mbar_arrive(qempty);
    };
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    mbar_wait(qfull, k & 1);
    if (n_kt > 0 && cw == 1) named_arrive(1, 256);  // consumer 0 takes the first turn
    if (n_own > 0) {  // tile 0: S and its softmax
      mbar_wait(full(base), (base / ST) & 1);
      named_sync(mine, 256);
      wg_fence();
      issue_s<HD>(s, qs, k_tile(base), cw);
      wg_commit();
      if (cw == 0 || n_kt > 1) named_arrive(other, 256);
      wg_wait0();
      pin(s);
      if (n_own == 1) release_q();
      softmax_tile(s, m0, m1, l0, l1, c0, c1, sl2, edge(k_begin), k_begin, row0, t4, a);
      split_p(s, ph, pl);
    } else {
      release_q();
    }
    // Turn j issues S_j = Q·K_jᵀ and O += P_{j-1}·V_{j-1}, then runs the
    // softmax of S_j while the second product and the other consumer's
    // products run. Each consumer takes n_kt turns; consumer 1 gives its
    // last one to nobody.
    for (int j = 1; j < n_own; ++j) {
      const int k0 = k_begin + j * kTcBK;
      mbar_wait(full(base + j), ((base + j) / ST) & 1);
      named_sync(mine, 256);
      pin(o);
      wg_fence();
      issue_s<HD>(s, qs, k_tile(base + j), cw);
      wg_commit();
      issue_pv<HDV>(o, ph, pl, k_tile(base + j - 1) + L::kK);
      wg_commit();
      if (cw == 0 || j + 1 < n_kt) named_arrive(other, 256);
      wg_wait1();  // S_j is done; P_{j-1}·V_{j-1} may still run
      pin(s);
      if (j == n_own - 1) release_q();
      softmax_tile(s, m0, m1, l0, l1, c0, c1, sl2, edge(k0), k0, row0, t4, a);
      wg_wait0();  // O holds P_{j-1}·V_{j-1}: rescale it to the new max
      pin(o);
      pin(ph);
      pin(pl);
      release(j - 1);
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }
      split_p(s, ph, pl);
    }
    if (n_own > 0) {  // the last seen tile's P·V
      pin(o);
      wg_fence();
      issue_pv<HDV>(o, ph, pl, k_tile(base + n_own - 1) + L::kK);
      wg_commit();
      wg_wait0();
      pin(o);
      pin(ph);
      pin(pl);
      release(n_own - 1);
    }
    for (int j = n_own; j < n_kt; ++j) {  // the turns of tiles past this consumer's rows
      mbar_wait(full(base + j), ((base + j) / ST) & 1);
      named_sync(mine, 256);
      if (cw == 0 || j + 1 < n_kt) named_arrive(other, 256);
      release(j);
    }
    base += n_kt;

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
    bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb + head * a.o_sh + 2 * t4;
    const int row1 = row0 + 8;
    if (a.lse != nullptr && t4 == 0) {  // m is in log2 units of the scaled scores
      const float kLn2 = 0.6931471805599453f, inf = __int_as_float(0x7f800000);
      float* lr = a.lse + (static_cast<int64_t>(b) * a.h + head) * a.sq;
      if (row0 < a.sq) lr[row0] = l0 > 0.0f ? (m0 + log2f(l0)) * kLn2 : inf;
      if (row1 < a.sq) lr[row1] = l1 > 0.0f ? (m1 + log2f(l1)) * kLn2 : inf;
    }
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      if (row0 < a.sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * a.o_ss + n * 8) = pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row1 < a.sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * a.o_ss + n * 8) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// the card's SMs, once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <int HD, int HDV>
cudaError_t launch_wide(const FlashArgs& a, cudaStream_t stream) {
  constexpr int smem = WideFwd<HD, HDV>::kBytes;
  static bool attr_set = false;  // above 48 KB only after opting in, once per instantiation
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_wide<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!slab_map(&tq, a.q, HD, a.sq, a.h, a.batch, a.q_sb, a.q_ss, a.q_sh, kTcBQ) ||
      !slab_map(&tk, a.k, HD, a.sk, a.kv, a.batch, a.k_sb, a.k_ss, a.k_sh, kTcBK) ||
      !slab_map(&tv, a.v, HDV, a.sk, a.kv, a.batch, a.v_sb, a.v_ss, a.v_sh, kTcBK))
    return cudaErrorInvalidValue;
  const int items = (a.sq + kTcBQ - 1) / kTcBQ * a.h * a.batch;
  flash_fwd_wide<HD, HDV><<<min(items, sm_count()), kWideThreads, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

int flash_fwd_wide_launch(const void* q, const void* k, const void* v, void* o, const int* plan, float* lse,
                          const int64_t* strides, int batch, int sq, int sk, int h, int kv, int hd, int hd_v,
                          float scale, int causal, int window, cudaStream_t stream) {
  const FlashArgs a{q, k, v, o, plan, lse,
                    strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                    strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
                    batch, sq, sk, h, kv, scale, causal, window};
  if (hd == 192 && hd_v == 192) return launch_wide<192, 192>(a, stream);
  if (hd == 192 && hd_v == 128) return launch_wide<192, 128>(a, stream);
  return cudaErrorInvalidValue;
}

int flash_fwd_wide_smem(int hd, int hd_v) {
  if (hd == 192 && hd_v == 192) return WideFwd<192, 192>::kBytes;
  if (hd == 192 && hd_v == 128) return WideFwd<192, 128>::kBytes;
  return -1;
}
