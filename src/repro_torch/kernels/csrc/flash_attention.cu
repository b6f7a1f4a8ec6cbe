// K5 flash_attention: forward attention with an online softmax and an f32
// accumulator; causal and sliding-window masks; q heads share KV heads (GQA).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (pallas_call at :133). There the TPU walks the KV blocks as the innermost,
// sequential grid axis and carries (m, l, acc) in VMEM scratch; here one
// block owns (batch, q head, tile of query rows) and loops over the KV tiles
// itself, with (m, l, acc) in registers. The KV head of q head h is
// h / (H / KV), read in place: no repeated K/V is materialized.
//
// Bound by operations at the serving path's prompts: 2 * 2 * hd per visible
// (q, k) pair, 34.4 GFLOP for a causal 2048-token prompt at 32 heads of 128,
// 34.8 us at the card's 989 bf16 TFLOP/s. Two kernels, chosen by dtype in
// the C entry (a dispatch by type between two hand-written kernels, not a
// fallback):
//
// * bfloat16 (the serving path): flash_fwd_wg, on the tensor cores.
//   - One block of two warpgroups owns 128 query rows of one q head, 64 rows
//     per warpgroup. S = Q·Kᵀ is wgmma m64n64k16 with Q and K in shared
//     memory; O += P·V is wgmma m64nHDk16 with P from registers and V in
//     shared memory as the transposed (MN-major) B operand, so V stays
//     key-major as stored. Both accumulate in f32. Head dims 16, 32, 64,
//     80 and 128; head dim 192 takes flash_fwd_wide (flash_attention_wide.cu:
//     a producer warp's TMA ring, two consumer warpgroups in turns, v at its
//     own head dim).
//   - Q is loaded once. K and V tiles of 64 keys go through a three-stage
//     ring in shared memory, filled with 16-byte cp.async copies in wgmma's
//     32-byte-swizzle layout (any head dim that is a multiple of 16 fits
//     it: hd 80 takes five 16-column slabs, no zero columns); the loads of
//     tile j + 1 fly while tile j is computed, one barrier per tile.
//   - Iteration j issues S_j and P_{j-1}·V_{j-1} together and runs the
//     softmax of S_j while P_{j-1}·V_{j-1} is in flight, so the exp and
//     the other per-element work overlap the tensor cores.
//   - The softmax runs on the accumulator in registers: scale applied to
//     S in f32 (q is not pre-rounded), the per-element mask only on tiles
//     that cross the causal or window frontier or the end of Sk (masked
//     scores are -inf, so a tile a warpgroup cannot see adds exactly
//     nothing), running max and f32 sum l per row.
//   - P is fed to P·V as two bf16 parts, hi = P truncated to bf16 and
//     lo = bf16(P - hi), so it keeps about 16 bits, as the Pallas kernel's
//     f32 P does. P rounded once to bf16, as FlashAttention does, errs by
//     up to |v| * 2^-9 where the output is a near-cancelling sum, outside
//     the port's bf16 attention tolerance (atol 2e-3); the second product
//     costs half again the tensor-core work. The output is normalised by
//     max(l, 1e-30) and stored as bf16.
//   - Blocks take the q tiles heaviest first, from a plan the host makes
//     (kernels/flash_attention.py:tile_plan): block t reads entry t / (H *
//     B), the q tile and its range of keys. Under a causal mask the last
//     query tiles see the most keys and go first, so the 16 x 32 = 512
//     tiles of a 2048-token qwen3 prompt balance over 132 SMs.
// * float32 (the checks only): flash_fwd_simt, scalar f32 FMAs from shared
//   memory. The tensor cores take f32 only as TF32 (10-bit mantissa),
//   which the f32 tolerance of 2e-5 does not admit.
//
// * any head dim above 192, f32 or bf16: attention_pieces
//   (attention_pieces.cuh), which walks the head dim in pieces of 64 columns
//   with O in shared memory (rt_flash_attention_pieces).
//
// Both kernels mask scores with -inf, so a row with no visible key gets
// zeros (the plain version gives it the mean of V); that cannot happen on
// the serving path, where every row sees its own key. l is clamped at
// 1e-30; the default scale hd^-0.5 is applied by the caller.
//
// Under autograd both kernels also write each row's log-sum-exp of its
// scaled scores, lse = m + log(l) in natural units (+inf for a row that sees
// no key), which flash_attention_bwd.cu reads to form P again; the
// inference path passes no lse buffer and the store is skipped.
#include "attention_pieces.cuh"
#include "common.cuh"
#include "flash_wg.cuh"

namespace {

// ---------------------------------------------------------------- float32: SIMT

constexpr int kSimtBQ = 64;       // query rows per block
constexpr int kSimtBK = 64;       // keys per tile
constexpr int kRowLanes = 4;      // threads per query row
constexpr int kSimtThreads = kSimtBQ * kRowLanes;

template <int HD>
constexpr int simt_smem_floats() {
  return 2 * kSimtBQ * (HD + 1) + kSimtBK * HD + kSimtBQ * (kSimtBK + 1);
}

// Each thread holds a quarter of one query row's scores and output; K and V
// tiles are staged in shared memory. Tiles past the causal frontier or
// before the window are skipped whole; inside a tile the mask is per element.
template <int HD>
__global__ void __launch_bounds__(kSimtThreads) flash_fwd_simt(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int P = HD + 1;          // padded pitch: rows land on distinct banks
  constexpr int PP = kSimtBK + 1;
  constexpr int NS = kSimtBK / kRowLanes;  // scores per thread per tile
  constexpr int NA = HD / kRowLanes;       // output columns per thread
  float* qs = smem;                  // [kSimtBQ][P], scaled query tile
  float* ks = qs + kSimtBQ * P;      // [kSimtBK][P]
  float* vs = ks + kSimtBK * P;      // [kSimtBK][HD]
  float* ps = vs + kSimtBK * HD;     // [kSimtBQ][PP], probabilities of the tile

  const int q_start = blockIdx.x * kSimtBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (a.h / a.kv);
  const int tid = threadIdx.x;
  const int row = tid / kRowLanes;
  const int sub = tid % kRowLanes;
  const int q_pos = q_start + row;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + head * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int i = tid; i < kSimtBQ * HD; i += kSimtThreads) {
    const int r = i / HD, d = i % HD;
    const int p = q_start + r;
    qs[r * P + d] = p < a.sq ? qb[p * a.q_ss + d] * a.scale : 0.0f;
  }

  // KV tiles this query tile can see: up to its last row (causal), from the
  // first key inside the window of its first row.
  int k_end = a.sk;
  if (a.causal) k_end = min(k_end, q_start + kSimtBQ);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q_start - a.window + 1) / kSimtBK * kSimtBK;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kSimtBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kSimtBK * HD; i += kSimtThreads) {
      const int r = i / HD, d = i % HD;
      const int p = k0 + r;
      const bool in = p < a.sk;  // zero past Sk: masked, but 0 * v must stay finite
      ks[r * P + d] = in ? kb[p * a.k_ss + d] : 0.0f;
      vs[r * HD + d] = in ? vb[p * a.v_ss + d] : 0.0f;
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

    // masked scores are -inf: a row that sees no key of the tile adds
    // exactly nothing (m stays at kNegInf, every p is 0)
    const float kInf = __int_as_float(0x7f800000);
    float mx = -kInf;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const int k_pos = k0 + sub + kRowLanes * c;
      bool ok = k_pos < a.sk;
      if (a.causal) ok = ok && k_pos <= q_pos;
      if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
      s[c] = ok ? s[c] : -kInf;
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
    for (int j = 0; j < kSimtBK; ++j) {
      const float p = ps[row * PP + j];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(p, vs[j * HD + sub + kRowLanes * i], acc[i]);
    }
  }

  if (q_pos < a.sq) {
    if (a.lse != nullptr && sub == 0)
      a.lse[(static_cast<int64_t>(b) * a.h + head) * a.sq + q_pos] = l > 0.0f ? m + logf(l) : __int_as_float(0x7f800000);
    const float lc = fmaxf(l, 1e-30f);
    float* ob = static_cast<float*>(a.o) + b * a.o_sb + q_pos * a.o_ss + head * a.o_sh;
#pragma unroll
    for (int i = 0; i < NA; ++i) ob[sub + kRowLanes * i] = acc[i] / lc;
  }
}

template <int HD>
cudaError_t launch_simt(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * simt_smem_floats<HD>();
  static bool attr_set = false;  // above 48 KB only after opting in, once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.sq + kSimtBQ - 1) / kSimtBQ, a.h, a.batch);
  flash_fwd_simt<HD><<<grid, kSimtThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------- bfloat16: tensor cores

constexpr int kWgThreads = 256;  // two warpgroups of 64 query rows each
constexpr int kWgStages = 3;     // K/V tiles in the ring

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Shared tiles in wgmma's 32-byte-swizzle canonical layouts, filled by
// 16-byte cp.async copies. A "slab" is 16 columns (32 bytes) of every row of
// a tile: Q and K are stored slab-major (K-major operands: slab kk is the
// k-step kk of Q·Kᵀ), V likewise (an MN-major operand: slab nb holds
// columns 16nb..16nb+15 of every key). Inside a slab, row r sits at r * 32
// bytes with its two 16-byte halves swapped when bit 2 of r is set (the
// hardware's Swizzle<1,4,3> on the address bits).
template <int HD>
struct WgLayout {
  static constexpr int kQ = kTcBQ * HD * 2;  // bytes
  static constexpr int kKV = kTcBK * HD * 2;
  static constexpr int kBytes = kQ + 2 * kWgStages * kKV + 1024;  // + slack to align the base to 1024
};

__device__ __forceinline__ uint32_t swz32(int row, int half) { return row * 32 + ((half ^ ((row >> 2) & 1)) << 4); }

// rows [row0, row0 + ROWS) of a (·, HD) bf16 array (row stride ss, base
// `src`) into a slab-major swizzled tile; rows at or past `limit` are
// zero-filled. Thread t copies 16-byte chunk t % C of rows t / C, t / C + R,
// ... (C chunks per row, R = threads / C rows per pass), so the addresses
// advance by a constant step.
template <int HD, int ROWS>
__device__ __forceinline__ void load_swz(uint32_t dst, const __nv_bfloat16* src, int64_t ss,
                                         int row0, int limit) {
  constexpr int kChunks = HD / 8;
  constexpr int kRowStep = kWgThreads / kChunks;
  constexpr int kPasses = (ROWS + kRowStep - 1) / kRowStep;
  const int ch = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
  if (r0 >= kRowStep) return;
  const __nv_bfloat16* p = src + (row0 + r0) * ss + ch * 8;
  const uint32_t d = dst + (ch >> 1) * ROWS * 32;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int r = r0 + pass * kRowStep;
    if (ROWS % kRowStep == 0 || r < ROWS) {
      const bool in = row0 + r < limit;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d + swz32(r, ch & 1)),
                   "l"(in ? p : src), "r"(in ? 16 : 0)
                   : "memory");
    }
    p += kRowStep * ss;
  }
}


template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wg(FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int NO = HD / 2;  // accumulator registers of O
  constexpr int ST = kWgStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;  // [HD/16][kTcBQ][16]
  const uint32_t ks = qs + WgLayout<HD>::kQ;  // [ST][HD/16][kTcBK][16]
  const uint32_t vs = ks + ST * WgLayout<HD>::kKV;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warpgroup index, broadcast so that the compiler sees it uniform in the
  // warp (wgmma under a branch it takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = a.scale * kLog2e;

  const int heads = a.h * a.batch;
  const int i = blockIdx.x / heads, hb = blockIdx.x % heads;
  const int head = hb % a.h, b = hb / a.h;
  // the host's plan: the q tile (heaviest first) and the keys it can see;
  // both warpgroups walk all of its K/V tiles, a tile that one cannot see
  // is masked whole. Broadcast like wg: the K/V loop that holds the wgmmas
  // runs on these values.
  const int q_start = __shfl_sync(0xffffffffu, __ldg(a.plan + 3 * i), 0) * kTcBQ;
  const int k_begin = __shfl_sync(0xffffffffu, __ldg(a.plan + 3 * i + 1), 0);
  const int k_end = __shfl_sync(0xffffffffu, __ldg(a.plan + 3 * i + 2), 0);
  const int kvh = head / (a.h / a.kv);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + head * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int n_kt = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;

  load_swz<HD, kTcBQ>(qs, qb, a.q_ss, q_start, a.sq);
  if (n_kt > 0) {
    load_swz<HD, kTcBK>(ks, kb, a.k_ss, k_begin, a.sk);
    load_swz<HD, kTcBK>(vs, vb, a.v_ss, k_begin, a.sk);
  }
  cp_async_commit();

  const int qw = q_start + wg * 64;  // this warpgroup's first row
  const int row0 = qw + (warp % 4) * 16 + g;
  auto edge = [&](int k0) {  // does the tile cross a frontier for this warpgroup's rows?
    return (a.causal && k0 + kTcBK - 1 > qw) || (a.window > 0 && k0 <= qw + 63 - a.window) ||
           k0 + kTcBK > a.sk;
  };
  // tile j is in the ring once iteration j's barrier is passed; iteration j
  // then fetches tile j + 1 into the stage that tile j - 2 left
  auto next_tile = [&](int j) {
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async writes -> wgmma reads
    __syncthreads();
    if (j + 1 < n_kt) {
      const int nx = (j + 1) % ST, k1 = k_begin + (j + 1) * kTcBK;
      load_swz<HD, kTcBK>(ks + nx * WgLayout<HD>::kKV, kb, a.k_ss, k1, a.sk);
      load_swz<HD, kTcBK>(vs + nx * WgLayout<HD>::kKV, vb, a.v_ss, k1, a.sk);
      cp_async_commit();
    }
  };

  float o[NO];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float s[32];                  // S of this warpgroup's 64 rows x 64 keys; n-tile n is s[4n..4n+3]
  uint32_t ph[4][4], pl[4][4];  // P of the previous tile, hi + lo bf16 parts
  float c0, c1;

  if (n_kt > 0) {  // tile 0: S and its softmax
    next_tile(0);
    wg_fence();
    issue_s<HD>(s, qs, ks, wg);
    wg_commit();
    wg_wait0();
    pin(s);
    softmax_tile(s, m0, m1, l0, l1, c0, c1, sl2, edge(k_begin), k_begin, row0, t4, a);
    split_p(s, ph, pl);
  }
  // Iteration j issues S_j = Q·K_jᵀ and O += P_{j-1}·V_{j-1} together and
  // runs the softmax of S_j while the second product is in flight.
  for (int j = 1; j < n_kt; ++j) {
    const int k0 = k_begin + j * kTcBK;
    next_tile(j);
    pin(o);
    wg_fence();
    issue_s<HD>(s, qs, ks + (j % ST) * WgLayout<HD>::kKV, wg);
    wg_commit();
    issue_pv<HD>(o, ph, pl, vs + ((j - 1) % ST) * WgLayout<HD>::kKV);
    wg_commit();
    wg_wait1();  // S_j is done; P_{j-1}·V_{j-1} may still run
    pin(s);
    softmax_tile(s, m0, m1, l0, l1, c0, c1, sl2, edge(k0), k0, row0, t4, a);
    wg_wait0();  // O holds P_{j-1}·V_{j-1}: rescale it to the new max
    pin(o);
    pin(ph);
    pin(pl);
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      o[4 * n] *= c0;
      o[4 * n + 1] *= c0;
      o[4 * n + 2] *= c1;
      o[4 * n + 3] *= c1;
    }
    split_p(s, ph, pl);
  }
  if (n_kt > 0) {  // the last tile's P·V
    pin(o);
    wg_fence();
    issue_pv<HD>(o, ph, pl, vs + ((n_kt - 1) % ST) * WgLayout<HD>::kKV);
    wg_commit();
    wg_wait0();
    pin(o);
    pin(ph);
    pin(pl);
  }
  cp_async_wait_all();

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
      *reinterpret_cast<uint32_t*>(ob + row1 * a.o_ss + n * 8) = pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

template <int HD>
cudaError_t launch_wg(const FlashArgs& a, cudaStream_t stream) {
  constexpr int smem = WgLayout<HD>::kBytes;
  static bool attr_set = false;  // above 48 KB only after opting in, once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wg<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_qt = (a.sq + kTcBQ - 1) / kTcBQ;
  flash_fwd_wg<HD><<<n_qt * a.h * a.batch, kWgThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 int64 values, (batch, seq, head) element strides of q, k, v, o.
// bf16 takes a tensor-core kernel (base pointers and seq/head strides
// 16-byte aligned, checked by the wrapper) and its tile plan on the device,
// ceil(sq / 128) x 3 ints (kernels/flash_attention.py:tile_plan): up to hd
// 128 flash_fwd_wg, at 192 flash_fwd_wide (flash_attention_wide.cu), at v's
// own head dim hd_v of 192 or 128. f32 the SIMT kernel, which takes no plan
// and one head dim for q, k and v. lse: (batch, h, sq) f32 for each row's
// log-sum-exp (autograd's forward), or null.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const int* plan, float* lse, const int64_t* strides, int batch, int sq,
                                  int sk, int h, int kv, int hd, int hd_v, float scale, int causal,
                                  int window, int is_bf16, void* stream) {
  if (batch == 0 || sq == 0 || h == 0) return cudaSuccess;
  if (kv <= 0 || h % kv != 0 || (is_bf16 && plan == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && hd == 192)
    return flash_fwd_wide_launch(q, k, v, o, plan, lse, strides, batch, sq, sk, h, kv, hd, hd_v, scale, causal,
                                 window, s);
  if (hd_v != hd) return cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o, plan, lse,
              strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
              strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
              batch, sq, sk, h, kv, scale, causal, window};
  switch (hd) {
    case 16: return is_bf16 ? launch_wg<16>(a, s) : launch_simt<16>(a, s);
    case 32: return is_bf16 ? launch_wg<32>(a, s) : launch_simt<32>(a, s);
    case 64: return is_bf16 ? launch_wg<64>(a, s) : launch_simt<64>(a, s);
    case 80: return is_bf16 ? launch_wg<80>(a, s) : launch_simt<80>(a, s);
    case 128: return is_bf16 ? launch_wg<128>(a, s) : launch_simt<128>(a, s);
    case 192: return launch_simt<192>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Bytes of shared memory a block of the forward's build at (hd, hd_v) in
// bf16 or f32 takes; -1 for a pair that is not built
// (kernels/flash_attention.py:fwd_smem is its twin).
extern "C" int rt_flash_attention_smem(int hd, int hd_v, int is_bf16) {
  if (is_bf16 && hd == 192) return flash_fwd_wide_smem(hd, hd_v);
  if (hd != hd_v) return -1;
  switch (hd) {
    case 16: return is_bf16 ? WgLayout<16>::kBytes : static_cast<int>(sizeof(float)) * simt_smem_floats<16>();
    case 32: return is_bf16 ? WgLayout<32>::kBytes : static_cast<int>(sizeof(float)) * simt_smem_floats<32>();
    case 64: return is_bf16 ? WgLayout<64>::kBytes : static_cast<int>(sizeof(float)) * simt_smem_floats<64>();
    case 80: return is_bf16 ? WgLayout<80>::kBytes : static_cast<int>(sizeof(float)) * simt_smem_floats<80>();
    case 128: return is_bf16 ? WgLayout<128>::kBytes : static_cast<int>(sizeof(float)) * simt_smem_floats<128>();
    case 192: return static_cast<int>(sizeof(float)) * simt_smem_floats<192>();
    default: return -1;
  }
}

// Head dims above the built ones (any hd): the pieces kernel, f32 or bf16,
// `rows` query positions of one q head per block. strides as
// rt_flash_attention's. cudaErrorInvalidValue where one row does not fit.
extern "C" int rt_flash_attention_pieces(const void* q, const void* k, const void* v, void* o,
                                         const int64_t* strides, int batch, int sq, int sk,
                                         int h, int kv, int hd, float scale, int causal,
                                         int window, int is_bf16, void* stream) {
  if (batch == 0 || sq == 0 || h == 0) return cudaSuccess;
  const int rows = pieces::rows_for(hd);
  if (kv <= 0 || h % kv != 0 || hd < 1 || rows < 1) return cudaErrorInvalidValue;
  pieces::Args a{q, k, v, o,
                 strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
                 sq, sk, h, kv, hd, scale, causal, window, 0, 0, 0, rows};
  const dim3 grid((sq + rows - 1) / rows, h, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pieces::launch<__nv_bfloat16, false>(a, grid, s)
                 : pieces::launch<float, false>(a, grid, s);
}

// Query rows per block of the pieces kernel at head dim hd (0: none fits).
extern "C" int rt_attention_pieces_rows(int hd) { return pieces::rows_for(hd); }
