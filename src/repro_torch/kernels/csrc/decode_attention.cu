// K6 decode_attention: one query token per sequence against a KV cache of
// (B, S, KV, hd), scalar cache_len, optional window, GQA native.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:
// decode_attention (pallas_call at :111). As there, the q heads of one KV
// head are processed against the same cache rows, so each cache element is
// read once per block. The TPU walks the cache tiles as a sequential grid
// axis; here that walk is split across blocks (flash-decoding): block
// (b * KV + kv head, split, head group) runs the online softmax over its
// own range of positions, and the splits are merged at the end.
//
// Bound by bytes: 2 * cache_len * KV * hd * elem (the valid K and V read
// once), 2.5 us for qwen3-4b's 2048 cached positions. What the design does
// about it:
// * K and V rows are read with 16-byte vector loads straight into
//   registers (8 bf16 or 4 f32 values per thread; a row of hd values takes
//   hd / 8 threads in bf16, 10 at hd 80, 24 at hd 192; f32 rows wider than
//   32 loads, hd 192, take two loads a thread), with no staging in shared
//   memory. A warp holds 32 / GS rows at once (GS: the row's thread count
//   rounded up to a power of two), and each thread issues the loads of U
//   rows of K and of V before it uses the first (U = 8, 4 for head groups
//   of 8), so U * 32 bytes per thread stay in flight.
// * The GB q rows of the block's head group are read with 16-byte loads
//   after the first K and V loads are issued, and held in registers in f32,
//   scaled by scale * log2(e). Each score is reduced with shuffles inside
//   the row's thread group, and the online softmax (running max, sum l)
//   and the P·V sum run in registers; the block's warps merge through
//   shared memory once, at the end.
// * The wrapper's split plan gives each block of 8 warps several
//   64-position tiles (at qwen3-4b's shape, 128 positions: one step of
//   loads) and still fills the card at batch 1
//   (decode_attention.py:split_plan).
// * The merge of the splits runs in the same launch: each block writes its
//   partial (m, l, acc), and the last block of a (batch, KV head, head
//   group) to finish, found through an atomic counter that it resets to 0,
//   merges them and writes the output. The merge reads all splits' (m, l)
//   at once into shared memory, then each column's partial sums, every read
//   issued before the first is used. A second merge kernel measured within
//   noise of this form on the card; one launch saves a launch per layer and
//   decode step.
//
// Valid positions are [max(0, cache_len - window), cache_len) (all below
// cache_len with no window). A block whose range holds no valid position
// contributes nothing (m = -1e30, l = 0); l is clamped at 1e-30, so
// cache_len = 0 gives a zero row. Head dims 16, 32, 64, 80, 128 and 192; q
// heads per KV head in groups of GB = 8, 4, 2 or 1 (the largest that
// divides G; at most 4 at hd 192, where the block's partials of 8 q heads
// would pass the 48 KB of static shared memory). Head dims above 192: the
// pieces kernel (attention_pieces.cuh), one block per (batch, KV head,
// group of q heads) over all the valid positions, no splits
// (rt_decode_attention_pieces).
#include "attention_pieces.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 128;  // decode_attention.py:MAX_SPLITS
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_acc;  // [B*KV*n_hg][splits][GB][hd]
  float* part_ml;   // [B*KV*n_hg][splits][GB][2]: running max (base 2), sum
  int* counters;    // [B*KV*n_hg]: finished splits, reset to 0 by the last
  int64_t q_sb, q_sh;        // q (B, 1, H, hd): batch and head strides
  int64_t k_sb, k_ss, k_sh;  // k cache (B, S, KV, hd)
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh;        // o (B, 1, H, hd)
  int kv, groups;
  int lo, hi;    // valid positions [lo, hi)
  int base;      // lo rounded down to a tile
  int chunk;     // positions per split
  int splits;
  float scale;
};

// the values of one 16-byte load, in f32
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);          // low bf16
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high bf16
  }
}

// the VPT values of a thread's LPT 16-byte loads of one row, in f32
template <typename T, int LPT, int VPT>
__device__ __forceinline__ void unpack_row(const uint4 (&r)[LPT], float (&x)[VPT]) {
  constexpr int kPer = VPT / LPT;
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    float t[kPer];
    unpack(r[l], t);
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[l * kPer + i] = t[i];
  }
}

// The merge of the splits of one (batch, KV head, head group), by all
// threads of the block that finished last: the splits' (m, l) into shared memory, the
// weights 2^(m_s - M) per split and q head, then each output column sums its
// splits with every read issued before the first is used.
template <typename T, int HD, int GB>
__device__ void merge_splits(const DecodeArgs& a, int bkvg, int n_hg) {
  constexpr int kItems = (GB * HD + kThreads - 1) / kThreads;  // columns per thread
  __shared__ float wsm[kMaxSplits * GB];                       // m, then the weight, per (split, q head)
  __shared__ float lsm[kMaxSplits * GB];
  __shared__ float inv_l[GB];
  const int64_t first = static_cast<int64_t>(bkvg) * a.splits;
  for (int i = threadIdx.x; i < a.splits * GB; i += kThreads) {
    wsm[i] = __ldcg(a.part_ml + (first * GB + i) * 2);
    lsm[i] = __ldcg(a.part_ml + (first * GB + i) * 2 + 1);
  }
  __syncthreads();
  if (threadIdx.x < GB) {
    const int gi = threadIdx.x;
    float m = kNegInf;
    for (int sp = 0; sp < a.splits; ++sp) m = fmaxf(m, wsm[sp * GB + gi]);
    float l = 0.0f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float w = exp2f(wsm[sp * GB + gi] - m);
      wsm[sp * GB + gi] = w;
      l += lsm[sp * GB + gi] * w;
    }
    inv_l[gi] = 1.0f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  float acc[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) acc[k] = 0.0f;
  const float* pa = a.part_acc + first * GB * HD;
#pragma unroll 16
  for (int sp = 0; sp < a.splits; ++sp) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < GB * HD) acc[k] = fmaf(wsm[sp * GB + i / HD], __ldcg(pa + sp * GB * HD + i), acc[k]);
    }
  }
  const int bkv = bkvg / n_hg, hg = bkvg % n_hg;
  const int b = bkv / a.kv, kvh = bkv % a.kv;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < GB * HD) {
      const int gi = i / HD, d = i % HD;
      const int head = kvh * a.groups + hg * GB + gi;
      rt::store_f32(static_cast<T*>(a.o) + b * a.o_sb + head * a.o_sh + d, acc[k] * inv_l[gi]);
    }
  }
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads) decode_split(DecodeArgs a) {
  constexpr int LPT = HD * static_cast<int>(sizeof(T)) / 16 > 32 ? 2 : 1;  // loads per thread and row
  constexpr int VPT = LPT * 16 / static_cast<int>(sizeof(T));  // values per thread and row
  constexpr int TPR = HD / VPT;        // threads per cache row
  constexpr int GS = TPR <= 1 ? 1 : TPR <= 2 ? 2 : TPR <= 4 ? 4 : TPR <= 8 ? 8 : TPR <= 16 ? 16 : 32;
  constexpr int RPW = 32 / GS;         // rows a warp holds at once
  constexpr int NG = kWarps * RPW;     // row groups of the block
  constexpr int U = (GB >= 8 ? 4 : 8) / LPT;  // rows per group in flight
  static_assert(HD % VPT == 0 && TPR <= 32, "head dim");
  __shared__ float accs[kWarps][GB][HD];
  __shared__ float mls[kWarps][GB][2];

  const int bkv = blockIdx.x, split = blockIdx.y, hg = blockIdx.z, n_hg = gridDim.z;
  const int b = bkv / a.kv, kvh = bkv % a.kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * RPW + lane / GS;
  const int sub = lane % GS;
  const bool active = sub < TPR;
  const int d0 = sub * VPT;
  const float sl2 = a.scale * kLog2e;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh + d0;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh + d0;
  const int begin = a.base + split * a.chunk;
  const int end = min(a.hi, begin + a.chunk);

  // the K and V rows of one step: U rows per group, all loads issued together
  uint4 kr[U][LPT], vr[U][LPT];
  bool valid[U];
  auto load_step = [&](int p0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + grp + u * NG;
      valid[u] = p < end && p >= a.lo;
      const bool in = valid[u] && active;
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        kr[u][l] = in ? __ldg(reinterpret_cast<const uint4*>(kb + p * a.k_ss) + l) : make_uint4(0, 0, 0, 0);
        vr[u][l] = in ? __ldg(reinterpret_cast<const uint4*>(vb + p * a.v_ss) + l) : make_uint4(0, 0, 0, 0);
      }
    }
  };
  load_step(begin);  // in flight while q is read

  // the GB q rows of the head group, in f32, scaled by scale * log2(e)
  float q[GB][VPT], acc[GB][VPT], m[GB], l[GB];
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (kvh * a.groups + hg * GB) * a.q_sh + d0;
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    uint4 qr[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      qr[l] = active ? __ldg(reinterpret_cast<const uint4*>(qb + gi * a.q_sh) + l) : make_uint4(0, 0, 0, 0);
    unpack_row<T>(qr, q[gi]);
#pragma unroll
    for (int e = 0; e < VPT; ++e) {
      q[gi][e] *= sl2;
      acc[gi][e] = 0.0f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.0f;
  }

  for (int p0 = begin; p0 < end; p0 += NG * U) {  // the same trip count in every lane
    if (p0 != begin) load_step(p0);
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[VPT];
      unpack_row<T>(kr[u], kx);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float x = 0.0f;
#pragma unroll
        for (int e = 0; e < VPT; ++e) x = fmaf(q[gi][e], kx[e], x);
        s[u][gi] = x;
      }
    }
#pragma unroll
    for (int off = GS / 2; off >= 1; off /= 2)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) s[u][gi] += __shfl_xor_sync(0xffffffffu, s[u][gi], off);
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = valid[u] ? fmaxf(mx, s[u][gi]) : mx;
      const float c = exp2f(m[gi] - mx);
      l[gi] *= c;
#pragma unroll
      for (int e = 0; e < VPT; ++e) acc[gi][e] *= c;
      m[gi] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[VPT];
      unpack_row<T>(vr[u], vx);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        const float p = valid[u] ? exp2f(s[u][gi] - m[gi]) : 0.0f;
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < VPT; ++e) acc[gi][e] = fmaf(p, vx[e], acc[gi][e]);
      }
    }
  }

  // merge the warp's row groups (lanes with the same columns), then the warps
#pragma unroll
  for (int off = GS; off < 32; off *= 2) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float ca = exp2f(m[gi] - mn), cb = exp2f(mo - mn);
      l[gi] = l[gi] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < VPT; ++e)
        acc[gi][e] = acc[gi][e] * ca + __shfl_xor_sync(0xffffffffu, acc[gi][e], off) * cb;
      m[gi] = mn;
    }
  }
  if (lane < GS && active) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi)
#pragma unroll
      for (int e = 0; e < VPT; ++e) accs[warp][gi][d0 + e] = acc[gi][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      mls[warp][gi][0] = m[gi];
      mls[warp][gi][1] = l[gi];
    }
  }
  __syncthreads();

  const int bkvg = bkv * n_hg + hg;
  const int64_t slot = static_cast<int64_t>(bkvg) * a.splits + split;
  for (int i = threadIdx.x; i < GB * HD; i += kThreads) {
    const int gi = i / HD, d = i % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, mls[w][gi][0]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(mls[w][gi][0] - mm);
      ll += mls[w][gi][1] * c;
      aa += accs[w][gi][d] * c;
    }
    if (a.splits == 1) {  // the block's range is the whole range: write the row
      const int head = kvh * a.groups + hg * GB + gi;
      rt::store_f32(static_cast<T*>(a.o) + b * a.o_sb + head * a.o_sh + d, aa / fmaxf(ll, 1e-30f));
    } else {
      a.part_acc[(slot * GB + gi) * HD + d] = aa;
      if (d == 0) {
        a.part_ml[(slot * GB + gi) * 2] = mm;
        a.part_ml[(slot * GB + gi) * 2 + 1] = ll;
      }
    }
  }
  if (a.splits == 1) return;

  __shared__ int last;
  __threadfence();  // this block's partials are visible to the block that merges
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counters + bkvg, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_splits<T, HD, GB>(a, bkvg, n_hg);
  if (threadIdx.x == 0) a.counters[bkvg] = 0;  // ready for the next launch
}

template <typename T, int HD, int GB>
cudaError_t launch_gb(const DecodeArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid(batch * a.kv, a.splits, a.groups / GB);
  decode_split<T, HD, GB><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const DecodeArgs& a, int batch, cudaStream_t stream) {
  if constexpr (HD <= 128) {  // accs of 8 q heads at hd 192 would pass 48 KB
    if (a.groups % 8 == 0) return launch_gb<T, HD, 8>(a, batch, stream);
  }
  if (a.groups % 4 == 0) return launch_gb<T, HD, 4>(a, batch, stream);
  if (a.groups % 2 == 0) return launch_gb<T, HD, 2>(a, batch, stream);
  return launch_gb<T, HD, 1>(a, batch, stream);
}

template <typename T>
cudaError_t dispatch_hd(const DecodeArgs& a, int batch, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, batch, stream);
    case 32: return launch_hd<T, 32>(a, batch, stream);
    case 64: return launch_hd<T, 64>(a, batch, stream);
    case 80: return launch_hd<T, 80>(a, batch, stream);
    case 128: return launch_hd<T, 128>(a, batch, stream);
    case 192: return launch_hd<T, 192>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 10 int64 values: q (batch, head), k (batch, seq, head),
// v (batch, seq, head), o (batch, head). part: B*KV*G*splits*(hd + 2)
// floats; counters: B*KV*G ints, 0 on entry and left 0 on exit. K and V
// base pointers and seq/head strides 16-byte aligned (checked by the wrapper).
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   float* part, int* counters, const int64_t* strides,
                                   int batch, int kv, int groups, int hd, int lo, int hi,
                                   int base, int chunk, int splits, float scale, int is_bf16,
                                   void* stream) {
  if (batch == 0 || kv == 0 || groups == 0) return cudaSuccess;
  if (splits < 1 || splits > kMaxSplits || chunk < 1) return cudaErrorInvalidValue;
  float* part_acc = part;
  float* part_ml = part + static_cast<int64_t>(batch) * kv * groups * splits * hd;
  DecodeArgs a{q, k, v, o, part_acc, part_ml, counters,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9],
               kv, groups, lo, hi, base, chunk, splits, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(a, batch, hd, s)
                 : dispatch_hd<float>(a, batch, hd, s);
}

// Head dims above the built ones (any hd): the pieces kernel, f32 or bf16,
// up to 32 q heads of one KV head per block, positions [lo, hi). strides as
// rt_decode_attention's. cudaErrorInvalidValue where one row does not fit.
extern "C" int rt_decode_attention_pieces(const void* q, const void* k, const void* v, void* o,
                                          const int64_t* strides, int batch, int kv,
                                          int groups, int hd, int lo, int hi, float scale,
                                          int is_bf16, void* stream) {
  if (batch == 0 || kv == 0 || groups == 0) return cudaSuccess;
  const int fit = pieces::rows_for(hd);
  const int rows = fit < groups ? fit : groups;
  if (hd < 1 || rows < 1) return cudaErrorInvalidValue;
  // q and o: (batch, head) strides; their seq stride is never read
  pieces::Args a{q, k, v, o,
                 strides[0], 0, strides[1], strides[2], strides[3], strides[4],
                 strides[5], strides[6], strides[7], strides[8], 0, strides[9],
                 1, hi, groups * kv, kv, hd, scale, 0, 0, lo, hi, groups, rows};
  const dim3 grid((groups + rows - 1) / rows, kv, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pieces::launch<__nv_bfloat16, true>(a, grid, s)
                 : pieces::launch<float, true>(a, grid, s);
}
