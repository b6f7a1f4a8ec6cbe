// mlstm_scan, general route: the chunked mLSTM scan at the shapes the
// tensor-core route (mlstm.cu) does not take: a chunk above 64 positions,
// or a width P whose f32 C tile and staged tiles do not fit one block of
// that route's third launch (P above 2816 with bf16 inputs, above 2208
// with f32 ones, and every P above 3072).
//
// Replaces no Pallas kernel: the reference computes the scan in jnp
// (repro/models/xlstm.py:54-135, `mlstm_chunked`, any P and chunk). The
// plain version is kernels/ref.py:mlstm_scan_ref; the arithmetic is
// mlstm.cu's (its header has the formulas), every product an f32 FMA.
//
// What bounds it: the same operations as mlstm.cu (per chunk of L
// positions L(L+1)/2 P MACs for q.k^T and for W.v, L P^2 for C q and for
// the C update), here on the f32 SIMT units (67 TFLOP/s on an H100), and
// the scratch of C q's column-tile partials (P/128 x S x P floats a head)
// written once and read once.
//
// Design: six launches, none carrying state across blocks but through
// device memory, none with atomics, every sum in an order fixed by the
// shape alone, so a call repeats bit for bit.
//   1. mg_gates, a warp per (head, batch): walks the chunks in order,
//      cumf by 32-position warp scans over the whole chunk, the chunk's
//      one stabilizer m' = max(m, max_j src_j) over all its positions,
//      then carry_i, to_end_j, and the chunk's decay, m and m'. A chunk
//      above 64 positions keeps one stabilizer and one clamp
//      max(|den|, exp(-m')): it is never split into sub-chunks.
//   2. mg_w, a block per (64 x 64 tile of W, chunk, head and batch) with
//      the key tile at or below the query tile: q k^T over P in slabs of
//      32 columns, then W_ij = exp(cumf_i + src_j - m') (q_i.k_j)/sqrt(P)
//      for j <= i, into the scratch W (L x L a chunk).
//   3. mg_wv, a block per (64 rows of a chunk, 64 columns of P, head and
//      batch): y_i's intra-chunk numerator sum_j W_ij v_j, over the key
//      tiles up to the row tile's, into y.
//   4. mg_n, a block per (128 columns of n, head and batch), a thread a
//      column: n_{c-1}.q_i over its columns for every position (warp
//      sums, then the 4 warps in order) into the scratch nq, and n_c =
//      decay_c n_{c-1} + sum_j to_end_j k_j. It writes the final n.
//   5. mg_c, a block per (32 rows x 128 columns of C, head and batch), C's
//      tile in registers (16 values a thread): over the chunks in order
//      and over slabs of 32 positions, (C q_i) over the tile's columns
//      into the scratch cq (one partial per column tile: a lane's 16
//      products, then an xor tree over the 8 lanes of a row) and the
//      update sum_j (v_j to_end_j) k_j^T, then C <- decay C + update. It
//      writes the final C.
//   6. mg_y, a block per (position, head and batch): the row sum of W, the
//      column blocks' nq and the column tiles' cq summed in index order,
//      y_i = (y_i + carry_i (C q)_i) / max(|sum_j W_ij + carry_i n.q_i|,
//      exp(-m')).
#include <math_constants.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;    // rows and columns of a W tile (launches 2, 3)
constexpr int kSlab = 32;    // columns of P (launch 2), positions (launches 3, 5) a slab
constexpr int kNCols = 128;  // columns of n a block of launch 4
constexpr int kCRows = 32;   // rows of C a block of launch 5
constexpr int kCCols = 128;  // columns of C a block of launch 5
constexpr int kPos = 4;      // per position: cumf, src, carry, to_end
constexpr int kChunkInfo = 3;  // per chunk: decay, m before, m'

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct GenArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;  // (B, S, nh)
  const float* fg;
  const float* C0;  // (B, nh, P, P) or null
  const float* n0;  // (B, nh, P) or null
  const float* m0;  // (B, nh) or null
  float* y;         // (B, S, nh, P)
  float* C;
  float* n;
  float* m;
  float* pos;       // (B nh, S, kPos)
  float* cinfo;     // (B nh, nc, kChunkInfo)
  float* W;         // (B nh, nc, L, L)
  float* nq;        // (ceil(P / 128), B nh, S)
  float* cq;        // (ceil(P / 128), B nh, S, P)
  int s, nh, p, chunk, nc;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ int chunk_len(const GenArgs& a, int c) { return min(a.chunk, a.s - c * a.chunk); }

// element p of position s of (batch b, head) in a (B, S, nh, P) tensor
__device__ __forceinline__ int64_t at(const GenArgs& a, int b, int s, int head, int p) {
  return ((static_cast<int64_t>(b) * a.s + s) * a.nh + head) * a.p + p;
}

// -- launch 1 ---------------------------------------------------------------------

__global__ void __launch_bounds__(32) mg_gates(GenArgs a) {
  const int bh = blockIdx.x, b = bh / a.nh, head = bh % a.nh, lane = threadIdx.x;
  const float scale = rsqrtf(static_cast<float>(a.p));
  float* pos = a.pos + static_cast<int64_t>(bh) * a.s * kPos;
  float m = a.m0 ? a.m0[bh] : -1e30f;
  for (int c = 0; c < a.nc; ++c) {
    const int s0 = c * a.chunk, lc = chunk_len(a, c);
    // cumf and src over the chunk, 32 positions a pass, and max_j src_j
    float run = 0.0f, mx = -CUDART_INF_F;
    for (int j0 = 0; j0 < lc; j0 += 32) {
      const int j = j0 + lane;
      const int64_t g = (static_cast<int64_t>(b) * a.s + s0 + j) * a.nh + head;
      float cf = j < lc ? log_sigmoid(a.fg[g]) : 0.0f;
      const float iv = j < lc ? a.ig[g] : -CUDART_INF_F;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, cf, o);
        if (lane >= o) cf += t;
      }
      cf += run;
      run = __shfl_sync(0xffffffffu, cf, 31);
      const float sr = iv - cf;
      mx = fmaxf(mx, sr);
      if (j < lc) {
        pos[(s0 + j) * kPos] = cf;
        pos[(s0 + j) * kPos + 1] = sr;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mnew = fmaxf(m, mx), last = run;  // run: cumf at the chunk's last position
    for (int j = lane; j < lc; j += 32) {  // the positions this lane wrote above
      const int64_t g = (static_cast<int64_t>(b) * a.s + s0 + j) * a.nh + head;
      const float cf = pos[(s0 + j) * kPos];
      pos[(s0 + j) * kPos + 2] = expf(cf + m - mnew) * scale;            // carry
      pos[(s0 + j) * kPos + 3] = expf(last - cf + a.ig[g] - mnew);       // to_end
    }
    if (lane == 0) {
      float* ci = a.cinfo + (static_cast<int64_t>(bh) * a.nc + c) * kChunkInfo;
      ci[0] = expf(last + m - mnew);  // decay
      ci[1] = m;
      ci[2] = mnew;
    }
    m = mnew;
  }
  if (lane == 0) a.m[bh] = m;
}

// -- launch 2 ---------------------------------------------------------------------

// A thread of a 256-thread block holds rows ty + 16 u and columns tx + 16 w
// (u, w < 4) of a 64 x 64 tile.
template <typename T>
__global__ void __launch_bounds__(256) mg_w(GenArgs a, int tiles) {
  __shared__ float qs[kTile][kSlab + 1];
  __shared__ float ks[kTile][kSlab + 1];
  const int jt = blockIdx.x % tiles, it = (blockIdx.x / tiles) % tiles, c = blockIdx.x / (tiles * tiles);
  if (jt > it) return;
  const int head = blockIdx.y, b = blockIdx.z, bh = b * a.nh + head;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = c * a.chunk, lc = chunk_len(a, c);
  const int i0 = it * kTile, j0 = jt * kTile;
  if (i0 >= lc) return;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  float acc[4][4] = {};
  for (int d0 = 0; d0 < a.p; d0 += kSlab) {
    __syncthreads();
    for (int e = tid; e < kTile * kSlab; e += 256) {
      const int r = e / kSlab, d = e % kSlab;
      const bool din = d0 + d < a.p;
      qs[r][d] = (i0 + r < lc && din) ? rt::load_f32(q + at(a, b, s0 + i0 + r, head, d0 + d)) : 0.0f;
      ks[r][d] = (j0 + r < lc && din) ? rt::load_f32(k + at(a, b, s0 + j0 + r, head, d0 + d)) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kSlab; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qv[u] = qs[ty + 16 * u][d];
        kv[u] = ks[tx + 16 * u][d];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(qv[u], kv[w], acc[u][w]);
    }
  }
  const float scale = rsqrtf(static_cast<float>(a.p));
  const float* pos = a.pos + (static_cast<int64_t>(bh) * a.s + s0) * kPos;
  const float mnew = a.cinfo[(static_cast<int64_t>(bh) * a.nc + c) * kChunkInfo + 2];
  float* W = a.W + (static_cast<int64_t>(bh) * a.nc + c) * a.chunk * a.chunk;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= lc) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = j0 + tx + 16 * w;
      if (j >= lc) continue;
      W[static_cast<int64_t>(i) * a.chunk + j] =
          j <= i ? expf(pos[i * kPos] + pos[j * kPos + 1] - mnew) * (acc[u][w] * scale) : 0.0f;
    }
  }
}

// -- launch 3 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) mg_wv(GenArgs a, int tiles) {
  __shared__ float ws[kTile][kSlab + 1];
  __shared__ float vs[kSlab][kTile];
  const int it = blockIdx.x % tiles, c = blockIdx.x / tiles;
  const int p0 = blockIdx.y * kTile, bh = blockIdx.z, b = bh / a.nh, head = bh % a.nh;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = c * a.chunk, lc = chunk_len(a, c);
  const int i0 = it * kTile;
  if (i0 >= lc) return;
  const int jend = min(lc, i0 + kTile);  // keys j <= i of the tile's rows
  const T* v = static_cast<const T*>(a.v);
  const float* W = a.W + (static_cast<int64_t>(bh) * a.nc + c) * a.chunk * a.chunk;
  float acc[4][4] = {};
  for (int jb = 0; jb < jend; jb += kSlab) {
    __syncthreads();
    for (int e = tid; e < kTile * kSlab; e += 256) {
      const int r = e / kSlab, j = e % kSlab;
      ws[r][j] = (i0 + r < lc && jb + j <= i0 + r) ? W[static_cast<int64_t>(i0 + r) * a.chunk + jb + j] : 0.0f;
      const int jr = e / kTile, pc = e % kTile;
      vs[jr][pc] = (jb + jr < jend && p0 + pc < a.p) ? rt::load_f32(v + at(a, b, s0 + jb + jr, head, p0 + pc)) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kSlab; ++j) {
      float wv[4], vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wv[u] = ws[ty + 16 * u][j];
        vv[u] = vs[j][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(wv[u], vv[w], acc[u][w]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= lc) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int pc = p0 + tx + 16 * w;
      if (pc < a.p) a.y[at(a, b, s0 + i, head, pc)] = acc[u][w];
    }
  }
}

// -- launch 4 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kNCols) mg_n(GenArgs a) {
  __shared__ float red[kNCols / 32][32];
  const int nb = blockIdx.x, bh = blockIdx.y, b = bh / a.nh, head = bh % a.nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = nb * kNCols + tid;
  const bool col = r < a.p;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const float* pos = a.pos + static_cast<int64_t>(bh) * a.s * kPos;
  float* nq = a.nq + (static_cast<int64_t>(nb) * gridDim.y + bh) * a.s;
  float n = (col && a.n0) ? a.n0[static_cast<int64_t>(bh) * a.p + r] : 0.0f;
  for (int c = 0; c < a.nc; ++c) {
    const int s0 = c * a.chunk, lc = chunk_len(a, c);
    // n_{c-1} . q_i over this block's columns, 32 positions a round
    for (int i0 = 0; i0 < lc; i0 += 32) {
      for (int u = 0; u < 32 && i0 + u < lc; ++u) {
        const float x = col ? n * rt::load_f32(q + at(a, b, s0 + i0 + u, head, r)) : 0.0f;
        const float sum = rt::warp_sum(x);
        if (lane == 0) red[warp][u] = sum;
      }
      __syncthreads();
      if (tid < 32 && i0 + tid < lc) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kNCols / 32; ++w) s += red[w][tid];
        nq[s0 + i0 + tid] = s;
      }
      __syncthreads();
    }
    float dn = 0.0f;
    for (int j = 0; j < lc; ++j)
      dn = fmaf(pos[(s0 + j) * kPos + 3], col ? rt::load_f32(k + at(a, b, s0 + j, head, r)) : 0.0f, dn);
    n = a.cinfo[(static_cast<int64_t>(bh) * a.nc + c) * kChunkInfo] * n + dn;
  }
  if (col) a.n[static_cast<int64_t>(bh) * a.p + r] = n;
}

// -- launch 5 ---------------------------------------------------------------------

// Thread tid holds C's row tid / 8 of the tile and its columns tid % 8 + 8 u
// (u < 16); the 8 lanes of a row are neighbours in one warp.
template <typename T>
__global__ void __launch_bounds__(256) mg_c(GenArgs a) {
  constexpr int kU = kCCols / 8;
  __shared__ float qs[kSlab][kCCols];
  __shared__ float ks[kSlab][kCCols];
  __shared__ float vt[kSlab][kCRows + 1];
  const int p0 = blockIdx.x * kCRows, ct = blockIdx.y, r0 = ct * kCCols, bh = blockIdx.z;
  const int b = bh / a.nh, head = bh % a.nh;
  const int tid = threadIdx.x, pr = tid / 8, cl = tid % 8;
  const bool row = p0 + pr < a.p;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* pos = a.pos + static_cast<int64_t>(bh) * a.s * kPos;
  float* cq = a.cq + (static_cast<int64_t>(ct) * gridDim.z + bh) * a.s * a.p;
  float Cr[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int cc = r0 + cl + 8 * u;
    Cr[u] = (a.C0 && row && cc < a.p) ? a.C0[(static_cast<int64_t>(bh) * a.p + p0 + pr) * a.p + cc] : 0.0f;
  }
  for (int c = 0; c < a.nc; ++c) {
    const int s0 = c * a.chunk, lc = chunk_len(a, c);
    float d[kU] = {};
    for (int jb = 0; jb < lc; jb += kSlab) {
      __syncthreads();
      for (int e = tid; e < kSlab * kCCols; e += 256) {
        const int j = e / kCCols, cc = e % kCCols;
        const bool in = jb + j < lc && r0 + cc < a.p;
        qs[j][cc] = in ? rt::load_f32(q + at(a, b, s0 + jb + j, head, r0 + cc)) : 0.0f;
        ks[j][cc] = in ? rt::load_f32(k + at(a, b, s0 + jb + j, head, r0 + cc)) : 0.0f;
      }
      for (int e = tid; e < kSlab * kCRows; e += 256) {
        const int j = e / kCRows, rr = e % kCRows;
        vt[j][rr] = (jb + j < lc && p0 + rr < a.p)
                        ? rt::load_f32(v + at(a, b, s0 + jb + j, head, p0 + rr)) * pos[(s0 + jb + j) * kPos + 3]
                        : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < kSlab && jb + j < lc; ++j) {
        // (C q_j) over this tile's columns, from C before the chunk's update
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < kU; ++u) part = fmaf(Cr[u], qs[j][cl + 8 * u], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        if (cl == 0 && row) cq[static_cast<int64_t>(s0 + jb + j) * a.p + p0 + pr] = part;
        const float w = vt[j][pr];
#pragma unroll
        for (int u = 0; u < kU; ++u) d[u] = fmaf(w, ks[j][cl + 8 * u], d[u]);
      }
    }
    const float decay = a.cinfo[(static_cast<int64_t>(bh) * a.nc + c) * kChunkInfo];
#pragma unroll
    for (int u = 0; u < kU; ++u) Cr[u] = decay * Cr[u] + d[u];
  }
  if (row) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int cc = r0 + cl + 8 * u;
      if (cc < a.p) a.C[(static_cast<int64_t>(bh) * a.p + p0 + pr) * a.p + cc] = Cr[u];
    }
  }
}

// -- launch 6 ---------------------------------------------------------------------

__global__ void __launch_bounds__(128) mg_y(GenArgs a, int nbn, int nct) {
  __shared__ float sh[2];
  const int s = blockIdx.x, bh = blockIdx.y, b = bh / a.nh, head = bh % a.nh;
  const int tid = threadIdx.x;
  const int c = s / a.chunk, i = s % a.chunk;
  const float* pos = a.pos + (static_cast<int64_t>(bh) * a.s + s) * kPos;
  const float carry = pos[2];
  if (tid < 32) {
    const float* W = a.W + ((static_cast<int64_t>(bh) * a.nc + c) * a.chunk + i) * a.chunk;
    float rw = 0.0f;
    for (int j = tid; j <= i; j += 32) rw += W[j];
    rw = rt::warp_sum(rw);
    if (tid == 0) {
      float nqs = 0.0f;
      for (int nb = 0; nb < nbn; ++nb) nqs += a.nq[(static_cast<int64_t>(nb) * gridDim.y + bh) * a.s + s];
      const float mnew = a.cinfo[(static_cast<int64_t>(bh) * a.nc + c) * kChunkInfo + 2];
      sh[0] = fmaxf(fabsf(rw + carry * nqs), expf(-mnew));
    }
  }
  __syncthreads();
  const float den = sh[0];
  for (int p = tid; p < a.p; p += 128) {
    float cqs = 0.0f;
    for (int ct = 0; ct < nct; ++ct) cqs += a.cq[((static_cast<int64_t>(ct) * gridDim.y + bh) * a.s + s) * a.p + p];
    float* y = a.y + at(a, b, s, head, p);
    *y = (*y + carry * cqs) / den;
  }
}

template <typename T>
int launch(const GenArgs& args, int batch, cudaStream_t st) {
  const int bhs = batch * args.nh, tiles = cdiv(args.chunk, kTile);
  const int nbn = cdiv(args.p, kNCols), nct = cdiv(args.p, kCCols);
  mg_gates<<<bhs, 32, 0, st>>>(args);  // with no chunk it writes the initial m
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (args.nc > 0) {
    mg_w<T><<<dim3(args.nc * tiles * tiles, args.nh, batch), 256, 0, st>>>(args, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    mg_wv<T><<<dim3(args.nc * tiles, cdiv(args.p, kTile), bhs), 256, 0, st>>>(args, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  mg_n<T><<<dim3(nbn, bhs), kNCols, 0, st>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mg_c<T><<<dim3(cdiv(args.p, kCRows), nct, bhs), 256, 0, st>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (args.s > 0) {
    mg_y<<<dim3(args.s, bhs), 128, 0, st>>>(args, nbn, nct);
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

// q, k, v packed (batch, s, nh, p), f32 (is_bf16 = 0) or bf16; ig, fg packed
// (batch, s, nh) f32; C0/n0/m0 null for the zero state; any chunk >= 1 and
// p >= 1. Scratch f32: pos (batch nh, s, 4), cinfo (batch nh, nc, 3), W
// (batch nh, nc, chunk, chunk), nq (ceil(p / 128), batch nh, s), cq
// (ceil(p / 128), batch nh, s, p).
extern "C" int rt_mlstm_scan_general(const void* q, const void* k, const void* v, const float* ig,
                                     const float* fg, const float* C0, const float* n0,
                                     const float* m0, float* y, float* C, float* n, float* m,
                                     float* pos, float* cinfo, float* W, float* nq, float* cq,
                                     int batch, int s, int nh, int p, int chunk, int is_bf16,
                                     void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (p < 1 || s < 0 || chunk < 1) return cudaErrorInvalidValue;
  const GenArgs args{q, k, v, ig, fg, C0, n0, m0, y, C, n, m, pos, cinfo, W, nq, cq,
                     s, nh, p, chunk, cdiv(s, chunk)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(args, batch, st) : launch<float>(args, batch, st);
}
