// K7 ssd_scan: the Mamba2 chunked SSD (state-space dual) scan.
//
// Replaces the Pallas kernel repro/kernels/ssd.py:ssd_scan (pallas_call at
// :90, kernel body _ssd_kernel at :25-69). There the TPU runs the chunks as
// the innermost, sequential grid axis with the (N x P) f32 state in VMEM
// scratch. Per chunk of L positions (cum = inclusive cumsum of dt * a):
//   W[i][j] = exp(cum_i - cum_j) * (C_i . B_j) * dt_j   for j <= i, else 0
//   y_i     = exp(cum_i) * (C_i . h) + sum_j W[i][j] x_j
//   h      <- exp(cum_last) * h + sum_j B_j (x) (x_j * exp(cum_last - cum_j) * dt_j)
// All sums in f32; exp is expf. Outputs: y (B, S, nh, P) f32 and the final
// h (B, nh, N, P) f32; an optional h0 seeds the state.
//
// Ragged length: S need not be a multiple of L. Positions >= S are staged
// as dt = 0 and x = B = C = 0: their decay is exp(0) = 1 and they add
// nothing to W, y or h, so the last, partial chunk gives exactly the
// result of a shorter chunk (y past S is not written). The reference's jnp
// scan instead shrinks the chunk to a divisor of S; the port never does.
//
// Two builds, chosen by the inputs' dtype:
//
// bf16 (the serving path): tensor cores, chunks in parallel. The SSD
// algebra splits the scan into three launches:
//   A ssd_chunk_state, a block per (batch, chunk, head): the chunk's own
//     state s_c = B^T (x * exp(cum_last - cum) * dt) and e_c = exp(cum_last);
//   B ssd_state_pass, the only sequential part, per (batch, head) and state
//     element: h_c = e_c h_{c-1} + s_c over the chunks (the order
//     el * h + acc), writing the state before each chunk as hi + lo bf16;
//   C ssd_chunk_out, a block per (batch, chunk, group of heads):
//     y = exp(cum) (C . h_{c-1}) + W . x.
// C's group is chosen on the host (kernels/ssd.py:head_group): the
// smallest group whose blocks fit on the SMs in one wave. At zamba2's
// prefill (16 chunks x 80 heads, one block per SM) groups of 10 heads give
// 128 blocks. B and C are shared
// by all heads, so C forms C.B^T once per block over the causal half
// (tiles on or below the diagonal) and applies each head's
// 2^((cum_i - cum_j) log2 e) dt_j to it as it builds W in registers; tiles
// of W above the diagonal are skipped. Each block copies the next head's
// x, h and dt in with 16-byte cp.async under the current head's products
// (two stages where they fit in shared memory, else one). Products are
// mma.sync m16n8k16 on bf16 with ldmatrix fragments: C.B^T from the inputs
// (exact products, f32 sums); W.x, C.h and B^T (x w), whose one operand is
// f32, with that operand split into hi + lo bf16 parts (2^-16 relative),
// at twice the tensor work. The per-chunk states live in scratch buffers
// cached per (device, stream) (kernels/ssd.py:_scratch).
//
// f32 (the checks only): the SIMT build of the first port, one block per
// (batch, head) walking its chunks with h in shared memory, f32 FMAs on a
// 16 x 16 thread grid with the whole L x L square of W (where W does not
// fit, row tiles of wi rows: tests/test_kernels.py's (L, N, P) =
// (128, 128, 64) runs with wi = 32). f32 inputs split into hi + lo bf16
// parts through the tensor-core kernels were tried and not kept: each
// operand then holds 2^-16 of its value, not 2^-24, and zamba2's smoke
// configuration on an H100 left the CPU by 3.3e-4 in an end-to-end check
// held at 1e-4 (tests/test_torch_gpu.py:
// test_hybrid_serving_path_on_the_card_matches_cpu).
//
// Bound: B and C are shared by the heads, so the inputs need C.B^T once per
// (batch, chunk), l(l+1)/2 N MACs over the causal pairs, and per (batch,
// head, chunk) l(l+1)/2 P MACs for W.x and 2 l N P for C.h and B^T.x. At
// zamba2's 2048-token prefill (80 heads of P = 64, N = 64, L = 128) that is
// 4.05 GFLOP: 60.5 us at 67 TFLOP/s f32, 4.1 us at 989 TFLOP/s bf16; the
// bytes (xh, dt, B, C in, y and h out, 65 MB) take 19.5 us. The bf16 build
// runs its products on the bf16 tensor cores, so its bound is the bytes,
// 19.5 us. It issues them in whole 16 x 16 tiles (the diagonal's included)
// and the f32-operand ones twice (hi + lo): 8.5 GFLOP, 8.6 us at the bf16
// rate, below the bytes too. The SIMT build's bound is the f32 rate's
// 60.5 us. What bounds the design of the bf16 build: the
// three launches move about 168 MB (x read twice, the chunk states written
// and read, their hi + lo parts written and read, y written in f32), 50 us
// at 3.35 TB/s; C forms W (an ex2 per causal pair) once per group of 32
// columns of P and head; one block of 8 warps per SM runs C (C.B^T in f32
// takes 70 KB of shared memory).
//
// Any other shape: the tiled build (ssd_chunk_tiles), f32 or bf16 inputs,
// for L, N or P above 128 and for f32 where the SIMT build does not fit
// (L = N = P = 128). One block per (batch, head) walks the chunks as the
// SIMT build does, but holds no whole matrix: every product runs over 32 x
// 32 tiles staged in shared memory (13 KB, whatever the shape), the state
// lives in the output h itself (global, updated in place after each
// chunk's outputs are written), y is accumulated in place in the output
// (each element owned by one thread), and the chunk's cumsum, exp(cum) and
// decay-to-end weights go through a per-block slice of a scratch buffer
// (4 L floats). C.B^T is formed tile by tile inside W's tiles (j <= i
// only). A simple, correct route: it re-reads C, B and x from L2 once per
// tile of the other operand, and runs B x nh blocks only.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The SIMT build (f32 inputs).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kGrid = 16;       // the threads as a 16 x 16 grid (ty, tx)
constexpr int kMaxTile = 8;     // register tile per side: dimensions up to 128
constexpr int kMaxDim = kGrid * kMaxTile;

struct SsdArgs {
  const void* x;      // (B, S, nh, P)
  const float* dt;    // (B, S, nh), softplus'd
  const float* a;     // (nh,), negative
  const void* bm;     // (B, S, N)
  const void* cm;     // (B, S, N)
  const float* h0;    // (B, nh, N, P) packed, or null for a zero state
  float* y;           // (B, S, nh, P) packed
  float* h;           // (B, nh, N, P) packed
  int64_t x_sb, x_ss, x_sh;     // element strides; inner stride 1
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int s, nh, p, n, chunk;
  int wi;  // rows of W per tile
};

__host__ __device__ constexpr int ssd_smem_floats(int l, int n, int p, int wi) {
  return l * p + 2 * l * (n + 1) + n * p + wi * (l + 1) + 4 * l;
}

// TP: register-tile columns over P (P <= kGrid * TP).
template <typename T, int TP>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan(SsdArgs a) {
  extern __shared__ float smem[];
  const int L = a.chunk, N = a.n, P = a.p;
  const int BP = N + 1, WP = L + 1;
  float* xs = smem;              // [L][P]
  float* bs = xs + L * P;        // [L][BP]
  float* cs = bs + L * BP;       // [L][BP]
  float* hs = cs + L * BP;       // [N][P]: the state
  float* ws = hs + N * P;        // [wi][WP]: a row tile of W
  float* cum = ws + a.wi * WP;   // [L]
  float* dts = cum + L;          // [L]
  float* ecum = dts + L;         // [L]: exp(cum_i)
  float* wend = ecum + L;        // [L]: exp(cum_last - cum_j) * dt_j

  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const float decay = a.a[head];
  const int64_t bh = static_cast<int64_t>(b) * a.nh + head;

  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + head * a.x_sh;
  const float* dtb = a.dt + b * a.dt_sb + head * a.dt_sh;
  const T* bb = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cb = static_cast<const T*>(a.cm) + b * a.c_sb;
  float* yb = a.y + static_cast<int64_t>(b) * a.s * a.nh * P + static_cast<int64_t>(head) * P;
  const int64_t y_ss = static_cast<int64_t>(a.nh) * P;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = a.h0 ? a.h0[bh * N * P + i] : 0.0f;

  for (int c0 = 0; c0 < a.s; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = c0 + i / P;
      xs[i] = t < a.s ? rt::load_f32(xb + t * a.x_ss + i % P) : 0.0f;
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int r = i / N, col = i % N;
      const int t = c0 + r;
      const bool in = t < a.s;
      bs[r * BP + col] = in ? rt::load_f32(bb + t * a.b_ss + col) : 0.0f;
      cs[r * BP + col] = in ? rt::load_f32(cb + t * a.c_ss + col) : 0.0f;
    }
    if (tid < 32) {
      // cum: each lane sums a run of consecutive positions, then a warp scan
      // of the runs' totals gives each run its offset.
      const int lane = tid;
      const int per = (L + 31) / 32;
      float vals[kMaxDim / 32];
      float dvals[kMaxDim / 32];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxDim / 32; ++k) {
        const int t = lane * per + k;
        const bool in = k < per && t < L && c0 + t < a.s;
        dvals[k] = in ? dtb[(c0 + t) * a.dt_ss] : 0.0f;
        run += dvals[k] * decay;
        vals[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float off = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) off = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxDim / 32; ++k) {
        const int t = lane * per + k;
        if (k < per && t < L) {
          cum[t] = off + vals[k];
          dts[t] = dvals[k];
        }
      }
      __syncwarp();
      const float last = cum[L - 1];
      for (int t = lane; t < L; t += 32) {
        ecum[t] = expf(cum[t]);
        wend[t] = expf(last - cum[t]) * dts[t];
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += a.wi) {
      const int rows = min(a.wi, L - i0);
      // W rows [i0, i0 + rows): thread (ty, tx) owns i = i0 + ty + 16u, j = tx + 16v
      {
        float acc[kMaxTile][kMaxTile];
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
          for (int v = 0; v < kMaxTile; ++v) acc[u][v] = 0.0f;
        for (int k = 0; k < N; ++k) {
          float cv[kMaxTile], bv[kMaxTile];
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u) {
            const int r = ty + kGrid * u;
            cv[u] = r < rows ? cs[(i0 + r) * BP + k] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < kMaxTile; ++v) {
            const int j = tx + kGrid * v;
            bv[v] = j < L ? bs[j * BP + k] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
            for (int v = 0; v < kMaxTile; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int r = ty + kGrid * u;
          if (r >= rows) continue;
          const int i = i0 + r;
#pragma unroll
          for (int v = 0; v < kMaxTile; ++v) {
            const int j = tx + kGrid * v;
            if (j < L) ws[r * WP + j] = j <= i ? expf(cum[i] - cum[j]) * acc[u][v] * dts[j] : 0.0f;
          }
        }
      }
      __syncthreads();
      // y rows of the tile: thread (ty, tx) owns i = i0 + ty + 16u, p = tx + 16v
      {
        float acc[kMaxTile][TP];
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] = 0.0f;
        for (int k = 0; k < N; ++k) {  // C_i . h, the state before this chunk
          float cv[kMaxTile], hv[TP];
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u) {
            const int r = ty + kGrid * u;
            cv[u] = r < rows ? cs[(i0 + r) * BP + k] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const int p = tx + kGrid * v;
            hv[v] = p < P ? hs[k * P + p] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
            for (int v = 0; v < TP; ++v) acc[u][v] = fmaf(cv[u], hv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int r = ty + kGrid * u;
          const float e = r < rows ? ecum[i0 + r] : 0.0f;
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] *= e;
        }
        for (int j = 0; j < i0 + rows; ++j) {  // W is zero past the tile's last row
          float wv[kMaxTile], xv[TP];
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u) {
            const int r = ty + kGrid * u;
            wv[u] = r < rows ? ws[r * WP + j] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const int p = tx + kGrid * v;
            xv[v] = p < P ? xs[j * P + p] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
            for (int v = 0; v < TP; ++v) acc[u][v] = fmaf(wv[u], xv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int r = ty + kGrid * u;
          const int t = c0 + i0 + r;
          if (r >= rows || t >= a.s) continue;
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const int p = tx + kGrid * v;
            if (p < P) yb[t * y_ss + p] = acc[u][v];
          }
        }
      }
      __syncthreads();  // ws is rewritten by the next tile; hs is read until here
    }

    // h <- exp(cum_last) h + B^T (x * wend): thread (ty, tx) owns n = ty + 16u, p = tx + 16v
    {
      const float el = ecum[L - 1];
      float acc[kMaxTile][TP];
#pragma unroll
      for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
        for (int v = 0; v < TP; ++v) acc[u][v] = 0.0f;
      for (int j = 0; j < L; ++j) {
        const float w = wend[j];
        float bv[kMaxTile], xv[TP];
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int n = ty + kGrid * u;
          bv[u] = n < N ? bs[j * BP + n] : 0.0f;
        }
#pragma unroll
        for (int v = 0; v < TP; ++v) {
          const int p = tx + kGrid * v;
          xv[v] = p < P ? xs[j * P + p] * w : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] = fmaf(bv[u], xv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < kMaxTile; ++u) {
        const int n = ty + kGrid * u;
        if (n >= N) continue;
#pragma unroll
        for (int v = 0; v < TP; ++v) {
          const int p = tx + kGrid * v;
          if (p < P) hs[n * P + p] = el * hs[n * P + p] + acc[u][v];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) a.h[bh * N * P + i] = hs[i];
}

// Shared memory above 48 KB only after opting in. The attribute belongs to
// the current device, so it is set on every launch.
template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int TP>
cudaError_t launch_ssd(const SsdArgs& a, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * ssd_smem_floats(a.chunk, a.n, a.p, a.wi);
  const cudaError_t e = set_smem(ssd_chunk_scan<T, TP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.nh, batch);
  ssd_chunk_scan<T, TP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const SsdArgs& a, int batch, cudaStream_t stream) {
  if (a.p <= 2 * kGrid) return launch_ssd<T, 2>(a, batch, stream);
  if (a.p <= 4 * kGrid) return launch_ssd<T, 4>(a, batch, stream);
  return launch_ssd<T, 8>(a, batch, stream);
}

// ---------------------------------------------------------------------------
// The tiled build (any L, N, P; f32 or bf16 inputs).
// ---------------------------------------------------------------------------

constexpr int kTile = 32;  // rows and columns of every staged tile
constexpr int kTileRows = kTile / (kThreads / kTile);  // 4 rows a thread

// Thread (ty, tx) of a 8 x 32 grid owns rows ty + 8u (u < 4), column tx of
// each 32 x 32 output tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_tiles(SsdArgs a, float* work) {
  __shared__ float ta[kTile][kTile + 1];
  __shared__ float tb[kTile][kTile + 1];
  __shared__ float tw[kTile][kTile + 1];
  const int L = a.chunk, N = a.n, P = a.p;
  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / kTile, tx = tid % kTile;
  constexpr int kStep = kThreads / kTile;  // 8
  const float decay = a.a[head];
  const int64_t bh = static_cast<int64_t>(b) * a.nh + head;
  float* cum = work + bh * 4 * L;  // [L] inclusive cumsum of dt * a
  float* dts = cum + L;            // [L] dt, 0 past S
  float* ecum = dts + L;           // [L] exp(cum)
  float* wend = ecum + L;          // [L] exp(cum_last - cum) * dt

  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + head * a.x_sh;
  const float* dtb = a.dt + b * a.dt_sb + head * a.dt_sh;
  const T* bb = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cb = static_cast<const T*>(a.cm) + b * a.c_sb;
  float* yb = a.y + static_cast<int64_t>(b) * a.s * a.nh * P + static_cast<int64_t>(head) * P;
  const int64_t y_ss = static_cast<int64_t>(a.nh) * P;
  float* hb = a.h + bh * N * P;  // the state, updated in place

  for (int i = tid; i < N * P; i += kThreads) hb[i] = a.h0 ? a.h0[bh * N * P + i] : 0.0f;

  for (int c0 = 0; c0 < a.s; c0 += L) {
    __syncthreads();  // the previous chunk's state update is done
    for (int t = tid; t < L; t += kThreads) dts[t] = c0 + t < a.s ? dtb[(c0 + t) * a.dt_ss] : 0.0f;
    __syncthreads();
    if (tid < 32) {
      // each lane sums a run of consecutive positions, then a warp scan of
      // the runs' totals gives each run its offset
      const int lane = tid, per = (L + 31) / 32;
      float run = 0.0f;
      for (int k = 0; k < per; ++k) {
        const int t = lane * per + k;
        if (t < L) {
          run += dts[t] * decay;
          cum[t] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float off = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) off = 0.0f;
      for (int k = 0; k < per; ++k) {
        const int t = lane * per + k;
        if (t < L) cum[t] = off + cum[t];
      }
    }
    __syncthreads();
    const float last = cum[L - 1];
    for (int t = tid; t < L; t += kThreads) {
      ecum[t] = expf(cum[t]);
      wend[t] = expf(last - cum[t]) * dts[t];
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += kTile) {
      // y rows [i0, i0 + 32) = exp(cum_i) C_i . h, over P and N in tiles
      for (int p0 = 0; p0 < P; p0 += kTile) {
        float acc[kTileRows] = {};
        for (int n0 = 0; n0 < N; n0 += kTile) {
          __syncthreads();
          for (int r = ty; r < kTile; r += kStep) {
            const int i = i0 + r, t = c0 + i, col = n0 + tx;
            ta[r][tx] = i < L && t < a.s && col < N ? rt::load_f32(cb + t * a.c_ss + col) : 0.0f;
            const int n = n0 + r, p = p0 + tx;
            tb[r][tx] = n < N && p < P ? hb[n * P + p] : 0.0f;
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < kTile; ++k) {
            const float hv = tb[k][tx];
#pragma unroll
            for (int u = 0; u < kTileRows; ++u) acc[u] = fmaf(ta[ty + kStep * u][k], hv, acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kTileRows; ++u) {
          const int i = i0 + ty + kStep * u, t = c0 + i, p = p0 + tx;
          if (i < L && t < a.s && p < P) yb[t * y_ss + p] = acc[u] * ecum[i];
        }
      }
      // y += W x over the key tiles j0 <= i0 (W is zero above the diagonal)
      for (int j0 = 0; j0 <= i0 && j0 < L; j0 += kTile) {
        float g[kTileRows] = {};
        for (int n0 = 0; n0 < N; n0 += kTile) {
          __syncthreads();
          for (int r = ty; r < kTile; r += kStep) {
            const int col = n0 + tx;
            const int i = i0 + r, ti = c0 + i;
            ta[r][tx] = i < L && ti < a.s && col < N ? rt::load_f32(cb + ti * a.c_ss + col) : 0.0f;
            const int j = j0 + r, tj = c0 + j;
            tb[r][tx] = j < L && tj < a.s && col < N ? rt::load_f32(bb + tj * a.b_ss + col) : 0.0f;
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < kTile; ++k) {
            const float bv = tb[tx][k];
#pragma unroll
            for (int u = 0; u < kTileRows; ++u) g[u] = fmaf(ta[ty + kStep * u][k], bv, g[u]);
          }
        }
        {
          const int j = j0 + tx;
#pragma unroll
          for (int u = 0; u < kTileRows; ++u) {
            const int r = ty + kStep * u, i = i0 + r;
            tw[r][tx] = i < L && j < L && j <= i ? expf(cum[i] - cum[j]) * g[u] * dts[j] : 0.0f;
          }
        }
        for (int p0 = 0; p0 < P; p0 += kTile) {
          __syncthreads();  // tw written; the previous x tile consumed
          for (int r = ty; r < kTile; r += kStep) {
            const int j = j0 + r, t = c0 + j, p = p0 + tx;
            tb[r][tx] = j < L && t < a.s && p < P ? rt::load_f32(xb + t * a.x_ss + p) : 0.0f;
          }
          __syncthreads();
          float acc[kTileRows] = {};
#pragma unroll 8
          for (int k = 0; k < kTile; ++k) {
            const float xv = tb[k][tx];
#pragma unroll
            for (int u = 0; u < kTileRows; ++u) acc[u] = fmaf(tw[ty + kStep * u][k], xv, acc[u]);
          }
#pragma unroll
          for (int u = 0; u < kTileRows; ++u) {
            const int i = i0 + ty + kStep * u, t = c0 + i, p = p0 + tx;
            if (i < L && t < a.s && p < P) yb[t * y_ss + p] += acc[u];
          }
        }
      }
    }
    __syncthreads();  // every read of the state before this chunk is done

    // h <- exp(cum_last) h + B^T (x * wend), over N and P in tiles
    const float el = ecum[L - 1];
    for (int n0 = 0; n0 < N; n0 += kTile) {
      for (int p0 = 0; p0 < P; p0 += kTile) {
        float acc[kTileRows] = {};
        for (int j0 = 0; j0 < L; j0 += kTile) {
          __syncthreads();
          for (int r = ty; r < kTile; r += kStep) {
            const int j = j0 + r, t = c0 + j;
            const bool in = j < L && t < a.s;
            const int col = n0 + tx, p = p0 + tx;
            ta[r][tx] = in && col < N ? rt::load_f32(bb + t * a.b_ss + col) : 0.0f;
            tb[r][tx] = in && p < P ? rt::load_f32(xb + t * a.x_ss + p) * wend[j] : 0.0f;
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < kTile; ++k) {
            const float xv = tb[k][tx];
#pragma unroll
            for (int u = 0; u < kTileRows; ++u) acc[u] = fmaf(ta[k][ty + kStep * u], xv, acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kTileRows; ++u) {
          const int n = n0 + ty + kStep * u, p = p0 + tx;
          if (n < N && p < P) hb[n * P + p] = el * hb[n * P + p] + acc[u];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_tiles(const SsdArgs& a, int batch, float* work, cudaStream_t stream) {
  ssd_chunk_tiles<T><<<dim3(a.nh, batch), kThreads, 0, stream>>>(a, work);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core build (bf16 inputs): three launches and scratch for the
// per-chunk states.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Padded shapes and shared-memory layout. Tiles are padded to multiples of
// 16 (rows and columns past the data are zero); bf16 rows have a stride of
// 16k + 8 elements (ldmatrix reads 8 rows at distinct banks), the f32 rows
// of C.B^T 16k + 8 floats (float2 loads of a fragment at distinct banks).
struct MmaLayout {
  int lp, np, pp;       // padded chunk, N, P
  int xs, ns, cbs;      // row strides: x, and B/C/h^T (bf16); C.B^T (f32)
  int x_bytes, bc_bytes, ht_bytes, vec_bytes;
  // kernel C (outputs): C, C.B^T, cum log2 e, exp(cum), then `stages`
  // regions of (x, h^T hi, h^T lo, dt); B sits in the last region until
  // C.B^T is formed
  int out_stage, out_region, out_c, out_cb, out_cl, out_ecum, out_regions, out_bytes, stages;
  // kernel A (chunk states): B, x, dt, cum, end weights
  int st_b, st_x, st_dt, st_cum, st_wend, st_bytes;

  __host__ __device__ MmaLayout(int l, int n, int p) {
    lp = up16(l);
    np = up16(n);
    pp = up16(p);
    xs = pp + 8;
    ns = np + 8;
    cbs = lp + 8;
    x_bytes = align16(lp * xs * 2);
    bc_bytes = align16(lp * ns * 2);
    ht_bytes = align16(pp * ns * 2);
    vec_bytes = align16(lp * 4);
    out_stage = x_bytes + 2 * ht_bytes + vec_bytes;
    out_region = out_stage > bc_bytes ? out_stage : bc_bytes;
    out_c = 0;
    out_cb = out_c + bc_bytes;
    out_cl = out_cb + align16(lp * cbs * 4);
    out_ecum = out_cl + vec_bytes;
    out_regions = out_ecum + vec_bytes;
    stages = out_regions + 2 * out_region <= kMaxSmem ? 2 : 1;
    out_bytes = out_regions + stages * out_region;
    st_b = 0;
    st_x = bc_bytes;
    st_dt = st_x + x_bytes;
    st_cum = st_dt + vec_bytes;
    st_wend = st_cum + vec_bytes;
    st_bytes = st_wend + vec_bytes;
  }
};

struct MmaArgs {
  const bf16* x;       // (B, S, nh, P)
  const float* dt;     // (B, S, nh)
  const float* a;      // (nh,)
  const bf16* bm;      // (B, S, N)
  const bf16* cm;      // (B, S, N)
  const float* h0;     // (B, nh, N, P) packed, or null
  float* y;            // (B, S, nh, P) packed
  float* h;            // (B, nh, N, P) packed
  float* states;       // (B, nc, nh, P, N) f32: each chunk's own state, transposed
  bf16* hsplit;        // (B, nc, nh, 2, P, N): the state before each chunk, transposed, hi and lo
  float* el;           // (B, nc, nh): exp(cum_last) of each chunk
  int64_t x_sb, x_ss, x_sh;
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int s, nh, p, n, chunk, nc, group;
  int vec;             // 1: x, B and C are copied in 16-byte pieces
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
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [0, prow) x columns [0, pcol) of a bf16 tile into shared memory (row
// stride ds); source rows past `rows` and columns past `cols` are zero.
// vec: 16-byte cp.async pieces (cols, the source's base and row stride are
// multiples of 8 elements); else plain loads and stores.
__device__ __forceinline__ void stage_bf16(bf16* dst, int ds, const bf16* src, int64_t ss, int rows,
                                           int cols, int prow, int pcol, bool vec) {
  if (vec) {
    const int cpr = pcol / 8;
    for (int e = threadIdx.x; e < prow * cpr; e += kMmaThreads) {
      const int r = e / cpr, c = (e % cpr) * 8;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ds + c, in ? src + r * ss + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < prow * pcol; e += kMmaThreads) {
      const int r = e / pcol, c = e % pcol;
      dst[r * ds + c] = r < rows && c < cols ? src[r * ss + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// dt of one head over the chunk's positions (zero past `rows`)
__device__ __forceinline__ void stage_dt(float* dst, const float* src, int64_t ss, int rows, int lp) {
  for (int t = threadIdx.x; t < lp; t += kMmaThreads) {
    const bool in = t < rows;
    cp_async4(dst + t, in ? src + t * ss : src, in);
  }
}

// cum = inclusive cumsum of dt * a over the padded chunk, by one warp: each
// lane sums a run of consecutive positions, a warp scan gives the offsets
// (the SIMT build's order)
__device__ __forceinline__ void chunk_cum(const float* dts, float decay, int lp, float* cum, int lane) {
  const int per = (lp + 31) / 32;  // at most 4: lp <= 128
  float vals[4];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = lane * per + k;
    const bool in = k < per && t < lp;
    run += (in ? dts[t] : 0.0f) * decay;
    vals[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float off = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) off = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = lane * per + k;
    if (k < per && t < lp) cum[t] = off + vals[k];
  }
  __syncwarp();
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// Kernel A: for each (batch, chunk, head), the chunk's own state
// s_c = B^T (x * exp(cum_last - cum) * dt), stored transposed (P x N, f32)
// in `states`, and e_c = exp(cum_last) in `el`. Products on tensor cores:
// M = N (B^T, exact in bf16), K = the chunk's positions, N = P (x times its
// end weight in f32, as hi + lo bf16). One head per block, several blocks
// per SM.
__global__ void __launch_bounds__(kMmaThreads) ssd_chunk_state(MmaArgs a) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const MmaLayout lay(a.chunk, a.n, a.p);
  const int c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk;
  const int rows = min(a.chunk, a.s - c0);
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  bf16* bs = reinterpret_cast<bf16*>(smem + lay.st_b);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.st_x);
  float* dts = reinterpret_cast<float*>(smem + lay.st_dt);
  float* cum = reinterpret_cast<float*>(smem + lay.st_cum);
  float* wend = reinterpret_cast<float*>(smem + lay.st_wend);
  const bool vec = a.vec != 0;
  stage_bf16(bs, lay.ns, a.bm + b * a.b_sb + c0 * a.b_ss, a.b_ss, rows, a.n, lay.lp, lay.np, vec);
  stage_bf16(xs, lay.xs, a.x + b * a.x_sb + c0 * a.x_ss + hd * a.x_sh, a.x_ss, rows, a.p, lay.lp,
             lay.pp, vec);
  stage_dt(dts, a.dt + b * a.dt_sb + c0 * a.dt_ss + hd * a.dt_sh, a.dt_ss, rows, lay.lp);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  if (warp == 0) {
    chunk_cum(dts, a.a[hd], lay.lp, cum, lane);
    const float last = cum[lay.lp - 1];
    for (int t = lane; t < lay.lp; t += 32) wend[t] = expf(last - cum[t]) * dts[t];
    if (lane == 0) a.el[(static_cast<int64_t>(b) * a.nc + c) * a.nh + hd] = expf(last);
  }
  __syncthreads();

  const int nb = lay.np / 16, ntiles = (a.p + 7) / 8, ngroups = (ntiles + 3) / 4;
  float* st = a.states + ((static_cast<int64_t>(b) * a.nc + c) * a.nh + hd) * a.n * a.p;
  for (int task = warp; task < nb * ngroups; task += kMmaWarps) {
    const int n0 = (task / ngroups) * 16, tg = (task % ngroups) * 4;
    float acc[4][4] = {};
    for (int kb = 0; kb < lay.lp; kb += 16) {
      uint32_t af[4];  // A[n][j] = B[j][n]: B^T read transposed
      ldsm4t(af, bs + (kb + row_b(lane)) * lay.ns + n0 + col_b(lane));
      const int j0 = kb + 2 * t4;
      const float w0 = wend[j0], w1 = wend[j0 + 1], w8 = wend[j0 + 8], w9 = wend[j0 + 9];
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        if (tg + nt >= ntiles) break;
        uint32_t xf[4];  // (x[j0][p], x[j0+1][p]) and rows + 8, for two column tiles
        ldsm4t(xf, xs + (kb + row_a(lane)) * lay.xs + (tg + nt) * 8 + col_a(lane));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v0 = xf[2 * h], v1 = xf[2 * h + 1];
          uint32_t hi0, lo0, hi1, lo1;
          split2(__uint_as_float(v0 << 16) * w0, __uint_as_float(v0 & 0xffff0000u) * w1, hi0, lo0);
          split2(__uint_as_float(v1 << 16) * w8, __uint_as_float(v1 & 0xffff0000u) * w9, hi1, lo1);
          mma(acc[nt + h], af, hi0, hi1);
          mma(acc[nt + h], af, lo0, lo1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (tg + nt >= ntiles) break;
      const int pc = (tg + nt) * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = n0 + g + (e >> 1) * 8, pp = pc + (e & 1);
        if (nn < a.n && pp < a.p) st[pp * a.n + nn] = acc[nt][e];
      }
    }
  }
}

// Kernel B, the only sequential part: per (batch, head) and state element,
// h_c = e_c h_{c-1} + s_c over the chunks, from h0 or zero. The state before
// each chunk goes to `hsplit` as hi + lo bf16 (transposed, P x N: kernel C's
// B operand of C.h); the last state goes to h.
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 4;  // chunks whose loads are issued together

__global__ void __launch_bounds__(kPassThreads) ssd_state_pass(MmaArgs a, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t np = static_cast<int64_t>(a.n) * a.p;
  const int64_t bh = idx / np, e = idx % np;  // e = p * N + n
  const int64_t b = bh / a.nh, hd = bh % a.nh;
  const int64_t packed = bh * np + (e % a.n) * a.p + e / a.n;  // (n, p) of h0 and h
  float hv = a.h0 ? a.h0[packed] : 0.0f;
  for (int c = 0; c < a.nc; c += kPassBatch) {
    float sv[kPassBatch], ev[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c + u < a.nc) {
        const int64_t slot = (b * a.nc + c + u) * a.nh + hd;
        sv[u] = a.states[slot * np + e];
        ev[u] = a.el[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c + u < a.nc) {
        bf16* hs = a.hsplit + ((b * a.nc + c + u) * a.nh + hd) * 2 * np;
        const uint32_t bits = __float_as_uint(hv);
        const float hi = __uint_as_float(bits & 0xffff0000u);
        hs[e] = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
        hs[np + e] = __float2bfloat16_rn(hv - hi);
        hv = __fmaf_rn(ev[u], hv, sv[u]);  // el * h + acc, the SIMT build's order
      }
    }
  }
  a.h[packed] = hv;
}

// Kernel C: for each (batch, chunk) the block forms C.B^T once, over the
// causal half (16 x 16 tiles on or below the diagonal), for all heads of
// its group; then per head
//   y_i = exp(cum_i) (C_i . h_{c-1}) + sum_{j <= i} W[i][j] x_j,
//   W[i][j] = 2^((cum_i - cum_j) log2 e) (C.B^T)[i][j] dt_j,
// with W formed in registers in the A-operand layout (tiles above the
// diagonal are skipped) and the next head's x, h and dt copied in under
// this head's products. C.h: A = C (exact), B = h as the hi + lo bf16 parts
// kernel B wrote; W.x: A = W as hi + lo, B = x (exact).
__global__ void __launch_bounds__(kMmaThreads, 1) ssd_chunk_out(MmaArgs a) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const MmaLayout lay(a.chunk, a.n, a.p);
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h_lo = grp * a.group, h_hi = min(a.nh, h_lo + a.group);
  const int c0 = c * a.chunk;
  const int rows = min(a.chunk, a.s - c0);
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  bf16* cs = reinterpret_cast<bf16*>(smem + lay.out_c);
  float* cb = reinterpret_cast<float*>(smem + lay.out_cb);
  float* cl = reinterpret_cast<float*>(smem + lay.out_cl);
  float* ecum = reinterpret_cast<float*>(smem + lay.out_ecum);
  auto region = [&](int r) { return smem + lay.out_regions + r * lay.out_region; };
  const bool vec = a.vec != 0;
  const bool hvec = a.n % 8 == 0;
  const int64_t np = static_cast<int64_t>(a.n) * a.p;
  auto stage_head = [&](int hd, int r) {
    unsigned char* base = region(r);
    stage_bf16(reinterpret_cast<bf16*>(base), lay.xs, a.x + b * a.x_sb + c0 * a.x_ss + hd * a.x_sh,
               a.x_ss, rows, a.p, lay.lp, lay.pp, vec);
    const bf16* hp = a.hsplit + ((static_cast<int64_t>(b) * a.nc + c) * a.nh + hd) * 2 * np;
    stage_bf16(reinterpret_cast<bf16*>(base + lay.x_bytes), lay.ns, hp, a.n, a.p, a.n, lay.pp,
               lay.np, hvec);
    stage_bf16(reinterpret_cast<bf16*>(base + lay.x_bytes + lay.ht_bytes), lay.ns, hp + np, a.n,
               a.p, a.n, lay.pp, lay.np, hvec);
    stage_dt(reinterpret_cast<float*>(base + lay.x_bytes + 2 * lay.ht_bytes),
             a.dt + b * a.dt_sb + c0 * a.dt_ss + hd * a.dt_sh, a.dt_ss, rows, lay.lp);
  };

  bf16* bs = reinterpret_cast<bf16*>(region(lay.stages - 1));
  stage_bf16(cs, lay.ns, a.cm + b * a.c_sb + c0 * a.c_ss, a.c_ss, rows, a.n, lay.lp, lay.np, vec);
  stage_bf16(bs, lay.ns, a.bm + b * a.b_sb + c0 * a.b_ss, a.b_ss, rows, a.n, lay.lp, lay.np, vec);
  if (lay.stages == 2) stage_head(h_lo, 0);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // C.B^T over the tiles (ib, jb), jb <= ib: exact products of bf16 inputs
  const int rb = lay.lp / 16;
  for (int u = warp; u < rb * (rb + 1) / 2; u += kMmaWarps) {
    int ib = 0;
    while ((ib + 1) * (ib + 2) / 2 <= u) ++ib;
    const int jb = u - ib * (ib + 1) / 2;
    float acc[2][4] = {};
    for (int kb = 0; kb < lay.np; kb += 16) {
      uint32_t af[4], bf[4];
      ldsm4(af, cs + (ib * 16 + row_a(lane)) * lay.ns + kb + col_a(lane));
      ldsm4(bf, bs + (jb * 16 + row_b(lane)) * lay.ns + kb + col_b(lane));
      mma(acc[0], af, bf[0], bf[1]);
      mma(acc[1], af, bf[2], bf[3]);
    }
    const int i0 = ib * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = jb * 16 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(cb + i0 * lay.cbs + j) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(cb + (i0 + 8) * lay.cbs + j) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();  // B is no longer read: its region takes a head's tiles
  if (lay.stages == 1) {
    stage_head(h_lo, 0);
    cp_commit();
    cp_wait_all();
    __syncthreads();
  }

  const int ntiles = (a.p + 7) / 8, ngroups = (ntiles + 3) / 4;
  const int tasks = rb * ngroups;
  for (int hd = h_lo; hd < h_hi; ++hd) {
    const int r = lay.stages == 2 ? (hd - h_lo) & 1 : 0;
    if (lay.stages == 2 && hd + 1 < h_hi) {
      stage_head(hd + 1, r ^ 1);
      cp_commit();
    }
    const bf16* xs = reinterpret_cast<const bf16*>(region(r));
    const bf16* hhi = reinterpret_cast<const bf16*>(region(r) + lay.x_bytes);
    const bf16* hlo = reinterpret_cast<const bf16*>(region(r) + lay.x_bytes + lay.ht_bytes);
    const float* dts = reinterpret_cast<const float*>(region(r) + lay.x_bytes + 2 * lay.ht_bytes);
    if (warp == 0) {
      chunk_cum(dts, a.a[hd], lay.lp, cl, lane);
      __syncwarp();
      for (int t = lane; t < lay.lp; t += 32) {
        const float v = cl[t];
        ecum[t] = expf(v);
        cl[t] = v * kLog2e;
      }
    }
    __syncthreads();
    float* yb = a.y + (static_cast<int64_t>(b) * a.s + c0) * a.nh * a.p + static_cast<int64_t>(hd) * a.p;
    const int64_t y_ss = static_cast<int64_t>(a.nh) * a.p;
    // tasks (row block, group of 4 column tiles), heaviest row blocks first,
    // dealt to the warps in a snake so each warp's causal work evens out
    for (int k = 0;; ++k) {
      const int u = k * kMmaWarps + (k & 1 ? kMmaWarps - 1 - warp : warp);
      if (u >= tasks) break;
      const int ib = rb - 1 - u / ngroups, tg = (u % ngroups) * 4;
      const int i0 = ib * 16 + g, i1 = i0 + 8;
      float acc[4][4] = {};
      // C_i . h_{c-1}
      for (int kb = 0; kb < lay.np; kb += 16) {
        uint32_t af[4];
        ldsm4(af, cs + (ib * 16 + row_a(lane)) * lay.ns + kb + col_a(lane));
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          if (tg + nt >= ntiles) break;
          uint32_t hf[4], lf[4];
          const int off = ((tg + nt) * 8 + row_b(lane)) * lay.ns + kb + col_b(lane);
          ldsm4(hf, hhi + off);
          ldsm4(lf, hlo + off);
          mma(acc[nt], af, hf[0], hf[1]);
          mma(acc[nt], af, lf[0], lf[1]);
          mma(acc[nt + 1], af, hf[2], hf[3]);
          mma(acc[nt + 1], af, lf[2], lf[3]);
        }
      }
      const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      // + W . x over the key blocks up to the diagonal
      const float ci0 = cl[i0], ci1 = cl[i1];
      for (int kb = 0; kb <= ib; ++kb) {
        const int j0 = kb * 16 + 2 * t4;
        float w[8];  // (i0, j0), (i0, j0+1), (i1, j0), (i1, j0+1), then j + 8
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = j0 + 8 * q;
          const float2 cj = *reinterpret_cast<const float2*>(cl + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          const float2 r0 = *reinterpret_cast<const float2*>(cb + i0 * lay.cbs + j);
          const float2 r1 = *reinterpret_cast<const float2*>(cb + i1 * lay.cbs + j);
          w[4 * q + 0] = j <= i0 ? ex2(ci0 - cj.x) * r0.x * dj.x : 0.0f;
          w[4 * q + 1] = j + 1 <= i0 ? ex2(ci0 - cj.y) * r0.y * dj.y : 0.0f;
          w[4 * q + 2] = j <= i1 ? ex2(ci1 - cj.x) * r1.x * dj.x : 0.0f;
          w[4 * q + 3] = j + 1 <= i1 ? ex2(ci1 - cj.y) * r1.y * dj.y : 0.0f;
        }
        uint32_t ah[4], al[4];
        split2(w[0], w[1], ah[0], al[0]);
        split2(w[2], w[3], ah[1], al[1]);
        split2(w[4], w[5], ah[2], al[2]);
        split2(w[6], w[7], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          if (tg + nt >= ntiles) break;
          uint32_t xf[4];
          ldsm4t(xf, xs + (kb * 16 + row_a(lane)) * lay.xs + (tg + nt) * 8 + col_a(lane));
          mma(acc[nt], ah, xf[0], xf[1]);
          mma(acc[nt], al, xf[0], xf[1]);
          mma(acc[nt + 1], ah, xf[2], xf[3]);
          mma(acc[nt + 1], al, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (tg + nt >= ntiles) break;
        const int pc = (tg + nt) * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1, pp = pc + (e & 1);
          if (i < rows && pp < a.p) yb[i * y_ss + pp] = acc[nt][e];
        }
      }
    }
    if (lay.stages == 2) {
      cp_wait_all();
      __syncthreads();
    } else {
      __syncthreads();
      if (hd + 1 < h_hi) {
        stage_head(hd + 1, 0);
        cp_commit();
        cp_wait_all();
        __syncthreads();
      }
    }
  }
}

cudaError_t launch_mma(const MmaArgs& a, int batch, cudaStream_t stream) {
  const MmaLayout lay(a.chunk, a.n, a.p);
  cudaError_t e = set_smem(ssd_chunk_state, lay.st_bytes);
  if (e != cudaSuccess) return e;
  e = set_smem(ssd_chunk_out, lay.out_bytes);
  if (e != cudaSuccess) return e;
  if (a.nc > 0) {
    ssd_chunk_state<<<dim3(a.nc, a.nh, batch), kMmaThreads, lay.st_bytes, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int64_t total = static_cast<int64_t>(batch) * a.nh * a.n * a.p;
  ssd_state_pass<<<static_cast<unsigned>((total + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
                   stream>>>(a, total);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nc == 0) return e;
  const int groups = (a.nh + a.group - 1) / a.group;
  ssd_chunk_out<<<dim3(a.nc, groups, batch), kMmaThreads, lay.out_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one SIMT block for chunk L, state N, head dim P, W row tile wi.
extern "C" int rt_ssd_scan_smem(int chunk, int n, int p, int wi) {
  return static_cast<int>(sizeof(float)) * ssd_smem_floats(chunk, n, p, wi);
}

// Blocks of the tensor-core build's output kernel (C) that one SM of the
// current device holds at once (its shared memory and registers), for
// chunk L, state N and head dim P; -1 on a CUDA error.
extern "C" int rt_ssd_blocks_per_sm(int chunk, int n, int p) {
  if (chunk < 1 || chunk > kMaxDim || n < 1 || n > kMaxDim || p < 1 || p > kMaxDim) return -1;
  const int smem = MmaLayout(chunk, n, p).out_bytes;
  int blocks = 0;
  if (set_smem(ssd_chunk_out, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_chunk_out, kMmaThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// strides: 10 int64 values: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq). f32 inputs (is_bf16 = 0) run the SIMT
// build with W row tile wi; bf16 inputs the tensor-core build with heads in
// groups of `group` and the scratch `states` and `hsplit` (batch *
// ceil(s / chunk) * nh * n * p floats each) and `el` (batch *
// ceil(s / chunk) * nh floats).
extern "C" int rt_ssd_scan(const void* x, const float* dt, const float* a, const void* bm,
                           const void* cm, const float* h0, float* y, float* h,
                           const int64_t* strides, int batch, int s, int nh, int p, int n,
                           int chunk, int wi, int group, float* states, void* hsplit, float* el,
                           int is_bf16, void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxDim || n < 1 || n > kMaxDim || p < 1 || p > kMaxDim || s < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (wi < 1 || wi > chunk) return cudaErrorInvalidValue;
    SsdArgs args{x, dt, a, bm, cm, h0, y, h,
                 strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], strides[8], strides[9],
                 s, nh, p, n, chunk, wi};
    return dispatch_p<float>(args, batch, st);
  }
  if (group < 1 || !states || !hsplit || !el) return cudaErrorInvalidValue;
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  bool vec = p % 8 == 0 && n % 8 == 0 && aligned(x) && aligned(bm) && aligned(cm);
  const int bf16_strides[] = {0, 1, 2, 6, 7, 8, 9};  // x, B and C
  for (int i : bf16_strides) vec = vec && strides[i] % 8 == 0;
  MmaArgs args{static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(bm),
               static_cast<const bf16*>(cm), h0, y, h, states, static_cast<bf16*>(hsplit), el,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9],
               s, nh, p, n, chunk, (s + chunk - 1) / chunk, group, vec ? 1 : 0};
  return launch_mma(args, batch, st);
}

// The tiled build, any chunk, N and P, f32 or bf16 inputs; strides as
// rt_ssd_scan's; `work`: batch * nh * 4 * chunk floats of scratch.
extern "C" int rt_ssd_scan_tiles(const void* x, const float* dt, const float* a, const void* bm,
                                 const void* cm, const float* h0, float* y, float* h,
                                 const int64_t* strides, int batch, int s, int nh, int p, int n,
                                 int chunk, float* work, int is_bf16, void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (chunk < 1 || n < 1 || p < 1 || s < 0 || !work) return cudaErrorInvalidValue;
  SsdArgs args{x, dt, a, bm, cm, h0, y, h,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9],
               s, nh, p, n, chunk, 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tiles<bf16>(args, batch, work, st)
                 : launch_tiles<float>(args, batch, work, st);
}
