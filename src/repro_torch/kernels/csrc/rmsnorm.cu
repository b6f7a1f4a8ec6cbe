// K1 rmsnorm: y = x * rsqrt(mean(x^2) + eps) * scale, f32 math, output in
// x's dtype (float32 or bfloat16).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py:rmsnorm (pallas_call
// at :55). It reads each element once and writes it once, so the card's
// memory rate bounds it (10.0 us for qwen3-4b's q-norm of 65536 rows of
// 128 bf16 values); the narrow (B, 5) event batches of the stream path are
// bound by launch latency instead. Design (common.cuh): one thread per row
// for narrow rows; for model widths a group of threads per row that holds
// the row in registers, read with 16-byte loads (16 lanes per row and 16
// rows per block at a head dim of 128 in bf16, no barrier; a block of
// 128-256 threads for d_model rows), so each element is read once and
// written once; a two-pass block per row beyond what registers hold. The
// input may be a strided view (row stride `stride`, inner stride 1), so
// the stream path passes x[:, 1:6] without a copy; unaligned rows take the
// same plan one element at a time. The plan (kernels/rmsnorm.py:row_plan)
// arrives as (route, threads, chunks, vec).
#include "common.cuh"

extern "C" int rt_rmsnorm(const void* x, int64_t stride, const float* scale, void* y,
                          int64_t rows, int d, float eps, int is_bf16, int route, int threads,
                          int chunks, int vec, void* stream) {
  const rt::Stages none = rt::make_stages(nullptr, nullptr, 0);
  const rt::RowPlan plan{route, threads, chunks, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return rt::launch_rms_rows<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(x), stride, scale, static_cast<__nv_bfloat16*>(y),
        rows, d, eps, none, plan, s);
  }
  return rt::launch_rms_rows<float, false>(static_cast<const float*>(x), stride, scale,
                                           static_cast<float*>(y), rows, d, eps, none, plan, s);
}

// K4 rmsnorm_residual: h = x + res in f32; returns y = rmsnorm(h) * scale and
// h, both rounded to x's dtype.
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py:rmsnorm_residual
// (pallas_call at :94). It is K1's template with a second input and a
// second output, so its reduction order is K1's. Like the Pallas kernel it
// norms the f32 sum, not the sum rounded to x's dtype as
// repro.kernels.ref.rmsnorm_residual_ref does; in bfloat16 the two differ
// by about one bf16 rounding of h, inside the 2e-2 bf16 tolerance, and in
// float32 they are the same sum. Bound by bytes: 4 * rows * d * elem (x and
// res read once, y and h written once). On the register route x and res
// stay in registers as loaded and the f32 sum is formed again for the
// second pass; the two-pass route re-reads them (from L2).
extern "C" int rt_rmsnorm_residual(const void* x, int64_t stride, const void* res,
                                   int64_t res_stride, const float* scale, void* y, void* added,
                                   int64_t rows, int d, float eps, int is_bf16, int route,
                                   int threads, int chunks, int vec, void* stream) {
  const rt::Stages none = rt::make_stages(nullptr, nullptr, 0);
  const rt::Residual rs{res, res_stride, added};
  const rt::RowPlan plan{route, threads, chunks, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return rt::launch_rms_rows<__nv_bfloat16, false, true>(
        static_cast<const __nv_bfloat16*>(x), stride, scale, static_cast<__nv_bfloat16*>(y),
        rows, d, eps, none, plan, s, rs);
  }
  return rt::launch_rms_rows<float, false, true>(static_cast<const float*>(x), stride, scale,
                                                 static_cast<float*>(y), rows, d, eps, none,
                                                 plan, s, rs);
}
