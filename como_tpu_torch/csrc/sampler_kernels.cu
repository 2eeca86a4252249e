// Greedy-sampler downdate step for Hopper (sm_90a).
//
// Replaces the TPU kernel como_tpu/gp/sampler_pallas.py::_downdate_kernel
// (called through downdate_step): one greedy conditional-entropy iteration's
// pass over the domain.  For every domain site d, with the chosen site
// (x_i, e_i) and the incremental-Cholesky row l_ni (S,):
//
//   k_id  = k(x_i, x_d)                               (GP cross-covariance)
//   obs   = (k_id - sum_s l_ni[s] * obs_info[s, d]) * sel / l_ii
//   obs_info[row, d] = obs ;  var[d] -= obs^2
//   min_dist[d] = sel ? min(min_dist[d], |x_d - x_i|^2) : min_dist[d]
//
// The per-iteration scalars (x_i, e_i, 1/l_ii, sel, scale) and l_ni are read
// from device memory: they come from an on-device argmax and matvec, so the
// 64-step sampler loop never syncs to the host.
//
// What bounds it on the H100: reading obs_info (S x D f32; 12.6 MB at
// S = 64, D = 49,152) plus ~1.2 MB of domain/var/min_dist traffic, about
// 4 us per launch at 3.35 TB/s.  Design: one thread per domain site; the
// S-row dot product walks obs_info column-wise, so neighbouring threads
// read neighbouring addresses of each row (coalesced).  l_ni and the
// scalars are staged in shared memory once per block.  The new obs row is
// written straight into row `row` of obs_info: each thread reads and
// writes only its own column, and row `row` is still all zeros when it is
// read, so the in-place write is race-free.  Plain sqrtf/expf/division.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void downdate_kernel(const float* __restrict__ xnT,
                                const float* __restrict__ enT,
                                float* __restrict__ obs, float* __restrict__ var,
                                float* __restrict__ md,
                                const float* __restrict__ sc,
                                const float* __restrict__ lni, int S, int D,
                                int row) {
  extern __shared__ float s_l[];  // S floats
  __shared__ float s_sc[8];
  for (int s = threadIdx.x; s < S; s += blockDim.x) s_l[s] = lni[s];
  if (threadIdx.x < 8) s_sc[threadIdx.x] = sc[threadIdx.x];
  __syncthreads();
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;

  const float xi0 = s_sc[0], xi1 = s_sc[1];
  const float f00 = s_sc[2], f11 = s_sc[3], f01 = s_sc[4];
  const float inv_lii = s_sc[5], sel = s_sc[6], scale = s_sc[7];

  const float x0 = xnT[d], x1 = xnT[D + d];
  const float e00 = enT[d], e11 = enT[D + d], e01 = enT[2 * D + d];
  const float d0 = x0 - xi0;
  const float d1 = x1 - xi1;
  const float s00 = e00 + f00;
  const float s11 = e11 + f11;
  const float s01 = e01 + f01;
  const float inv_det = 1.0f / (s00 * s11 - s01 * s01);
  const float Q = 0.5f * inv_det *
                  (s11 * d0 * d0 - 2.0f * s01 * d0 * d1 + s00 * d1 * d1);
  const float det_n = e00 * e11 - e01 * e01;
  const float det_m = f00 * f11 - f01 * f01;
  const float pos = inv_det < 0.0f ? 0.0f : inv_det;  // NaN propagates
  const float C = 2.0f * sqrtf(sqrtf(det_n * det_m)) * sqrtf(pos + 1e-8f);
  const float t = 1.7320508075688772f * sqrtf(Q + 1e-8f);
  const float k_id = scale * C * (1.0f + t) * expf(-t);

  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += s_l[s] * obs[(size_t)s * D + d];
  const float o = (k_id - acc) * (inv_lii * sel);
  obs[(size_t)row * D + d] = o;
  var[d] = var[d] - o * o;
  const float d2 = d0 * d0 + d1 * d1;
  const float m = md[d];
  md[d] = sel > 0.0f ? fminf(m, d2) : m;
}

}  // namespace

extern "C" int como_downdate_step_f32(const void* xnT, const void* enT,
                                      void* obs, void* var, void* md,
                                      const void* sc, const void* lni, int S,
                                      int D, int row, void* stream) {
  if (D == 0) return 0;
  const int grid = (D + BLOCK - 1) / BLOCK;
  downdate_kernel<<<grid, BLOCK, S * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)xnT, (const float*)enT, (float*)obs, (float*)var,
      (float*)md, (const float*)sc, (const float*)lni, S, D, row);
  return (int)cudaGetLastError();
}
