// The GP cross-covariance backward as one thread per site: the design first
// planned for it, kept to be timed against the shipped kernel.  Not part of
// the library: tools/cross_cov_bwd_probe.py appends this file to
// csrc/gp_kernels.cu (whose bwd_pair, FastOps / IeeeOps, cluster barriers
// and sum_over_clusters it uses) and builds it as its `site_thread` variant.
//
//  * A block of ST_THREADS sites, one a thread; the anchors walked in tiles
//    of ST_TM, staged in shared memory with their columns of G (read
//    coalesced, a row's ST_TM anchors at a time).
//  * A site's six sums in registers across all anchors: no shuffles.
//  * An anchor's sums over the block's sites: each thread stores an
//    output's six values in shared memory; each warp's lanes add its 32
//    sites in order, then the warps' sums are added in order, into the
//    block's sums of every anchor (shared memory, 6 M floats: M <= 4,096).
//  * The sum over blocks in the same launch, as the shipped kernel does it:
//    clusters of up to 8 blocks add their sums through distributed shared
//    memory in rank order, and the cluster that draws the last ticket adds
//    the clusters' sums in cluster order.
// The arithmetic is the shipped kernel's (FastOps, recomputed with IeeeOps
// where flagged), so the two differ in their layout alone.

namespace {

constexpr int ST_THREADS = 128;
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_TM = 8;                       // anchors a tile
constexpr int ST_Q = BW_SUMS * ST_TM;          // one site's values in a tile
constexpr int ST_PAD = ST_Q + 1;               // odd: a warp's rows fall in distinct banks
constexpr int ST_MAX_CLUSTER = 8;

__global__ void __launch_bounds__(ST_THREADS)
cross_cov_bwd_site_thread_kernel(const float* __restrict__ G, const float* __restrict__ xn,
                                 const float* __restrict__ en, const float* __restrict__ xm,
                                 const float* __restrict__ em, float scale, int N, int M,
                                 float* __restrict__ g_xn, float* __restrict__ g_en,
                                 float* __restrict__ g_xm, float* __restrict__ g_em,
                                 float* __restrict__ cpart, unsigned int* __restrict__ counter) {
  extern __shared__ __align__(16) float s_bp[];  // [k][M]: the block's sums of every anchor
  __shared__ float s_g[ST_THREADS][ST_TM + 1];   // the tile's G: [site][anchor]
  __shared__ float s_a[6][ST_TM];                // the tile's anchors: y0 y1 f00 f11 f01 rm
  __shared__ float s_v[ST_THREADS * ST_PAD];     // [site][k][anchor]: the outputs' values
  __shared__ float s_w[ST_WARPS][ST_Q];          // [warp][k][anchor]: a warp's sums
  __shared__ int s_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = cluster.num_blocks(), rank = cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int t = threadIdx.x, lane = t & 31, w = t / 32;
  const int n0 = blockIdx.x * ST_THREADS, n = n0 + t;
  if (t == 0) s_last = 0;  // before the first cluster barrier
  float x0 = 0.0f, x1 = 0.0f, e00 = 1.0f, e11 = 1.0f, e01 = 0.0f;
  if (n < N) {
    x0 = xn[2 * (size_t)n];
    x1 = xn[2 * (size_t)n + 1];
    e00 = en[3 * (size_t)n];
    e11 = en[3 * (size_t)n + 1];
    e01 = en[3 * (size_t)n + 2];
  }
  const float rn = sqrtf(sqrtf(e00 * e11 - e01 * e01));
  float acc[BW_SUMS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int m0 = 0; m0 < M; m0 += ST_TM) {
    const int J = min(ST_TM, M - m0);
    __syncthreads();  // the last tile's shared memory is read
    for (int i = t; i < ST_THREADS * ST_TM; i += ST_THREADS) {
      const int r = i / ST_TM, j = i % ST_TM;
      s_g[r][j] = n0 + r < N && j < J ? G[(size_t)(n0 + r) * M + m0 + j] : 0.0f;
    }
    if (t < ST_TM) {
      float q[6] = {0.0f, 0.0f, 1.0f, 1.0f, 0.0f, 0.0f};
      if (t < J) {
        const size_t m = m0 + t;
        q[0] = xm[2 * m];
        q[1] = xm[2 * m + 1];
        q[2] = em[3 * m];
        q[3] = em[3 * m + 1];
        q[4] = em[3 * m + 2];
        q[5] = sqrtf(sqrtf(q[2] * q[3] - q[4] * q[4]));
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) s_a[k][t] = q[k];
    }
    __syncthreads();

    float v[ST_Q];  // [k][j]
#pragma unroll
    for (int j4 = 0; j4 < ST_TM; j4 += 4) {
      bool slow = false;
#pragma unroll
      for (int j = j4; j < j4 + 4; ++j) {
        const Pair6 p = bwd_pair<FastOps>(s_g[t][j], x0, x1, e00, e11, e01, rn, s_a[0][j],
                                          s_a[1][j], s_a[2][j], s_a[3][j], s_a[4][j], s_a[5][j],
                                          scale, slow);
#pragma unroll
        for (int k = 0; k < BW_SUMS; ++k) v[k * ST_TM + j] = p.v[k];
      }
      if (slow) {  // rare: the four again, with IEEE operations throughout
#pragma unroll
        for (int j = j4; j < j4 + 4; ++j) {
          const Pair6 p = bwd_pair<IeeeOps>(s_g[t][j], x0, x1, e00, e11, e01, rn, s_a[0][j],
                                            s_a[1][j], s_a[2][j], s_a[3][j], s_a[4][j],
                                            s_a[5][j], scale, slow);
#pragma unroll
          for (int k = 0; k < BW_SUMS; ++k) v[k * ST_TM + j] = p.v[k];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ST_Q; ++i) s_v[t * ST_PAD + i] = v[i];
#pragma unroll
    for (int j = 0; j < ST_TM; ++j) {
#pragma unroll
      for (int k = 0; k < BW_SUMS; ++k) acc[k] += v[k * ST_TM + j];
    }
    __syncwarp();
    for (int i = lane; i < ST_Q; i += 32) {  // the warp's 32 sites, in order
      const float* src = s_v + 32 * w * ST_PAD + i;
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) s += src[r * ST_PAD];
      s_w[w][i] = s;
    }
    __syncthreads();
    if (t < ST_Q) {  // the block's: the warps' sums in order
      const int k = t / ST_TM, j = t % ST_TM;
      float s = 0.0f;
#pragma unroll
      for (int b = 0; b < ST_WARPS; ++b) s += s_w[b][t];
      if (j < J) s_bp[k * M + m0 + j] = s;
    }
  }

  if (n < N) {  // the site's grads
    const float g_d = acc[5] / (4.0f * (e00 * e11 - e01 * e01));
    g_xn[2 * (size_t)n] = acc[0];
    g_xn[2 * (size_t)n + 1] = acc[1];
    g_en[3 * (size_t)n] = acc[2] + g_d * e11;
    g_en[3 * (size_t)n + 1] = acc[3] + g_d * e00;
    g_en[3 * (size_t)n + 2] = acc[4] - 2.0f * g_d * e01;
  }
  cluster_arrive();  // every block's s_bp is written
  cluster_wait();
  // the anchors m with m % CL == rank: their sums over the cluster's
  // blocks in rank order, to this cluster's share of scratch
  for (int i = t; i < BW_SUMS * M; i += ST_THREADS) {
    if (i % M % CL != rank) continue;
    float s = 0.0f;
    for (int r = 0; r < CL; ++r) s += cluster.map_shared_rank(s_bp, r)[i];
    cpart[(size_t)cid * BW_SUMS * M + i] = s;
  }
  __threadfence();  // before this cluster's rank 0 takes its ticket
  cluster_arrive();  // every remote read done, the scratch written
  cluster_wait();
  sum_over_clusters(cluster, cpart, counter, &s_last, s_v, ST_THREADS * ST_PAD / BW_SUMS, M,
                    em, g_xm, g_em);
}

int st_blocks(int N) { return (N + ST_THREADS - 1) / ST_THREADS; }

int st_cluster(int N) {
  int c = 1;
  while (c < st_blocks(N) && c < ST_MAX_CLUSTER) c *= 2;
  return c;
}

}  // namespace

extern "C" long long como_cross_covariance_bwd_site_thread_scratch(int N, int M) {
  if (N <= 0 || M <= 0) return 0;
  const int c = st_cluster(N);
  return (long long)((st_blocks(N) + c - 1) / c) * BW_SUMS * M;
}

// The shipped entry point's arguments; `counter` zero before the launch and
// left zero by it.
extern "C" int como_cross_covariance_bwd_site_thread_f32(
    const void* grad, const void* xn, const void* en, const void* xm, const void* em,
    float scale, int N, int M, void* g_xn, void* g_en, void* g_xm, void* g_em, void* scratch,
    void* counter, void* stream) {
  if (N <= 0 || M <= 0 || N > (1 << 28) || M > 4096) return (int)cudaErrorInvalidValue;
  const int c = st_cluster(N);
  const size_t smem = sizeof(float) * BW_SUMS * (size_t)M;
  cudaError_t err = cudaFuncSetAttribute(cross_cov_bwd_site_thread_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((st_blocks(N) + c - 1) / c * c);
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cross_cov_bwd_site_thread_kernel, (const float*)grad,
                           (const float*)xn, (const float*)en, (const float*)xm,
                           (const float*)em, scale, N, M, (float*)g_xn, (float*)g_en,
                           (float*)g_xm, (float*)g_em, (float*)scratch, (unsigned int*)counter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
