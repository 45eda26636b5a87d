// The backward's weight-grad phase (phase 3 of fused_mlp_bwd.cu's K4 and
// K3, and of the wide family's K4w and K3w in fused_mlp_wide.cu): every
// weight grad a product a^T d over all points, read from the feature-major
// workspace rows, as one Hopper GEMM launch (wgrad_bf16) or a plain FMA tile
// (wgrad_f32), each split of the points into its own partial, then the two
// fixed-order reductions of the splits and of the bias partials. Both
// libraries build it; the bf16 kernel runs in thread-block clusters that
// share each K chunk by TMA multicast (launch_wgrad_bf16).

#pragma once

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------------------------- weight grads

// One weight grad C[M][N] = A^T B summed over k: A rows [M][k_len] and B
// rows [N][k_len] (rows of the workspace or of ray_prep's per-ray rows, of
// stride lda), C rows of stride ldc. Split s sums k in [s*split_len,
// (s+1)*split_len) into its own partial slice. The bf16 launch reads A and
// B through tensor maps (src: 0 the workspace, 1 the per-ray rows) at rows
// ra and rb, C in 128 x 256 tiles (mtiles x ntiles) shared out over
// clusters of mc x nc CTAs; the f32 launch reads the pointers, C in 64 x 64
// tiles (mc = nc = 1).
struct Prob {
  const void* A;
  const void* B;
  float* C;
  int M, N, lda, ldc, k_len;
  int ra, rb, src;  // bf16: rows in the map, which map
  int mtiles, ntiles, nsplit, cta0;
  int mc, nc;  // bf16: the cluster's M-tiles and N-tiles
};
constexpr int MAXP = 16;
// The stacked K4 launches its scenes' products as one more grid axis
// (blockIdx.y = the scene): scene s's columns start s * k_len further on in
// A and B, and its partials scene_stride floats on.
struct Probs {
  Prob p[MAXP];
  int count;
  int split_len;
  size_t split_stride;  // floats between two splits' partial slices
  size_t scene_stride;  // floats between two scenes' sets of partials
};

__device__ __forceinline__ const Prob& find_prob(const Probs& P, int& local) {
  int pi = 0;
  while (pi + 1 < P.count && int(blockIdx.x) >= P.p[pi + 1].cta0) ++pi;
  local = blockIdx.x - P.p[pi].cta0;
  return P.p[pi];
}

// The bf16 launch: one CTA a (problem, split, 128 x 256 tile of C), the
// CTAs of a split's C in thread-block clusters of mc x nc tiles, so each
// 64-point K chunk of A and B leaves L2 once a cluster: A's boxes of an
// M-tile go by TMA multicast to the nc CTAs of its row, B's of an N-tile to
// the mc CTAs of its column (the tile's 256-row products 2 x 1; W = 512's
// 512 x 512 ones 4 x 2, the portable most; a C of one tile, and dWout's 4
// columns, 1 x 1). Warpgroup 0 is the producer: one thread keeps a 4-stage
// ring of K chunks (A: 128 rows, or 64 where the tile's M <= 64; B: the
// tile's 256 or 128 columns, one 8-row box for dWout's 4) and issues its
// share of the cluster's boxes, A box i from the row's CTA i % nc, B box j
// from the column's CTA j % mc; each stage's `full` mbarrier expects every
// byte that lands in this CTA. The consumer warpgroups 1 and 2 own 64 rows
// of C each (only 1 where M <= 64) and run wgmma m64nNk16 x 4 a chunk from
// the swizzled tiles, then free the stage on the `empty` mbarrier of every
// CTA that writes into it (its row and column: one arrival a warp, remote
// where not its own), so a producer refills a stage only after each
// receiver's consumers are done with it. Every CTA of a cluster sums the
// same split, so the same chunks; the launch ends on a cluster barrier, so
// no CTA exits while a peer may still write to it. Rows and columns of the
// accumulator beyond M or N are computed (from zeros past the tensor's
// edge, or neighbouring rows) and never stored.
constexpr int WG_THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 = 384 x 168
constexpr int GM = 128, GN = 256, GK = 64, STAGES = 4;
constexpr int BOX = 64;                         // rows of a TMA box (64 x 128 bytes)
constexpr size_t BOX_BYTES = size_t(BOX) * GK * 2;
constexpr size_t A_STAGE = size_t(GM) * GK * 2;   // 16 KB
constexpr size_t B_STAGE = size_t(GN) * GK * 2;   // 32 KB
constexpr size_t WGRAD_SMEM = 1024 + STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * sizeof(uint64_t);
static_assert(A_STAGE % 1024 == 0 && B_STAGE % 1024 == 0, "swizzled tiles on 1024-byte bounds");
static_assert(WGRAD_SMEM <= 232448, "the ring fits in an SM's shared memory");

// The consumer warpgroups an M-tile's rows need.
__host__ __device__ __forceinline__ int tile_wgs(int M, int mi) { return M - mi * GM > 64 ? 2 : 1; }
// The wgmma width of an N-tile of `cols` columns.
__host__ __device__ __forceinline__ int tile_bn(int cols) {
  return cols <= 8 ? 8 : cols <= 128 ? 128 : 256;
}

// A CTA's place: its tile of C, its split, and the CTA ranks whose `empty`
// barriers its consumer warps free: lane l < targets arrives at rank to.
struct Place {
  int split, mi, ni, cols, targets;
  uint32_t to;
};

template <int BN>
__device__ void wgrad_consume(const Prob& P, const Place& pl, int w, int nchunks,
                              size_t split_stride, size_t scene_stride, const unsigned char* ring,
                              uint64_t* full, uint64_t* empty) {
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % STAGES;
    hopper::mbar_wait(&full[s], (c / STAGES) & 1);
    const unsigned char* a = ring + s * (A_STAGE + B_STAGE) + size_t(w) * BOX_BYTES;
    const unsigned char* b = ring + s * (A_STAGE + B_STAGE) + A_STAGE;
    const uint64_t da = hopper::desc_k_sw128(a), db = hopper::desc_k_sw128(b);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < GK / 16; ++k) {
      if constexpr (BN == 256) hopper::wgmma_m64n256k16(acc, da + 2 * k, db + 2 * k);
      else if constexpr (BN == 128) hopper::wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k);
      else hopper::wgmma_m64n8k16(acc, da + 2 * k, db + 2 * k);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (lane < pl.targets) hopper::mbar_arrive_cluster(&empty[s], pl.to);
  }
  // the accumulator fragment (hopper.cuh) to this split's partial
  const int t = threadIdx.x & 127;
  const int row = pl.mi * GM + w * 64 + 16 * (t >> 5) + ((t & 31) >> 2);
  float* C = P.C + size_t(pl.split) * split_stride + size_t(blockIdx.y) * scene_stride +
             size_t(pl.ni) * GN;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int m = row + 8 * ((j >> 1) & 1);
    const int n = 8 * (j >> 2) + 2 * (t & 3);
    if (m < P.M && n < pl.cols)  // N is even: the pair is in or out together
      *reinterpret_cast<float2*>(C + size_t(m) * P.ldc + n) = make_float2(acc[j], acc[j + 1]);
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_bf16(const __grid_constant__ CUtensorMap ws_map, const __grid_constant__ CUtensorMap ws8_map,
           const __grid_constant__ CUtensorMap rws_map, const Probs P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * (A_STAGE + B_STAGE));
  uint64_t* empty = full + STAGES;
  int local;
  const Prob& pr = find_prob(P, local);
  // the problem's clusters in the order split x N x M, its CTAs (cm, cn) at
  // rank cm + mc * cn; past its last, the padding of the grid's last cluster
  const int mc = pr.mc, nc = pr.nc, ctas = mc * nc;
  const bool live = local < pr.nsplit * pr.mtiles * pr.ntiles;
  const int ci = local / ctas, r = local - ci * ctas;
  const int cm = r % mc, cn = r / mc;
  const int cpm = pr.mtiles / mc, per = cpm * (pr.ntiles / nc);
  Place pl;
  pl.split = ci / per;
  const int m0 = (ci % per % cpm) * mc, n0 = (ci % per / cpm) * nc;  // the cluster's first tiles
  pl.mi = m0 + cm;
  pl.ni = n0 + cn;
  pl.cols = min(GN, pr.N - pl.ni * GN);
  const uint32_t first = hopper::cluster_ctarank() - r;  // the rank of the cluster's CTA (0, 0)
  // this CTA's row of the cluster, then the rest of its column
  const int lane = threadIdx.x & 31;
  pl.targets = nc + mc - 1;
  if (lane < nc) {
    pl.to = first + cm + mc * lane;
  } else {
    const int m = lane - nc;
    pl.to = first + (m + (m >= cm)) + mc * cn;
  }
  const int k_begin = pl.split * P.split_len;
  const int nchunks = (min(pr.k_len, k_begin + P.split_len) - k_begin) / GK;  // k_len % 64 == 0
  const int k_scene = int(blockIdx.y) * pr.k_len;  // the scene's first column
  const int nwg = tile_wgs(pr.M, pl.mi);  // consumer warpgroups with rows to own
  const int bn = tile_bn(pl.cols);
  if (threadIdx.x == 0 && live) {
    int frees = nc * nwg;  // consumer warpgroups of the row, then of the rest of the column
    for (int m = 0; m < mc; ++m)
      if (m != cm) frees += tile_wgs(pr.M, m0 + m);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * frees);
    }
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();  // every barrier of the cluster set up before any box or arrival
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && live) {
      const CUtensorMap* amap = pr.src ? &rws_map : &ws_map;
      const CUtensorMap* bmap = bn == 8 ? &ws8_map : amap;
      const int bboxes = bn == 8 ? 1 : bn / BOX;
      const uint32_t bytes = uint32_t(nwg * BOX_BYTES) + (bn == 8 ? 8u * GK * 2 : uint32_t(bboxes * BOX_BYTES));
      uint16_t row_mask = 0;
      for (int n = 0; n < nc; ++n) row_mask |= uint16_t(1u << (first + cm + mc * n));
      const uint16_t col_mask = uint16_t(((1u << mc) - 1) << (first + mc * cn));
      const int ya = pr.ra + pl.mi * GM, yb = pr.rb + pl.ni * GN;
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) hopper::mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        unsigned char* a = ring + s * (A_STAGE + B_STAGE);
        const int k = k_scene + k_begin + c * GK;
        for (int i = cn; i < nwg; i += nc) {
          if (nc == 1)
            hopper::tma_load_2d(a + i * BOX_BYTES, amap, &full[s], k, ya + i * BOX);
          else
            hopper::tma_load_2d_multicast(a + i * BOX_BYTES, amap, &full[s], k, ya + i * BOX,
                                          row_mask);
        }
        for (int j = cm; j < bboxes; j += mc) {
          if (mc == 1)
            hopper::tma_load_2d(a + A_STAGE + j * BOX_BYTES, bmap, &full[s], k, yb + j * BOX);
          else
            hopper::tma_load_2d_multicast(a + A_STAGE + j * BOX_BYTES, bmap, &full[s], k,
                                          yb + j * BOX, col_mask);
        }
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int w = wg - 1;
    if (w < nwg && live) {
      if (bn == 256)
        wgrad_consume<256>(pr, pl, w, nchunks, P.split_stride, P.scene_stride, ring, full, empty);
      else if (bn == 128)
        wgrad_consume<128>(pr, pl, w, nchunks, P.split_stride, P.scene_stride, ring, full, empty);
      else
        wgrad_consume<8>(pr, pl, w, nchunks, P.split_stride, P.scene_stride, ring, full, empty);
    }
  }
  hopper::cluster_sync();  // no CTA leaves while a peer's boxes or arrivals may reach it
}

// ------------------------------------------------------ the bf16 launch (host)

// A bf16 problem's cluster: the largest mc in {4, 2, 1} and nc in {2, 1}
// that divide C's M-tiles and N-tiles (at most 8 CTAs, the portable
// cluster); 1 x 1 for dWout's 4 columns, whose 8-row box is not worth
// sharing. ops/fused_mlp_wide.py's cluster_shape is the same rule.
inline void cluster_shape(int M, int N, int* mc, int* nc) {
  const int mt = (M + GM - 1) / GM, nt = (N + GN - 1) / GN;
  *mc = N <= 8 ? 1 : mt % 4 == 0 ? 4 : mt % 2 == 0 ? 2 : 1;
  *nc = N <= 8 ? 1 : nt % 2 == 0 ? 2 : 1;
}

// A bf16 problem's tiles and cluster are ones the kernel takes.
inline bool cluster_valid(const Prob& q) {
  return q.mtiles == (q.M + GM - 1) / GM && q.ntiles == (q.N + GN - 1) / GN &&
         (q.mc == 1 || q.mc == 2 || q.mc == 4) && (q.nc == 1 || q.nc == 2) &&
         q.mtiles % q.mc == 0 && q.ntiles % q.nc == 0 && (q.N > 8 || q.mc * q.nc == 1);
}

// Lays the bf16 launch out and returns its cluster size, the largest
// problem's mc * nc: the problems by cluster size, largest first (stable),
// each one's CTAs from cta0 on, so every problem starts on a multiple of
// its own cluster and none of its clusters crosses one of the launch's;
// the grid (P.p[P.count].cta0) whole clusters of the launch. The order of
// the problems in the grid changes no sum.
inline int cluster_layout(Probs& P) {
  for (int i = 1; i < P.count; ++i) {
    const Prob q = P.p[i];
    int j = i;
    for (; j > 0 && P.p[j - 1].mc * P.p[j - 1].nc < q.mc * q.nc; --j) P.p[j] = P.p[j - 1];
    P.p[j] = q;
  }
  int cta = 0, cl = 1;
  for (int i = 0; i < P.count; ++i) {
    P.p[i].cta0 = cta;
    cta += P.p[i].mtiles * P.p[i].ntiles * P.p[i].nsplit;
    cl = max(cl, P.p[i].mc * P.p[i].nc);
  }
  P.p[P.count].cta0 = (cta + cl - 1) / cl * cl;
  return cl;
}

inline cudaError_t wgrad_smem_attr() {
  return cudaFuncSetAttribute(wgrad_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(WGRAD_SMEM));
}

// CTAs of wgrad_bf16 resident at once in clusters of cl (the card's most
// active clusters, cudaOccupancyMaxActiveClusters, times cl), asked once a
// device: what the split counts fill (the SMs do not share out into
// clusters of 8 evenly: 132 is no multiple of 8, and a cluster stays in a
// GPC).
inline cudaError_t wgrad_slots(int cl, int* slots) {
  static int known[64][9] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cl < 1 || cl > 8 || dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  if (known[dev][cl] == 0) {
    if ((e = wgrad_smem_attr()) != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unsigned(cl), 1, 1);
    cfg.blockDim = dim3(WG_THREADS, 1, 1);
    cfg.dynamicSmemBytes = WGRAD_SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = unsigned(cl);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(wgrad_bf16), &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    known[dev][cl] = n * cl;
  }
  *slots = known[dev][cl];
  return cudaSuccess;
}

// The last bf16 launch's cluster size, grid and problem count, as the
// libraries report it (nerf_wgrad_last_launch).
inline int* last_wgrad_launch() {
  static int last[4] = {};
  return last;
}

// The bf16 launch of P's problems (laid out here) on the three maps, the
// scenes on grid y, in clusters of the largest problem's size: one
// cudaLaunchKernelEx with a cluster dimension. A launch the card refuses
// returns its error; nothing else runs in its place.
inline cudaError_t launch_wgrad_bf16(const CUtensorMap& ws_map, const CUtensorMap& ws8_map,
                                     const CUtensorMap& rws_map, Probs& P, int scenes,
                                     cudaStream_t s) {
  for (int i = 0; i < P.count; ++i)
    if (!cluster_valid(P.p[i])) return cudaErrorInvalidValue;
  const int cl = cluster_layout(P);
  cudaError_t e = wgrad_smem_attr();
  if (e != cudaSuccess) return e;
  // setmaxnreg moves registers within the pool the CTA got at launch: a
  // smaller pool than the two roles ask for would stall the consumers
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, wgrad_bf16)) != cudaSuccess) return e;
  if (fa.numRegs * WG_THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
    return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(P.p[P.count].cta0), unsigned(scenes), 1);
  cfg.blockDim = dim3(WG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = WGRAD_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int* last = last_wgrad_launch();
  last[0] = cl;
  last[1] = P.p[P.count].cta0;
  last[2] = scenes;
  last[3] = P.count;
  CUtensorMap maps[3] = {ws_map, ws8_map, rws_map};
  void* args[4] = {&maps[0], &maps[1], &maps[2], &P};
  if ((e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(wgrad_bf16), args)) !=
      cudaSuccess)
    return e;
  return cudaGetLastError();
}

constexpr int FM = 64, FK = 32;  // f32 tile: 64 x 64, K chunks of 32

__global__ void __launch_bounds__(THREADS) wgrad_f32(const Probs P) {
  __shared__ float As[FM][FK + 1], Bs[FM][FK + 1];
  int local;
  const Prob& pr = find_prob(P, local);
  const int per = pr.mtiles * pr.ntiles;
  const int split = local / per, rem = local - split * per;
  const int mi = rem / pr.ntiles, ni = rem - mi * pr.ntiles;
  const size_t k_scene = size_t(blockIdx.y) * pr.k_len;  // the scene's first column
  const float* A = static_cast<const float*>(pr.A) + k_scene;
  const float* B = static_cast<const float*>(pr.B) + k_scene;
  const int m0 = mi * FM, n0 = ni * FM;
  const int k_begin = split * P.split_len;
  const int k_end = min(pr.k_len, k_begin + P.split_len);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += FK) {
    for (int idx = tid; idx < FM * FK; idx += THREADS) {
      const int r = idx / FK, k = idx - r * FK;
      As[r][k] = m0 + r < pr.M ? A[size_t(m0 + r) * pr.lda + k0 + k] : 0.f;
      Bs[r][k] = n0 + r < pr.N ? B[size_t(n0 + r) * pr.lda + k0 + k] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < FK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(As[ty * 4 + i][kk], Bs[tx * 4 + j][kk], acc[i][j]);
    __syncthreads();
  }
  float* C = pr.C + size_t(split) * P.split_stride + size_t(blockIdx.y) * P.scene_stride;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < pr.M && n < pr.N) C[size_t(m) * pr.ldc + n] = acc[i][j];
    }
}

// out[j] = sum over the splits in order of part[s][j]; blockIdx.y is the
// scene (the stacked K4: its partials nsplit * n floats on, its grads
// out_stride floats on)
__global__ void reduce_splits(const float* __restrict__ part, int nsplit, size_t n,
                              float* __restrict__ out, size_t out_stride) {
  const size_t j = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  part += size_t(blockIdx.y) * nsplit * n;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[size_t(sp) * n + j];
  out[size_t(blockIdx.y) * out_stride + j] = s;
}

// out[j] = the tiles' bias sums part[t][j]: 8 groups of strided tiles, each
// in tile order, then the groups in order. 32 columns per block; blockIdx.y
// is the scene, as in reduce_splits.
__global__ void reduce_tiles(const float* __restrict__ part, int ntiles, int n,
                             float* __restrict__ out, size_t out_stride) {
  __shared__ float red[8][32];
  const int jj = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + jj;
  part += size_t(blockIdx.y) * ntiles * n;
  out += size_t(blockIdx.y) * out_stride;
  float s = 0.f;
  if (j < n)
    for (int t = grp; t < ntiles; t += 8) s += part[size_t(t) * n + j];
  red[grp][jj] = s;
  __syncthreads();
  if (grp == 0 && j < n) {
    float r = red[0][jj];
    for (int q = 1; q < 8; ++q) r += red[q][jj];
    out[j] = r;
  }
}

}  // namespace
