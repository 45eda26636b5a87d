// The backward's weight-grad phase (phase 3 of fused_mlp_bwd.cu's K4 and
// K3, and of the wide family's K4w and K3w in fused_mlp_wide.cu): every
// weight grad a product a^T d over all points, read from the feature-major
// workspace rows, as one Hopper GEMM launch (wgrad_bf16) or a plain FMA tile
// (wgrad_f32), each split of the points into its own partial, then the two
// fixed-order reductions of the splits and of the bias partials. Moved here
// unchanged from fused_mlp_bwd.cu so that both libraries build it.

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
// ra and rb; the f32 launch through the pointers.
struct Prob {
  const void* A;
  const void* B;
  float* C;
  int M, N, lda, ldc, k_len;
  int ra, rb, src, bn;  // bf16: rows in the map, which map, the tile's width (8, 128, 256)
  int mtiles, ntiles, nsplit, cta0;
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

// The bf16 launch: one CTA a (problem, split, 128-row tile of C), C's full
// width N <= 256 in one tile, so each A row is read once and each B row
// once per 128 rows of C (twice for the 256-row products; the two tiles
// are neighbours in the grid and meet in L2). Warpgroup 0 is the producer:
// one thread keeps a 4-stage ring of 64-point K chunks filled by TMA (A:
// 128 rows, or 64 when M <= 64; B: N rows, one 8-row box for dWout's 4
// columns), each stage behind a `full` mbarrier that counts the bytes. The
// consumer warpgroups 1 and 2 own 64 rows of C each (only 1 when M <= 64)
// and run wgmma m64nNk16 x 4 a chunk from the swizzled tiles, then free the
// stage on its `empty` mbarrier (one arrival a warp). Rows and columns of
// the accumulator beyond M or N are computed (from zeros past the tensor's
// edge, or neighbouring rows) and never stored.
constexpr int WG_THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 = 384 x 168
constexpr int GM = 128, GK = 64, STAGES = 4;
constexpr int BOX = 64;                         // rows of a TMA box (64 x 128 bytes)
constexpr size_t BOX_BYTES = size_t(BOX) * GK * 2;
constexpr size_t A_STAGE = size_t(GM) * GK * 2;   // 16 KB
constexpr size_t B_STAGE = size_t(256) * GK * 2;  // 32 KB
constexpr size_t WGRAD_SMEM = 1024 + STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * sizeof(uint64_t);
static_assert(A_STAGE % 1024 == 0 && B_STAGE % 1024 == 0, "swizzled tiles on 1024-byte bounds");
static_assert(WGRAD_SMEM <= 232448, "the ring fits in an SM's shared memory");

template <int BN>
__device__ void wgrad_consume(const Prob& P, int split, int mi, int w, int nchunks,
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
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  // the accumulator fragment (hopper.cuh) to this split's partial
  const int t = threadIdx.x & 127;
  const int row = mi * GM + w * 64 + 16 * (t >> 5) + ((t & 31) >> 2);
  float* C = P.C + size_t(split) * split_stride + size_t(blockIdx.y) * scene_stride;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int m = row + 8 * ((j >> 1) & 1);
    const int n = 8 * (j >> 2) + 2 * (t & 3);
    if (m < P.M && n < P.N)  // N is even: the pair is in or out together
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
  const int split = local / pr.mtiles, mi = local - split * pr.mtiles;
  const int k_begin = split * P.split_len;
  const int nchunks = (min(pr.k_len, k_begin + P.split_len) - k_begin) / GK;  // k_len % 64 == 0
  const int k_scene = int(blockIdx.y) * pr.k_len;  // the scene's first column
  const int nwg = pr.M - mi * GM > 64 ? 2 : 1;  // consumer warpgroups with rows to own
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * nwg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const CUtensorMap* amap = pr.src ? &rws_map : &ws_map;
      const CUtensorMap* bmap = pr.bn == 8 ? &ws8_map : amap;
      const int bboxes = pr.bn == 8 ? 1 : pr.bn / BOX;
      const uint32_t bytes = uint32_t(nwg * BOX_BYTES) + (pr.bn == 8 ? 8u * GK * 2 : uint32_t(bboxes * BOX_BYTES));
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) hopper::mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        unsigned char* a = ring + s * (A_STAGE + B_STAGE);
        const int k = k_scene + k_begin + c * GK;
        for (int i = 0; i < nwg; ++i)
          hopper::tma_load_2d(a + i * BOX_BYTES, amap, &full[s], k, pr.ra + mi * GM + i * BOX);
        for (int i = 0; i < bboxes; ++i)
          hopper::tma_load_2d(a + A_STAGE + i * BOX_BYTES, bmap, &full[s], k, pr.rb + i * BOX);
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int w = wg - 1;
    if (w < nwg) {
      if (pr.bn == 256)
        wgrad_consume<256>(pr, split, mi, w, nchunks, P.split_stride, P.scene_stride, ring, full,
                           empty);
      else if (pr.bn == 128)
        wgrad_consume<128>(pr, split, mi, w, nchunks, P.split_stride, P.scene_stride, ring, full,
                           empty);
      else
        wgrad_consume<8>(pr, split, mi, w, nchunks, P.split_stride, P.scene_stride, ring, full,
                         empty);
    }
  }
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
