// The fused NeRF MLP's wide kernel family for Hopper (sm_90a): K1-K6 at
// every width and octave count that nerf_tpu's kernels take
// (nerf_tpu/ops/fused_mlp.py::supports: depth 8, skip at 4, viewdirs, any
// width % 128 == 0, any octave count) and that the W <= 256 tile of
// fwd_tile_sm90.cuh is not built for: W not in {128, 256}, or 3 + 6 Fp > 64
// point or 3 + 6 Fv > 32 view embedding columns.
//
// K1w replaces nerf_tpu/ops/fused_mlp.py::_fwd_kernel_rays and K2w its
// _fwd_kernel at those configurations; K4w and K3w replace
// _make_bwd_kernel_rays and _make_bwd_kernel; K5w and K6w (with
// fused_render.cu's compositing launches) replace
// nerf_tpu/experimental/fused_render.py::_fwd_kernel and _make_bwd_kernel.
// The math and its rounding points are the W <= 256 kernels'
// (fused_mlp_fwd.cu and fused_mlp_bwd.cu's headers), with the embedding
// widths padded to KE = round_up(3 + 6 Fp, 64) and KV = round_up(3 + 6 Fv, 32).
//
// Design: every activation lives feature-major in device memory, a row per
// feature and a column per point ([feature][point], the backward's
// workspace rows, ops/fused_mlp.py::ws_rows), and every layer is one launch
// of one GEMM, C[M][N] = sum over its sources of A_s[M][k_s] B_s[k_s][N]:
// A a block of weights (K-major rows in device memory), B a block of rows
// (N = points), an epilogue that adds a bias and a per-view term
// (add[m][n / add_div]), applies the relu or a relu mask (the sign of an
// activation row), rounds and stores rows, stores f32 rows, and sums each
// row over each 128-point tile (the bias grads' partials). The forward is
// the layers in order with W^T as A (K1w, K2w, the backward's recompute),
// the cotangent chain the same GEMM with W as A (the rank-4 terms of gc are
// a source of k = 4 with Wout's rows zero-padded to 8), and the weight
// grads wgrad_sm90.cuh's launch over the same rows (phase 3 of the W <= 256
// backward, unchanged). Small kernels around it: the embedding rows
// (embed_cols), the head (head_cols: raw from the hv and h7 rows), the
// cotangent rows gc (gc_rows), the per-ray sums of d_hv (ray_sums) and the
// posenc backward for K3w's dx and dv (embed_backward_cols). The launch plan
// is ops/fused_mlp_wide.py's; each launch here is one of its primitives.
//
// The bf16 GEMM (gemm_bf16_sm90): a CTA of 384 threads owns a 128 x 128
// tile of C (128 rows, 128 points); warpgroup 0's thread 0 keeps a 4-stage
// ring of 64-deep K chunks filled by TMA (A: 64-row boxes of 64 K values,
// the K-major 128-byte-swizzled tile of hopper.cuh; B: two boxes of 64 K
// rows x 64 points, the MN-major 128-byte-swizzled tile), each stage behind
// an mbarrier that counts its bytes; warpgroups 1 and 2 own 64 rows each
// (one when the tile has <= 64 rows) and run wgmma m64n64k16 twice a 16-deep
// K step, B transposed (MN-major), into two 64 x 64 f32 accumulators, then
// free the stage. K beyond a source's k and rows beyond M come in as zeros
// (TMA fills past a tensor map's edge). The f32 GEMM (gemm_f32) is a plain
// 64 x 128 FMA tile (no TF32) with the same epilogue.
//
// Bound: at W = 512 with 10/4 octaves the forward is 4,601,856 FLOP a point
// (3.88x W = 256's 1,186,816), bound by operations: >= 39.0 ms for a
// 32,768-ray chunk at 64 + 192 samples at 989 TFLOP/s. This family moves
// every activation through device memory (~2 x W bf16 a layer a point),
// which the W <= 256 tile keeps on chip; it is built to be right first.

#include "fused_mlp_common.cuh"
#include "hopper.cuh"
#include "wgrad_sm90.cuh"

namespace {

constexpr int WIDE_TILE = 128;  // points of a GEMM tile and of a bias partial
constexpr int EW_THREADS = 128;  // the small kernels' blocks

// ------------------------------------------------------------ embeddings

// Column p of the embedding rows: out[k][p] = [x | sin(x 2^f) f-major |
// cos(x 2^f)], zero-padded to K rows, at the point (or direction) of
// column p < n, and at x = 0 for the padded columns n <= p < ncols. The
// arithmetic is fused_mlp_common.cuh's embed_row (sincosf with its range
// reduction, exact scaling by 2^f, no FMA contraction).
template <typename T, typename In>
__global__ void __launch_bounds__(EW_THREADS)
embed_cols(const In in, int n, int F, int K, T* __restrict__ out, size_t ld, int ncols) {
  const int p = blockIdx.x * EW_THREADS + threadIdx.x;
  if (p >= ncols) return;
  float x[3] = {0.f, 0.f, 0.f};
  if (p < n) in.point(p, x);
#pragma unroll
  for (int d = 0; d < 3; ++d) out[size_t(d) * ld + p] = from_f<T>(x[d]);
  for (int f = 0; f < F; ++f) {
    const float scale = float(1 << f);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s, c;
      sincosf(__fmul_rn(x[d], scale), &s, &c);
      out[size_t(3 + f * 3 + d) * ld + p] = from_f<T>(s);
      out[size_t(3 + 3 * F + f * 3 + d) * ld + p] = from_f<T>(c);
    }
  }
  for (int k = 3 + 6 * F; k < K; ++k) out[size_t(k) * ld + p] = from_f<T>(0.f);
}

// dx[p] of the point (or direction) y[p], p < n, from the f32 cotangent rows
// de[k][p] of its embedding: de[d] + sum over f of 2^f (de[sin f, d]
// cos(y_d 2^f) - de[cos f, d] sin(y_d 2^f)), as embed_row_backward.
__global__ void __launch_bounds__(EW_THREADS)
embed_backward_cols(const float* __restrict__ y, int n, int F, const float* __restrict__ de,
                    size_t ld, float* __restrict__ out) {
  const int p = blockIdx.x * EW_THREADS + threadIdx.x;
  if (p >= n) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x = y[size_t(p) * 3 + d];
    float acc = 0.f;
    for (int f = 0; f < F; ++f) {
      const float scale = float(1 << f);
      float s, c;
      sincosf(__fmul_rn(x, scale), &s, &c);
      const float d_xb = __fsub_rn(__fmul_rn(de[size_t(3 + f * 3 + d) * ld + p], c),
                                   __fmul_rn(de[size_t(3 + 3 * F + f * 3 + d) * ld + p], s));
      acc = __fadd_rn(acc, __fmul_rn(scale, d_xb));
    }
    out[size_t(p) * 3 + d] = __fadd_rn(de[size_t(d) * ld + p], acc);
  }
}

// ------------------------------------------------------------------ head

// raw of point p < n: hv[:, p] Wout[:W/2] + h7[:, p] Wout[W/2:] + bout, to
// out[c * sc + p * sp] (planes: sc = N, sp = 1; rows: sc = 1, sp = 4).
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
head_cols(const T* __restrict__ hv, const T* __restrict__ h7, size_t ld, int n, int W,
          const T* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ out,
          size_t sc, size_t sp) {
  const int p = blockIdx.x * EW_THREADS + threadIdx.x;
  if (p >= n) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < W / 2; ++k) {
    const float h = to_f(hv[size_t(k) * ld + p]);
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = fmaf(h, to_f(wout[k * 4 + c]), a[c]);
  }
  for (int k = 0; k < W; ++k) {
    const float h = to_f(h7[size_t(k) * ld + p]);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = fmaf(h, to_f(wout[(W / 2 + k) * 4 + c]), b[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * sc + size_t(p) * sp] = (a[c] + b[c]) + bout[c];
}

// ------------------------------------------------------ backward helpers

// gc rows: rows[c][p] = g of channel c at point p < n, rounded (0 past n),
// rows 4..7 zero (read by the weight grads' 8-row box of dWout); and each
// 128-point tile's f32 sums of g (dbout's partials) at bsum[tile][c].
template <typename T>
__global__ void __launch_bounds__(WIDE_TILE)
gc_rows(const float* __restrict__ g, size_t gsc, size_t gsp, int n, T* __restrict__ rows,
        size_t ld, float* __restrict__ bsum, size_t ld_bsum) {
  __shared__ float part[4][WIDE_TILE];
  const int i = threadIdx.x, p = blockIdx.x * WIDE_TILE + i;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float v = p < n ? g[c * gsc + size_t(p) * gsp] : 0.f;
    rows[size_t(c) * ld + p] = from_f<T>(v);
    rows[size_t(c + 4) * ld + p] = from_f<T>(0.f);
    part[c][i] = v;
  }
  __syncthreads();
  if (i < 4) {
    float s = 0.f;
    for (int q = 0; q < WIDE_TILE; ++q) s += part[i][q];
    bsum[size_t(blockIdx.x) * ld_bsum + i] = s;
  }
}

// Per ray r < rpad: out[c][r] = the f32 sum over its spr samples of
// dhv32[c][r * spr + j], in sample order, rounded (0 for r >= n_rays):
// the d_hv of a direction per ray, for dWve and d_ev.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
ray_sums(const float* __restrict__ dhv32, size_t ld32, int n_rays, int spr, int H,
         T* __restrict__ out, size_t ld_out, int rpad) {
  const size_t idx = size_t(blockIdx.x) * EW_THREADS + threadIdx.x;
  if (idx >= size_t(H) * rpad) return;
  const int c = int(idx / rpad), r = int(idx - size_t(c) * rpad);
  float s = 0.f;
  if (r < n_rays)
    for (int j = 0; j < spr; ++j) s += dhv32[size_t(c) * ld32 + size_t(r) * spr + j];
  out[size_t(c) * ld_out + r] = from_f<T>(s);
}

// ------------------------------------------------------------------ GEMM

// One GEMM launch: C[M][N] = A0[M][k0] B0[k0][N] (+ A1[M][k1] B1[k1][N]),
// then per element v = C + add[m][n / add_div] + bias[m], relu, zero where
// mask[m][n] is not positive, out[m][n] = v rounded, out32[m][n] = v, and
// bsum[n / 128][m] = the sum of v over the tile's 128 columns (each pointer
// null: that step skipped). Rows are strided by their ld (elements).
struct GemmArgs {
  int M, N, k0, k1, kc0, kc1;  // kc: the 64-deep chunks of each source (bf16)
  const void* a0;
  long long lda0;
  const void* b0;
  long long ldb0;
  const void* a1;
  long long lda1;
  const void* b1;
  long long ldb1;
  const float* bias;
  const float* add;
  long long ld_add;
  int add_div;
  const void* mask;
  long long ld_mask;
  int relu;
  void* out;
  long long ld_out;
  float* out32;
  long long ld_out32;
  float* bsum;
  long long ld_bsum;
};

template <typename T> struct Pair;
template <> struct Pair<bf16> {
  typedef __nv_bfloat162 type;
  __device__ static float2 get(type v) { return __bfloat1622float2(v); }
  __device__ static type make(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <> struct Pair<float> {
  typedef float2 type;
  __device__ static float2 get(type v) { return v; }
  __device__ static type make(float a, float b) { return make_float2(a, b); }
};

// The epilogue of the elements (m, n) and (m, n + 1), n even: returns their
// values before rounding.
template <typename T>
__device__ __forceinline__ float2 epi_pair(const GemmArgs& g, int m, int n, float v0, float v1) {
  typedef typename Pair<T>::type T2;
  if (g.add != nullptr) {
    const float* a = g.add + size_t(m) * g.ld_add;
    v0 += a[n / g.add_div];
    v1 += a[(n + 1) / g.add_div];
  }
  if (g.bias != nullptr) {
    const float b = g.bias[m];
    v0 += b;
    v1 += b;
  }
  if (g.relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  if (g.mask != nullptr) {
    const float2 k = Pair<T>::get(
        *reinterpret_cast<const T2*>(static_cast<const T*>(g.mask) + size_t(m) * g.ld_mask + n));
    if (!(k.x > 0.f)) v0 = 0.f;
    if (!(k.y > 0.f)) v1 = 0.f;
  }
  if (g.out != nullptr)
    *reinterpret_cast<T2*>(static_cast<T*>(g.out) + size_t(m) * g.ld_out + n) =
        Pair<T>::make(v0, v1);
  if (g.out32 != nullptr)
    *reinterpret_cast<float2*>(g.out32 + size_t(m) * g.ld_out32 + n) = make_float2(v0, v1);
  return make_float2(v0, v1);
}

constexpr int GEMM_THREADS = 384;  // a producer and two consumer warpgroups
constexpr int GT_M = 128, GT_K = 64, GEMM_STAGES = 4;
constexpr size_t GT_BOX = size_t(64) * 128;  // a 64 x 64 bf16 box: 8 KB
constexpr size_t GT_A = 2 * GT_BOX, GT_B = 2 * GT_BOX;
constexpr size_t GEMM_STAGE = GT_A + GT_B;
constexpr size_t GEMM_SMEM = 1024 + GEMM_STAGES * GEMM_STAGE + 2 * GEMM_STAGES * sizeof(uint64_t);
static_assert(WIDE_TILE == 128 && GT_BOX % 1024 == 0, "two 64-point boxes a tile");
static_assert(GEMM_SMEM <= 232448, "the ring fits in an SM's shared memory");

// The descriptor of an MN-major operand tile with the 128-byte swizzle at p:
// rows of 64 bf16 along N (128 bytes), one row per K index, 8-row groups
// 1024 bytes apart. A tile here is 64 wide along N, one swizzle atom, so
// only the stride between 8-row groups along K matters; both offset fields
// hold it (1024 bytes). Adding 128 to it moves the start 16 K rows on.
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p) {
  const uint64_t a = hopper::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// D[64][64] += A[64][16] B[16][64]: A K-major, B MN-major (transposed), both
// 128-byte-swizzled in shared memory, bf16 operands, f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k16_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// One m64n64 accumulator fragment (hopper.cuh: element j at row r0 +
// 8 ((j / 2) % 2), column n0 + 8 (j / 4) + j % 2) through the epilogue in
// pairs of neighbouring columns, adding each row's values to s0 (row r0)
// and s1 (row r0 + 8).
__device__ __forceinline__ void epi_fragment(const GemmArgs& g, const float (&acc)[32], int r0,
                                             int n0, float& s0, float& s1) {
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int m = r0 + 8 * ((j >> 1) & 1);
    if (m < g.M) {
      const float2 v = epi_pair<bf16>(g, m, n0 + 8 * (j >> 2), acc[j], acc[j + 1]);
      if ((j >> 1) & 1)
        s1 += v.x + v.y;
      else
        s0 += v.x + v.y;
    }
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_bf16_sm90(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
               const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
               const __grid_constant__ GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GEMM_STAGES * GEMM_STAGE);
  uint64_t* empty = full + GEMM_STAGES;
  const int mtiles = (g.M + GT_M - 1) / GT_M;
  const int mt = blockIdx.x % mtiles, nt = blockIdx.x / mtiles;
  const int nwg = g.M - mt * GT_M > 64 ? 2 : 1;  // consumer warpgroups with rows to own
  const int nchunks = g.kc0 + g.kc1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * nwg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // producer
    if (threadIdx.x == 0) {
      const uint32_t bytes = uint32_t(nwg * GT_BOX + GT_B);
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % GEMM_STAGES;
        if (c >= GEMM_STAGES) hopper::mbar_wait(&empty[s], ((c / GEMM_STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        unsigned char* st = ring + s * GEMM_STAGE;
        const bool second = c >= g.kc0;
        const CUtensorMap* am = second ? &a1 : &a0;
        const CUtensorMap* bm = second ? &b1 : &b0;
        const int k = (second ? c - g.kc0 : c) * GT_K;
        for (int i = 0; i < nwg; ++i)
          hopper::tma_load_2d(st + i * GT_BOX, am, &full[s], k, mt * GT_M + i * 64);
        for (int i = 0; i < 2; ++i)
          hopper::tma_load_2d(st + GT_A + i * GT_BOX, bm, &full[s], nt * WIDE_TILE + i * 64, k);
      }
    }
    return;
  }
  const int w = wg - 1;
  if (w >= nwg) return;
  float acc0[32], acc1[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    acc0[j] = 0.f;
    acc1[j] = 0.f;
  }
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % GEMM_STAGES;
    hopper::mbar_wait(&full[s], (c / GEMM_STAGES) & 1);
    const unsigned char* st = ring + s * GEMM_STAGE;
    const uint64_t da = hopper::desc_k_sw128(st + w * GT_BOX);
    const uint64_t db0 = desc_mn_sw128(st + GT_A), db1 = desc_mn_sw128(st + GT_A + GT_BOX);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < GT_K / 16; ++k) {
      wgmma_m64n64k16_tb(acc0, da + 2 * k, db0 + 128 * k);
      wgmma_m64n64k16_tb(acc1, da + 2 * k, db1 + 128 * k);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  // the accumulator fragments (hopper.cuh) through the epilogue; each row's
  // sum over the tile by the 4 lanes that share it
  const int r0 = mt * GT_M + w * 64 + 16 * warp + (lane >> 2);
  float s0 = 0.f, s1 = 0.f;
  epi_fragment(g, acc0, r0, nt * WIDE_TILE + 2 * (lane & 3), s0, s1);
  epi_fragment(g, acc1, r0, nt * WIDE_TILE + 64 + 2 * (lane & 3), s0, s1);
  if (g.bsum != nullptr) {  // the same for the whole grid
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if ((lane & 3) == 0) {
      if (r0 < g.M) g.bsum[size_t(nt) * g.ld_bsum + r0] = s0;
      if (r0 + 8 < g.M) g.bsum[size_t(nt) * g.ld_bsum + r0 + 8] = s1;
    }
  }
}

constexpr int F_M = 64, F_K = 32;  // the f32 tile: 64 rows x 128 points, K chunks of 32

__global__ void __launch_bounds__(256) gemm_f32(const __grid_constant__ GemmArgs g) {
  __shared__ float As[F_M][F_K + 1];
  __shared__ float Bs[F_K][WIDE_TILE];
  const int mtiles = (g.M + F_M - 1) / F_M;
  const int mt = blockIdx.x % mtiles, nt = blockIdx.x / mtiles;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int src = 0; src < 2; ++src) {
    const int K = src ? g.k1 : g.k0;
    const float* A = static_cast<const float*>(src ? g.a1 : g.a0);
    const float* B = static_cast<const float*>(src ? g.b1 : g.b0);
    const size_t lda = size_t(src ? g.lda1 : g.lda0), ldb = size_t(src ? g.ldb1 : g.ldb0);
    for (int k0 = 0; k0 < K; k0 += F_K) {
      for (int idx = tid; idx < F_M * F_K; idx += 256) {
        const int r = idx / F_K, k = idx - r * F_K, m = mt * F_M + r;
        As[r][k] = m < g.M && k0 + k < K ? A[size_t(m) * lda + k0 + k] : 0.f;
      }
      for (int idx = tid; idx < F_K * WIDE_TILE; idx += 256) {
        const int k = idx / WIDE_TILE, c = idx - k * WIDE_TILE;
        Bs[k][c] = k0 + k < K ? B[size_t(k0 + k) * ldb + size_t(nt) * WIDE_TILE + c] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < F_K; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mt * F_M + ty * 4 + i;
    float s = 0.f;
    if (m < g.M) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float2 v =
            epi_pair<float>(g, m, nt * WIDE_TILE + tx * 8 + j, acc[i][j], acc[i][j + 1]);
        s += v.x + v.y;
      }
    }
    if (g.bsum != nullptr) {  // the 16 lanes of a row group (tx), in a fixed order
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tx == 0 && m < g.M) g.bsum[size_t(nt) * g.ld_bsum + m] = s;
    }
  }
}

// The tensor map of a bf16 operand [rows][cols] at base, rows `stride`
// elements apart, read in boxes of 64 columns x 64 rows with the 128-byte
// swizzle; past its edge TMA reads zeros.
cudaError_t encode_operand(CUtensorMap* map, const void* base, long long rows, long long cols,
                           long long stride) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (stride * 2) % 16 != 0 || rows < 1 ||
      cols < 1 || stride < cols)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(stride) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

#define NERF_CHECK(x)                 \
  do {                                \
    cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

unsigned blocks_of(long long n, int per) { return unsigned((n + per - 1) / per); }

}  // namespace

// Every entry returns a cudaError_t code (0 on success); the launches go on
// `stream` and do not synchronise. Pointers are device pointers; row
// operands are bf16 if use_bf16 else f32, other buffers f32; ld, lda, ldb
// count elements.

// The embedding rows out[K][ld] for columns 0 .. ncols-1: of the points of
// a ray batch (rays: x = ro[r] + rd[r] z[p], r = p / spr) or of x [n][3]
// (views: x = the directions), F octaves, zero-padded to K rows.
extern "C" int nerf_wide_embed(int use_bf16, int rays, const float* ro, const float* rd,
                               const float* z, const float* x, int n, int spr, int F, int K,
                               void* out, long long ld, int ncols, void* stream) {
  if (n < 0 || ncols < n || spr < 1 || F < 1 || F > 30 || K < 3 + 6 * F || ld < ncols)
    return cudaErrorInvalidValue;
  if (ncols == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_of(ncols, EW_THREADS);
  if (rays) {
    const RaysIn in{ro, rd, z, nullptr, spr};
    if (use_bf16)
      embed_cols<bf16><<<grid, EW_THREADS, 0, s>>>(in, n, F, K, static_cast<bf16*>(out), ld, ncols);
    else
      embed_cols<float><<<grid, EW_THREADS, 0, s>>>(in, n, F, K, static_cast<float*>(out), ld,
                                                    ncols);
  } else {
    const PointsIn in{x, nullptr, 1};
    if (use_bf16)
      embed_cols<bf16><<<grid, EW_THREADS, 0, s>>>(in, n, F, K, static_cast<bf16*>(out), ld, ncols);
    else
      embed_cols<float><<<grid, EW_THREADS, 0, s>>>(in, n, F, K, static_cast<float*>(out), ld,
                                                    ncols);
  }
  return cudaGetLastError();
}

// One GEMM launch (GemmArgs above): M rows, N columns (a multiple of 128),
// source s: A_s [M][k_s] rows lda_s apart and B_s [k_s][N] rows ldb_s apart
// (k1 = 0: one source); bias [M]; add [M][ld_add], column n / add_div; mask
// [M][ld_mask]; out [M][ld_out]; out32 [M][ld_out32]; bsum [N/128][ld_bsum].
extern "C" int nerf_wide_gemm(int use_bf16, int M, int N, const void* a0, long long lda0, int k0,
                              const void* b0, long long ldb0, const void* a1, long long lda1,
                              int k1, const void* b1, long long ldb1, const float* bias,
                              const float* add, long long ld_add, int add_div, const void* mask,
                              long long ld_mask, int relu, void* out, long long ld_out,
                              float* out32, long long ld_out32, float* bsum, long long ld_bsum,
                              void* stream) {
  if (M < 1 || N < 0 || N % WIDE_TILE != 0 || k0 < 1 || k1 < 0 || lda0 < k0 ||
      (k1 > 0 && lda1 < k1) || ldb0 < N || (k1 > 0 && ldb1 < N) || add_div < 1 ||
      (add != nullptr && ld_add < 1) || (mask != nullptr && ld_mask < N) ||
      (out != nullptr && ld_out < N) || (out32 != nullptr && ld_out32 < N) ||
      (bsum != nullptr && ld_bsum < M))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const GemmArgs g{M,    N,    k0,   k1,     (k0 + GT_K - 1) / GT_K, (k1 + GT_K - 1) / GT_K,
                   a0,   lda0, b0,   ldb0,   a1,      lda1,  b1,   ldb1,
                   bias, add,  ld_add, add_div, mask, ld_mask, relu, out, ld_out,
                   out32, ld_out32, bsum, ld_bsum};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = N / WIDE_TILE;
  if (!use_bf16) {
    const long long ctas = ntiles * ((M + F_M - 1) / F_M);
    if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
    gemm_f32<<<unsigned(ctas), 256, 0, s>>>(g);
    return cudaGetLastError();
  }
  CUtensorMap ma0, mb0, ma1, mb1;
  NERF_CHECK(encode_operand(&ma0, a0, M, k0, lda0));
  NERF_CHECK(encode_operand(&mb0, b0, k0, N, ldb0));
  if (k1 > 0) {
    NERF_CHECK(encode_operand(&ma1, a1, M, k1, lda1));
    NERF_CHECK(encode_operand(&mb1, b1, k1, N, ldb1));
  } else {
    ma1 = ma0;  // no chunk reads them
    mb1 = mb0;
  }
  const long long ctas = ntiles * ((M + GT_M - 1) / GT_M);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  NERF_CHECK(cudaFuncSetAttribute(gemm_bf16_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(GEMM_SMEM)));
  gemm_bf16_sm90<<<unsigned(ctas), GEMM_THREADS, GEMM_SMEM, s>>>(ma0, mb0, ma1, mb1, g);
  return cudaGetLastError();
}

// raw of points 0 .. n-1 from the hv [W/2][ld] and h7 [W][ld] rows, Wout
// [3W/2][4] and bout [4] to out[c * sc + p * sp].
extern "C" int nerf_wide_head(int use_bf16, const void* hv, const void* h7, long long ld, int n,
                              int width, const void* wout, const float* bout, float* out,
                              long long sc, long long sp, void* stream) {
  if (n < 0 || ld < n || width < 2) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_of(n, EW_THREADS);
  if (use_bf16)
    head_cols<bf16><<<grid, EW_THREADS, 0, s>>>(static_cast<const bf16*>(hv),
                                                static_cast<const bf16*>(h7), ld, n, width,
                                                static_cast<const bf16*>(wout), bout, out, sc, sp);
  else
    head_cols<float><<<grid, EW_THREADS, 0, s>>>(static_cast<const float*>(hv),
                                                 static_cast<const float*>(h7), ld, n, width,
                                                 static_cast<const float*>(wout), bout, out, sc,
                                                 sp);
  return cudaGetLastError();
}

// The cotangent rows gc [8][ld] for columns 0 .. ncols-1 (a multiple of 128)
// from g (channel c of point p at g[c * gsc + p * gsp], p < n), and each
// 128-point tile's sums of g at bsum[tile * ld_bsum + c].
extern "C" int nerf_wide_gc(int use_bf16, const float* g, long long gsc, long long gsp, int n,
                            int ncols, void* rows, long long ld, float* bsum, long long ld_bsum,
                            void* stream) {
  if (n < 0 || ncols < n || ncols % WIDE_TILE != 0 || ld < ncols || ld_bsum < 4)
    return cudaErrorInvalidValue;
  if (ncols == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned(ncols / WIDE_TILE);
  if (use_bf16)
    gc_rows<bf16><<<grid, WIDE_TILE, 0, s>>>(g, gsc, gsp, n, static_cast<bf16*>(rows), ld, bsum,
                                             ld_bsum);
  else
    gc_rows<float><<<grid, WIDE_TILE, 0, s>>>(g, gsc, gsp, n, static_cast<float*>(rows), ld,
                                              bsum, ld_bsum);
  return cudaGetLastError();
}

// out[c][r] (c < H, r < rpad; ld_out apart) = the sum over ray r's spr
// samples of dhv32[c][r * spr + j] (rows ld32 apart), rounded; 0 past n_rays.
extern "C" int nerf_wide_ray_sums(int use_bf16, const float* dhv32, long long ld32, int n_rays,
                                  int spr, int H, void* out, long long ld_out, int rpad,
                                  void* stream) {
  if (n_rays < 0 || rpad < n_rays || spr < 1 || H < 1 || ld_out < rpad ||
      ld32 < static_cast<long long>(n_rays) * spr)
    return cudaErrorInvalidValue;
  if (rpad == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_of(static_cast<long long>(H) * rpad, EW_THREADS);
  if (use_bf16)
    ray_sums<bf16><<<grid, EW_THREADS, 0, s>>>(dhv32, ld32, n_rays, spr, H,
                                               static_cast<bf16*>(out), ld_out, rpad);
  else
    ray_sums<float><<<grid, EW_THREADS, 0, s>>>(dhv32, ld32, n_rays, spr, H,
                                                static_cast<float*>(out), ld_out, rpad);
  return cudaGetLastError();
}

// dx [n][3] of the points (or directions) y [n][3] from the f32 cotangent
// rows de [3 + 6F][ld] of their F-octave embedding.
extern "C" int nerf_wide_embed_bwd(const float* y, int n, int F, const float* de, long long ld,
                                   float* out, void* stream) {
  if (n < 0 || ld < n || F < 1 || F > 30) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  embed_backward_cols<<<blocks_of(n, EW_THREADS), EW_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(y, n, F, de, ld, out);
  return cudaGetLastError();
}

// The weight grads (wgrad_sm90.cuh) of n_probs products, each 7 ints in
// probs (host memory): (src, ra, M, rb, N, coff, ldc): C[M][N] at
// wpart + coff, rows ldc apart, = the sum over the columns of rows ra.. and
// rb.. of the workspace ws [ws_rows][ldp] (src 0, k = ldp columns) or of the
// per-ray rows rws [rws_rows][rpad] (src 1, k = rpad); N <= 256 in bf16.
// The columns split in split_len pieces (a multiple of 64), nsplit of them
// at most, each into its own partial of grad_size floats in wpart (zeroed
// here first); then out[:grad_size] = the partials' sum and
// out[grad_size:] = the sum of the nbpart bias partials bpart [nbpart][nbias].
extern "C" int nerf_wide_wgrad(int use_bf16, const void* ws, int ws_rows, long long ldp,
                               const void* rws, int rws_rows, long long rpad, int n_probs,
                               const int* probs, int split_len, int nsplit, long long grad_size,
                               float* wpart, float* out, const float* bpart, int nbpart,
                               int nbias, void* stream) {
  if (ldp < 64 || ldp % 64 != 0 || rpad < 0 || rpad % 64 != 0 || n_probs < 1 ||
      split_len < 64 || split_len % 64 != 0 || nsplit < 1 ||
      static_cast<long long>(nsplit) * split_len < ldp || nbpart < 1 || nbias < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  NERF_CHECK(cudaMemsetAsync(wpart, 0, size_t(nsplit) * size_t(grad_size) * 4, s));
  CUtensorMap ws_map, ws8_map, rws_map;
  if (use_bf16) {
    NERF_CHECK(hopper::encode_rows_sw128(&ws_map, ws, ws_rows, ldp, 64));
    NERF_CHECK(hopper::encode_rows_sw128(&ws8_map, ws, ws_rows, ldp, 8));
    if (rpad > 0)
      NERF_CHECK(hopper::encode_rows_sw128(&rws_map, rws, rws_rows, rpad, 64));
    else
      rws_map = ws_map;  // no per-ray rows: no problem reads this map
    NERF_CHECK(cudaFuncSetAttribute(wgrad_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    int(WGRAD_SMEM)));
    cudaFuncAttributes fa;
    NERF_CHECK(cudaFuncGetAttributes(&fa, wgrad_bf16));
    if (fa.numRegs * WG_THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
      return cudaErrorInvalidConfiguration;
  }
  const size_t esz = use_bf16 ? 2 : 4;
  for (int p0 = 0; p0 < n_probs; p0 += MAXP - 1) {  // one past the last: the grid size
    Probs P;
    P.count = 0;
    P.split_len = split_len;
    P.split_stride = size_t(grad_size);
    P.scene_stride = size_t(nsplit) * size_t(grad_size);
    int cta = 0;
    for (int i = p0; i < n_probs && i < p0 + MAXP - 1; ++i) {
      const int* q = probs + 7 * i;
      const int src = q[0], ra = q[1], M = q[2], rb = q[3], N = q[4], coff = q[5], ldc = q[6];
      const long long ld = src ? rpad : ldp;
      if (M < 1 || N < 1 || (use_bf16 && N > 256) || (src && rpad == 0) ||
          ra < 0 || rb < 0 || ra + M > (src ? rws_rows : ws_rows))
        return cudaErrorInvalidValue;
      const unsigned char* base = static_cast<const unsigned char*>(src ? rws : ws);
      Prob& pr = P.p[P.count++];
      pr.A = base + size_t(ra) * size_t(ld) * esz;
      pr.B = base + size_t(rb) * size_t(ld) * esz;
      pr.C = wpart + coff;
      pr.M = M;
      pr.N = N;
      pr.lda = int(ld);
      pr.ldc = ldc;
      pr.k_len = int(ld);
      pr.ra = ra;
      pr.rb = rb;
      pr.src = src;
      pr.bn = use_bf16 ? (N <= 8 ? 8 : N <= 128 ? 128 : 256) : FM;
      pr.mtiles = (M + (use_bf16 ? GM : FM) - 1) / (use_bf16 ? GM : FM);
      pr.ntiles = use_bf16 ? 1 : (N + FM - 1) / FM;
      pr.nsplit = int((ld + split_len - 1) / split_len);
      pr.cta0 = cta;
      cta += pr.mtiles * pr.ntiles * pr.nsplit;
    }
    P.p[P.count].cta0 = cta;
    if (use_bf16)
      wgrad_bf16<<<dim3(cta, 1), WG_THREADS, WGRAD_SMEM, s>>>(ws_map, ws8_map, rws_map, P);
    else
      wgrad_f32<<<dim3(cta, 1), THREADS, 0, s>>>(P);
    NERF_CHECK(cudaGetLastError());
  }
  reduce_splits<<<dim3(unsigned((grad_size + 255) / 256), 1), 256, 0, s>>>(
      wpart, nsplit, size_t(grad_size), out, 0);
  NERF_CHECK(cudaGetLastError());
  reduce_tiles<<<dim3(unsigned((nbias + 31) / 32), 1), 256, 0, s>>>(bpart, nbpart, nbias,
                                                                   out + grad_size, 0);
  return cudaGetLastError();
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
