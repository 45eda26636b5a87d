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
// row over each 256-point tile (the bias grads' partials). The forward is
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
// Scenes: the stacked (multi-scene) K1ws-K6ws, nerf_tpu's kernels under
// its vmap over the scenes (nerf_tpu/parallel/multi_scene.py), run the same
// launches once for S scenes. The columns are the scenes' one after another,
// C each (whole GEMM tiles: no tile spans two scenes); the GEMM reads scene
// s's weights, bias and per-view terms at a scene stride, the head its Wout
// and bout, and the weight grads put each scene's into its own set
// (wgrad_sm90.cuh's grid axis y). The kernels that work per point or per
// ray (embed_cols, gc_rows, ray_sums) see only the padded columns. S = 1 is
// the single-scene launch.
//
// The bf16 GEMM (gemm_bf16_sm90) replaces no TPU kernel by itself: it is the
// body of every layer of K1w-K6w. Bound: at W = 512 with 10/4 octaves the
// forward is 4,601,856 FLOP a point (3.88x W = 256's 1,186,816): >= 39.0 ms
// for a 32,768-ray chunk at 64 + 192 samples at 989 TFLOP/s, while layer by
// layer through device memory the family moves ~18 KB a point, ~45 ms a
// chunk at 3.35 TB/s, so the GEMM's realistic target is the time of the
// same products in a library. Its design, each point against what held its
// first version back:
// - persistent CTAs, one an SM at most, walking the (scene, N tile, M tile)
//   space with M fastest, so the CTAs on one N tile's M tiles run together
//   and read its B rows from L2 after the first; the producer fills the next
//   tile's K chunks while the consumers run the current tile's epilogue;
// - a 128 x 256 tile (128 rows, 256 points): each consumer warpgroup owns 64
//   rows and issues one wgmma m64n256k16 a 16-deep K step, B MN-major
//   (transposed) across four 64-point swizzle atoms (the descriptor's
//   leading byte offset: one 8 KB TMA box), so each A fragment is read once
//   a 256-point tile;
// - products in flight across K chunks: commit a chunk, wait until one group
//   is in flight, then free the previous chunk's stage (4 stages of 48 KB);
// - setmaxnreg: the producer warpgroup drops to 40 registers, the consumers
//   rise to 232 for their 128 accumulators and the epilogue;
// - the epilogue staged through shared memory: bias, per-view term, relu and
//   mask on the fragment, the mask rows in by 16-byte loads a round (64
//   columns) ahead, the rounded (and f32) rows out by TMA stores from two
//   128-byte-swizzled staging boxes a warpgroup, taken in turn, so that the
//   stores run while the next round is formed and the next tile's products
//   run.
// K beyond a source's k and rows beyond M come in as zeros (TMA fills past
// a tensor map's edge); columns are whole tiles (ops/fused_mlp_wide.py::cols
// pads them to 256 points). The rounding points are those of its first
// version: f32 sums, + add, + bias, relu, mask, one rounding on the store.
// The f32 GEMM (gemm_f32) is a plain 64 x 256 FMA tile (no TF32) with the
// same epilogue.

#include "fused_mlp_common.cuh"
#include "hopper.cuh"
#include "wgrad_sm90.cuh"

namespace {

constexpr int WIDE_TILE = 256;  // points of a GEMM tile and of a bias partial
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

// raw of point p < n: hv[:, p] Wout_s[:W/2] + h7[:, p] Wout_s[W/2:] + bout_s,
// to out[c * sc + p * sp] (planes: sc = N, sp = 1; rows: sc = 1, sp = 4),
// with s = p / C the point's scene (Wout_s swout elements past scene 0's,
// bout_s sbout).
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
head_cols(const T* __restrict__ hv, const T* __restrict__ h7, size_t ld, int n, int C, int W,
          const T* __restrict__ wout_all, size_t swout, const float* __restrict__ bout_all,
          size_t sbout, float* __restrict__ out, size_t sc, size_t sp) {
  const int p = blockIdx.x * EW_THREADS + threadIdx.x;
  if (p >= n) return;
  const int s = p / C;
  const T* __restrict__ wout = wout_all + size_t(s) * swout;
  const float* __restrict__ bout = bout_all + size_t(s) * sbout;
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
// WIDE_TILE-point tile's f32 sums of g (dbout's partials) at bsum[tile][c].
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

// One GEMM launch over S scenes of C columns each (N = S C columns; scene s
// owns [s C, (s + 1) C), whole tiles): C[m][n] = A0_s[m][:k0] B0[:k0][n] (+
// A1_s[m][:k1] B1[:k1][n]) with A_s scene s's block (sa elements past scene
// 0's), then per element v = C + add_s[m][(n - s C) / add_div] + bias_s[m],
// relu, zero where mask[m][n] is not positive, out[m][n] = v rounded,
// out32[m][n] = v, and bsum[n / WIDE_TILE][m] = the sum of v over the
// tile's columns (each pointer null: that step skipped). Rows are strided
// by their ld, scenes by their s (elements). S = 1: one scene, N = C.
struct GemmArgs {
  int S, M, C, k0, k1, kc0, kc1;  // kc: the 64-deep chunks of each source (bf16)
  const void* a0;
  long long lda0, sa0;
  const void* b0;
  long long ldb0;
  const void* a1;
  long long lda1, sa1;
  const void* b1;
  long long ldb1;
  const float* bias;
  long long sbias;
  const float* add;
  long long ld_add, sadd;
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

// The epilogue of the elements (m, n) and (m, n + 1) of scene s, n even and
// nl = n - s C, on the f32 tile: returns their values before rounding.
__device__ __forceinline__ float2 epi_pair_f32(const GemmArgs& g, int s, int m, int n, int nl,
                                               float v0, float v1) {
  if (g.add != nullptr) {
    const float* a = g.add + size_t(s) * g.sadd + size_t(m) * g.ld_add;
    v0 += a[nl / g.add_div];
    v1 += a[(nl + 1) / g.add_div];
  }
  if (g.bias != nullptr) {
    const float b = g.bias[size_t(s) * g.sbias + m];
    v0 += b;
    v1 += b;
  }
  if (g.relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  if (g.mask != nullptr) {
    const float* k = static_cast<const float*>(g.mask) + size_t(m) * g.ld_mask + n;
    if (!(k[0] > 0.f)) v0 = 0.f;
    if (!(k[1] > 0.f)) v1 = 0.f;
  }
  if (g.out != nullptr)
    *reinterpret_cast<float2*>(static_cast<float*>(g.out) + size_t(m) * g.ld_out + n) =
        make_float2(v0, v1);
  if (g.out32 != nullptr)
    *reinterpret_cast<float2*>(g.out32 + size_t(m) * g.ld_out32 + n) = make_float2(v0, v1);
  return make_float2(v0, v1);
}

// The bf16 GEMM's tile: 128 rows (two consumer warpgroups of 64) x
// WIDE_TILE = 256 points, a ring of GEMM_STAGES 64-deep K chunks (A: two
// 64-row boxes of the K-major 128-byte-swizzled tile; B: four boxes of 64 K
// rows x 64 points, the MN-major swizzled tile), then each consumer
// warpgroup's two staging boxes for its epilogue's TMA stores (64 rows x
// 128 bytes, 128-byte swizzled: 64 bf16 or 32 f32 columns).
constexpr int GEMM_THREADS = 384;  // a producer and two consumer warpgroups
constexpr int GEMM_PRODUCER_REGS = 40, GEMM_CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232
constexpr int GT_M = 128, GT_K = 64, GEMM_STAGES = 4;
constexpr size_t GT_BOX = size_t(64) * 128;  // a 64 x 64 bf16 box: 8 KB
constexpr size_t GT_A = 2 * GT_BOX, GT_B = (WIDE_TILE / 64) * GT_BOX;
constexpr size_t GEMM_STAGE = GT_A + GT_B;  // 48 KB
constexpr int EPI_COLS = 64;                 // the columns of an epilogue round
constexpr size_t EPI_BOX = size_t(64) * 128;  // a staging box: 8 KB
constexpr size_t GEMM_SMEM =
    1024 + GEMM_STAGES * GEMM_STAGE + 4 * EPI_BOX + 2 * GEMM_STAGES * sizeof(uint64_t);
static_assert(WIDE_TILE == 256 && GT_BOX % 1024 == 0, "four 64-point boxes a tile");
static_assert(GEMM_SMEM <= 232448, "the ring and the staging fit in an SM's shared memory");

// The descriptor of the MN-major B tile with the 128-byte swizzle at p:
// along N, swizzle atoms of 64 points (128 bytes), one TMA box (64 K rows x
// 128 bytes, GT_BOX = 8 KB) apart: the leading byte offset; along K, a
// 128-byte row per K index, 8-row groups 1024 bytes apart: the stride byte
// offset. Adding 128 to it moves the start 16 K rows (2048 bytes) on.
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p) {
  const uint64_t a = hopper::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(GT_BOX >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// Byte offset of row r's 16-byte chunk c in a 128-byte-swizzled staging box
// (TMA's layout: the chunk index XOR r % 8; the box 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Shared-memory accesses at 32-bit shared addresses (st.shared / ld.shared).
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts64(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A warp's 16 mask rows r0 .. r0 + 15 of the 64 columns from n0: 4 16-byte
// pieces a lane (piece p = lane + 32 i: row p / 8, 8 columns p % 8), zeros
// past M.
__device__ __forceinline__ void load_mask(const GemmArgs& g, int r0, int n0, int lane,
                                          uint4 (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = lane + 32 * i, row = p >> 3, c = p & 7;
    v[i] = r0 + row < g.M
               ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.mask) +
                                                 size_t(r0 + row) * g.ld_mask + n0 + 8 * c)
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Consumer warpgroup w's 64 rows (from r_wg) of a finished tile (acc:
// hopper.cuh's m64n256 fragment; this thread's rows rw = 16 warp + lane / 4
// and rw + 8 of the 64, their biases ba and bb, loaded before the products)
// through the epilogue in 4 rounds of 64 columns: the round's mask rows
// (prefetched a round ahead into mk by 16-byte loads) go through a staging
// box, the values are formed on the fragment (+ add, + bias, relu, mask),
// and the rounded rows (then the f32 rows, 32 columns a box) leave from the
// staging boxes by TMA stores, the two boxes taken in turn (`unit` counts
// the boxes this warpgroup has staged) so that a round's stores run while
// the next is formed, and the last while the next tile's products run.
// Then each row's sum over the tile into bsum.
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& g, const CUtensorMap* out_map,
                                              const CUtensorMap* out32_map, float (&acc)[128],
                                              int r_wg, int w, int nt, int s, float ba, float bb,
                                              unsigned char* boxes, uint4 (&mk)[4], int& unit) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int rw = 16 * warp + (lane >> 2), ra = r_wg + rw, rb = ra + 8;
  const bool oka = ra < g.M, okb = rb < g.M;
  const float* add_a = g.add == nullptr || !oka ? nullptr
                                                : g.add + size_t(s) * g.sadd + size_t(ra) * g.ld_add;
  const float* add_b = g.add == nullptr || !okb ? nullptr
                                                : g.add + size_t(s) * g.sadd + size_t(rb) * g.ld_add;
  const int n_tile = nt * WIDE_TILE;
  // the view of this thread's first column in its scene, and its place in
  // that view's add_div columns (stepped on 8 columns at a time below)
  const int nl0 = n_tile - s * g.C + 2 * (lane & 3), d = g.add_div;
  int vq = nl0 / d, vr = nl0 - vq * d;
  const uint32_t base = hopper::smem_addr(boxes);
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int q = 0; q < WIDE_TILE / EPI_COLS; ++q) {
    const int n0 = n_tile + q * EPI_COLS;
    const uint32_t box = base + (unit & 1) * uint32_t(EPI_BOX);
    if (t == 0) hopper::bulk_wait_read<1>();  // the store that read this box two units ago
    hopper::bar_sync(1 + w, 128);
    if (g.mask != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = lane + 32 * i;
        sts128(box + swz(16 * warp + (p >> 3), p & 7), mk[i]);
      }
      if (q + 1 < WIDE_TILE / EPI_COLS) load_mask(g, r_wg + 16 * warp, n0 + EPI_COLS, lane, mk);
      __syncwarp();
    }
    // acc[j], acc[j + 1] with j = 32 q + 4 gg + 2 hi: row rw + 8 hi, columns
    // 8 gg + 2 (lane % 4) + {0, 1} of the round; each step a pass over the
    // round's 32 values, under one branch at most, so that the passes run
    // as straight lines
    if (g.add != nullptr) {
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) {
        const int q1 = vr + 1 < d ? vq : vq + 1;  // the view of the second column
        const int j = 32 * q + 4 * gg;
        if (add_a != nullptr) {
          acc[j] += add_a[vq];
          acc[j + 1] += add_a[q1];
        }
        if (add_b != nullptr) {
          acc[j + 2] += add_b[vq];
          acc[j + 3] += add_b[q1];
        }
        for (vr += 8; vr >= d; vr -= d) ++vq;  // the next 8 columns
      }
    }
    const bool has_bias = g.bias != nullptr, relu = g.relu != 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = 32 * q + i;
      const float v = has_bias ? acc[j] + (((i >> 1) & 1) ? bb : ba) : acc[j];
      acc[j] = relu ? fmaxf(v, 0.f) : v;
    }
    if (g.mask != nullptr) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int j = 32 * q + 2 * u;
        const uint32_t k = lds32(box + swz(rw + 8 * (u & 1), u >> 1) + 4 * (lane & 3));
        const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k));
        if (!(kf.x > 0.f)) acc[j] = 0.f;
        if (!(kf.y > 0.f)) acc[j + 1] = 0.f;
      }
    }
    if (g.bsum != nullptr) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int j = 32 * q + 2 * u;
        if (u & 1)
          sb += acc[j] + acc[j + 1];
        else
          sa += acc[j] + acc[j + 1];
      }
    }
    if (g.out != nullptr) {
      __syncwarp();  // this warp's reads of its mask rows are done
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int j = 32 * q + 2 * u;
        sts32(box + swz(rw + 8 * (u & 1), u >> 1) + 4 * (lane & 3), bf16x2(acc[j], acc[j + 1]));
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(1 + w, 128);
      if (t == 0) {
        hopper::tma_store_2d(out_map, boxes + (unit & 1) * EPI_BOX, n0, r_wg);
        hopper::bulk_commit();
      }
      ++unit;
    }
    if (g.out32 != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // 32 columns a box
        const uint32_t box32 = base + (unit & 1) * uint32_t(EPI_BOX);
        if (t == 0) hopper::bulk_wait_read<1>();
        hopper::bar_sync(1 + w, 128);
#pragma unroll
        for (int u = 8 * h; u < 8 * h + 8; ++u) {
          const int j = 32 * q + 2 * u, c = 2 * ((u >> 1) - 4 * h) + ((lane & 3) >> 1);
          sts64(box32 + swz(rw + 8 * (u & 1), c) + 8 * (lane & 1), acc[j], acc[j + 1]);
        }
        hopper::fence_proxy_async();
        hopper::bar_sync(1 + w, 128);
        if (t == 0) {
          hopper::tma_store_2d(out32_map, boxes + (unit & 1) * EPI_BOX, n0 + 32 * h, r_wg);
          hopper::bulk_commit();
        }
        ++unit;
      }
    }
  }
  if (g.bsum != nullptr) {  // the same for the whole grid
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    if ((lane & 3) == 0) {
      if (oka) g.bsum[size_t(nt) * g.ld_bsum + ra] = sa;
      if (okb) g.bsum[size_t(nt) * g.ld_bsum + rb] = sb;
    }
  }
}

// Keeps the compiler from moving the accumulators across the asynchronous
// products' issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int j = 0; j < 128; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// A consumer warpgroup's tiles (w: 0 or 1, its 64 rows of each): per K chunk
// wait for its stage, issue 4 wgmma m64n256k16 (B MN-major) into the 128
// accumulators, commit, then wait until one group is in flight and free the
// previous chunk's stage; after the last, drain, free it and run the
// epilogue. Both warpgroups run every product (no divergent path around
// wgmma): one whose rows are all past M reads a box the producer left
// unfilled and stores nothing. A tile's first mask round is loaded before
// its products, which hide the loads' latency.
__device__ __forceinline__ void gemm_consume(const GemmArgs& g, const CUtensorMap* out_map,
                                             const CUtensorMap* out32_map,
                                             const unsigned char* ring, unsigned char* epi,
                                             uint64_t* full, uint64_t* empty, int mtiles,
                                             int ntiles, int tiles, int nchunks) {
  const int w = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  unsigned char* boxes = epi + size_t(w) * 2 * EPI_BOX;
  int it = 0;    // chunks consumed, over this CTA's tiles: the ring's position
  int unit = 0;  // staging boxes filled, over this CTA's tiles
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t % mtiles, nt = t / mtiles, s = nt / ntiles;
    const int r_wg = mt * GT_M + w * 64;
    const bool rows = r_wg < g.M;  // this warpgroup has rows to store
    uint4 mk[4];  // the mask rows of a round, loaded a round ahead
    if (rows && g.mask != nullptr) load_mask(g, r_wg + 16 * warp, nt * WIDE_TILE, lane, mk);
    const int ra = r_wg + 16 * warp + (lane >> 2), rb = ra + 8;  // this thread's rows' biases
    const float* bias = g.bias == nullptr ? nullptr : g.bias + size_t(s) * g.sbias;
    const float ba = bias != nullptr && ra < g.M ? bias[ra] : 0.f;
    const float bb = bias != nullptr && rb < g.M ? bias[rb] : 0.f;
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    for (int c = 0; c < nchunks; ++c, ++it) {
      const int st = it % GEMM_STAGES;
      hopper::mbar_wait(&full[st], (it / GEMM_STAGES) & 1);
      const unsigned char* sm = ring + st * GEMM_STAGE;
      const uint64_t da = hopper::desc_k_sw128(sm + w * GT_BOX), db = desc_mn_sw128(sm + GT_A);
      fence_acc(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < GT_K / 16; ++k) hopper::wgmma_m64n256k16<1>(acc, da + 2 * k, db + 128 * k);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      fence_acc(acc);
      if (c > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % GEMM_STAGES]);
    }
    hopper::wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % GEMM_STAGES]);
    if (rows) gemm_epilogue(g, out_map, out32_map, acc, r_wg, w, nt, s, ba, bb, boxes, mk, unit);
  }
  if ((threadIdx.x & 127) == 0) hopper::bulk_wait_all();  // the last stores are done
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ... of the (scene, N tile,
// M tile) walk, M fastest, so the CTAs on one N tile's M tiles run together
// and read its B rows from L2 after the first. Warpgroup 0's thread 0 keeps
// the ring filled across tiles (the next tile's chunks load while the
// consumers run the epilogue); A's boxes come from the 3-D map [scene][M][K]
// (rows past M and K past k as zeros), B's from the 2-D map of the rows; the
// epilogue stores through out_map (bf16 rows, 64-column boxes) and out32_map
// (f32 rows, 32-column boxes), which drop rows past M.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_bf16_sm90(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
               const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
               const __grid_constant__ CUtensorMap out_map,
               const __grid_constant__ CUtensorMap out32_map, const __grid_constant__ GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* epi = ring + GEMM_STAGES * GEMM_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 4 * EPI_BOX);
  uint64_t* empty = full + GEMM_STAGES;
  const int mtiles = (g.M + GT_M - 1) / GT_M, ntiles = g.C / WIDE_TILE;  // ntiles: a scene's
  const int tiles = g.S * ntiles * mtiles, nchunks = g.kc0 + g.kc1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // a warp of each consumer warpgroup's four
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // producer
    hopper::setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mt = t % mtiles, nt = t / mtiles, s = nt / ntiles;
        const int nbox = g.M - mt * GT_M > 64 ? 2 : 1;  // A boxes with rows to own
        const uint32_t bytes = uint32_t(nbox * GT_BOX + GT_B);
        for (int c = 0; c < nchunks; ++c, ++it) {
          const int st = it % GEMM_STAGES;
          if (it >= GEMM_STAGES) hopper::mbar_wait(&empty[st], ((it / GEMM_STAGES) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[st], bytes);
          unsigned char* sm = ring + st * GEMM_STAGE;
          const bool second = c >= g.kc0;
          const CUtensorMap* am = second ? &a1 : &a0;
          const CUtensorMap* bm = second ? &b1 : &b0;
          const int k = (second ? c - g.kc0 : c) * GT_K;
          for (int i = 0; i < nbox; ++i)
            hopper::tma_load_3d(sm + i * GT_BOX, am, &full[st], k, mt * GT_M + i * 64, s);
          for (int i = 0; i < WIDE_TILE / 64; ++i)
            hopper::tma_load_2d(sm + GT_A + i * GT_BOX, bm, &full[st], nt * WIDE_TILE + i * 64, k);
        }
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    gemm_consume(g, &out_map, &out32_map, ring, epi, full, empty, mtiles, ntiles, tiles, nchunks);
  }
}

constexpr int F_M = 64, F_K = 32;  // the f32 tile: 64 rows x WIDE_TILE points, K chunks of 32

__global__ void __launch_bounds__(256) gemm_f32(const __grid_constant__ GemmArgs g) {
  __shared__ float As[F_M][F_K + 1];
  __shared__ float Bs[F_K][WIDE_TILE];
  const int mtiles = (g.M + F_M - 1) / F_M;
  const int mt = blockIdx.x % mtiles, nt = blockIdx.x / mtiles, s = nt / (g.C / WIDE_TILE);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // 16 columns, 4 rows a thread
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  for (int src = 0; src < 2; ++src) {
    const int K = src ? g.k1 : g.k0;
    const float* A = static_cast<const float*>(src ? g.a1 : g.a0) + size_t(s) * (src ? g.sa1 : g.sa0);
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
        float a[4], b[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 16; ++j) b[j] = Bs[kk][tx * 16 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mt * F_M + ty * 4 + i;
    float sum = 0.f;
    if (m < g.M) {
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int n = nt * WIDE_TILE + tx * 16 + j;
        const float2 v = epi_pair_f32(g, s, m, n, n - s * g.C, acc[i][j], acc[i][j + 1]);
        sum += v.x + v.y;
      }
    }
    if (g.bsum != nullptr) {  // the 16 lanes of a row group (tx), in a fixed order
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (tx == 0 && m < g.M) g.bsum[size_t(nt) * g.ld_bsum + m] = sum;
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

// The 3-D tensor map of S scenes' bf16 weight blocks [rows][cols] at base,
// rows `stride` and scenes `sstride` elements apart, read in boxes of 64
// columns x 64 rows of one scene with the 128-byte swizzle; past a block's
// edge TMA reads zeros.
cudaError_t encode_weights(CUtensorMap* map, const void* base, int S, long long rows,
                           long long cols, long long stride, long long sstride) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (S == 1) sstride = stride * rows;  // one scene: any legal stride
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (stride * 2) % 16 != 0 ||
      (sstride * 2) % 16 != 0 || S < 1 || rows < 1 || cols < 1 || stride < cols || sstride < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(S)};
  const cuuint64_t strides[2] = {cuuint64_t(stride) * 2, cuuint64_t(sstride) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of the GEMM's output rows [rows][cols] at base (bf16, or
// f32 with f32), rows `stride` elements apart, written in boxes of 64 rows
// x 128 bytes (64 bf16 or 32 f32 columns) from 128-byte-swizzled staging;
// rows past `rows` are not written.
cudaError_t encode_store(CUtensorMap* map, const void* base, bool f32, long long rows,
                         long long cols, long long stride) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int esz = f32 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (stride * esz) % 16 != 0 || rows < 1 ||
      cols < 1 || stride < cols)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(stride) * esz};
  const cuuint32_t box[2] = {cuuint32_t(128 / esz), 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether p (null: no rows) and rows ld elements of esz bytes apart allow
// 16-byte accesses.
bool rows16(const void* p, long long ld, int esz) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * esz) % 16 == 0);
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

// One GEMM launch (GemmArgs above) over S scenes of C columns (a multiple
// of WIDE_TILE): M rows, source s: A_s [S][M][k_s] (rows lda_s, scenes sa_s
// apart) and B_s [k_s][S C] rows ldb_s apart (k1 = 0: one source); bias
// [S][M] (scenes sbias apart); add [S][M][ld_add] (scenes sadd apart),
// column (n - s C) / add_div; mask [M][ld_mask]; out [M][ld_out]; out32
// [M][ld_out32]; bsum [S C / WIDE_TILE][ld_bsum]. In bf16 the mask rows
// take 16-byte loads and the out and out32 rows TMA stores: each 16-byte
// aligned, rows a multiple of 16 bytes apart.
extern "C" int nerf_wide_gemm(int use_bf16, int S, int M, int C, const void* a0, long long lda0,
                              long long sa0, int k0, const void* b0, long long ldb0,
                              const void* a1, long long lda1, long long sa1, int k1,
                              const void* b1, long long ldb1, const float* bias, long long sbias,
                              const float* add, long long ld_add, long long sadd, int add_div,
                              const void* mask, long long ld_mask, int relu, void* out,
                              long long ld_out, float* out32, long long ld_out32, float* bsum,
                              long long ld_bsum, void* stream) {
  const long long N = static_cast<long long>(S) * C;
  if (S < 1 || M < 1 || C < 0 || C % WIDE_TILE != 0 || k0 < 1 || k1 < 0 || lda0 < k0 ||
      (k1 > 0 && lda1 < k1) || ldb0 < N || (k1 > 0 && ldb1 < N) || add_div < 1 ||
      (add != nullptr && ld_add < 1) || (mask != nullptr && ld_mask < N) ||
      (out != nullptr && ld_out < N) || (out32 != nullptr && ld_out32 < N) ||
      (bsum != nullptr && ld_bsum < M) || N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const GemmArgs g{S,    M,     int(C), k0,   k1,   (k0 + GT_K - 1) / GT_K, (k1 + GT_K - 1) / GT_K,
                   a0,   lda0,  sa0,    b0,   ldb0, a1,    lda1,  sa1,   b1,   ldb1,
                   bias, sbias, add,    ld_add, sadd, add_div, mask, ld_mask, relu, out, ld_out,
                   out32, ld_out32, bsum, ld_bsum};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = N / WIDE_TILE;
  if (!use_bf16) {
    const long long ctas = ntiles * ((M + F_M - 1) / F_M);
    if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
    gemm_f32<<<unsigned(ctas), 256, 0, s>>>(g);
    return cudaGetLastError();
  }
  if (!rows16(mask, ld_mask, 2)) return cudaErrorInvalidValue;  // the epilogue's 16-byte loads
  CUtensorMap ma0, mb0, ma1, mb1, mo, mo32;
  NERF_CHECK(encode_weights(&ma0, a0, S, M, k0, lda0, sa0));
  NERF_CHECK(encode_operand(&mb0, b0, k0, N, ldb0));
  if (k1 > 0) {
    NERF_CHECK(encode_weights(&ma1, a1, S, M, k1, lda1, sa1));
    NERF_CHECK(encode_operand(&mb1, b1, k1, N, ldb1));
  } else {
    ma1 = ma0;  // no chunk reads them
    mb1 = mb0;
  }
  if (out != nullptr)
    NERF_CHECK(encode_store(&mo, out, false, M, N, ld_out));
  else
    mo = mb0;  // no store reads it
  if (out32 != nullptr)
    NERF_CHECK(encode_store(&mo32, out32, true, M, N, ld_out32));
  else
    mo32 = mb0;
  const long long tiles = ntiles * ((M + GT_M - 1) / GT_M);
  int dev = 0, sms = 0;
  NERF_CHECK(cudaGetDevice(&dev));
  NERF_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  NERF_CHECK(cudaFuncSetAttribute(gemm_bf16_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(GEMM_SMEM)));
  cudaFuncAttributes fa;
  NERF_CHECK(cudaFuncGetAttributes(&fa, gemm_bf16_sm90));
  if (fa.numRegs * GEMM_THREADS < 128 * GEMM_PRODUCER_REGS + 256 * GEMM_CONSUMER_REGS)
    return cudaErrorInvalidConfiguration;
  const unsigned ctas = unsigned(tiles < sms ? tiles : sms);  // persistent: a CTA an SM at most
  gemm_bf16_sm90<<<ctas, GEMM_THREADS, GEMM_SMEM, s>>>(ma0, mb0, ma1, mb1, mo, mo32, g);
  return cudaGetLastError();
}

// raw of points 0 .. n-1 from the hv [W/2][ld] and h7 [W][ld] rows, Wout
// [S][3W/2][4] and bout [S][4] (scenes swout and sbout elements apart; point
// p's scene p / C) to out[c * sc + p * sp].
extern "C" int nerf_wide_head(int use_bf16, const void* hv, const void* h7, long long ld, int n,
                              int C, int width, const void* wout, long long swout,
                              const float* bout, long long sbout, float* out, long long sc,
                              long long sp, void* stream) {
  if (n < 0 || ld < n || width < 2 || C < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_of(n, EW_THREADS);
  if (use_bf16)
    head_cols<bf16><<<grid, EW_THREADS, 0, s>>>(static_cast<const bf16*>(hv),
                                                static_cast<const bf16*>(h7), ld, n, C, width,
                                                static_cast<const bf16*>(wout), swout, bout, sbout,
                                                out, sc, sp);
  else
    head_cols<float><<<grid, EW_THREADS, 0, s>>>(static_cast<const float*>(hv),
                                                 static_cast<const float*>(h7), ld, n, C, width,
                                                 static_cast<const float*>(wout), swout, bout,
                                                 sbout, out, sc, sp);
  return cudaGetLastError();
}

// The cotangent rows gc [8][ld] for columns 0 .. ncols-1 (a multiple of
// WIDE_TILE) from g (channel c of point p at g[c * gsc + p * gsp], p < n),
// and each WIDE_TILE-point tile's sums of g at bsum[tile * ld_bsum + c].
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

// The weight grads (wgrad_sm90.cuh) of n_probs products (at most MAXP - 1:
// one launch), each 9 ints in probs (host memory): (src, ra, M, rb, N, coff,
// ldc, mc, nc): C[M][N] at wpart + coff, rows ldc apart, = the sum over a
// scene's columns of rows ra.. and rb.. of the workspace ws [ws_rows][ldp]
// (src 0) or of the per-ray rows rws [rws_rows][rpad] (src 1); in bf16 its
// 128 x 256 tiles in clusters of mc x nc (cluster_shape; f32 ignores them).
// The columns are `scenes` scenes' (ldp / scenes and rpad / scenes each,
// multiples of 64), scene s's into its own set of grads (wgrad_sm90.cuh's
// grid axis y). A scene's columns split in split_len pieces (a multiple of
// 64), nsplit of them at most, each into its own partial of grad_size
// floats in wpart (zeroed here first); then out[s][:grad_size] = scene s's
// partials' sum and out[s][grad_size:] = the sum of its nbpart / scenes bias
// partials (bpart [nbpart][nbias], a scene's after the one before), out's
// scenes grad_size + nbias floats apart.
extern "C" int nerf_wide_wgrad(int use_bf16, const void* ws, int ws_rows, long long ldp,
                               const void* rws, int rws_rows, long long rpad, int scenes,
                               int n_probs, const int* probs, int split_len, int nsplit,
                               long long grad_size, float* wpart, float* out, const float* bpart,
                               int nbpart, int nbias, void* stream) {
  if (scenes < 1 || ldp % scenes != 0 || rpad % scenes != 0 || nbpart % scenes != 0)
    return cudaErrorInvalidValue;
  const long long kp = ldp / scenes, kr = rpad / scenes;  // a scene's columns
  if (kp < 64 || kp % 64 != 0 || kr < 0 || kr % 64 != 0 || n_probs < 1 || n_probs >= MAXP ||
      split_len < 64 || split_len % 64 != 0 || nsplit < 1 ||
      static_cast<long long>(nsplit) * split_len < kp || nbpart < 1 || nbias < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esz = use_bf16 ? 2 : 4;
  Probs P;
  P.count = 0;
  P.split_len = split_len;
  P.split_stride = size_t(grad_size);
  P.scene_stride = size_t(nsplit) * size_t(grad_size);
  int cta = 0;
  for (int i = 0; i < n_probs; ++i) {
    const int* q = probs + 9 * i;
    const int src = q[0], ra = q[1], M = q[2], rb = q[3], N = q[4], coff = q[5], ldc = q[6];
    const long long ld = src ? rpad : ldp, k_len = src ? kr : kp;
    if (M < 1 || N < 1 || (src && rpad == 0) || ra < 0 || rb < 0 ||
        ra + M > (src ? rws_rows : ws_rows))
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
    pr.k_len = int(k_len);
    pr.ra = ra;
    pr.rb = rb;
    pr.src = src;
    pr.mtiles = (M + (use_bf16 ? GM : FM) - 1) / (use_bf16 ? GM : FM);
    pr.ntiles = (N + (use_bf16 ? GN : FM) - 1) / (use_bf16 ? GN : FM);
    pr.mc = use_bf16 ? q[7] : 1;
    pr.nc = use_bf16 ? q[8] : 1;
    pr.nsplit = int((k_len + split_len - 1) / split_len);
    pr.cta0 = cta;  // the f32 grid's; the bf16 launch lays its clusters out
    cta += pr.mtiles * pr.ntiles * pr.nsplit;
  }
  P.p[P.count].cta0 = cta;
  NERF_CHECK(cudaMemsetAsync(wpart, 0, size_t(scenes) * nsplit * size_t(grad_size) * 4, s));
  if (use_bf16) {
    CUtensorMap ws_map, ws8_map, rws_map;
    NERF_CHECK(hopper::encode_rows_sw128(&ws_map, ws, ws_rows, ldp, 64));
    NERF_CHECK(hopper::encode_rows_sw128(&ws8_map, ws, ws_rows, ldp, 8));
    if (rpad > 0)
      NERF_CHECK(hopper::encode_rows_sw128(&rws_map, rws, rws_rows, rpad, 64));
    else
      rws_map = ws_map;  // no per-ray rows: no problem reads this map
    NERF_CHECK(launch_wgrad_bf16(ws_map, ws8_map, rws_map, P, scenes, s));
  } else {
    wgrad_f32<<<dim3(cta, scenes), THREADS, 0, s>>>(P);
    NERF_CHECK(cudaGetLastError());
  }
  const size_t out_stride = size_t(grad_size) + nbias;
  reduce_splits<<<dim3(unsigned((grad_size + 255) / 256), scenes), 256, 0, s>>>(
      wpart, nsplit, size_t(grad_size), out, out_stride);
  NERF_CHECK(cudaGetLastError());
  reduce_tiles<<<dim3(unsigned((nbias + 31) / 32), scenes), 256, 0, s>>>(
      bpart, nbpart / scenes, nbias, out + grad_size, out_stride);
  return cudaGetLastError();
}

// The CTAs of the bf16 weight-grad launch the card holds at once in
// clusters of cl (wgrad_sm90.cuh's wgrad_slots), into *slots: what
// ops/fused_mlp_wide.py's hopper_splits fills.
extern "C" int nerf_wide_wgrad_slots(int cl, int* slots) { return wgrad_slots(cl, slots); }

// The last bf16 weight-grad launch of this library: its cluster size, grid
// x and y, and problem count, into out[0..3].
extern "C" void nerf_wgrad_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = last_wgrad_launch()[i];
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
