// Fused NeRF rendering for Hopper (sm_90a): rays -> posenc -> 8xW MLP ->
// volume compositing -> per-ray maps in one kernel (K5), and the
// compositing backward that feeds the MLP backward (K6).
//
// K5 replaces nerf_tpu/experimental/fused_render.py::_fwd_kernel (the Pallas
// kernel behind _fused_render_op): for ray r with samples z[r, 0..S-1],
//   raw   = the fused MLP at x = rays_o[r] + rays_d[r] * z      (K1's tile body)
//   sigma = raw_sigma + noise;  dist_k = (z_{k+1} - z_k) |rays_d|, 1e10 |rays_d| last
//   ea_k  = exp(-relu(sigma_k) dist_k);  c_k = ea_k + 1e-10
//   T_k   = exp(sum_{j<k} log c_j)  (in sample order);  w_k = (1 - ea_k) T_k
//   rgb   = sum_k w_k sigmoid(raw_rgb_k) (+ 1 - acc on a white background)
//   depth = sum_k w_k z_k;  acc = sum_k w_k;  disp = 1 / max(1e-10, depth / acc)
// (_composite, fused_render.py:122-152). Serving writes rgb, disp, acc and w
// only: raw never leaves the chip. Under autograd K5 also writes raw as
// planes [4][R*S], K6's residual (re-running the MLP instead would cost a
// whole forward).
// K6 replaces fused_render.py::_make_bwd_kernel (behind _bwd_rule): a
// kernel here (composite_bwd, a warp per ray) recomputes T, w, c, depth and
// acc from the residual raw as K5 computes them and forms the cotangent of
// raw as _bwd_rule does
// (:213-252): the `live` guard on depth/acc, white_bkgd's -sum g_rgb on
// g_acc, t = g_w + g_rgb . sigmoid(raw_rgb) + g_depth z + g_acc,
//   d_alpha_k = t_k T_k - (sum_{i>k} t_i w_i) / c_k   (suffix summed from the back),
//   d_sigma   = d_alpha ea dist (sigma > 0),   d_raw_rgb = w s (1 - s) g_rgb;
// then the wrapper runs K4's three phases (fused_mlp_bwd.cu) on that
// cotangent with a direction per ray: the weight grads, no input grads.
//
// Bound: K5 does K1's 1,186,816 FLOP per point at 8x256 (the compositing
// adds ~30 per point); its bytes (36 B in and 20 B out per ray, 4 B z and
// 4 B noise in, 4 B w out per point, 16 B raw under autograd) are far less,
// so it is bound by operations: >= 10.07 ms for a 32,768-ray chunk at
// 64+192 samples at 989 TFLOP/s bf16. K6 is K4's operations plus a per-ray
// pass that moves ~44 B a point.
// Design of the bf16 kernel (render_bf16_sm90): K1's tile
// (fwd_tile_sm90.cuh: a TMA weight ring, two ping-pong wgmma consumer
// warpgroups, a persistent grid), so K5's raw is K1's bit for bit, with a
// schedule and a hook of its own:
//  - ray groups: compositing needs whole rays in one CTA, and a 128-point
//    tile is 1.5 rays at S = 192. A group is G = lcm(S, 128) / S whole rays,
//    n_sub = lcm(S, 128) / 128 consecutive full tiles (S = 64: 2 rays, 1
//    tile; 192: 2, 3; 200: 16, 25; 8: 16, 1). GroupWalk takes the CTA's
//    groups blockIdx.x, + gridDim.x, ..., each group's tiles in order; only
//    the last group is ragged, which the tile's p < n_pts mask covers;
//  - raw off the chip, near it: at W = 256 the tile leaves 1,984 bytes of
//    an SM's shared memory, and a group needs 16 B a point (6 KB at S =
//    192). The sink writes raw to the raw planes where they are kept
//    (autograd: K6's residual), else to the CTA's slab in device memory,
//    [grid][2][4][G*S] floats, double-buffered by the CTA's group count
//    (1.6 MB at S = 192, 13.5 MB at S = 200 for 132 CTAs: it stays in the
//    50 MB L2); the wrapper allocates it (fused_render.py::slab_floats);
//  - compositing beside the MLP (GroupHook, the hook): the producer
//    warpgroup's three idle warps composite each group once the consumers
//    have written its raw, while the consumers go on with the next groups
//    and keep their ping-pong. Per slab buffer two mbarriers: `full` (the
//    256 consumer threads arrive after their last head of the group) and
//    `empty` (the 96 compositing threads arrive after reading it); a
//    consumer waits on `empty` before the first head of the CTA's group
//    k >= 2, for group k-2. Each warp composites a ray: lane l takes
//    ceil(S/32) consecutive samples, sums their log c in sample order, a
//    shuffle scan in a fixed lane order gives each lane its exclusive
//    prefix, a second pass forms T, w and the lane's rgb, depth and acc
//    sums, and an xor butterfly sums those; in 40 registers a thread
//    (setmaxnreg). Every sum runs in a fixed order, so launches are
//    bit-identical; against the plain version's cumsum the prefix differs
//    by f32 ulps. (Compositing on the consumers, behind a barrier of both
//    at each group's end, stalled their ping-pong: K5 - K1 was 15-16% of
//    K1 against 0.5-3% so; PERF.md.)
// The f32 kernel (render_f32) keeps the simple first version: a CTA of 256
// threads owns one group, whose raw fwd_tile_f32 (fused_mlp_common.cuh)
// keeps in shared memory (20 B a point with the compositing scratch) over
// 64-point sub-tiles; where the group would hold more than GROUP_BYTES of
// it (S = 200: lcm = 1600 points), the CTA takes one ray and masks the
// tail of its last sub-tile; the two sums run in sample order on one thread
// per ray. composite_bwd (K6's own pass, both precisions) is a warp per ray
// on K5's compositing scan (composite_scan), the ray's samples staged in
// shared memory by coalesced loads: 4,096 rays are 4,096 warps.
// Bound: ~44 B a point (raw 16, z 4, noise 4 and g_w 4 in, g 16 out) and
// 32 B a ray, 46.4 MB at a training step's 4,096 x (64 + 192) points:
// 0.014 ms at 3.35 TB/s.

#include "fused_mlp_common.cuh"
#include "fwd_tile_sm90.cuh"

namespace {

constexpr int COMP_PLANES = 5;        // f32: r, g, b, sigma (-> ea), log c (-> prefix -> w)
constexpr size_t GROUP_BYTES = 16384;  // f32: shared memory for a multi-ray group's points
constexpr int MAX_SMEM = 232448;       // a block's dynamic shared memory on sm_90
constexpr int RAW_PLANES = 4;          // bf16: r, g, b, sigma of a group in the slab
constexpr int SLAB_BUFFERS = 2;        // bf16: a CTA's slab, double-buffered
constexpr int COMPOSITE_WARPS = 3;     // bf16: the producer warpgroup's idle warps
// bf16: the slab's mbarriers (full and empty of each buffer) after FwdSmem's,
// then the stacked K5's slab index of the CTA (slab_cta, a word)
constexpr size_t HOOK_BYTES = (2 * SLAB_BUFFERS + 1) * sizeof(uint64_t);

// |d| as sqrt((d0 d0 + d1 d1) + d2 d2), no FMA contraction
__device__ __forceinline__ float ray_norm(const float* d) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                              __fmul_rn(d[2], d[2])));
}

// dist_k of a ray's sample k: (z_{k+1} - z_k) |d|, 1e10 |d| for the last
__device__ __forceinline__ float sample_dist(const float* z, int k, int S, float dn) {
  return __fmul_rn(k + 1 < S ? __fsub_rn(z[k + 1], z[k]) : 1e10f, dn);
}

// sigma = raw sigma + noise (noise null: none)
__device__ __forceinline__ float noisy(float raw_sigma, const float* noise, size_t p) {
  return noise != nullptr ? __fadd_rn(raw_sigma, noise[p]) : raw_sigma;
}

// ea = exp(-relu(sigma) dist) = 1 - alpha
__device__ __forceinline__ float ealpha(float sigma, float dist) {
  return expf(__fmul_rn(-fmaxf(sigma, 0.f), dist));
}

__device__ __forceinline__ float log_c(float ea) { return logf(__fadd_rn(ea, 1e-10f)); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// 1 / max(1e-10, ratio), NaN (an empty ray's 0/0) kept as jnp.maximum keeps it
__device__ __forceinline__ float disp_of(float ratio) {
  return 1.f / (ratio != ratio ? ratio : fmaxf(1e-10f, ratio));
}

struct RenderArgs {
  const float* ro;
  const float* rd;
  const float* vd;
  const float* z;
  const float* noise;  // [R][S] or null
  int n_rays;
  int S;
  int Fp;
  int Fv;
  int G;         // rays per group
  int n_sub;     // (sub-)tiles per group
  int n_groups;  // bf16: ceil(n_rays / G)
  int white;
  const void* wb;
  const float* bb;
  float* rgb;   // [R][3]
  float* disp;  // [R]
  float* acc;   // [R]
  float* w;     // [R][S]
  float* raw;   // planes [4][R*S], or null
  float* slab;  // bf16 without raw: [grid][SLAB_BUFFERS][RAW_PLANES][G*S]
  // the stacked K5: the rays of scene_rays a scene (f32: a CTA's scene is
  // its first ray's), scene_groups bf16 groups a scene (0: one net)
  int scene_rays;
  int scene_groups;
};

// The compositing of the CTA's rays r0 .. r0+g_rays-1 from raw in comp.
__device__ void composite(const RenderArgs& a, float* comp, int nq, int r0, int g_rays) {
  const int S = a.S, tid = threadIdx.x, n_valid = g_rays * S;
  const size_t pbase = size_t(r0) * S;
  float* ea = comp + 3 * nq;  // raw sigma, then ea
  float* lw = comp + 4 * nq;  // log c, then its exclusive prefix, then w
  for (int q = tid; q < n_valid; q += THREADS) {
    const int r = r0 + q / S, k = q % S;
    const float e = ealpha(noisy(ea[q], a.noise, pbase + q),
                           sample_dist(a.z + size_t(r) * S, k, S, ray_norm(a.rd + 3 * r)));
    ea[q] = e;
    lw[q] = log_c(e);
#pragma unroll
    for (int c = 0; c < 3; ++c) comp[c * nq + q] = sigmoid(comp[c * nq + q]);
  }
  __syncthreads();
  if (tid < g_rays) {  // T_k = exp(sum_{j<k} log c_j): the sum in sample order
    float s = 0.f;
    for (int k = 0; k < S; ++k) {
      const float t = lw[tid * S + k];
      lw[tid * S + k] = s;
      s = __fadd_rn(s, t);
    }
  }
  __syncthreads();
  for (int q = tid; q < n_valid; q += THREADS) {
    const float w = __fmul_rn(__fsub_rn(1.f, ea[q]), expf(lw[q]));
    lw[q] = w;
    a.w[pbase + q] = w;
  }
  __syncthreads();
  if (tid < g_rays) {
    const int r = r0 + tid;
    const float* z = a.z + size_t(r) * S;
    float rgb[3] = {0.f, 0.f, 0.f}, depth = 0.f, acc = 0.f;
    for (int k = 0; k < S; ++k) {
      const int q = tid * S + k;
      const float w = lw[q];
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = fmaf(w, comp[c * nq + q], rgb[c]);
      depth = fmaf(w, z[k], depth);
      acc = __fadd_rn(acc, w);
    }
    a.disp[r] = disp_of(depth / acc);
    a.acc[r] = acc;
#pragma unroll
    for (int c = 0; c < 3; ++c) a.rgb[r * 3 + c] = a.white ? rgb[c] + (1.f - acc) : rgb[c];
  }
}

// ------------------------------------------------------------- bf16 (sm_90a)

// K5's schedule: the CTA's groups blockIdx.x, + gridDim.x, ..., each group's
// n_sub tiles in order; one net (TileWalk's scene 0).
struct GroupWalk : TileWalk {
  static constexpr bool kStacked = false;
  int n_sub;
  __device__ __forceinline__ int first() const { return blockIdx.x * n_sub; }
  __device__ __forceinline__ int next(int tile) const {
    return (tile + 1) % n_sub != 0 ? tile + 1 : tile + 1 + int(gridDim.x - 1) * n_sub;
  }
};

// The opaque reads of the grid's y and size (asm volatile), taken afresh
// where they are used: held in registers across the compositing or the
// head, such values spill (K5's compositing warps run at 40 registers).
__device__ __forceinline__ int grid_y() {
  int y;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(y));
  return y;
}
__device__ __forceinline__ int grid_ctas() {
  int n;
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(n));
  return n;
}

// The stacked K5's schedule (multi-scene training): GroupWalk inside
// SceneWalk. S scenes' rays one after another, each scene whole groups
// (scene_groups * n_sub tiles); the grid's y is the scene, and CTA (x, y)
// takes scene y's groups x, x + gridDim.x, ..., each group's tiles in
// order, on scene y's weights. It holds no field: the counts are read from
// the kernel's parameters and y afresh where used, so that the producer
// warpgroup's 40 registers keep none of them.
struct SceneGroupWalk {
  static constexpr bool kStacked = true;
  const RenderArgs& a;
  __device__ __forceinline__ int scene_tiles() const { return a.scene_groups * a.n_sub; }
  __device__ __forceinline__ int first() const {
    return grid_y() * scene_tiles() + int(blockIdx.x) * a.n_sub;
  }
  __device__ __forceinline__ int next(int tile) const {
    const int t = (tile + 1) % a.n_sub != 0 ? tile + 1 : tile + 1 + int(gridDim.x - 1) * a.n_sub;
    return t < (grid_y() + 1) * scene_tiles() ? t : INT_MAX;  // INT_MAX: done
  }
  __device__ __forceinline__ int scene() const { return grid_y(); }
};

// The CTA's index among the grid's (x, y): its slab's (one net: x).
template <bool kStacked>
__device__ __forceinline__ int slab_cta() {
  if constexpr (kStacked) return grid_y() * grid_ctas() + int(blockIdx.x);
  return blockIdx.x;
}

// The CTA's count of groups before group g (g a global group index): the
// slab buffer of g is this count % 2. The stacked walk counts within g's
// scene.
template <bool kStacked>
__device__ __forceinline__ int group_count(const RenderArgs& a, int g) {
  if constexpr (kStacked) return (g % a.scene_groups) / int(gridDim.x);
  return g / int(gridDim.x);
}

// Raw plane 0 of group g (the CTA's buffer b of the slab, b = the CTA's
// group count % 2), indexed by the group's sample q = p - g*G*S: the raw
// planes where they are kept, else the CTA's slab (slab_cta: per (x, y)
// CTA in the stacked grid); plane c is plane_stride(a) floats further.
template <bool kStacked>
__device__ __forceinline__ float* group_plane(const RenderArgs& a, int g, int b) {
  const int GS = a.G * a.S;
  if (a.raw != nullptr) return a.raw + size_t(g) * GS;
  return a.slab + size_t(slab_cta<kStacked>() * SLAB_BUFFERS + b) * RAW_PLANES * GS;
}
__device__ __forceinline__ size_t plane_stride(const RenderArgs& a) {
  return a.raw != nullptr ? size_t(a.n_rays) * a.S : size_t(a.G) * a.S;
}

// The tile's sink: raw of point p into its group's planes.
template <bool kStacked>
struct GroupSink {
  const RenderArgs& a;
  __device__ __forceinline__ void operator()(int p, int c, float v) const {
    const int GS = a.G * a.S, g = p / GS;
    group_plane<kStacked>(a, g, group_count<kStacked>(a, g) % SLAB_BUFFERS)
        [c * plane_stride(a) + (p - g * GS)] = v;
  }
};

// How a warp's compositing loads raw sigma: through L2 only where the same
// kernel wrote it (K5's slab), read-only from device memory, or plainly
// (shared memory: K6's staged rays).
enum SigmaLoad { kSigmaL2, kSigmaRO, kSigmaPlain };

// One ray's samples as a warp's compositing reads them: depths z and noise
// (null: none) by point p0 + k, raw sigma by sample k.
template <int kLoad>
struct RaySamples {
  const float* z;
  const float* noise;
  const float* sigma;
  int S;
  int p0;
  float dn;  // |rays_d|
  __device__ __forceinline__ float raw_sigma(int k) const {
    if constexpr (kLoad == kSigmaL2) return __ldcg(sigma + k);
    if constexpr (kLoad == kSigmaRO) return __ldg(sigma + k);
    return sigma[k];
  }
  // ea = 1 - alpha of sample k
  __device__ __forceinline__ float ea(int k) const {
    const float dz = k + 1 < S ? __fsub_rn(z[p0 + k + 1], z[p0 + k]) : 1e10f;
    return ealpha(noisy(raw_sigma(k), noise, p0 + k), __fmul_rn(dz, dn));
  }
};

// Lane l's share of a ray's samples in a warp's compositing: ceil(S/32)
// consecutive samples [k0, k1) (K5 and K6 partition alike).
__device__ __forceinline__ void lane_samples(int S, int& k0, int& k1) {
  const int n = (S + 31) / 32;
  k0 = min(int(threadIdx.x & 31) * n, S);
  k1 = min(k0 + n, S);
}

// The forward of a ray's compositing by one warp, K5's and K6's, so that
// K6's T, w, depth and acc are K5's bit for bit: the lane's sum of log c
// over its samples in sample order, the lanes' exclusive prefix by a
// shuffle scan in a fixed order (pre0: T of the lane's first sample is
// exp(pre0)), then T_k = exp(prefix), w_k = (1 - ea_k) T_k, on_w(k, w),
// and depth and acc summed over the lane and then over the warp by xor
// butterflies (every lane gets the same). Lean on registers, for the 40 of
// K5's compositing threads.
template <int kLoad, typename OnW>
__device__ __forceinline__ void composite_scan(const RaySamples<kLoad>& rs, int k0, int k1,
                                               float& pre0, float& depth, float& acc,
                                               const OnW& on_w) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll 1
  for (int k = k0; k < k1; ++k) s = __fadd_rn(s, log_c(rs.ea(k)));
  // the lanes' exclusive prefix: an inclusive scan in a fixed order, shifted
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s = __fadd_rn(t, s);
  }
  float pre = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) pre = 0.f;
  pre0 = pre;
  depth = 0.f;
  acc = 0.f;
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const float ea = rs.ea(k);
    const float w = __fmul_rn(__fsub_rn(1.f, ea), expf(pre));
    pre = __fadd_rn(pre, log_c(ea));
    on_w(k, w);
    depth = fmaf(w, rs.z[rs.p0 + k], depth);
    acc = __fadd_rn(acc, w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    depth = __fadd_rn(depth, __shfl_xor_sync(0xffffffffu, depth, o));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  }
}

// One warp composites ray r from its raw planes (sample k of plane c at
// pl[c * plane_stride(a) + k]) by composite_scan, which writes w; then rgb
// over the lane's w just written. Points by 32-bit index off the
// arguments' pointers.
__device__ __forceinline__ void composite_ray(const RenderArgs& a, int r, const float* pl) {
  const int lane = threadIdx.x & 31;
  int k0, k1;
  lane_samples(a.S, k0, k1);
  const int p0 = r * a.S;
  const RaySamples<kSigmaL2> rs{a.z, a.noise, pl + 3 * plane_stride(a), a.S, p0,
                                ray_norm(a.rd + 3 * r)};
  float pre0, depth, acc;
  composite_scan(rs, k0, k1, pre0, depth, acc, [&](int k, float w) { a.w[p0 + k] = w; });
  if (lane == 0) {
    a.disp[r] = disp_of(depth / acc);
    a.acc[r] = acc;
  }
  // rgb over the lane's w
  float rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const float w = a.w[p0 + k];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = fmaf(w, sigmoid(__ldcg(pl + c * plane_stride(a) + k)), rgb[c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = __fadd_rn(rgb[c], __shfl_xor_sync(0xffffffffu, rgb[c], o));
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.rgb[r * 3 + c] = a.white ? rgb[c] + (1.f - acc) : rgb[c];
  }
}

// The stacked K5's slab index of the CTA as its thread 0 stored it after the
// slab's mbarriers (render_bf16_sm90), read afresh where used (a volatile
// shared load): computed from the grid's y and size in the compositing
// warps' 40 registers, it made ptxas spill 20-44 bytes there.
__device__ __forceinline__ int stored_slab_cta(const uint64_t* bars) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(hopper::smem_addr(bars + 2 * SLAB_BUFFERS)));
  return v;
}

// The tile's hook: the producer warpgroup's warps 1-3 composite each ray
// group once the consumers have written its raw, while the consumers go on
// to the next groups. The CTA's k-th group uses slab buffer b = k % 2,
// behind two mbarriers in shared memory (bars, after FwdSmem's):
// full[b] (the 256 consumer threads arrive after their last head of the
// group) and empty[b] (the 96 compositing threads arrive once they have
// read it); the consumers wait on empty[b] before the first head of group
// k >= 2, for group k-2's compositing.
// kStacked: the stacked K5's (SceneGroupWalk), each CTA on its scene's groups.
template <bool kStacked>
struct GroupHook : NoHook {
  const RenderArgs& a;
  uint64_t* bars;  // full[SLAB_BUFFERS], empty[SLAB_BUFFERS]
  __device__ __forceinline__ int local_group(int tile) const {
    return group_count<kStacked>(a, tile / a.n_sub);
  }
  __device__ __forceinline__ void before_head(int tile) const {
    const int k = local_group(tile);
    if (tile % a.n_sub == 0 && k >= SLAB_BUFFERS)
      hopper::mbar_wait(&bars[SLAB_BUFFERS + k % SLAB_BUFFERS], (k / SLAB_BUFFERS - 1) & 1);
  }
  __device__ __forceinline__ void after_tile(int tile, int ntiles) const {
    if ((tile + 1) % a.n_sub == 0 || tile + 1 == ntiles)
      hopper::mbar_arrive(&bars[local_group(tile) % SLAB_BUFFERS]);
  }
  // The CTA's groups, in its walk's order: one net's blockIdx.x, +
  // gridDim.x, ... below n_groups; the stacked walk's the same within scene
  // y's scene_groups (the grid's size and y read anew where they are used:
  // held in a register across the compositing, the size was the one value
  // that spilled).
  __device__ __forceinline__ int group_end() const {
    if constexpr (kStacked) return (grid_y() + 1) * a.scene_groups;
    return a.n_groups;
  }
  __device__ __forceinline__ void side() const {
    const int warp = int(threadIdx.x >> 5) - 1;  // 0-2
    int k = 0;  // the CTA's group count
    int g = int(blockIdx.x);
    if constexpr (kStacked) g += grid_y() * a.scene_groups;
    for (; g < group_end(); g += grid_ctas(), ++k) {
      const int b = k % SLAB_BUFFERS;
      hopper::mbar_wait(&bars[b], (k / SLAB_BUFFERS) & 1);
      const int r_end = min((g + 1) * a.G, a.n_rays);
      if constexpr (kStacked) {  // group_plane<true>, with the CTA's slab index stored
        const float* pl =
            a.raw != nullptr
                ? a.raw + size_t(g) * (a.G * a.S)
                : a.slab + size_t(stored_slab_cta(bars) * SLAB_BUFFERS + b) * RAW_PLANES * (a.G * a.S);
        for (int r = g * a.G + warp; r < r_end; r += COMPOSITE_WARPS)
          composite_ray(a, r, pl + (r - g * a.G) * a.S);
      } else {
        for (int r = g * a.G + warp; r < r_end; r += COMPOSITE_WARPS)
          composite_ray(a, r, group_plane<false>(a, g, b) + (r - g * a.G) * a.S);
      }
      hopper::mbar_arrive(&bars[SLAB_BUFFERS + b]);
    }
  }
};

// Walk: GroupWalk (one net), or SceneGroupWalk (the stacked K5: a net per
// scene, stacked blobs, a scene a row of the grid).
template <int W, typename Walk>
__global__ void __launch_bounds__(FWD_THREADS, 1)
render_bf16_sm90(const __grid_constant__ FwdMaps maps, const __grid_constant__ RenderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStacked = Walk::kStacked;
  uint64_t* bars = reinterpret_cast<uint64_t*>(fwd_smem_base(smem) + FwdSmem<W>::bytes);
  if (threadIdx.x == 0) {  // made visible with the ring's barriers (fwd_tiles_sm90)
    for (int b = 0; b < SLAB_BUFFERS; ++b) {
      hopper::mbar_init(&bars[b], 2 * 128);
      hopper::mbar_init(&bars[SLAB_BUFFERS + b], 32 * COMPOSITE_WARPS);
    }
    if constexpr (kStacked)  // the CTA's slab index, for the compositing warps
      reinterpret_cast<int*>(bars + 2 * SLAB_BUFFERS)[0] = int(blockIdx.y * gridDim.x + blockIdx.x);
  }
  const RaysIn in{a.ro, a.rd, a.z, a.vd, a.S};
  if constexpr (kStacked)
    fwd_tiles_sm90<RaysIn, W>(maps, in, a.n_rays * a.S, a.Fp, a.Fv,
                              static_cast<const bf16*>(a.wb), a.bb, smem, GroupSink<true>{a},
                              SceneGroupWalk{a}, GroupHook<true>{{}, a, bars});
  else
    fwd_tiles_sm90<RaysIn, W>(maps, in, a.n_rays * a.S, a.Fp, a.Fv,
                              static_cast<const bf16*>(a.wb), a.bb, smem, GroupSink<false>{a},
                              GroupWalk{{}, a.n_sub}, GroupHook<false>{{}, a, bars});
}

// ------------------------------------------------------------------ f32

// Raw of the CTA's points into the compositing planes comp[c][p - pbase]
// (stride nq), and to raw planes in device memory where given.
struct SharedSink {
  float* comp;
  int nq;
  int pbase;
  float* raw;
  size_t n_pts;
  __device__ void operator()(int p, int c, float v) const {
    comp[c * nq + (p - pbase)] = v;
    if (raw != nullptr) raw[c * n_pts + p] = v;
  }
};

template <int W>
__global__ void __launch_bounds__(THREADS) render_f32(const RenderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = a.n_sub * TP32;
  float* comp = reinterpret_cast<float*>(smem + F32Smem<W>::bytes);
  const int r0 = blockIdx.x * a.G;
  const int g_rays = min(a.G, a.n_rays - r0);
  const int pbase = r0 * a.S, p_end = pbase + g_rays * a.S;
  const int scene = r0 / a.scene_rays;  // the stacked K5's: its rays' net
  const RaysIn in{a.ro, a.rd, a.z, a.vd, a.S};
  const SharedSink sink{comp, nq, pbase, a.raw, size_t(a.n_rays) * a.S};
  for (int j = 0; j < a.n_sub && pbase + j * TP32 < p_end; ++j)
    fwd_tile_f32<RaysIn, W>(in, p_end, a.Fp, a.Fv,
                            static_cast<const float*>(a.wb) + size_t(scene) * Layout<W>::size,
                            a.bb + size_t(scene) * Layout<W>::nbias, pbase + j * TP32, smem, sink);
  __syncthreads();
  composite(a, comp, nq, r0, g_rays);
}

// K6's compositing backward, one warp per ray: g [4][R*S], the cotangent
// of raw (r, g, b, sigma), from the residual raw [4][R*S] and the maps'
// cotangents g_rgb [R][3], g_disp, g_acc [R], g_w [R][S]. Lane l owns K5's
// samples [k0, k1) of the ray (lane_samples). composite_scan recomputes the
// forward as K5 does (T, w, depth and acc bit for bit); the per-ray terms
// follow (the `live` guard, white_bkgd's -sum g_rgb on g_acc); then, with
// t_k = g_w + g_rgb . s_k + g_depth z_k + g_acc_t and s_k = sigmoid(raw_rgb),
//   d_alpha_k = t_k T_k - (sum_{i>k} t_i w_i) / c_k:
// each lane sums t w over its samples from the back (writing d_rgb on the
// way), an exclusive suffix scan over the lanes in a fixed order
// (shfl_down) gives it the sum past its samples, and a back-to-front pass
// inside the lane writes d_sigma. T and w are recomputed in blocks of
// COMP_BLOCK samples from the back, each block's prefix summed anew from the
// lane's pre0 in K5's order, and held in registers. Two instantiations:
// - kStaged, S <= 32 COMP_BLOCK = 256 (a lane's samples in one block, so the
//   second pass reuses the first's registers): the warp first copies its
//   ray's sigma, z, noise, raw rgb and g_w into shared memory by coalesced
//   loads (a lane's own samples are strided by the partition), computes
//   from there, writes d_rgb and d_sigma over the inputs it has read, and
//   stores the four cotangent rows coalesced;
// - above it, the same passes on device memory, blocks recomputed.
// No scratch plane; every sum runs in a fixed order, so launches are
// bit-identical.
constexpr int COMP_BLOCK = 8;       // samples a lane holds in registers
constexpr int COMP_BWD_WARPS = 4;   // rays a CTA
constexpr int COMP_STAGED_MAX_S = 32 * COMP_BLOCK;
constexpr int COMP_STAGED_PLANES = 7;  // sigma, z, noise, r, g, b, g_w

struct CompositeBwdArgs {
  const float* rd;
  const float* z;
  const float* noise;
  const float* raw;
  const float* g_rgb;
  const float* g_disp;
  const float* g_acc;
  const float* g_w;
  int n_rays;
  int S;
  int white;
  float* g;
};

// A block of a lane's samples, b0 .. b0 + COMP_BLOCK - 1 of [k0, k1), for
// the backward: ea, T, w, t and (sigma > 0) by sample.
struct CompBlock {
  float ea[COMP_BLOCK], T[COMP_BLOCK], w[COMP_BLOCK], t[COMP_BLOCK];
  bool pos[COMP_BLOCK];
};

template <bool kStaged>
__global__ void __launch_bounds__(COMP_BWD_WARPS * 32)
composite_bwd(const __grid_constant__ CompositeBwdArgs a) {
  extern __shared__ float comp_stage[];  // kStaged: [warps][COMP_STAGED_PLANES][S]
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * COMP_BWD_WARPS + warp;
  if (r >= a.n_rays) return;  // whole warps
  const int S = a.S, lane = threadIdx.x & 31;
  const size_t N = size_t(a.n_rays) * S;
  const int p0 = r * S;
  const float* raw = a.raw + p0;  // the ray's plane c at raw[c * N + k]
  float* gout = a.g + p0;
  float* st = comp_stage + warp * COMP_STAGED_PLANES * S;
  if constexpr (kStaged) {
    for (int k = lane; k < S; k += 32) {
      st[k] = __ldg(raw + 3 * N + k);
      st[S + k] = __ldg(a.z + p0 + k);
      if (a.noise != nullptr) st[2 * S + k] = __ldg(a.noise + p0 + k);
#pragma unroll
      for (int c = 0; c < 3; ++c) st[(3 + c) * S + k] = __ldg(raw + c * N + k);
      st[6 * S + k] = __ldg(a.g_w + p0 + k);
    }
    __syncwarp();
  }
  // the ray's inputs and outputs by sample k: staged, or in device memory
  const float* z = kStaged ? st + S : a.z + p0;
  const float* noise = a.noise == nullptr ? nullptr : kStaged ? st + 2 * S : a.noise + p0;
  auto rgb_in = [&](int c, int k) { return kStaged ? st[(3 + c) * S + k] : __ldg(raw + c * N + k); };
  auto gw_in = [&](int k) { return kStaged ? st[6 * S + k] : __ldg(a.g_w + p0 + k); };
  auto d_rgb = [&](int c, int k) -> float& { return kStaged ? st[(3 + c) * S + k] : gout[c * N + k]; };
  auto d_sigma = [&](int k) -> float& { return kStaged ? st[k] : gout[3 * N + k]; };
  constexpr int kLoad = kStaged ? kSigmaPlain : kSigmaRO;
  const RaySamples<kLoad> rs{z, noise, kStaged ? st : raw + 3 * N, S, 0, ray_norm(a.rd + 3 * r)};
  int k0, k1;
  lane_samples(S, k0, k1);
  // the forward again, as K5 computes it
  float pre0, depth, acc;
  composite_scan(rs, k0, k1, pre0, depth, acc, [](int, float) {});
  // disp = 1/max(1e-10, depth/acc); `live` keeps the clamped and the empty
  // ray's 0/0 branch out of the cotangent
  const float ratio = depth / acc;
  const bool live = ratio > 1e-10f;
  const float disp = disp_of(ratio);
  const float gr[3] = {__ldg(a.g_rgb + 3 * r), __ldg(a.g_rgb + 3 * r + 1),
                       __ldg(a.g_rgb + 3 * r + 2)};
  const float dm = live ? -__ldg(a.g_disp + r) * disp * disp : 0.f;
  const float g_depth = live ? dm / acc : 0.f;
  float g_acc_t = __ldg(a.g_acc + r) - (live ? dm * depth / (acc * acc) : 0.f);
  if (a.white) g_acc_t -= (gr[0] + gr[1]) + gr[2];
  // block b0's T, w, t: its prefix from pre0 in sample order (K5's sums);
  // with rgb, its d_rgb (over the raw rgb just read, when staged)
  CompBlock blk;
  auto fill = [&](int b0, bool rgb) {
    float pre = pre0;
#pragma unroll 1
    for (int k = k0; k < b0; ++k) pre = __fadd_rn(pre, log_c(rs.ea(k)));
#pragma unroll
    for (int i = 0; i < COMP_BLOCK; ++i) {
      const int k = b0 + i;
      if (k >= k1) break;
      const float ea = rs.ea(k);
      const float T = expf(pre);
      const float w = __fmul_rn(__fsub_rn(1.f, ea), T);
      pre = __fadd_rn(pre, log_c(ea));
      float sg[3], rgb_dot = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sg[c] = sigmoid(rgb_in(c, k));
        rgb_dot = __fadd_rn(rgb_dot, __fmul_rn(gr[c], sg[c]));
      }
      blk.ea[i] = ea;
      blk.T[i] = T;
      blk.w[i] = w;
      blk.t[i] = __fadd_rn(__fadd_rn(__fadd_rn(gw_in(k), rgb_dot), __fmul_rn(g_depth, z[k])),
                           g_acc_t);
      blk.pos[i] = noisy(rs.raw_sigma(k), noise, k) > 0.f;
      if (rgb)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          d_rgb(c, k) = __fmul_rn(__fmul_rn(__fmul_rn(w, sg[c]), __fsub_rn(1.f, sg[c])), gr[c]);
    }
  };
  const int last = k1 > k0 ? k0 + (k1 - k0 - 1) / COMP_BLOCK * COMP_BLOCK : k0 - 1;
  // the lane's sum of t w from the back
  float tw = 0.f;
#pragma unroll 1
  for (int b0 = last; b0 >= k0; b0 -= COMP_BLOCK) {
    fill(b0, true);  // blk ends up holding the first block, k0
#pragma unroll
    for (int i = COMP_BLOCK - 1; i >= 0; --i)
      if (b0 + i < k1) tw = __fadd_rn(tw, __fmul_rn(blk.t[i], blk.w[i]));
  }
  // the lanes' exclusive suffix: an inclusive scan from the top lane in a
  // fixed order, shifted
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, tw, o);
    if (lane + o < 32) tw = __fadd_rn(tw, u);
  }
  float suffix = __shfl_down_sync(0xffffffffu, tw, 1);
  if (lane == 31) suffix = 0.f;
  __syncwarp();  // every lane's reads of sigma came before d_sigma over it
  // from the back: d_alpha_k = t_k T_k - suffix_k / c_k, d_sigma
  int held = k0;
#pragma unroll 1
  for (int b0 = last; b0 >= k0; b0 -= COMP_BLOCK) {
    if (b0 != held) {  // one block a lane (always, when staged): no refill
      fill(b0, false);
      held = b0;
    }
#pragma unroll
    for (int i = COMP_BLOCK - 1; i >= 0; --i) {
      const int k = b0 + i;
      if (k >= k1) continue;
      const float c = __fadd_rn(blk.ea[i], 1e-10f);
      const float d_alpha = __fsub_rn(__fmul_rn(blk.t[i], blk.T[i]), __fdiv_rn(suffix, c));
      suffix = __fadd_rn(suffix, __fmul_rn(blk.t[i], blk.w[i]));
      const float d_relu = __fmul_rn(__fmul_rn(d_alpha, blk.ea[i]), sample_dist(z, k, S, rs.dn));
      d_sigma(k) = __fmul_rn(d_relu, blk.pos[i] ? 1.f : 0.f);
    }
  }
  if constexpr (kStaged) {  // the cotangent rows, coalesced
    __syncwarp();
    for (int k = lane; k < S; k += 32) {
#pragma unroll
      for (int c = 0; c < 3; ++c) gout[c * N + k] = st[(3 + c) * S + k];
      gout[3 * N + k] = st[k];
    }
  }
}

// K5w's compositing launch (the wide family, fused_mlp_wide.cu, computes
// raw into planes first): a warp per ray composites from the raw planes
// a.raw [4][R*S] by composite_ray, K5's compositing, so its T, w and maps
// are what K5 computes from the same raw.
__global__ void __launch_bounds__(COMP_BWD_WARPS * 32)
composite_planes(const __grid_constant__ RenderArgs a) {
  const int r = blockIdx.x * COMP_BWD_WARPS + (threadIdx.x >> 5);
  if (r >= a.n_rays) return;  // whole warps
  composite_ray(a, r, a.raw + size_t(r) * a.S);
}

long long gcd(long long a, long long b) { return b == 0 ? a : gcd(b, a % b); }

// A group of whole rays that fills whole tiles: G = lcm(S, tile) / S rays,
// n_sub = lcm(S, tile) / tile tiles.
void ray_groups(int S, int tile, int& G, int& n_sub) {
  const long long lcm = S / gcd(S, tile) * tile;
  G = static_cast<int>(lcm / S);
  n_sub = static_cast<int>(lcm / tile);
}

// f32: a CTA's rays and sub-tiles: a group where its raw fits GROUP_BYTES,
// else one ray and its masked tail.
void group_geometry(int S, int tile, int& G, int& n_sub) {
  ray_groups(S, tile, G, n_sub);
  if (static_cast<long long>(n_sub) * tile * COMP_PLANES * 4 > static_cast<long long>(GROUP_BYTES)) {
    G = 1;
    n_sub = (S + tile - 1) / tile;
  }
}

template <typename Kernel>
cudaError_t launch_render(Kernel kernel, size_t base_smem, int tile, RenderArgs a,
                          cudaStream_t stream) {
  group_geometry(a.S, tile, a.G, a.n_sub);
  const size_t smem = base_smem + size_t(COMP_PLANES) * a.n_sub * tile * 4;
  if (smem > size_t(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.n_rays + a.G - 1) / a.G;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16: the weights' tensor maps and a persistent grid of min(groups, the
// device's SM count) CTAs; without raw planes the slab must hold
// CTAs x SLAB_BUFFERS x RAW_PLANES x G*S floats. With scenes > 1 (the
// stacked K5) each scene's scene_rays rays are whole groups, the blobs hold
// a net per scene, and the grid is scene_grid's (x, scenes), a slab per CTA.
template <int W>
cudaError_t launch_render_sm90(RenderArgs a, long long slab_floats, cudaStream_t stream,
                               int scenes) {
  ray_groups(a.S, TP, a.G, a.n_sub);
  if (static_cast<long long>(a.n_sub) * TP > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (scenes > 1 && a.scene_rays % a.G != 0) return cudaErrorInvalidValue;
  FwdMaps maps;
  cudaError_t err = encode_fwd_maps<W>(&maps, static_cast<const bf16*>(a.wb), scenes);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = FwdSmem<W>::launch_bytes + HOOK_BYTES;
  static_assert(smem <= size_t(MAX_SMEM), "the slab's barriers fit beside the tile's");
  const auto kernel = scenes > 1 ? render_bf16_sm90<W, SceneGroupWalk>
                                 : render_bf16_sm90<W, GroupWalk>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  a.n_groups = (a.n_rays + a.G - 1) / a.G;
  dim3 grid(a.n_groups < sms ? a.n_groups : sms);
  if (scenes > 1) {
    a.scene_groups = a.scene_rays / a.G;
    grid = scene_grid(a.scene_groups, scenes, sms);
  }
  if (a.raw == nullptr &&
      (a.slab == nullptr || slab_floats < static_cast<long long>(grid.x) * grid.y *
                                              SLAB_BUFFERS * RAW_PLANES * a.n_sub * TP))
    return cudaErrorInvalidValue;
  kernel<<<grid, FWD_THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

int render_fwd(int use_bf16, int width, RenderArgs a, long long slab_floats, void* stream,
               int scenes) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16) {
    if (width == 256) return launch_render_sm90<256>(a, slab_floats, s, scenes);
    if (width == 128) return launch_render_sm90<128>(a, slab_floats, s, scenes);
  } else {
    int G, n_sub;  // a CTA's rays: no CTA of the stacked K5 may span two scenes
    group_geometry(a.S, TP32, G, n_sub);
    if (scenes > 1 && a.scene_rays % G != 0) return cudaErrorInvalidValue;
    if (width == 256) return launch_render(render_f32<256>, F32Smem<256>::bytes, TP32, a, s);
    if (width == 128) return launch_render(render_f32<128>, F32Smem<128>::bytes, TP32, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry returns a cudaError_t code (0 on success). The launches go on
// `stream` and do not synchronise; all buffers are device pointers, float32
// unless noted; wblob (bf16 if use_bf16 else f32) and bblob are laid out as
// fused_mlp_common.cuh's Layout says.

// K5: rays_o, rays_d, viewdirs [R,3]; z [R,S]; noise [R,S] or null (none);
// out rgb [R,3], disp [R], acc [R], w [R,S], and raw [4,R,S] unless null.
// bf16 without raw takes a scratch slab of slab_floats floats (at least
// fused_render.py::slab_floats), else null.
extern "C" int nerf_fused_render_fwd(int use_bf16, int width, const float* rays_o,
                                     const float* rays_d, const float* viewdirs, const float* z,
                                     const float* noise, int n_rays, int n_samples,
                                     int n_freq_pts, int n_freq_views, int white_bkgd,
                                     const void* wblob, const float* bblob, float* rgb,
                                     float* disp, float* acc, float* w, float* raw, float* slab,
                                     long long slab_floats, void* stream) {
  if (n_freq_pts < 1 || n_freq_pts > MAX_FP || n_freq_views < 1 || n_freq_views > MAX_FV)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (n_rays < 0 || n_samples < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const RenderArgs a{rays_o, rays_d, viewdirs, z, noise, n_rays, n_samples, n_freq_pts,
                     n_freq_views, 0, 0, 0, white_bkgd != 0, wblob, bblob, rgb, disp, acc, w, raw,
                     slab, n_rays, 0};
  return render_fwd(use_bf16, width, a, slab_floats, stream, 1);
}

// The stacked K5 of multi-scene training, one launch for S scenes (the vmap
// over scenes of nerf_tpu's make_multi_scene_step gives _fwd_kernel a scene
// axis, nerf_tpu/parallel/multi_scene.py:44-64): every ray argument and
// output as K5's over all S*R rays, scene s's rays at s*R ..; wblob and
// bblob a net per scene, as nerf_fused_mlp_fwd_stacked takes them. R must
// be whole ray groups of both kernels (a multiple of 128 / gcd(S, 128));
// the wrapper pads each scene's rays. bf16 without raw takes a slab of at
// least fused_render.py::slab_floats(..., scenes) floats: a CTA's buffers
// for each CTA of the (x, scene) grid. Each tile computes what K5 computes
// for it alone, and each ray's compositing is K5's, bit for bit. Bound at
// S = 8, N_rand 1024, 64 + 192 samples: K1's 2.52 ms, by operations.
extern "C" int nerf_fused_render_fwd_stacked(int use_bf16, int width, const float* rays_o,
                                             const float* rays_d, const float* viewdirs,
                                             const float* z, const float* noise, int n_scenes,
                                             int rays_per_scene, int n_samples, int n_freq_pts,
                                             int n_freq_views, int white_bkgd,
                                             const void* wblob, const float* bblob, float* rgb,
                                             float* disp, float* acc, float* w, float* raw,
                                             float* slab, long long slab_floats, void* stream) {
  if (n_freq_pts < 1 || n_freq_pts > MAX_FP || n_freq_views < 1 || n_freq_views > MAX_FV)
    return cudaErrorInvalidValue;
  const long long n_rays = static_cast<long long>(rays_per_scene) * n_scenes;
  if (n_scenes < 1 || rays_per_scene < 1 || n_samples < 1 ||
      n_rays * n_samples > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const RenderArgs a{rays_o, rays_d, viewdirs, z, noise, int(n_rays), n_samples, n_freq_pts,
                     n_freq_views, 0, 0, 0, white_bkgd != 0, wblob, bblob, rgb, disp, acc, w, raw,
                     slab, rays_per_scene, 0};
  return render_fwd(use_bf16, width, a, slab_floats, stream, n_scenes);
}

// K6's compositing backward: rays_d [R,3]; z [R,S]; noise [R,S] or null;
// raw [4,R,S] (K5's residual); g_rgb [R,3]; g_disp, g_acc [R]; g_w [R,S];
// out g_planes [4,R,S], the cotangent of raw for nerf_fused_mlp_bwd.
extern "C" int nerf_fused_render_bwd_planes(const float* rays_d, const float* z,
                                            const float* noise, const float* raw,
                                            const float* g_rgb, const float* g_disp,
                                            const float* g_acc, const float* g_w, int n_rays,
                                            int n_samples, int white_bkgd, float* g_planes,
                                            void* stream) {
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (n_rays < 0 || n_samples < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const CompositeBwdArgs a{rays_d, z,       noise,     raw,       g_rgb,           g_disp,
                           g_acc,  g_w,     n_rays,    n_samples, white_bkgd != 0, g_planes};
  const int grid = (n_rays + COMP_BWD_WARPS - 1) / COMP_BWD_WARPS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_samples <= COMP_STAGED_MAX_S) {
    const size_t smem = size_t(COMP_BWD_WARPS) * COMP_STAGED_PLANES * n_samples * sizeof(float);
    composite_bwd<true><<<grid, COMP_BWD_WARPS * 32, smem, s>>>(a);
  } else {
    composite_bwd<false><<<grid, COMP_BWD_WARPS * 32, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// K5w's compositing: the maps rgb [R,3], disp, acc [R] and w [R,S] of the
// raw planes raw [4,R,S] (the wide family's K1w output), rays_d [R,3], z
// [R,S] and noise [R,S] or null, as K5 composites them.
extern "C" int nerf_fused_render_composite(const float* rays_d, const float* z,
                                           const float* noise, const float* raw, int n_rays,
                                           int n_samples, int white_bkgd, float* rgb, float* disp,
                                           float* acc, float* w, void* stream) {
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (n_rays < 0 || n_samples < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  RenderArgs a{};
  a.rd = rays_d;
  a.z = z;
  a.noise = noise;
  a.n_rays = n_rays;
  a.S = n_samples;
  a.white = white_bkgd != 0;
  a.rgb = rgb;
  a.disp = disp;
  a.acc = acc;
  a.w = w;
  a.raw = const_cast<float*>(raw);
  a.scene_rays = n_rays;
  const int grid = (n_rays + COMP_BWD_WARPS - 1) / COMP_BWD_WARPS;
  composite_planes<<<grid, COMP_BWD_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
