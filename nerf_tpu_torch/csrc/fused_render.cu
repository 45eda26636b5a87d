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
// per-ray kernel here (composite_bwd) recomputes T, w, c, depth and acc from
// the residual raw and forms the cotangent of raw as _bwd_rule does
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
// Design: K1's CTA owns 128 points, which at S = 192 is 1.5 rays, but
// compositing needs whole rays in one CTA. So a K5 CTA owns a group of G
// whole rays, G = lcm(S, tile) / S (2 at S = 64 and at S = 192), and runs
// the shared tile body (fused_mlp_common.cuh) over the group's G*S/tile
// sub-tiles with a sink that keeps raw in shared memory (20 B a point with
// the compositing scratch). Where that group would hold more than
// GROUP_BYTES of it (S = 200: lcm = 3200 points), the CTA takes one ray and
// masks the tail of its last sub-tile. The compositing then runs in the
// CTA: the per-point transcendentals (exp, log, sigmoid) on every thread,
// the two sums in sample order on one thread per ray. The f32 instantiation
// does the same with 64-point sub-tiles. composite_bwd is one thread per
// ray, three passes over its samples; every sum runs in a fixed order, so
// launches are bit-identical. This is the simple first version.

#include "fused_mlp_common.cuh"

namespace {

constexpr int COMP_PLANES = 5;        // r, g, b, sigma (-> ea), log c (-> prefix -> w)
constexpr size_t GROUP_BYTES = 16384;  // shared memory for a multi-ray group's points
constexpr int MAX_SMEM = 232448;       // a block's dynamic shared memory on sm_90

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
  int G;      // rays per CTA
  int n_sub;  // sub-tiles per CTA
  int white;
  const void* wb;
  const float* bb;
  float* rgb;   // [R][3]
  float* disp;  // [R]
  float* acc;   // [R]
  float* w;     // [R][S]
  float* raw;   // planes [4][R*S], or null
};

// Raw of the CTA's points into the compositing planes comp[c][p - pbase]
// (stride nq), and to raw planes in device memory where given.
struct GroupSink {
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

template <int W>
__global__ void __launch_bounds__(THREADS, 1) render_bf16(const RenderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = a.n_sub * TP;
  float* comp = reinterpret_cast<float*>(smem + Bf16Smem<W>::bytes);
  const int r0 = blockIdx.x * a.G;
  const int g_rays = min(a.G, a.n_rays - r0);
  const int pbase = r0 * a.S, p_end = pbase + g_rays * a.S;
  const RaysIn in{a.ro, a.rd, a.z, a.vd, a.S};
  const GroupSink sink{comp, nq, pbase, a.raw, size_t(a.n_rays) * a.S};
  for (int j = 0; j < a.n_sub && pbase + j * TP < p_end; ++j)
    fwd_tile_bf16<RaysIn, W>(in, p_end, a.Fp, a.Fv, static_cast<const bf16*>(a.wb), a.bb,
                             pbase + j * TP, smem, sink);
  __syncthreads();
  composite(a, comp, nq, r0, g_rays);
}

template <int W>
__global__ void __launch_bounds__(THREADS) render_f32(const RenderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = a.n_sub * TP32;
  float* comp = reinterpret_cast<float*>(smem + F32Smem<W>::bytes);
  const int r0 = blockIdx.x * a.G;
  const int g_rays = min(a.G, a.n_rays - r0);
  const int pbase = r0 * a.S, p_end = pbase + g_rays * a.S;
  const RaysIn in{a.ro, a.rd, a.z, a.vd, a.S};
  const GroupSink sink{comp, nq, pbase, a.raw, size_t(a.n_rays) * a.S};
  for (int j = 0; j < a.n_sub && pbase + j * TP32 < p_end; ++j)
    fwd_tile_f32<RaysIn, W>(in, p_end, a.Fp, a.Fv, static_cast<const float*>(a.wb), a.bb,
                            pbase + j * TP32, smem, sink);
  __syncthreads();
  composite(a, comp, nq, r0, g_rays);
}

// K6's compositing backward, one thread per ray: g [4][R*S], the cotangent
// of raw (r, g, b, sigma), from the residual raw [4][R*S] and the maps'
// cotangents g_rgb [R][3], g_disp, g_acc [R], g_w [R][S]. Plane 3 of g
// holds T between the passes.
__global__ void composite_bwd(const float* __restrict__ rd, const float* __restrict__ z_all,
                              const float* __restrict__ noise, const float* __restrict__ raw,
                              const float* __restrict__ g_rgb, const float* __restrict__ g_disp,
                              const float* __restrict__ g_acc, const float* __restrict__ g_w,
                              int n_rays, int S, int white, float* __restrict__ g) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const size_t N = size_t(n_rays) * S, p0 = size_t(r) * S;
  const float* z = z_all + p0;
  const float dn = ray_norm(rd + 3 * r);
  // forward again, as K5 computes it: T_k (kept in plane 3), depth, acc
  float pre = 0.f, depth = 0.f, acc = 0.f;
  for (int k = 0; k < S; ++k) {
    const float e = ealpha(noisy(raw[3 * N + p0 + k], noise, p0 + k), sample_dist(z, k, S, dn));
    const float T = expf(pre);
    const float w = __fmul_rn(__fsub_rn(1.f, e), T);
    depth = fmaf(w, z[k], depth);
    acc = __fadd_rn(acc, w);
    g[3 * N + p0 + k] = T;
    pre = __fadd_rn(pre, log_c(e));
  }
  // disp = 1/max(1e-10, depth/acc); `live` keeps the clamped and the empty
  // ray's 0/0 branch out of the cotangent
  const float ratio = depth / acc;
  const bool live = ratio > 1e-10f;
  const float disp = disp_of(ratio);
  const float gr[3] = {g_rgb[3 * r], g_rgb[3 * r + 1], g_rgb[3 * r + 2]};
  const float dm = live ? -g_disp[r] * disp * disp : 0.f;
  const float g_depth = live ? dm / acc : 0.f;
  float g_acc_t = g_acc[r] - (live ? dm * depth / (acc * acc) : 0.f);
  if (white) g_acc_t -= (gr[0] + gr[1]) + gr[2];
  // from the back: d_alpha_k = t_k T_k - (sum_{i>k} t_i w_i) / c_k
  float suffix = 0.f;
  for (int k = S - 1; k >= 0; --k) {
    const size_t p = p0 + k;
    const float sigma = noisy(raw[3 * N + p], noise, p);
    const float dist = sample_dist(z, k, S, dn);
    const float e = ealpha(sigma, dist);
    const float c = __fadd_rn(e, 1e-10f);
    const float T = g[3 * N + p];
    const float w = __fmul_rn(__fsub_rn(1.f, e), T);
    float s[3], rgb_dot = 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      s[ch] = sigmoid(raw[ch * N + p]);
      rgb_dot = __fadd_rn(rgb_dot, __fmul_rn(gr[ch], s[ch]));
    }
    const float t = __fadd_rn(__fadd_rn(__fadd_rn(g_w[p], rgb_dot), __fmul_rn(g_depth, z[k])),
                              g_acc_t);
    const float d_alpha = __fsub_rn(__fmul_rn(t, T), __fdiv_rn(suffix, c));
    suffix = __fadd_rn(suffix, __fmul_rn(t, w));
    const float d_relu = __fmul_rn(__fmul_rn(d_alpha, e), dist);
    g[3 * N + p] = __fmul_rn(d_relu, sigma > 0.f ? 1.f : 0.f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      g[ch * N + p] = __fmul_rn(__fmul_rn(__fmul_rn(w, s[ch]), __fsub_rn(1.f, s[ch])), gr[ch]);
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// A CTA's rays and sub-tiles: a whole number of tiles of whole rays where
// that fits GROUP_BYTES, else one ray and its masked tail.
void group_geometry(int S, int tile, int& G, int& n_sub) {
  const long long lcm = static_cast<long long>(S) / gcd(S, tile) * tile;
  if (lcm * COMP_PLANES * 4 <= static_cast<long long>(GROUP_BYTES)) {
    G = static_cast<int>(lcm / S);
    n_sub = static_cast<int>(lcm / tile);
  } else {
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

}  // namespace

// Every entry returns a cudaError_t code (0 on success). The launches go on
// `stream` and do not synchronise; all buffers are device pointers, float32
// unless noted; wblob (bf16 if use_bf16 else f32) and bblob are laid out as
// fused_mlp_common.cuh's Layout says.

// K5: rays_o, rays_d, viewdirs [R,3]; z [R,S]; noise [R,S] or null (none);
// out rgb [R,3], disp [R], acc [R], w [R,S], and raw [4,R,S] unless null.
extern "C" int nerf_fused_render_fwd(int use_bf16, int width, const float* rays_o,
                                     const float* rays_d, const float* viewdirs, const float* z,
                                     const float* noise, int n_rays, int n_samples,
                                     int n_freq_pts, int n_freq_views, int white_bkgd,
                                     const void* wblob, const float* bblob, float* rgb,
                                     float* disp, float* acc, float* w, float* raw,
                                     void* stream) {
  if (n_freq_pts < 1 || n_freq_pts > MAX_FP || n_freq_views < 1 || n_freq_views > MAX_FV)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (n_rays < 0 || n_samples < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  RenderArgs a{rays_o, rays_d, viewdirs, z, noise, n_rays, n_samples, n_freq_pts, n_freq_views,
               0, 0, white_bkgd != 0, wblob, bblob, rgb, disp, acc, w, raw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16) {
    if (width == 256) return launch_render(render_bf16<256>, Bf16Smem<256>::bytes, TP, a, s);
    if (width == 128) return launch_render(render_bf16<128>, Bf16Smem<128>::bytes, TP, a, s);
  } else {
    if (width == 256) return launch_render(render_f32<256>, F32Smem<256>::bytes, TP32, a, s);
    if (width == 128) return launch_render(render_f32<128>, F32Smem<128>::bytes, TP32, a, s);
  }
  return cudaErrorInvalidValue;
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
  constexpr int block = 128;
  composite_bwd<<<(n_rays + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rays_d, z, noise, raw, g_rgb, g_disp, g_acc, g_w, n_rays, n_samples, white_bkgd != 0,
      g_planes);
  return cudaGetLastError();
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
