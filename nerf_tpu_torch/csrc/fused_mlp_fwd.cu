// Fused NeRF forward for Hopper (sm_90a): points -> posenc -> 8xW MLP ->
// raw (r, g, b, sigma), with every activation kept on chip. Two input
// modes, one kernel body (fused_mlp_common.cuh's RaysIn / PointsIn):
//
// K1 replaces nerf_tpu/ops/fused_mlp.py::_fwd_kernel_rays (the Pallas
// kernel behind fused_query_rays_planes): point p = r*S + s of a ray batch is
//   x  = rays_o[r] + rays_d[r] * z[r, s]              (no FMA contraction)
// and raw goes out as planes out[c][p].
// K2 replaces nerf_tpu/ops/fused_mlp.py::_fwd_kernel (behind fused_query):
// x [N][3] is read from memory, its view direction is v[p / spr] (spr = 1: a
// direction per point, spr = S: per ray), and raw goes out as rows out[p][c].
// Then, per point:
//   e  = [x | sin(x*2^f) f-major | cos(x*2^f)]        (Fp octaves, K padded to 64)
//   ev = the same for the view direction              (Fv octaves, K padded to 32)
//   h0 = relu(e W0e + b0), h_i = relu(h_{i-1} W_i + b_i), with e W5e added
//        at layer 5 (the reference's skip after layer 4)
//   feat = h7 Wf + bf;  hv = relu(feat Wvf + ev Wve + bv)
//   raw  = [hv | h7] Wout + bout
// Two instantiations: bf16 operands with f32 accumulation (wgmma on the
// tensor cores; activations rounded to bf16 between layers, as
// _trunk_forward/_head_forward do), and true f32 with FMA loops (no TF32),
// which computes the f32 mode and isolates indexing faults from rounding.
//
// Bound: 1,186,816 FLOP per point at 8x256 with views, so the kernel is
// bound by operations: at the H100's 989 TFLOP/s bf16 dense rate a
// 32,768-ray chunk (64 + 192 samples) takes at least 10.07 ms (2.52 coarse,
// 7.55 fine); it reads 28 B (K1) or 24 B (K2, plus 12 B a point at spr = 1)
// and writes 16 B per point. The weights come from L2: the bf16 blob,
// 1,190,912 bytes at 8x256 (fused_mlp.py::fwd_weight_bytes_per_tile), is
// streamed once per 128-point tile, ~78 GB per chunk at 64 + 192.
//
// Design of the bf16 kernel (fwd_bf16_sm90, whose tile body is
// fwd_tile_sm90.cuh's fwd_tiles_sm90): a persistent grid of min(tiles, SMs)
// CTAs of 384 threads, each walking 128-point tiles. A producer warpgroup
// (one thread issuing) streams the weights by TMA, as 64-wide K chunks of
// the blob's K-major W^T blocks through four tensor maps with the 128-byte
// swizzle, into a 4-stage mbarrier ring, running ahead into the next tile;
// two consumer warpgroups own 64 points each and run wgmma m64nNk16 (N = W,
// W/2 for the view layer) with A, their activations, from shared memory in
// the swizzled layout and B from the ring. What that does about the earlier
// warp-MMA tile (since retired; K5, the backward's recompute and K7's probes
// run this tile too, fused_render.cu, fused_mlp_bwd.cu, probe_overlap.cu):
//  - products: wgmma reads both operands from shared memory, where the
//    warp-MMA tile loaded every fragment with scalar 32-bit shared loads;
//  - the weight ring: one thread and the TMA engine move the weights, four
//    stages deep, against a two-stage cp.async ring that all 256 threads
//    filled and fenced with two __syncthreads a chunk;
//  - the epilogue: each warpgroup syncs only itself (a named barrier), the
//    two take turns issuing a layer's products (ping-pong), so one's
//    epilogue runs under the other's products, and the head runs from
//    registers (hv is never stored);
//  - the weight stream: a CTA keeps the ring busy across tiles; the blob is
//    still read from L2 once per 128-point tile.
// Ragged tails are masked per point. The f32 kernel (fwd_f32) keeps the
// simple one-tile-per-CTA FMA body.
//
// The f32 tile body (fwd_tile_f32), which K5 in fused_render.cu runs too,
// the weight and bias blobs' Layout and the building blocks shared with the
// backward (K4, K3) live in fused_mlp_common.cuh.

#include "fused_mlp_common.cuh"
#include "fwd_tile_sm90.cuh"

namespace {

// Walk: TileWalk (one net), or SceneWalk (the stacked launch: a net per
// scene, stacked blobs).
template <typename In, int W, typename Walk>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fwd_bf16_sm90(const __grid_constant__ FwdMaps maps, const In in, int n_pts, int Fp, int Fv,
              const bf16* __restrict__ wb, const float* __restrict__ bb, float* __restrict__ out,
              size_t sc, size_t sp, const Walk walk) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_tiles_sm90<In, W>(maps, in, n_pts, Fp, Fv, wb, bb, smem, GlobalSink{out, sc, sp}, walk);
}

// One tile a CTA; tile t reads the blobs of scene t / tiles_per_scene
// (stacked as SceneWalk's; one net: a tiles_per_scene beyond the grid).
template <typename In, int W>
__global__ void __launch_bounds__(THREADS)
fwd_f32(const In in, int n_pts, int Fp, int Fv, const float* __restrict__ wb,
        const float* __restrict__ bb, float* __restrict__ out, size_t sc, size_t sp,
        int tiles_per_scene) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int scene = blockIdx.x / tiles_per_scene;
  fwd_tile_f32<In, W>(in, n_pts, Fp, Fv, wb + size_t(scene) * Layout<W>::size,
                      bb + size_t(scene) * Layout<W>::nbias, blockIdx.x * TP32, smem,
                      GlobalSink{out, sc, sp});
}

#define NERF_CHECK(x)                 \
  do {                                \
    cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// The bf16 launch: the blob's four tensor maps, encoded per launch, and a
// persistent grid of min(tiles, the device's SM count) CTAs. With scenes >
// 1 the n_pts points are that many scenes' in turn, each a whole number of
// tiles, and wblob / bb hold a net per scene (SceneWalk: scene_grid's CTAs
// a scene).
template <typename In, int W>
cudaError_t launch_bf16(const In& in, int n_pts, int Fp, int Fv, const void* wblob,
                        const float* bb, float* out, size_t sc, size_t sp, int scenes,
                        cudaStream_t stream) {
  const bf16* wb = static_cast<const bf16*>(wblob);
  FwdMaps maps;
  NERF_CHECK(encode_fwd_maps<W>(&maps, wb, scenes));
  constexpr size_t smem = FwdSmem<W>::launch_bytes;
  int dev = 0, sms = 0;
  NERF_CHECK(cudaGetDevice(&dev));
  NERF_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int tiles = (n_pts + TP - 1) / TP;
  const int grid = tiles < sms ? tiles : sms;
  if (scenes == 1) {
    NERF_CHECK(cudaFuncSetAttribute(fwd_bf16_sm90<In, W, TileWalk>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
    fwd_bf16_sm90<In, W, TileWalk><<<grid, FWD_THREADS, smem, stream>>>(
        maps, in, n_pts, Fp, Fv, wb, bb, out, sc, sp, TileWalk());
  } else {  // the stacked K1 (rays) and K2 (points)
    NERF_CHECK(cudaFuncSetAttribute(fwd_bf16_sm90<In, W, SceneWalk>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
    fwd_bf16_sm90<In, W, SceneWalk><<<scene_grid(tiles / scenes, scenes, sms), FWD_THREADS, smem,
                                      stream>>>(maps, in, n_pts, Fp, Fv, wb, bb, out, sc, sp,
                                                SceneWalk{tiles / scenes});
  }
  return cudaGetLastError();
}

template <typename In, int W>
cudaError_t launch_f32(const In& in, int n_pts, int Fp, int Fv, const void* wb, const float* bb,
                       float* out, size_t sc, size_t sp, int scenes, cudaStream_t stream) {
  constexpr size_t smem = F32Smem<W>::bytes;
  NERF_CHECK(cudaFuncSetAttribute(fwd_f32<In, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem)));
  const int tiles = (n_pts + TP32 - 1) / TP32;
  fwd_f32<In, W><<<tiles, THREADS, smem, stream>>>(in, n_pts, Fp, Fv,
                                                   static_cast<const float*>(wb), bb, out, sc,
                                                   sp, scenes == 1 ? tiles : tiles / scenes);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch(const In& in, int use_bf16, int width, int n_pts, int Fp, int Fv,
                   const void* wb, const float* bb, float* out, size_t sc, size_t sp,
                   cudaStream_t stream, int scenes = 1) {
#define NERF_ARGS in, n_pts, Fp, Fv, wb, bb, out, sc, sp, scenes, stream
  if (use_bf16) {
    if (width == 256) return launch_bf16<In, 256>(NERF_ARGS);
    if (width == 128) return launch_bf16<In, 128>(NERF_ARGS);
  } else {
    if (width == 256) return launch_f32<In, 256>(NERF_ARGS);
    if (width == 128) return launch_f32<In, 128>(NERF_ARGS);
  }
#undef NERF_ARGS
  return cudaErrorInvalidValue;
}

bool valid_freqs(int n_freq_pts, int n_freq_views) {
  return n_freq_pts >= 1 && n_freq_pts <= MAX_FP && n_freq_views >= 1 && n_freq_views <= MAX_FV;
}

}  // namespace

// Both entries return a cudaError_t code (0 on success). The launch goes on
// `stream` and does not synchronise; all buffers are device pointers,
// float32 unless noted; wblob (bf16 if use_bf16 else f32) and bblob are laid
// out as Layout says.

// K1: rays_o, rays_d, viewdirs [R,3]; z [R,S]; out [4,R,S].
extern "C" int nerf_fused_mlp_fwd(int use_bf16, int width, const float* rays_o,
                                  const float* rays_d, const float* viewdirs, const float* z,
                                  int n_rays, int n_samples, int n_freq_pts, int n_freq_views,
                                  const void* wblob, const float* bblob, float* out,
                                  void* stream) {
  if (!valid_freqs(n_freq_pts, n_freq_views)) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (n_rays < 0 || n_samples < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int n_pts = static_cast<int>(n);
  const RaysIn in{rays_o, rays_d, z, viewdirs, n_samples};
  return launch(in, use_bf16, width, n_pts, n_freq_pts, n_freq_views, wblob, bblob, out,
                size_t(n_pts), 1, static_cast<cudaStream_t>(stream));
}

// The stacked K1 of multi-scene training, one launch for S scenes (the
// vmap over scenes of nerf_tpu's make_multi_scene_step gives
// _fwd_kernel_rays a scene axis, nerf_tpu/parallel/multi_scene.py:44-64):
// rays_o, rays_d, viewdirs [S*R,3] and z [S*R,N], scene s's rays at rows
// s*R ..; wblob [S][Layout size] and bblob [S][nbias], a net per scene;
// out [4][S*R*N] (K1's planes over all S*R rays). R must be a multiple of
// 64 (the stacked backward's per-ray rows; a scene's R*N points are then
// whole tiles, so no tile spans two scenes); the wrapper pads each scene's
// rays. Each tile computes what K1 computes for it alone, bit for bit.
// Bound at S = 8, N_rand 1024, 64 + 192 samples (the configs/multi
// recipe, 2,097,152 points a step): 2.52 ms at 989 TFLOP/s, by operations.
extern "C" int nerf_fused_mlp_fwd_stacked(int use_bf16, int width, const float* rays_o,
                                          const float* rays_d, const float* viewdirs,
                                          const float* z, int n_scenes, int rays_per_scene,
                                          int n_samples, int n_freq_pts, int n_freq_views,
                                          const void* wblob, const float* bblob, float* out,
                                          void* stream) {
  if (!valid_freqs(n_freq_pts, n_freq_views)) return cudaErrorInvalidValue;
  const long long per = static_cast<long long>(rays_per_scene) * n_samples;
  const long long n = per * n_scenes;
  if (n_scenes < 1 || rays_per_scene < 64 || rays_per_scene % 64 != 0 || n_samples < 1 ||
      per % TP != 0 || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int n_pts = static_cast<int>(n);
  const RaysIn in{rays_o, rays_d, z, viewdirs, n_samples};
  return launch(in, use_bf16, width, n_pts, n_freq_pts, n_freq_views, wblob, bblob, out,
                size_t(n_pts), 1, static_cast<cudaStream_t>(stream), n_scenes);
}

// The stacked K2 of multi-scene training, one launch for S scenes (the
// vmap over scenes of nerf_tpu's make_multi_scene_step gives _fwd_kernel a
// scene axis, nerf_tpu/parallel/multi_scene.py:44-64): x [S*P,3], scene s's
// points at rows s*P ..; v [S*P/spr,3], point p looking along v[p / spr];
// wblob and bblob a net per scene, as nerf_fused_mlp_fwd_stacked takes
// them; out [S*P,4] (K2's rows over all S*P points). P must be whole tiles
// (a multiple of 128) and a multiple of spr, so that no tile and no view
// spans two scenes; the wrapper pads each scene's points by whole rays. Each
// tile computes what K2 computes for it alone, bit for bit. Bound at S = 8,
// N_rand 1024, 63 + 191 samples (2,080,768 points a step): 2.50 ms at 989
// TFLOP/s, by operations.
extern "C" int nerf_fused_mlp_fwd_points_stacked(int use_bf16, int width, const float* x,
                                                 const float* v, int n_scenes, int pts_per_scene,
                                                 int spr, int n_freq_pts, int n_freq_views,
                                                 const void* wblob, const float* bblob,
                                                 float* out, void* stream) {
  if (!valid_freqs(n_freq_pts, n_freq_views)) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(pts_per_scene) * n_scenes;
  if (n_scenes < 1 || pts_per_scene < TP || pts_per_scene % TP != 0 || spr < 1 ||
      pts_per_scene % spr != 0 || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const PointsIn in{x, v, spr};
  return launch(in, use_bf16, width, int(n), n_freq_pts, n_freq_views, wblob, bblob, out, 1, 4,
                static_cast<cudaStream_t>(stream), n_scenes);
}

// K2: x [N,3]; v [N/spr,3], point p looking along v[p / spr]; out [N,4].
extern "C" int nerf_fused_mlp_fwd_points(int use_bf16, int width, const float* x,
                                         const float* v, int n_pts, int spr, int n_freq_pts,
                                         int n_freq_views, const void* wblob,
                                         const float* bblob, float* out, void* stream) {
  if (!valid_freqs(n_freq_pts, n_freq_views)) return cudaErrorInvalidValue;
  if (n_pts < 0 || spr < 1 || n_pts % spr != 0) return cudaErrorInvalidValue;
  if (n_pts == 0) return cudaSuccess;
  const PointsIn in{x, v, spr};
  return launch(in, use_bf16, width, n_pts, n_freq_pts, n_freq_views, wblob, bblob, out, 1, 4,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
