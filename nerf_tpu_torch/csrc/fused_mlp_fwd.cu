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
// Two instantiations: bf16 operands with f32 accumulation (mma.sync
// m16n8k16 on the tensor cores; activations rounded to bf16 between layers,
// as _trunk_forward/_head_forward do), and true f32 with FMA loops (no TF32),
// which computes the f32 mode and isolates indexing faults from rounding.
//
// Bound: 1,186,816 FLOP per point at 8x256 with views, so the kernel is
// compute-bound: at the H100's 989 TFLOP/s bf16 dense rate a 32,768-ray chunk
// takes at least 2.5 ms coarse (S=64) and 7.5 ms fine (S=192); it reads 28 B
// (K1) or 24 B (K2, plus 12 B a point at spr = 1) and writes 16 B per point.
// Design: one CTA owns a tile of 128 points. Its activations live in shared
// memory as bf16 (one [128][W] buffer, updated in place: each layer keeps
// its outputs in registers until every warp has read the inputs). The
// ~0.6 MB of packed weights stays in global memory / L2 and streams through
// a double-buffered shared-memory ring of 64-wide K chunks (cp.async), so all
// 8 warps share one copy of each chunk. Ragged tails are masked per point.
// This is the simple first version; wgmma, TMA and larger tiles are later work.
//
// The tile body (fwd_tile_bf16 / fwd_tile_f32), which K5 in fused_render.cu
// runs too, the weight and bias blobs' Layout and the building blocks shared
// with the backward (K4, K3) live in fused_mlp_common.cuh.

#include "fused_mlp_common.cuh"

namespace {

template <typename In, int W>
__global__ void __launch_bounds__(THREADS, 1)
fwd_bf16(const In in, int n_pts, int Fp, int Fv, const bf16* __restrict__ wb,
         const float* __restrict__ bb, float* __restrict__ out, size_t sc, size_t sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_tile_bf16<In, W>(in, n_pts, Fp, Fv, wb, bb, blockIdx.x * TP, smem, GlobalSink{out, sc, sp});
}

template <typename In, int W>
__global__ void __launch_bounds__(THREADS)
fwd_f32(const In in, int n_pts, int Fp, int Fv, const float* __restrict__ wb,
        const float* __restrict__ bb, float* __restrict__ out, size_t sc, size_t sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_tile_f32<In, W>(in, n_pts, Fp, Fv, wb, bb, blockIdx.x * TP32, smem,
                      GlobalSink{out, sc, sp});
}

template <typename T, typename In, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int tile, const In& in, int n_pts, int Fp,
                          int Fv, const void* wb, const float* bb, float* out, size_t sc,
                          size_t sp, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n_pts + tile - 1) / tile;
  kernel<<<grid, THREADS, smem, stream>>>(in, n_pts, Fp, Fv, static_cast<const T*>(wb), bb, out,
                                          sc, sp);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch(const In& in, int use_bf16, int width, int n_pts, int Fp, int Fv,
                   const void* wb, const float* bb, float* out, size_t sc, size_t sp,
                   cudaStream_t stream) {
#define NERF_ARGS in, n_pts, Fp, Fv, wb, bb, out, sc, sp, stream
  if (use_bf16) {
    if (width == 256) return launch_kernel<bf16>(fwd_bf16<In, 256>, Bf16Smem<256>::bytes, TP, NERF_ARGS);
    if (width == 128) return launch_kernel<bf16>(fwd_bf16<In, 128>, Bf16Smem<128>::bytes, TP, NERF_ARGS);
  } else {
    if (width == 256) return launch_kernel<float>(fwd_f32<In, 256>, F32Smem<256>::bytes, TP32, NERF_ARGS);
    if (width == 128) return launch_kernel<float>(fwd_f32<In, 128>, F32Smem<128>::bytes, TP32, NERF_ARGS);
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
