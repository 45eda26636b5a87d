// Building blocks shared by the fused NeRF MLP kernels (fused_mlp_fwd.cu:
// K1 and K2, fused_mlp_bwd.cu: K4 and K3, fused_render.cu: K5, and K7's
// probes in probe_overlap.cu): the two input modes, the weight-blob layout,
// the posenc embedding and its backward, and the f32 forward tile
// (fwd_tile_f32: FMA layers), which hands raw to a caller-given sink. In
// bf16 every kernel runs fwd_tile_sm90.cuh's TMA + wgmma tile or its
// pieces; the tile of warp-level MMAs (HMMA in SASS) that K1 ran before
// it, and K7 last, is gone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KE = 64;       // padded point-embedding width (3 + 6*10 = 63)
constexpr int KV = 32;       // padded view-embedding width (3 + 6*4 = 27)
constexpr int MAX_FP = 10;
constexpr int MAX_FV = 4;
constexpr int THREADS = 256;  // 8 warps
constexpr int KC = 64;        // K chunk of the weight ring

// K1's weight blob (element type T): row-major [out][in] blocks, in order
//   W05e^T [2W][64] | W1^T..W7^T [W][W] | Wf^T [W][W] | Wvf^T [W/2][W] |
//   Wve^T [W/2][32] | Wout [3W/2][4]
// and bias blob (f32): b0..b7 [W] | bf [W] | bv [W/2] | bout [4].
template <int W>
struct Layout {
  static constexpr size_t w05 = 0;
  static constexpr size_t w1 = w05 + size_t(2 * W) * KE;
  __host__ __device__ static size_t wi(int i) { return w1 + size_t(i - 1) * W * W; }
  static constexpr size_t wf = w1 + size_t(7) * W * W;
  static constexpr size_t wvf = wf + size_t(W) * W;
  static constexpr size_t wve = wvf + size_t(W / 2) * W;
  static constexpr size_t wout = wve + size_t(W / 2) * KV;
  static constexpr size_t size = wout + size_t(3 * W / 2) * 4;  // one net's blob
  static constexpr int bf = 8 * W;
  static constexpr int bv = 9 * W;
  static constexpr int bout = 9 * W + W / 2;
  static constexpr int nbias = bout + 4;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// Where a tile's points come from. Both modes give point p a position x and
// a view direction v[p / spr] (v holds one direction per spr points).
// RaysIn (K1, K4): p = r*S + s of a ray batch, x = ro[r] + rd[r]*z[p]
// (a separate multiply and add: no FMA contraction), spr = S.
struct RaysIn {
  const float* ro;
  const float* rd;
  const float* z;
  const float* v;
  int spr;
  __device__ void point(int p, float (&x)[3]) const {
    const int r = p / spr;
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = __fadd_rn(ro[r * 3 + d], __fmul_rn(rd[r * 3 + d], z[p]));
  }
};
// PointsIn (K2, K3): x [N][3] from memory; spr = 1 (a direction per point)
// or the samples per ray.
struct PointsIn {
  const float* x;
  const float* v;
  int spr;
  __device__ void point(int p, float (&y)[3]) const {
#pragma unroll
    for (int d = 0; d < 3; ++d) y[d] = x[size_t(p) * 3 + d];
  }
};
template <typename In>
__device__ __forceinline__ void view_of(const In& in, int p, float (&v)[3]) {
  const int r = p / in.spr;
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = in.v[size_t(r) * 3 + d];
}

// The embedding's trig: sincosf keeps its range reduction, since the phases
// reach |x*2^9| ~ 3100, where __sinf/__cosf are wrong (built without
// --use_fast_math). K7's probes swap in others (probe_overlap.cu).
struct SinCos {
  __device__ __forceinline__ void operator()(float xb, float& s, float& c) const {
    sincosf(xb, &s, &c);
  }
};

// One embedding row in kernel order [x | sin(x*2^f) f-major | cos], zero-padded
// to K entries (trig(x*2^f, s, c) gives the sine and cosine).
template <typename T, typename Trig = SinCos>
__device__ void embed_row(const float (&x)[3], int F, int K, T* row, const Trig& trig = Trig()) {
#pragma unroll
  for (int d = 0; d < 3; ++d) row[d] = from_f<T>(x[d]);
  for (int f = 0; f < F; ++f) {
    const float scale = float(1 << f);  // exact power of two
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s, c;
      trig(__fmul_rn(x[d], scale), s, c);
      row[3 + f * 3 + d] = from_f<T>(s);
      row[3 + 3 * F + f * 3 + d] = from_f<T>(c);
    }
  }
  for (int k = 3 + 6 * F; k < K; ++k) row[k] = from_f<T>(0.f);
}

// Point (tid < tile) or view (tid >= tile) embedding of one point of the
// tile, in kernel row order, zero-padded to the buffer's K. Threads beyond
// 2*tile do nothing; masked points embed zeros.
template <typename T, typename In>
__device__ void embed_tile(const In& in, int n_pts, int Fp, int Fv, int p0, int tile, T* emb,
                           int lde, T* embv, int ldv) {
  const int tid = threadIdx.x;
  const bool pts = tid < tile;
  const int i = pts ? tid : tid - tile;
  if (i >= tile) return;
  const int p = p0 + i;
  float x[3] = {0.f, 0.f, 0.f};
  if (p < n_pts) {
    if (pts)
      in.point(p, x);
    else
      view_of(in, p, x);
  }
  embed_row<T>(x, pts ? Fp : Fv, pts ? KE : KV, pts ? emb + i * lde : embv + i * ldv);
}

// The backward of embed_row for one row: dx[d] = d_e[d] + sum over f of
// 2^f (d_e[sin f, d] cos(x_d 2^f) - d_e[cos f, d] sin(x_d 2^f)), with the
// f32 sin/cos of the forward recomputed (d_e is the cotangent of the
// embedding row, kernel order, f32, at stride 1).
__device__ __forceinline__ void embed_row_backward(const float (&x)[3], int F, const float* d_e,
                                                   float (&dx)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float acc = 0.f;
    for (int f = 0; f < F; ++f) {
      const float scale = float(1 << f);
      float s, c;
      sincosf(__fmul_rn(x[d], scale), &s, &c);
      const float d_xb = __fsub_rn(__fmul_rn(d_e[3 + f * 3 + d], c),
                                   __fmul_rn(d_e[3 + 3 * F + f * 3 + d], s));
      acc = __fadd_rn(acc, __fmul_rn(scale, d_xb));  // exact scaling by 2^f
    }
    dx[d] = __fadd_rn(d_e[d], acc);
  }
}

// Where the forward tile puts raw: sink(p, c, v) receives channel c of
// point p. GlobalSink writes out[c*sc + p*sp] to device memory (planes
// [4][N]: sc = N, sp = 1, K1; rows [N][4]: sc = 1, sp = 4, K2).
struct GlobalSink {
  float* out;
  size_t sc;
  size_t sp;
  __device__ void operator()(int p, int c, float v) const { out[c * sc + size_t(p) * sp] = v; }
};

// sink(p, c, v) for the tile's points p = p0 + i < n_pts: raw = hv Wout[:W/2]
// + part + bout, where part = h7 Wout[W/2:] was computed before h7 was
// overwritten.
template <typename T, int W, typename Sink>
__device__ void head(const T* hv, int ldh, const T* __restrict__ wout, const float* part,
                     const float* __restrict__ bout, int n_pts, int p0, int tile,
                     const Sink& sink) {
  for (int idx = threadIdx.x; idx < tile * 4; idx += THREADS) {
    const int i = idx % tile, c = idx / tile;
    float acc = 0.f;
    for (int k = 0; k < W / 2; ++k) acc = fmaf(to_f(hv[i * ldh + k]), to_f(wout[k * 4 + c]), acc);
    const float v = (acc + part[i * 4 + c]) + bout[c];
    const int p = p0 + i;
    if (p < n_pts) sink(p, c, v);
  }
}

// part[i][c] = h7[i] . Wout[W/2 + k][c]
template <typename T, int W>
__device__ void head_part(const T* h7, int ldh, const T* __restrict__ wout, float* part, int tile) {
  for (int idx = threadIdx.x; idx < tile * 4; idx += THREADS) {
    const int i = idx % tile, c = idx / tile;
    float acc = 0.f;
    for (int k = 0; k < W; ++k)
      acc = fmaf(to_f(h7[i * ldh + k]), to_f(wout[(W / 2 + k) * 4 + c]), acc);
    part[i * 4 + c] = acc;
  }
}

// ---------------------------------------------------------------- bf16 path

constexpr int TP = 128;  // points of a bf16 tile (fwd_tile_sm90.cuh: two warpgroups of 64)

// cp.async commit groups (the cotangent chain copies its mask words with
// cp.async, fused_mlp_bwd.cu).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ----------------------------------------------------------------- f32 path

constexpr int TP32 = 64;  // points per CTA
template <int W> struct F32Smem {
  static constexpr int lda = W + 1;  // odd strides: conflict-free column reads
  static constexpr int lde = KE + 1;
  static constexpr int ldv = KV + 1;
  static constexpr size_t a = 0;
  static constexpr size_t b = a + size_t(TP32) * lda * 4;
  static constexpr size_t emb = b + size_t(TP32) * lda * 4;
  static constexpr size_t embv = emb + size_t(TP32) * lde * 4;
  static constexpr size_t part = embv + size_t(TP32) * ldv * 4;
  static constexpr size_t bytes = part + size_t(TP32) * 4 * 4;
};

// out[i][n] = act(A1[i] . W1[n] + A2[i] . W2[n] + bias[n]) for the tile's
// 64 rows; warp w takes columns n = w, w+8, ...; lane takes rows lane and
// lane+32. Weights W^T are [N][K] rows in global memory (one broadcast load
// per k for the warp).
__device__ void dense_f32(const float* A1, int lda1, int K1, const float* __restrict__ W1,
                          const float* A2, int lda2, int K2, const float* __restrict__ W2,
                          const float* __restrict__ bias, int N, float* out, int ldo,
                          bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < N; n += THREADS / 32) {
    float a0 = 0.f, a1 = 0.f;
    const float* w = W1 + size_t(n) * K1;
    for (int k = 0; k < K1; ++k) {
      const float wk = __ldg(w + k);
      a0 = fmaf(A1[lane * lda1 + k], wk, a0);
      a1 = fmaf(A1[(lane + 32) * lda1 + k], wk, a1);
    }
    if (A2 != nullptr) {
      const float* w2 = W2 + size_t(n) * K2;
      for (int k = 0; k < K2; ++k) {
        const float wk = __ldg(w2 + k);
        a0 = fmaf(A2[lane * lda2 + k], wk, a0);
        a1 = fmaf(A2[(lane + 32) * lda2 + k], wk, a1);
      }
    }
    a0 += bias[n];
    a1 += bias[n];
    if (relu) {
      a0 = fmaxf(a0, 0.f);
      a1 = fmaxf(a1, 0.f);
    }
    out[lane * ldo + n] = a0;
    out[(lane + 32) * ldo + n] = a1;
  }
}

// The f32 forward of one tile of TP32 points p0 .. p0+TP32-1 (K1, K2 and
// K5 in f32): posenc and the MLP, with raw of the points p < n_pts going to
// sink(p, c, v). smem holds F32Smem<W>::bytes.
template <typename In, int W, typename Sink>
__device__ void fwd_tile_f32(const In& in, int n_pts, int Fp, int Fv, const float* __restrict__ wb,
                             const float* __restrict__ bb, int p0, unsigned char* smem,
                             const Sink& sink) {
  using L = F32Smem<W>;
  using O = Layout<W>;
  float* A = reinterpret_cast<float*>(smem + L::a);
  float* B = reinterpret_cast<float*>(smem + L::b);
  float* emb = reinterpret_cast<float*>(smem + L::emb);
  float* embv = reinterpret_cast<float*>(smem + L::embv);
  float* part = reinterpret_cast<float*>(smem + L::part);
  constexpr int lda = L::lda;

  embed_tile<float>(in, n_pts, Fp, Fv, p0, TP32, emb, L::lde, embv, L::ldv);
  __syncthreads();
  dense_f32(emb, L::lde, KE, wb + O::w05, nullptr, 0, 0, nullptr, bb, W, A, lda, true);
  __syncthreads();
  float* src = A;
  float* dst = B;
  for (int i = 1; i < 8; ++i) {
    const bool skip = i == 5;
    dense_f32(src, lda, W, wb + O::wi(i), skip ? emb : nullptr, L::lde, skip ? KE : 0,
              wb + O::w05 + size_t(W) * KE, bb + i * W, W, dst, lda, true);
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  // src = h7
  head_part<float, W>(src, lda, wb + O::wout, part, TP32);
  dense_f32(src, lda, W, wb + O::wf, nullptr, 0, 0, nullptr, bb + O::bf, W, dst, lda, false);
  __syncthreads();
  // dst = feat; the view layer writes hv over h7
  dense_f32(dst, lda, W, wb + O::wvf, embv, L::ldv, KV, wb + O::wve, bb + O::bv, W / 2, src,
            lda, true);
  __syncthreads();
  head<float, W>(src, lda, wb + O::wout, part, bb + O::bout, n_pts, p0, TP32, sink);
}

}  // namespace
