// Building blocks shared by the fused NeRF MLP kernels (fused_mlp_fwd.cu:
// K1 and K2, fused_mlp_bwd.cu: K4 and K3, fused_render.cu: K5): the two
// input modes, the weight-blob layout, the posenc embedding and its
// backward, the bf16 mma.sync layer with its cp.async weight ring, the f32
// FMA layer, and the forward's tile bodies, which hand raw to a
// caller-given sink. The f32 forwards run fwd_tile_f32; in bf16 K1, K2, K5
// and the backward's recompute run fwd_tile_sm90.cuh's wgmma tile, which
// sums each layer's products in the same K order as fwd_tile_bf16 here (on
// an H100 the two tiles' bf16 raw differed only in the head's last f32
// bits: PERF.md), and the backward's cotangent chain runs on that tile's
// ring and wgmma too. The mma.sync code here (mma_layer, epilogue,
// fwd_tile_bf16) serves K7's probes (probe_overlap.cu) alone: no
// production kernel runs it.

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

// One embedding row in kernel order [x | sin(x*2^f) f-major | cos], zero-padded
// to K entries.
template <typename T>
__device__ void embed_row(const float (&x)[3], int F, int K, T* row) {
#pragma unroll
  for (int d = 0; d < 3; ++d) row[d] = from_f<T>(x[d]);
  for (int f = 0; f < F; ++f) {
    const float scale = float(1 << f);  // exact power of two
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s, c;
      // sincosf keeps its range reduction: the phases reach |x*2^9| ~ 3100,
      // where __sinf/__cosf are wrong. Built without --use_fast_math.
      sincosf(__fmul_rn(x[d], scale), &s, &c);
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

constexpr int TP = 128;  // points per CTA
template <int W> struct Bf16Smem {
  static constexpr int lda = W + 8;  // +8 bf16: conflict-free fragment loads
  static constexpr int lde = KE + 8;
  static constexpr int ldv = KV + 8;
  static constexpr int ldw = KC + 8;
  static constexpr size_t act = 0;
  static constexpr size_t emb = act + size_t(TP) * lda * 2;
  static constexpr size_t embv = emb + size_t(TP) * lde * 2;
  static constexpr size_t wbuf = embv + size_t(TP) * ldv * 2;
  static constexpr size_t part = wbuf + size_t(2) * W * ldw * 2;
  static constexpr size_t bytes = part + size_t(TP) * 4 * 4;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gsrc) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One K segment of a layer: activations A [TP][lda] in shared memory times
// weights Wg^T [N][K] in global memory.
struct Seg {
  const bf16* A;
  int lda;
  const bf16* Wg;
  int K;
};

// Chunk c (KC wide; the last of s2 may be narrower) of a layer's K range
// A1 W1 + A2 W2: its segment and first k.
__device__ __forceinline__ void layer_chunk(const Seg& s1, const Seg& s2, int c, Seg& s, int& k0,
                                            int& width) {
  const int c1 = s1.K / KC;
  if (c < c1) {
    s = s1;
    k0 = c * KC;
    width = KC;
  } else {
    s = s2;
    k0 = (c - c1) * KC;
    width = min(KC, s2.K - k0);
  }
}
__device__ __forceinline__ int layer_chunks(const Seg& s1, const Seg& s2) {
  return s1.K / KC + (s2.K + KC - 1) / KC;
}

// cp.async of a chunk's N weight rows (k0 .. k0+width of Wg^T) into dst
// (stride ldw), by all THREADS threads, as one commit group.
template <int W, int N>
__device__ __forceinline__ void load_chunk(const Seg& s, int k0, int width, bf16* dst) {
  using L = Bf16Smem<W>;
  const int pieces = width / 8;  // 16-byte pieces per weight row
  for (int idx = threadIdx.x; idx < N * pieces; idx += THREADS) {
    const int n = idx / pieces, j = idx - n * pieces;
    cp_async16(dst + n * L::ldw + j * 8, s.Wg + size_t(n) * s.K + k0 + j * 8);
  }
  cp_async_commit();
}

// acc += one chunk's products: rows wm*64 .. +64 of s.A (k0 .. k0+width)
// times the chunk's weights wsm in shared memory. Warps are laid out 2
// (rows, 64 each: wm = warp / 4) x 4 (columns, NT*8 each).
template <int W, int NT>
__device__ __forceinline__ void mma_chunk(const Seg& s, int k0, int width, const bf16* wsm,
                                          float (&acc)[4][NT][4]) {
  using L = Bf16Smem<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < width; kk += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const bf16* ap = s.A + (wm * 64 + mt * 16 + g) * s.lda + k0 + kk + 2 * t;
      a[mt][0] = ld32(ap);
      a[mt][1] = ld32(ap + 8 * s.lda);
      a[mt][2] = ld32(ap + 8);
      a[mt][3] = ld32(ap + 8 * s.lda + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bp = wsm + (wn * NT * 8 + nt * 8 + g) * L::ldw + kk + 2 * t;
      const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma16816(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[4][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
}

// acc += the products of chunks 0 .. nchunks-1, chunk(c, s, k0, width)
// naming each, through a double-buffered cp.async weight ring. Ends with a
// barrier, so the caller may overwrite the A operands in place afterwards.
template <int W, int NT, typename Chunk>
__device__ void mma_chunks(int nchunks, const Chunk& chunk, bf16* wbuf, float (&acc)[4][NT][4]) {
  using L = Bf16Smem<W>;
  constexpr int N = NT * 32;
  auto load = [&](int c) {
    Seg s;
    int k0, width;
    chunk(c, s, k0, width);
    load_chunk<W, N>(s, k0, width, wbuf + (c & 1) * W * L::ldw);
  };
  load(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Seg s;
    int k0, width;
    chunk(c, s, k0, width);
    mma_chunk<W, NT>(s, k0, width, wbuf + (c & 1) * W * L::ldw, acc);
    __syncthreads();
  }
}

// acc[TP x N] = A1 W1 + A2 W2 (f32 accumulators in registers), N = 32*NT,
// the warps laid out as in mma_chunk. Ends with a barrier. K7's probes
// only (ROADMAP B.7): every production bf16 kernel runs wgmma.
template <int W, int NT>
__device__ void mma_layer(Seg s1, Seg s2, bf16* wbuf, float (&acc)[4][NT][4]) {
  zero_acc(acc);
  mma_chunks<W, NT>(
      layer_chunks(s1, s2),
      [&](int c, Seg& s, int& k0, int& width) { layer_chunk(s1, s2, c, s, k0, width); }, wbuf,
      acc);
}

// out[TP x N] = act(acc + bias), rounded to bf16 (kBias = false: no bias).
// Each warp writes only its own rows and columns of out.
template <int NT, bool kBias = true>
__device__ void epilogue(float (&acc)[4][NT][4], const float* __restrict__ bias, bf16* out,
                         int ldo, bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = wm * 64 + mt * 16 + g;
      const int col = wn * NT * 8 + nt * 8 + 2 * t;
      float v[4] = {acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2], acc[mt][nt][3]};
      if (kBias) {
        const float b0 = bias[col], b1 = bias[col + 1];
        v[0] += b0;
        v[1] += b1;
        v[2] += b0;
        v[3] += b1;
      }
      if (relu)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q], 0.f);
      *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
}

// The forward of one tile of TP points p0 .. p0+TP-1 (K7's `full` probe
// runs this body): posenc and the MLP, with raw of the points p < n_pts going
// to sink(p, c, v). smem holds Bf16Smem<W>::bytes. A CTA may run it again
// on another tile right away: the next tile's first write to a buffer
// comes after a barrier that every read of this tile precedes.
template <typename In, int W, typename Sink>
__device__ void fwd_tile_bf16(const In& in, int n_pts, int Fp, int Fv, const bf16* __restrict__ wb,
                              const float* __restrict__ bb, int p0, unsigned char* smem,
                              const Sink& sink) {
  using L = Bf16Smem<W>;
  using O = Layout<W>;
  bf16* act = reinterpret_cast<bf16*>(smem + L::act);
  bf16* emb = reinterpret_cast<bf16*>(smem + L::emb);
  bf16* embv = reinterpret_cast<bf16*>(smem + L::embv);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + L::wbuf);
  float* part = reinterpret_cast<float*>(smem + L::part);

  embed_tile<bf16>(in, n_pts, Fp, Fv, p0, TP, emb, L::lde, embv, L::ldv);
  // (mma_layer's first barrier orders these writes before any read)
  const Seg none = {nullptr, 0, nullptr, 0};
  {  // layer 0: rows [0, W) of W05e^T
    float acc[4][W / 32][4];
    mma_layer<W, W / 32>({emb, L::lde, wb + O::w05, KE}, none, wbuf, acc);
    epilogue<W / 32>(acc, bb, act, L::lda, true);
  }
  for (int i = 1; i < 8; ++i) {  // trunk; layer 5 adds e W5e (rows [W, 2W))
    float acc[4][W / 32][4];
    const Seg skip = i == 5 ? Seg{emb, L::lde, wb + O::w05 + size_t(W) * KE, KE} : none;
    mma_layer<W, W / 32>({act, L::lda, wb + O::wi(i), W}, skip, wbuf, acc);
    epilogue<W / 32>(acc, bb + i * W, act, L::lda, true);
  }
  __syncthreads();
  head_part<bf16, W>(act, L::lda, wb + O::wout, part, TP);
  {  // feature (no activation)
    float acc[4][W / 32][4];
    mma_layer<W, W / 32>({act, L::lda, wb + O::wf, W}, none, wbuf, acc);
    epilogue<W / 32>(acc, bb + O::bf, act, L::lda, false);
  }
  {  // view layer: [feat | ev] -> W/2, into columns [0, W/2) of act
    float acc[4][W / 64][4];
    mma_layer<W, W / 64>({act, L::lda, wb + O::wvf, W}, {embv, L::ldv, wb + O::wve, KV}, wbuf,
                         acc);
    epilogue<W / 64>(acc, bb + O::bv, act, L::lda, true);
  }
  __syncthreads();
  head<bf16, W>(act, L::lda, wb + O::wout, part, bb + O::bout, n_pts, p0, TP, sink);
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

// fwd_tile_bf16's f32 counterpart: TP32 points, smem of F32Smem<W>::bytes.
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
