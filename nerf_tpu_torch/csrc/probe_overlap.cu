// K7: probes of K1's forward tile for Hopper (sm_90a), asking what
// serializes against the tensor cores. Replaces tools/probe_overlap.py's
// Pallas probes (``build`` :75, call :79: k_matmul_only, k_bias_relu,
// k_interleaved; ``bench_k`` :172, call :181: k_embed_trunk,
// k_embed_trunk_interleaved, mk_embed_trunk(embed_notrig / embed_poly),
// k_full), plus one body of the port's own. Nine bodies over points p,
// out [N][256] f32:
//
//   matmul_only   h <- bf16(h W_i), i = 0..7, from x [N][256] bf16 (no bias
//                 read, no relu)
//   bias_relu     h <- bf16(relu(h W_i + b_i))
//   interleaved   bias_relu with the CTA's two 64-point halves a weight
//                 chunk apart, so that each half's epilogue runs beside the
//                 other half's products (trunk_interleaved)
//   embed_trunk   e = [x | sin(x 2^f) f-major | cos] (x [N][3] f32, 10
//                 octaves, bf16), h0 = bf16(relu(e W0e + b0)), then layers
//                 1..7 with e W5e added at layer 5
//   embed_trunk_il  embed_trunk with interleaved's schedule
//   embed_notrig  embed_trunk with x 2^f * 0.5 and * 0.25 in place of sin, cos
//   embed_poly    embed_trunk with the script's shared range reduction and
//                 minimax polynomials (rintf rounds half to even, as
//                 jnp.round does; multiplies and adds kept apart)
//   full          K1's whole tile: embed_trunk, feature (Ws[0], no bias),
//                 view layer with a view embedding per ray of spr points,
//                 rgb+sigma head; out[:, 4:] = 0
//   products      matmul_only's 8 products, each of x, summed in the
//                 accumulators: out = bf16(sum_i x W_i). The same weight
//                 ring and barriers with no epilogue between layers, to
//                 time the product stream alone (the script has no such
//                 body)
//
// The script's embedding order [x | sin(3f+d) | cos(3f+d)] is K1's kernel
// order, so W0e / W5e go into K1's blob unpermuted. Every body is built from
// the mma.sync tile code (fused_mlp_common.cuh) that K1, K5 and the
// backward's recompute and chain ran until their wgmma tile
// (fwd_tile_sm90.cuh), and that no production kernel runs now: the
// cp.async weight ring and mma_layer / mma_chunk, epilogue,
// embed_row with sincosf's range reduction, and for `full` fwd_tile_bf16
// itself, so what a probe times is that tile, not today's K1. A CTA
// holds K1's 128 points (the TPU's 1,536-point tile was a VMEM blocking
// choice), 172 KB of shared memory, 207 KB for the interleaved bodies.
//
// Bound: the trunk bodies are 2*8*256^2 FLOP a point on the tensor cores
// (8.25e11 at 786,432 points, 0.834 ms at 989 TFLOP/s) against 1.21 GB
// moved (0.361 ms), so operation-bound; the embedding bodies read 12 B a
// point and are more so. Bias, relu and trig run on other units and could
// overlap the products, so they add nothing to the least time: what they
// add to a probe's time is the serialization it measures.

#include "fused_mlp_common.cuh"

namespace {

constexpr int PW = 256;  // the probes' width (the script's W)
constexpr int PF = 10;   // point octaves
constexpr int VF = 4;    // view octaves
constexpr int DEPTH = 8;

enum Body : int {
  kMatmulOnly = 0,
  kBiasRelu,
  kInterleaved,
  kEmbedTrunk,
  kEmbedTrunkIL,
  kEmbedNotrig,
  kEmbedPoly,
  kFull,
  kProducts,
};

struct Probe {
  const bf16* x;    // [n][PW]: the x-in bodies' activations
  const float* x3;  // [n][3]: the embedding bodies' points
  const float* v3;  // [n / spr][3]: full's view directions
  const bf16* wt;   // [8][PW][PW]: W_i^T of the x-in bodies
  const float* b;   // [8][PW]
  const bf16* wb;   // K1's weight blob (Layout<PW>) of the embedding bodies
  const float* bb;  // K1's bias blob
  float* out;       // [n][PW]
  int n_pts;
  int spr;
};

using L = Bf16Smem<PW>;
using O = Layout<PW>;
// The interleave's ring: three chunk stages of PW weight rows in place of
// K1's two (they run on over `part`, which the trunk bodies do not use).
constexpr size_t kStage = size_t(PW) * L::ldw;  // bf16 elements
constexpr size_t kInterleavedBytes = L::wbuf + 3 * kStage * sizeof(bf16);
static_assert(kInterleavedBytes <= 227 * 1024, "the interleave's shared memory");

// The 8 layers of the x-in bodies: h <- h W_i (+ b_i), in place in act.
struct XLayers {
  const bf16* wt;
  const float* b;
  bf16* act;
  __device__ Seg s1(int i) const { return {act, L::lda, wt + size_t(i) * PW * PW, PW}; }
  __device__ Seg s2(int) const { return Seg{nullptr, 0, nullptr, 0}; }
  __device__ const float* bias(int i) const { return b + i * PW; }
};

// The 8 trunk layers of the embedding bodies: layer 0 reads e (rows [0, W)
// of W05e^T), layer 5 adds e W5e (rows [W, 2W)).
struct EmbedLayers {
  const bf16* wb;
  const float* bb;
  bf16* act;
  bf16* emb;
  __device__ Seg s1(int i) const {
    return i == 0 ? Seg{emb, L::lde, wb + O::w05, KE} : Seg{act, L::lda, wb + O::wi(i), PW};
  }
  __device__ Seg s2(int i) const {
    return i == 5 ? Seg{emb, L::lde, wb + O::w05 + size_t(PW) * KE, KE}
                  : Seg{nullptr, 0, nullptr, 0};
  }
  __device__ const float* bias(int i) const { return bb + i * PW; }
};

// K1's schedule: every layer's products, then its epilogue, the whole CTA
// in step (kBiasRelu = false: matmul_only's bare bf16 rounding).
template <bool kBiasRelu, typename Layers>
__device__ void trunk(const Layers& ly, bf16* act, bf16* wbuf) {
  for (int i = 0; i < DEPTH; ++i) {
    float acc[4][PW / 32][4];
    mma_layer<PW, PW / 32>(ly.s1(i), ly.s2(i), wbuf, acc);
    epilogue<PW / 32, kBiasRelu>(acc, ly.bias(i), act, L::lda, kBiasRelu);
  }
}

// The half's own barrier (warps 0-3 or 4-7: 128 threads).
__device__ __forceinline__ void half_barrier(int half) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(half + 1) : "memory");
}

// Chunk t of the layers' chunk sequence: its layer, segment, first k and
// width; returns its index within the layer and sets n to the layer's count.
template <typename Layers>
__device__ int locate(const Layers& ly, int t, int& i, Seg& s, int& k0, int& width, int& n) {
  for (i = 0;; ++i) {
    n = layer_chunks(ly.s1(i), ly.s2(i));
    if (t < n) break;
    t -= n;
  }
  layer_chunk(ly.s1(i), ly.s2(i), t, s, k0, width);
  return t;
}

// bias_relu's layers with the CTA's two 64-point halves (mma_chunk's row
// split: warps 0-3 rows [0, 64), warps 4-7 rows [64, 128)) a chunk apart:
// at step t half A multiplies chunk t of the layers' chunk sequence and
// half B chunk t - 1. A half's epilogue comes right after its layer's last
// chunk, behind a barrier of its own (its warps' reads of its rows are
// done), while the other half is still in its products: it writes only its
// own rows, which the other half never reads. Three ring stages hold the
// two halves' chunks and the next in flight; a step has mma_chunks' two
// barriers a chunk, so the skew is the only change from K1's schedule.
template <typename Layers>
__device__ void trunk_interleaved(const Layers& ly, bf16* act, bf16* wbuf) {
  const int half = threadIdx.x >> 7;
  int total = 0;
  for (int i = 0; i < DEPTH; ++i) total += layer_chunks(ly.s1(i), ly.s2(i));
  Seg s;
  int i, k0, width, n;
  locate(ly, 0, i, s, k0, width, n);
  load_chunk<PW, PW>(s, k0, width, wbuf);
  float acc[4][PW / 32][4];
  for (int t = 0; t <= total; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // chunk t is in; chunk t - 2's stage is free
    if (t + 1 < total) {
      locate(ly, t + 1, i, s, k0, width, n);
      load_chunk<PW, PW>(s, k0, width, wbuf + ((t + 1) % 3) * kStage);
    }
    const int mine = t - half;
    if (mine >= 0 && mine < total) {
      const int c = locate(ly, mine, i, s, k0, width, n);
      if (c == 0) zero_acc(acc);
      mma_chunk<PW, PW / 32>(s, k0, width, wbuf + (mine % 3) * kStage, acc);
      if (c == n - 1) {
        half_barrier(half);
        epilogue<PW / 32>(acc, ly.bias(i), act, L::lda, true);
      }
    }
    __syncthreads();
  }
}

// The tile's rows of x into act (zeros past n_pts), 16 bytes a thread.
__device__ void load_x_tile(const Probe& a, int p0, bf16* act) {
  constexpr int pieces = PW / 8;
  for (int idx = threadIdx.x; idx < TP * pieces; idx += THREADS) {
    const int i = idx / pieces, j = idx - i * pieces;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + i < a.n_pts) v = *reinterpret_cast<const uint4*>(a.x + size_t(p0 + i) * PW + j * 8);
    *reinterpret_cast<uint4*>(act + i * L::lda + j * 8) = v;
  }
}

// out[p] = act rows as f32, after a barrier that follows the last write.
__device__ void store_tile(const Probe& a, int p0, const bf16* act) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TP * PW; idx += THREADS) {
    const int i = idx / PW, c = idx - i * PW;
    if (p0 + i < a.n_pts) a.out[size_t(p0 + i) * PW + c] = __bfloat162float(act[i * L::lda + c]);
  }
}

// The script's poly_sincos: shared range reduction, minimax polynomials of
// degree 9 (sin) and 8 (cos) in Horner form, no FMA contraction.
__device__ __forceinline__ void poly_sincos(float xb, float& s, float& c) {
  const float y = __fmul_rn(xb, 0.15915494309189535f);
  const float r = __fmul_rn(__fsub_rn(y, rintf(y)), 6.283185307179586f);
  const float r2 = __fmul_rn(r, r);
  float ps = __fadd_rn(-0.00019316277202555934f, __fmul_rn(r2, 2.1732608711915083e-06f));
  ps = __fadd_rn(0.008312388725549872f, __fmul_rn(r2, ps));
  ps = __fadd_rn(-0.16663259474612063f, __fmul_rn(r2, ps));
  ps = __fadd_rn(0.9999845940079196f, __fmul_rn(r2, ps));
  s = __fmul_rn(r, ps);
  float pc = __fadd_rn(2.4253237753182864e-05f, __fmul_rn(r2, -2.2194166856720897e-07f));
  pc = __fadd_rn(-0.0013862750536381093f, __fmul_rn(r2, pc));
  pc = __fadd_rn(0.04166103368789301f, __fmul_rn(r2, pc));
  pc = __fadd_rn(-0.4999955824558693f, __fmul_rn(r2, pc));
  c = __fadd_rn(0.9999994437337446f, __fmul_rn(r2, pc));
}

// One point's embedding row (KE entries, kernel order) for a body.
template <int B>
__device__ void probe_embed_row(const float (&x)[3], bf16* row) {
  if constexpr (B == kEmbedNotrig || B == kEmbedPoly) {
#pragma unroll
    for (int d = 0; d < 3; ++d) row[d] = __float2bfloat16_rn(x[d]);
    for (int f = 0; f < PF; ++f) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float xb = __fmul_rn(x[d], float(1 << f));
        float s, c;
        if constexpr (B == kEmbedNotrig) {
          s = __fmul_rn(xb, 0.5f);
          c = __fmul_rn(xb, 0.25f);
        } else {
          poly_sincos(xb, s, c);
        }
        row[3 + f * 3 + d] = __float2bfloat16_rn(s);
        row[3 + 3 * PF + f * 3 + d] = __float2bfloat16_rn(c);
      }
    }
    for (int k = 3 + 6 * PF; k < KE; ++k) row[k] = __float2bfloat16_rn(0.f);
  } else {
    embed_row<bf16>(x, PF, KE, row);
  }
}

// matmul_only, bias_relu, interleaved: 8 layers on x's tile.
template <int B>
__device__ void x_tile(const Probe& a, int p0, unsigned char* smem) {
  bf16* act = reinterpret_cast<bf16*>(smem + L::act);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + L::wbuf);
  load_x_tile(a, p0, act);  // (the trunk's first barrier orders these writes)
  const XLayers ly{a.wt, a.b, act};
  if constexpr (B == kInterleaved)
    trunk_interleaved(ly, act, wbuf);
  else
    trunk<B == kBiasRelu>(ly, act, wbuf);
  store_tile(a, p0, act);
}

// products: x W_0 + ... + x W_7 through one run of the weight ring.
__device__ void products_tile(const Probe& a, int p0, unsigned char* smem) {
  bf16* act = reinterpret_cast<bf16*>(smem + L::act);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + L::wbuf);
  load_x_tile(a, p0, act);
  constexpr int per_layer = PW / KC;
  float acc[4][PW / 32][4];
  zero_acc(acc);
  mma_chunks<PW, PW / 32>(
      DEPTH * per_layer,
      [&](int c, Seg& s, int& k0, int& width) {
        s = Seg{act, L::lda, a.wt + size_t(c / per_layer) * PW * PW, PW};
        k0 = (c % per_layer) * KC;
        width = KC;
      },
      wbuf, acc);
  epilogue<PW / 32, false>(acc, nullptr, act, L::lda, false);
  store_tile(a, p0, act);
}

// embed_trunk, embed_trunk_il, embed_notrig, embed_poly.
template <int B>
__device__ void embed_trunk_tile(const Probe& a, int p0, unsigned char* smem) {
  bf16* act = reinterpret_cast<bf16*>(smem + L::act);
  bf16* emb = reinterpret_cast<bf16*>(smem + L::emb);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + L::wbuf);
  for (int i = threadIdx.x; i < TP; i += THREADS) {
    float x[3] = {0.f, 0.f, 0.f};
    if (p0 + i < a.n_pts)
#pragma unroll
      for (int d = 0; d < 3; ++d) x[d] = a.x3[size_t(p0 + i) * 3 + d];
    probe_embed_row<B>(x, emb + i * L::lde);
  }
  const EmbedLayers ly{a.wb, a.bb, act, emb};
  if constexpr (B == kEmbedTrunkIL)
    trunk_interleaved(ly, act, wbuf);
  else
    trunk<true>(ly, act, wbuf);
  store_tile(a, p0, act);
}

// full writes raw (r, g, b, sigma) to channels 0..3 of a row.
struct RowSink {
  float* out;
  __device__ void operator()(int p, int c, float v) const { out[size_t(p) * PW + c] = v; }
};

__device__ void full_tile(const Probe& a, int p0, unsigned char* smem) {
  for (int idx = threadIdx.x; idx < TP * (PW - 4); idx += THREADS) {
    const int i = idx / (PW - 4), c = 4 + idx - i * (PW - 4);
    if (p0 + i < a.n_pts) a.out[size_t(p0 + i) * PW + c] = 0.f;
  }
  fwd_tile_bf16<PointsIn, PW>(PointsIn{a.x3, a.v3, a.spr}, a.n_pts, PF, VF, a.wb, a.bb, p0, smem,
                              RowSink{a.out});
}

template <int B>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(const Probe a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = blockIdx.x * TP;
  if constexpr (B == kMatmulOnly || B == kBiasRelu || B == kInterleaved)
    x_tile<B>(a, p0, smem);
  else if constexpr (B == kProducts)
    products_tile(a, p0, smem);
  else if constexpr (B == kFull)
    full_tile(a, p0, smem);
  else
    embed_trunk_tile<B>(a, p0, smem);
}

template <int B>
cudaError_t launch(const Probe& a, cudaStream_t stream) {
  const size_t smem = (B == kInterleaved || B == kEmbedTrunkIL) ? kInterleavedBytes : L::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(probe_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  probe_kernel<B><<<(a.n_pts + TP - 1) / TP, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success); launches on `stream` without
// synchronising. body: 0 matmul_only .. 8 products (the order above). All
// pointers are device memory; the bodies read only their own inputs (x, wt,
// b for 0-2 and 8; x3, wblob, bblob for 3-6; x3, v3, wblob, bblob for 7).
extern "C" int nerf_probe_overlap(int body, int n_pts, int spr, const void* x, const float* x3,
                                  const float* v3, const void* wt, const float* b,
                                  const void* wblob, const float* bblob, float* out,
                                  void* stream) {
  if (n_pts < 0 || spr < 1 || n_pts % spr != 0) return cudaErrorInvalidValue;
  if (n_pts == 0) return cudaSuccess;
  const Probe a{static_cast<const bf16*>(x), x3, v3, static_cast<const bf16*>(wt), b,
                static_cast<const bf16*>(wblob), bblob, out, n_pts, spr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kMatmulOnly: return launch<kMatmulOnly>(a, s);
    case kBiasRelu: return launch<kBiasRelu>(a, s);
    case kInterleaved: return launch<kInterleaved>(a, s);
    case kEmbedTrunk: return launch<kEmbedTrunk>(a, s);
    case kEmbedTrunkIL: return launch<kEmbedTrunkIL>(a, s);
    case kEmbedNotrig: return launch<kEmbedNotrig>(a, s);
    case kEmbedPoly: return launch<kEmbedPoly>(a, s);
    case kFull: return launch<kFull>(a, s);
    case kProducts: return launch<kProducts>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
