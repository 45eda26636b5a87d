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
//   interleaved   bias_relu on the ping-pong schedule (below)
//   embed_trunk   e = [x | sin(x 2^f) f-major | cos] (x [N][3] f32, 10
//                 octaves, bf16), h0 = bf16(relu(e W0e + b0)), then layers
//                 1..7 with e W5e added at layer 5
//   embed_trunk_il  embed_trunk on the ping-pong schedule
//   embed_notrig  embed_trunk with x 2^f * 0.5 and * 0.25 in place of sin, cos
//   embed_poly    embed_trunk with the script's shared range reduction and
//                 minimax polynomials (rintf rounds half to even, as
//                 jnp.round does; multiplies and adds kept apart)
//   full          K1's whole tile: embed_trunk, feature (Ws[0], no bias),
//                 view layer with a view embedding per ray of spr points,
//                 rgb+sigma head; out[:, 4:] = 0
//   products      matmul_only's 8 products, each of x, summed in the
//                 accumulators: out = bf16(sum_i x W_i), one epilogue at
//                 the end, to time the product stream alone (the script has
//                 no such body)
//
// The script's embedding order [x | sin(3f+d) | cos(3f+d)] is K1's kernel
// order, so W0e / W5e go into K1's blob unpermuted. Every body is a launch
// of K1's tile (fwd_tile_sm90.cuh) or of a CTA built from its pieces, so
// what a probe times is the tile K1, K2, K5 and the backward's recompute
// run: 384 threads on a persistent grid of min(tiles, SMs) CTAs, a
// producer thread streaming weight chunks (64 K columns x 256 rows, 128-byte
// swizzled) by TMA into FwdSmem's four-stage ring, and two consumer
// warpgroups of 64 points each running wgmma m64n256k16 on their swizzled
// act blocks (consume_chunk, finish_layer, epilogue_sw):
//  - `full` is fwd_tiles_sm90 itself with K2's input (PointsIn) and a sink
//    that writes channels 0..3 of a row; the producer warpgroup's idle warps
//    write the zeros of channels 4.. (ZeroHook). Its channels 0..3 equal
//    K2's raw on the same blob bit for bit (chip_smoke.py phase 18);
//  - the x-in bodies (matmul_only, bias_relu, interleaved, products) load
//    their warpgroup's 64 rows of x into act by TMA (a 64 x 64 box with the
//    128-byte swizzle is one act block; a tile's next rows are loaded as
//    soon as its last products retired), stream W_i^T through the ring and
//    write out as f32 rows from the last accumulators;
//  - the embedding bodies run the tile's embedding (embed_sw) with the trig
//    swapped, layers 0..7 as K1 does, and write h7 rows from the last
//    accumulators;
//  - schedules: the interleaved bodies run the production ping-pong (the
//    warpgroups take turns issuing a layer's products, so one's epilogue
//    runs under the other's products: take_turn / pass_turn); bias_relu,
//    matmul_only and the other embedding bodies run the same warpgroups in
//    lockstep (both issue a layer's products behind one barrier, then both
//    run their epilogues), so bias_relu / interleaved and embed_trunk /
//    embed_trunk_il measure what ping-pong buys; products takes no turns.
// Shared memory: FwdSmem<256>'s 225 KB and two mbarriers for the x rows.
//
// Bound: the trunk bodies are 2*8*256^2 FLOP a point on the tensor cores
// (8.25e11 at 786,432 points, 0.834 ms at 989 TFLOP/s) against 1.21 GB
// moved (0.361 ms), so operation-bound; the embedding bodies read 12 B a
// point and are more so. Bias, relu and trig run on other units and could
// overlap the products, so they add nothing to the least time: what they
// add to a probe's time is the serialization it measures.

#include "fused_mlp_common.cuh"
#include "fwd_tile_sm90.cuh"

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

__host__ __device__ constexpr bool x_in(int b) {
  return b == kMatmulOnly || b == kBiasRelu || b == kInterleaved || b == kProducts;
}
__host__ __device__ constexpr bool ping_pong(int b) { return b == kInterleaved || b == kEmbedTrunkIL; }

struct Probe {
  const float* x3;  // [n][3]: the embedding bodies' points
  const float* v3;  // [n / spr][3]: full's view directions
  const float* b;   // [8][PW]: the x-in bodies' biases
  const bf16* wb;   // K1's weight blob (Layout<PW>) of the embedding bodies
  const float* bb;  // K1's bias blob
  float* out;       // [n][PW]
  int n_pts;
  int spr;
};

// The bodies' tensor maps: K1's four over the blob (the embedding bodies and
// full); the x-in bodies' W_i^T, [8 PW][PW] in boxes of PW rows, and x,
// [n][PW] in boxes of FWD_ROWS rows (one act block).
struct ProbeMaps {
  FwdMaps fwd;
  CUtensorMap wt;
  CUtensorMap x;
};

using L = FwdSmem<PW>;
constexpr int NB = L::NB;
constexpr size_t XBARS = L::bytes;  // the two warpgroups' x mbarriers
constexpr size_t SMEM = L::launch_bytes + 2 * sizeof(uint64_t);
static_assert(SMEM <= 232448, "fits in an SM's shared memory");

// ------------------------------------------------------------------- trig

// embed_notrig: x 2^f * 0.5 and * 0.25
struct NoTrig {
  __device__ __forceinline__ void operator()(float xb, float& s, float& c) const {
    s = __fmul_rn(xb, 0.5f);
    c = __fmul_rn(xb, 0.25f);
  }
};

// embed_poly: the script's poly_sincos, shared range reduction, minimax
// polynomials of degree 9 (sin) and 8 (cos) in Horner form, no FMA
// contraction.
struct PolyTrig {
  __device__ __forceinline__ void operator()(float xb, float& s, float& c) const {
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
};

template <int B>
struct TrigOf {
  using type = SinCos;
};
template <>
struct TrigOf<kEmbedNotrig> {
  using type = NoTrig;
};
template <>
struct TrigOf<kEmbedPoly> {
  using type = PolyTrig;
};

// ------------------------------------------------------------------- full

// full's sink: raw (r, g, b, sigma) to channels 0..3 of a row.
struct RowSink {
  float* out;
  __device__ void operator()(int p, int c, float v) const { out[size_t(p) * PW + c] = v; }
};

// full's hook: the producer warpgroup's warps 1-3 write the zeros of
// channels 4.. of the CTA's tiles' rows (TileWalk's order), 16 bytes a
// store, beside the consumers' MLP.
struct ZeroHook : NoHook {
  float* out;
  int n_pts;
  __device__ __forceinline__ void side() const {
    constexpr int PIECES = (PW - 4) / 4;  // float4s of a row's channels 4..
    const int ntiles = (n_pts + TP - 1) / TP;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      for (int idx = threadIdx.x - 32; idx < TP * PIECES; idx += 96) {
        const int i = idx / PIECES, j = idx - i * PIECES;
        const int p = tile * TP + i;
        if (p < n_pts)
          *reinterpret_cast<float4*>(out + size_t(p) * PW + 4 + 4 * j) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
  }
};

// ------------------------------------------------------- the other bodies

// The producer thread: every tile's chunks, in the consumers' order. The
// x-in bodies: W_0^T .. W_7^T, NB chunks each. The embedding bodies: K1's
// trunk (fwd_producer's order up to layer 7: W0e, W1..W7, W5e after W5).
template <int B>
__device__ __forceinline__ void probe_producer(const ProbeMaps& maps, int ntiles,
                                               unsigned char* ring, uint64_t* full,
                                               uint64_t* empty) {
  uint32_t g = 0;
  auto load = [&](const CUtensorMap* map, int x, int y) {
    const uint32_t s = g % FWD_STAGES;
    if (g >= FWD_STAGES) hopper::mbar_wait(&empty[s], ((g / FWD_STAGES) - 1) & 1);
    hopper::mbar_arrive_expect_tx(&full[s], uint32_t(PW) * 128);
    hopper::tma_load_2d(ring + s * L::STAGE, map, &full[s], x, y);
    ++g;
  };
  const TileWalk walk;
  for (int tile = walk.first(); tile < ntiles; tile = walk.next(tile)) {
    if constexpr (x_in(B)) {
      for (int i = 0; i < DEPTH; ++i)
        for (int j = 0; j < NB; ++j) load(&maps.wt, KC * j, i * PW);
    } else {
      load(&maps.fwd.w05, 0, 0);
      for (int i = 1; i < DEPTH; ++i) {
        for (int j = 0; j < NB; ++j) load(&maps.fwd.trunk, KC * j, (i - 1) * PW);
        if (i == 5) load(&maps.fwd.w05, 0, PW);
      }
    }
  }
}

// The warpgroup's 64 rows of x for the tile into its act blocks, by TMA on
// xbar (one thread issues; rows past n come in as zeros).
__device__ __forceinline__ void load_x(const ProbeMaps& maps, int tile, int w, unsigned char* act,
                                       uint64_t* xbar) {
  if ((threadIdx.x & 127) != 0) return;
  hopper::mbar_arrive_expect_tx(xbar, uint32_t(NB * L::BLOCK));
  for (int j = 0; j < NB; ++j)
    hopper::tma_load_2d(act + j * L::BLOCK, &maps.x, xbar, KC * j, tile * TP + w * FWD_ROWS);
}

// out rows p0 .. p0+63 (p < n_pts) = bf16(act(acc + bias)) as f32, from the
// m64n256 accumulator fragment: row 16*warp + lane/4 (+8), columns
// 8*jb + 2*(lane%4) (+1), 8 bytes a store.
template <bool kBias, bool kRelu>
__device__ __forceinline__ void store_out(const float (&acc)[PW / 2],
                                          const float* __restrict__ bias, float* out, int p0,
                                          int n_pts) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int jb = 0; jb < PW / 8; ++jb) {
    const int col = 8 * jb + 2 * (lane & 3);
    float2 b = make_float2(0.f, 0.f);
    if constexpr (kBias) b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * jb + 2 * h], v1 = acc[4 * jb + 2 * h + 1];
      if constexpr (kBias) {
        v0 += b.x;
        v1 += b.y;
      }
      if constexpr (kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const int p = p0 + 16 * warp + (lane >> 2) + 8 * h;
      if (p < n_pts)
        *reinterpret_cast<float2*>(out + size_t(p) * PW + col) =
            __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
    }
  }
}

// The schedules' gate before a layer's products and after they are
// issued: ping-pong takes and passes the turn; lockstep syncs both
// warpgroups (named barrier 3, 256 threads) and passes nothing.
template <int B>
__device__ __forceinline__ void issue_begin(int w) {
  if constexpr (ping_pong(B))
    take_turn(w);
  else
    hopper::bar_sync(3, 256);
}
template <int B>
__device__ __forceinline__ void issue_end(int w) {
  if constexpr (ping_pong(B)) pass_turn(w);
}

// One consumer warpgroup (w = 0 or 1) of the x-in and embedding bodies
// over the CTA's tiles: its 64 points of each, p0 on. A layer is
// fwd_consumer's: the products in the schedule's gate, finish_layer, then
// the epilogue in place, except the last layer's, which writes out.
template <int B>
__device__ __forceinline__ void probe_consumer(const Probe& a, const ProbeMaps& maps, int ntiles,
                                               unsigned char* smem, uint64_t* full,
                                               uint64_t* empty, int w) {
  constexpr bool kBias = B != kMatmulOnly && B != kProducts;
  unsigned char* act = smem + L::act + w * NB * L::BLOCK;
  unsigned char* emb = smem + L::emb + w * L::BLOCK;
  unsigned char* embv = smem + L::embv + w * L::BLOCK;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + XBARS) + w;
  const int bar = 1 + w;
  const TileWalk walk;
  FwdRing r{smem + L::ring, L::STAGE, full, empty, 0};
  float part[2][4] = {};  // unused: no head
  if (ping_pong(B) && w == 1) pass_turn(w);  // warpgroup 0 goes first
  if (x_in(B) && walk.first() < ntiles) load_x(maps, walk.first(), w, act, xbar);
  uint32_t k = 0;  // the CTA's tiles so far
  for (int tile = walk.first(); tile < ntiles; tile = walk.next(tile), ++k) {
    const int p0 = tile * TP + w * FWD_ROWS;
    const int next = walk.next(tile);
    if constexpr (B == kProducts) {  // x W_0 + ... + x W_7, one epilogue
      hopper::mbar_wait(xbar, k & 1);
      float acc[PW / 2];
      zero_regs(acc);
#pragma unroll 1
      for (int i = 0; i < DEPTH; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          consume_chunk<PW>(r, acc, act + j * L::BLOCK, i == 0 && j == 0);
      finish_layer(r, bar);
      if (next < ntiles) load_x(maps, next, w, act, xbar);  // act is free
      store_out<false, false>(acc, nullptr, a.out, p0, a.n_pts);
    } else {
      if constexpr (x_in(B)) {
        hopper::mbar_wait(xbar, k & 1);
      } else {  // the embedding, its views zeros (Fv = 0: no view layer)
        embed_sw<PointsIn, typename TrigOf<B>::type>(PointsIn{a.x3, a.v3, a.spr}, a.n_pts, PF,
                                                     0, p0, act, emb, embv);
        hopper::fence_proxy_async();
        hopper::bar_sync(bar, 128);
      }
#pragma unroll 1
      for (int i = 0; i < DEPTH; ++i) {
        const float* bias = kBias ? (x_in(B) ? a.b : a.bb) + i * PW : nullptr;
        if (i > 0) {
          hopper::fence_proxy_async();
          hopper::bar_sync(bar, 128);
        }
        float acc[PW / 2];
        zero_regs(acc);
        issue_begin<B>(w);
        if (!x_in(B) && i == 0) {
          consume_chunk<PW>(r, acc, emb, true);  // e W0e
        } else {
#pragma unroll
          for (int j = 0; j < NB; ++j) consume_chunk<PW>(r, acc, act + j * L::BLOCK, j == 0);
        }
        issue_end<B>(w);  // before the skip chunk: see take_turn
        if (!x_in(B) && i == 5) consume_chunk<PW>(r, acc, emb, false);  // + e W5e
        finish_layer(r, bar);
        if (i + 1 < DEPTH) {
          epilogue_sw<PW, kBias, false, kBias>(acc, bias, act, nullptr, part);
        } else {
          if (x_in(B) && next < ntiles) load_x(maps, next, w, act, xbar);  // act is free
          store_out<kBias, kBias>(acc, bias, a.out, p0, a.n_pts);
        }
      }
    }
  }
  if (ping_pong(B) && w == 0) take_turn(w);  // warpgroup 1's last pass_turn
}

template <int B>
__global__ void __launch_bounds__(FWD_THREADS, 1)
probe_sm90(const __grid_constant__ ProbeMaps maps, const __grid_constant__ Probe a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (B == kFull) {
    fwd_tiles_sm90<PointsIn, PW>(maps.fwd, PointsIn{a.x3, a.v3, a.spr}, a.n_pts, PF, VF, a.wb,
                                 a.bb, smem_raw, RowSink{a.out}, TileWalk(),
                                 ZeroHook{{}, a.out, a.n_pts});
  } else {
    unsigned char* smem = fwd_smem_base(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + FWD_STAGES;
    uint64_t* xbars = reinterpret_cast<uint64_t*>(smem + XBARS);
    const int ntiles = (a.n_pts + TP - 1) / TP;
    if (threadIdx.x == 0) {
      for (int s = 0; s < FWD_STAGES; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], 8);  // the consumers' 8 warps
      }
      for (int w = 0; w < 2; ++w) hopper::mbar_init(&xbars[w], 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
    const int wg = threadIdx.x >> 7;
    if (wg == 0) {
      hopper::setmaxnreg_dec<FWD_PRODUCER_REGS>();
      if (threadIdx.x == 0) probe_producer<B>(maps, ntiles, smem + L::ring, full, empty);
    } else {
      hopper::setmaxnreg_inc<FWD_CONSUMER_REGS>();
      probe_consumer<B>(a, maps, ntiles, smem, full, empty, wg - 1);
    }
  }
}

#define NERF_CHECK(x)                 \
  do {                                \
    cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// A body's launch: a persistent grid of min(tiles, SMs) CTAs of 384
// threads. setmaxnreg moves registers within the pool the CTA got at
// launch: a smaller pool than the two roles ask for would stall the
// consumers, so it is refused.
template <int B>
cudaError_t launch(const ProbeMaps& maps, const Probe& a, cudaStream_t stream) {
  const auto kernel = probe_sm90<B>;
  NERF_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM)));
  cudaFuncAttributes fa;
  NERF_CHECK(cudaFuncGetAttributes(&fa, kernel));
  if (fa.numRegs * FWD_THREADS < 128 * FWD_PRODUCER_REGS + 256 * FWD_CONSUMER_REGS)
    return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  NERF_CHECK(cudaGetDevice(&dev));
  NERF_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int tiles = (a.n_pts + TP - 1) / TP;
  kernel<<<tiles < sms ? tiles : sms, FWD_THREADS, SMEM, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success); launches on `stream` without
// synchronising. body: 0 matmul_only .. 8 products (the order above). All
// pointers are device memory, 16-byte aligned; the bodies read only their
// own inputs (x, wt, b for 0-2 and 8; x3, wblob, bblob for 3-6; x3, v3,
// wblob, bblob for 7).
extern "C" int nerf_probe_overlap(int body, int n_pts, int spr, const void* x, const float* x3,
                                  const float* v3, const void* wt, const float* b,
                                  const void* wblob, const float* bblob, float* out,
                                  void* stream) {
  if (n_pts < 0 || spr < 1 || n_pts % spr != 0 || body < 0 || body > kProducts)
    return cudaErrorInvalidValue;
  if (n_pts == 0) return cudaSuccess;
  const Probe a{x3, v3, b, static_cast<const bf16*>(wblob), bblob, out, n_pts, spr};
  ProbeMaps maps;
  if (x_in(body)) {
    NERF_CHECK(hopper::encode_rows_sw128(&maps.wt, wt, DEPTH * PW, PW, PW));
    NERF_CHECK(hopper::encode_rows_sw128(&maps.x, x, n_pts, PW, FWD_ROWS));
  } else {
    NERF_CHECK(encode_fwd_maps<PW>(&maps.fwd, a.wb));
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kMatmulOnly: return launch<kMatmulOnly>(maps, a, s);
    case kBiasRelu: return launch<kBiasRelu>(maps, a, s);
    case kInterleaved: return launch<kInterleaved>(maps, a, s);
    case kEmbedTrunk: return launch<kEmbedTrunk>(maps, a, s);
    case kEmbedTrunkIL: return launch<kEmbedTrunkIL>(maps, a, s);
    case kEmbedNotrig: return launch<kEmbedNotrig>(maps, a, s);
    case kEmbedPoly: return launch<kEmbedPoly>(maps, a, s);
    case kFull: return launch<kFull>(maps, a, s);
    default: return launch<kProducts>(maps, a, s);
  }
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
