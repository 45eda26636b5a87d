// The bf16 forward tile for Hopper (sm_90a): posenc and the 8xW MLP over
// tiles of 128 points, the weights streamed by TMA into a shared-memory ring
// that feeds wgmma. Its rounding points are K1's (operands rounded to bf16,
// f32 accumulation, activations rounded to bf16 between layers), in two
// input modes (RaysIn / PointsIn) with a caller-given sink (GlobalSink).
// Its layers sum a layer's products chunk by chunk in the K order of the
// warp-MMA tile that K1 ran before it; on an H100 their activations
// matched in every case measured, and the head's f32 sums, which run in
// another order, moved raw in its last bits only (PERF.md).
//
// One CTA of 384 threads (fwd_tiles_sm90 is the whole CTA's body) walks its
// tiles of a persistent grid in the order a schedule gives (a template
// parameter: TileWalk, K1's and K2's default, takes tiles blockIdx.x,
// + gridDim.x, ...; K5's GroupWalk in fused_render.cu takes groups of
// consecutive tiles; SceneWalk, the stacked K1's, K2's, K4's and K3's, a
// scene's tiles a row of the grid, each scene on its own weights, and the
// stacked K5's SceneGroupWalk, K5's groups within such a row); the
// producer and both consumers walk the same order.
// A hook (a template parameter too; NoHook, the default, compiles to
// nothing) is called by the consumers before each tile's head writes raw
// and after it, and runs on the producer warpgroup's three idle warps (K5
// composites its ray groups there); the backward's recompute
// (fused_mlp_bwd.cu) takes each layer's output from the consumers while
// the next layer's products run (after_embed, after_layer). The backward's
// cotangent chain (bwd_chain_sm90, fused_mlp_bwd.cu) is a CTA of the same
// shape with its own producer and consumers, built from this file's pieces
// (FwdSmem's ring and act blocks, FwdRing, consume_chunk, finish_layer,
// take_turn / pass_turn, st_shared_b32, wout_row), and so are K7's probes
// (probe_overlap.cu: its `full` body is this tile itself). This tile's
// roles:
// - warpgroup 0, the producer: one thread streams the weight chunks of
//   every tile, in the order the layers consume them, by TMA into a ring of
//   FWD_STAGES stages (a chunk is 64 K columns x N rows of a W^T block,
//   128-byte swizzled; N = W, or W/2 for the view layer), each behind a
//   `full` mbarrier that counts its bytes and an `empty` one that counts
//   the 8 consumer warps; it runs ahead into the next tile's chunks while
//   the consumers finish a tile. Its registers go to the consumers
//   (setmaxnreg 40 / 232).
// - warpgroups 1 and 2, the consumers: each owns 64 of the tile's points.
//   Its activations (act, 64 x W), point embedding (emb, 64 x 64) and view
//   embedding (embv, 64 x 64, columns 32.. zero) live in shared memory in
//   the K-major 128-byte-swizzled layout of hopper.cuh, in 8 KB blocks of
//   64 columns, and are wgmma's A operand; the ring stage is B. A layer is
//   wgmma m64nNk16 over its chunks with one group kept in flight (a stage is
//   freed once the group that read it retired), then the epilogue in place:
//   bias, relu, bf16 rounding and 4-byte swizzled stores from the
//   accumulator fragment, then fence.proxy.async and the warpgroup's own
//   named barrier before the next layer's wgmma. The two warpgroups take
//   turns issuing a layer's products (take_turn / pass_turn, named
//   barriers 3 and 4), so that one's epilogue runs while the other's
//   products keep the tensor cores busy.
// - The embedding: each consumer thread embeds one point (threads 0-63) or
//   one view direction (64-127) with embed_row into a padded staging row
//   in its warpgroup's act (free until layer 0's epilogue), then moves its
//   own row into emb / embv by swizzled 16-byte stores.
// - The head: rgb/alpha = [hv | h7] Wout + bout in f32 FMA from registers:
//   h7's part at layer 7's epilogue, hv's at the view layer's, each
//   reduced over the 4 lanes that share an accumulator row, so hv is never
//   stored (unless the hook asks for it: kHvToAct). The sink gets raw of
//   the points p < n_pts.

#pragma once

#include <climits>

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FWD_THREADS = 384;  // a producer and two consumer warpgroups
constexpr int FWD_PRODUCER_REGS = 40, FWD_CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 64K
constexpr int FWD_STAGES = 4;
constexpr int FWD_ROWS = 64;  // points a consumer warpgroup owns: TP = 2 x 64
// embedding staging rows in a warpgroup's act, in bf16: odd word strides,
// so embed_row's 2-byte stores of a warp hit 32 banks
constexpr int FWD_SPT = KE + 2, FWD_SVW = KV + 2;

// The four weight maps (hopper::encode_rows_sw128 over the bf16 blob of
// Layout<W>, boxes of 64 columns):
//   w05   W05e^T [2W][64], boxes of W rows (layer 0: rows [0, W); layer 5's
//         skip: [W, 2W));
//   trunk W1^T..W7^T, Wf^T, contiguous as [8W][W], boxes of W rows;
//   wvf   Wvf^T [W/2][W], boxes of W/2 rows;
//   wve   Wve^T [W/2][32], one 64-wide box of W/2 rows (columns 32.. are
//         past the edge: TMA fills them with zeros).
struct FwdMaps {
  CUtensorMap w05, trunk, wvf, wve;
};

template <int W>
struct FwdSmem {
  static constexpr int NB = W / 64;                    // 64-column blocks of act
  static constexpr size_t BLOCK = size_t(FWD_ROWS) * 128;  // 64 rows x 64 bf16: 8 KB
  static constexpr size_t STAGE = size_t(W) * 128;     // a chunk of N = W rows
  static constexpr size_t ring = 0;
  static constexpr size_t act = ring + FWD_STAGES * STAGE;  // [2 wg][NB][BLOCK]
  static constexpr size_t emb = act + 2 * NB * BLOCK;       // [2 wg][BLOCK]
  static constexpr size_t embv = emb + 2 * BLOCK;           // [2 wg][BLOCK]
  static constexpr size_t bars = embv + 2 * BLOCK;          // full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bars + 2 * FWD_STAGES * sizeof(uint64_t);
  static constexpr size_t launch_bytes = bytes + 1024;  // the base is aligned up to 1 KB
  static_assert(STAGE % 1024 == 0 && BLOCK % 1024 == 0, "swizzled tiles on 1 KB bounds");
  static_assert(size_t(FWD_ROWS) * (FWD_SPT + FWD_SVW) * 2 <= NB * BLOCK,
                "staging fits in act");
  static_assert(launch_bytes <= 232448, "fits in an SM's shared memory");
  static_assert(NB <= FWD_STAGES, "a layer's act chunks fit in the ring (take_turn)");
};

// The schedules: the first tile of the CTA and the one after `tile`; the
// CTA stops at the first tile >= ntiles; scene() is the weight set its
// tiles read. TileWalk (K1, K2): every gridDim.x-th tile, one weight set.
struct TileWalk {
  __device__ __forceinline__ int first() const { return blockIdx.x; }
  __device__ __forceinline__ int next(int tile) const { return tile + gridDim.x; }
  __device__ __forceinline__ int scene() const { return 0; }
};

// SceneWalk (the stacked K1, K2, K4 and K3 launches of multi-scene
// training; fused_render.cu's SceneGroupWalk, the stacked K5's, is one): S
// scenes' points one after another, each scene a whole number of tiles, so
// that no tile spans two scenes; the grid's y is the scene, and CTA (x, y)
// takes scene y's tiles x, x + gridDim.x, ... (TileWalk's order within the
// scene). Its tiles read the weights of scene y: its blocks in blobs
// stacked [S][Layout<W>::size] (biases [S][nbias]). The producer picks each
// tile's rows of the maps; the ring streams a tile's weights every tile,
// and no stage assumes one weight set. The consumers read the scene afresh
// (an opaque read of %ctaid.y, which the compiler neither hoists nor keeps)
// where an epilogue or the head addresses a bias or a Wout row, and add it
// to the index into the blobs: kept as pointers, per tile or for the CTA's
// life, the per-scene bases made ptxas spill 80 to 360 bytes in the W = 256
// consumers (K1's, the recompute's, the chain's), which run at their 232
// registers.
struct SceneWalk {
  int tiles_per_scene;
  __device__ __forceinline__ int first() const {
    return int(blockIdx.y) * tiles_per_scene + int(blockIdx.x);
  }
  __device__ __forceinline__ int next(int tile) const {
    const int t = tile + int(gridDim.x);
    return t < (int(blockIdx.y) + 1) * tiles_per_scene ? t : INT_MAX;  // INT_MAX: done
  }
  __device__ __forceinline__ int scene() const {
    int y;
    asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(y));
    return y;
  }
};

// The hook: before_head(tile) is called by every consumer thread before
// the tile's head hands raw to the sink, after_tile(tile, ntiles) after it,
// and side() by the threads of the producer warpgroup's warps 1-3 (40
// registers each) once. after_embed(emb, embv, p0) and after_layer(l, act,
// p0) are called by every thread of a consumer warpgroup (its 64 points
// from p0) once a buffer holds a layer's complete output and the next
// layer's products are in flight, and before that layer's epilogue may
// overwrite it: the embeddings under layer 0's products; h_l (l = 0..7)
// under layer l + 1's, after layer 5's skip chunk; feat (l = 8) under the
// view layer's, after its embv chunk; with kHvToAct, hv (l = 9) in act's
// first W/2 columns between two barriers of the warpgroup after the view
// layer. A hook waits on no barrier. NoHook: none.
struct NoHook {
  static constexpr bool kHvToAct = false;
  __device__ __forceinline__ void before_head(int) const {}
  __device__ __forceinline__ void after_tile(int, int) const {}
  __device__ __forceinline__ void side() const {}
  __device__ __forceinline__ void after_embed(const unsigned char*, const unsigned char*,
                                              int) const {}
  __device__ __forceinline__ void after_layer(int, const unsigned char*, int) const {}
};

// The 1 KB-aligned base of the dynamic shared memory (FwdSmem's offsets;
// a caller's extra bytes start at FwdSmem<W>::bytes).
__device__ __forceinline__ unsigned char* fwd_smem_base(unsigned char* smem_raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                          ~uintptr_t(1023));
}

// The consumers' view of the ring: g counts the chunks consumed so far.
struct FwdRing {
  const unsigned char* base;
  size_t stage_bytes;
  uint64_t* full;
  uint64_t* empty;
  uint32_t g;
};

template <int N>
__device__ __forceinline__ void wgmma_chunk(float (&acc)[N / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int k = 0; k < KC / 16; ++k) {  // a 16-wide K step is +32 bytes: +2 on a descriptor
    if constexpr (N == 256) hopper::wgmma_m64n256k16(acc, da + 2 * k, db + 2 * k);
    else if constexpr (N == 128) hopper::wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k);
    else hopper::wgmma_m64n64k16(acc, da + 2 * k, db + 2 * k);
  }
}

__device__ __forceinline__ void release_stage(FwdRing& r, uint32_t chunk) {
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&r.empty[chunk % FWD_STAGES]);
}

// acc += A (64 x 64 at a, swizzled) times the ring's next chunk. The first
// chunk of a layer leaves the previous layer's groups alone (all retired);
// every later one retires the group before it and frees that stage.
template <int N>
__device__ __forceinline__ void consume_chunk(FwdRing& r, float (&acc)[N / 2], const void* a,
                                              bool first) {
  const uint32_t s = r.g % FWD_STAGES;
  hopper::mbar_wait(&r.full[s], (r.g / FWD_STAGES) & 1);
  hopper::wgmma_fence();
  wgmma_chunk<N>(acc, hopper::desc_k_sw128(a),
                 hopper::desc_k_sw128(r.base + s * r.stage_bytes));
  hopper::wgmma_commit();
  if (!first) {
    hopper::wgmma_wait<1>();
    release_stage(r, r.g - 1);
  }
  ++r.g;
}

// The layer's last group retired, its stage freed, and every warp of the
// warpgroup past its wait, so the epilogue may overwrite A in place.
__device__ __forceinline__ void finish_layer(FwdRing& r, int bar) {
  hopper::wgmma_wait<0>();
  release_stage(r, r.g - 1);
  hopper::bar_sync(bar, 128);
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
}

// The four bf16 of Wout's row k as floats.
__device__ __forceinline__ void wout_row(const bf16* __restrict__ wout, int k, float (&w)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(wout + size_t(k) * 4));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// Shared-memory stores by 32-bit shared addresses: the epilogue's 64
// addresses a layer are then one base and immediates, not 64-bit pointers
// (which ptxas kept live across the layers, and spilled).
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// out (a warpgroup's act, NB blocks of 64 x 64 swizzled) = bf16(act(acc +
// bias)), from the m64nN accumulator fragment (hopper.cuh): row
// 16*warp + lane/4 (+8), columns 8*jb + 2*(lane%4) (+1). With kPart also
// part[h][c] += the rounded row . Wout[W/2 + col][c] (h7's share of raw).
// Without kBias no bias is read or added (K7's matmul_only). boff and wrow
// move the bias index and the Wout row to a stacked blob's scene
// (SceneWalk).
template <int W, bool kRelu, bool kPart, bool kBias = true>
__device__ __forceinline__ void epilogue_sw(const float (&acc)[W / 2],
                                            const float* __restrict__ bias, unsigned char* out,
                                            const bf16* __restrict__ wout, float (&part)[2][4],
                                            int boff = 0, int wrow = 0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int sw = lane >> 2;  // the rows' % 8: the swizzle's XOR
  const uint32_t row0 = hopper::smem_addr(out) + (16 * warp + sw) * 128 + ((lane & 3) << 2);
#pragma unroll
  for (int jb = 0; jb < W / 8; ++jb) {
    const int col = 8 * jb + 2 * (lane & 3);
    float2 b = make_float2(0.f, 0.f);
    if constexpr (kBias) b = __ldg(reinterpret_cast<const float2*>(bias + (boff + col)));
    const uint32_t blk = row0 + (jb >> 3) * (FWD_ROWS * 128) + (((jb & 7) ^ sw) << 4);
    float w0[4], w1[4];
    if (kPart) {
      wout_row(wout, wrow + W / 2 + col, w0);
      wout_row(wout, wrow + W / 2 + col + 1, w1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * jb + 2 * h], v1 = acc[4 * jb + 2 * h + 1];
      if constexpr (kBias) {
        v0 += b.x;
        v1 += b.y;
      }
      if (kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const __nv_bfloat162 q = __floats2bfloat162_rn(v0, v1);
      st_shared_b32(blk + h * 8 * 128, *reinterpret_cast<const uint32_t*>(&q));
      if (kPart) {
        const float2 f = __bfloat1622float2(q);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[h][c] = fmaf(f.y, w1[c], fmaf(f.x, w0[c], part[h][c]));
      }
    }
  }
}

// Sums each of v's 8 values over the 4 lanes that share accumulator rows.
__device__ __forceinline__ void quad_sum(float (&v)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[h][c] += __shfl_xor_sync(0xffffffffu, v[h][c], 1);
      v[h][c] += __shfl_xor_sync(0xffffffffu, v[h][c], 2);
    }
}

__device__ __forceinline__ float pick(const float (&v)[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

// The view layer's epilogue and the head: hv = bf16(relu(acc + bv)) stays
// in registers; raw = (hv . Wout[:W/2] + part) + bout goes to the sink,
// channel lane % 4 of the thread's two rows (boff, wrow: epilogue_sw's).
template <int W, typename Sink>
__device__ __forceinline__ void view_head(const float (&acc)[W / 4], const float* __restrict__ bv,
                                          const bf16* __restrict__ wout,
                                          const float* __restrict__ bout, const float (&part)[2][4],
                                          int n_pts, int p0, const Sink& sink, int boff = 0,
                                          int wrow = 0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float o[2][4] = {};
#pragma unroll
  for (int jb = 0; jb < W / 16; ++jb) {
    const int col = 8 * jb + 2 * (lane & 3);
    const float2 b = __ldg(reinterpret_cast<const float2*>(bv + (boff + col)));
    float w0[4], w1[4];
    wout_row(wout, wrow + col, w0);
    wout_row(wout, wrow + col + 1, w1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(
          fmaxf(acc[4 * jb + 2 * h] + b.x, 0.f), fmaxf(acc[4 * jb + 2 * h + 1] + b.y, 0.f)));
#pragma unroll
      for (int c = 0; c < 4; ++c) o[h][c] = fmaf(f.y, w1[c], fmaf(f.x, w0[c], o[h][c]));
    }
  }
  quad_sum(o);
  const int c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 16 * warp + (lane >> 2) + 8 * h;
    const float v = (pick(o[h], c) + pick(part[h], c)) + __ldg(bout + (boff + c));
    if (p < n_pts) sink(p, c, v);
  }
}

// Embeds the warpgroup's 64 points (threads 0-63) and view directions
// (64-127) into emb / embv (swizzled; embv's columns 32..63 zeros): each
// thread through a staging row of its own in act, so no barrier is needed
// between the two steps. Trig gives the sines and cosines (embed_row).
template <typename In, typename Trig = SinCos>
__device__ __forceinline__ void embed_sw(const In& in, int n_pts, int Fp, int Fv, int p0,
                                         unsigned char* act, unsigned char* emb,
                                         unsigned char* embv) {
  const int t = threadIdx.x & 127;
  const bool pts = t < FWD_ROWS;  // warp-uniform: warps 0-1 points, 2-3 views
  const int i = t & (FWD_ROWS - 1);
  const int p = p0 + i;
  float x[3] = {0.f, 0.f, 0.f};
  if (p < n_pts) {
    if (pts)
      in.point(p, x);
    else
      view_of(in, p, x);
  }
  bf16* row = reinterpret_cast<bf16*>(act) +
              (pts ? i * FWD_SPT : FWD_ROWS * FWD_SPT + i * FWD_SVW);
  embed_row<bf16, Trig>(x, pts ? Fp : Fv, pts ? KE : KV, row);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(row);
  const uint32_t dst = hopper::smem_addr(pts ? emb : embv) + i * 128;
  const int chunks = pts ? KE / 8 : KV / 8;  // 16-byte chunks of the row that hold values
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < chunks) v = make_uint4(src[4 * c], src[4 * c + 1], src[4 * c + 2], src[4 * c + 3]);
    st_shared_v4(dst + ((c ^ (i & 7)) << 4), v);
  }
}

// The warpgroups' turns on the tensor cores (ping-pong): warpgroup w
// waits at named barrier 3 + w before it issues a layer's products and,
// once they are issued, lets the other go (barrier 4 - w), so that each
// one's epilogue runs under the other's products. A layer's chunks past
// the first FWD_STAGES (layer 5's skip chunk, the view layer's embv chunk
// at W = 256) come after the turn is passed: the ring can only load them
// once the other warpgroup has freed this layer's first chunks.
__device__ __forceinline__ void take_turn(int w) { hopper::bar_sync(3 + w, 256); }
__device__ __forceinline__ void pass_turn(int w) { hopper::bar_arrive(4 - w, 256); }

// One consumer warpgroup (w = 0 or 1) over the CTA's tiles.
template <typename In, int W, typename Sink, typename Walk, typename Hook>
__device__ __forceinline__ void fwd_consumer(const In& in, int n_pts, int Fp, int Fv,
                                             const bf16* __restrict__ wb,
                                             const float* __restrict__ bb, int ntiles,
                                             unsigned char* smem, uint64_t* full, uint64_t* empty,
                                             int w, const Sink& sink, const Walk& walk,
                                             const Hook& hook) {
  using L = FwdSmem<W>;
  using O = Layout<W>;
  constexpr int NB = L::NB;
  unsigned char* act = smem + L::act + w * NB * L::BLOCK;
  unsigned char* emb = smem + L::emb + w * L::BLOCK;
  unsigned char* embv = smem + L::embv + w * L::BLOCK;
  const bf16* wout = wb + O::wout;
  // the tile's net (SceneWalk: its scene's) as index offsets into the blobs,
  // taken afresh where used (see SceneWalk): a bias, and a row of Wout
  auto boff = [&]() { return walk.scene() * O::nbias; };
  auto wrow = [&]() { return walk.scene() * int(O::size / 4); };
  const int bar = 1 + w;
  FwdRing r{smem + L::ring, L::STAGE, full, empty, 0};
  if (w == 1) pass_turn(w);  // warpgroup 0 goes first
  for (int tile = walk.first(); tile < ntiles; tile = walk.next(tile)) {
    const int p0 = tile * TP + w * FWD_ROWS;
    embed_sw(in, n_pts, Fp, Fv, p0, act, emb, embv);
    hopper::fence_proxy_async();
    hopper::bar_sync(bar, 128);
    float part[2][4] = {};
    {
      float acc[W / 2];
      zero_regs(acc);
      take_turn(w);
      consume_chunk<W>(r, acc, emb, true);  // layer 0: e W0e
      pass_turn(w);
      hook.after_embed(emb, embv, p0);
      finish_layer(r, bar);
      epilogue_sw<W, true, false>(acc, bb, act, wout, part, boff(), 0);
    }
    for (int i = 1; i < 8; ++i) {  // trunk; layer 5 adds e W5e
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      float acc[W / 2];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB; ++j) consume_chunk<W>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);  // before the skip chunk: see take_turn
      if (i == 5) consume_chunk<W>(r, acc, emb, false);
      hook.after_layer(i - 1, act, p0);
      finish_layer(r, bar);
      if (i == 7)
        epilogue_sw<W, true, true>(acc, bb + i * W, act, wout, part, boff(), wrow());
      else
        epilogue_sw<W, true, false>(acc, bb + i * W, act, wout, part, boff(), 0);
    }
    quad_sum(part);
    {  // feature (no activation), over h7 in place
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      float acc[W / 2];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB; ++j) consume_chunk<W>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);
      hook.after_layer(7, act, p0);
      finish_layer(r, bar);
      epilogue_sw<W, false, false>(acc, bb + O::bf, act, wout, part, boff(), 0);
    }
    {  // view layer [feat | ev] -> W/2, then the head
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      float acc[W / 4];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB; ++j) consume_chunk<W / 2>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);  // before the embv chunk: see take_turn
      consume_chunk<W / 2>(r, acc, embv, false);
      hook.after_layer(8, act, p0);
      finish_layer(r, bar);  // act and embv are free for the next tile
      if constexpr (Hook::kHvToAct) {  // hv to act for the hook, then act is free again
        epilogue_sw<W / 2, true, false>(acc, bb + O::bv, act, wout, part, boff(), 0);
        hopper::bar_sync(bar, 128);
        hook.after_layer(9, act, p0);
        hopper::bar_sync(bar, 128);
      }
      hook.before_head(tile);
      view_head<W>(acc, bb + O::bv, wout, bb + O::bout, part, n_pts, p0, sink, boff(), wrow());
    }
    hook.after_tile(tile, ntiles);
  }
  if (w == 0) take_turn(w);  // warpgroup 1's last pass_turn
}

// The producer thread: every tile's chunks, in the consumers' order, from
// the rows of the tile's scene (the maps span every scene's blob).
template <int W, typename Walk>
__device__ __forceinline__ void fwd_producer(const FwdMaps& maps, int ntiles, unsigned char* ring,
                                             uint64_t* full, uint64_t* empty, const Walk& walk) {
  using L = FwdSmem<W>;
  using O = Layout<W>;
  constexpr int NB = L::NB;
  static_assert(O::size % W == 0 && W % KE == 0, "a scene's blob is whole rows of every map");
  uint32_t g = 0;
  auto load = [&](const CUtensorMap* map, int x, int y, int rows) {
    const uint32_t s = g % FWD_STAGES;
    if (g >= FWD_STAGES) hopper::mbar_wait(&empty[s], ((g / FWD_STAGES) - 1) & 1);
    hopper::mbar_arrive_expect_tx(&full[s], uint32_t(rows) * 128);
    hopper::tma_load_2d(ring + s * L::STAGE, map, &full[s], x, y);
    ++g;
  };
  for (int tile = walk.first(); tile < ntiles; tile = walk.next(tile)) {
    const int sc = walk.scene();
    const int y05 = sc * int(O::size / KE), yw = sc * int(O::size / W);
    const int yve = sc * int(O::size / KV);
    load(&maps.w05, 0, y05, W);
    for (int i = 1; i < 8; ++i) {
      for (int j = 0; j < NB; ++j) load(&maps.trunk, KC * j, yw + (i - 1) * W, W);
      if (i == 5) load(&maps.w05, 0, y05 + W, W);
    }
    for (int j = 0; j < NB; ++j) load(&maps.trunk, KC * j, yw + 7 * W, W);
    for (int j = 0; j < NB; ++j) load(&maps.wvf, KC * j, yw, W / 2);
    load(&maps.wve, 0, yve, W / 2);
  }
}

// The whole CTA (FWD_THREADS threads, FwdSmem<W>::launch_bytes of dynamic
// shared memory at smem_raw) over its tiles of the ntiles = ceil(n_pts / TP)
// tiles, in walk's order, with hook's calls.
template <typename In, int W, typename Sink, typename Walk = TileWalk, typename Hook = NoHook>
__device__ __forceinline__ void fwd_tiles_sm90(const FwdMaps& maps, const In& in, int n_pts,
                                               int Fp, int Fv, const bf16* __restrict__ wb,
                                               const float* __restrict__ bb,
                                               unsigned char* smem_raw, const Sink& sink,
                                               const Walk& walk = Walk(),
                                               const Hook& hook = Hook()) {
  using L = FwdSmem<W>;
  unsigned char* smem = fwd_smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + FWD_STAGES;
  const int ntiles = (n_pts + TP - 1) / TP;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // the consumers' 8 warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    hopper::setmaxnreg_dec<FWD_PRODUCER_REGS>();
    if (threadIdx.x == 0)
      fwd_producer<W>(maps, ntiles, smem + L::ring, full, empty, walk);
    else if (threadIdx.x >= 32)
      hook.side();
  } else {
    hopper::setmaxnreg_inc<FWD_CONSUMER_REGS>();
    fwd_consumer<In, W>(in, n_pts, Fp, Fv, wb, bb, ntiles, smem, full, empty, wg - 1, sink, walk,
                        hook);
  }
}

// The launch's four tensor maps over the bf16 weight blob wb (Layout<W>),
// or over `scenes` such blobs one after another: each map then runs on
// through the later scenes' blobs, scene s's block starting s *
// Layout<W>::size / cols rows further on (fwd_producer).
template <int W>
cudaError_t encode_fwd_maps(FwdMaps* maps, const bf16* wb, int scenes = 1) {
  using O = Layout<W>;
  const long long more = scenes - 1;  // blobs past the first
  cudaError_t err = hopper::encode_rows_sw128(&maps->w05, wb + O::w05,
                                              more * (O::size / KE) + 2 * W, KE, W);
  if (err == cudaSuccess)
    err = hopper::encode_rows_sw128(&maps->trunk, wb + O::w1, more * (O::size / W) + 8 * W, W, W);
  if (err == cudaSuccess)
    err = hopper::encode_rows_sw128(&maps->wvf, wb + O::wvf, more * (O::size / W) + W / 2, W,
                                    W / 2);
  if (err == cudaSuccess)
    err = hopper::encode_rows_sw128(&maps->wve, wb + O::wve, more * (O::size / KV) + W / 2, KV,
                                    W / 2);
  return err;
}

// The stacked launches' grid (SceneWalk): a persistent CTA per SM shared
// out among the scenes, min(tiles a scene, max(1, SMs / scenes)) CTAs a
// scene (8 scenes: 16 a scene, 128 of the 132 SMs), the scene as y.
inline dim3 scene_grid(int tiles_per_scene, int scenes, int sms) {
  const int per = sms / scenes > 1 ? sms / scenes : 1;
  return dim3(tiles_per_scene < per ? tiles_per_scene : per, scenes);
}

}  // namespace
