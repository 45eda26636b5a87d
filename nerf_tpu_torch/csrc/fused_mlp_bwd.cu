// Fused NeRF backward for Hopper (sm_90a): the gradients of the fused
// forward (fused_mlp_fwd.cu) from the cotangent of its raw output, in its
// two input modes (fused_mlp_common.cuh's RaysIn / PointsIn).
//
// K4 replaces nerf_tpu/ops/fused_mlp.py::_make_bwd_kernel_rays (the Pallas
// kernel behind _fused_rays_bwd_rule): raygen mode, the cotangent as planes
// g[c][p], weight grads only (rays and depths are never differentiated on
// the training path).
// K3 replaces nerf_tpu/ops/fused_mlp.py::_make_bwd_kernel (behind
// _fused_bwd_rule): points x [N][3] from memory, the cotangent as rows
// g[p][c], and with input grads also dx [N][3] and dv [N/spr][3].
// Per point, with g the cotangent of raw (r, g, b, sigma) and gc = bf16(g):
//   dWout = [hv | h7]^T gc;  dbout = sum g
//   d_hv  = (gc Wout[:W/2]^T) * (hv > 0);          dbv = sum d_hv
//   dWvf  = feat^T bf16(d_hv);  dWve = ev^T bf16(sum over a view's points of d_hv)
//   d_feat = bf16(d_hv) Wvf^T;  dWf = h7^T bf16(d_feat);  dbf = sum d_feat
//   d_h7  = (bf16(d_feat) Wf^T + gc Wout[W/2:]^T) * (h7 > 0)
//   layer i = 7..1: dW_i = h_{i-1}^T bf16(d_h_i);  db_i = sum d_h_i;
//                   d_h_{i-1} = (bf16(d_h_i) W_i^T) * (h_{i-1} > 0)
//   dW05e = e^T [bf16(d_h_0) | bf16(d_h_5)];  db0 = sum d_h_0
// and, with input grads (K3):
//   d_e = [bf16(d_h_0) | bf16(d_h_5)] W05e^T,   dx = embed_row_backward(x, d_e)
//   d_ev = bf16(sum over a view's points of d_hv) Wve^T,  dv = embed_row_backward(v, d_ev)
// (_mlp_backward_math; bias grads sum the unrounded f32 cotangents, as
// there). Two instantiations, as the forward's: bf16 operands with f32
// accumulation (wgmma and TMA in every launch that multiplies), and true
// f32 FMA loops (no TF32) that isolate indexing faults from rounding.
//
// Bound: the recompute (the forward without the rgb/alpha head), the
// activation cotangents and the weight grads are 3,484,416 FLOP per point at
// 8x256 with 10/4 octaves (plus 6,912 per view direction for dWve, and
// 64,512 per point + 6,912 per direction with input grads), so the kernel
// is bound by operations: at 989 TFLOP/s bf16 a training step at
// N_rand=4096 needs >= 0.92 ms coarse (262,144 points) and >= 2.77 ms fine
// (786,432 points).
//
// Design: three phases, each launch on the caller's stream. A tile does not
// fit every activation in shared memory (h0..h7, feat, hv and their
// cotangents are ~1.2 MB at 128 points), so each activation and each
// rounded cotangent goes to a workspace in device memory, feature-major
// ([feature][point], WsRows: 9.9 KB per point in bf16), for phase 3, and
// the relu masks of h0..h7 and hv go there as bits (MaskRows: 272 B a
// point at W = 256). In bf16 phase 1 is two launches:
//  1a. The recompute (bwd_recompute_sm90) is K1's tile, fwd_tile_sm90.cuh,
//     over the same weight blob and tensor maps: a persistent grid of
//     384-thread CTAs, the producer warpgroup's TMA weight ring, two
//     ping-pong wgmma consumer warpgroups of 64 points each. Its activations
//     are K1's (K2's in points mode) bit for bit, so the masks the backward
//     uses are the ones the forward used. Its hook (RecomputeHook) stores
//     each layer's output while the next layer's products run: from the
//     128-byte-swizzled act / emb / embv blocks to the workspace rows, 8
//     points of one feature a 16-byte store (store_rows_sw), and the masks
//     as one 32-bit word per point and 32 features, from warp ballots over
//     the same loads; each warp its own 16 points, which its epilogue
//     rewrites next. The stores allocate no L1 line (st_global_na): lines
//     they allocated in L1, in the 29 KB a tile's 227 KB of shared memory
//     leaves of it, stalled the consumers and even their epilogues' shared
//     stores (0.97 ms of 4.68 a lego step on an H100). Measured there too:
//     the producer warpgroup's three idle warps cannot carry these stores
//     (a unit of 32 features x 16 points with its ballots costs any warp
//     ~900 cycles, and the consumers' eight run them under the products),
//     and no staging box for TMA stores fits beside the ring at W = 256
//     (PERF.md). hv, which K1 keeps in registers, goes to act first
//     (kHvToAct). Its head does no work unless raw is asked for (a check of
//     the tile against K1's, the sink then GlobalSink). Bound by bytes: the
//     rows and masks it writes once (e, h0..h7, feat, hv: 4,992 B a point at
//     8x256 in ray mode, 272 B of masks) and z read, 5,268 B, so >= 1.65 ms
//     a training step (1,048,576 points) at 3.35 TB/s; its 1,185,536 FLOP a
//     point need >= 1.26 ms at 989 TFLOP/s.
//  1b. The cotangent chain (bwd_chain_sm90) runs on the same CTA shape: the
//     producer warpgroup streams the chain's weights in their order (Wve's
//     and Wvf's chunks, Wf's, W7's .. W1's, with input grads W0e's and
//     W5e's) by TMA from the chain blob (TLayout: kp's own [in][out]
//     layout, the K-major B tile of d W^T) into the ring, and each consumer
//     warpgroup keeps its 64 points' cotangent in act, K-major and 128-byte
//     swizzled, as wgmma's A operand; each layer's epilogue rewrites act in
//     place once the layer's last group has retired (finish_layer). The
//     warpgroups take turns issuing a layer (ping-pong), and while one
//     layer's products run, the previous layer's rows go to the workspace
//     (store_rows_sw, the recompute's 16-byte stores) and its bias sums to
//     the partials. The rank-4 terms are no products: each consumer thread
//     computes d_hv = (gc Wout[:W/2]^T) * (hv > 0) for exactly the elements
//     of its m64n(W/2) fragment, and adds d_h7's gc Wout[W/2:]^T to the
//     accumulators after the products, in the order the chain's earlier
//     warp-MMA version added it. The relu masks are the recompute's words (MaskRows), two
//     rows' W/32 a thread, loaded before the layer's products. The bias
//     sums are f32 column sums over a warpgroup's 64 points (two rows a
//     thread, a reduce-scatter over the 8 lanes that share a column, then
//     the four warps through shared memory), written as one partial a
//     warpgroup and tile (BIAS_PART). Each product sums chunk by chunk, 16
//     K values at a time, in that earlier version's K order. With input grads
//     d_e runs as two more products (d0 from act, then d5 read back from
//     its workspace rows, load_rows_sw) and dx per point; with a direction
//     per point d_ev and dv come first, from d_hv. Bound by bytes: the rows
//     it writes once (gc's 4 used rows, d0..d7, d_feat, d_hv: 4,872 B a
//     point at 8x256), the f32 d_hv rows (512 B at spr > 1), the masks and
//     g read (288 B), 5,672 B a point, so with the weights and a tile's bias
//     sums >= 1.80 ms a training step at 3.35 TB/s; its 1,117,184 FLOP a
//     point need >= 1.18 ms at 989 TFLOP/s.
//     The f32 instantiation (bwd_tile_f32) is one launch: the recompute by
//     FMA, its rows to the workspace, and the chain reading its masks back
//     from them.
//  2. With a direction per ray (spr > 1), a small kernel sums d_hv over each
//     ray's samples (fixed order) and embeds the view directions per ray for
//     dWve, then d_ev and dv. With a direction per point (spr = 1) phase 1
//     writes the view embedding to the workspace and computes d_ev and dv
//     itself, and dWve is one more product over points.
//  3. Every weight grad is a product a^T d over all points: one launch
//     (wgrad_bf16) takes all 14 of them as a Hopper GEMM that reads the
//     workspace rows once. A CTA owns a 128-row tile of one product's C at
//     its full width (N <= 256; 8 for dWout's 4 columns, 128 for dWvf and
//     dWve), so an A row is read once and a B row once per 128 rows of C.
//     Warp specialised, 384 threads: a producer warpgroup (one thread
//     issuing, registers given up with setmaxnreg) streams 64-point K chunks
//     of A and B by TMA (cp.async.bulk.tensor, tensor maps over the
//     workspace and the per-ray rows, boxes of 64 points x 64 rows with the
//     128-byte swizzle) into a 4-stage ring of 48 KB stages, each behind an
//     mbarrier that counts the bytes; two consumer warpgroups (one when C
//     has <= 64 rows) each run wgmma m64nNk16 from the swizzled tiles into
//     64 x N f32 accumulators and free a stage on a second mbarrier. The
//     points are split so that no split sums more than 16,384 points in one
//     accumulator chain (up to 64 splits) and the grid fills whole waves of
//     the 132 SMs as nearly as the shapes allow (the shapes alone fix the
//     count); each split writes its own partial, and two reduction kernels
//     then sum the splits and the tiles' bias sums in a fixed order. No
//     float atomics: two launches on the same inputs give bit-identical
//     grads. The f32 instantiation keeps a plain 64 x 64 FMA tile
//     (wgrad_f32).
//     Phase 3 alone is bound by bytes: it must read every workspace row
//     once, 4,936 bf16 rows = 9,872 B a point at 8x256 in ray mode
//     (1,181,696 FLOP a point), so >= 0.77 ms coarse and >= 2.32 ms fine at
//     3.35 TB/s.
// Padded points carry a zero cotangent, so they add nothing to any sum; the
// recompute writes every row of every tile up to n_pad (posenc of x = 0
// past n_pts), so no unwritten row meets a zero.

#include "fused_mlp_common.cuh"
#include "fwd_tile_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace {

// The forward weights again in kp's own [in][out] layout (element type T):
// the B operand [N = in][K = out] of the cotangent products d W^T.
//   W1..W7 [W][W] | Wf [W][W] | Wvf [W][W/2] |
//   W0e [64][W] | W5e [64][W] | Wve [32][W/2]  (input grads; embedding rows padded)
template <int W>
struct TLayout {
  __host__ __device__ static size_t wi(int i) { return size_t(i - 1) * W * W; }
  static constexpr size_t wf = size_t(7) * W * W;
  static constexpr size_t wvf = size_t(8) * W * W;
  static constexpr size_t w0e = wvf + size_t(W) * (W / 2);
  static constexpr size_t w5e = w0e + size_t(KE) * W;
  static constexpr size_t wve = w5e + size_t(KE) * W;
  static constexpr size_t size = wve + size_t(KV) * (W / 2);  // one net's blob
};

// The f32 gradients, in kp's [in][out] layout with the embedding rows padded:
//   dW05e [64][2W] | dW1..dW7 [W][W] | dWf [W][W] | dWvf [W][W/2] |
//   dWve [32][W/2] | dWout [3W/2][4], then the bias grads as the bias blob.
template <int W>
struct GLayout {
  static constexpr size_t w05 = 0;
  __host__ __device__ static size_t wi(int i) {
    return size_t(KE) * 2 * W + size_t(i - 1) * W * W;
  }
  static constexpr size_t wf = size_t(KE) * 2 * W + size_t(7) * W * W;
  static constexpr size_t wvf = wf + size_t(W) * W;
  static constexpr size_t wve = wvf + size_t(W) * (W / 2);
  static constexpr size_t wout = wve + size_t(KV) * (W / 2);
  static constexpr size_t size = wout + size_t(3 * W / 2) * 4;
};

// Rows of the point workspace; row r holds one feature for every point.
template <int W>
struct WsRows {
  static constexpr int e = 0;
  __host__ __device__ static int h(int i) { return KE + i * W; }
  static constexpr int feat = KE + 8 * W;
  static constexpr int hv = feat + W;
  static constexpr int gc = hv + W / 2;  // 4 rows used, 8 kept for alignment
  __host__ __device__ static int d(int i) { return gc + 8 + i * W; }
  static constexpr int dfeat = gc + 8 + 8 * W;
  static constexpr int dhv = dfeat + W;
  static constexpr int ev = dhv + W / 2;  // the view embedding, a direction per point only
  static constexpr int rows = ev + KV;
};

// Rows of the bf16 mask words (u32, one per point a row): word k of layer
// i's rows holds the bits of (h_i[p][32k + b] > 0) at bit b, for h0..h7,
// then hv.
template <int W>
struct MaskRows {
  __host__ __device__ static int h(int i) { return i * (W / 32); }
  static constexpr int hv = 8 * (W / 32);
  static constexpr int rows = hv + W / 64;
};

// dst[c][p0 + i] = src[i][c]: a tile's [tile][rows] shared buffer to
// feature-major workspace rows (consecutive threads, consecutive points).
// The f32 path's.
template <typename T>
__device__ void store_t(const T* src, int lds, int rows, int tile, T* dst, size_t ldp, int p0) {
  for (int idx = threadIdx.x; idx < rows * tile; idx += THREADS) {
    const int c = idx / tile, i = idx - c * tile;
    dst[size_t(c) * ldp + p0 + i] = src[i * lds + c];
  }
}

// dst[i][c] = src[c][p0 + i]: store_t's inverse, workspace rows back to a
// tile's shared buffer.
template <typename T>
__device__ void load_t(const T* src, size_t ldp, int p0, int rows, int tile, T* dst, int ldd) {
  for (int idx = threadIdx.x; idx < rows * tile; idx += THREADS) {
    const int c = idx / tile, i = idx - c * tile;
    dst[i * ldd + c] = src[size_t(c) * ldp + p0 + i];
  }
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Global stores that allocate no line in L1 (st.global.L1::no_allocate).
__device__ __forceinline__ void st_global_na(void* p, uint4 v) {
  asm volatile("st.global.L1::no_allocate.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ void st_global_na(uint32_t* p, uint32_t v) {
  asm volatile("st.global.L1::no_allocate.b32 [%0], %1;\n" ::"l"(p), "r"(v));
}

// The recompute's stores, by one consumer warpgroup of fwd_tile_sm90.cuh:
// ws[c][p0 + i] = A[i][c] for its 64 points i and the features c < ncols
// (a multiple of 32) of A, ncols / 64 blocks of 64 x 64 bf16 at a in the
// 128-byte-swizzled layout (hopper.cuh: element (i, c) of a block at byte
// i*128 + ((c/8) ^ (i%8))*16 + (c%8)*2), to feature-major rows; with m
// given also m[c / 32][p0 + i] = the bits of (A[i][c..c+31] > 0) (bit b:
// feature c + b; bf16 as a signed 16-bit integer is > 0 exactly where the
// value is, -0 and NaN aside, which relu never gives). Warp w moves points
// 16w .. 16w + 15, 32 features at a time: lane (q, h) = (lane / 2, lane % 2)
// reads features c, c + 1 (c = c0 + 2q, one 32-bit word) at rows i .. i + 7
// (i = 16w + 8h) and writes each feature's 8 points as one 16-byte store,
// lanes 2q and 2q + 1 one 32-byte sector. Half h reads its rows in the
// order j ^ 4h: both halves' row % 8 then differ by 4, so the 64-byte
// pieces the swizzle gives them are the two halves of a 128-byte row, 32
// banks, one wavefront a load. The masks come from two ballots a row over
// the same words, before the stores (fewer registers live at once: the
// hook runs beside a layer's 128 accumulators); lanes 0-15 write their
// points' words, 64 bytes a warp. With kStream (the recompute's) the rows
// and words allocate no line in L1 (st_global_na): nothing in the launch
// reads them back, and lines they allocated in L1, in the 29 KB a tile's
// 227 KB of shared memory leaves of it, cost the recompute 0.97 of its
// 4.68 ms a lego step on an H100 (PERF.md; st.global.cg, .cs: less).
template <bool kStream = false>
__device__ __forceinline__ void store_rows_sw(const unsigned char* a, int ncols, bf16* ws,
                                              size_t ldp, uint32_t* m, int p0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane >> 1, h = lane & 1;
  const int i = 16 * warp + 8 * h;
  const uint32_t base = hopper::smem_addr(a) + i * 128;
#pragma unroll 1
  for (int c0 = 0; c0 < ncols; c0 += 32) {
    const int c = c0 + 2 * q;
    const uint32_t col = base + (c >> 6) * (FWD_ROWS * 128) + ((c & 7) << 1);
    const int chunk = (c & 63) >> 3;
    uint32_t w[8];  // w[k]: features c, c + 1 at point i + k (in row order j ^ 4h before the swap)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = j ^ (4 * h);  // the row's offset from i, and its % 8
      w[j] = ld_shared_b32(col + x * 128 + ((chunk ^ x) << 4));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // w[j] <-> w[j ^ 4] for half 1
      const uint32_t lo = h ? w[k + 4] : w[k], hi = h ? w[k] : w[k + 4];
      w[k] = lo;
      w[k + 4] = hi;
    }
    if (m != nullptr) {  // the same for the whole warpgroup; first, so w dies in the stores
      uint32_t word = 0u;  // lane L < 16: point 16w + L
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // bit 2q' + h' of each ballot: lane (q', h'), feature c0 + 2q' (b0)
        // or c0 + 2q' + 1 (b1) at point 16w + 8h' + k
        const uint32_t b0 = __ballot_sync(0xffffffffu, int16_t(w[k] & 0xffffu) > 0);
        const uint32_t b1 = __ballot_sync(0xffffffffu, int16_t(w[k] >> 16) > 0);
        if (lane == k) word = (b0 & 0x55555555u) | ((b1 & 0x55555555u) << 1);
        if (lane == k + 8) word = ((b0 >> 1) & 0x55555555u) | (b1 & 0xaaaaaaaau);
      }
      if (lane < 16) {
        if constexpr (kStream)
          st_global_na(m + (size_t(c0 >> 5) * ldp + p0 + 16 * warp + lane), word);
        else
          m[size_t(c0 >> 5) * ldp + p0 + 16 * warp + lane] = word;
      }
    }
    uint32_t f0[4], f1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f0[k] = __byte_perm(w[2 * k], w[2 * k + 1], 0x5410);  // feature c, points 2k, 2k + 1
      f1[k] = __byte_perm(w[2 * k], w[2 * k + 1], 0x7632);  // feature c + 1
    }
    bf16* g = ws + size_t(c) * ldp + p0 + i;
    if constexpr (kStream) {
      st_global_na(g, make_uint4(f0[0], f0[1], f0[2], f0[3]));
      st_global_na(g + ldp, make_uint4(f1[0], f1[1], f1[2], f1[3]));
    } else {
      *reinterpret_cast<uint4*>(g) = make_uint4(f0[0], f0[1], f0[2], f0[3]);
      *reinterpret_cast<uint4*>(g + ldp) = make_uint4(f1[0], f1[1], f1[2], f1[3]);
    }
  }
}

// store_rows_sw's inverse, without masks: A[i][c] = ws[c][p0 + i] for the
// warpgroup's 64 points and the features c < ncols into ncols / 64
// swizzled blocks at a, by the same lanes (each reads back the rows it
// stored there, so no fence is needed) with 16-byte loads and the same
// conflict-free shared addresses. The chain's d5 for d_e.
__device__ __forceinline__ void load_rows_sw(unsigned char* a, int ncols, const bf16* ws,
                                             size_t ldp, int p0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane >> 1, h = lane & 1;
  const int i = 16 * warp + 8 * h;
  const uint32_t base = hopper::smem_addr(a) + i * 128;
#pragma unroll 1
  for (int c0 = 0; c0 < ncols; c0 += 32) {
    const int c = c0 + 2 * q;
    const uint32_t col = base + (c >> 6) * (FWD_ROWS * 128) + ((c & 7) << 1);
    const int chunk = (c & 63) >> 3;
    const bf16* g = ws + size_t(c) * ldp + p0 + i;
    const uint4 a0 = *reinterpret_cast<const uint4*>(g);
    const uint4 a1 = *reinterpret_cast<const uint4*>(g + ldp);
    const uint32_t f0[4] = {a0.x, a0.y, a0.z, a0.w}, f1[4] = {a1.x, a1.y, a1.z, a1.w};
    uint32_t w[8];  // w[k]: features c, c + 1 at point i + k (i + (k ^ 4h) after the swap)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[2 * k] = __byte_perm(f0[k], f1[k], 0x5410);
      w[2 * k + 1] = __byte_perm(f0[k], f1[k], 0x7632);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // w[j] <-> w[j ^ 4] for half 1
      const uint32_t lo = h ? w[k + 4] : w[k], hi = h ? w[k] : w[k + 4];
      w[k] = lo;
      w[k + 4] = hi;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = j ^ (4 * h);
      st_shared_b32(col + x * 128 + ((chunk ^ x) << 4), w[j]);
    }
  }
}

// One point's input grad: out[p][d] = embed_row_backward(y, d_e row i), for
// point p = p0 + i of a tile's `tile` points (a thread each, i its index
// among them). y is the point (pts) or its view direction.
template <typename In>
__device__ void input_grad(const In& in, bool pts, int F, const float* d_e, int ldd, int n_pts,
                           int p0, int tile, float* __restrict__ out, int i) {
  const int p = p0 + i;
  if (i >= tile || p >= n_pts) return;
  float y[3], d[3];
  if (pts)
    in.point(p, y);
  else
    view_of(in, p, y);
  embed_row_backward(y, F, d_e + i * ldd, d);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[size_t(p) * 3 + k] = d[k];
}

// ---------------------------------------------------------------- bf16 path

// The recompute's hook (fwd_tile_sm90.cuh): each layer's output, complete in
// a consumer warpgroup's swizzled blocks, to the workspace rows while the
// next layer's products run, and the relu masks of h0..h7 and hv to the
// mask words. ws and masks are the rows' bases, ldp points a row. kStream:
// store_rows_sw's; the launch that also writes raw (a check of the tile)
// keeps plain stores, for at W = 256 the head's sums beside the stream
// stores' addresses made ptxas spill 68 bytes.
template <int W, bool kStream>
struct RecomputeHook : NoHook {
  static constexpr bool kHvToAct = true;
  bf16* ws;
  uint32_t* masks;
  size_t ldp;
  bool dense;  // a view direction per point: the view embedding's rows too
  __device__ __forceinline__ void after_embed(const unsigned char* emb, const unsigned char* embv,
                                              int p0) const {
    store_rows_sw<kStream>(emb, KE, ws + size_t(WsRows<W>::e) * ldp, ldp, nullptr, p0);
    if (dense)
      store_rows_sw<kStream>(embv, KV, ws + size_t(WsRows<W>::ev) * ldp, ldp, nullptr, p0);
  }
  // l: h0..h7 (0..7), feat (8) or hv (9)
  __device__ __forceinline__ void after_layer(int l, const unsigned char* act, int p0) const {
    using R = WsRows<W>;
    using M = MaskRows<W>;
    const int r0 = l < 8 ? R::h(l) : l == 8 ? R::feat : R::hv;
    uint32_t* m = l == 8 ? nullptr : masks + size_t(l < 8 ? M::h(l) : M::hv) * ldp;
    store_rows_sw<kStream>(act, l == 9 ? W / 2 : W, ws + size_t(r0) * ldp, ldp, m, p0);
  }
};

// The recompute's sink when raw is not asked for: the head's sums are dead
// code, and the compiler drops them.
struct NoSink {
  __device__ __forceinline__ void operator()(int, int, float) const {}
};

// The bf16 recompute: K1's (K2's) tile over the n_pts points and the
// padding up to whole tiles, its rows and masks written by RecomputeHook,
// raw (planes or rows, as GlobalSink) only where raw is given (kRaw). Walk
// as K1's: TileWalk, or SceneWalk in the stacked K4 (a net per scene).
template <typename In, int W, bool kRaw, typename Walk>
__global__ void __launch_bounds__(FWD_THREADS, 1)
bwd_recompute_sm90(const __grid_constant__ FwdMaps maps, const In in, int n_pts, int Fp, int Fv,
                   const bf16* __restrict__ wb, const float* __restrict__ bb, bf16* ws,
                   uint32_t* masks, size_t ldp, float* raw, size_t sc, size_t sp,
                   const Walk walk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RecomputeHook<W, !kRaw> hook{{}, ws, masks, ldp, in.spr == 1};
  if constexpr (kRaw)
    fwd_tiles_sm90<In, W>(maps, in, n_pts, Fp, Fv, wb, bb, smem, GlobalSink{raw, sc, sp}, walk,
                          hook);
  else
    fwd_tiles_sm90<In, W>(maps, in, n_pts, Fp, Fv, wb, bb, smem, NoSink(), walk, hook);
}

// ------------------------------------------------ the chain on the wgmma tile

// The chain's four weight maps (hopper::encode_rows_sw128 over the bf16
// blob of TLayout<W>, boxes of 64 K columns). kp's own [in][out] layout is
// the K-major B tile [N = in][K = out] of a product d W^T:
//   trunk  W1..W7, Wf, contiguous as [8W][W], boxes of W rows;
//   wvf    Wvf [W][W/2], boxes of W rows (d_feat, K = W/2);
//   e05    W0e, W5e, contiguous as [2 x 64][W], boxes of 64 rows (d_e,
//          N = KE);
//   wve    Wve [32][W/2], boxes of 64 rows (d_ev): rows 32..63 lie past the
//          map's edge and TMA fills them with zeros, so d_ev runs as
//          m64n64k16 with its upper 32 columns zero rather than as a
//          product of its own width (hopper.cuh has no m64n32).
struct ChainMaps {
  CUtensorMap trunk, wvf, e05, wve;
};

// Over `scenes` chain blobs one after another (the stacked K4), each map
// runs on through the later scenes' blobs, as encode_fwd_maps' do.
template <int W>
cudaError_t encode_chain_maps(ChainMaps* maps, const bf16* wt, int scenes = 1) {
  using T = TLayout<W>;
  const long long more = scenes - 1;  // blobs past the first
  cudaError_t err =
      hopper::encode_rows_sw128(&maps->trunk, wt + T::wi(1), more * (T::size / W) + 8 * W, W, W);
  if (err == cudaSuccess)
    err = hopper::encode_rows_sw128(&maps->wvf, wt + T::wvf, more * (T::size / (W / 2)) + W,
                                    W / 2, W);
  if (err == cudaSuccess)
    err = hopper::encode_rows_sw128(&maps->e05, wt + T::w0e, more * (T::size / W) + 2 * KE, W,
                                    KE);
  if (err == cudaSuccess)
    err = hopper::encode_rows_sw128(&maps->wve, wt + T::wve, more * (T::size / (W / 2)) + KV,
                                    W / 2, 64);
  return err;
}

// The chain's shared memory: fwd_tile_sm90.cuh's weight ring and act blocks
// (a consumer warpgroup's cotangent, 64 points x W, K-major and 128-byte
// swizzled: wgmma's A operand, rewritten in place by each layer's
// epilogue), each warpgroup's g ([64][4] f32, and rounded to bf16), its
// four warps' bias column sums ([4][W] f32) and its points' mask words of
// the layer in flight, the ring's barriers. The input
// grads stage their f32 d_ev / d_e rows in act (LDV, LDE: odd strides, a
// thread a row without bank conflicts, wide enough for the embeddings'
// used columns).
template <int W>
struct ChainSmem {
  using F = FwdSmem<W>;
  static constexpr int NB = F::NB;
  static constexpr size_t BLOCK = F::BLOCK, STAGE = F::STAGE;
  static constexpr size_t ring = 0;
  static constexpr size_t act = ring + FWD_STAGES * STAGE;      // [2 wg][NB][BLOCK]
  static constexpr size_t gs = act + 2 * NB * BLOCK;             // [2 wg][64][4]
  static constexpr size_t gcs = gs + 2 * FWD_ROWS * 4 * 4;       // [2 wg][64][4]
  static constexpr size_t red = gcs + 2 * FWD_ROWS * 4 * 4;      // [2 wg][4][W]
  static constexpr int MLD = W / 32 + 1;  // a point's mask words, padded: no bank conflicts
  static constexpr size_t msk = red + 2 * 4 * size_t(W) * 4;     // [2 wg][64][MLD] u32
  static constexpr size_t bars = msk + 2 * FWD_ROWS * MLD * 4;   // full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bars + 2 * FWD_STAGES * sizeof(uint64_t);
  static constexpr size_t launch_bytes = bytes + 1024;  // the base is aligned up to 1 KB
  static constexpr int LDV = KV - 1, LDE = KE - 1;
  static_assert(3 + 6 * MAX_FV <= LDV && 3 + 6 * MAX_FP <= LDE, "the used columns are staged");
  static_assert(size_t(FWD_ROWS) * LDV * 4 <= (NB - NB / 2) * BLOCK, "d_ev's rows fit past d_hv's");
  static_assert(size_t(FWD_ROWS) * LDE * 4 <= NB * BLOCK, "d_e's rows fit in act");
  static_assert(launch_bytes <= 232448, "fits in an SM's shared memory");
};

// A consumer warpgroup's m64nN fragment (hopper.cuh): its thread t holds
// acc[4*jb + 2*h + e] at row 16*(t/32) + (t%32)/4 + 8*h and column 8*jb +
// 2*(t%4) + e. The relu mask of column c of a row is bit c % 32 of the row's
// word c / 32, so the pair at 8*jb + 2*(t%4) is bits 8*(jb%4) + 2*(t%4) and
// + 1 of word jb / 4.

// The mask words of one layer's output (rows m of MaskRows, ldp points a
// row) for the warpgroup's 64 points from p0, N/32 words a point, to its
// msk [64][MLD] by cp.async (4 bytes a copy, consecutive threads on
// consecutive points), so that their latency hides under the layer's
// products and no register holds them until the epilogue reads them;
// mask_wait makes them visible once a barrier follows.
template <int W, int N>
__device__ __forceinline__ void copy_mask_words(const uint32_t* __restrict__ m, size_t ldp, int p0,
                                                uint32_t* msk) {
  constexpr int MLD = ChainSmem<W>::MLD;
  for (int idx = threadIdx.x & 127; idx < FWD_ROWS * (N / 32); idx += 128) {
    const int i = idx & (FWD_ROWS - 1), k = idx / FWD_ROWS;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     hopper::smem_addr(msk + i * MLD + k)),
                 "l"(m + size_t(k) * ldp + p0 + i)
                 : "memory");
  }
  cp_async_commit();
}

__device__ __forceinline__ void mask_wait() { cp_async_wait<0>(); }

// This thread's two rows of the warpgroup's rounded g (gcs, [64][4]).
__device__ __forceinline__ void gc_rows(const float* gcs, float (&gc)[2][4]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = 16 * warp + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 q = *reinterpret_cast<const float4*>(gcs + (r + 8 * h) * 4);
    gc[h][0] = q.x;
    gc[h][1] = q.y;
    gc[h][2] = q.z;
    gc[h][3] = q.w;
  }
}

// d_hv before its mask, gc . Wout[:W/2][c] (fmaf over the 4 channels from
// zero, the order of nerf_tpu's rank-4 product), for exactly the elements
// of an m64n(W/2) fragment.
template <int W>
__device__ __forceinline__ void dhv_fragment(const float* gcs, const bf16* __restrict__ wout,
                                             float (&acc)[W / 4]) {
  const int t = threadIdx.x & 3;
  float gc[2][4];
  gc_rows(gcs, gc);
#pragma unroll
  for (int jb = 0; jb < W / 16; ++jb) {
    float w0[4], w1[4];
    wout_row(wout, 8 * jb + 2 * t, w0);
    wout_row(wout, 8 * jb + 2 * t + 1, w1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d0 = fmaf(gc[h][k], w0[k], d0);
        d1 = fmaf(gc[h][k], w1[k], d1);
      }
      acc[4 * jb + 2 * h] = d0;
      acc[4 * jb + 2 * h + 1] = d1;
    }
  }
}

// One step of a reduce-scatter over the 8 lanes that share a fragment's
// columns: the lanes 0 and 1 of bit OFF keep halves lo = cs[0, H) and hi =
// cs[H, 2H) of their sums and add the partner's same half.
template <int S, int H, int OFF>
__device__ __forceinline__ void halve_sums(float (&cs)[S]) {
  const bool up = threadIdx.x & OFF;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float lo = cs[k], hi = cs[k + H];
    cs[k] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
  }
}

// A chain layer's epilogue over a consumer warpgroup's m64nN fragment, in
// place of the layer's A operand: d = acc (+ gc . Wout[W/2 + c] with kH7,
// as that sum from zero, then added), zeroed where the forward activation
// was not positive (kMask: the words in msk, copy_mask_words', read a word
// a row for every 4 jb); d in f32 to f32out [64][N] where given (d_hv for
// ray_prep); d rounded to bf16 into out (act's blocks, epilogue_sw's 4-byte
// swizzled stores); and d's f32 column sums over the warpgroup's 64
// points: the thread's two rows, then the 8 lanes that share its columns
// by a reduce-scatter (xor 16, 8, 4: 7N/32 shuffles a thread rather than
// 3N/4), each lane left with N/32 columns, written to its warp's row of red
// [4][W]. reduce_bias sums the four rows.
template <int W, int N, bool kMask, bool kH7>
__device__ __forceinline__ void chain_epilogue(const float (&acc)[N / 2], const uint32_t* msk,
                                               const float* gcs, const bf16* __restrict__ wout_h7,
                                               float* f32out, unsigned char* out, float* red) {
  constexpr int MLD = ChainSmem<W>::MLD;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int sw = lane >> 2, t = lane & 3;  // sw: the rows' % 8, the swizzle's XOR
  const int r0 = 16 * warp + sw;
  const uint32_t row0 = hopper::smem_addr(out) + r0 * 128 + (t << 2);
  const uint32_t mrow = hopper::smem_addr(msk) + r0 * MLD * 4;  // row r0's words; + 8 rows
  float gc[2][4];
  if (kH7) gc_rows(gcs, gc);
  float cs[N / 4];
#pragma unroll
  for (int jq = 0; jq < N / 32; ++jq) {
    uint32_t words[2] = {0u, 0u};
    if (kMask) {
      words[0] = ld_shared_b32(mrow + jq * 4);
      words[1] = ld_shared_b32(mrow + 8 * MLD * 4 + jq * 4);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int jb = 4 * jq + jj, col = 8 * jb + 2 * t;
      const uint32_t blk = row0 + (jb >> 3) * (FWD_ROWS * 128) + (((jb & 7) ^ sw) << 4);
      float w0[4], w1[4];
      if (kH7) {
        wout_row(wout_h7, col, w0);
        wout_row(wout_h7, col + 1, w1);
      }
      float v[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0 = acc[4 * jb + 2 * h], x1 = acc[4 * jb + 2 * h + 1];
        if (kH7) {
          float e0 = 0.f, e1 = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            e0 = fmaf(gc[h][k], w0[k], e0);
            e1 = fmaf(gc[h][k], w1[k], e1);
          }
          x0 += e0;
          x1 += e1;
        }
        if (kMask) {
          const uint32_t bits = words[h] >> (8 * jj + 2 * t);
          if (!(bits & 1u)) x0 = 0.f;
          if (!(bits & 2u)) x1 = 0.f;
        }
        if (f32out != nullptr)
          *reinterpret_cast<float2*>(f32out + size_t(r0 + 8 * h) * N + col) = make_float2(x0, x1);
        const __nv_bfloat162 q = __floats2bfloat162_rn(x0, x1);
        st_shared_b32(blk + h * 8 * 128, *reinterpret_cast<const uint32_t*>(&q));
        v[h][0] = x0;
        v[h][1] = x1;
      }
      cs[2 * jb] = v[0][0] + v[1][0];
      cs[2 * jb + 1] = v[0][1] + v[1][1];
    }
  }
  halve_sums<N / 4, N / 8, 16>(cs);
  halve_sums<N / 4, N / 16, 8>(cs);
  halve_sums<N / 4, N / 32, 4>(cs);
#pragma unroll
  for (int k = 0; k < N / 32; ++k) {  // sum slot s = 2 * jb + e of the lane's
    const int s = k + (N / 32) * sw;
    red[warp * W + 8 * (s >> 1) + 2 * t + (s & 1)] = cs[k];
  }
}

// bsum[c] = the warpgroup's column sums in red [4][W], c < n, in warp order.
template <int W>
__device__ __forceinline__ void reduce_bias(const float* red, int n, float* __restrict__ bsum) {
  for (int c = threadIdx.x & 127; c < n; c += 128)
    bsum[c] = ((red[c] + red[W + c]) + red[2 * W + c]) + red[3 * W + c];
}

// out[row][c] = acc (f32, stride ld, the columns c < ld) from an m64n64
// fragment: the input grads' d_ev / d_e rows, which a thread then reads
// whole.
__device__ __forceinline__ void stage_fragment(const float (&acc)[32], float* out, int ld) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 8 * jb + 2 * t + (q & 1);
      if (c < ld) out[(r0 + 8 * (q >> 1)) * ld + c] = acc[4 * jb + q];
    }
}

// The chain's producer thread: every tile's weight chunks by TMA, in the
// consumers' order (fwd_producer's ring and barriers): with a direction
// per point and dv, Wve's W/128 chunks (d_ev); Wvf's W/128 (d_feat); Wf's
// and W7's .. W1's W/64 each (d_h7 .. d_h0); with dx, W0e's and W5e's W/64
// each (d_e).
template <int W, typename Walk>
__device__ __forceinline__ void chain_producer(const ChainMaps& maps, int ntiles, bool dense_dv,
                                               bool with_dx, unsigned char* ring, uint64_t* full,
                                               uint64_t* empty, const Walk& walk) {
  using L = ChainSmem<W>;
  using T = TLayout<W>;
  constexpr int NB = L::NB;
  static_assert(T::size % W == 0, "a scene's chain blob is whole rows of every map");
  uint32_t g = 0;
  auto load = [&](const CUtensorMap* map, int x, int y, int rows) {
    const uint32_t s = g % FWD_STAGES;
    if (g >= FWD_STAGES) hopper::mbar_wait(&empty[s], ((g / FWD_STAGES) - 1) & 1);
    hopper::mbar_arrive_expect_tx(&full[s], uint32_t(rows) * 128);
    hopper::tma_load_2d(ring + s * L::STAGE, map, &full[s], x, y);
    ++g;
  };
  for (int tile = walk.first(); tile < ntiles; tile = walk.next(tile)) {
    const int sc = walk.scene();  // the rows of the tile's scene
    const int yw = sc * int(T::size / W), yh = sc * int(T::size / (W / 2));
    if (dense_dv)
      for (int j = 0; j < NB / 2; ++j) load(&maps.wve, KC * j, yh, 64);
    for (int j = 0; j < NB / 2; ++j) load(&maps.wvf, KC * j, yh, W);
    for (int l = 8; l >= 1; --l)
      for (int j = 0; j < NB; ++j) load(&maps.trunk, KC * j, yw + (l - 1) * W, W);
    if (with_dx)
      for (int y = 0; y < 2 * KE; y += KE)
        for (int j = 0; j < NB; ++j) load(&maps.e05, KC * j, yw + y, KE);
  }
}

// One consumer warpgroup (w = 0 or 1) of the chain over the CTA's tiles:
// its 64 points of each, p0 on. A layer is fwd_consumer's: the products
// over the A operand in act in the warpgroup's turn (take_turn /
// pass_turn), then, while they run, the previous layer's output rows from
// act to the workspace (store_rows_sw) and its bias sums from red to the
// tile's partial (reduce_bias), then finish_layer and the epilogue in
// place. The bias partials are per warpgroup, bpart row 2 * tile + w: a
// sum across the two warpgroups would need a barrier between them, which
// the ping-pong cannot afford; reduce_tiles sums the rows in a fixed order.
template <typename In, int W, typename Walk>
__device__ __forceinline__ void chain_consumer(
    const In& in, const float* __restrict__ g, size_t gsc, size_t gsp, int n_pts, int Fp, int Fv,
    const bf16* __restrict__ wb, bf16* ws, const uint32_t* __restrict__ masks, size_t ldp,
    float* dhv32, float* bpart, float* dx, float* dv, int ntiles, unsigned char* smem,
    uint64_t* full, uint64_t* empty, int w, const Walk& walk) {
  using L = ChainSmem<W>;
  using O = Layout<W>;
  using R = WsRows<W>;
  using M = MaskRows<W>;
  constexpr int NB = L::NB, H = W / 2;
  unsigned char* act = smem + L::act + w * NB * L::BLOCK;
  float* gs = reinterpret_cast<float*>(smem + L::gs) + w * FWD_ROWS * 4;
  float* gcs = reinterpret_cast<float*>(smem + L::gcs) + w * FWD_ROWS * 4;
  float* red = reinterpret_cast<float*>(smem + L::red) + w * 4 * W;
  // the tile's Wout (SceneWalk: its scene's, taken afresh where used)
  auto wout = [&]() { return wb + size_t(walk.scene()) * O::size + O::wout; };
  const int bar = 1 + w, t = threadIdx.x & 127;
  const bool dense_dv = in.spr == 1 && dv != nullptr;
  FwdRing r{smem + L::ring, L::STAGE, full, empty, 0};
  auto rows = [&](int r0) { return ws + size_t(r0) * ldp; };
  auto mrows = [&](int m0) { return masks + size_t(m0) * ldp; };
  uint32_t* msk = reinterpret_cast<uint32_t*>(smem + L::msk) + w * FWD_ROWS * L::MLD;
  if (w == 1) pass_turn(w);  // warpgroup 0 goes first
  for (int tile = walk.first(); tile < ntiles; tile = walk.next(tile)) {
    const int p0 = tile * TP + w * FWD_ROWS;
    float* bsum = bpart + size_t(2 * tile + w) * O::nbias;
    if (t < FWD_ROWS) {  // the points' g, zero past n_pts; gc to its rows
      const int p = p0 + t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = p < n_pts ? g[c * gsc + size_t(p) * gsp] : 0.f;
        const bf16 vc = __float2bfloat16_rn(v);
        gs[t * 4 + c] = v;
        gcs[t * 4 + c] = __bfloat162float(vc);
        rows(R::gc + c)[p] = vc;
      }
    }
    {
      // (every read of msk and act of the last tile came before a barrier)
      copy_mask_words<W, H>(mrows(M::hv), ldp, p0, msk);
      mask_wait();
      hopper::bar_sync(bar, 128);
      if (t < 4) {
        float s = 0.f;
        for (int i = 0; i < FWD_ROWS; ++i) s += gs[i * 4 + t];
        bsum[O::bout + t] = s;
      }
      // d_hv = (gc Wout[:W/2]^T) * (hv > 0): f32 to dhv32 (a direction per ray)
      float acc[H / 2];
      dhv_fragment<W>(gcs, wout(), acc);
      chain_epilogue<W, H, true, false>(acc, msk, gcs, nullptr,
                                        in.spr == 1 ? nullptr : dhv32 + size_t(p0) * H, act, red);
    }
    if (dense_dv) {  // d_ev = bf16(d_hv) Wve^T, then dv through the view trig
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      float acc[32];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) consume_chunk<64>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);
      store_rows_sw(act, H, rows(R::dhv), ldp, nullptr, p0);
      reduce_bias<W>(red, H, bsum + O::bv);
      finish_layer(r, bar);
      float* d_ev = reinterpret_cast<float*>(act + NB / 2 * L::BLOCK);  // past d_hv
      stage_fragment(acc, d_ev, L::LDV);
      hopper::bar_sync(bar, 128);
      input_grad(in, false, Fv, d_ev, L::LDV, n_pts, p0, FWD_ROWS, dv, t);
    }
    {  // d_feat = bf16(d_hv) Wvf^T (the feature layer has no activation)
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      float acc[W / 2];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) consume_chunk<W>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);
      if (!dense_dv) {
        store_rows_sw(act, H, rows(R::dhv), ldp, nullptr, p0);
        reduce_bias<W>(red, H, bsum + O::bv);
      }
      finish_layer(r, bar);
      chain_epilogue<W, W, false, false>(acc, msk, gcs, nullptr, nullptr, act, red);
    }
    // l = 8: d_h7 = (bf16(d_feat) Wf^T + gc Wout[W/2:]^T) * (h7 > 0); then
    // l = 7..1: d_h_{l-1} = (bf16(d_h_l) W_l^T) * (h_{l-1} > 0). The rows of
    // act (d_feat = WsRows' d(8), then d_h_l) go to row d(l), their bias
    // sums to l * W (bf = 8W).
#pragma unroll 1
    for (int l = 8; l >= 1; --l) {
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      copy_mask_words<W, W>(mrows(M::h(l - 1)), ldp, p0, msk);  // after the last epilogue's reads
      float acc[W / 2];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB; ++j) consume_chunk<W>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);
      store_rows_sw(act, W, rows(R::d(l)), ldp, nullptr, p0);
      reduce_bias<W>(red, W, bsum + l * W);
      mask_wait();
      finish_layer(r, bar);
      if (l == 8)
        chain_epilogue<W, W, true, true>(acc, msk, gcs, wout() + H * 4, nullptr, act, red);
      else
        chain_epilogue<W, W, true, false>(acc, msk, gcs, nullptr, nullptr, act, red);
    }
    if (dx != nullptr) {  // d_e = [d0 | d5] [W0e | W5e]^T: d0 in act, d5 back from its rows
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      float acc[32];
      zero_regs(acc);
      take_turn(w);
#pragma unroll
      for (int j = 0; j < NB; ++j) consume_chunk<64>(r, acc, act + j * L::BLOCK, j == 0);
      pass_turn(w);  // d5's chunks come after the turn: see take_turn
      store_rows_sw(act, W, rows(R::d(0)), ldp, nullptr, p0);
      reduce_bias<W>(red, W, bsum);
      finish_layer(r, bar);
      load_rows_sw(act, W, rows(R::d(5)), ldp, p0);
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
#pragma unroll
      for (int j = 0; j < NB; ++j) consume_chunk<64>(r, acc, act + j * L::BLOCK, j == 0);
      finish_layer(r, bar);
      float* d_e = reinterpret_cast<float*>(act);
      stage_fragment(acc, d_e, L::LDE);
      hopper::bar_sync(bar, 128);
      input_grad(in, true, Fp, d_e, L::LDE, n_pts, p0, FWD_ROWS, dx, t);
    } else {
      hopper::bar_sync(bar, 128);
      store_rows_sw(act, W, rows(R::d(0)), ldp, nullptr, p0);
      reduce_bias<W>(red, W, bsum);
    }
    // the next tile's first writes to gs, act and red follow its first barrier
  }
  if (w == 0) take_turn(w);  // warpgroup 1's last pass_turn
}

// The bf16 cotangent chain (phase 1b) over the n_pts points and the padding
// up to whole tiles, after the recompute (bwd_recompute_sm90) has written
// the tiles' rows and mask words: fwd_tile_sm90.cuh's CTA of 384 threads
// (a TMA producer warpgroup, two ping-pong wgmma consumer warpgroups) on
// a persistent grid in the walk's order (TileWalk, or SceneWalk in the
// stacked K4: a net per scene). dx, and with a direction per point dv, only
// where the pointer is given.
template <typename In, int W, typename Walk>
__global__ void __launch_bounds__(FWD_THREADS, 1)
bwd_chain_sm90(const __grid_constant__ ChainMaps maps, const In in, const float* __restrict__ g,
               size_t gsc, size_t gsp, int n_pts, int Fp, int Fv, const bf16* __restrict__ wb,
               bf16* ws, const uint32_t* __restrict__ masks, size_t ldp, float* dhv32,
               float* bpart, float* dx, float* dv, const Walk walk) {
  using L = ChainSmem<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
      chain_producer<W>(maps, ntiles, in.spr == 1 && dv != nullptr, dx != nullptr,
                        smem + L::ring, full, empty, walk);
  } else {
    hopper::setmaxnreg_inc<FWD_CONSUMER_REGS>();
    chain_consumer<In, W>(in, g, gsc, gsp, n_pts, Fp, Fv, wb, ws, masks, ldp, dhv32, bpart, dx,
                          dv, ntiles, smem, full, empty, wg - 1, walk);
  }
}

// ----------------------------------------------------------------- f32 path

template <int W> struct BwdSmem32 {
  static constexpr int lda = W + 1, lde = KE + 1, ldv = KV + 1;
  static constexpr size_t a = 0;
  static constexpr size_t b = a + size_t(TP32) * lda * 4;
  static constexpr size_t emb = b + size_t(TP32) * lda * 4;
  static constexpr size_t embv = emb + size_t(TP32) * lde * 4;
  static constexpr size_t gs = embv + size_t(TP32) * ldv * 4;
  static constexpr size_t bytes = gs + size_t(TP32) * 4 * 4;
};

// out[i][n] = X[i] . Bw[n] (+ X2[i] . Bw2[n] when X2 is given) for the
// tile's 64 rows (no bias, no activation); Bw, Bw2 are [N][K] rows in global
// memory.
__device__ void dense_t_f32(const float* X, int ldx, int K, const float* __restrict__ Bw, int N,
                            float* out, int ldo, const float* X2 = nullptr,
                            const float* __restrict__ Bw2 = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < N; n += THREADS / 32) {
    float a0 = 0.f, a1 = 0.f;
    const float* w = Bw + size_t(n) * K;
    for (int k = 0; k < K; ++k) {
      const float wk = __ldg(w + k);
      a0 = fmaf(X[lane * ldx + k], wk, a0);
      a1 = fmaf(X[(lane + 32) * ldx + k], wk, a1);
    }
    if (X2 != nullptr) {
      const float* w2 = Bw2 + size_t(n) * K;
      for (int k = 0; k < K; ++k) {
        const float wk = __ldg(w2 + k);
        a0 = fmaf(X2[lane * ldx + k], wk, a0);
        a1 = fmaf(X2[(lane + 32) * ldx + k], wk, a1);
      }
    }
    out[lane * ldo + n] = a0;
    out[(lane + 32) * ldo + n] = a1;
  }
}

// In place: buf[i][c] (+ gs[i] . wout_h7[c] when given), zeroed where the
// forward activation in `mask` (workspace rows) is not positive.
__device__ void mask_f32(float* buf, int ld, int N, const float* mask, size_t ldp, int p0,
                         const float* gs, const float* __restrict__ wout_h7) {
  for (int idx = threadIdx.x; idx < TP32 * N; idx += THREADS) {
    const int c = idx / TP32, i = idx - c * TP32;
    float v = buf[i * ld + c];
    if (wout_h7 != nullptr) {
      float e = 0.f;
      for (int k = 0; k < 4; ++k) e = fmaf(gs[i * 4 + k], wout_h7[c * 4 + k], e);
      v += e;
    }
    if (!(mask[size_t(c) * ldp + p0 + i] > 0.f)) v = 0.f;
    buf[i * ld + c] = v;
  }
}

__device__ void colsum_f32(const float* buf, int ld, int N, float* __restrict__ bsum) {
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < TP32; ++i) s += buf[i * ld + c];
    bsum[c] = s;
  }
}

// One tile a CTA; tile t reads the nets of scene t / tiles_per_scene (the
// stacked K4's blobs; one net: a tiles_per_scene beyond the grid).
template <typename In, int W>
__global__ void __launch_bounds__(THREADS)
bwd_tile_f32(const In in, const float* __restrict__ g, size_t gsc, size_t gsp, int n_pts,
             int Fp, int Fv, const float* __restrict__ wb_all, const float* __restrict__ wt_all,
             const float* __restrict__ bb_all, float* ws, size_t ldp, float* dhv32, float* bpart,
             float* dx, float* dv, int tiles_per_scene) {
  using L = BwdSmem32<W>;
  using O = Layout<W>;
  using T = TLayout<W>;
  using R = WsRows<W>;
  const int scene = blockIdx.x / tiles_per_scene;
  const float* __restrict__ wb = wb_all + size_t(scene) * O::size;
  const float* __restrict__ wt = wt_all + size_t(scene) * T::size;
  const float* __restrict__ bb = bb_all + size_t(scene) * O::nbias;
  extern __shared__ __align__(16) unsigned char smem[];
  float* A = reinterpret_cast<float*>(smem + L::a);
  float* B = reinterpret_cast<float*>(smem + L::b);
  float* emb = reinterpret_cast<float*>(smem + L::emb);
  float* embv = reinterpret_cast<float*>(smem + L::embv);
  float* gs = reinterpret_cast<float*>(smem + L::gs);
  constexpr int lda = L::lda;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP32;
  const bool dense = in.spr == 1;
  float* bsum = bpart + size_t(blockIdx.x) * O::nbias;
  auto row = [&](int r) { return ws + size_t(r) * ldp; };

  embed_tile<float>(in, n_pts, Fp, Fv, p0, TP32, emb, L::lde, embv, L::ldv);
  __syncthreads();
  store_t(emb, L::lde, KE, TP32, row(R::e), ldp, p0);
  if (dense) store_t(embv, L::ldv, KV, TP32, row(R::ev), ldp, p0);
  dense_f32(emb, L::lde, KE, wb + O::w05, nullptr, 0, 0, nullptr, bb, W, A, lda, true);
  __syncthreads();
  store_t(A, lda, W, TP32, row(R::h(0)), ldp, p0);
  float* src = A;
  float* dst = B;
  for (int i = 1; i < 8; ++i) {
    const bool skip = i == 5;
    dense_f32(src, lda, W, wb + O::wi(i), skip ? emb : nullptr, L::lde, skip ? KE : 0,
              wb + O::w05 + size_t(W) * KE, bb + i * W, W, dst, lda, true);
    __syncthreads();
    store_t(dst, lda, W, TP32, row(R::h(i)), ldp, p0);
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  // src = h7
  dense_f32(src, lda, W, wb + O::wf, nullptr, 0, 0, nullptr, bb + O::bf, W, dst, lda, false);
  __syncthreads();
  store_t(dst, lda, W, TP32, row(R::feat), ldp, p0);
  // dst = feat; the view layer writes hv over h7
  dense_f32(dst, lda, W, wb + O::wvf, embv, L::ldv, KV, wb + O::wve, bb + O::bv, W / 2, src,
            lda, true);
  __syncthreads();
  store_t(src, lda, W / 2, TP32, row(R::hv), ldp, p0);

  if (tid < TP32) {
    const int p = p0 + tid;
    for (int c = 0; c < 4; ++c) {
      const float v = p < n_pts ? g[c * gsc + size_t(p) * gsp] : 0.f;
      gs[tid * 4 + c] = v;
      row(R::gc + c)[p0 + tid] = v;
    }
  }
  __syncthreads();
  if (tid < 4) {
    float s = 0.f;
    for (int i = 0; i < TP32; ++i) s += gs[i * 4 + tid];
    bsum[O::bout + tid] = s;
  }
  // d_hv = (g Wout[:W/2]^T) * (hv > 0) -> dst (feat is in the workspace)
  for (int idx = tid; idx < TP32 * (W / 2); idx += THREADS) {
    const int i = idx / (W / 2), c = idx - i * (W / 2);
    float d = 0.f;
    for (int k = 0; k < 4; ++k) d = fmaf(gs[i * 4 + k], wb[O::wout + c * 4 + k], d);
    if (!(src[i * lda + c] > 0.f)) d = 0.f;
    dst[i * lda + c] = d;
    if (!dense) dhv32[size_t(p0 + i) * (W / 2) + c] = d;
  }
  __syncthreads();
  colsum_f32(dst, lda, W / 2, bsum + O::bv);
  store_t(dst, lda, W / 2, TP32, row(R::dhv), ldp, p0);
  if (dense && dv != nullptr) {  // d_ev = d_hv Wve^T per point -> emb (spent), then the trig
    dense_t_f32(dst, lda, W / 2, wt + T::wve, KV, emb, L::lde);
    __syncthreads();
    input_grad(in, false, Fv, emb, L::lde, n_pts, p0, TP32, dv, tid);
  }
  dense_t_f32(dst, lda, W / 2, wt + T::wvf, W, src, lda);  // d_feat -> src
  __syncthreads();
  colsum_f32(src, lda, W, bsum + O::bf);
  store_t(src, lda, W, TP32, row(R::dfeat), ldp, p0);
  dense_t_f32(src, lda, W, wt + T::wf, W, dst, lda);  // d_h7 -> dst
  __syncthreads();
  mask_f32(dst, lda, W, row(R::h(7)), ldp, p0, gs, wb + O::wout + size_t(W / 2) * 4);
  __syncthreads();
  colsum_f32(dst, lda, W, bsum + 7 * W);
  store_t(dst, lda, W, TP32, row(R::d(7)), ldp, p0);
  float* cur = dst;
  float* oth = src;
  for (int i = 7; i >= 1; --i) {
    dense_t_f32(cur, lda, W, wt + T::wi(i), W, oth, lda);
    __syncthreads();
    mask_f32(oth, lda, W, row(R::h(i - 1)), ldp, p0, nullptr, nullptr);
    __syncthreads();
    colsum_f32(oth, lda, W, bsum + (i - 1) * W);
    store_t(oth, lda, W, TP32, row(R::d(i - 1)), ldp, p0);
    float* tmp = cur;
    cur = oth;
    oth = tmp;
  }
  if (dx != nullptr) {  // d_e = [d0 | d5] W05e^T -> emb (d0 in cur, d5 back from the workspace)
    load_t(row(R::d(5)), ldp, p0, W, TP32, oth, lda);
    __syncthreads();
    dense_t_f32(cur, lda, W, wt + T::w0e, KE, emb, L::lde, oth, wt + T::w5e);
    __syncthreads();
    input_grad(in, true, Fp, emb, L::lde, n_pts, p0, TP32, dx, tid);
  }
}

// ------------------------------------------------------- per-ray view terms

// Per ray r: dhv_ray[c][r] = sum over the ray's samples of d_hv (f32, in
// sample order, then rounded to T) and ev[k][r] = the view embedding; zero
// for the padded rays. With dv given, also d_ev = dhv_ray Wve^T (wve: Wve
// [KV][W/2], T layout) and dv[r] through the view trig. One block per ray,
// one thread per column.
template <typename T, int W>
__global__ void ray_prep(const float* __restrict__ vd, const float* __restrict__ dhv32,
                         int n_rays, int S, int Fv, T* rws, size_t rpad,
                         const T* __restrict__ wve, float* __restrict__ dv) {
  constexpr int H = W / 2;
  __shared__ float dsum[H];
  __shared__ float d_ev[KV];
  const int r = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  if (r < n_rays)
    for (int j = 0; j < S; ++j) s += dhv32[(size_t(r) * S + j) * H + c];
  const T sc = from_f<T>(s);
  rws[size_t(KV + c) * rpad + r] = sc;
  const float x[3] = {r < n_rays ? vd[r * 3] : 0.f, r < n_rays ? vd[r * 3 + 1] : 0.f,
                      r < n_rays ? vd[r * 3 + 2] : 0.f};
  if (c == 0) {
    T ev[KV];
    embed_row<T>(x, Fv, KV, ev);
    for (int k = 0; k < KV; ++k) rws[size_t(k) * rpad + r] = r < n_rays ? ev[k] : from_f<T>(0.f);
  }
  if (dv == nullptr) return;  // the same for the whole grid
  dsum[c] = to_f(sc);
  __syncthreads();
  if (c < KV) {
    float a = 0.f;
    for (int j = 0; j < H; ++j) a = fmaf(dsum[j], to_f(wve[c * H + j]), a);
    d_ev[c] = a;
  }
  __syncthreads();
  if (c == 0 && r < n_rays) {
    float d[3];
    embed_row_backward(x, Fv, d_ev, d);
#pragma unroll
    for (int k = 0; k < 3; ++k) dv[size_t(r) * 3 + k] = d[k];
  }
}

// ---------------------------------------------------------------- host side

size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// A launch's geometry and workspace: n_pts points, a view direction per
// spr of them (dense: spr = 1, a direction per point; else one per ray).
// Phase 1 writes a partial of the bias grads per BIAS_PART points (a tile
// of the f32 path, a consumer warpgroup's half tile of the bf16 chain). The
// stacked K4 takes `scenes` such sets of points one after another, each
// whole tiles and whole 64-ray columns of the per-ray rows: the counts
// below are the launch's, n_pad_s and rpad_s a scene's, and every scene's
// products split as one scene's alone would (split_len, nsplit).
struct Plan {
  int tile, n_pts, n_pad, ntiles, nbpart, n_rays, rpad, split_len, nsplit;
  int scenes, n_pad_s, rpad_s;
  bool dense;
  size_t ws, masks, rws, dhv, bpart, wpart, total;  // byte offsets / sizes
  cudaError_t err;  // the card's answer on the weight-grad launch's clusters
};

template <typename T, int W>
Probs make_probs(const Plan& pl, const T* ws, const T* rws, float* wpart, int split_len);

constexpr int BIAS_PART = 64;  // points a bias-grad partial sums
static_assert(TP32 == BIAS_PART && TP == 2 * FWD_ROWS && FWD_ROWS == BIAS_PART,
              "a partial per f32 tile and per bf16 consumer warpgroup");
// Points a split sums in one f32 accumulator chain, in 64-point chunks. The
// chain's rounding grows with its length: 11 splits of 71,552 points at the
// fine level of a training step put K4's worst bf16 leaf 8x further from
// its plain version than 64 splits of 12,288 (PERF.md).
constexpr int MAX_SPLIT_CHUNKS = 256;

// Splits of the bf16 weight-grad launch for `tiles` CTAs a split over
// nchunks 64-point chunks, in clusters of cl CTAs of which the card holds
// `slots` CTAs at once (wgrad_slots): at most 64 (the partials' memory), at
// least enough for MAX_SPLIT_CHUNKS a split where 64 allow it, and at least
// 8 chunks a split; within that the least s whose grid (whole clusters)
// fills its waves over the slots to 95%, else the fullest. The shapes and
// the card fix it, so two launches sum in the same order.
// ops/fused_mlp_wide.py's hopper_splits is the same.
int hopper_splits(int tiles, int nchunks, int cl, int slots) {
  const int smin = min(64, (nchunks + MAX_SPLIT_CHUNKS - 1) / MAX_SPLIT_CHUNKS);
  const int smax = max(smin, min(64, nchunks / 8));
  int best = smin;
  double best_fill = 0.0;
  for (int s = smin; s <= smax; ++s) {
    const int ctas = (tiles * s + cl - 1) / cl * cl;
    const double fill = double(ctas) / (double((ctas + slots - 1) / slots) * slots);
    if (fill >= 0.95) return s;
    if (fill > best_fill) {
      best_fill = fill;
      best = s;
    }
  }
  return best;
}

// n_pts: the points of a scene (of the launch with scenes = 1).
template <typename T, int W>
Plan make_plan(int n_pts, int spr, int scenes = 1) {
  Plan p{};
  p.tile = sizeof(T) == 2 ? TP : TP32;
  p.scenes = scenes;
  p.n_pts = n_pts;
  p.dense = spr == 1;
  p.n_pad = (p.n_pts + p.tile - 1) / p.tile * p.tile;
  p.ntiles = p.n_pad / p.tile;
  p.nbpart = p.n_pad / BIAS_PART;
  p.n_rays = n_pts / spr;
  p.rpad = p.dense ? 0 : (p.n_rays + 63) / 64 * 64;  // the per-ray rows of ray_prep
  p.n_pad_s = p.n_pad;
  p.rpad_s = p.rpad;
  const int nchunks = p.n_pad / 64;
  int target;
  if (sizeof(T) == 2) {  // the CTAs a split over the points (the per-ray problem aside)
    const Probs one = make_probs<T, W>(p, nullptr, nullptr, nullptr, p.n_pad);
    int tiles = 0, cl = 1, slots = 0;
    for (int i = 0; i < one.count; ++i) {
      if (one.p[i].src == 0) tiles += one.p[i].mtiles * one.p[i].ntiles;
      cl = max(cl, one.p[i].mc * one.p[i].nc);
    }
    p.err = wgrad_slots(cl, &slots);
    if (p.err != cudaSuccess) return p;
    target = hopper_splits(tiles, nchunks, cl, slots);
  } else {
    target = max(1, min(64, p.n_pad / 8192));
  }
  p.split_len = (nchunks + target - 1) / target * 64;
  p.nsplit = (p.n_pad + p.split_len - 1) / p.split_len;
  // the launch's counts: scenes x a scene's (its points are whole tiles)
  p.n_pts *= scenes;
  p.n_pad *= scenes;
  p.ntiles *= scenes;
  p.nbpart *= scenes;
  p.n_rays *= scenes;
  p.rpad *= scenes;
  size_t o = 0;
  p.ws = o;
  o += align256(size_t(WsRows<W>::rows) * p.n_pad * sizeof(T));
  p.masks = o;  // the bf16 path's mask words (the f32 chain reads the rows)
  o += sizeof(T) == 2 ? align256(size_t(MaskRows<W>::rows) * p.n_pad * 4) : 0;
  p.rws = o;
  o += align256(size_t(KV + W / 2) * p.rpad * sizeof(T));
  p.dhv = o;
  o += p.dense ? 0 : align256(size_t(p.n_pad) * (W / 2) * 4);
  p.bpart = o;
  o += align256(size_t(p.nbpart) * Layout<W>::nbias * 4);
  p.wpart = o;
  o += align256(size_t(scenes) * p.nsplit * GLayout<W>::size * 4);
  p.total = o;
  return p;
}

// The 14 weight-grad products. bf16: 128 x 256 tiles of C (at most one
// N-tile at the tile's widths) in clusters (cluster_shape); f32: 64 x 64
// tiles.
template <typename T, int W>
Probs make_probs(const Plan& pl, const T* ws, const T* rws, float* wpart, int split_len) {
  using R = WsRows<W>;
  using G = GLayout<W>;
  constexpr bool hop = sizeof(T) == 2;
  Probs P;
  P.count = 0;
  P.split_len = split_len;
  P.split_stride = G::size;
  P.scene_stride = size_t(pl.nsplit) * G::size;
  int cta = 0;
  auto add = [&](int src, int k_len, int ra, int M, int rb, int N, size_t coff, int ldc) {
    const T* base = src ? rws : ws;
    const size_t ld = src ? pl.rpad : pl.n_pad;
    Prob& q = P.p[P.count++];
    q.A = base == nullptr ? nullptr : base + size_t(ra) * ld;
    q.B = base == nullptr ? nullptr : base + size_t(rb) * ld;
    q.C = wpart == nullptr ? nullptr : wpart + coff;
    q.M = M;
    q.N = N;
    q.lda = int(ld);
    q.ldc = ldc;
    q.k_len = k_len;
    q.ra = ra;
    q.rb = rb;
    q.src = src;
    q.mtiles = (M + (hop ? GM : FM) - 1) / (hop ? GM : FM);
    q.ntiles = (N + (hop ? GN : FM) - 1) / (hop ? GN : FM);
    q.mc = q.nc = 1;
    if (hop) cluster_shape(M, N, &q.mc, &q.nc);
    q.nsplit = (k_len + split_len - 1) / split_len;
    q.cta0 = cta;
    cta += q.mtiles * q.ntiles * q.nsplit;
  };
  const int K = pl.n_pad_s;  // a scene's columns
  add(0, K, R::e, KE, R::d(0), W, G::w05, 2 * W);      // dW05e[:, :W]
  add(0, K, R::e, KE, R::d(5), W, G::w05 + W, 2 * W);  // dW05e[:, W:]
  for (int i = 1; i < 8; ++i) add(0, K, R::h(i - 1), W, R::d(i), W, G::wi(i), W);
  add(0, K, R::h(7), W, R::dfeat, W, G::wf, W);
  add(0, K, R::feat, W, R::dhv, W / 2, G::wvf, W / 2);
  add(0, K, R::hv, W / 2, R::gc, 4, G::wout, 4);                       // dWout[:W/2]
  add(0, K, R::h(7), W, R::gc, 4, G::wout + size_t(W / 2) * 4, 4);  // dWout[W/2:]
  if (pl.dense)  // dWve = ev^T bf16(d_hv) over points
    add(0, K, R::ev, KV, R::dhv, W / 2, G::wve, W / 2);
  else  // over rays, from ray_prep's rows
    add(1, pl.rpad_s, 0, KV, KV, W / 2, G::wve, W / 2);
  P.p[P.count].cta0 = cta;  // one past the last problem: the grid size
  return P;
}

#define NERF_CHECK(x)                        \
  do {                                       \
    cudaError_t e_ = (x);                    \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

// The bf16 recompute's launch: the forward blob's four tensor maps and a
// persistent grid of min(tiles, SMs) CTAs, as K1's; raw (sink strides sc,
// sp) only where raw is given. With scenes > 1 (the stacked K4 and K3, no
// raw) a net per scene, as the stacked K1's and K2's.
template <typename In, int W>
cudaError_t launch_recompute(const In& in, int n_pts, int Fp, int Fv, const bf16* wb,
                             const float* bb, bf16* ws, uint32_t* masks, size_t ldp, float* raw,
                             size_t sc, size_t sp, cudaStream_t s, int scenes = 1) {
  FwdMaps maps;
  NERF_CHECK(encode_fwd_maps<W>(&maps, wb, scenes));
  constexpr size_t smem = FwdSmem<W>::launch_bytes;
  int dev = 0, sms = 0;
  NERF_CHECK(cudaGetDevice(&dev));
  NERF_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int tiles = (n_pts + TP - 1) / TP;
  const int grid = tiles < sms ? tiles : sms;
  if (scenes > 1) {  // the stacked K4's (rays) and K3's (points): no raw
    if (raw != nullptr) return cudaErrorInvalidValue;
    const auto kernel = bwd_recompute_sm90<In, W, false, SceneWalk>;
    NERF_CHECK(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
    kernel<<<scene_grid(tiles / scenes, scenes, sms), FWD_THREADS, smem, s>>>(
        maps, in, n_pts, Fp, Fv, wb, bb, ws, masks, ldp, raw, sc, sp, SceneWalk{tiles / scenes});
    return cudaGetLastError();
  }
  const auto kernel = raw != nullptr ? bwd_recompute_sm90<In, W, true, TileWalk>
                                     : bwd_recompute_sm90<In, W, false, TileWalk>;
  NERF_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  kernel<<<grid, FWD_THREADS, smem, s>>>(maps, in, n_pts, Fp, Fv, wb, bb, ws, masks, ldp, raw, sc,
                                         sp, TileWalk());
  return cudaGetLastError();
}

// The chain's launch: its four tensor maps over the chain blob wt and a
// persistent grid of min(tiles, SMs) CTAs, as the recompute's. setmaxnreg
// moves registers within the pool the CTA got at launch: a smaller pool
// than the two roles ask for would stall the consumers, so it is refused.
template <typename In, int W, typename Walk>
cudaError_t launch_chain_walk(const ChainMaps& maps, const In& in, const float* g, size_t gsc,
                              size_t gsp, int n_pts, int Fp, int Fv, const bf16* wb, bf16* ws,
                              const uint32_t* masks, size_t ldp, float* dhv32, float* bpart,
                              float* dx, float* dv, const Walk& walk, dim3 grid, cudaStream_t s) {
  constexpr size_t smem = ChainSmem<W>::launch_bytes;
  const auto kernel = bwd_chain_sm90<In, W, Walk>;
  NERF_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  cudaFuncAttributes fa;
  NERF_CHECK(cudaFuncGetAttributes(&fa, kernel));
  if (fa.numRegs * FWD_THREADS < 128 * FWD_PRODUCER_REGS + 256 * FWD_CONSUMER_REGS)
    return cudaErrorInvalidConfiguration;
  kernel<<<grid, FWD_THREADS, smem, s>>>(maps, in, g, gsc, gsp, n_pts, Fp, Fv, wb, ws, masks, ldp,
                                         dhv32, bpart, dx, dv, walk);
  return cudaGetLastError();
}

// With scenes > 1 (the stacked K4 and K3) a net per scene: wb and wt hold a
// blob per scene, one after another, and the walk is SceneWalk.
template <typename In, int W>
cudaError_t launch_chain(const In& in, const float* g, size_t gsc, size_t gsp, int n_pts, int Fp,
                         int Fv, const bf16* wb, const bf16* wt, bf16* ws, const uint32_t* masks,
                         size_t ldp, float* dhv32, float* bpart, float* dx, float* dv,
                         cudaStream_t s, int scenes = 1) {
  ChainMaps maps;
  NERF_CHECK(encode_chain_maps<W>(&maps, wt, scenes));
  int dev = 0, sms = 0;
  NERF_CHECK(cudaGetDevice(&dev));
  NERF_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int tiles = (n_pts + TP - 1) / TP;
  const int grid = tiles < sms ? tiles : sms;
  if (scenes > 1)  // the stacked K4's (rays) and K3's (points)
    return launch_chain_walk<In, W>(maps, in, g, gsc, gsp, n_pts, Fp, Fv, wb, ws, masks, ldp,
                                    dhv32, bpart, dx, dv, SceneWalk{tiles / scenes},
                                    scene_grid(tiles / scenes, scenes, sms), s);
  return launch_chain_walk<In, W>(maps, in, g, gsc, gsp, n_pts, Fp, Fv, wb, ws, masks, ldp, dhv32,
                                  bpart, dx, dv, TileWalk(), grid, s);
}

// n_pts: a scene's points (the launch's with scenes = 1). With scenes > 1
// (the stacked K4 and K3: no input grads) the blobs hold a net per scene, one
// after another, and out a grad set per scene.
template <typename T, int W, typename In>
cudaError_t run(const In& in, const float* g, size_t gsc, size_t gsp, int n_pts, int Fp, int Fv,
                const void* wblob, const void* wtblob, const float* bblob, void* workspace,
                long long ws_bytes, float* out, float* dx, float* dv, cudaStream_t s,
                int scenes) {
  const Plan pl = make_plan<T, W>(n_pts, in.spr, scenes);
  NERF_CHECK(pl.err);
  if (scenes > 1 && (pl.n_pad_s != n_pts || (!pl.dense && pl.rpad_s * in.spr != n_pts) ||
                     dx != nullptr || dv != nullptr))
    return cudaErrorInvalidValue;  // a scene's points: whole tiles and 64-ray columns
  if (ws_bytes < 0 || size_t(ws_bytes) < pl.total) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(workspace);
  T* ws = reinterpret_cast<T*>(base + pl.ws);
  T* rws = reinterpret_cast<T*>(base + pl.rws);
  float* dhv32 = reinterpret_cast<float*>(base + pl.dhv);
  float* bpart = reinterpret_cast<float*>(base + pl.bpart);
  float* wpart = reinterpret_cast<float*>(base + pl.wpart);
  const T* wb = static_cast<const T*>(wblob);
  const T* wt = static_cast<const T*>(wtblob);
  const size_t ldp = pl.n_pad;

  NERF_CHECK(cudaMemsetAsync(wpart, 0, size_t(scenes) * pl.nsplit * GLayout<W>::size * 4, s));
  if (sizeof(T) == 2) {
    uint32_t* masks = reinterpret_cast<uint32_t*>(base + pl.masks);
    NERF_CHECK((launch_recompute<In, W>(in, pl.n_pts, Fp, Fv, reinterpret_cast<const bf16*>(wb),
                                        bblob, reinterpret_cast<bf16*>(ws), masks, ldp, nullptr,
                                        0, 0, s, scenes)));
    NERF_CHECK((launch_chain<In, W>(in, g, gsc, gsp, pl.n_pts, Fp, Fv,
                                    reinterpret_cast<const bf16*>(wb),
                                    reinterpret_cast<const bf16*>(wt), reinterpret_cast<bf16*>(ws),
                                    masks, ldp, dhv32, bpart, dx, dv, s, scenes)));
  } else {
    const size_t smem = BwdSmem32<W>::bytes;
    NERF_CHECK(cudaFuncSetAttribute(bwd_tile_f32<In, W>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
    bwd_tile_f32<In, W><<<pl.ntiles, THREADS, smem, s>>>(
        in, g, gsc, gsp, pl.n_pts, Fp, Fv, reinterpret_cast<const float*>(wb),
        reinterpret_cast<const float*>(wt), bblob, reinterpret_cast<float*>(ws), ldp, dhv32,
        bpart, dx, dv, pl.ntiles / scenes);
  }
  NERF_CHECK(cudaGetLastError());
  if (!pl.dense) {
    ray_prep<T, W><<<pl.rpad, W / 2, 0, s>>>(in.v, dhv32, pl.n_rays, in.spr, Fv, rws,
                                            size_t(pl.rpad), wt + TLayout<W>::wve, dv);
    NERF_CHECK(cudaGetLastError());
  }
  Probs P = make_probs<T, W>(pl, ws, rws, wpart, pl.split_len);
  if (sizeof(T) == 2) {
    // the workspace rows and ray_prep's per-ray rows as TMA tensor maps:
    // boxes of 64 points x 64 rows (8 rows for dWout's gc), 128-byte swizzle
    CUtensorMap ws_map, ws8_map, rws_map;
    static_assert(TP % 64 == 0, "n_pad * 2 bytes is a multiple of 128: a legal TMA row stride");
    NERF_CHECK(hopper::encode_rows_sw128(&ws_map, ws, WsRows<W>::rows, pl.n_pad, 64));
    NERF_CHECK(hopper::encode_rows_sw128(&ws8_map, ws, WsRows<W>::rows, pl.n_pad, 8));
    if (pl.dense)
      rws_map = ws_map;  // no per-ray rows: no problem reads this map
    else
      NERF_CHECK(hopper::encode_rows_sw128(&rws_map, rws, KV + W / 2, pl.rpad, 64));
    NERF_CHECK(launch_wgrad_bf16(ws_map, ws8_map, rws_map, P, scenes, s));
  } else {
    wgrad_f32<<<dim3(P.p[P.count].cta0, scenes), THREADS, 0, s>>>(P);
  }
  NERF_CHECK(cudaGetLastError());
  const size_t gw = GLayout<W>::size;
  const int nb = Layout<W>::nbias;
  reduce_splits<<<dim3(unsigned((gw + 255) / 256), scenes), 256, 0, s>>>(wpart, pl.nsplit, gw,
                                                                         out, gw + nb);
  NERF_CHECK(cudaGetLastError());
  reduce_tiles<<<dim3((nb + 31) / 32, scenes), 256, 0, s>>>(bpart, pl.nbpart / scenes, nb,
                                                            out + gw, gw + nb);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch(int use_bf16, int width, const In& in, const float* g, size_t gsc,
                     size_t gsp, int n_pts, int Fp, int Fv, const void* wblob,
                     const void* wtblob, const float* bblob, void* workspace, long long ws_bytes,
                     float* out, float* dx, float* dv, void* stream, int scenes = 1) {
  if (Fp < 1 || Fp > MAX_FP || Fv < 1 || Fv > MAX_FV) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_ARGS in, g, gsc, gsp, n_pts, Fp, Fv, wblob, wtblob, bblob, workspace, ws_bytes, out, \
                  dx, dv, s, scenes
  if (use_bf16) {
    if (width == 256) return run<bf16, 256>(NERF_ARGS);
    if (width == 128) return run<bf16, 128>(NERF_ARGS);
  } else {
    if (width == 256) return run<float, 256>(NERF_ARGS);
    if (width == 128) return run<float, 128>(NERF_ARGS);
  }
#undef NERF_ARGS
  return cudaErrorInvalidValue;
}

// n_pts points in views of spr points each
bool valid_shape(long long n_pts, int spr) {
  return n_pts >= 1 && spr >= 1 && n_pts % spr == 0 && n_pts <= 0x7fffffffLL - 256;
}

// The recompute launch alone into ws and masks at ldp = n_pts rounded up
// to whole tiles (nerf_fused_mlp_bwd_recompute*); with scenes > 1 a net per
// scene (SceneWalk), n_pts the launch's points.
template <typename In>
int recompute_only(int width, const In& in, int n_pts, int Fp, int Fv, const void* wblob,
                   const float* bblob, void* ws, void* masks, float* raw, size_t sc, size_t sp,
                   void* stream, int scenes = 1) {
  if (Fp < 1 || Fp > MAX_FP || Fv < 1 || Fv > MAX_FV) return cudaErrorInvalidValue;
  const size_t ldp = (size_t(n_pts) + TP - 1) / TP * TP;
  const bf16* wb = static_cast<const bf16*>(wblob);
  bf16* w = static_cast<bf16*>(ws);
  uint32_t* m = static_cast<uint32_t*>(masks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 256)
    return launch_recompute<In, 256>(in, n_pts, Fp, Fv, wb, bblob, w, m, ldp, raw, sc, sp, s,
                                     scenes);
  if (width == 128)
    return launch_recompute<In, 128>(in, n_pts, Fp, Fv, wb, bblob, w, m, ldp, raw, sc, sp, s,
                                     scenes);
  return cudaErrorInvalidValue;
}

// The recompute and the chain alone (nerf_fused_mlp_bwd_chain*), into ws,
// masks, dhv32 and bpart at ldp = n_pts rounded up to whole tiles.
template <typename In>
int chain_only(int width, const In& in, const float* g, size_t gsc, size_t gsp, int n_pts, int Fp,
               int Fv, const void* wblob, const void* wtblob, const float* bblob, void* ws,
               void* masks, float* dhv32, float* bpart, float* dx, float* dv, void* stream) {
  if (Fp < 1 || Fp > MAX_FP || Fv < 1 || Fv > MAX_FV) return cudaErrorInvalidValue;
  const size_t ldp = (size_t(n_pts) + TP - 1) / TP * TP;
  const bf16* wb = static_cast<const bf16*>(wblob);
  const bf16* wt = static_cast<const bf16*>(wtblob);
  bf16* w = static_cast<bf16*>(ws);
  uint32_t* m = static_cast<uint32_t*>(masks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 256) {
    NERF_CHECK((launch_recompute<In, 256>(in, n_pts, Fp, Fv, wb, bblob, w, m, ldp, nullptr, 0, 0, s)));
    return launch_chain<In, 256>(in, g, gsc, gsp, n_pts, Fp, Fv, wb, wt, w, m, ldp, dhv32, bpart, dx,
                                 dv, s);
  }
  if (width == 128) {
    NERF_CHECK((launch_recompute<In, 128>(in, n_pts, Fp, Fv, wb, bblob, w, m, ldp, nullptr, 0, 0, s)));
    return launch_chain<In, 128>(in, g, gsc, gsp, n_pts, Fp, Fv, wb, wt, w, m, ldp, dhv32, bpart, dx,
                                 dv, s);
  }
  return cudaErrorInvalidValue;
}

int workspace_bytes(int use_bf16, int width, int n_pts, int spr, long long* bytes,
                    int scenes = 1) {
  Plan p;
  if (use_bf16 && width == 256) p = make_plan<bf16, 256>(n_pts, spr, scenes);
  else if (use_bf16 && width == 128) p = make_plan<bf16, 128>(n_pts, spr, scenes);
  else if (!use_bf16 && width == 256) p = make_plan<float, 256>(n_pts, spr, scenes);
  else if (!use_bf16 && width == 128) p = make_plan<float, 128>(n_pts, spr, scenes);
  else return cudaErrorInvalidValue;
  if (p.err != cudaSuccess) return p.err;
  *bytes = static_cast<long long>(p.total);
  return cudaSuccess;
}

// The stacked shape: S scenes of R rays and N samples, a scene's R*N points
// whole tiles and R whole 64-ray columns of the per-ray rows.
bool valid_stacked(int n_scenes, int rays_per_scene, int n_samples) {
  const long long per = static_cast<long long>(rays_per_scene) * n_samples;
  return n_scenes >= 1 && rays_per_scene >= 64 && rays_per_scene % 64 == 0 &&
         valid_shape(per * n_scenes, n_samples) && per % TP == 0;
}

// The stacked points shape: S scenes of P points in views of spr, a scene's
// P points whole tiles and, with a direction per ray (spr > 1), its P / spr
// views whole 64-ray columns of the per-ray rows.
bool valid_stacked_points(int n_scenes, int pts_per_scene, int spr) {
  return n_scenes >= 1 && pts_per_scene >= TP && pts_per_scene % TP == 0 &&
         valid_shape(static_cast<long long>(pts_per_scene) * n_scenes, spr) &&
         pts_per_scene % spr == 0 && (spr == 1 || (pts_per_scene / spr) % 64 == 0);
}

}  // namespace

// Bytes of device workspace that nerf_fused_mlp_bwd (K4) needs for this shape.
extern "C" int nerf_fused_mlp_bwd_workspace(int use_bf16, int width, int n_rays, int n_samples,
                                            long long* bytes) {
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (!valid_shape(n, n_samples)) return cudaErrorInvalidValue;
  return workspace_bytes(use_bf16, width, int(n), n_samples, bytes);
}

// Bytes of device workspace that nerf_fused_mlp_bwd_points (K3) needs.
extern "C" int nerf_fused_mlp_bwd_points_workspace(int use_bf16, int width, int n_pts, int spr,
                                                   long long* bytes) {
  if (!valid_shape(n_pts, spr)) return cudaErrorInvalidValue;
  return workspace_bytes(use_bf16, width, n_pts, spr, bytes);
}

// Both entries return a cudaError_t code (0 on success). The launches go on
// `stream` and do not synchronise; all buffers are device pointers, float32
// unless noted: wblob (bf16 if use_bf16 else f32) and bblob as the forward
// takes them; wtblob the same dtype in TLayout; workspace of the matching
// *_workspace bytes; out the f32 grads in GLayout followed by the bias grads.

// K4: rays_o, rays_d, viewdirs [R,3]; z [R,S]; g, the cotangent of K1's
// output, [4,R,S].
extern "C" int nerf_fused_mlp_bwd(int use_bf16, int width, const float* rays_o,
                                  const float* rays_d, const float* viewdirs, const float* z,
                                  const float* g, int n_rays, int n_samples, int n_freq_pts,
                                  int n_freq_views, const void* wblob, const void* wtblob,
                                  const float* bblob, void* workspace, long long ws_bytes,
                                  float* out, void* stream) {
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (!valid_shape(n, n_samples)) return cudaErrorInvalidValue;
  const RaysIn in{rays_o, rays_d, z, viewdirs, n_samples};
  return dispatch(use_bf16, width, in, g, size_t(n), 1, int(n), n_freq_pts, n_freq_views, wblob,
                  wtblob, bblob, workspace, ws_bytes, out, nullptr, nullptr, stream);
}

// Bytes of device workspace that nerf_fused_mlp_bwd_stacked needs for this
// shape: n_scenes x K4's at R = rays_per_scene, and a set of weight-grad
// partials per scene.
extern "C" int nerf_fused_mlp_bwd_stacked_workspace(int use_bf16, int width, int n_scenes,
                                                    int rays_per_scene, int n_samples,
                                                    long long* bytes) {
  if (!valid_stacked(n_scenes, rays_per_scene, n_samples)) return cudaErrorInvalidValue;
  return workspace_bytes(use_bf16, width, rays_per_scene * n_samples, n_samples, bytes, n_scenes);
}

// The stacked K4 of multi-scene training, one launch of each of its phases
// for S scenes (the vmap over scenes of nerf_tpu's make_multi_scene_step
// gives _make_bwd_kernel_rays a scene axis, nerf_tpu/parallel/multi_scene.py:
// 44-64): rays and z as nerf_fused_mlp_fwd_stacked takes them, g [4][S*R*N]
// (the cotangent of its planes); wblob and bblob [S][...] as there, wtblob
// [S][TLayout size]; out [S][GLayout size + nbias], each scene's grads as
// K4's. The recompute and the chain walk every scene's tiles in one launch
// each (SceneWalk: each tile the weights of its scene), phase 2 runs on all
// S*R rays, and the weight-grad launch takes S times K4's problems (a grid
// axis), each summing its scene's columns only, split as K4's at R rays
// would split them: each scene's grads are then K4's on its rays alone, bit
// for bit. Bound at S = 8, N_rand 1024, 64 + 192 samples: 8 x K4's at
// N_rand 1024, 7.39 ms at 989 TFLOP/s (3,484,416 FLOP a point, 2,097,152
// points), by operations; its phases alone are bound by bytes (the
// recompute 3.30 ms, the chain 3.55, the weight grads 6.18 at 3.35 TB/s).
extern "C" int nerf_fused_mlp_bwd_stacked(int use_bf16, int width, const float* rays_o,
                                          const float* rays_d, const float* viewdirs,
                                          const float* z, const float* g, int n_scenes,
                                          int rays_per_scene, int n_samples, int n_freq_pts,
                                          int n_freq_views, const void* wblob,
                                          const void* wtblob, const float* bblob,
                                          void* workspace, long long ws_bytes, float* out,
                                          void* stream) {
  if (!valid_stacked(n_scenes, rays_per_scene, n_samples)) return cudaErrorInvalidValue;
  const int per = rays_per_scene * n_samples;
  const RaysIn in{rays_o, rays_d, z, viewdirs, n_samples};
  return dispatch(use_bf16, width, in, g, size_t(per) * n_scenes, 1, per, n_freq_pts,
                  n_freq_views, wblob, wtblob, bblob, workspace, ws_bytes, out, nullptr, nullptr,
                  stream, n_scenes);
}

// Bytes of device workspace that nerf_fused_mlp_bwd_points_stacked needs:
// n_scenes x K3's at N = pts_per_scene, and a set of weight-grad partials
// per scene.
extern "C" int nerf_fused_mlp_bwd_points_stacked_workspace(int use_bf16, int width, int n_scenes,
                                                           int pts_per_scene, int spr,
                                                           long long* bytes) {
  if (!valid_stacked_points(n_scenes, pts_per_scene, spr)) return cudaErrorInvalidValue;
  return workspace_bytes(use_bf16, width, pts_per_scene, spr, bytes, n_scenes);
}

// The stacked K3 of multi-scene training, one launch of each of its phases
// for S scenes (the vmap over scenes of nerf_tpu's make_multi_scene_step
// gives _make_bwd_kernel a scene axis, nerf_tpu/parallel/multi_scene.py:
// 44-64), weight grads only (the renderer's points carry no gradient): x, v
// and the nets as nerf_fused_mlp_fwd_points_stacked takes them, wtblob
// [S][TLayout size]; g [S*P][4], the cotangent of its rows; out [S][GLayout
// size + nbias], each scene's grads as K3's. The stacked K4's launches in
// points mode: the recompute and the chain walk every scene's tiles
// (SceneWalk), phase 2 (a direction per ray) runs on all S*P/spr views, and
// the weight-grad launch takes S times K3's problems, each split as K3's at
// P points would split them: each scene's grads are then K3's on its points
// alone, bit for bit. Bound at S = 8, N_rand 1024, 63 + 191 samples, a
// direction per point (2,080,768 points): 7.35 ms at 989 TFLOP/s (3,484,416
// FLOP a point and 6,912 a view), by operations.
extern "C" int nerf_fused_mlp_bwd_points_stacked(int use_bf16, int width, const float* x,
                                                 const float* v, const float* g, int n_scenes,
                                                 int pts_per_scene, int spr, int n_freq_pts,
                                                 int n_freq_views, const void* wblob,
                                                 const void* wtblob, const float* bblob,
                                                 void* workspace, long long ws_bytes, float* out,
                                                 void* stream) {
  if (!valid_stacked_points(n_scenes, pts_per_scene, spr)) return cudaErrorInvalidValue;
  const PointsIn in{x, v, spr};
  return dispatch(use_bf16, width, in, g, 1, 4, pts_per_scene, n_freq_pts, n_freq_views, wblob,
                  wtblob, bblob, workspace, ws_bytes, out, nullptr, nullptr, stream, n_scenes);
}

// K3: x [N,3]; v [N/spr,3], point p looking along v[p / spr]; g, the
// cotangent of K2's output, [N,4]; dx [N,3] and dv [N/spr,3] both given
// (input grads) or both null (their branch is skipped).
extern "C" int nerf_fused_mlp_bwd_points(int use_bf16, int width, const float* x, const float* v,
                                         const float* g, int n_pts, int spr, int n_freq_pts,
                                         int n_freq_views, const void* wblob, const void* wtblob,
                                         const float* bblob, void* workspace, long long ws_bytes,
                                         float* out, float* dx, float* dv, void* stream) {
  if (!valid_shape(n_pts, spr) || (dx == nullptr) != (dv == nullptr))
    return cudaErrorInvalidValue;
  const PointsIn in{x, v, spr};
  return dispatch(use_bf16, width, in, g, 1, 4, n_pts, n_freq_pts, n_freq_views, wblob, wtblob,
                  bblob, workspace, ws_bytes, out, dx, dv, stream);
}

// The bf16 recompute alone, K4's and K3's first launch, for a check of what
// it writes: ws [WsRows<W>::rows][n_pad] bf16 and masks
// [MaskRows<W>::rows][n_pad] u32 (n_pad: the points rounded up to 128), and
// raw where raw is not null. Rays mode: raw as planes [4][R*S], as K1's.
extern "C" int nerf_fused_mlp_bwd_recompute(int width, const float* rays_o, const float* rays_d,
                                            const float* viewdirs, const float* z, int n_rays,
                                            int n_samples, int n_freq_pts, int n_freq_views,
                                            const void* wblob, const float* bblob, void* ws,
                                            void* masks, float* raw, void* stream) {
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (!valid_shape(n, n_samples)) return cudaErrorInvalidValue;
  const RaysIn in{rays_o, rays_d, z, viewdirs, n_samples};
  return recompute_only(width, in, int(n), n_freq_pts, n_freq_views, wblob, bblob, ws, masks, raw,
                        size_t(n), 1, stream);
}

// Points mode (K3's): x [N,3], v [N/spr,3]; raw as rows [N][4], as K2's.
extern "C" int nerf_fused_mlp_bwd_recompute_points(int width, const float* x, const float* v,
                                                   int n_pts, int spr, int n_freq_pts,
                                                   int n_freq_views, const void* wblob,
                                                   const float* bblob, void* ws, void* masks,
                                                   float* raw, void* stream) {
  if (!valid_shape(n_pts, spr)) return cudaErrorInvalidValue;
  const PointsIn in{x, v, spr};
  return recompute_only(width, in, n_pts, n_freq_pts, n_freq_views, wblob, bblob, ws, masks, raw,
                        1, 4, stream);
}

// The stacked K3's recompute alone (multi-scene training's points mode):
// x [S*P,3], v [S*P/spr,3] and the nets as nerf_fused_mlp_fwd_points_stacked
// takes them (P a scene's points, whole tiles); ws and masks as
// nerf_fused_mlp_bwd_recompute's over all S*P points, scene s's columns
// [s*P, (s+1)*P). raw must be null: the stacked launch writes none.
extern "C" int nerf_fused_mlp_bwd_recompute_points_stacked(int width, const float* x,
                                                           const float* v, int n_scenes,
                                                           int pts_per_scene, int spr,
                                                           int n_freq_pts, int n_freq_views,
                                                           const void* wblob, const float* bblob,
                                                           void* ws, void* masks, float* raw,
                                                           void* stream) {
  if (!valid_stacked_points(n_scenes, pts_per_scene, spr)) return cudaErrorInvalidValue;
  const PointsIn in{x, v, spr};
  return recompute_only(width, in, pts_per_scene * n_scenes, n_freq_pts, n_freq_views, wblob,
                        bblob, ws, masks, raw, 1, 4, stream, n_scenes);
}

// The bf16 recompute and cotangent chain alone, K4's and K3's first two
// launches, for a check of what the chain writes: ws and masks as
// nerf_fused_mlp_bwd_recompute's (the chain's rows gc, d0..d7, d_feat,
// d_hv beside the recompute's), dhv32 [n_pad][W/2] f32 (written with a
// direction per ray), bpart [n_pad / 64][nbias] f32 (each 64 points' bias
// sums). Rays mode: g planes [4][R*S], as K4's.
extern "C" int nerf_fused_mlp_bwd_chain(int width, const float* rays_o, const float* rays_d,
                                        const float* viewdirs, const float* z, const float* g,
                                        int n_rays, int n_samples, int n_freq_pts,
                                        int n_freq_views, const void* wblob, const void* wtblob,
                                        const float* bblob, void* ws, void* masks, float* dhv32,
                                        float* bpart, void* stream) {
  const long long n = static_cast<long long>(n_rays) * n_samples;
  if (!valid_shape(n, n_samples)) return cudaErrorInvalidValue;
  const RaysIn in{rays_o, rays_d, z, viewdirs, n_samples};
  return chain_only(width, in, g, size_t(n), 1, int(n), n_freq_pts, n_freq_views, wblob, wtblob,
                    bblob, ws, masks, dhv32, bpart, nullptr, nullptr, stream);
}

// Points mode (K3's): g rows [N][4]; dx [N][3] where given, and dv
// [N][3] where also given at spr = 1 (at spr > 1 phase 2 computes dv).
extern "C" int nerf_fused_mlp_bwd_chain_points(int width, const float* x, const float* v,
                                               const float* g, int n_pts, int spr, int n_freq_pts,
                                               int n_freq_views, const void* wblob,
                                               const void* wtblob, const float* bblob, void* ws,
                                               void* masks, float* dhv32, float* bpart, float* dx,
                                               float* dv, void* stream) {
  if (!valid_shape(n_pts, spr) || (dv != nullptr && (dx == nullptr || spr != 1)))
    return cudaErrorInvalidValue;
  const PointsIn in{x, v, spr};
  return chain_only(width, in, g, 1, 4, n_pts, n_freq_pts, n_freq_views, wblob, wtblob, bblob, ws,
                    masks, dhv32, bpart, dx, dv, stream);
}

// The last bf16 weight-grad launch of this library (K4's, K3's or K6's
// phase 3): its cluster size, grid x and y, and problem count, into
// out[0..3].
extern "C" void nerf_wgrad_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = last_wgrad_launch()[i];
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
