// Weight gradient of the stride-2 stem convolution, for Hopper (sm_90a).
//
// Replaces segtpu/ops/conv_wgrad.py::stem_conv_wgrad (the Pallas TPU
// kernel). It computes dW (k, k, C, CO), fp32, of a k x k, stride-2,
// pad p = k//2 (pt rows above, any below), bias-free NHWC convolution:
//
//   dW[kh, kw, c, o] = sum_{n, ho, wo} x[n, 2ho - pt + kh, 2wo - p + kw, c]
//                                       * dy[n, ho, wo, o]
//
// from x (N, H, W, C) and dy (N, Ho, Wo, CO), both bf16, with every
// product summed in fp32; x rows outside [0, H) read as zero. pt is p for
// the whole image; a band of an image sharded over H carries its halo rows
// in x and takes pt = 0 (or p at the image's top).
//
// What bounds it: memory. At the main path's shape (x 8x769x769x3, dy
// 8x385x385x64, k=3) it must read x (28.4 MB) and dy (151.8 MB) once,
// about 180 MB: 54 us at 3.35 TB/s. Its 4.1 GFLOP take about 4 us on the
// tensor cores (22.3 GFLOP, 23 us, at k=7).
//
// Design. As a product, dW^T (o x taps) = dy^T (o x pixels) . xcol
// (pixels x taps), contracted over the N*Ho*Wo output pixels.
//   * a tile is up to kTileP = 64 output pixels of one output row (n, ho)
//     and kTileO = 64 output channels; a row of Wo pixels is
//     ceil(Wo / 64) tiles, the last one short. The grid is (row blocks,
//     tap groups, o tiles); a row block walks a contiguous range of tiles
//     in order, so the input rows that consecutive output rows share are
//     read again from L2, not from memory;
//   * a tap group is a box of taps: kr rows kh, kc columns kw and cs
//     channels c (the launch plan, stem_wgrad_plan in
//     segtpu_torch/ops/conv_wgrad.py, picks it), at most 32 * NT taps;
//   * warp specialised: four consumer warps multiply, one producer warp
//     copies. The tiles pass through a ring of `stages` slots in dynamic
//     shared memory, handed between the two roles by mbarriers: full[s]
//     (the producer's copies have landed) and empty[s] (the consumers'
//     products have read the slot);
//   * per tile, the tile's dy (64 pixels x 64 o, bf16) comes by TMA: one
//     copy of a box of a 3-d tensor map over (CO, Wo, N*Ho) in the 128-byte
//     swizzle (16-byte chunk j of pixel row r at chunk j ^ (r % 8)), zeros
//     past Wo and past CO, its bytes counted on full[s]. Where CO * 2 is no
//     multiple of 16 (or dy not 16-byte aligned) no tensor map can describe
//     dy, and the producer loads it by 2 bytes into the same layout. For
//     each of the box's kr tap rows, the producer stages the input row's
//     columns the tile reads. With `span` those are all C channels of
//     2*63 + kc columns, copied as they lie from the 16-byte boundary at or
//     before their start by cp.async (the row's start is only 2-byte
//     aligned and its stride no multiple of 16, so no tensor map can
//     describe it; the offset into the copy is kept), whose completion
//     arrives on full[s]; without it (C too wide for a span to fit), the
//     box's cs channels are gathered by 2-byte loads. Rows outside the image
//     are staged as zeros;
//   * products on the tensor cores, mma.sync.m16n8k16 bf16 -> fp32, M = o,
//     N = taps, K = pixels: A = dy^T from the staged tile by ldmatrix.trans
//     (o is the contiguous axis, so the tile's rows read as dy^T's
//     columns), B = the x columns gathered from the staged rows: pixel
//     p's value of tap (kh, kw, c) lies at column 2p + kw of row kh, so a
//     B register pairs two 2-byte loads. Columns left or right of the
//     image and pixels past the row's end are zeros in B, by select, not
//     in memory. Each of the four warps owns all 64 o and NT n8 tiles of
//     the group's taps (padded to 32 * NT): 16 * NT fp32 accumulators a
//     thread, kept over the block's whole range;
//   * the grid is one wave: the wrapper asks the runtime's occupancy of the
//     kernel for 4, then 3, then 2 blocks an SM, each with the deepest ring
//     that many leave room for, and launches as many row blocks as fit. At
//     the main shape that is 4 blocks an SM with 5 slots of 10.6 KB: more
//     producer and consumer warps an SM buy more than a deeper ring (a
//     fifth block, with 4 slots, was slower);
//   * each row block writes its partial dW into a (G, k*k*C, CO) fp32
//     scratch, and a second kernel sums the G partials in a fixed order:
//     deterministic, no atomics. With G = 1 the block writes dW directly.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTileP = 64;        // output pixels of a tile: the K of its products
constexpr int kTileO = 64;        // output channels of a tile: the M
constexpr int kWarps = 4;         // consumer warps of a block; each owns NT n8 tiles of taps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxNT = 6;         // n8 tiles a warp owns at most (192 taps a block)
constexpr int kMaxStages = 8;
constexpr int kDyBytes = kTileP * kTileO * 2;  // one staged dy tile
constexpr int kReduceWarps = 8;   // warps that split the partials' G axis

struct StemArgs {
  int n, h, w, c, ho, wo, co, k;
  int pad_top;          // zero rows above x (k / 2 for a whole image)
  int kr, kc, cs;       // a tap group's box: kh rows, kw columns, channels
  int gw, gc;           // tap groups along kw and along c
  int span;             // x rows staged as whole-C spans by cp.async
  int dy_tma;           // dy by TMA (CO % 8 == 0, 16-byte aligned)
  int stages;           // depth of the ring
  int col_tiles;        // tiles of one output row: ceil(Wo / kTileP)
  int tiles;            // N * Ho * col_tiles
  int row_blocks;
};

// Input columns a tile's kc taps kw read: 2 * 63 + kc.
__host__ __device__ inline int span_cols(int kc) { return 2 * (kTileP - 1) + kc; }

// bf16 elements of one staged x row: the span and its alignment offset
// (at most 7 elements), or the gathered columns of cs channels; a multiple
// of 8, so that every row starts 16-byte aligned.
__host__ __device__ inline int x_row_elems(int c, int kc, int cs, int span) {
  const int n = span ? 7 + span_cols(kc) * c : span_cols(kc) * cs;
  return (n + 7) / 8 * 8;
}

__host__ __device__ inline int slot_bytes(int c, int kr, int kc, int cs, int span) {
  return kDyBytes + 2 * kr * x_row_elems(c, kc, cs, span);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; the bytes past src_bytes (all 16
// when it is 0) are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}
// cp.async's completion as an arrival on `bar`: the arrival is made once
// every cp.async this thread issued before it has landed, and counts as one
// of the arrivals the phase expects (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// mbarriers in shared memory (CTA scope): init with the count of arrivals a
// phase takes, arrive (release), and wait for the phase of the given parity
// to complete (acquire).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// adds `bytes` to the transactions the current phase of `bar` waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// TMA: the box of `map` at coordinates (x, y, z) -> dst; its bytes count
// against `bar`'s transactions when they land
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(x), "r"(y), "r"(z) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, in register i,
// elements [2t][g] and [2t+1][g] of matrix i (g = l / 4, t = l % 4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a tile lies: output row (n, ho), its first pixel wo0 and width tw.
struct Tile {
  int b, oh, wo0, tw;
};
__device__ __forceinline__ Tile tile_at(const StemArgs& g, int t) {
  Tile r;
  const int row = t / g.col_tiles;
  r.wo0 = t % g.col_tiles * kTileP;
  r.tw = min(kTileP, g.wo - r.wo0);
  r.b = row / g.ho;
  r.oh = row % g.ho;
  return r;
}

// The tap group's box of blockIdx.y: its first tap (kh0, kw0, c0) and its
// extent, cut at the kernel's edge.
struct Box {
  int kh0, kw0, c0, nkh, nkw, ncs;
};
__device__ __forceinline__ Box box_of(const StemArgs& g) {
  Box x;
  const int grp = blockIdx.y;
  x.kh0 = grp / (g.gw * g.gc) * g.kr;
  x.kw0 = grp / g.gc % g.gw * g.kc;
  x.c0 = grp % g.gc * g.cs;
  x.nkh = min(g.kr, g.k - x.kh0);
  x.nkw = min(g.kc, g.k - x.kw0);
  x.ncs = min(g.cs, g.c - x.c0);
  return x;
}

// Element offset of x[b, hi, col, 0] (hi and col may lie outside the image).
__device__ __forceinline__ long long x_elem(const StemArgs& g, int b, int hi, int col) {
  return ((long long)(b * g.h + hi) * g.w + col) * g.c;
}

// The producer warp's copies of tile `tl` into one slot, lane `lane` taking
// every 32nd piece: dy by 2-byte loads where there is no tensor map
// (`dy_tma` false; the kernel issues the TMA copy otherwise), the x rows by
// cp.async (`span`) or 2-byte loads.
__device__ __forceinline__ void stage_tile(const StemArgs& g, const Box& bx, const Tile& tl,
                                           int o0, const unsigned short* __restrict__ x,
                                           const unsigned short* __restrict__ dy,
                                           unsigned char* dys, unsigned short* xs, int xrow,
                                           int lane) {
  if (!g.dy_tma) {
    const long long drow = ((long long)tl.b * g.ho + tl.oh) * g.wo + tl.wo0;  // first pixel
    for (int e = lane; e < kTileP * kTileO; e += 32) {
      const int pp = e >> 6, ol = e & 63;
      const bool ok = pp < tl.tw && o0 + ol < g.co;
      const unsigned short v = ok ? dy[(drow + pp) * g.co + o0 + ol] : (unsigned short)0;
      *reinterpret_cast<unsigned short*>(dys + pp * 128 + (((ol >> 3) ^ (pp & 7)) << 4) +
                                         2 * (ol & 7)) = v;
    }
  }
  const int pad = g.k / 2;
  const int col0 = 2 * tl.wo0 - pad + bx.kw0;  // the box's first column
  const int cols = span_cols(g.kc);
  for (int r = 0; r < g.kr; ++r) {
    const int hi = 2 * tl.oh - g.pad_top + bx.kh0 + r;
    const bool row_ok = r < bx.nkh && hi >= 0 && hi < g.h;
    unsigned short* dst = xs + r * xrow;
    if (g.span) {
      // the row's bytes from the 16-byte boundary at or before column col0;
      // pieces outside the tensor (and every piece of a row outside the
      // image) are zero-filled and read nothing
      const long long at0 = (2 * x_elem(g, tl.b, hi, col0)) & ~15LL;
      const long long end = 2LL * g.n * g.h * g.w * g.c;
      const char* src = reinterpret_cast<const char*>(x);
      for (int e = lane; e < xrow / 8; e += 32) {
        const long long at = at0 + 16LL * e;
        const int nb = row_ok && at >= 0 ? (int)max(0LL, min(16LL, end - at)) : 0;
        cp_async16(dst + 8 * e, nb > 0 ? src + at : src, nb);
      }
    } else {
      for (int e = lane; e < cols * g.cs; e += 32) {
        const int col = col0 + e / g.cs, ch = bx.c0 + e % g.cs;
        const bool ok = row_ok && col >= 0 && col < g.w && ch < g.c;
        dst[e] = ok ? x[x_elem(g, tl.b, hi, col) + ch] : (unsigned short)0;
      }
    }
  }
}

// At most 204 registers a thread, so that two blocks fit an SM's 64K.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
stem_wgrad_tc(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
              float* __restrict__ partial, StemArgs g,
              const __grid_constant__ CUtensorMap dy_map) {
  extern __shared__ uint4 stem_smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  const uint32_t raw_addr = smem_u32(stem_smem_raw);
  unsigned char* base = reinterpret_cast<unsigned char*>(stem_smem_raw) +
                        (((raw_addr + 1023) & ~1023u) - raw_addr);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Box bx = box_of(g);
  const int taps = bx.nkh * bx.nkw * bx.ncs;
  const int o0 = blockIdx.z * kTileO;
  const int pad = g.k / 2;
  const int xrow = x_row_elems(g.c, g.kc, g.cs, g.span);
  const int ps = g.span ? 2 * g.c : 2 * g.cs;  // x elements from one pixel to the next
  unsigned char* dy_ring = base;
  unsigned short* x_ring = reinterpret_cast<unsigned short*>(base + g.stages * kDyBytes);
  const int x_slot = g.kr * xrow;

  const int t0 = (int)((long long)blockIdx.x * g.tiles / g.row_blocks);
  const int count = (int)((long long)(blockIdx.x + 1) * g.tiles / g.row_blocks) - t0;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      // the producer's 32 lanes arrive, and with `span` their cp.async too
      mbar_init(&full[s], g.span ? 64 : 32);
      mbar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer warp: the copies ----
    // Tile q goes into slot q % stages once the consumers have released
    // it; its dy by TMA (lane 0; the bytes count on full), its x rows by
    // cp.async (each lane's completion arrives on full) or plain loads;
    // then every lane arrives.
    for (int q = 0; q < count; ++q) {
      const int slot = q % g.stages;
      if (q >= g.stages) mbar_wait(&empty[slot], (q / g.stages - 1) & 1);
#ifdef STEM_WGRAD_SKIP_COPIES  // timing build of scripts/torch_stem_parts.py only
      if (q < g.stages) {
#endif
      const Tile tl = tile_at(g, t0 + q);
      if (g.dy_tma && lane == 0) {
        mbar_expect_tx(&full[slot], kDyBytes);
        tma_load_3d(dy_ring + slot * kDyBytes, &dy_map, &full[slot], o0, tl.wo0,
                    tl.b * g.ho + tl.oh);
      }
      stage_tile(g, bx, tl, o0, x, dy, dy_ring + slot * kDyBytes, x_ring + slot * x_slot,
                 xrow, lane);
#ifdef STEM_WGRAD_SKIP_COPIES
      }
#endif
      if (g.span) cp_async_arrive(&full[slot]);
      mbar_arrive(&full[slot]);
    }
    return;
  }

  // ---- consumer warps: the products and the epilogue ----
  // The taps this thread gathers B for: tap T = warp * 8NT + 8i + lane / 4
  // of the group, its row kh (within the box), its column kw (of the
  // kernel; -1 past the group's taps) and its offset in a staged row.
  int tkh[NT], tkw[NT], toff[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int t = warp * 8 * NT + 8 * i + (lane >> 2);
    const int lh = t / (bx.nkw * bx.ncs), lw = t / bx.ncs % bx.nkw, lc = t % bx.ncs;
    const bool ok = t < taps;
    tkh[i] = ok ? lh : 0;
    tkw[i] = ok ? bx.kw0 + lw : -1;
    toff[i] = ok ? (g.span ? lw * g.c + bx.c0 + lc : lw * g.cs + lc) : 0;
  }
  float acc[4][NT][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;

  // ldmatrix addresses of A = dy^T: lane l addresses pixel row
  // (l % 8) + 8 * (l / 16) of a 16-pixel step, 16-byte chunk 2m + (l / 8) % 2
  // (o 16m .. 16m + 15), swizzled by the row
  const int a_row = (lane & 7) + 8 * (lane >> 4);
  int a_off[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) a_off[m] = a_row * 128 + (((2 * m + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);

  for (int q = 0; q < count; ++q) {
    const int slot = q % g.stages;
    mbar_wait(&full[slot], (q / g.stages) & 1);
    const Tile tl = tile_at(g, t0 + q);
    const uint32_t dys = smem_u32(dy_ring + slot * kDyBytes);
    const unsigned short* xs = x_ring + slot * x_slot;
    // per owned tap: where pixel 2(lane % 4) of the tile's first step lies,
    // and the pixels [plo, phi) whose column 2(wo0 + p) - pad + kw lies in
    // the image (none past the tile's width)
    const long long e0 =
        x_elem(g, tl.b, 2 * tl.oh - g.pad_top + bx.kh0, 2 * tl.wo0 - pad + bx.kw0);
    int xb[NT], plo[NT], phi[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int shift = g.span ? (int)((e0 + (long long)tkh[i] * g.w * g.c) & 7) : 0;
      xb[i] = tkh[i] * xrow + shift + toff[i] + ps * 2 * (lane & 3);
      const int lo = pad - tkw[i] - 2 * tl.wo0, hi = g.w - 1 + pad - tkw[i] - 2 * tl.wo0;
      plo[i] = lo <= 0 ? 0 : (lo + 1) / 2;
      phi[i] = tkw[i] < 0 || hi < 0 ? 0 : min(tl.tw, hi / 2 + 1);
    }
#ifdef STEM_WGRAD_SKIP_PRODUCTS  // timing build of scripts/torch_stem_parts.py only
    const int used = 0;
#else
    const int used = tl.tw;
#endif
#pragma unroll
    for (int ks = 0; ks < kTileP / 16; ++ks) {
      if (16 * ks >= used) break;  // the rest of the tile is past the row's end
      uint32_t a[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) ldsm_x4_trans(a[m], dys + ks * 16 * 128 + a_off[m]);
      const int p0 = 16 * ks + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const unsigned short* src = xs + xb[i] + ps * 16 * ks;
        const uint32_t v0 = src[0], v1 = src[ps], v2 = src[8 * ps], v3 = src[9 * ps];
        const uint32_t b0 = (p0 >= plo[i] && p0 < phi[i] ? v0 : 0u) |
                            (p0 + 1 >= plo[i] && p0 + 1 < phi[i] ? v1 << 16 : 0u);
        const uint32_t b1 = (p0 + 8 >= plo[i] && p0 + 8 < phi[i] ? v2 : 0u) |
                            (p0 + 9 >= plo[i] && p0 + 9 < phi[i] ? v3 << 16 : 0u);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma16816(acc[m][i], a[m], b0, b1);
      }
    }
    mbar_arrive(&empty[slot]);
  }

  // accumulator e of (m, i): o = o0 + 16m + lane / 4 + 8 (e / 2), tap
  // warp * 8NT + 8i + 2 (lane % 4) + e % 2; dW row of tap (kh, kw, c) is
  // ((kh * k + kw) * C + c) * CO
  float* out = partial + (size_t)blockIdx.x * g.k * g.k * g.c * g.co;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = warp * 8 * NT + 8 * i + 2 * (lane & 3) + (e & 1);
      if (t >= taps) continue;
      const int lh = t / (bx.nkw * bx.ncs), lw = t / bx.ncs % bx.nkw, lc = t % bx.ncs;
      float* dst = out + (size_t)(((bx.kh0 + lh) * g.k + bx.kw0 + lw) * g.c + bx.c0 + lc) * g.co;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int o = o0 + 16 * m + (lane >> 2) + 8 * (e >> 1);
        if (o < g.co) dst[o] = acc[m][i][e];
      }
    }
  }
}

// out[e] = sum over g of partial[g][e], in a fixed order: warp v of a block
// sums g = v, v + kReduceWarps, ... for 32 consecutive elements, then warp
// 0 adds the kReduceWarps sums in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
stem_wgrad_reduce(const float* __restrict__ partial, float* __restrict__ out,
                  int groups, int elems) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < elems) {
    for (int g = warp; g < groups; g += kReduceWarps) {
      v += partial[(size_t)g * elems + e];
    }
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && e < elems) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) t += sums[i][lane];
    out[e] = t;
  }
}

// dy (N*Ho, Wo, CO) as a 3-d tensor map whose box is one tile: 64 o x 64
// pixels of one output row, in the 128-byte swizzle, zero-filled past CO
// and past Wo. CO * 2 must be a multiple of 16 and dy 16-byte aligned.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t dy_map_of(CUtensorMap* map, const void* dy, int rows, int wo, int co) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)co, (cuuint64_t)wo, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)co * 2, (cuuint64_t)wo * co * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kTileO, (cuuint32_t)kTileP, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(dy),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Opts `kernel` into `bytes` of dynamic shared memory on the current
// device, once: the largest size asked for so far is remembered per device
// and NT.
template <int NT>
cudaError_t allow_smem(void (*kernel)(const unsigned short*, const unsigned short*, float*,
                                      StemArgs, const CUtensorMap),
                       int bytes) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kDevices) allowed[dev] = bytes;
  return e;
}

template <typename F>
cudaError_t nt_dispatch(int nt, F&& f) {
  switch (nt) {
    case 1: return f(stem_wgrad_tc<1>, allow_smem<1>);
    case 2: return f(stem_wgrad_tc<2>, allow_smem<2>);
    case 3: return f(stem_wgrad_tc<3>, allow_smem<3>);
    case 4: return f(stem_wgrad_tc<4>, allow_smem<4>);
    case 5: return f(stem_wgrad_tc<5>, allow_smem<5>);
    case 6: return f(stem_wgrad_tc<6>, allow_smem<6>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the partial kernel takes: a ring of
// `stages` slots, each one dy tile and the box's kr staged x rows, and 1024
// bytes to align the ring.
int stem_conv_wgrad_smem_bytes(int c, int kr, int kc, int cs, int span, int stages) {
  return 1024 + stages * slot_bytes(c, kr, kc, cs, span);
}

// Blocks of the partial kernel with `nt` n8 tiles a warp that fit on one SM
// at `smem_bytes` of dynamic shared memory, or minus a CUDA error code.
int stem_conv_wgrad_occupancy(int nt, int smem_bytes) {
  int blocks = 0;
  const cudaError_t err = nt_dispatch(nt, [&](auto kernel, auto allow) {
    cudaError_t e = allow(kernel, smem_bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem_bytes);
    }
    return e;
  });
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches the partial kernel on a grid of (row_blocks, tap groups, o
// tiles) and, for row_blocks > 1, the reduction, on `stream`. The plan (nt
// n8 tiles of taps a warp, the box kr x kc x cs, span, stages, row_blocks)
// comes from stem_wgrad_plan. With row_blocks == 1 the partial kernel
// writes `out` and `partial` is unused; otherwise `partial` holds
// row_blocks * k*k*c * co floats. With `span`, x must be 16-byte aligned.
// Returns a CUDA error code: that of a refused shared-memory size, or
// cudaGetLastError() after the launches (0 on success).
int stem_conv_wgrad(const void* x, const void* dy, void* partial, void* out,
                    int n, int h, int w, int c, int ho, int wo, int co, int k, int pad_top,
                    int nt, int kr, int kc, int cs, int span, int stages, int row_blocks,
                    void* stream) {
  if (nt < 1 || nt > kMaxNT || kr < 1 || kc < 1 || cs < 1 || kr * kc * cs > 32 * nt ||
      stages < 2 || stages > kMaxStages || row_blocks < 1 || pad_top < 0 || pad_top > k ||
      (span && (reinterpret_cast<uintptr_t>(x) & 15))) {
    return (int)cudaErrorInvalidValue;
  }
  StemArgs a;
  a.n = n; a.h = h; a.w = w; a.c = c; a.ho = ho; a.wo = wo; a.co = co; a.k = k;
  a.pad_top = pad_top;
  a.kr = kr; a.kc = kc; a.cs = cs;
  a.gw = (k + kc - 1) / kc;
  a.gc = (c + cs - 1) / cs;
  a.span = span;
  a.dy_tma = co % 8 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  a.stages = stages;
  a.col_tiles = (wo + kTileP - 1) / kTileP;
  const long long tiles = (long long)n * ho * a.col_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.row_blocks = row_blocks;
  const dim3 grid((unsigned)row_blocks, (unsigned)((k + kr - 1) / kr * a.gw * a.gc),
                  (unsigned)((co + kTileO - 1) / kTileO));
  const int smem = stem_conv_wgrad_smem_bytes(c, kr, kc, cs, span, stages);
  const auto* xb = static_cast<const unsigned short*>(x);
  const auto* db = static_cast<const unsigned short*>(dy);
  float* target = static_cast<float*>(row_blocks == 1 ? out : partial);
  auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap dy_map;
  memset(&dy_map, 0, sizeof(dy_map));
  if (a.dy_tma) {
    const cudaError_t e = dy_map_of(&dy_map, dy, n * ho, wo, co);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t err = nt_dispatch(nt, [&](auto kernel, auto allow) {
    const cudaError_t e = allow(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, s>>>(xb, db, target, a, dy_map);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || row_blocks == 1) return (int)err;
  const int elems = k * k * c * co;
  stem_wgrad_reduce<<<(elems + 31) / 32, 32 * kReduceWarps, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), row_blocks, elems);
  return (int)cudaGetLastError();
}

}  // extern "C"
