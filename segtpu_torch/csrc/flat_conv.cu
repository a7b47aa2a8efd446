// Backward kernels of the stride-1 "flat-row" convolution, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of segtpu/ops/flatconv.py:
//   * flat_conv_wgrad (_make_wgrad_kernel) by flat_wgrad_partial + flat_wgrad_reduce;
//   * flat_conv_dgrad (_make_dgrad_kernel) by flat_dgrad.
//
// The conv is stride 1, dilation d, kh x kw, pad p, NHWC / HWIO, with
// (k - 1) * d = 2p so that x (N, H, W, C) and dy (N, H, W, O) have the same
// size. Both are seen as flat rows, (N*H*W, C) and (N*H*W, O). Row r is the
// pixel h = (r / W) mod H, w = r mod W. Tap (a, b) moves it by
// dh = a*d - p, dw = b*d - p, i.e. by the row offset off = dh * W + dw:
//
//   wgrad: dW[a, b, c, o] = sum_r  x[r + off, c] * dy[r, o]
//          over rows r < N*H*W with h + dh and w + dw inside the image;
//   dgrad: dx[r, c] = sum_{a, b, o} dy[r - off, o] * W[a, b, c, o]
//          over taps with h - dh and w - dw inside the image.
//
// x, dy and W are bf16; every product is summed in fp32. dW is fp32, dx is
// rounded to bf16 (segtpu's result types).
//
// What bounds them on an H100. At PSPNet's stem_conv2 (x and dy
// 8x385x385x64, 3x3) each kernel must move 303.6 MB (0.091 ms at
// 3.35 TB/s) and do 87.4 GFLOP (0.088 ms on the bf16 tensor cores at
// 989 TFLOP/s): it sits on the ridge, so it needs both the tensor cores and
// a single pass over memory. This first version takes the tensor cores
// (mma.sync m16n8k16 bf16 -> fp32, fragments by ldmatrix; not wgmma) and
// leaves memory to the L2:
//   * it stages each tap's shifted rows anew from global memory, so the
//     k*k taps re-read x and dy (wgrad) or dy (dgrad) k*k times: 2.7 GB and
//     1.4 GB of loads at stem_conv2 instead of 0.3 GB. The blocks of the k*k
//     taps of one row range run side by side, so most re-reads hit L2, and
//     the L2's bandwidth is what bounds this version. Staging one tap row
//     (or all taps) per block and reusing the staged rows across taps is
//     the next step;
//   * masks are applied while staging, by select: a row outside the image,
//     a row that wraps in W or crosses H or an image, and the ragged tail
//     are written to shared memory as zeros, and their global memory is
//     never read, so halo garbage or NaN cannot leak into a sum;
//   * each thread's next global loads go to registers while the current
//     tile's products run; there is no cp.async / TMA pipeline. wgmma, TMA
//     and a multi-stage pipeline are later work.
//
// The TPU design does not carry over: its row tiles of 1024 with
// neighbour-block halos and a grid-carried dW accumulator relied on a
// sequential grid and a large VMEM. Here blocks run in no order, so:
//   * wgrad: a block owns one output tile (tap, 64 c, 64 o) and one
//     contiguous range of rows (a "split"), walked in chunks of 64 rows; it
//     writes a partial dW, and flat_wgrad_reduce sums the splits in a fixed
//     order. No atomics; the result is deterministic for a given shape and
//     card. The partial buffer holds splits * kh*kw*C*O floats; the wrapper
//     keeps it at most 2^24 floats (64 MiB, MAX_PARTIAL_FLOATS in
//     segtpu_torch/ops/flatconv.py) and refuses a dW larger than that. The
//     widest dW of the models' layers, 3x3x512x512, is 2.4M floats.
//   * dgrad: a block owns a tile of 64 rows x 64 c of dx and loops over the
//     taps and O in chunks of 32. No reduction across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int kTile = 64;      // block tile: M = N = 64
constexpr int kBK = 32;        // dgrad: depth of one staged chunk
// dgrad's shared-memory row stride, in bf16: 80 bytes, so that the eight
// 16-byte rows an ldmatrix reads fall into distinct banks
constexpr int kLd = kBK + 8;
constexpr int kReduceThreads = 256;

struct Geom {
  int n, h, w, c, o, kh, kw, pad, dil;
  int rows;  // n * h * w
};

union Pack8 {
  uint4 u;
  unsigned short s[8];
};

// Channels ch0 .. ch0+7 of flat row `row` of a (rows, nch) bf16 array;
// zero where !ok or past nch. Global memory is read only where ok.
__device__ __forceinline__ Pack8 load8(const unsigned short* __restrict__ src,
                                       long long row, int ch0, int nch,
                                       bool ok) {
  Pack8 p;
  p.u = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || ch0 >= nch) return p;
  const unsigned short* q = src + row * nch + ch0;
  if ((nch & 7) == 0) {  // 16-byte aligned: the wrapper checks the base
    p.u = __ldg(reinterpret_cast<const uint4*>(q));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (ch0 + e < nch) p.s[e] = q[e];
    }
  }
  return p;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives, in register i, elements [g][2t]
// and [g][2t+1] of matrix i (g = l / 4, t = l % 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const unsigned short* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// acc (the warp's 32 x 32 tile at (wm, wn)) += A[64][kBK] * B[64][kBK]^T,
// both k-contiguous in shared memory (row stride kLd). Fragment layout of
// m16n8k16: lane = 4 g + t holds A rows g and g+8 at k = 2t, 2t+1, 2t+8,
// 2t+9, B column g at the same k, and C rows g and g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void tile_mma(const unsigned short* As,
                                         const unsigned short* Bs,
                                         float (&acc)[2][4][4], int wm, int wn,
                                         int lane) {
  const int mat = lane >> 3;
  const int mrow = lane & 7;
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 16) {
    uint32_t a[2][4];
    uint32_t b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
      ldsm_x4(a[i], As + (wm * 32 + i * 16 + mrow + (mat & 1) * 8) * kLd + k0 +
                        (mat >> 1) * 8);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
      uint32_t t[4];
      ldsm_x4(t, Bs + (wn * 32 + jj * 16 + mrow + (mat >> 1) * 8) * kLd + k0 +
                     (mat & 1) * 8);
      b[2 * jj][0] = t[0];
      b[2 * jj][1] = t[1];
      b[2 * jj + 1][0] = t[2];
      b[2 * jj + 1][1] = t[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
}

// Row and column, within the 64 x 64 block tile, of accumulator element
// acc[i][j][e] of this lane.
__device__ __forceinline__ int acc_row(int wm, int i, int e, int lane) {
  return wm * 32 + i * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int wn, int j, int e, int lane) {
  return wn * 32 + j * 8 + 2 * (lane & 3) + (e & 1);
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, in register i,
// elements [2t][g] and [2t+1][g] of matrix i (g = l / 4, t = l % 4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const unsigned short* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

constexpr int kWK = 64;          // wgrad: rows per staged chunk
constexpr int kWLd = kTile + 8;  // row stride of the row-major x and dy tiles
constexpr int kWLoads = kWK * (kTile / 8) / kThreads;  // 16-byte loads a thread

// Image coordinates (h, w) of the rows a thread stages, carried from chunk
// to chunk by adding kWK, so that no chunk divides by W or H.
struct RowPos {
  int h[kWLoads], w[kWLoads];
};

__device__ __forceinline__ void row_pos_init(RowPos& pos, const Geom& g, int r0) {
#pragma unroll
  for (int q = 0; q < kWLoads; ++q) {
    const int r = r0 + ((threadIdx.x + q * kThreads) >> 3);
    pos.h[q] = (r / g.w) % g.h;
    pos.w[q] = r % g.w;
  }
}

__device__ __forceinline__ void row_pos_advance(RowPos& pos, const Geom& g) {
#pragma unroll
  for (int q = 0; q < kWLoads; ++q) {
    int w = pos.w[q] + kWK, h = pos.h[q];
    while (w >= g.w) {
      w -= g.w;
      h = h + 1 == g.h ? 0 : h + 1;
    }
    pos.w[q] = w;
    pos.h[q] = h;
  }
}

// One chunk of kWK rows starting at r0: x[r + off, c0 .. c0+63] (masked)
// and dy[r, o0 .. o0+63], 8 channels per load. A warp covers 4 whole rows.
__device__ __forceinline__ void wgrad_load(Pack8 (&xr)[kWLoads],
                                           Pack8 (&dr)[kWLoads],
                                           const unsigned short* __restrict__ x,
                                           const unsigned short* __restrict__ dy,
                                           const Geom& g, const RowPos& pos,
                                           int r0, int r_end, int dh, int dw,
                                           long long off, int c0, int o0) {
#pragma unroll
  for (int q = 0; q < kWLoads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = r0 + (i >> 3);
    const int grp = i & 7;
    const bool in = r < r_end;
    const int hz = pos.h[q] + dh;
    const int wz = pos.w[q] + dw;
    const bool ok = in && hz >= 0 && hz < g.h && wz >= 0 && wz < g.w;
    xr[q] = load8(x, r + off, c0 + 8 * grp, g.c, ok);
    dr[q] = load8(dy, r, o0 + 8 * grp, g.o, in);
  }
}

// grid: x = output tile (tap, c tile, o tile; o fastest), y = split of rows.
// Tile: M = c, N = o, K = rows. x and dy are staged as they lie, rows by
// channels ([r][c] and [r][o]), with 16-byte stores; ldmatrix.trans turns
// them into the A = x^T and B = dy fragments. The next chunk's global loads
// are in flight while the current chunk's products run. At most 128
// registers a thread, so that 4 blocks fit on an SM (the wrapper's plan
// sizes the grid to one such wave).
__global__ void __launch_bounds__(kThreads, 4)
flat_wgrad_partial(const unsigned short* __restrict__ x,
                   const unsigned short* __restrict__ dy,
                   float* __restrict__ partial, Geom g, int rows_per_split) {
  __shared__ __align__(16) unsigned short Xs[kWK * kWLd];
  __shared__ __align__(16) unsigned short Ds[kWK * kWLd];

  const int ctiles = (g.c + kTile - 1) / kTile;
  const int otiles = (g.o + kTile - 1) / kTile;
  int tile = blockIdx.x;
  const int ot = tile % otiles;
  tile /= otiles;
  const int ct = tile % ctiles;
  const int tap = tile / ctiles;
  const int dh = (tap / g.kw) * g.dil - g.pad;
  const int dw = (tap % g.kw) * g.dil - g.pad;
  const long long off = (long long)dh * g.w + dw;
  const int c0 = ct * kTile;
  const int o0 = ot * kTile;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, g.rows);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses
  const int mrow = lane & 7;  // which of its rows
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Pack8 xr[kWLoads], dr[kWLoads];
  RowPos pos;
  row_pos_init(pos, g, r_begin);
  if (r_begin < r_end) {
    wgrad_load(xr, dr, x, dy, g, pos, r_begin, r_end, dh, dw, off, c0, o0);
  }
  for (int r0 = r_begin; r0 < r_end; r0 += kWK) {
#pragma unroll
    for (int q = 0; q < kWLoads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int at = (i >> 3) * kWLd + 8 * (i & 7);
      *reinterpret_cast<uint4*>(Xs + at) = xr[q].u;
      *reinterpret_cast<uint4*>(Ds + at) = dr[q].u;
    }
    __syncthreads();
    if (r0 + kWK < r_end) {
      row_pos_advance(pos, g);
      wgrad_load(xr, dr, x, dy, g, pos, r0 + kWK, r_end, dh, dw, off, c0, o0);
    }
#pragma unroll
    for (int k0 = 0; k0 < kWK; k0 += 16) {
      uint32_t a[2][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // matrices: (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
        ldsm_x4_trans(a[i], Xs + (k0 + mrow + (mat >> 1) * 8) * kWLd +
                                wm * 32 + i * 16 + (mat & 1) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t t[4];
        ldsm_x4_trans(t, Ds + (k0 + mrow + (mat & 1) * 8) * kWLd +
                             wn * 32 + jj * 16 + (mat >> 1) * 8);
        b[2 * jj][0] = t[0];
        b[2 * jj][1] = t[1];
        b[2 * jj + 1][0] = t[2];
        b[2 * jj + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  float* out = partial + ((size_t)blockIdx.y * g.kh * g.kw + tap) * g.c * g.o;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + acc_row(wm, i, e, lane);
        const int o = o0 + acc_col(wn, j, e, lane);
        if (c < g.c && o < g.o) out[(size_t)c * g.o + o] = acc[i][j][e];
      }
}

// out[e] = sum over s = 0, 1, ..., splits-1 of partial[s][e], in that order.
__global__ void __launch_bounds__(kReduceThreads)
flat_wgrad_reduce(const float* __restrict__ partial, float* __restrict__ out,
                  int splits, long long elems) {
  const long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= elems) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * elems + e];
  out[e] = v;
}

// grid: x = (row tile, c tile; c fastest). Tile: M = rows, N = c, K = taps x
// O. A[r][o] = dy[r - off, o] (masked by the output row's h and w), B[c][o]
// = W[tap, c, o]; both are k-contiguous in global memory already.
__global__ void __launch_bounds__(kThreads)
flat_dgrad(const unsigned short* __restrict__ dy,
           const unsigned short* __restrict__ wt,
           unsigned short* __restrict__ dx, Geom g) {
  __shared__ __align__(16) unsigned short As[kTile * kLd];
  __shared__ __align__(16) unsigned short Bs[kTile * kLd];

  const int ctiles = (g.c + kTile - 1) / kTile;
  const int ct = blockIdx.x % ctiles;
  const int r0 = (blockIdx.x / ctiles) * kTile;
  const int c0 = ct * kTile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Each thread stages the same two (row, group) chunks of A for every
  // tap and chunk: 64 rows x 4 groups of 8, a warp covering 8 whole rows.
  constexpr int kChunks = kTile * (kBK / 8) / kThreads;  // 2
  int srow[kChunks], sgrp[kChunks], sh[kChunks], sw[kChunks];
  bool sin[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int i = threadIdx.x + q * kThreads;
    srow[q] = i / (kBK / 8);
    sgrp[q] = i % (kBK / 8);
    const int r = r0 + srow[q];
    sin[q] = r < g.rows;
    sh[q] = (r / g.w) % g.h;
    sw[q] = r % g.w;
  }

  // Steps s = (tap, o chunk); the next step's global loads are in flight
  // while the current step's products run.
  const int ochunks = (g.o + kBK - 1) / kBK;
  const int steps = g.kh * g.kw * ochunks;
  Pack8 ar[kChunks], br[kChunks];
  auto load = [&](int step) {
    const int tap = step / ochunks;
    const int o0 = (step % ochunks) * kBK;
    const int dh = (tap / g.kw) * g.dil - g.pad;
    const int dw = (tap % g.kw) * g.dil - g.pad;
    const long long off = (long long)dh * g.w + dw;
    const unsigned short* wtap = wt + (size_t)tap * g.c * g.o;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const bool ok = sin[q] && sh[q] - dh >= 0 && sh[q] - dh < g.h &&
                      sw[q] - dw >= 0 && sw[q] - dw < g.w;
      ar[q] = load8(dy, (long long)(r0 + srow[q]) - off, o0 + 8 * sgrp[q], g.o, ok);
      const int c = c0 + srow[q];
      br[q] = load8(wtap, c, o0 + 8 * sgrp[q], g.o, c < g.c);
    }
  };
  load(0);
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      *reinterpret_cast<uint4*>(As + srow[q] * kLd + 8 * sgrp[q]) = ar[q].u;
      *reinterpret_cast<uint4*>(Bs + srow[q] * kLd + 8 * sgrp[q]) = br[q].u;
    }
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    tile_mma(As, Bs, acc, wm, wn, lane);
    __syncthreads();
  }

  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(dx);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + acc_row(wm, i, e, lane);
        const int c = c0 + acc_col(wn, j, e, lane);
        if (r < g.rows && c < g.c) {
          out[(size_t)r * g.c + c] = __float2bfloat16_rn(acc[i][j][e]);
        }
      }
}

Geom make_geom(int n, int h, int w, int c, int o, int kh, int kw, int pad,
               int dil) {
  Geom g;
  g.n = n; g.h = h; g.w = w; g.c = c; g.o = o;
  g.kh = kh; g.kw = kw; g.pad = pad; g.dil = dil;
  g.rows = n * h * w;
  return g;
}

}  // namespace

extern "C" {

// Edge of the square block tile (M = N) of both kernels, for the wrapper's
// launch plan.
int flat_conv_tile() { return kTile; }

// dW (kh, kw, C, O) fp32 from bf16 x (N, H, W, C) and dy (N, H, W, O).
// Launches flat_wgrad_partial on a grid of (kh*kw * ceil(C/64) * ceil(O/64),
// splits); split s takes rows [s * rows_per_split, (s+1) * rows_per_split).
// With splits == 1 the partial is `out` itself and no reduction runs;
// otherwise `partial` holds splits * kh*kw*C*O floats and flat_wgrad_reduce
// sums it into `out`. Returns cudaGetLastError() after the launches.
int flat_conv_wgrad(const void* x, const void* dy, void* partial, void* out,
                    int n, int h, int w, int c, int o, int kh, int kw, int pad,
                    int dil, int splits, int rows_per_split, void* stream) {
  const Geom g = make_geom(n, h, w, c, o, kh, kw, pad, dil);
  const int tiles = kh * kw * ((c + kTile - 1) / kTile) * ((o + kTile - 1) / kTile);
  auto s = static_cast<cudaStream_t>(stream);
  float* target = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  flat_wgrad_partial<<<dim3(tiles, splits), kThreads, 0, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(dy),
      target, g, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long elems = (long long)kh * kw * c * o;
  const int blocks = (int)((elems + kReduceThreads - 1) / kReduceThreads);
  flat_wgrad_reduce<<<blocks, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), splits, elems);
  return (int)cudaGetLastError();
}

// dx (N, H, W, C) bf16 from bf16 dy (N, H, W, O) and W laid out (kh, kw, C,
// O). Returns cudaGetLastError() after the launch.
int flat_conv_dgrad(const void* dy, const void* wt, void* dx, int n, int h,
                    int w, int c, int o, int kh, int kw, int pad, int dil,
                    void* stream) {
  const Geom g = make_geom(n, h, w, c, o, kh, kw, pad, dil);
  const long long blocks =
      (long long)((g.rows + kTile - 1) / kTile) * ((c + kTile - 1) / kTile);
  flat_dgrad<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(dy), static_cast<const unsigned short*>(wt),
      static_cast<unsigned short*>(dx), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
