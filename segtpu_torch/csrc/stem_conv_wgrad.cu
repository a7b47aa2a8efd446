// Weight gradient of the stride-2 stem convolution, for Hopper (sm_90a).
//
// Replaces segtpu/ops/conv_wgrad.py::stem_conv_wgrad (the Pallas TPU
// kernel). It computes dW (k, k, C, CO), fp32, of a k x k, stride-2,
// pad k//2, bias-free NHWC convolution:
//
//   dW[kh, kw, c, o] = sum_{n, ho, wo} x[n, 2ho - p + kh, 2wo - p + kw, c]
//                                       * dy[n, ho, wo, o]
//
// from x (N, H, W, C) and dy (N, Ho, Wo, CO), both bf16, with every
// product summed in fp32.
//
// What bounds it: memory. At the main path's shape (x 8x769x769x3, dy
// 8x385x385x64, k=3) it must read x (28.4 MB) and dy (151.8 MB) once,
// about 180 MB: 54 us at 3.35 TB/s. Its 4.1 GFLOP would take about 4 us on
// the tensor cores. This first version makes no attempt to reach that
// bound: it runs on the fp32 CUDA cores from shared memory with scalar
// bf16 loads. wgmma, TMA and vectorised 16-byte loads are later work.
//
// Design. The TPU kernel's space-to-depth fold and tap concatenation were
// there to fill a 128x128 MXU, and its accumulator relied on the TPU grid
// running in order; neither carries over. Here:
//   * the grid is (row blocks, tap groups, o tiles). A row block owns a
//     contiguous range of output rows (n, ho) and walks them in tiles of
//     kTileW output pixels, staging the tile's dy (as fp32) and the input
//     rows its taps read (as fp32, zero outside the image) in shared memory;
//   * a tap group is a box of taps: kr rows kh, kc columns kw and cs
//     channels c (the launch plan, stem_wgrad_plan in
//     segtpu_torch/ops/conv_wgrad.py, picks the box). It stages only that
//     slice of x, so shared memory stays within the 48 KB a launch takes
//     without opting in, whatever C and k are;
//   * an o tile is co_tile output channels, co_tile a power of two from 4
//     to kMaxCoTile (its quarter divides kThreads); lanes past CO are
//     staged as zeros, computed and never written;
//   * each thread owns 4 consecutive output channels of NT taps of its
//     group (NT <= 16): NT x 4 fp32 accumulators in registers. Per pixel it
//     reads one float4 of dy and one x value per tap;
//   * each row block writes its partial dW into a (G, k*k*C, CO) fp32
//     scratch, and a second kernel sums the G partials in a fixed order:
//     deterministic, no atomics. The plan keeps G * k*k*C*CO under 2^24
//     floats; with G = 1 the block writes dW directly and no sum runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;       // output pixels staged per tile
constexpr int kMaxCoTile = 256;  // widest o tile: its dy tile is 32 KB
constexpr int kReduceWarps = 8;  // warps that split the partials' G axis

struct StemArgs {
  int n, h, w, c, ho, wo, co, k;
  int co_tile;          // o tile width (4, 8, ..., kMaxCoTile)
  int kr, kc, cs;       // a tap group's box: kh rows, kw columns, channels
  int gw, gc;           // tap groups along kw and along c
  int rows_per_block;
};

// Input columns a tile of kTileW output pixels reads for kc taps kw.
__host__ __device__ inline int x_cols(int kc) { return 2 * kTileW + kc - 2; }

// kBoxed false: one tap group of all k*k*C taps and one o tile of exactly
// CO, CO a multiple of 4 (the main path's stem); the boxes' offsets are then
// compile-time zeros, and the code the same as before there were boxes.
template <int NT, bool kBoxed>
__global__ void __launch_bounds__(kThreads)
stem_wgrad_partial(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ dy,
                   float* __restrict__ partial, StemArgs g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = g.k, c = g.c, co = g.co, ct = kBoxed ? g.co_tile : co;
  // this block's tap group: taps kh0.., kw0.., c0.. of the box
  const int grp_id = blockIdx.y;
  const int kh0 = kBoxed ? grp_id / (g.gw * g.gc) * g.kr : 0;
  const int kw0 = kBoxed ? grp_id / g.gc % g.gw * g.kc : 0;
  const int c0 = kBoxed ? grp_id % g.gc * g.cs : 0;
  const int nkh = kBoxed ? min(g.kr, k - kh0) : k;
  const int nkw = kBoxed ? min(g.kc, k - kw0) : k;
  const int ncs = kBoxed ? min(g.cs, c - c0) : c;
  const int o0 = kBoxed ? blockIdx.z * ct : 0;
  const int xw = x_cols(kBoxed ? g.kc : k);
  float* dys = smem;                  // [kTileW][co_tile]
  float* xs = smem + kTileW * ct;     // [nkh][xw][ncs]

  const int taps = nkh * nkw * ncs;
  const int lanes = ct / 4;  // threads across the output channels
  const int groups = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int pad = k / 2;

  // Shared-memory offset of each owned tap at pixel 0 of a tile; pixel p
  // adds 2*p*ncs. Taps past the group's end alias its tap 0 and are
  // computed but never written.
  int off[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    int j = grp + i * groups;
    j = j < taps ? j : 0;
    const int lh = j / (nkw * ncs);
    const int lw = j / ncs % nkw;
    off[i] = (lh * xw + lw) * ncs + j % ncs;
  }
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const int rows = g.n * g.ho;
  const int r0 = blockIdx.x * g.rows_per_block;
  const int r1 = min(r0 + g.rows_per_block, rows);
  const int xcols = xw * ncs;
  const bool whole_o = !kBoxed || ct == co;  // one o tile, no padded lanes
  for (int r = r0; r < r1; ++r) {
    const int b = r / g.ho;
    const int oh = r % g.ho;
    for (int w0 = 0; w0 < g.wo; w0 += kTileW) {
      const int tw = min(kTileW, g.wo - w0);
      __syncthreads();  // the previous tile is consumed
      const __nv_bfloat16* dyrow = dy + ((size_t)r * g.wo + w0) * co;
      if (whole_o) {
        for (int i = threadIdx.x; i < tw * co; i += kThreads) {
          dys[i] = __bfloat162float(dyrow[i]);
        }
      } else {
        for (int i = threadIdx.x; i < tw * ct; i += kThreads) {
          const int o = o0 + i % ct;
          dys[i] = o < co ? __bfloat162float(dyrow[(i / ct) * co + o]) : 0.f;
        }
      }
      for (int i = threadIdx.x; i < nkh * xcols; i += kThreads) {
        const int lh = i / xcols;
        const int col = (i % xcols) / ncs;
        const int ci = i % ncs;
        const int hi = 2 * oh - pad + kh0 + lh;
        const int wi = 2 * w0 - pad + kw0 + col;
        float v = 0.f;
        if (hi >= 0 && hi < g.h && wi >= 0 && wi < g.w) {
          v = __bfloat162float(x[(((size_t)b * g.h + hi) * g.w + wi) * c + c0 + ci]);
        }
        xs[i] = v;
      }
      __syncthreads();
      for (int p = 0; p < tw; ++p) {
        const float4 d = *reinterpret_cast<const float4*>(dys + p * ct + 4 * lane);
        const float* xp = xs + 2 * p * ncs;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float xv = xp[off[i]];
          acc[i][0] = fmaf(xv, d.x, acc[i][0]);
          acc[i][1] = fmaf(xv, d.y, acc[i][1]);
          acc[i][2] = fmaf(xv, d.z, acc[i][2]);
          acc[i][3] = fmaf(xv, d.w, acc[i][3]);
        }
      }
    }
  }

  // dW row of tap (kh, kw, c) is ((kh * k + kw) * C + c) * CO
  float* out = partial + (size_t)blockIdx.x * k * k * c * co;
  const int o = o0 + 4 * lane;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = grp + i * groups;
    if (j < taps && o < co) {
      const int lh = j / (nkw * ncs), lw = j / ncs % nkw;
      float* dst = out + ((size_t)((kh0 + lh) * k + kw0 + lw) * c + c0 + j % ncs) * co + o;
      if (!kBoxed || co % 4 == 0) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {  // constant indices only: acc stays in registers
        dst[0] = acc[i][0];
        if (o + 1 < co) dst[1] = acc[i][1];
        if (o + 2 < co) dst[2] = acc[i][2];
        if (o + 3 < co) dst[3] = acc[i][3];
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the partial kernel takes: the tile's dy
// (kTileW x co_tile) and the x slice of a tap group's box, both as fp32.
int stem_conv_wgrad_smem_bytes(int co_tile, int kr, int kc, int cs) {
  return (int)(sizeof(float) * (kTileW * co_tile + kr * x_cols(kc) * cs));
}

// Launches the partial kernel on a grid of (row_blocks, tap groups, o
// tiles) and, for row_blocks > 1, the reduction, on `stream`. The plan
// (co_tile, the box kr x kc x cs, nt, rows_per_block, row_blocks) comes
// from stem_wgrad_plan; nt is the taps each thread owns (1..16). With
// row_blocks == 1 the partial kernel writes `out` and `partial` is unused;
// otherwise `partial` holds row_blocks * k*k*c * co floats. Returns a CUDA
// error code: cudaGetLastError() after the launches (0 on success).
int stem_conv_wgrad(const void* x, const void* dy, void* partial, void* out,
                    int n, int h, int w, int c, int ho, int wo, int co, int k,
                    int co_tile, int kr, int kc, int cs, int nt,
                    int rows_per_block, int row_blocks, void* stream) {
  if (co_tile < 4 || co_tile > kMaxCoTile || (co_tile & (co_tile - 1)) || kr < 1 ||
      kc < 1 || cs < 1 || row_blocks < 1 || rows_per_block < 1) {
    return (int)cudaErrorInvalidValue;
  }
  StemArgs a;
  a.n = n; a.h = h; a.w = w; a.c = c; a.ho = ho; a.wo = wo; a.co = co; a.k = k;
  a.co_tile = co_tile; a.kr = kr; a.kc = kc; a.cs = cs;
  a.gw = (k + kc - 1) / kc;
  a.gc = (c + cs - 1) / cs;
  a.rows_per_block = rows_per_block;
  const dim3 grid((unsigned)row_blocks, (unsigned)((k + kr - 1) / kr * a.gw * a.gc),
                  (unsigned)((co + co_tile - 1) / co_tile));
  const size_t smem = stem_conv_wgrad_smem_bytes(co_tile, kr, kc, cs);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* db = static_cast<const __nv_bfloat16*>(dy);
  float* target = static_cast<float*>(row_blocks == 1 ? out : partial);
  auto s = static_cast<cudaStream_t>(stream);
  const bool boxed = grid.y > 1 || grid.z > 1 || co_tile != co || co % 4 != 0;
  switch (nt) {
#define SEGTPU_NT(N)                                                            \
  case N:                                                                       \
    if (boxed) {                                                                \
      stem_wgrad_partial<N, true><<<grid, kThreads, smem, s>>>(xb, db, target, a);  \
    } else {                                                                    \
      stem_wgrad_partial<N, false><<<grid, kThreads, smem, s>>>(xb, db, target, a); \
    }                                                                           \
    break;
    SEGTPU_NT(1) SEGTPU_NT(2) SEGTPU_NT(3) SEGTPU_NT(4)
    SEGTPU_NT(5) SEGTPU_NT(6) SEGTPU_NT(7) SEGTPU_NT(8)
    SEGTPU_NT(9) SEGTPU_NT(10) SEGTPU_NT(11) SEGTPU_NT(12)
    SEGTPU_NT(13) SEGTPU_NT(14) SEGTPU_NT(15) SEGTPU_NT(16)
#undef SEGTPU_NT
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || row_blocks == 1) return (int)err;
  const int elems = k * k * c * co;
  stem_wgrad_reduce<<<(elems + 31) / 32, 32 * kReduceWarps, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), row_blocks, elems);
  return (int)cudaGetLastError();
}

}  // extern "C"
