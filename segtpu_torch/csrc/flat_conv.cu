// Backward kernels of the stride-1 "flat-row" convolution, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of segtpu/ops/flatconv.py:
//   * flat_conv_wgrad (_make_wgrad_kernel) by flat_wgrad + flat_wgrad_reduce;
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
// few passes over memory.
//
// wgrad (flat_wgrad), warpgroup products (wgmma) fed by a cp.async ring:
//   * a block is one warpgroup (128 threads). It owns one tap row a and up
//     to three of its taps b (all of them for k <= 3), a 64-wide c tile, an
//     o tile of N = 64, or 32 or 24 for O <= 32, and one split of the rows:
//     split s of S takes the chunks of 64 dy rows s, s + S, s + 2S, ...
//     Per chunk it stages the dy rows once and ONE x window, rows
//     [r0 + off(a, b0), r0 + off(a, b0) + 64 + (taps - 1) * d): tap b0 + j
//     is the window shifted down by j * d rows, which costs ldmatrix
//     nothing. x and dy cross from L2 kh times (0.92 GB at stem_conv2, not
//     kh*kw times: 2.7 GB), and each staged dy row feeds every tap;
//   * products: wgmma.m64nNk16, M = c, N = o, K = rows. A = x^T comes from
//     the row-major window by ldmatrix.trans into registers, where the
//     masks are applied; B = dy is read by the tensor cores from shared
//     memory in the 128- or 64-byte swizzled layout (N = 64, 32; unswizzled
//     core matrices for N = 24). 3 taps x N/2 fp32 accumulators a thread;
//   * masks, by select on the x operand as segtpu does: while a chunk is
//     staged, one 64-bit word per tap says which of its dy rows see their
//     partner pixel inside the image (h + dh, w + dw; h and w are carried
//     from chunk to chunk); each A register holds two consecutive rows and
//     is ANDed with a 0x0000/0xFFFF half-mask;
//   * staging: cp.async (16 bytes, .cg) into a ring of 3 slots in dynamic
//     shared memory, two chunks ahead. Rows outside [0, N*H*W) are
//     zero-filled through the copy's source size 0, so their memory is
//     never read: NaN just outside x and dy cannot reach dW. C or O not a
//     multiple of 8 takes 2-byte loads, except dy when the o tile covers all
//     of O: a chunk's dy rows are then one contiguous, 16-byte aligned span
//     of 64 * O values, copied as it lies (the last piece cut by the source
//     size) and laid out as the B tile in one shared-memory pass;
//   * the grid is one wave: the wrapper sizes the splits from the kernel's
//     own occupancy (flat_conv_wgrad_occupancy). Each block writes a partial
//     dW, and flat_wgrad_reduce sums the splits in a fixed order: no
//     atomics, deterministic for a given shape and card. The partial buffer
//     holds splits * kh*kw*C*O floats, at most 2^24 (MAX_PARTIAL_FLOATS in
//     segtpu_torch/ops/flatconv.py); a dW too large for two splits is
//     written directly by one split, with kh * ceil(kw / 3) * ceil(C / 64)
//     * ceil(O / N) blocks, enough for the card.
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; scripts/
// torch_wgrad_parts.py times builds that skip the copies or the products):
// at stem_conv2 the whole takes about 0.36 ms, the staging alone 0.19, the
// products alone 0.22, and the two barely overlap. The staging took nearly
// as long with every row in L2, and a deeper ring, longer chunks or other
// copy instructions did not move it. A producer warp (TMA or warp
// specialisation) that overlaps the copies with the products is the next
// step.

// dgrad (flat_dgrad): a block owns a tile of 64 rows x 64 c of dx and loops
// over the taps and O in chunks of 32, staging each tap's rows of dy anew
// (1.4 GB of loads at stem_conv2, mostly from L2); the masks are applied
// while staging, by select, and rows off the image are never read. Each
// thread's next global loads go to registers while the current tile's
// products run. No reduction across blocks.

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

constexpr int kWK = 64;          // wgrad: dy rows per staged chunk (the K of a stage)
constexpr int kWStages = 3;      // depth of the cp.async ring
constexpr int kWMaxTaps = 3;     // taps of one tap row a block owns at most
constexpr int kWTileC = 64;      // c tile: the M of a warpgroup product
constexpr int kWXLd = kWTileC + 8;  // x row stride, 144 bytes: an ldmatrix's 8 rows hit distinct banks

// 16 bytes global -> shared, asynchronous; the bytes past src_bytes (all 16
// when it is 0) are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}
// orders this thread's writes to shared memory before later reads by the
// tensor cores (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Warpgroup products, D (64 x N, fp32, registers) += A (64 x 16, bf16,
// registers: each warp's 16 rows in the mma.m16n8k16 A layout) * B (16 x N,
// bf16, shared memory through a descriptor, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void wgmma_n24(float (&d)[12], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 24) wgmma_n24(d, a, desc);
  else if constexpr (N == 32) wgmma_n32(d, a, desc);
  else wgmma_n64(d, a, desc);
}

// The dy tile of a chunk, kWK rows x N columns, as the tensor cores read B
// (MN-major), in bf16 elements from the tile's base. Rows are N apart, so
// rows 16s .. 16s+15 start at 16 s N. N = 64: 128-byte rows, the 16-byte
// piece p of row k at p ^ (k % 8) (the 128-byte swizzle; base 1024-byte
// aligned). N = 32: 64-byte rows, piece p at p ^ (k / 2 % 4) (the 64-byte
// swizzle). N = 24: no swizzle, 8 x 8 core matrices of 128 contiguous bytes,
// those of rows 8i .. 8i+7 side by side. A row's pieces land in distinct
// banks either way; cp.async into the core-matrix layout from rows of 64 or
// 128 bytes measured 2-3x slower than into the swizzled ones.
template <int N>
__device__ __forceinline__ int dy_at(int k, int p) {
  if constexpr (N == 64) return k * 64 + 8 * (p ^ (k & 7));
  else if constexpr (N == 32) return k * 32 + 8 * (p ^ ((k >> 1) & 3));
  else return ((k >> 3) * 3 + p) * 64 + (k & 7) * 8;
}

// Descriptor of rows 16s .. 16s+15 of such a tile at shared address `addr`:
// start >> 4; leading byte offset (unused by the swizzled forms; 384 bytes
// from one core matrix column of 8 rows to the next 8 rows unswizzled);
// stride byte offset (8 rows: 1024, 512, or 128 from one core matrix to the
// next along N); layout (1: 128-byte swizzle, 2: 64-byte, 0: none).
template <int N>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t lbo = N == 24 ? 384 : 16, sbo = N == 64 ? 1024 : N == 32 ? 512 : 128;
  constexpr uint64_t layout = N == 64 ? 1 : N == 32 ? 2 : 0;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32 |
         layout << 62;
}

// How a wgrad operand is staged: 16-byte cp.async pieces (channels a
// multiple of 8), 2-byte loads, or (dy only) the chunk's contiguous span.
enum WStage { kVec = 0, kScalar = 1, kSpan = 2 };

struct WgradArgs {
  Geom g;
  int taps;            // taps b0 .. b0+taps-1 of tap row a a block owns
  int groups;          // ceil(kw / taps)
  int win;             // rows of the x window: kWK + (taps - 1) * dil
  int x_mode, dy_mode; // WStage
};

// Shared-memory layout of flat_wgrad<NT, N>, in bf16 elements from a
// 1024-byte aligned base: kWStages dy tiles (kWK x N each, dy_at), then
// kWStages x windows (win rows x kWXLd, row-major), then the validity words
// (uint32 [kWStages][kWMaxTaps][2]), then, for a dy span, the tile the span
// is laid out into. `bytes` includes the slack for aligning the base.
struct WgradSmem {
  int x, x_stage, masks, pad, bytes;
};

__host__ __device__ inline WgradSmem wgrad_smem(int tile_o, int win, bool span) {
  WgradSmem s;
  s.x = kWStages * kWK * tile_o;
  s.x_stage = win * kWXLd;
  s.masks = s.x + kWStages * s.x_stage;
  s.pad = (s.masks + kWStages * kWMaxTaps * 2 * 2 + 511) / 512 * 512;
  s.bytes = 2 * (s.pad + (span ? kWK * tile_o : 0)) + 1024;
  return s;
}

// grid: x = output tile (tap row a, tap group, c tile, o tile; o fastest),
// y = split. NT: taps a block can hold (1 or kWMaxTaps); N: the o tile (24,
// 32 or 64). One warpgroup: warp w owns c rows 16w .. 16w+15 of the 64-wide
// c tile, for every tap and all N o. Products: M = c, N = o, K = rows; A =
// x^T by ldmatrix.trans from the row-major window into registers (masked
// there), B = dy from shared memory. At most 168 registers a thread, so
// that 3 blocks fit on an SM.
template <int NT, int N>
__global__ void __launch_bounds__(kThreads, 3)
flat_wgrad(const unsigned short* __restrict__ x,
           const unsigned short* __restrict__ dy,
           float* __restrict__ partial, WgradArgs args) {
  constexpr int NB = N / 8;  // 16-byte pieces of a dy row
  extern __shared__ uint4 wgrad_smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wgrad_smem_raw));
  unsigned short* smem = reinterpret_cast<unsigned short*>(
      reinterpret_cast<char*>(wgrad_smem_raw) + (((raw + 1023) & ~1023u) - raw));
  const Geom& g = args.g;
  const int taps = args.taps;
  const WgradSmem lay = wgrad_smem(N, args.win, args.dy_mode == kSpan);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + lay.masks);
  unsigned short* dpad = smem + lay.pad;

  const int ctiles = (g.c + kWTileC - 1) / kWTileC;
  const int otiles = (g.o + N - 1) / N;
  int tile = blockIdx.x;
  const int ot = tile % otiles;
  tile /= otiles;
  const int ct = tile % ctiles;
  tile /= ctiles;
  const int b0 = (tile % args.groups) * taps;
  const int a = tile / args.groups;
  const int nt = min(taps, g.kw - b0);  // taps of this block
  const int dh = a * g.dil - g.pad;
  const long long xoff = (long long)dh * g.w + b0 * g.dil - g.pad;
  const int c0 = ct * kWTileC;
  const int o0 = ot * N;
  // split s takes chunks s, s + S, s + 2S, ... of kWK rows (S = gridDim.y):
  // at any time the whole grid works on one band of rows
  const int split = blockIdx.y;
  const int step = gridDim.y * kWK;  // rows from one of the block's chunks to the next
  const int nchunks = ((g.rows + kWK - 1) / kWK - split + gridDim.y - 1) / gridDim.y;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses
  const int mrow = lane & 7;  // which of its rows

  // image coordinates of dy row split * kWK + q * step + tid (tid < kWK), for
  // the validity words of the block's chunk q; carried from chunk to chunk
  int hpos = 0, wpos = 0;
  if (tid < kWK) {
    const int r = split * kWK + tid;
    hpos = (r / g.w) % g.h;
    wpos = r % g.w;
  }

  // Stage the block's chunk q (rows split * kWK + q * step ...) into ring
  // slot q % kWStages and commit one cp.async group (empty past the end).
  auto stage_chunk = [&](int q) {
#ifdef FLAT_WGRAD_SKIP_COPIES  // timing build of scripts/torch_wgrad_parts.py only
    if (q >= kWStages - 1) {
      cp_async_commit();
      return;
    }
#endif
    const int st = q % kWStages;
    unsigned short* ds = smem + st * kWK * N;
    unsigned short* xs = smem + lay.x + st * lay.x_stage;
    const long long r0 = split * kWK + (long long)q * step;
    if (r0 < g.rows) {
      const long long xr0 = r0 + xoff;
      for (int e = tid; e < args.win * (kWTileC / 8); e += kThreads) {
        const int i = e / (kWTileC / 8), p = e % (kWTileC / 8);
        const long long row = xr0 + i;
        const int ch = c0 + 8 * p;
        const bool ok = row >= 0 && row < g.rows && ch < g.c;
        unsigned short* dst = xs + i * kWXLd + 8 * p;
        if (args.x_mode == kVec) {
          cp_async16(dst, ok ? x + row * g.c + ch : x, ok ? 16 : 0);
        } else {
          *reinterpret_cast<uint4*>(dst) = load8(x, row, ch, g.c, ok).u;
        }
      }
      if (args.dy_mode == kSpan) {
        // rows [r0, r0 + kWK) x all O channels as they lie: kWK * O / 8 pieces
        const char* base = reinterpret_cast<const char*>(dy);
        const long long at0 = r0 * g.o * 2, end = (long long)g.rows * g.o * 2;
        for (int e = tid; e < kWK / 8 * g.o; e += kThreads) {
          const long long at = at0 + 16LL * e;
          const int n = (int)max(0LL, min(16LL, end - at));
          cp_async16(ds + 8 * e, n > 0 ? base + at : base, n);
        }
      } else {
        for (int e = tid; e < kWK * NB; e += kThreads) {
          const int i = e / NB, p = e % NB;
          const long long row = r0 + i;
          const int ch = o0 + 8 * p;
          const bool ok = row < g.rows && ch < g.o;
          unsigned short* dst = ds + dy_at<N>(i, p);
          if (args.dy_mode == kVec) {
            cp_async16(dst, ok ? dy + row * g.o + ch : dy, ok ? 16 : 0);
          } else {
            *reinterpret_cast<uint4*>(dst) = load8(dy, row, ch, g.o, ok).u;
          }
        }
      }
      if (tid < kWK) {  // warps 0 and 1, whole
        const bool in = r0 + tid < g.rows;
        const int hz = hpos + dh;
        const bool hok = in && hz >= 0 && hz < g.h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int wz = wpos + (b0 + j) * g.dil - g.pad;
          const unsigned bits = __ballot_sync(0xffffffffu, hok && wz >= 0 && wz < g.w);
          if (lane == 0) masks[(st * kWMaxTaps + j) * 2 + warp] = bits;
        }
        wpos += step;
        if (wpos >= g.w) {
          const int wraps = wpos / g.w;
          wpos -= wraps * g.w;
          hpos = (hpos + wraps) % g.h;
        }
      }
    }
    cp_async_commit();
  };

  float acc[NT][N / 2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int q = 0; q < kWStages - 1; ++q) stage_chunk(q);

  for (int s = 0; s < nchunks; ++s) {
    cp_async_wait<kWStages - 2>();  // chunk s has landed (this thread's copies)
    fence_proxy_async();            // ... where the tensor cores read it
    __syncthreads();                // everyone's copies; chunk s-1 is done with
    stage_chunk(s + kWStages - 1);  // into chunk s-1's slot
    const int st = s % kWStages;
    const unsigned short* ds = smem + st * kWK * N;
    const unsigned short* xs = smem + lay.x + st * lay.x_stage;
    if (args.dy_mode == kSpan) {  // [kWK][O] as it lay in memory -> the tile
      for (int e = tid; e < kWK * NB; e += kThreads) {
        const int i = e / NB, p = e % NB;
        Pack8 v;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int o = 8 * p + k;
          v.s[k] = o < g.o ? ds[i * g.o + o] : 0;
        }
        *reinterpret_cast<uint4*>(dpad + dy_at<N>(i, p)) = v.u;
      }
      fence_proxy_async();
      __syncthreads();
      ds = dpad;
    }
    unsigned long long valid[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t* m = masks + (st * kWMaxTaps + j) * 2;
      valid[j] = m[0] | (unsigned long long)m[1] << 32;
    }
    // this warp's A = x^T fragments of rows k0 .. k0+15 for every tap, masked
    auto load_a = [&](uint32_t (&af)[NT][4], int k0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) break;
        // tap b0 + j: the window shifted by j * dil rows. Matrices:
        // (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
        ldsm_x4_trans(af[j], xs + (j * g.dil + k0 + mrow + (mat >> 1) * 8) * kWXLd +
                                 warp * 16 + (mat & 1) * 8);
        if (valid[j] != ~0ull) {
          // registers 0, 1 hold rows k0 + 2t, +1 (low, high half); 2, 3 rows
          // k0 + 2t + 8, +9
          const unsigned v = (unsigned)(valid[j] >> (k0 + 2 * (lane & 3)));
          const uint32_t lo = ((v & 1u) ? 0x0000ffffu : 0u) | ((v & 2u) ? 0xffff0000u : 0u);
          const uint32_t hi = ((v & 0x100u) ? 0x0000ffffu : 0u) |
                              ((v & 0x200u) ? 0xffff0000u : 0u);
          af[j][0] &= lo;
          af[j][1] &= lo;
          af[j][2] &= hi;
          af[j][3] &= hi;
        }
      }
    };
#ifdef FLAT_WGRAD_SKIP_PRODUCTS  // timing build of scripts/torch_wgrad_parts.py only
    if (nt > 0) continue;
#endif
    const uint32_t dyb = static_cast<uint32_t>(__cvta_generic_to_shared(ds));
    uint32_t af[2][NT][4];
    load_a(af[0], 0);
#pragma unroll
    for (int ks = 0; ks < kWK / 16; ++ks) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) break;
        wgmma_bf16<N>(acc[j], af[ks & 1][j], b_desc<N>(dyb + ks * 32 * N));
      }
      wgmma_commit();
      if (ks + 1 < kWK / 16) {
        wgmma_wait<1>();  // the group before this one read the other A set
        load_a(af[(ks + 1) & 1], (ks + 1) * 16);
      }
    }
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  // accumulator e: row g (+8 for e % 4 >= 2), column 8 (e / 4) + 2t (+1 for odd e)
  const int tap0 = a * g.kw + b0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
    float* out = partial + ((size_t)blockIdx.y * g.kh * g.kw + tap0 + j) * g.c * g.o;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int c = c0 + warp * 16 + (lane >> 2) + ((e & 2) ? 8 : 0);
      const int o = o0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      if (c < g.c && o < g.o) out[(size_t)c * g.o + o] = acc[j][e];
    }
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

// f(flat_wgrad<NT, N>) for the o tile N and the taps a block holds.
template <typename F>
cudaError_t wgrad_dispatch(int tile_o, int taps, F&& f) {
  const bool many = taps > 1;
  switch (tile_o) {
    case 24: return many ? f(flat_wgrad<kWMaxTaps, 24>) : f(flat_wgrad<1, 24>);
    case 32: return many ? f(flat_wgrad<kWMaxTaps, 32>) : f(flat_wgrad<1, 32>);
    default: return many ? f(flat_wgrad<kWMaxTaps, 64>) : f(flat_wgrad<1, 64>);
  }
}

}  // namespace

extern "C" {

// dW (kh, kw, C, O) fp32 from bf16 x (N, H, W, C) and dy (N, H, W, O).
// Launches flat_wgrad with an o tile of tile_o (24, 32 or 64) and `taps`
// (1 to 3) taps of a tap row per block, on a grid of (kh * ceil(kw / taps)
// * ceil(C / 64) * ceil(O / tile_o), splits); split s takes the chunks of 64
// rows s, s + splits, s + 2 splits, ... With splits == 1 the partial is
// `out` itself and no reduction runs; otherwise `partial` holds splits *
// kh*kw*C*O floats and flat_wgrad_reduce sums it into `out`. x and dy must
// be 16-byte aligned. Returns a CUDA error code: that of a refused
// shared-memory size, or cudaGetLastError() after the launches.
int flat_conv_wgrad(const void* x, const void* dy, void* partial, void* out,
                    int n, int h, int w, int c, int o, int kh, int kw, int pad,
                    int dil, int tile_o, int taps, int splits, void* stream) {
  if ((tile_o != 24 && tile_o != 32 && tile_o != 64) || taps < 1 ||
      taps > kWMaxTaps || splits < 1 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  WgradArgs a;
  a.g = make_geom(n, h, w, c, o, kh, kw, pad, dil);
  a.taps = taps;
  a.groups = (kw + taps - 1) / taps;
  a.win = kWK + (taps - 1) * dil;
  a.x_mode = c % 8 == 0 ? kVec : kScalar;
  a.dy_mode = o % 8 == 0 ? kVec : (o <= tile_o ? kSpan : kScalar);
  const WgradSmem lay = wgrad_smem(tile_o, a.win, a.dy_mode == kSpan);
  const long long tiles = (long long)kh * a.groups * ((c + kWTileC - 1) / kWTileC) *
                          ((o + tile_o - 1) / tile_o);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  auto s = static_cast<cudaStream_t>(stream);
  float* target = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const auto* xp = static_cast<const unsigned short*>(x);
  const auto* dyp = static_cast<const unsigned short*>(dy);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, lay.bytes, s>>>(xp, dyp, target, a);
    return cudaGetLastError();
  };
  cudaError_t err = wgrad_dispatch(tile_o, taps, launch);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long elems = (long long)kh * kw * c * o;
  const int blocks = (int)((elems + kReduceThreads - 1) / kReduceThreads);
  flat_wgrad_reduce<<<blocks, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), splits, elems);
  return (int)cudaGetLastError();
}

// Blocks of flat_wgrad resident on one SM for the launch flat_conv_wgrad
// makes with these arguments (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the shared-memory attribute is set), or minus a CUDA error code.
// Writes the dynamic shared memory per block to *smem_bytes.
int flat_conv_wgrad_occupancy(int o, int dil, int tile_o, int taps, int* smem_bytes) {
  if ((tile_o != 24 && tile_o != 32 && tile_o != 64) || taps < 1 || taps > kWMaxTaps) {
    return -(int)cudaErrorInvalidValue;
  }
  const bool span = o % 8 != 0 && o <= tile_o;
  const WgradSmem lay = wgrad_smem(tile_o, kWK + (taps - 1) * dil, span);
  *smem_bytes = lay.bytes;
  int blocks = 0;
  auto query = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                        lay.bytes);
    }
    return e;
  };
  const cudaError_t err = wgrad_dispatch(tile_o, taps, query);
  return err == cudaSuccess ? blocks : -(int)err;
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
