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

// dgrad (flat_dgrad<N, KO>), warp specialised: warpgroup products (wgmma)
// fed by a producer warpgroup through a cp.async ring and mbarriers:
//   * a block is three warpgroups on a tile of 128 dx rows x an N-wide c
//     tile (N = 64, 128 or 256: all of C up to 256, so dy is read once per
//     c tile). Warpgroups 0 and 1 multiply: each owns 64 rows and all N
//     channels in ONE set of N/2 fp32 accumulators a thread, into which
//     every tap and o chunk sums. Warpgroup 2 issues every copy. The grid
//     is one wave (the wrapper sizes it from the kernel's own occupancy,
//     flat_conv_dgrad_occupancy): block b walks the tiles b, b + blocks, ...
//     and its ring runs on from one tile into the next, so the next tile's
//     copies overlap this tile's products and epilogue;
//   * K = taps x O. A stage is one tap row a, its taps (all kw of them
//     where the window and the ring allow) and one o chunk of KO (32 or
//     64): ONE dy window of 128 + (taps - 1) * d rows, as tap b reads rows
//     r - off(a, b) and neighbouring taps are the same window shifted by d
//     rows, which costs ldmatrix nothing. dy crosses from L2 kh times (0.46
//     GB at stem_conv2), not kh * kw times (1.4 GB);
//   * products: wgmma.m64nNk16 (N <= 128; two of them at N = 256), M =
//     rows, N = c, K = o. A = dy comes from the window by ldmatrix into
//     registers, where the mask is applied by select: an A register holds
//     two o of one row, so a row whose partner pixel is off the image
//     zeroes whole registers. B = W is read by the tensor cores from shared
//     memory, K-major (o contiguous, as the weight lies) in the 128- or
//     64-byte swizzle. Where there is one c tile and the whole weight fits
//     beside the ring (stem_conv2, stem_conv3, the UperNet head), it is
//     staged once per block and stays; otherwise each stage brings its taps'
//     tiles. The wrapper pads the weight's O to a multiple of 8 with zeros
//     (the tensor map's row stride must be a multiple of 16 bytes);
//   * staging into a ring of 3 slots: the weight tiles by TMA (one thread;
//     a 3-d tensor map over (kh*kw, C, O) whose box is one tile, in the
//     tile's swizzle, zero past C and O), the dy windows by the producer's
//     cp.async (16 bytes, .cg). mbarrier full[s] completes when the
//     producer's 128 threads have seen their copies of slot s land (and
//     fenced them for the tensor cores) and the TMA bytes have arrived;
//     empty[s] when the 256 consumer threads have read it. Rows outside
//     [0, N*H*W) are zero-filled through the copy's source size 0, so NaN
//     just outside dy cannot reach dx. O not a multiple of 8 (the
//     head's 19): the window's rows are one contiguous span, copied from the
//     16-byte boundary at or before it and laid out by the producer into
//     the window, zero past O (K padded to 32); O past one chunk and not a
//     multiple of 8 takes 2-byte loads;
//   * epilogue: each consumer warp rounds its 16 rows to bf16 into its own
//     tile of shared memory, 64 channels at a time, and writes whole 16-byte
//     pieces of dx rows, 8 lanes to a row's 128 bytes (2-byte stores where
//     C is not a multiple of 8). Rows past the end and channels past C are
//     not written. No reduction across blocks.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_dgrad_parts.py
// times builds that skip the copies or the products): the products, at
// every full-width layer. Without its copies the kernel takes 0.34 of its
// 0.39 ms at stem_conv2 (about 250 TFLOP/s at N = 64) and 0.62-0.64 of
// 0.70-0.71 ms at layer4 and FPN.smooth_conv.0 (about 560 TFLOP/s at
// N = 256); the copies, 0.25-0.49 ms alone, run under the products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // wgrad: one warpgroup
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

// ---- dgrad ----
constexpr int kDConsumers = 256;            // two consumer warpgroups
constexpr int kDProducers = 128;            // one producer warpgroup
constexpr int kDThreads = kDConsumers + kDProducers;
constexpr int kDM = 128;        // dx rows of a block tile: 64 a warpgroup
constexpr int kDStages = 3;     // depth of the cp.async ring
constexpr int kDSubTaps = 3;    // taps whose A fragments a thread holds at once
constexpr int kDEpLd = 72;      // epilogue row stride: 64 c + 8, 144 bytes
constexpr int kDEpBytes = (kDConsumers / 32) * 16 * kDEpLd * 2;  // 16 rows a warp

// Products with B K-major (o contiguous), read by descriptor: D (64 x N,
// fp32) = A (64 x 16, registers) * B (16 x N, shared memory) + D, or
// without "+ D" where accumulate is 0; imm-trans-b 0.
__device__ __forceinline__ void wgmma_k_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_k_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int NW>
__device__ __forceinline__ void wgmma_k(float (&d)[NW / 2], const uint32_t (&a)[4],
                                        uint64_t desc, int accumulate) {
  if constexpr (NW == 64) wgmma_k_n64(d, a, desc, accumulate);
  else wgmma_k_n128(d, a, desc, accumulate);
}

// Descriptor of a K-major weight tile at shared address `addr`: rows of KO
// bf16 (one c each) in the 128-byte (KO = 64) or 64-byte (KO = 32) swizzle,
// laid out by dy_at<KO>; the base is 1024-byte aligned. Leading byte offset
// unused (1); stride byte offset: 8 rows.
template <int KO>
__device__ __forceinline__ uint64_t wk_desc(uint32_t addr) {
  constexpr uint64_t sbo = KO * 16, layout = KO == 64 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (sbo >> 4) << 32 |
         layout << 62;
}

// mbarriers in shared memory (CTA scope): init with the count of arrivals a
// phase takes, arrive (release), and wait for the phase of the given parity
// to complete (acquire).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
// the producer warpgroup's own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kDProducers) : "memory");
}

struct DgradArgs {
  Geom g;
  int ow;       // o stride of the weight: O rounded up to a multiple of 8
  int taps;     // taps of a tap row one stage holds
  int groups;   // ceil(kw / taps): stages per tap row and o chunk
  int win;      // window rows a slot holds: kDM + (taps - 1) * dil
  int chunks;   // ceil(O / KO)
  int dy_mode;  // WStage: kVec, kScalar or kSpan
  int resident; // the weight of the one c tile stays in shared memory
  int ctiles;   // ceil(C / N)
  int tiles;    // row tiles x c tiles
};

// Shared-memory layout of flat_dgrad<N, KO>, in bytes from a 1024-byte
// aligned base: the weight tiles (N rows x KO, dy_at<KO>; all kh*kw*chunks
// of them when resident, else kDStages x taps), then kDStages dy windows
// (win rows x (KO + 8) bf16: 144 or 80 bytes, so the eight rows an
// ldmatrix reads hit distinct banks), then for a dy span kDStages raw
// spans, then each warp's epilogue tile. `bytes` includes the alignment
// slack. Mirrored by dgrad_smem_bytes in segtpu_torch/ops/flatconv.py.
struct DgradSmem {
  int win, raw, span, ep, bytes;
};

__host__ __device__ inline DgradSmem dgrad_smem(int tile_c, int ko, int taps, int dil,
                                                int o, int kh, int kw, bool resident) {
  DgradSmem s;
  const int chunks = (o + ko - 1) / ko;
  const int win = kDM + (taps - 1) * dil;
  const bool span = o % 8 != 0 && o <= ko;
  s.win = (resident ? kh * kw * chunks : kDStages * taps) * tile_c * ko * 2;
  s.raw = s.win + kDStages * win * (ko + 8) * 2;
  s.span = span ? (win * o * 2 + 15) / 16 * 16 + 16 : 0;
  s.ep = s.raw + kDStages * s.span;
  s.bytes = s.ep + kDEpBytes + 1024;
  return s;
}

// One stage of a block: tap row a, taps b0 .. b0+nt-1, o chunk ch, of the
// block's tile of rows r0 .. r0+kDM-1 and channels c0 .. c0+N-1.
struct DStage {
  int r0, c0, a, b0, nt, ch;
  bool first, last;
};

// grid: x = blocks, each walking the tiles t = blockIdx.x, + gridDim.x, ...
// (tile t: row tile t / ctiles, c tile t % ctiles; c fastest). Warp
// specialised: warpgroups 0 and 1 multiply, warpgroup 2 copies. Consumer
// warpgroup v owns dx rows 64v .. 64v+63 of the tile and all N channels, in
// one set of N / 2 fp32 accumulators a thread. Products: M = rows, N = c,
// K = taps x o; A = dy from the window by ldmatrix into registers (masked
// there), B = W from shared memory by descriptor. The ring's slots pass
// between the two roles through mbarriers: full[s] (the producer's 128
// threads arrive once the slot's copies have landed) and empty[s] (the 256
// consumer threads arrive once their products have read it).
template <int N, int KO>
__global__ void __launch_bounds__(kDThreads, 1)
flat_dgrad(const unsigned short* __restrict__ dy,
           unsigned short* __restrict__ dx, DgradArgs args,
           const __grid_constant__ CUtensorMap wmap) {
  constexpr int NW = N < 128 ? N : 128;  // width of one wgmma
  constexpr int NH = N / NW;             // wgmmas per tap and k step
  constexpr int KP = KO / 8;             // 16-byte pieces of a staged row
  constexpr int WLD = KO + 8;            // window row stride, in bf16
  constexpr int TILE = N * KO;           // bf16 of one weight tile
  extern __shared__ uint4 dgrad_smem_raw[];
  __shared__ uint64_t full[kDStages], empty[kDStages];
  const uint32_t raw_addr = smem_u32(dgrad_smem_raw);
  unsigned char* base = reinterpret_cast<unsigned char*>(dgrad_smem_raw) +
                        (((raw_addr + 1023) & ~1023u) - raw_addr);
  const Geom& g = args.g;
  const bool span = args.dy_mode == kSpan;
  const DgradSmem lay = dgrad_smem(N, KO, args.taps, g.dil, g.o, g.kh, g.kw, args.resident);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(base);
  unsigned short* winsm = reinterpret_cast<unsigned short*>(base + lay.win);
  unsigned char* rawsm = base + lay.raw;

  const int tid = threadIdx.x;
  const int per_tile = g.kh * args.groups * args.chunks;
  const int nstages = (args.tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                      (int)gridDim.x * per_tile;

  auto decode = [&](int q) {
    DStage st;
    const int t = blockIdx.x + q / per_tile * gridDim.x;
    int s = q % per_tile;
    st.first = s == 0;
    st.last = s == per_tile - 1;
    st.r0 = t / args.ctiles * kDM;
    st.c0 = t % args.ctiles * N;
    st.ch = s % args.chunks;
    s /= args.chunks;
    st.b0 = s % args.groups * args.taps;
    st.a = s / args.groups;
    st.nt = min(args.taps, g.kw - st.b0);
    return st;
  };
  // first dy row of a stage's window: tap b reads rows r - off(a, b), so the
  // window starts at the group's last tap and tap b sits (b0 + nt - 1 - b) *
  // dil rows further in
  auto window_start = [&](const DStage& st) {
    return (long long)st.r0 - (long long)(st.a * g.dil - g.pad) * g.w + g.pad -
           (long long)(st.b0 + st.nt - 1) * g.dil;
  };

  if (tid == 0) {
    for (int s = 0; s < kDStages; ++s) {
      mbar_init(&full[s], kDProducers);
      mbar_init(&empty[s], kDConsumers);
    }
  }
  __syncthreads();

  if (tid >= kDConsumers) {
    // ---- producer warpgroup: the copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int ptid = tid - kDConsumers;
    // the weight tile of tap (a, b), o chunk ch, c tile from c0 -> dst, by
    // TMA: N rows x KO o in the swizzle dy_at<KO> describes, zero past C and
    // past the weight's padded O
    auto stage_weight = [&](unsigned short* dst, uint64_t* bar, int a, int b, int ch, int c0) {
      tma_load_3d(dst, &wmap, bar, ch * KO, c0, a * g.kw + b);
    };
    if (args.resident && ptid == 0) {  // the whole weight of the one c tile, once
      const int tiles = g.kh * g.kw * args.chunks;
      mbar_expect_tx(&full[0], tiles * TILE * 2);
      for (int t = 0; t < tiles; ++t) {
        stage_weight(wsm + t * TILE, &full[0], t / args.chunks / g.kw, t / args.chunks % g.kw,
                     t % args.chunks, 0);
      }
    }
    // Iteration q issues stage q's copies (its dy window, and its weight
    // tiles unless they are resident) into slot q % kDStages once the
    // consumers have released it, then hands stage q-1 over: this thread's
    // copies of it have landed, the raw span (where there is one) is laid
    // out, and the fence orders the writes before the tensor cores' reads.
    // Rows outside [0, rows) are zero-filled through the copy's source size
    // 0 and never read.
    for (int q = 0; q <= nstages; ++q) {
      if (q < nstages) {
        const int slot = q % kDStages;
        if (q >= kDStages) mbar_wait(&empty[slot], (q / kDStages - 1) & 1);
#ifdef FLAT_DGRAD_SKIP_COPIES  // timing build of scripts/torch_dgrad_parts.py only
        if (q < kDStages) {
#endif
        const DStage st = decode(q);
        const long long ws = window_start(st);
        const int need = kDM + (st.nt - 1) * g.dil;
        if (span) {
          // rows [ws, ws + need) x all O channels as they lie, from the
          // 16-byte boundary at or before them; pieces outside the tensor
          // read nothing
          const char* src = reinterpret_cast<const char*>(dy);
          const long long at0 = (ws * g.o * 2) & ~15LL;
          const long long end = (long long)g.rows * g.o * 2;
          const int pieces = (int)(((ws + need) * g.o * 2 - at0 + 15) / 16);
          unsigned char* dst = rawsm + slot * lay.span;
          for (int e = ptid; e < pieces; e += kDProducers) {
            const long long at = at0 + 16LL * e;
            const int nb = at < 0 ? 0 : (int)max(0LL, min(16LL, end - at));
            cp_async16(dst + 16 * e, nb > 0 ? src + at : src, nb);
          }
        } else {
          unsigned short* dst = winsm + slot * args.win * WLD;
          for (int e = ptid; e < need * KP; e += kDProducers) {
            const int i = e / KP, p = e % KP;
            const long long row = ws + i;
            const int ch = st.ch * KO + 8 * p;
            const bool ok = row >= 0 && row < g.rows && ch < g.o;
            if (args.dy_mode == kVec) {
              cp_async16(dst + i * WLD + 8 * p, ok ? dy + row * g.o + ch : dy, ok ? 16 : 0);
            } else {
              *reinterpret_cast<uint4*>(dst + i * WLD + 8 * p) =
                  load8(dy, row, ch, g.o, ok).u;
            }
          }
        }
        if (!args.resident && ptid == 0) {
          mbar_expect_tx(&full[slot], st.nt * TILE * 2);
          for (int j = 0; j < st.nt; ++j) {
            stage_weight(wsm + (slot * args.taps + j) * TILE, &full[slot], st.a, st.b0 + j,
                         st.ch, st.c0);
          }
        }
#ifdef FLAT_DGRAD_SKIP_COPIES
        }
#endif
        cp_async_commit();
      }
      if (q > 0) {
        const int p = q - 1;
        if (q < nstages) cp_async_wait<1>();
        else cp_async_wait<0>();
        if (span) {  // the raw span -> the window, zero past O
          producer_sync();  // every producer thread's pieces have landed
          const DStage st = decode(p);
          const int slot = p % kDStages;
          const int need = kDM + (st.nt - 1) * g.dil;
          const long long ws = window_start(st);
          const unsigned short* rs =
              reinterpret_cast<const unsigned short*>(rawsm + slot * lay.span) +
              ((ws * g.o * 2) & 15) / 2;
          unsigned short* dst = winsm + slot * args.win * WLD;
          for (int e = ptid; e < need * KP; e += kDProducers) {
            const int i = e / KP, pc = e % KP;
            Pack8 v;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int o = 8 * pc + k;
              v.s[k] = o < g.o ? rs[i * g.o + o] : 0;
            }
            *reinterpret_cast<uint4*>(dst + i * WLD + 8 * pc) = v.u;
          }
        }
        fence_proxy_async();
        mbar_arrive(&full[p % kDStages]);
      }
    }
  } else {
    // ---- consumer warpgroups: the products and the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int mat = lane >> 3;  // which 8x8 matrix this lane addresses
    const int mrow = lane & 7;  // which of its rows
    const int rbase = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's 16 dx rows
    float acc[NH][NW / 2];  // set by each tile's first product
#pragma unroll
    for (int hn = 0; hn < NH; ++hn)
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) acc[hn][e] = 0.f;
    // image coordinates of this thread's two dx rows (rbase + g, + 8) of the
    // current tile; a row past the end is never valid
    int hlo = 0, wlo = 0, hhi = 0, whi = 0;
    bool inlo = false, inhi = false;

    for (int q = 0; q < nstages; ++q) {
      const DStage st = decode(q);
      const int slot = q % kDStages;
      mbar_wait(&full[slot], (q / kDStages) & 1);
      const unsigned short* win = winsm + slot * args.win * WLD;
      if (st.first) {
        const int rlo = st.r0 + rbase + (lane >> 2), rhi = rlo + 8;
        inlo = rlo < g.rows;
        inhi = rhi < g.rows;
        hlo = rlo / g.w % g.h;
        wlo = rlo % g.w;
        hhi = rhi / g.w % g.h;
        whi = rhi % g.w;
      }
      const int dh = st.a * g.dil - g.pad;
      const bool hlo_ok = inlo && hlo - dh >= 0 && hlo - dh < g.h;
      const bool hhi_ok = inhi && hhi - dh >= 0 && hhi - dh < g.h;
#ifdef FLAT_DGRAD_SKIP_PRODUCTS  // timing build of scripts/torch_dgrad_parts.py only
      if (st.nt < 0)
#endif
      for (int j0 = 0; j0 < st.nt; j0 += kDSubTaps) {
        // this warp's A = dy fragments of k step ks for taps j0 .. j0+2,
        // masked by select: registers 0 and 2 hold row g, 1 and 3 row g + 8
        auto load_a = [&](uint32_t (&f)[kDSubTaps][4], int ks) {
#pragma unroll
          for (int j = 0; j < kDSubTaps; ++j) {
            if (j0 + j >= st.nt) break;
            const int b = st.b0 + j0 + j;
            const int shift = (st.b0 + st.nt - 1 - b) * g.dil;
            // matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
            ldsm_x4(f[j], win + (rbase + mrow + (mat & 1) * 8 + shift) * WLD + ks * 16 +
                              (mat >> 1) * 8);
            const int dw = b * g.dil - g.pad;
            if (!(hlo_ok && wlo - dw >= 0 && wlo - dw < g.w)) f[j][0] = f[j][2] = 0u;
            if (!(hhi_ok && whi - dw >= 0 && whi - dw < g.w)) f[j][1] = f[j][3] = 0u;
          }
        };
        // A sets in registers: at N = 64 (32 accumulators) all of the
        // stage's k steps, loaded first and multiplied as one group; wider,
        // two, loaded one k step ahead of the products
        constexpr bool kAllA = N == 64;
        uint32_t af[kAllA ? KO / 16 : 2][kDSubTaps][4];
#pragma unroll
        for (int ks = 0; ks < (kAllA ? KO / 16 : 1); ++ks) load_a(af[ks], ks);
#pragma unroll
        for (int ks = 0; ks < KO / 16; ++ks) {
          const int set = kAllA ? ks : ks & 1;
          if (!kAllA || ks == 0) wgmma_fence();
#pragma unroll
          for (int j = 0; j < kDSubTaps; ++j) {
            if (j0 + j >= st.nt) break;
            const int b = st.b0 + j0 + j;
            const unsigned short* tile =
                wsm + (args.resident ? (st.a * g.kw + b) * args.chunks + st.ch
                                     : slot * args.taps + j0 + j) * TILE;
            const uint32_t addr = smem_u32(tile) + ks * 32;
            // a tile's first product overwrites the accumulators: zeroing
            // them by hand inside the pipeline would serialise the wgmma
            const int accumulate = ks > 0 || j > 0 || j0 > 0 || !st.first;
#pragma unroll
            for (int hn = 0; hn < NH; ++hn) {
              wgmma_k<NW>(acc[hn], af[set][j], wk_desc<KO>(addr + hn * NW * KO * 2),
                          accumulate);
            }
          }
          if (!kAllA) {
            wgmma_commit();
            if (ks + 1 < KO / 16) {
              wgmma_wait<1>();  // the group before this one read the other A set
              load_a(af[(ks + 1) & 1], ks + 1);
            }
          }
        }
        if (kAllA) wgmma_commit();
        wgmma_wait<0>();
      }
      mbar_arrive(&empty[slot]);  // this thread is done with the slot

      if (st.last) {
        // Epilogue: each warp rounds its 16 rows to bf16 into its own tile
        // of shared memory, 64 channels at a time, and writes them back as
        // whole 16-byte pieces of dx rows (8 lanes to a row's 128 bytes).
        unsigned short* ep =
            reinterpret_cast<unsigned short*>(base + lay.ep) + warp * 16 * kDEpLd;
#pragma unroll
        for (int j = 0; j < N / 64; ++j) {
          const int hn = 64 * j / NW, e0 = 64 * j % NW / 2;
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            // accumulator e0 + e: row g (+8 for e % 4 >= 2), column 8 (e / 4) + 2t
            const int row = (lane >> 2) + ((e & 2) ? 8 : 0);
            const int col = 8 * (e >> 2) + 2 * (lane & 3);
            *reinterpret_cast<__nv_bfloat162*>(ep + row * kDEpLd + col) =
                __floats2bfloat162_rn(acc[hn][e0 + e], acc[hn][e0 + e + 1]);
          }
          __syncwarp();
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int piece = lane + 32 * m, row = piece >> 3, p = piece & 7;
            const long long r = (long long)st.r0 + rbase + row;
            const int c = st.c0 + 64 * j + 8 * p;
            if (r < g.rows && c < g.c) {
              const uint4 v = *reinterpret_cast<const uint4*>(ep + row * kDEpLd + 8 * p);
              unsigned short* out = dx + r * g.c + c;
              if ((g.c & 7) == 0) {
                *reinterpret_cast<uint4*>(out) = v;
              } else {
                Pack8 pk;
                pk.u = v;
                for (int k = 0; k < 8 && c + k < g.c; ++k) out[k] = pk.s[k];
              }
            }
          }
          __syncwarp();
        }
      }
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

// f(flat_dgrad<N, KO>) for the c tile N and the o chunk KO, or
// cudaErrorInvalidValue for a pair with no instance.
template <typename F>
cudaError_t dgrad_dispatch(int tile_c, int ko, F&& f) {
  if (ko == 32) {
    switch (tile_c) {
      case 64: return f(flat_dgrad<64, 32>);
      case 128: return f(flat_dgrad<128, 32>);
      case 256: return f(flat_dgrad<256, 32>);
    }
  } else if (ko == 64) {
    switch (tile_c) {
      case 64: return f(flat_dgrad<64, 64>);
      case 128: return f(flat_dgrad<128, 64>);
    }
  }
  return cudaErrorInvalidValue;
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

// Blocks of flat_dgrad resident on one SM for the launch flat_conv_dgrad
// makes with these arguments (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the shared-memory attribute is set), or minus a CUDA error code.
// Writes the dynamic shared memory per block to *smem_bytes.
int flat_conv_dgrad_occupancy(int o, int kh, int kw, int dil, int tile_c, int ko,
                              int taps, int resident, int* smem_bytes) {
  if (taps < 1 || taps > kw) return -(int)cudaErrorInvalidValue;
  const int bytes = dgrad_smem(tile_c, ko, taps, dil, o, kh, kw, resident != 0).bytes;
  *smem_bytes = bytes;
  int blocks = 0;
  auto query = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kDThreads, bytes);
    }
    return e;
  };
  const cudaError_t err = dgrad_dispatch(tile_c, ko, query);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The weight (kh*kw, C, ow) as a 3-d tensor map whose box is one tile of
// the kernel: KO o x tile_c channels of one tap, in the 128-byte (KO = 64)
// or 64-byte (KO = 32) swizzle, zero-filled past C and ow.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t weight_map(CUtensorMap* map, const void* wt, int c, int ow, int taps, int tile_c,
                       int ko) {
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
  const cuuint64_t dims[3] = {(cuuint64_t)ow, (cuuint64_t)c, (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)ow * 2, (cuuint64_t)c * ow * 2};
  const cuuint32_t box[3] = {(cuuint32_t)ko, (cuuint32_t)tile_c, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            ko == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dx (N, H, W, C) bf16 from bf16 dy (N, H, W, O) and the weight laid out
// (kh, kw, C, ow), ow = O rounded up to a multiple of 8 (zeros past O).
// Launches flat_dgrad<tile_c, ko> on `blocks` blocks that walk the tiles
// of 128 rows x tile_c channels; a stage holds `taps` taps of a tap row;
// `resident` keeps the whole weight in shared memory (one c tile only).
// dy, the weight and dx must be 16-byte aligned. Returns a CUDA error code:
// that of a refused shared-memory size, or cudaGetLastError() after the
// launch.
int flat_conv_dgrad(const void* dy, const void* wt, void* dx, int n, int h,
                    int w, int c, int o, int ow, int kh, int kw, int pad, int dil,
                    int tile_c, int ko, int taps, int resident, int blocks,
                    void* stream) {
  DgradArgs a;
  a.g = make_geom(n, h, w, c, o, kh, kw, pad, dil);
  a.ow = ow;
  a.taps = taps;
  a.groups = taps > 0 ? (kw + taps - 1) / taps : 0;
  a.win = kDM + (taps - 1) * dil;
  a.chunks = ko > 0 ? (o + ko - 1) / ko : 0;
  a.dy_mode = o % 8 == 0 ? kVec : (o <= ko ? kSpan : kScalar);
  a.resident = resident;
  a.ctiles = tile_c > 0 ? (c + tile_c - 1) / tile_c : 0;
  const long long tiles = (long long)((a.g.rows + kDM - 1) / kDM) * a.ctiles;
  if (taps < 1 || taps > kw || ow % 8 != 0 || ow < o || blocks < 1 || blocks > tiles ||
      tiles > 0x7fffffffLL || (resident && a.ctiles != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  a.tiles = (int)tiles;
  const int bytes = dgrad_smem(tile_c, ko, taps, dil, o, kh, kw, resident != 0).bytes;
  CUtensorMap wmap;
  const cudaError_t err = weight_map(&wmap, wt, c, ow, kh * kw, tile_c, ko);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dyp = static_cast<const unsigned short*>(dy);
  auto* dxp = static_cast<unsigned short*>(dx);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kDThreads, bytes, s>>>(dyp, dxp, a, wmap);
    return cudaGetLastError();
  };
  return (int)dgrad_dispatch(tile_c, ko, launch);
}

}  // extern "C"
