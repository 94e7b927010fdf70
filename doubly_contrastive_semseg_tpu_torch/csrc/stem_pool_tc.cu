// Fused ResNet stem of the SwiftNet pyramid for Hopper (sm_90a), bf16 on
// tensor cores:
//   7x7 / stride 2 / pad 3 conv over RGB -> folded eval BatchNorm -> ReLU
//   -> 3x3 / stride 2 / pad 1 max-pool,
// in one pass; the pre-pool activation never reaches device memory.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/stem_pallas.py:123
// fused_stem_pool (_stem_kernel), with its numerics: bf16 products, f32 sums
// (stem_pallas.py:80-83). That kernel packs the conv as a space-to-depth 4x4
// conv to fill a 128-wide matrix unit; none of that is carried over.
//
// Bound: operations. 147 multiply-adds per conv output and channel: at a
// batch of 8 2048x1024 frames the three pyramid levels do 103.5 GFLOP,
// 0.1047 ms on bf16 tensor cores at 989 TFLOP/s, against 308 MB of bf16
// input and output, 0.092 ms at 3.35 TB/s. This design executes 12 % more
// products than that (K 160 for 147, M 576 for 561), on mma.sync, whose
// own ceiling on the H100 is below the 989 TFLOP/s of wgmma
// (tools/stem_variants.py measures it).
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 accumulators).
// M = the conv positions of a tile, N = the 64 output channels, K = the taps
// in the order k = ky * 22 + 1 + 3 * kx + ci: each kernel row's 21 taps
// after one dummy tap, 154, zero-padded to 160 (10 k-steps of 16; the
// wrapper packs the weights so, with zero rows at the dummy and padding
// taps). A pooled tile of 8 x 16 outputs needs a 17 x 33 conv tile: 561
// positions, 36 M tiles of 16 (3 % waste); K wastes 8 %.
//  - The block stages the tile's halo'd input patch (39 rows x 74.7 pixels
//    x 3 channels, from the pixel 3 before the first one read, a multiple of
//    8) in shared memory as the image's bf16, with the conv's zero padding:
//    28 16-byte cp.async copies a row, each chunk wholly inside the image or
//    zero-filled (W % 8 == 0; other widths are staged word by word into the
//    same layout). Position (r, c) and tap k = 22 ky + j then sit at word
//    224 r + 4 + 3 c + 112 ky + j / 2 of the patch: rows are 224 bf16 and j
//    is even at every pair of taps, so each thread gathers its A fragment as
//    four aligned 32-bit loads through a k -> offset table held in registers
//    (no im2col slab). A conv position's first pixel is odd, 3 elements a
//    pixel, so its first element is odd: the dummy tap in front of each
//    kernel row is what makes every pair start even.
//  - The weights are staged once per block with 16-byte copies, already in
//    the order of the mma's B fragments (20 KB; the wrapper permutes the
//    packed (160, 64) operand): one 16-byte shared load gives a thread its B
//    of two n tiles.
//  - 6 warps; each owns 3 pairs of M tiles and all 64 channels, so each A
//    fragment feeds 8 products and each B fragment 2.
//  - Epilogue: scale/shift + ReLU on the accumulators, rounded to bf16 into
//    a conv tile in shared memory (rounding is monotone, so the max of the
//    rounded values is the rounded max); positions outside the conv output
//    are written as 0, which post-ReLU is the pool's -inf padding. Rows of
//    128 bytes, 16-byte chunks XOR-swizzled by the position, so the stores
//    and the pool's 16-byte loads are free of bank conflicts. The pool reads
//    9 chunks per output chunk and stores 16 bytes per thread, coalesced.
//  - A loop over tiles: as many blocks as fit (two an SM) walk the tiles, so
//    the weights are staged once a block, not once a tile. After a tile's
//    products the next tile's patch copies are issued and fly while the
//    pool runs and the SM's other block runs its products.
// Budget: shared memory: weights 20,480 + conv tile 71,808 + patch 17,472 +
// scale and shift 512 = 110,272 bytes a block, two blocks an SM (of 228 KB).
// Registers: ptxas (sm_90a, -O3, CUDA 12.8) reports 166 registers, 0 bytes
// of stack, 0 spill stores and loads, 1 barrier: 64 f32 accumulators (two M
// tiles x 8 n tiles x 4), the 20-entry tap table, and 166 x 192 threads x 2
// blocks = 63,744 of the SM's 65,536. chip_smoke.py prints the report on
// every build.
//
// f32 stays on the CUDA-core kernel (csrc/stem_pool.cu): the serving, eval
// and profile paths run bf16, and an f32 level is held to its plain version
// at 1e-4 x max|ref|, which bf16 products (8 bits of mantissa) cannot meet,
// nor TF32 products (10 bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUT = 64;
constexpr int TP = 8;                      // pooled rows a tile
constexpr int TQ = 16;                     // pooled cols a tile
constexpr int CR = 2 * TP + 1;             // conv rows of the tile
constexpr int CCOL = 2 * TQ + 1;           // conv cols of the tile
constexpr int NPOS = CR * CCOL;            // 561
constexpr int MT = (NPOS + 15) / 16;       // 36 M tiles
constexpr int IR = 2 * (CR - 1) + 7;       // 39 patch rows
constexpr int ROW_CHUNKS = 28;             // 16-byte chunks a patch row: 74.7 pixels
constexpr int ROW_W = 4 * ROW_CHUNKS;      // 112 words a patch row
constexpr int PATCH_W = IR * ROW_W;        // 4368 words
constexpr int KROW = 22;                   // taps a kernel row, the dummy included
constexpr int KTAPS = 7 * KROW;            // 154
constexpr int KSTEPS = 10;                 // K = 160
constexpr int NT = COUT / 8;               // n tiles of 8
constexpr int WARPS = 6;
constexpr int THREADS = 32 * WARPS;
constexpr int PAIRS = MT / 2;              // pairs of M tiles
constexpr int POOL_ITEMS = TP * TQ * (COUT / 8);
constexpr size_t WF_BYTES = (size_t)KSTEPS * (NT / 2) * 32 * 16;
constexpr size_t CONV_BYTES = (size_t)NPOS * COUT * 2;
constexpr size_t PATCH_BYTES = (size_t)PATCH_W * 4;
constexpr size_t AFF_BYTES = 2 * COUT * 4;
constexpr size_t SMEM_BYTES = WF_BYTES + CONV_BYTES + PATCH_BYTES + AFF_BYTES;
static_assert(KTAPS <= 16 * KSTEPS, "K covers every tap");
static_assert(MT % 2 == 0 && PAIRS % WARPS == 0, "every warp owns the same number of pairs");
static_assert(3 * (2 * (CCOL - 1) + 7 + 3) <= 8 * ROW_CHUNKS, "a patch row holds every pixel read");
static_assert(WF_BYTES % 16 == 0 && CONV_BYTES % 16 == 0 && PATCH_BYTES % 8 == 0,
              "each region keeps its alignment");

struct Tile {
  int b, p0, q0;  // image, first pooled row and col
};

__device__ __forceinline__ Tile tile_at(int tile, int ntx, int per_img) {
  Tile t;
  t.b = tile / per_img;
  const int rem = tile - t.b * per_img;
  const int ty = rem / ntx;
  t.p0 = ty * TP;
  t.q0 = (rem - ty * ntx) * TQ;
  return t;
}

// The patch of a tile starts at image row 4 p0 - 5 and pixel 4 q0 - 8 (a
// multiple of 8, so with W % 8 == 0 every patch row starts 16-byte aligned
// and each 16-byte chunk lies wholly inside or outside the image).

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Issues the 16-byte copies of the tile's patch, zero-filled outside the
// image. Needs W % 8 == 0 and a 16-byte aligned x.
__device__ __forceinline__ void stage_patch_async(uint32_t* patch, const unsigned short* x,
                                                  const Tile& t, int H, int W) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(patch);
  const long long e_first = 3LL * (4 * t.q0 - 8);  // element of the patch's pixel 0 in a row
  for (int i = threadIdx.x; i < IR * ROW_CHUNKS; i += THREADS) {
    const int pr = i / ROW_CHUNKS;
    const int gr = 4 * t.p0 - 5 + pr;
    const long long e0 = e_first + 8 * (i - pr * ROW_CHUNKS);
    const bool in = gr >= 0 && gr < H && e0 >= 0 && e0 + 8 <= 3LL * W;
    cp_async16(dst + 16 * i, in ? x + ((long long)t.b * H + gr) * W * 3 + e0 : x, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_patch() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The same patch for any W, word by word: two bf16, 0 outside the image.
__device__ __forceinline__ void stage_patch_words(uint32_t* patch, const unsigned short* x,
                                                  const Tile& t, int H, int W) {
  const int px0 = 4 * t.q0 - 8;
  for (int i = threadIdx.x; i < PATCH_W; i += THREADS) {
    const int pr = i / ROW_W;
    const int e = 2 * (i - pr * ROW_W);
    const int gr = 4 * t.p0 - 5 + pr;
    uint32_t v = 0u;
    if (gr >= 0 && gr < H) {
      const long long row = (((long long)t.b * H + gr) * W + px0) * 3;
      const uint32_t lo = (unsigned)(px0 + e / 3) < (unsigned)W ? __ldg(x + row + e) : 0u;
      const uint32_t hi =
          (unsigned)(px0 + (e + 1) / 3) < (unsigned)W ? __ldg(x + row + e + 1) : 0u;
      v = lo | (hi << 16);
    }
    patch[i] = v;
  }
}

// Patch word of tap pair (k, k + 1), relative to the position's word.
// Padding taps (zero weights) read the position's own word.
__device__ __forceinline__ int tap_word(int k) {
  if (k >= KTAPS) return 0;
  const int ky = k / KROW;
  return ky * ROW_W + (k - ky * KROW) / 2;
}

// Word of conv position m's dummy tap: patch row 2 r, element 8 + 6 c (the
// position's first pixel, 2 c + 3, starts at element 9)
__device__ __forceinline__ int pos_word(int m) {
  m = min(m, NPOS - 1);  // the last M tile's padding rows: computed, never stored
  const int r = m / CCOL;
  return r * 2 * ROW_W + 4 + 3 * (m - r * CCOL);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t hmax2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 16-byte chunk v (channels 8v..8v+7) of conv position m
__device__ __forceinline__ unsigned char* conv_chunk(unsigned char* conv_s, int m, int v) {
  return conv_s + m * (COUT * 2) + ((v ^ (m & 7)) << 4);
}

// x: (B, H, W, 3) bf16; w: the (160, 64) bf16 B operand in fragment order,
// uint4 (s * NT/2 + np) * 32 + lane holding the B fragments of n tiles 2 np
// and 2 np + 1 at k-step s; scale, shift: (64,) f32; out: (B, Hp, Wp, 64) bf16.
__global__ void __launch_bounds__(THREADS, 2)
stem_pool_tc_kernel(const unsigned short* __restrict__ x, const uint16_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    __nv_bfloat16* __restrict__ out, int B, int H, int W, int Hc, int Wc,
                    int Hp, int Wp) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* wf = reinterpret_cast<uint4*>(smem);                // [KSTEPS][NT/2][32 lanes]
  unsigned char* conv_s = smem + WF_BYTES;                   // [NPOS][64] bf16, swizzled
  uint32_t* patch = reinterpret_cast<uint32_t*>(conv_s + CONV_BYTES);  // [IR][ROW_W]
  float* aff = reinterpret_cast<float*>(smem + WF_BYTES + CONV_BYTES + PATCH_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragments' row group
  const int t4 = lane & 3;   // the thread in the group
  const int ntx = (Wp + TQ - 1) / TQ;
  const int per_img = ntx * ((Hp + TP - 1) / TP);
  const int ntiles = B * per_img;

  // the B fragments, in the order the wrapper packed them
  const uint4* wsrc = reinterpret_cast<const uint4*>(w);
  for (int i = tid; i < (int)(WF_BYTES / 16); i += THREADS) wf[i] = __ldg(wsrc + i);
  for (int i = tid; i < COUT; i += THREADS) {
    aff[i] = scale[i];
    aff[COUT + i] = shift[i];
  }
  // 16-byte copies where every chunk is whole, word by word otherwise
  const bool chunked = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (blockIdx.x < ntiles) {
    const Tile t = tile_at(blockIdx.x, ntx, per_img);
    if (chunked) {
      stage_patch_async(patch, x, t, H, W);
      wait_patch();
    } else {
      stage_patch_words(patch, x, t, H, W);
    }
  }

  int koff[2 * KSTEPS];  // this thread's tap pairs, k-step s: lo 2s, hi 2s + 1
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    koff[2 * s] = tap_word(16 * s + 2 * t4);
    koff[2 * s + 1] = tap_word(16 * s + 2 * t4 + 8);
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, ntx, per_img);
    const int r0 = 2 * t.p0 - 1;  // conv row of tile row 0
    const int c0 = 2 * t.q0 - 1;
    __syncthreads();  // the patch is staged; the previous pool is done with the conv tile

    for (int pair = warp; pair < PAIRS; pair += WARPS) {
      // rows g, g+8 of M tiles 2 pair and 2 pair + 1: position 32 pair + g + 8 i
      int wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wb[i] = pos_word(32 * pair + g + 8 * i);
      float acc[2][NT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][n][e] = 0.f;

#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int lo = koff[2 * s];
        const int hi = koff[2 * s + 1];
        const uint32_t a0[4] = {patch[wb[0] + lo], patch[wb[1] + lo], patch[wb[0] + hi],
                                patch[wb[1] + hi]};
        const uint32_t a1[4] = {patch[wb[2] + lo], patch[wb[3] + lo], patch[wb[2] + hi],
                                patch[wb[3] + hi]};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const uint4 bq = wf[(s * (NT / 2) + np) * 32 + lane];
          mma_bf16(acc[0][2 * np], a0, bq.x, bq.y);
          mma_bf16(acc[1][2 * np], a1, bq.x, bq.y);
          mma_bf16(acc[0][2 * np + 1], a0, bq.z, bq.w);
          mma_bf16(acc[1][2 * np + 1], a1, bq.z, bq.w);
        }
      }

      int pos[4];
      bool inside[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 32 * pair + g + 8 * i;
        const int r = m / CCOL;
        const int c = m - r * CCOL;
        pos[i] = m;
        inside[i] = (unsigned)(r0 + r) < (unsigned)Hc && (unsigned)(c0 + c) < (unsigned)Wc;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 sc = *reinterpret_cast<const float2*>(aff + 8 * n + 2 * t4);
        const float2 sh = *reinterpret_cast<const float2*>(aff + COUT + 8 * n + 2 * t4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (pos[i] >= NPOS) continue;
          // accumulator rows: c0, c1 for row g, c2, c3 for row g + 8
          const float y0 = acc[i >> 1][n][2 * (i & 1)];
          const float y1 = acc[i >> 1][n][2 * (i & 1) + 1];
          const float v0 = inside[i] ? fmaxf(fmaf(y0, sc.x, sh.x), 0.f) : 0.f;
          const float v1 = inside[i] ? fmaxf(fmaf(y1, sc.y, sh.y), 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(conv_chunk(conv_s, pos[i], n) + 4 * t4) =
              bf16x2_bits(v0, v1);
        }
      }
    }
    __syncthreads();  // the conv tile is whole; every product has read the patch

    // the next tile's copies fly while the pool runs
    const int next = tile + gridDim.x;
    if (next < ntiles && chunked) stage_patch_async(patch, x, tile_at(next, ntx, per_img), H, W);
    for (int item = tid; item < POOL_ITEMS; item += THREADS) {
      const int v = item & 7;
      const int pp = item >> 3;
      const int pr = pp / TQ;
      const int pc = pp - pr * TQ;
      const int gp = t.p0 + pr;
      const int gq = t.q0 + pc;
      if (gp >= Hp || gq >= Wp) continue;
      const int m0 = 2 * pr * CCOL + 2 * pc;
      uint4 best = *reinterpret_cast<const uint4*>(conv_chunk(conv_s, m0, v));
#pragma unroll
      for (int d = 1; d < 9; ++d) {
        const int m = m0 + (d / 3) * CCOL + d % 3;
        const uint4 c = *reinterpret_cast<const uint4*>(conv_chunk(conv_s, m, v));
        best = make_uint4(hmax2(best.x, c.x), hmax2(best.y, c.y), hmax2(best.z, c.z),
                          hmax2(best.w, c.w));
      }
      *reinterpret_cast<uint4*>(out + (((size_t)t.b * Hp + gp) * Wp + gq) * COUT + v * 8) = best;
    }
    if (next < ntiles) {
      if (chunked)
        wait_patch();
      else
        stage_patch_words(patch, x, tile_at(next, ntx, per_img), H, W);
    }
  }
}

// Blocks that fit on the current device at once (two an SM), found once per
// device: the kernel's grid.
cudaError_t resident_blocks(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(stem_pool_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_pool_tc_kernel, THREADS,
                                                           SMEM_BYTES)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (dev < 64) cached[dev] = *out;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted (or there was
// nothing to do). x: (B, H, W, 3) bf16 NHWC; w: the packed weights in
// fragment order (ops/stem.py: stem_weight_fragments); scale, shift: (64,)
// f32; out: (B, Hp, Wp, 64) bf16.
int dcss_stem_pool_tc(const void* x, const void* w, const void* scale, const void* shift,
                      void* out, int B, int H, int W, void* stream) {
  const int Hc = (H - 1) / 2 + 1;
  const int Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1;
  const int Wp = (Wc - 1) / 2 + 1;
  const long long ntiles = (long long)B * ((Hp + TP - 1) / TP) * ((Wp + TQ - 1) / TQ);
  if (ntiles == 0) return 0;
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(ntiles < resident ? ntiles : (long long)resident);
  stem_pool_tc_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(out), B, H, W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
