// Fused SwiftNet decoder step for Hopper (sm_90a), on mma.sync tensor cores:
//   out = conv3x3( relu( BN_eval( up2_bilinear(x) + skip ) ) )
// in one pass: neither the upsampled tensor nor the pre-conv activation is
// written to device memory.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/blend_pallas.py:96
// fused_upsample_blend (_kernel :32), with the numerics of csrc/blend.cu
// (the first design, kept as the yardstick of tools/profile_blend.py).
//
// Bound: operations. At a batch of 8, the three decoder steps of a
// 2048x1024 forward that take this kernel (outputs 64x128, 128x256,
// 256x512, 128 channels) do 2*B*H*W*9*128*128 = 4.1e11 flops against
// 0.79 GB of bf16 inputs and outputs: 0.41 ms on bf16 tensor cores, 0.24 ms
// of memory traffic.
//
// Design: one block of 8 warps owns an output tile of 8 rows x 16 columns
// of one image and one 128-wide chunk of output channels; two blocks an SM,
// so one block's activation staging overlaps the other's products.
//  - Activation halo: for each 128-wide chunk of input channels the block
//    forms the 10 x 18 halo'd activation tile in shared memory on CUDA
//    cores: the x2 bilinear (half-pixel centres, edge clamp) of the bf16 x,
//    over rows then columns with each product and sum rounded to bf16 as the
//    Pallas body does, plus the bf16 skip, rounded to bf16, then the folded
//    BN as an f32 multiply and add, ReLU, rounded to bf16; pixels outside
//    the image are zero (the conv's zero padding). The bilinear and the
//    skip add run on channel pairs as fma.rn.bf16x2, which rounds each
//    product and sum once, as torch's bf16 ops do: 10 instructions a pair,
//    where f32 arithmetic needs a round trip through bf16 after each.
//  - Weights: packed once by the wrapper (ops/blend.py: pack_blend) as
//    [output chunk][input chunk][tap][half][64 input ch][128 output ch]
//    bf16, so each half-tap is one contiguous 16 KB block. They stream
//    through a ring of 3 half-tap slots filled by 16-byte cp.async copies:
//    half-tap s + 2 is in flight while s is multiplied, one __syncthreads a
//    half-tap, no register round trip. The first two are in flight while
//    the halo is formed.
//  - Products: the 3x3 conv is 9 taps x 2 halves of (128 pixels x 64) .
//    (64 x 128) products over shifted views of the halo tile, on
//    mma.sync.m16n8k16 (bf16 in, f32 accumulators). Warp w owns output rows
//    2*(w/2), 2*(w/2)+1 (two m16 tiles of 16 columns) and output channels
//    64*(w%2) .. +63 (eight n8 tiles): 64 f32 accumulators a thread. A
//    fragments come from ldmatrix.x4 on the halo's rows (pixel-major), B
//    fragments from ldmatrix.x4.trans on the staged weight rows
//    (input-channel-major). Staged rows are 136 bf16 (272 bytes, 16 mod
//    128), so the 8 rows of every ldmatrix phase fall on distinct banks.
//  - Epilogue: the f32 tile goes through shared memory (rows of 136 f32:
//    the accumulators' 8-byte stores are conflict-free per half-warp) to
//    16-byte global stores; columns past the image's right edge are masked
//    (H is a multiple of 8, W of 8, C of 128: the TPU kernel's shapes).
// Budget: shared memory 48,960 (halo) + 3 x 17,408 (ring) = 101,184 bytes
// a block (the epilogue's 69,632 reuse it), two blocks an SM; at most 128
// registers a thread (chip_smoke.py and tools/profile_blend.py print
// ptxas's report).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 128;             // channels a chunk, input and output
constexpr int KH = CK / 2;          // input channels a half-tap
constexpr int TH = 8;               // output rows a block
constexpr int TW = 16;              // output cols a block: one m16 tile
constexpr int HR = TH + 2;          // halo rows
constexpr int HC = TW + 2;          // halo cols
constexpr int LDA = CK + 8;         // bf16 a staged pixel
constexpr int LDB = CK + 8;         // bf16 a staged weight row
constexpr int LDO = CK + 8;         // f32 an output pixel in the epilogue
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS_PER_SM = 2;
constexpr int STAGES = 3;           // half-tap slots in the weight ring
constexpr int HALF_TAPS = 18;       // half-taps a chunk of input channels
constexpr int VEC = 8;              // bf16 a 16-byte access
constexpr int NV = CK / VEC;        // 16-byte vectors a 128-wide row
constexpr size_t ACT_BYTES = sizeof(__nv_bfloat16) * HR * HC * LDA;
constexpr size_t SLOT_BYTES = sizeof(__nv_bfloat16) * KH * LDB;
constexpr size_t OUT_BYTES = sizeof(float) * TH * TW * LDO;
constexpr size_t SMEM_BYTES = ACT_BYTES + STAGES * SLOT_BYTES > OUT_BYTES
                                  ? ACT_BYTES + STAGES * SLOT_BYTES
                                  : OUT_BYTES;
static_assert(ACT_BYTES % 16 == 0 && SLOT_BYTES % 16 == 0, "16-byte aligned rows and slots");
static_assert((LDA * 2) % 128 == 16 && (LDB * 2) % 128 == 16, "ldmatrix rows on distinct banks");
static_assert(TH == 2 * (WARPS / 2), "a warp owns two rows and half the channels");
static_assert((KH * NV) % THREADS == 0, "every thread makes the same copies");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned int bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned int*>(&v);
}

// a * b + c on bf16 pairs, rounded once to bf16 (nearest even)
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
constexpr uint32_t BF2_NEG_ZERO = 0x80008000u;  // a * b + (-0) is a * b, zeros' signs kept
constexpr uint32_t BF2_ONE = 0x3f803f80u;
constexpr uint32_t BF2_QUARTER = 0x3e803e80u;
constexpr uint32_t BF2_THREE_QUARTERS = 0x3f403f40u;

// bf16(bf16(wa * a) + bf16(wb * b)) on bf16 pairs: torch's bf16 arithmetic
// (each product and sum rounded once; wa, wb in {1/4, 3/4})
__device__ __forceinline__ uint32_t blend2(uint32_t wa, uint32_t wb, uint32_t a, uint32_t b) {
  return bf2_fma(bf2_fma(wa, a, BF2_NEG_ZERO), BF2_ONE, bf2_fma(wb, b, BF2_NEG_ZERO));
}

template <typename OutT> struct Store;
template <> struct Store<float> {
  static constexpr int N = 4;  // elements a 16-byte store
  static __device__ __forceinline__ void put(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
};
template <> struct Store<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void put(__nv_bfloat16* dst, const float* src) {
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        bits(__floats2bfloat162_rn(lo.x, lo.y)), bits(__floats2bfloat162_rn(lo.z, lo.w)),
        bits(__floats2bfloat162_rn(hi.x, hi.y)), bits(__floats2bfloat162_rn(hi.z, hi.w)));
  }
};

// Forms the halo'd activation tile of input channels ci0 .. ci0 + 127 (see
// the note above) in act_s, [HR * HC pixels][LDA].
__device__ __forceinline__ void form_halo(__nv_bfloat16* act_s, const __nv_bfloat16* xb,
                                          const __nv_bfloat16* sb, const float* ab, int ci0,
                                          int i0, int j0, int H, int W, int C) {
  const int h = H / 2, w = W / 2;
  for (int item = threadIdx.x; item < HR * HC * NV; item += THREADS) {
    const int px = item / NV;
    const int v = item - px * NV;
    const int hr = px / HC;
    const int hc = px - hr * HC;
    const int R = i0 - 1 + hr;
    const int Q = j0 - 1 + hc;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (R >= 0 && R < H && Q >= 0 && Q < W) {
      // x2 bilinear phases (half-pixel centres): output 2k blends x[k-1]
      // and x[k] as 1/4, 3/4; output 2k+1 blends x[k] and x[k+1] as
      // 3/4, 1/4; x repeats its edge rows and columns
      const int ky = R >> 1;
      const int kx = Q >> 1;
      const int ya = (R & 1) ? ky : max(ky - 1, 0);
      const int yb = (R & 1) ? min(ky + 1, h - 1) : ky;
      const int xa = (Q & 1) ? kx : max(kx - 1, 0);
      const int xc = (Q & 1) ? min(kx + 1, w - 1) : kx;
      const uint32_t wya = (R & 1) ? BF2_THREE_QUARTERS : BF2_QUARTER;
      const uint32_t wyb = (R & 1) ? BF2_QUARTER : BF2_THREE_QUARTERS;
      const uint32_t wxa = (Q & 1) ? BF2_THREE_QUARTERS : BF2_QUARTER;
      const uint32_t wxb = (Q & 1) ? BF2_QUARTER : BF2_THREE_QUARTERS;
      const int c = ci0 + v * VEC;
      const uint4 r00 = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)ya * w + xa) * C + c));
      const uint4 r01 = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)ya * w + xc) * C + c));
      const uint4 r10 = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)yb * w + xa) * C + c));
      const uint4 r11 = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)yb * w + xc) * C + c));
      const uint4 rs = __ldg(reinterpret_cast<const uint4*>(sb + ((size_t)R * W + Q) * C + c));
      const float4 a_lo = __ldg(reinterpret_cast<const float4*>(ab + c));
      const float4 a_hi = __ldg(reinterpret_cast<const float4*>(ab + c + 4));
      const float4 s_lo = __ldg(reinterpret_cast<const float4*>(ab + C + c));
      const float4 s_hi = __ldg(reinterpret_cast<const float4*>(ab + C + c + 4));
      const uint32_t w00[4] = {r00.x, r00.y, r00.z, r00.w};
      const uint32_t w01[4] = {r01.x, r01.y, r01.z, r01.w};
      const uint32_t w10[4] = {r10.x, r10.y, r10.z, r10.w};
      const uint32_t w11[4] = {r11.x, r11.y, r11.z, r11.w};
      const uint32_t ws[4] = {rs.x, rs.y, rs.z, rs.w};
      const float sc[VEC] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float sh[VEC] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
      unsigned int res[VEC / 2];
#pragma unroll
      for (int k = 0; k < VEC / 2; ++k) {
        // rows, then columns, each product and sum rounded to bf16, as the
        // Pallas body computes in bf16; then the skip, rounded
        const uint32_t ra = blend2(wya, wyb, w00[k], w10[k]);
        const uint32_t rc = blend2(wya, wyb, w01[k], w11[k]);
        const uint32_t pre = bf2_fma(blend2(wxa, wxb, ra, rc), BF2_ONE, ws[k]);
        // multiply then add in f32, each rounded, as the plain version's two
        // ops (a bf16 is the high half of the f32 with the same bits)
        const float y0 = __fadd_rn(__fmul_rn(__uint_as_float(pre << 16), sc[2 * k]), sh[2 * k]);
        const float y1 = __fadd_rn(__fmul_rn(__uint_as_float(pre & 0xffff0000u), sc[2 * k + 1]),
                                   sh[2 * k + 1]);
        res[k] = bits(__floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f)));
      }
      packed = make_uint4(res[0], res[1], res[2], res[3]);
    }
    *reinterpret_cast<uint4*>(act_s + px * LDA + v * VEC) = packed;
  }
}

// The warp's share of one half-tap: (2 x 16 pixels) x 64 input channels
// against 64 x 64 output channels. a0, a1: this lane's ldmatrix row address
// of its two m16 tiles at the half-tap's first input channel; b: its
// address in the staged slot at the warp's first output channel.
__device__ __forceinline__ void products(float (&acc)[2][8][4], uint32_t a0, uint32_t a1,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KH / 16; ++kk) {
    uint32_t fa0[4], fa1[4];
    ldmatrix_x4(fa0, a0 + kk * 32);
    ldmatrix_x4(fa1, a1 + kk * 32);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, b + kk * 16 * LDB * 2 + np * 32);
      mma_bf16(acc[0][2 * np], fa0, fb[0], fb[1]);
      mma_bf16(acc[0][2 * np + 1], fa0, fb[2], fb[3]);
      mma_bf16(acc[1][2 * np], fa1, fb[0], fb[1]);
      mma_bf16(acc[1][2 * np + 1], fa1, fb[2], fb[3]);
    }
  }
}

// x: (B, H/2, W/2, C) bf16; skip: (B, H, W, C) bf16; wp: the packed weights
// (C/128, C/128, 9, 2, 64, 128) bf16 (see the note); ab: (2, C) f32 folded
// BN scale/shift; out: (B, H, W, C).
template <typename OutT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
blend_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ skip,
                 const __nv_bfloat16* __restrict__ wp, const float* __restrict__ ab,
                 OutT* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* act_s = reinterpret_cast<__nv_bfloat16*>(smem);            // [HR*HC][LDA]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + ACT_BYTES);  // [3][KH][LDB]
  float* out_s = reinterpret_cast<float*>(smem);  // [TH*TW][LDO], after the products

  const int nch = C / CK;
  const int b = blockIdx.z / nch;
  const int co = blockIdx.z - b * nch;
  const int i0 = blockIdx.y * TH;
  const int j0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = 2 * (warp / 2);          // first of the warp's two output rows
  const int n0 = (warp % 2) * (CK / 2);   // first of its 64 output channels
  const __nv_bfloat16* xb = x + (size_t)b * (H / 2) * (W / 2) * C;
  const __nv_bfloat16* sb = skip + (size_t)b * H * W * C;
  const __nv_bfloat16* wb = wp + (size_t)co * nch * HALF_TAPS * KH * CK;
  const int nsteps = nch * HALF_TAPS;

  // Half-tap s into slot s % STAGES; every thread commits one group a call,
  // empty past the last half-tap, so "all but the newest group" is s.
  const uint32_t ring_u32 = smem_u32(ring);
  auto stage = [&](int s) {
    if (s < nsteps) {
      const __nv_bfloat16* src = wb + (size_t)s * KH * CK;
      const uint32_t dst = ring_u32 + (s % STAGES) * (uint32_t)SLOT_BYTES;
#pragma unroll
      for (int j = 0; j < KH * NV / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int k = i / NV;
        const int v = i - k * NV;
        cp_async16(dst + (k * LDB + v * VEC) * 2, src + k * CK + v * VEC);
      }
    }
    cp_async_commit();
  };

  // ldmatrix row addresses. A (row-major 16 x 16): lanes 0-15 give pixels
  // 0-15 at channels +0, lanes 16-31 the same pixels at +8. B (16 x 16 of
  // [k][n], transposed on load): lane l gives row k = l % 8 + 8 ((l / 8) % 2)
  // at columns + 8 (l / 16).
  const uint32_t act_u32 = smem_u32(act_s);
  const uint32_t a_lane = act_u32 + ((lane & 15) * LDA + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = ((((lane & 7) + ((lane >> 3) & 1) * 8) * LDB) + n0 + (lane >> 4) * 8) * 2;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  stage(0);
  stage(1);
  for (int s = 0; s < nsteps; ++s) {
    const int hs = s % HALF_TAPS;
    if (hs == 0) {
      if (s > 0) __syncthreads();  // the previous chunk's fragments are all loaded
      form_halo(act_s, xb, sb, ab, (s / HALF_TAPS) * CK, i0, j0, H, W, C);
    }
    cp_async_wait_prev();  // this thread's copies of half-tap s have landed
    __syncthreads();       // everyone's have, the halo is formed, slot (s - 1) % 3 is free
    stage(s + 2);
    const int tap = hs >> 1;
    const int ky = tap / 3;
    const int kx = tap - 3 * ky;
    // row m of A is output pixel (r, j0 + m): halo pixel (r + ky, m + kx)
    const uint32_t a0 = a_lane + (((r0 + ky) * HC + kx) * LDA + (hs & 1) * KH) * 2;
    products(acc, a0, a0 + HC * LDA * 2, ring_u32 + (s % STAGES) * (uint32_t)SLOT_BYTES + b_lane);
  }

  cp_async_wait_all();
  __syncthreads();  // every fragment is loaded before the output overwrites the tiles
  // accumulator (i, n): rows g and g + 8 of m tile i, columns 2t, 2t + 1 of n tile n
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* o = out_s + ((r0 + i) * TW + g) * LDO + n0 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][n][0], acc[i][n][1]);
      *reinterpret_cast<float2*>(o + 8 * LDO) = make_float2(acc[i][n][2], acc[i][n][3]);
    }
  __syncthreads();

  constexpr int SN = Store<OutT>::N;
  constexpr int NS = CK / SN;
  for (int item = tid; item < TH * TW * NS; item += THREADS) {
    const int px = item / NS;
    const int v = item - px * NS;
    const int r = px / TW;
    const int q = px - r * TW;
    if (j0 + q >= W || i0 + r >= H) continue;  // the ragged right (and bottom) edge
    Store<OutT>::put(out + (((size_t)b * H + i0 + r) * W + j0 + q) * C + co * CK + v * SN,
                     out_s + px * LDO + v * SN);
  }
}

template <typename OutT>
int launch(const void* x, const void* skip, const void* wp, const void* ab, void* out,
           int B, int H, int W, int C, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blend_mma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blend_mma_kernel<OutT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (C / CK));
  blend_mma_kernel<OutT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(ab),
      static_cast<OutT*>(out), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted. H and W are the
// output's (the skip's) size; H % 8 == 0, W % 8 == 0, C % 128 == 0; x, skip,
// wp and out 16-byte aligned.
int dcss_upsample_blend_mma(const void* x, const void* skip, const void* wp, const void* ab,
                            void* out, int B, int H, int W, int C, int out_is_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16 ? launch<__nv_bfloat16>(x, skip, wp, ab, out, B, H, W, C, s)
                     : launch<float>(x, skip, wp, ab, out, B, H, W, C, s);
}

// Dynamic shared memory a block, in bytes.
int dcss_blend_mma_smem_bytes() { return (int)SMEM_BYTES; }

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
