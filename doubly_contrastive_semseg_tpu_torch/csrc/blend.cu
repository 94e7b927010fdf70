// Fused SwiftNet decoder step for Hopper (sm_90a):
//   out = conv3x3( relu( BN_eval( up2_bilinear(x) + skip ) ) )
// in one pass: neither the upsampled tensor nor the pre-conv activation is
// written to device memory.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/blend_pallas.py:
// fused_upsample_blend (_kernel).
//
// Bound: operations. At a batch of 8, the three decoder steps of a
// 2048x1024 forward that take this kernel (outputs 64x128, 128x256,
// 256x512, 128 channels) do 2*B*H*W*9*128*128 = 4.1e11 flops against
// 0.79 GB of bf16 inputs and outputs: 0.41 ms on bf16 tensor cores, 0.24 ms
// of memory traffic.
//
// Design (a first, simple kernel; no TMA, no wgmma, no overlapped staging):
// one block of 8 warps owns an output tile of 8 rows x 16 columns of one
// image and one 128-wide chunk of output channels. For each 128-wide chunk
// of input channels it forms the halo'd activation tile (10 x 18 pixels) in
// shared memory: the x2 bilinear (half-pixel centres, edge clamp) of the
// bf16 x, over rows then columns with each product and sum rounded to bf16
// as the Pallas body does, plus the bf16 skip, rounded to bf16, then the
// folded BN as an f32 multiply and add, ReLU, rounded to bf16; pixels
// outside the image are zero (the conv's zero padding). The 3x3 conv is
// then 9 accumulated (128 pixels x 128) . (128 x 128) products over shifted
// views of that tile, one tap's weights staged in shared memory at a time,
// on bf16 tensor cores through nvcuda::wmma 16x16x16 fragments with f32
// accumulators. Warp w owns output rows 2*(w/2) and 2*(w/2)+1 and output
// channels 64*(w%2) .. +63: each fragment of A is used 4 times and each of
// B twice. Staged rows are padded to 144 bf16 (288 bytes), which keeps
// every fragment pointer 32-byte aligned as wmma needs. The f32 tile goes
// through shared memory to 16-byte stores; columns past the image's right
// edge are masked (H is a multiple of 8, W of 8, C of 128: the TPU kernel's
// shapes). 88.7 KB of shared memory a block, two blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int CK = 128;             // channels a chunk, input and output
constexpr int TH = 8;               // output rows a block
constexpr int TW = 16;              // output cols a block: one wmma M tile
constexpr int HR = TH + 2;          // halo rows
constexpr int HC = TW + 2;          // halo cols
constexpr int LDA = CK + 16;        // bf16 a staged pixel
constexpr int LDB = CK + 16;        // bf16 a staged weight row
constexpr int LDO = CK + 4;         // f32 an output pixel in the epilogue
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NFRAG = CK / 2 / 16;  // 16-wide output-channel fragments a warp
constexpr int VEC = 8;              // bf16 a 16-byte access
constexpr size_t ACT_BYTES = sizeof(__nv_bfloat16) * HR * HC * LDA;
constexpr size_t W_BYTES = sizeof(__nv_bfloat16) * CK * LDB;
constexpr size_t OUT_BYTES = sizeof(float) * TH * TW * LDO;
constexpr size_t SMEM_BYTES = ACT_BYTES + W_BYTES > OUT_BYTES ? ACT_BYTES + W_BYTES : OUT_BYTES;
static_assert(ACT_BYTES % 128 == 0, "weights start 128-byte aligned");
// wmma wants 32-byte aligned fragment pointers: A starts at any staged
// pixel, the output fragments at multiples of TW pixels
static_assert((LDA * 2) % 32 == 0 && (TW * LDO * 4) % 32 == 0 && LDO % 4 == 0,
              "wmma pointers 32-byte aligned");
static_assert(TH == 2 * (WARPS / 2), "a warp owns two rows and half the channels");

__device__ __forceinline__ void unpack(const uint4& r, float* f) {
  // a bf16 is the high half of the f32 with the same bits
  const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned int bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned int*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16(bf16(wa * a) + bf16((1 - wa) * b)) for bf16-exact a, b and wa in
// {1/4, 3/4}: each f32 product is exact, so this is torch's bf16 arithmetic
__device__ __forceinline__ float blend2(float wa, float a, float b) {
  return round_bf16(round_bf16(wa * a) + round_bf16((1.f - wa) * b));
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

// x: (B, H/2, W/2, C) bf16; skip: (B, H, W, C) bf16; w9: (9, C, C) bf16 as
// [ky*3+kx][cin][cout]; ab: (2, C) f32 folded BN scale/shift; out: (B, H, W, C).
template <typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
blend_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ skip,
             const __nv_bfloat16* __restrict__ w9, const float* __restrict__ ab,
             OutT* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* act_s = reinterpret_cast<__nv_bfloat16*>(smem);            // [HR*HC][LDA]
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + ACT_BYTES);  // [CK][LDB]
  float* out_s = reinterpret_cast<float*>(smem);  // [TH*TW][LDO], after the products

  const int nco = C / CK;
  const int b = blockIdx.z / nco;
  const int co0 = (blockIdx.z - b * nco) * CK;
  const int i0 = blockIdx.y * TH;
  const int j0 = blockIdx.x * TW;
  const int h = H / 2, w = W / 2;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r0 = 2 * (warp / 2);          // first of the warp's two output rows
  const int n0 = (warp % 2) * (CK / 2);   // first of its 64 output channels
  const __nv_bfloat16* xb = x + (size_t)b * h * w * C;
  const __nv_bfloat16* sb = skip + (size_t)b * H * W * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NFRAG];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NFRAG; ++n) wmma::fill_fragment(acc[i][n], 0.f);

  constexpr int NV = CK / VEC;
  for (int ci0 = 0; ci0 < C; ci0 += CK) {
    __syncthreads();  // the previous chunk's fragments are all loaded
    for (int item = tid; item < HR * HC * NV; item += THREADS) {
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
        const float wya = (R & 1) ? 0.75f : 0.25f;
        const float wxa = (Q & 1) ? 0.75f : 0.25f;
        const int c = ci0 + v * VEC;
        float f00[VEC], f01[VEC], f10[VEC], f11[VEC], fs[VEC];
        unpack(__ldg(reinterpret_cast<const uint4*>(xb + ((size_t)ya * w + xa) * C + c)), f00);
        unpack(__ldg(reinterpret_cast<const uint4*>(xb + ((size_t)ya * w + xc) * C + c)), f01);
        unpack(__ldg(reinterpret_cast<const uint4*>(xb + ((size_t)yb * w + xa) * C + c)), f10);
        unpack(__ldg(reinterpret_cast<const uint4*>(xb + ((size_t)yb * w + xc) * C + c)), f11);
        unpack(__ldg(reinterpret_cast<const uint4*>(sb + ((size_t)R * W + Q) * C + c)), fs);
        unsigned int res[VEC / 2];
#pragma unroll
        for (int k = 0; k < VEC; k += 2) {
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // rows, then columns, each product and sum rounded to bf16, as
            // the Pallas body computes in bf16
            const float ra = blend2(wya, f00[k + e], f10[k + e]);
            const float rc = blend2(wya, f01[k + e], f11[k + e]);
            const float pre = round_bf16(blend2(wxa, ra, rc) + fs[k + e]);
            // multiply then add, each rounded, as the plain version's two ops
            y[e] = fmaxf(__fadd_rn(__fmul_rn(pre, __ldg(ab + c + k + e)),
                                   __ldg(ab + C + c + k + e)), 0.f);
          }
          res[k / 2] = bits(__floats2bfloat162_rn(y[0], y[1]));
        }
        packed = make_uint4(res[0], res[1], res[2], res[3]);
      }
      *reinterpret_cast<uint4*>(act_s + px * LDA + v * VEC) = packed;
    }

    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // the tile is staged; the previous tap's weights are consumed
      const __nv_bfloat16* wt = w9 + ((size_t)tap * C + ci0) * C + co0;
      for (int item = tid; item < CK * NV; item += THREADS) {
        const int k = item / NV;
        const int v = item - k * NV;
        *reinterpret_cast<uint4*>(w_s + k * LDB + v * VEC) =
            __ldg(reinterpret_cast<const uint4*>(wt + (size_t)k * C + v * VEC));
      }
      __syncthreads();
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
      // row m of A is output pixel (r, j0 + m): halo pixel (r + ky, m + kx)
      const __nv_bfloat16* a0 = act_s + ((r0 + ky) * HC + kx) * LDA;
      const __nv_bfloat16* a1 = a0 + HC * LDA;
#pragma unroll 2
      for (int k0 = 0; k0 < CK; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa0, fa1;
        wmma::load_matrix_sync(fa0, a0 + k0, LDA);
        wmma::load_matrix_sync(fa1, a1 + k0, LDA);
#pragma unroll
        for (int n = 0; n < NFRAG; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, w_s + k0 * LDB + n0 + n * 16, LDB);
          wmma::mma_sync(acc[0][n], fa0, fb, acc[0][n]);
          wmma::mma_sync(acc[1][n], fa1, fb, acc[1][n]);
        }
      }
    }
  }

  __syncthreads();  // every fragment is loaded before the output overwrites the tiles
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NFRAG; ++n)
      wmma::store_matrix_sync(out_s + (r0 + i) * TW * LDO + n0 + n * 16, acc[i][n], LDO,
                              wmma::mem_row_major);
  __syncthreads();

  constexpr int SN = Store<OutT>::N;
  constexpr int NS = CK / SN;
  for (int item = tid; item < TH * TW * NS; item += THREADS) {
    const int px = item / NS;
    const int v = item - px * NS;
    const int r = px / TW;
    const int q = px - r * TW;
    if (j0 + q >= W) continue;  // the ragged right edge
    Store<OutT>::put(out + (((size_t)b * H + i0 + r) * W + j0 + q) * C + co0 + v * SN,
                     out_s + px * LDO + v * SN);
  }
}

template <typename OutT>
int launch(const void* x, const void* skip, const void* w9, const void* ab, void* out,
           int B, int H, int W, int C, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blend_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, H / TH, B * (C / CK));
  blend_kernel<OutT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(w9), static_cast<const float*>(ab),
      static_cast<OutT*>(out), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted. H and W are the
// output's (the skip's) size; H % 8 == 0, W % 8 == 0, C % 128 == 0.
int dcss_upsample_blend(const void* x, const void* skip, const void* w9, const void* ab,
                        void* out, int B, int H, int W, int C, int out_is_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16 ? launch<__nv_bfloat16>(x, skip, w9, ab, out, B, H, W, C, s)
                     : launch<float>(x, skip, w9, ab, out, B, H, W, C, s);
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
