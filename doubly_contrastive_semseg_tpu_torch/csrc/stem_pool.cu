// Fused ResNet stem of the SwiftNet pyramid for Hopper (sm_90a):
//   7x7 / stride 2 / pad 3 conv over RGB -> folded eval BatchNorm -> ReLU
//   -> 3x3 / stride 2 / pad 1 max-pool,
// in one pass; the pre-pool activation never reaches device memory.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/stem_pallas.py:
// fused_stem_pool (_stem_kernel). That kernel re-expresses the conv as a
// space-to-depth 4x4 conv over 12 channels and folds W into lanes to fill a
// 128-wide matrix unit; none of that is needed here, so this kernel reads the
// dense NHWC level directly.
//
// Bound: 147 multiply-adds per conv output and channel (about 79 GFLOP at
// level 0 of a batch of 8 2048x1024 frames, 105 GFLOP over the 3 levels)
// against 0.23 GB of input and output: the work is operations, not bytes.
// Design: one block per tile of 8 x 16 pooled outputs (all 64 channels). It
// stages the 39 x 71 x 3 input patch (halo included) and all 9,408 weights
// in shared memory as float, computes the 17 x 33 x 64 conv tile on CUDA
// cores with f32 accumulation (each thread 9 positions x 8 channels, so
// every weight and input read from shared memory feeds 8 or 9 FMAs), applies
// scale/shift + ReLU into shared memory and max-pools from there. Conv
// positions outside the image are written as 0: post-ReLU values are >= 0,
// so a 0 in the pool window is the same as the pool's -inf padding.
// ops/stem.py launches it for f32 levels; bf16 levels take the tensor-core
// kernel in stem_pool_tc.cu, and this one on bf16 is kept to time against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CIN = 3;
constexpr int COUT = 64;
constexpr int K = 7;
constexpr int TP = 8;                     // pooled rows per block
constexpr int TQ = 16;                    // pooled cols per block
constexpr int CR = 2 * TP + 1;            // conv rows of the tile
constexpr int CCOL = 2 * TQ + 1;          // conv cols of the tile
constexpr int NPOS = CR * CCOL;
constexpr int IR = 2 * (CR - 1) + K;      // input patch rows
constexpr int IC = 2 * (CCOL - 1) + K;    // input patch cols
constexpr int THREADS = 512;
constexpr int CPT = 8;                    // channels per thread
constexpr int NCG = COUT / CPT;           // channel groups
constexpr int NPG = THREADS / NCG;        // position groups
constexpr int P = (NPOS + NPG - 1) / NPG; // positions per thread
constexpr int NTAP = K * K * CIN;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (size_t)(NTAP * COUT + NPOS * COUT + IR * IC * CIN);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x: (B, H, W, 3); w: (7, 7, 3, 64); scale, shift: (64,) f32;
// out: (B, Hp, Wp, 64). Thread (cg, pg) owns channels cg*4..cg*4+3 and
// 32+cg*4..32+cg*4+3, so each float4 weight read of a warp covers 128
// contiguous bytes.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 T* __restrict__ out, int H, int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [NTAP][COUT]
  float* conv_s = w_s + NTAP * COUT;             // [NPOS][COUT]
  float* in_s = conv_s + NPOS * COUT;            // [IR][IC][CIN]

  const int b = blockIdx.z;
  const int p0 = blockIdx.y * TP;
  const int q0 = blockIdx.x * TQ;
  const int r0 = 2 * p0 - 1;  // conv row of tile row 0
  const int c0 = 2 * q0 - 1;
  const int ir0 = 2 * r0 - 3;  // input row of patch row 0
  const int ic0 = 2 * c0 - 3;
  const int tid = threadIdx.x;

  for (int i = tid; i < NTAP * COUT; i += THREADS) w_s[i] = to_f(w[i]);
  const T* xb = x + (size_t)b * H * W * CIN;
  for (int i = tid; i < IR * IC * CIN; i += THREADS) {
    const int pr = i / (IC * CIN);
    const int rem = i - pr * (IC * CIN);
    const int pc = rem / CIN;
    const int ch = rem - pc * CIN;
    const int gr = ir0 + pr;
    const int gc = ic0 + pc;
    float v = 0.f;  // the conv's zero padding
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = to_f(xb[((size_t)gr * W + gc) * CIN + ch]);
    in_s[i] = v;
  }
  __syncthreads();

  const int cg = tid % NCG;
  const int pg = tid / NCG;
  int base[P];
  float acc[P][CPT];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    int pos = pg + j * NPG;
    if (pos >= NPOS) pos = 0;  // computed, never stored
    const int r = pos / CCOL;
    const int c = pos - r * CCOL;
    base[j] = (2 * r * IC + 2 * c) * CIN;
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[j][k] = 0.f;
  }

  for (int ky = 0; ky < K; ++ky) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
#pragma unroll
      for (int ch = 0; ch < CIN; ++ch) {
        const int tap = (ky * K + kx) * CIN + ch;
        const float4 wa = smem4[(tap * COUT + cg * 4) / 4];
        const float4 wb = smem4[(tap * COUT + 32 + cg * 4) / 4];
        const int off = (ky * IC + kx) * CIN + ch;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float v = in_s[base[j] + off];
          acc[j][0] = fmaf(v, wa.x, acc[j][0]);
          acc[j][1] = fmaf(v, wa.y, acc[j][1]);
          acc[j][2] = fmaf(v, wa.z, acc[j][2]);
          acc[j][3] = fmaf(v, wa.w, acc[j][3]);
          acc[j][4] = fmaf(v, wb.x, acc[j][4]);
          acc[j][5] = fmaf(v, wb.y, acc[j][5]);
          acc[j][6] = fmaf(v, wb.z, acc[j][6]);
          acc[j][7] = fmaf(v, wb.w, acc[j][7]);
        }
      }
    }
  }

  float sc[CPT], sh[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int ch = (k < 4) ? cg * 4 + k : 32 + cg * 4 + (k - 4);
    sc[k] = scale[ch];
    sh[k] = shift[ch];
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int pos = pg + j * NPG;
    if (pos < NPOS) {
      const int r = pos / CCOL;
      const int c = pos - r * CCOL;
      const bool inside = (r0 + r >= 0) && (r0 + r < Hc) && (c0 + c >= 0) && (c0 + c < Wc);
      float y[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        y[k] = inside ? fmaxf(fmaf(acc[j][k], sc[k], sh[k]), 0.f) : 0.f;
      float4* dst = reinterpret_cast<float4*>(conv_s + pos * COUT);
      dst[cg] = make_float4(y[0], y[1], y[2], y[3]);
      dst[8 + cg] = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
  __syncthreads();

  for (int i = tid; i < TP * TQ * COUT; i += THREADS) {
    const int ch = i % COUT;
    const int pp = i / COUT;
    const int pr = pp / TQ;
    const int pc = pp - pr * TQ;
    const int gp = p0 + pr;
    const int gq = q0 + pc;
    if (gp < Hp && gq < Wp) {
      float m = 0.f;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
          m = fmaxf(m, conv_s[((2 * pr + dr) * CCOL + 2 * pc + dc) * COUT + ch]);
      out[(((size_t)b * Hp + gp) * Wp + gq) * COUT + ch] = from_f<T>(m);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* shift, void* out,
           int B, int H, int W, cudaStream_t stream) {
  const int Hc = (H - 1) / 2 + 1;
  const int Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1;
  const int Wp = (Wc - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Wp + TQ - 1) / TQ, (Hp + TP - 1) / TP, B);
  stem_pool_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), H, W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted.
int dcss_stem_pool(const void* x, const void* w, const void* scale, const void* shift,
                   void* out, int B, int H, int W, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, scale, shift, out, B, H, W, s)
                 : launch<float>(x, w, scale, shift, out, B, H, W, s);
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
