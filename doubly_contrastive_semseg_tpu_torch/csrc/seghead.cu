// Fused segmentation serving head for Hopper (sm_90a):
//   labels = argmax_c( upsample_x4_bilinear( conv1x1( relu( BN_eval(feat) ) ) + bias ) )
// in one pass over the decoder features; the full-resolution logits are
// never written to device memory.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/seghead_pallas.py:
// fused_seghead_upsample_argmax (_kernel, _phases4).
//
// Bound: bytes. At a batch of 8 2048x1024 frames the kernel must read
// 268 MB of bf16 features and write 16.8 MB of int8 labels; the 128 -> 19
// 1x1 conv is about 5 GFLOP. Design: one block per tile of 8 x 32 feature
// pixels. It stages the tile plus a one-pixel edge-replicated halo
// (10 x 34 pixels x 128 channels) with 16-byte loads into shared memory,
// rows padded by 16 bytes so the per-pixel reads are free of bank conflicts.
// Each thread computes one halo pixel's C logits in f32 (activations
// rounded to the feature dtype, as the TPU kernel rounds them to bf16) and
// keeps them in registers; the logits then overwrite the feature buffer in
// channel-planar order, which leaves room for two blocks per SM. Each
// thread then emits output pixels: torch's align_corners=False bilinear
// weights from the 2 x 2 neighbouring logits, and an argmax that keeps the
// first index on ties (strict '>'), as torch.argmax and jnp.argmax do.
// Any h >= 1 and any w work: halo reads clamp to the image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 128;
constexpr int MAXC = 32;
constexpr int TH = 8;                  // feature rows per block
constexpr int TW = 32;                 // feature cols per block
constexpr int HR = TH + 2;             // halo rows
constexpr int HC = TW + 2;             // halo cols
constexpr int NPIX = HR * HC;
constexpr int THREADS = 384;
static_assert(THREADS >= NPIX, "one halo pixel per thread");
// weights [CIN][MAXC] + BN scale/shift [2][CIN] + class bias [MAXC], floats
constexpr int PARAM_FLOATS = CIN * MAXC + 2 * CIN + MAXC;

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  // a bf16 is the high half of the f32 with the same bits
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__host__ __device__ constexpr int feat_stride() { return CIN + Traits<T>::VEC; }  // +16 bytes a pixel

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * PARAM_FLOATS + sizeof(T) * (size_t)NPIX * feat_stride<T>();
}

// feat: (B, h, w, 128); wt: (128, CP) f32, CP = C rounded up to 4, already
// rounded to T's precision; ab: (2, 128) f32 folded BN scale/shift;
// bias: (C,) f32; out: (B, 4h, 4w) int8.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
seghead_kernel(const T* __restrict__ feat, const float* __restrict__ wt,
               const float* __restrict__ ab, const float* __restrict__ bias,
               int8_t* __restrict__ out, int h, int w, int C) {
  constexpr int VEC = Traits<T>::VEC;
  constexpr int FS = feat_stride<T>();
  extern __shared__ float4 smem4[];
  float* wt_s = reinterpret_cast<float*>(smem4);  // [CIN][CP]
  float* ab_s = wt_s + CIN * MAXC;                // [2][CIN]
  float* bias_s = ab_s + 2 * CIN;                 // [MAXC]
  T* feat_s = reinterpret_cast<T*>(bias_s + MAXC);  // [NPIX][FS]
  float* logit_s = reinterpret_cast<float*>(feat_s);  // [C][NPIX], after the features

  const int CP = (C + 3) / 4 * 4;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TH;  // first feature row of the tile
  const int j0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  for (int i = tid; i < CIN * CP; i += THREADS) wt_s[i] = wt[i];
  for (int i = tid; i < 2 * CIN; i += THREADS) ab_s[i] = ab[i];
  for (int i = tid; i < C; i += THREADS) bias_s[i] = bias[i];
  const T* fb = feat + (size_t)b * h * w * CIN;
  constexpr int NV = CIN / VEC;
  for (int i = tid; i < NPIX * NV; i += THREADS) {
    const int px = i / NV;
    const int v = i - px * NV;
    const int hr = px / HC;
    const int hc = px - hr * HC;
    const int gr = min(max(i0 - 1 + hr, 0), h - 1);  // edge replication
    const int gc = min(max(j0 - 1 + hc, 0), w - 1);
    *reinterpret_cast<uint4*>(feat_s + px * FS + v * VEC) =
        *reinterpret_cast<const uint4*>(fb + ((size_t)gr * w + gc) * CIN + v * VEC);
  }
  __syncthreads();

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  if (tid < NPIX) {
    const T* xp = feat_s + tid * FS;
    for (int k0 = 0; k0 < CIN; k0 += VEC) {
      float xs[VEC];
      Traits<T>::unpack(*reinterpret_cast<const uint4*>(xp + k0), xs);
#pragma unroll
      for (int kk = 0; kk < VEC; ++kk) {
        const int k = k0 + kk;
        const float a = Traits<T>::round(
            fmaxf(fmaf(xs[kk], ab_s[k], ab_s[CIN + k]), 0.f));
        const float4* wk = reinterpret_cast<const float4*>(wt_s + k * CP);
#pragma unroll
        for (int c4 = 0; c4 < MAXC / 4; ++c4) {
          if (c4 * 4 < C) {
            const float4 wv = wk[c4];
            acc[c4 * 4 + 0] = fmaf(a, wv.x, acc[c4 * 4 + 0]);
            acc[c4 * 4 + 1] = fmaf(a, wv.y, acc[c4 * 4 + 1]);
            acc[c4 * 4 + 2] = fmaf(a, wv.z, acc[c4 * 4 + 2]);
            acc[c4 * 4 + 3] = fmaf(a, wv.w, acc[c4 * 4 + 3]);
          }
        }
      }
    }
  }
  __syncthreads();  // every feature read is done before logits overwrite them
  if (tid < NPIX) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) logit_s[c * NPIX + tid] = acc[c] + bias_s[c];
  }
  __syncthreads();

  const int H4 = 4 * h;
  const int W4 = 4 * w;
  for (int o = tid; o < 16 * TH * TW; o += THREADS) {
    const int oy = o / (4 * TW);
    const int ox = o - oy * (4 * TW);
    const int Y = 4 * i0 + oy;
    const int X = 4 * j0 + ox;
    if (Y >= H4 || X >= W4) continue;
    // torch's area_pixel_compute_source_index, align_corners=False, scale 1/4
    const float sy = fmaxf((Y + 0.5f) * 0.25f - 0.5f, 0.f);
    const float sx = fmaxf((X + 0.5f) * 0.25f - 0.5f, 0.f);
    const int y0 = (int)sy;
    const int x0 = (int)sx;
    const float ly1 = sy - y0, ly0 = 1.f - ly1;
    const float lx1 = sx - x0, lx0 = 1.f - lx1;
    const int hy0 = y0 - (i0 - 1);
    const int hy1 = hy0 + (y0 < h - 1 ? 1 : 0);
    const int hx0 = x0 - (j0 - 1);
    const int hx1 = hx0 + (x0 < w - 1 ? 1 : 0);
    const int p00 = hy0 * HC + hx0, p01 = hy0 * HC + hx1;
    const int p10 = hy1 * HC + hx0, p11 = hy1 * HC + hx1;
    float best = 0.f;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      const float* L = logit_s + c * NPIX;
      const float v = ly0 * (lx0 * L[p00] + lx1 * L[p01]) + ly1 * (lx0 * L[p10] + lx1 * L[p11]);
      if (c == 0 || v > best) {
        best = v;
        arg = c;
      }
    }
    out[((size_t)b * H4 + Y) * W4 + X] = (int8_t)arg;
  }
}

template <typename T>
int launch(const void* feat, const void* wt, const void* ab, const void* bias, void* out,
           int B, int h, int w, int C, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      seghead_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
  seghead_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(wt),
      static_cast<const float*>(ab), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), h, w, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted. 1 <= C <= 32.
int dcss_seghead(const void* feat, const void* wt, const void* ab, const void* bias,
                 void* out, int B, int h, int w, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(feat, wt, ab, bias, out, B, h, w, C, s)
                 : launch<float>(feat, wt, ab, bias, out, B, h, w, C, s);
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
