// Fused segmentation serving head for Hopper (sm_90a), bf16 features on
// tensor cores:
//   labels = argmax_c( upsample_x4_bilinear( conv1x1( relu( BN_eval(feat) ) ) + bias ) )
// in one pass over the decoder features; the full-resolution logits are
// never written to device memory.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/seghead_pallas.py:164
// fused_seghead_upsample_argmax (_kernel :65, _phases4 :45), with its
// numerics: post-BN-ReLU activations and weights rounded to bf16, products
// summed in f32, the x4 bilinear in the delta form of _phases4 in f32, ties
// to the first class (strict '>', as torch.argmax and jnp.argmax).
//
// Bound: bytes. At a batch of 8 2048x1024 frames the kernel must read
// 268.4 MB of bf16 features and write 16.8 MB of int8 labels, 0.0851 ms at
// 3.35 TB/s; the 128 -> 19 1x1 is 5.1 GFLOP, microseconds on tensor cores.
// What each part of the design does (csrc/seghead.cu is the CUDA-core
// design it follows; the f32 route keeps it):
//  - Persistent blocks, two an SM, walk work items of (image, strip of 64
//    feature columns, run of 32 feature rows), going down the rows of the
//    strip two rows a step. Each step stages two feature rows of the strip
//    and its two halo columns (66 pixels) and turns them into logit rows, so
//    a feature pixel's 1x1 runs 66/64 x (32 + 2)/32 = 1.10 times (1.33 with
//    the 8 x 32 tiles of seghead.cu): the logits of the last two rows of a
//    step stay in a ring of four logit rows for the next step.
//  - Staging is a double buffer of steps in shared memory, filled with
//    16-byte cp.async copies: the copies of step s + 1 (the next item's
//    first step at an item's end) are issued before step s computes, so
//    35.9 KB a block, 71.8 KB an SM, are in flight while the SM computes
//    (seghead.cu stages a whole tile, then waits, then computes). Source
//    addresses are clamped to the image, which is the edge replication of
//    the halo and of a ragged strip or run, at no extra cost.
//  - The 1x1 runs on mma.sync.m16n8k16 (bf16 in, f32 accumulators): M = the
//    132 staged pixels of a step (9 M tiles: warp k takes tile k, and n tile
//    k of the ninth), N = the classes padded to 8 NT, K = 128. The A
//    fragments are the staged words unpacked to f32, BN as fmaf(x, scale,
//    shift) per channel, rounded to bf16 pairs and max'ed with 0 (rounding
//    is monotone and keeps 0, so this is relu-then-round). The B fragments
//    are packed once by the wrapper (ops/seghead.py: pack_seghead) in
//    fragment order and held in registers for the whole walk. Padded
//    classes are never stored or read. (seghead.cu runs 128 x C sequential
//    FMAs a pixel on CUDA cores with a shared load every 4.)
//  - The logit ring is channel-planar, [row][class][68 floats], so the
//    accumulator stores (8 pixels x 4 class pairs a warp) and the upsample's
//    loads (32 consecutive pixels) are free of bank conflicts.
//  - Upsample-argmax in separable phases: two threads per feature pixel and
//    output row of the step, each with the top or bottom 2 x 4 of its 4 x 4
//    output block, keep the running best and argmax in registers; per class
//    a thread reads the 2 x 3 logits it needs (the next class's loads are
//    issued before this class's arithmetic), forms the 2 vertical phases of
//    the 3 columns and then the 4 horizontal phases of each, as _phases4
//    does: 6 logit reads for 8 outputs, where seghead.cu reads 32. Edge
//    replication of the logits is exactly F.interpolate(align_corners=False)
//    at scale 4. Each thread stores its labels as two 4-byte stores, a
//    warp's coalesced.
// Where the time goes (tools/profile_seghead.py ablates this source; on an
// H100 80GB HBM3 at 700 W): the copies alone take about 0.45 of the
// kernel, the arithmetic without the copies about 0.85, so the copies hide
// behind the arithmetic, most of it the upsample-argmax (3 compare-and-
// select operations a class and output pixel are the floor of an exact
// first-index argmax).
// Any h >= 1 and any w work; feat must be 16-byte aligned (cp.async).
// Budget: shared memory 71,808 (staging) + 1,024 (BN) + 32 NT (bias) +
// 1,088 C (logit ring) bytes: 93,600 at C = 19, two blocks an SM; 48
// registers a thread of B fragments at NT = 3 (ptxas: 128 registers, no
// spills; chip_smoke.py prints the report).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 128;
constexpr int STRIP = 64;                        // feature columns a work item
constexpr int RUN = 32;                          // feature rows a work item
constexpr int SPX = STRIP + 2;                   // staged pixels a row: the strip and its halo
constexpr int STEP_ROWS = 2;                     // feature rows a step
constexpr int STEP_PX = STEP_ROWS * SPX;         // 132
constexpr int MT = (STEP_PX + 15) / 16;          // 9 M tiles
constexpr int PX_WORDS = CIN / 2 + 4;            // a staged pixel: 256 bytes + 16 of padding
constexpr int SLOT_WORDS = STEP_PX * PX_WORDS;
constexpr size_t STAGE_BYTES = 2ull * SLOT_WORDS * 4;
constexpr int LS = SPX + 2;                      // floats a logit row of one class
constexpr int RING = 4;                          // logit rows kept
constexpr int KSTEPS = CIN / 16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
static_assert(THREADS == 2 * STEP_ROWS * STRIP, "two threads per pixel and row of a step");
static_assert(MT == WARPS + 1, "a tile per warp, the last one split by n tiles");
static_assert(RUN % STEP_ROWS == 0, "a run is whole steps");
static_assert((PX_WORDS * 4) % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte cp.async targets");
static_assert(PX_WORDS % 32 == 4 && LS % 32 == 4, "8 pixels x 4 word offsets hit 32 banks");

__host__ __device__ constexpr size_t smem_bytes(int nt, int c) {
  return STAGE_BYTES + 2 * CIN * 4 + nt * 8 * 4 + (size_t)RING * c * LS * 4;
}

struct Item {
  int b, r0, j0, nrows, nsteps;  // image, first row and column, rows, steps
};

__device__ __forceinline__ Item item_at(int item, int nruns, int nstrips, int h) {
  Item it;
  it.b = item / (nruns * nstrips);
  const int rem = item - it.b * nruns * nstrips;
  const int run = rem / nstrips;
  it.r0 = run * RUN;
  it.j0 = (rem - run * nstrips) * STRIP;
  it.nrows = min(RUN, h - it.r0);
  // step 0 computes logit rows r0 - 1 and r0; step q > 0 rows r0 + 2q - 1
  // and r0 + 2q and emits output rows r0 + 2q - 2 and r0 + 2q - 1
  it.nsteps = 1 + (it.nrows + 1) / 2;
  return it;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issues the copies of step q of an item: its two feature rows, 66 pixels
// each, source rows and columns clamped to the image. Thread t copies the
// 16-byte chunk t % 16 of every sixteenth pixel.
__device__ __forceinline__ void stage_step(uint32_t dst, const __nv_bfloat16* feat,
                                           const Item& it, int q, int h, int w) {
  const int v = threadIdx.x & 15;
  for (int px = threadIdx.x >> 4; px < STEP_PX; px += THREADS / 16) {
    const int r = px >= SPX ? 1 : 0;
    const int p = px - r * SPX;
    const int gr = min(max(it.r0 - 1 + 2 * q + r, 0), h - 1);
    const int gc = min(max(it.j0 - 1 + p, 0), w - 1);
    cp_async16(dst + (px * PX_WORDS + 4 * v) * 4,
               feat + (((size_t)it.b * h + gr) * w + gc) * CIN + 8 * v);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(relu(x * scale + shift)) of a staged pair of channels; bn holds
// (scale, scale, shift, shift) of the pair
__device__ __forceinline__ uint32_t activate(uint32_t x, float4 bn) {
  const float lo = __uint_as_float(x << 16);
  const float hi = __uint_as_float(x & 0xffff0000u);
  __nv_bfloat162 v = __floats2bfloat162_rn(fmaf(lo, bn.x, bn.z), fmaf(hi, bn.y, bn.w));
  v = __hmax2(v, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The logits of M tile mt, n tiles [n0, n1), of a step's two feature rows
// into ring rows j and j + 1 (mod RING)
template <int NT>
__device__ __forceinline__ void tile_products(const uint32_t* slot, const uint2 (&bf)[KSTEPS][NT],
                                              const float4* bn, const float* bias_s, float* ring,
                                              int C, int j, int mt, int n0, int n1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * mt + g;
  // the last tile's rows past the step's pixels: computed, never stored
  const uint32_t* x0 = slot + min(m0, STEP_PX - 1) * PX_WORDS + t;
  const uint32_t* x1 = slot + min(m0 + 8, STEP_PX - 1) * PX_WORDS + t;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    // channel pairs 16 s + 2 t and 16 s + 2 t + 8
    const float4 bn0 = bn[8 * s + t];
    const float4 bn1 = bn[8 * s + 4 + t];
    const uint32_t a[4] = {activate(x0[8 * s], bn0), activate(x1[8 * s], bn0),
                           activate(x0[8 * s + 4], bn1), activate(x1[8 * s + 4], bn1)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < n0 || n >= n1) continue;
      const uint2 b = bf[s][n];
      mma_bf16(acc[n], a, b.x, b.y);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + 8 * hh;
    if (m >= STEP_PX) continue;
    const int r = m >= SPX ? 1 : 0;
    float* row = ring + ((j + r) & (RING - 1)) * C * LS + (m - r * SPX);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      if (n < n0 || n >= n1) continue;
      if (c < C) row[c * LS] = acc[n][2 * hh] + bias_s[c];
      if (c + 1 < C) row[(c + 1) * LS] = acc[n][2 * hh + 1] + bias_s[c + 1];
    }
  }
}

// A step's logits: warp k computes M tile k, and n tile k of the last tile
template <int NT>
__device__ __forceinline__ void products(const uint32_t* slot, const uint2 (&bf)[KSTEPS][NT],
                                         const float4* bn, const float* bias_s, float* ring, int C,
                                         int j) {
  const int warp = threadIdx.x >> 5;
  tile_products<NT>(slot, bf, bn, bias_s, ring, C, j, warp, 0, NT);
  if (warp < NT) tile_products<NT>(slot, bf, bn, bias_s, ring, C, j, WARPS, warp, warp + 1);
}

// The 4 phases of a x4 bilinear along one axis, in _phases4's delta form
__device__ __forceinline__ void phases4(float p, float c, float n, float* out) {
  const float dp = p - c;
  const float dn = n - c;
  out[0] = c + 0.375f * dp;
  out[1] = c + 0.125f * dp;
  out[2] = c + 0.125f * dn;
  out[3] = c + 0.375f * dn;
}

// a[0..2]: the logits of the other row (prev for the top half, next for
// the bottom), columns left, own, right; a[3..5]: the pixel's own row. v[4
// ry + rx]: the half's 2 x 4 upsampled values, vertical phases first, with
// weights wy[ry] on the other row, as _phases4 forms them.
__device__ __forceinline__ void upsample8(const float (&a)[6], float w0, float w1,
                                          float (&v)[8]) {
  float col[2][3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float d = a[x] - a[3 + x];
    col[0][x] = a[3 + x] + w0 * d;
    col[1][x] = a[3 + x] + w1 * d;
  }
#pragma unroll
  for (int ry = 0; ry < 2; ++ry) phases4(col[ry][0], col[ry][1], col[ry][2], v + 4 * ry);
}

__device__ __forceinline__ void load6(const float* other, const float* own, int off,
                                      float (&a)[6]) {
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    a[x] = other[off + x - 1];
    a[3 + x] = own[off + x - 1];
  }
}

// The labels of output rows 2 half, 2 half + 1 of the 4 x 4 block of feature
// pixel p (1..64) of in-item output row jo (1..nrows): ring rows jo - 1, jo,
// jo + 1 hold logit rows r0 + jo - 2 .. r0 + jo.
__device__ __forceinline__ void upsample_argmax(const float* ring, int C, const Item& it, int jo,
                                                int half, int p, int h, int w, int8_t* out) {
  const int col = it.j0 + p - 1;
  if (jo > it.nrows || col >= w) return;
  const int i = it.r0 + jo - 1;
  const float* own = ring + (jo & (RING - 1)) * C * LS + p;
  const float* other = ring + ((half ? jo + 1 : jo - 1) & (RING - 1)) * C * LS + p;
  const float w0 = half ? 0.125f : 0.375f;  // phase offsets -3/8, -1/8 | 1/8, 3/8
  const float w1 = half ? 0.375f : 0.125f;
  float a[6], nx[6], v[8], best[8];
  int arg[8];
  load6(other, own, 0, a);
  if (C > 1) load6(other, own, LS, nx);
  upsample8(a, w0, w1, best);
#pragma unroll
  for (int k = 0; k < 8; ++k) arg[k] = 0;
  for (int c = 1; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = nx[k];
    if (c + 1 < C) load6(other, own, (c + 1) * LS, nx);
    upsample8(a, w0, w1, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool gt = v[k] > best[k];
      best[k] = fmaxf(best[k], v[k]);
      arg[k] = gt ? c : arg[k];
    }
  }
  const size_t W4 = 4 * (size_t)w;
  int8_t* o = out + ((size_t)it.b * 4 * h + 4 * i + 2 * half) * W4 + 4 * (size_t)col;
#pragma unroll
  for (int ry = 0; ry < 2; ++ry) {
    const uint32_t word = (uint32_t)arg[4 * ry] | ((uint32_t)arg[4 * ry + 1] << 8) |
                          ((uint32_t)arg[4 * ry + 2] << 16) | ((uint32_t)arg[4 * ry + 3] << 24);
    *reinterpret_cast<uint32_t*>(o + ry * W4) = word;
  }
}

// feat: (B, h, w, 128) bf16, 16-byte aligned; wfrag: the (8 NT, 128) bf16
// weights in B-fragment order, uint2 (s * NT + n) * 32 + lane; ab: (2, 128)
// f32 folded BN scale and shift; bias: (8 NT,) f32; out: (B, 4h, 4w) int8.
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
seghead_tc_kernel(const __nv_bfloat16* __restrict__ feat, const uint2* __restrict__ wfrag,
                  const float* __restrict__ ab, const float* __restrict__ bias,
                  int8_t* __restrict__ out, int B, int h, int w, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);  // [2][STEP_PX][PX_WORDS]
  float4* bn = reinterpret_cast<float4*>(smem + STAGE_BYTES);  // [CIN / 2]
  float* bias_s = reinterpret_cast<float*>(bn + CIN / 2);
  float* ring = bias_s + NT * 8;                        // [RING][C][LS]

  const int nstrips = (w + STRIP - 1) / STRIP;
  const int nruns = (h + RUN - 1) / RUN;
  const int items = B * nruns * nstrips;
  uint2 breg[KSTEPS][NT];  // this lane's B fragments, for the whole walk
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int n = 0; n < NT; ++n) breg[s][n] = wfrag[(s * NT + n) * 32 + (threadIdx.x & 31)];
  for (int i = threadIdx.x; i < CIN / 2; i += THREADS)
    bn[i] = make_float4(ab[2 * i], ab[2 * i + 1], ab[CIN + 2 * i], ab[CIN + 2 * i + 1]);
  for (int i = threadIdx.x; i < NT * 8; i += THREADS) bias_s[i] = bias[i];

  const uint32_t stage_addr = (uint32_t)__cvta_generic_to_shared(stage);
  int item = blockIdx.x;  // the step being computed: item, step q
  Item it = item_at(item, nruns, nstrips, h);
  int q = 0;
  int next_item = item;   // the step being staged
  Item nit = it;
  int nq = 0;
  bool staging = true;
  stage_step(stage_addr, feat, it, 0, h, w);
  cp_async_commit();
  for (int step = 0;; ++step) {
    if (staging && ++nq == nit.nsteps) {
      next_item += gridDim.x;
      staging = next_item < items;
      if (staging) nit = item_at(next_item, nruns, nstrips, h);
      nq = 0;
    }
    if (staging)
      stage_step(stage_addr + ((step + 1) & 1) * SLOT_WORDS * 4, feat, nit, nq, h, w);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // step's rows landed; the previous upsample is done with the ring
    products<NT>(stage + (step & 1) * SLOT_WORDS, breg, bn, bias_s, ring, C, 2 * q);
    __syncthreads();  // the logits are whole; every product has read the slot
    if (q > 0)
      upsample_argmax(ring, C, it, 2 * q - 1 + (threadIdx.x >> 7), (threadIdx.x >> 6) & 1,
                      (threadIdx.x & 63) + 1, h, w, out);
    if (++q == it.nsteps) {
      item += gridDim.x;
      if (item >= items) break;
      it = item_at(item, nruns, nstrips, h);
      q = 0;
    }
  }
}

// Blocks of seghead_tc_kernel<NT> that fit on the current device at once
// with C classes, found once per device and C: the kernel's grid.
template <int NT>
cudaError_t resident_blocks(int C, int* out) {
  static int cached[16][33] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && cached[dev][C] > 0) {
    *out = cached[dev][C];
    return cudaSuccess;
  }
  const size_t bytes = smem_bytes(NT, C);
  err = cudaFuncSetAttribute(seghead_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(NT, 8 * NT));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seghead_tc_kernel<NT>,
                                                           THREADS, bytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (dev < 16) cached[dev][C] = *out;
  return cudaSuccess;
}

template <int NT>
int launch(const void* feat, const void* wfrag, const void* ab, const void* bias, void* out,
           int B, int h, int w, int C, cudaStream_t stream) {
  const long long items =
      (long long)B * ((h + RUN - 1) / RUN) * ((w + STRIP - 1) / STRIP);
  if (items == 0) return 0;
  int resident = 0;
  const cudaError_t err = resident_blocks<NT>(C, &resident);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(items < resident ? items : (long long)resident);
  seghead_tc_kernel<NT><<<grid, THREADS, smem_bytes(NT, C), stream>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const uint2*>(wfrag),
      static_cast<const float*>(ab), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), B, h, w, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted (or there was
// nothing to do); cudaErrorInvalidValue unless 1 <= C <= 32. The weights
// are packed for NT = ceil(C / 8) n tiles (ops/seghead.py: pack_seghead).
int dcss_seghead_tc(const void* feat, const void* wfrag, const void* ab, const void* bias,
                    void* out, int B, int h, int w, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 7) / 8) {
    case 1: return launch<1>(feat, wfrag, ab, bias, out, B, h, w, C, s);
    case 2: return launch<2>(feat, wfrag, ab, bias, out, B, h, w, C, s);
    case 3: return launch<3>(feat, wfrag, ab, bias, out, B, h, w, C, s);
    case 4: return launch<4>(feat, wfrag, ab, bias, out, B, h, w, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
