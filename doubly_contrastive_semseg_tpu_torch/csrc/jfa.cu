// One update of the label-carrying jump flood, for Hopper (sm_90a):
// the distance from each pixel to the nearest pixel of another label.
//
// Replaces doubly_contrastive_semseg_tpu/ops/edt.py:88
// nearest_diff_label_distance, which has no Pallas kernel: XLA fuses each
// of its (round, direction) updates into one pass. In eager PyTorch the
// same update is about 25 elementwise kernels, so a 768^2 call would make
// some 2,200 launches; here it is one launch an update, 88 at 768^2
// (11 rounds x 8 directions), 64 at 96^2.
//
// An update must see the state the previous direction left: JAX rolls the
// state after the previous direction's selects, and step (b) below reads
// step (a)'s result at the same pixel. So the wrapper (ops/edt.py::
// jump_flood_cuda) launches once per update, reading state buffer A at p
// and at the neighbour p - (dy, dx) and writing buffer B.
//
// State: one float4 a pixel, (seed y, seed x, squared distance, seed label
// as int bits). Step (a) adopts the neighbour's stored seed if that seed
// is set, its label differs from the pixel's and it is strictly closer;
// step (b) then adopts the neighbour pixel itself if its label differs and
// it is strictly closer than (a)'s result. A neighbour outside the frame
// is no candidate, as JAX's mask of its wrapped roll makes it. Squared
// distances are sums of squares of small integers, exact in float32, and
// the root is __fsqrt_rn (IEEE, whatever the build flags), so the result
// equals the plain version and JAX bit for bit.
//
// Bound: bytes. Each update reads 2 x 16 B of state and 2 labels and
// writes 16 B a pixel: about 50 B, 235 MB an update for a batch of 8
// 768^2 crops, 88 times a call, where the function's own input and output
// are 5 B a pixel. The simple design streams the state through device
// memory; a compact state (int16 coordinates, d^2 recomputed, uint8
// labels) that keeps a 768^2 x 8 batch in L2 is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e9f;
constexpr int THREADS = 256;

template <typename L, bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS)
jfa_step(const L* __restrict__ labels, const float4* __restrict__ src,
         float4* __restrict__ dst, float* __restrict__ dist,
         int n, int H, int W, int dy, int dx) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int row = i / W;
  const int x = i - row * W;
  const int y = row % H;
  const int mine = static_cast<int>(labels[i]);
  // the first update starts from the empty state: no seed, d^2 = BIG^2
  float4 s = FIRST ? make_float4(BIG, BIG, BIG * BIG, __int_as_float(-1)) : src[i];
  const int ny = y - dy, nx = x - dx;
  if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
    const int j = i - dy * W - dx;
    if (!FIRST) {   // (a) the neighbour's stored seed (none in the empty state)
      const float4 c = src[j];
      const int cl = __float_as_int(c.w);
      if (c.x < BIG && cl != mine) {
        const float ey = __fsub_rn(static_cast<float>(y), c.x);
        const float ex = __fsub_rn(static_cast<float>(x), c.y);
        const float cd = __fadd_rn(__fmul_rn(ey, ey), __fmul_rn(ex, ex));
        if (cd < s.z) s = make_float4(c.x, c.y, cd, c.w);
      }
    }
    // (b) the neighbour pixel itself, a seed of its own label
    const int nl = static_cast<int>(labels[j]);
    const float d2 = static_cast<float>(dy * dy + dx * dx);
    if (nl != mine && d2 < s.z) {
      s = make_float4(static_cast<float>(ny), static_cast<float>(nx), d2, __int_as_float(nl));
    }
  }
  if (LAST) {
    dist[i] = s.z >= BIG ? 0.0f : __fsqrt_rn(s.z);
  } else {
    dst[i] = s;
  }
}

template <typename L>
cudaError_t launch(const void* labels, const void* src, void* dst, void* dist, int n,
                   int H, int W, int dy, int dx, int mode, cudaStream_t stream) {
  const dim3 grid((n + THREADS - 1) / THREADS);
  const L* lab = static_cast<const L*>(labels);
  const float4* in = static_cast<const float4*>(src);
  float4* out = static_cast<float4*>(dst);
  float* d = static_cast<float*>(dist);
  switch (mode) {
    case 0: jfa_step<L, false, false><<<grid, THREADS, 0, stream>>>(lab, in, out, d, n, H, W, dy, dx); break;
    case 1: jfa_step<L, true, false><<<grid, THREADS, 0, stream>>>(lab, in, out, d, n, H, W, dy, dx); break;
    case 2: jfa_step<L, false, true><<<grid, THREADS, 0, stream>>>(lab, in, out, d, n, H, W, dy, dx); break;
    case 3: jfa_step<L, true, true><<<grid, THREADS, 0, stream>>>(lab, in, out, d, n, H, W, dy, dx); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One (round, direction) update of the flood over n = B * H * W pixels.
// labels: uint8, int32 or int64 (label_bytes 1, 4, 8). src, dst: n float4
// states; mode bit 0: the first update (src unread), bit 1: the last
// (writes n float32 distances to dist, dst unwritten). Returns a
// cudaError_t code: 0 when the launch was accepted.
int dcss_jfa_step(const void* labels, int label_bytes, const void* src, void* dst,
                  void* dist, int n, int H, int W, int dy, int dx, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  switch (label_bytes) {
    case 1: return launch<uint8_t>(labels, src, dst, dist, n, H, W, dy, dx, mode, s);
    case 4: return launch<int32_t>(labels, src, dst, dist, n, H, W, dy, dx, mode, s);
    case 8: return launch<int64_t>(labels, src, dst, dist, n, H, W, dy, dx, mode, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
