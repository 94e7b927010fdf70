// Row sweeps of the row-L2-normalised contrastive losses for Hopper (sm_90a).
//
// Over the logits L = Z Z^T / tau of N embeddings Z (N, D) f32, one launch
// makes one sweep and writes per-row statistics; the N x N matrix is never
// stored. With vpair_ij = valid_i & valid_j, same_ij = vpair_ij &
// (label_i == label_j), pos_ij = same_ij & (i != j), and
// lhat_ij = (l_ij - m_i) / n_i over valid pairs:
//   SWEEP_MAX   m_i = max over valid j (diagonal included); -1e30 if none
//   SWEEP_NORM  n_i = max(sqrt(sum over valid j of (l_ij - m_i)^2), 1e-12)
//   SWEEP_SUMS  s_i = sum of exp(lhat_ij) over valid j != i (supcon), or,
//               in neg_mode, over valid j of another label (pixel contrast);
//               p_i = sum over pos of lhat_ij; c_i = #pos
//   SWEEP_POS   q_i = sum over pos of [lhat_ij - log(exp(lhat_ij) + s_i)];
//               c_i = #pos
//
// Replaces the TPU kernels of doubly_contrastive_semseg_tpu/ops/
// contrastive_pallas.py: contrastive_row_stats (_max_kernel, _norm_kernel,
// _sums_kernel) for the first three sweeps, and the fourth sweep of
// pixel_contrast_loss_pallas (_pc_kernel).
//
// Bound: operations, f32 on CUDA cores (67 TFLOP/s on an H100 SXM at 700 W);
// Z is 4 MB at N = 8192, D = 128. This kernel recomputes every logit in
// each sweep, 2*N^2*D flops (17.2 GFLOP at that size), but the functions
// need each distinct logit once, and L is symmetric: the row stats need
// N(N+1)/2 dot products, N(N+1)*D flops (8.6 GFLOP, 0.128 ms), and the
// positive sweep only the positive pairs, sum(c_i)*D flops (about 0.37
// GFLOP, 0.0055 ms, at 19 labels with 10 % of the rows invalid).
// chip_smoke.py computes both bounds
// from its inputs; the elementwise work of a few operations a pair is not
// counted. Design: one
// block of 128 threads owns 32 rows and walks over all columns in tiles of
// 64, so each row's accumulators stay in registers and nothing is carried
// across blocks (no atomics: the result is deterministic). The block keeps
// its 32 rows and stages each column tile in shared memory, both k-major, so
// a thread reads one float4 of rows and one of columns per k and makes a
// 4 x 4 register tile with 16 FMAs. TF32 is not used: the tests hold the
// kernel to the f32 plain version. The per-row partials of the 16 threads
// that share a row are combined by warp shuffles in a fixed order. Rows and
// columns past N are masked, not padded: any N >= 1 and any D <= 256.
// |lhat| <= 1 by construction, so expf cannot overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;      // rows a block owns
constexpr int COLS = 64;      // columns a tile stages
constexpr int THREADS = 128;  // 8 x 16 threads, each 4 rows x 4 columns
constexpr int MAX_D = 256;
constexpr float NEG_BIG = -1e30f;

enum Sweep { SWEEP_MAX = 0, SWEEP_NORM = 1, SWEEP_SUMS = 2, SWEEP_SUMS_NEG = 3, SWEEP_POS = 4 };

__host__ __device__ constexpr int round4(int d) { return (d + 3) & ~3; }

// Copies rows [r0, r0 + R) of z (N, D) into dst as k-major [Dp][R], zeros
// past N and past D.
template <int R>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ z, int r0,
                                      int N, int D, int Dp) {
  if ((D & 3) == 0) {
    const int quads = Dp >> 2;
    for (int idx = threadIdx.x; idx < R * quads; idx += THREADS) {
      const int r = idx % R;
      const int kq = idx / R;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < N) v = *reinterpret_cast<const float4*>(z + (size_t)(r0 + r) * D + 4 * kq);
      dst[(4 * kq + 0) * R + r] = v.x;
      dst[(4 * kq + 1) * R + r] = v.y;
      dst[(4 * kq + 2) * R + r] = v.z;
      dst[(4 * kq + 3) * R + r] = v.w;
    }
  } else {
    for (int idx = threadIdx.x; idx < R * Dp; idx += THREADS) {
      const int r = idx % R;
      const int k = idx / R;
      dst[k * R + r] = (r0 + r < N && k < D) ? z[(size_t)(r0 + r) * D + k] : 0.f;
    }
  }
}

template <int SWEEP>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ z, const int* __restrict__ labels,
             const int* __restrict__ valid, int N, int D, float inv_temp,
             const float* __restrict__ m_in, const float* __restrict__ n_in,
             const float* __restrict__ s_in, float* __restrict__ out0,
             float* __restrict__ out1, float* __restrict__ out2) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  float* zr = smem;                  // [Dp][ROWS]
  float* zc = zr + Dp * ROWS;        // [Dp][COLS]
  int* lab_c = reinterpret_cast<int*>(zc + Dp * COLS);  // [COLS]
  int* val_c = lab_c + COLS;                            // [COLS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: columns 4tx .. 4tx+3 of the tile
  const int ty = tid >> 4;  // row group: rows 4ty .. 4ty+3 of the block
  const int r0 = blockIdx.x * ROWS;

  stage<ROWS>(zr, z, r0, N, D, Dp);

  int row_lab[4];
  bool row_ok[4];
  float rm[4], rn[4], rs[4];
  float acc0[4], acc1[4], acc2[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + 4 * ty + a;
    row_ok[a] = i < N && valid[i] != 0;
    row_lab[a] = i < N ? labels[i] : 0;
    rm[a] = (SWEEP != SWEEP_MAX && i < N) ? m_in[i] : 0.f;
    rn[a] = (SWEEP >= SWEEP_SUMS && i < N) ? n_in[i] : 1.f;
    rs[a] = (SWEEP == SWEEP_POS && i < N) ? s_in[i] : 0.f;
    acc0[a] = SWEEP == SWEEP_MAX ? NEG_BIG : 0.f;
    acc1[a] = 0.f;
    acc2[a] = 0.f;
  }

  for (int c0 = 0; c0 < N; c0 += COLS) {
    __syncthreads();  // the previous tile is no longer read
    stage<COLS>(zc, z, c0, N, D, Dp);
    if (tid < COLS) {
      const int j = c0 + tid;
      lab_c[tid] = j < N ? labels[j] : 0;
      val_c[tid] = j < N ? valid[j] : 0;
    }
    __syncthreads();

    float l[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) l[a][b] = 0.f;
#pragma unroll 4
    for (int k = 0; k < Dp; ++k) {
      const float4 ra = *reinterpret_cast<const float4*>(zr + k * ROWS + 4 * ty);
      const float4 cb = *reinterpret_cast<const float4*>(zc + k * COLS + 4 * tx);
      const float rv[4] = {ra.x, ra.y, ra.z, ra.w};
      const float cv[4] = {cb.x, cb.y, cb.z, cb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) l[a][b] = fmaf(rv[a], cv[b], l[a][b]);
    }

#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int cl = 4 * tx + b;
      const int j = c0 + cl;
      const bool col_ok = val_c[cl] != 0;
      const int col_lab = lab_c[cl];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (!(row_ok[a] && col_ok)) continue;
        const float lij = l[a][b] * inv_temp;
        if (SWEEP == SWEEP_MAX) {
          acc0[a] = fmaxf(acc0[a], lij);
        } else if (SWEEP == SWEEP_NORM) {
          const float d = lij - rm[a];
          acc0[a] = fmaf(d, d, acc0[a]);
        } else {
          const int i = r0 + 4 * ty + a;
          const bool same = row_lab[a] == col_lab;
          const bool pos = same && i != j;
          const float lh = (lij - rm[a]) / rn[a];
          if (SWEEP == SWEEP_POS) {
            if (pos) {
              acc0[a] += lh - logf(expf(lh) + rs[a]);
              acc1[a] += 1.f;
            }
          } else {
            const bool in_denominator = SWEEP == SWEEP_SUMS_NEG ? !same : i != j;
            if (in_denominator) acc0[a] += expf(lh);
            if (pos) {
              acc1[a] += lh;
              acc2[a] += 1.f;
            }
          }
        }
      }
    }
  }

  // combine the 16 threads (lanes of one half-warp) that share these rows
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float o0 = __shfl_xor_sync(0xffffffffu, acc0[a], off);
      const float o1 = __shfl_xor_sync(0xffffffffu, acc1[a], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, acc2[a], off);
      acc0[a] = SWEEP == SWEEP_MAX ? fmaxf(acc0[a], o0) : acc0[a] + o0;
      acc1[a] += o1;
      acc2[a] += o2;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = r0 + 4 * ty + a;
      if (i >= N) continue;
      if (SWEEP == SWEEP_MAX) {
        out0[i] = acc0[a];
      } else if (SWEEP == SWEEP_NORM) {
        out0[i] = fmaxf(sqrtf(acc0[a]), 1e-12f);
      } else if (SWEEP == SWEEP_POS) {
        out0[i] = acc0[a];
        out1[i] = acc1[a];
      } else {
        out0[i] = acc0[a];
        out1[i] = acc1[a];
        out2[i] = acc2[a];
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)round4(D) * (ROWS + COLS) + sizeof(int) * 2 * COLS;
}

template <int SWEEP>
int launch(const void* z, const void* labels, const void* valid, int N, int D,
           float inv_temp, const void* m, const void* n, const void* s, void* out0,
           void* out1, void* out2, cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<SWEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + ROWS - 1) / ROWS);
  sweep_kernel<SWEEP><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(z), static_cast<const int*>(labels),
      static_cast<const int*>(valid), N, D, inv_temp, static_cast<const float*>(m),
      static_cast<const float*>(n), static_cast<const float*>(s),
      static_cast<float*>(out0), static_cast<float*>(out1), static_cast<float*>(out2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One sweep (0 max, 1 norm, 2 sums, 3 sums in neg_mode, 4 positive log-prob)
// over z (N, D) f32 with int32 labels and int32 0/1 validity, all contiguous
// on the device. m, n, s are the (N,) results of earlier sweeps (unused ones
// may be null); out0..out2 are (N,) f32. Returns a cudaError_t code: 0 when
// the launch was accepted.
int dcss_contrastive_sweep(int sweep, const void* z, const void* labels, const void* valid,
                           int N, int D, float inv_temp, const void* m, const void* n,
                           const void* s, void* out0, void* out1, void* out2, void* stream) {
  if (N < 1 || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sweep) {
    case SWEEP_MAX:
      return launch<SWEEP_MAX>(z, labels, valid, N, D, inv_temp, m, n, s, out0, out1, out2, st);
    case SWEEP_NORM:
      return launch<SWEEP_NORM>(z, labels, valid, N, D, inv_temp, m, n, s, out0, out1, out2, st);
    case SWEEP_SUMS:
      return launch<SWEEP_SUMS>(z, labels, valid, N, D, inv_temp, m, n, s, out0, out1, out2, st);
    case SWEEP_SUMS_NEG:
      return launch<SWEEP_SUMS_NEG>(z, labels, valid, N, D, inv_temp, m, n, s, out0, out1, out2,
                                    st);
    case SWEEP_POS:
      return launch<SWEEP_POS>(z, labels, valid, N, D, inv_temp, m, n, s, out0, out1, out2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
