// Contrastive row statistics (K3) for Hopper (sm_90a): two passes over the
// symmetric half of the logits on split-TF32 tensor cores.
//
// Over the logits L = Z Z^T / tau of N embeddings Z (N, D) f32, with
// vpair_ij = valid_i & valid_j, same_ij = vpair_ij & (label_i == label_j),
// pos_ij = same_ij & (i != j) and lhat_ij = (l_ij - m_i) / n_i:
//   m_i = max over valid j of l_ij (diagonal included); -1e30 if none
//   n_i = max(sqrt(sum over valid j of (l_ij - m_i)^2), 1e-12)
//   s_i = sum of exp(lhat_ij) over valid j != i (supcon), or, in neg_mode,
//         over valid j of another label (pixel contrast)
//   p_i = sum over pos of lhat_ij;  c_i = #pos
// The N x N matrix is never stored.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/
// contrastive_pallas.py:235 contrastive_row_stats (_max_kernel :94,
// _norm_kernel :114, _sums_kernel :135), and the three sweeps of
// csrc/contrastive.cu that ported it first.
//
// Bound: operations. The stats need each distinct logit of the symmetric L
// once: N(N+1)/2 dot products, N(N+1)*D f32 flops (8.59 GFLOP at N = 8192,
// D = 128; Z is 4 MB). An f32-accurate product runs on CUDA cores (67
// TFLOP/s: 0.128 ms) or as three TF32 tensor-core products (3 x 8.59 GFLOP
// at 494.7 TFLOP/s: 0.052 ms); the bound is the lesser.
//
// Design:
// - Two passes. Pass A gives m and n together: each (row, column tile)
//   side carries (m_t, the row's max in the tile; S1 = sum (l - m_t);
//   S2 = sum (l - m_t)^2; k = #valid). Partials merge with the exact shift
//   S2 += 2 d S1 + k d^2, S1 += k d, for d = m_old - m_new <= 0: every term
//   has one sign, so nothing cancels; a partial with k = 0 is skipped (its
//   m is -1e30, and d^2 would overflow). Pass B gives s, p, c from the
//   final m and n.
// - The symmetric half. A block owns one tile pair (I, J), I <= J, of
//   128 x 128 logits and computes it once: rows of I read it as l_ij (row
//   sums), rows of J as l_ji = l_ij (column sums). A diagonal tile is read
//   by its rows only, so each ordered pair counts once.
// - No carry across blocks and no atomics: each (row, column tile) side
//   writes its partial once into scratch [4][tiles][N] f32, allocated by
//   the wrapper, and a reduce launch combines each row's partials in tile
//   order. Two calls on the same inputs give bitwise-equal outputs.
//   Scratch: 16 * N * ceil(N / 128) bytes, 8.4 MB at N = 8192, 537 MB at
//   N = 65536.
// - Split-TF32 tensor cores: mma.sync m16n8k8 TF32 with f32 accumulation;
//   each operand splits as hi = tf32(x), lo = tf32(x - hi) (round to
//   nearest, ties away, by integer add and mask), and the products lo*hi +
//   hi*lo + hi*hi go into one accumulator, the small ones first. One TF32
//   product alone is ~400x less accurate than f32. |lhat| <= 1, so pass B's
//   __expf (ex2.approx) errs by a few ulp, far inside the 1e-5 gates.
// - Z is staged as f32 by cp.async, 32 of D at a time into two buffers,
//   zero-filled past N and past D (D % 8 != 0 included); the split happens
//   as fragments are loaded, so shared memory holds one copy. Rows are
//   36 floats apart, so the fragment loads are free of bank conflicts.
//   8 warps, each 64 x 32 logits; 88 KB of shared memory, two blocks an SM.
// - Any D >= 1: the chunk loop over D is the only place D enters, so
//   shared memory, registers and scratch do not grow with it (the DeepLab
//   family's pixel contrast runs at D = 2048, 720, 480 and 320).
// Launches a call: pass A, its reduce, pass B, its reduce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                 // rows and columns of a tile
constexpr int THREADS = 256;
constexpr int WARP_M = 64, WARP_N = 32;   // logits a warp holds
constexpr int WARPS_M = TILE / WARP_M;    // 2
constexpr int WARPS_N = TILE / WARP_N;    // 4
constexpr int MT = WARP_M / 16;           // mma tiles a warp, along rows
constexpr int NT = WARP_N / 8;            // and along columns
constexpr int KC = 32;                    // D staged a buffer
constexpr int LDS = KC + 4;               // staged row stride, floats
constexpr int REDUCE_THREADS = 128;
constexpr float NEG_BIG = -1e30f;

static_assert(THREADS == 2 * TILE, "one thread a row of each side");
static_assert(THREADS / 32 == WARPS_M * WARPS_N, "warp grid");

enum Step { PASS_A = 0, REDUCE_A = 1, PASS_B = 2, REDUCE_B = 3 };

struct Smem {
  float z[2][2][TILE * LDS];         // [buffer][side: rows of I, rows of J]
  int lab[2][TILE];                  // [side]
  int ok[2][TILE];
  float m[2][TILE];
  float rn[2][TILE];                 // 1 / n
  float red_row[WARPS_N][TILE][3];   // each column warp's partials of a row
  float red_col[WARPS_M][TILE][3];   // each row warp's partials of a column
  float tmax[2][TILE];               // pass A: a row's or column's tile max
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// hi = tf32(x), lo = tf32(x - hi): round to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds, by an integer add and mask (cheaper than cvt).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Block b's tile pair (I, J): the upper triangle I <= J, column by column.
__device__ __forceinline__ void tile_pair(int b, int& I, int& J) {
  int j = (int)((sqrtf(8.f * (float)b + 1.f) - 1.f) * 0.5f);
  while (j * (j + 1) / 2 > b) --j;
  while ((j + 1) * (j + 2) / 2 <= b) ++j;
  I = b - j * (j + 1) / 2;
  J = j;
}

// Stages columns [k0, k0 + KC) of the rows r0.. (side 0) and c0.. (side 1)
// of z into buffer buf, zeros past N and past D.
__device__ __forceinline__ void stage_chunk(Smem& sm, int buf, const float* __restrict__ z,
                                            int N, int D, int r0, int c0, int k0) {
  if ((D & 3) == 0) {
    constexpr int QUADS = KC / 4;
    for (int idx = threadIdx.x; idx < 2 * TILE * QUADS; idx += THREADS) {
      const int side = idx / (TILE * QUADS);
      const int rem = idx % (TILE * QUADS);
      const int r = rem / QUADS, q = rem % QUADS;
      const int row = (side ? c0 : r0) + r, k = k0 + 4 * q;
      const bool ok = row < N && k < D;
      cp_async16(&sm.z[buf][side][r * LDS + 4 * q], ok ? z + (size_t)row * D + k : z, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * TILE * KC; idx += THREADS) {
      const int side = idx / (TILE * KC);
      const int rem = idx % (TILE * KC);
      const int r = rem / KC, kk = rem % KC;
      const int row = (side ? c0 : r0) + r, k = k0 + kk;
      const bool ok = row < N && k < D;
      cp_async4(&sm.z[buf][side][r * LDS + kk], ok ? z + (size_t)row * D + k : z, ok);
    }
  }
}

// acc = the warp's 64 x 32 block of Z_I Z_J^T, split-TF32.
__device__ __forceinline__ void tile_products(Smem& sm, const float* __restrict__ z, int N,
                                              int D, int r0, int c0,
                                              float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % WARPS_M) * WARP_M, wc = (warp / WARPS_M) * WARP_N;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nchunks = (D + KC - 1) / KC;
  stage_chunk(sm, 0, z, N, D, r0, c0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nchunks) stage_chunk(sm, buf ^ 1, z, N, D, r0, c0, (ch + 1) * KC);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* A = sm.z[buf][0];
    const float* B = sm.z[buf][1];
    const int ksteps = min(KC / 8, (D - ch * KC + 7) / 8);
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks < ksteps) {
        const int k = 8 * ks + t;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const float* bp = B + (wc + ni * 8 + g) * LDS + k;
          split_tf32(bp[0], bh[ni][0], bl[ni][0]);
          split_tf32(bp[4], bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float* ap = A + (wr + mi * 16 + g) * LDS + k;
          uint32_t ah[4], al[4];
          split_tf32(ap[0], ah[0], al[0]);
          split_tf32(ap[8 * LDS], ah[1], al[1]);
          split_tf32(ap[4], ah[2], al[2]);
          split_tf32(ap[8 * LDS + 4], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            mma_tf32(acc[mi][ni], al, bh[ni]);
            mma_tf32(acc[mi][ni], ah, bl[ni]);
            mma_tf32(acc[mi][ni], ah, bh[ni]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
}

__device__ __forceinline__ float row_lanes_max(float v) {  // the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_lanes_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float col_lanes_max(float v) {  // the 8 lanes of a column
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ float col_lanes_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// One tile pair of pass A (partials of m, S1, S2, k) or pass B (of s, p, c).
// Accumulator element e of mma tile (mi, ni) is row wr + 16 mi + g + 8 (e >> 1)
// and column wc + 8 ni + 2 t + (e & 1) of the tile.
template <int PASS>
__global__ void __launch_bounds__(THREADS, 2)
tile_kernel(const float* __restrict__ z, const int* __restrict__ labels,
            const int* __restrict__ valid, int N, int D, float inv_temp, int neg_mode,
            const float* __restrict__ m_in, const float* __restrict__ n_in,
            float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int nt = (N + TILE - 1) / TILE;
  int I, J;
  tile_pair(blockIdx.x, I, J);
  const int r0 = I * TILE, c0 = J * TILE;
  const bool two_sided = I != J;
  const int tid = threadIdx.x;
  {
    const int side = tid / TILE, r = tid % TILE;
    const int i = (side ? c0 : r0) + r;
    const bool in = i < N;
    sm.lab[side][r] = in ? labels[i] : 0;
    sm.ok[side][r] = in && valid[i] != 0;
    if (PASS == PASS_B) {
      sm.m[side][r] = in ? m_in[i] : 0.f;
      sm.rn[side][r] = in ? 1.f / n_in[i] : 0.f;
    }
  }  // read after tile_products' first barrier

  float acc[MT][NT][4];
  tile_products(sm, z, N, D, r0, c0, acc);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] *= inv_temp;

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int wr = wm * WARP_M, wc = wn * WARP_N;

  // this thread's 8 columns and 8 rows: validity bits and labels
  unsigned col_ok = 0, row_ok = 0;
  int col_lab[NT][2], row_lab[MT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = wc + ni * 8 + 2 * t + b;
      col_ok |= (sm.ok[1][c] ? 1u : 0u) << (2 * ni + b);
      col_lab[ni][b] = sm.lab[1][c];
    }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + mi * 16 + g + 8 * h;
      row_ok |= (sm.ok[0][r] ? 1u : 0u) << (2 * mi + h);
      row_lab[mi][h] = sm.lab[0][r];
    }

  const size_t plane = (size_t)nt * N;
  if (PASS == PASS_A) {
    // 1. each row's (and column's) max over the valid pairs of the tile
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_BIG;
        if (row_ok >> (2 * mi + h) & 1u) {
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              if (col_ok >> (2 * ni + b) & 1u) mx = fmaxf(mx, acc[mi][ni][2 * h + b]);
        }
        mx = row_lanes_max(mx);
        if (t == 0) sm.red_row[wn][wr + mi * 16 + g + 8 * h][0] = mx;
      }
    if (two_sided) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float mx = NEG_BIG;
          if (col_ok >> (2 * ni + b) & 1u) {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (row_ok >> (2 * mi + h) & 1u) mx = fmaxf(mx, acc[mi][ni][2 * h + b]);
          }
          mx = col_lanes_max(mx);
          if (g == 0) sm.red_col[wm][wc + ni * 8 + 2 * t + b][0] = mx;
        }
    }
    __syncthreads();
    if (tid < TILE) {
      float mx = sm.red_row[0][tid][0];
#pragma unroll
      for (int w = 1; w < WARPS_N; ++w) mx = fmaxf(mx, sm.red_row[w][tid][0]);
      sm.tmax[0][tid] = mx;
    } else if (two_sided) {
      const int c = tid - TILE;
      float mx = sm.red_col[0][c][0];
#pragma unroll
      for (int w = 1; w < WARPS_M; ++w) mx = fmaxf(mx, sm.red_col[w][c][0]);
      sm.tmax[1][c] = mx;
    }
    __syncthreads();

    // 2. S1, S2 and k about the tile max
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + mi * 16 + g + 8 * h;
        const float mt = sm.tmax[0][r];
        float s1 = 0.f, s2 = 0.f, k = 0.f;
        if (row_ok >> (2 * mi + h) & 1u) {
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              if (col_ok >> (2 * ni + b) & 1u) {
                const float d = acc[mi][ni][2 * h + b] - mt;
                s1 += d;
                s2 = fmaf(d, d, s2);
                k += 1.f;
              }
        }
        s1 = row_lanes_sum(s1);
        s2 = row_lanes_sum(s2);
        k = row_lanes_sum(k);
        if (t == 0) {
          sm.red_row[wn][r][0] = s1;
          sm.red_row[wn][r][1] = s2;
          sm.red_row[wn][r][2] = k;
        }
      }
    if (two_sided) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = wc + ni * 8 + 2 * t + b;
          const float mt = sm.tmax[1][c];
          float s1 = 0.f, s2 = 0.f, k = 0.f;
          if (col_ok >> (2 * ni + b) & 1u) {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (row_ok >> (2 * mi + h) & 1u) {
                  const float d = acc[mi][ni][2 * h + b] - mt;
                  s1 += d;
                  s2 = fmaf(d, d, s2);
                  k += 1.f;
                }
          }
          s1 = col_lanes_sum(s1);
          s2 = col_lanes_sum(s2);
          k = col_lanes_sum(k);
          if (g == 0) {
            sm.red_col[wm][c][0] = s1;
            sm.red_col[wm][c][1] = s2;
            sm.red_col[wm][c][2] = k;
          }
        }
    }
  } else {
    // pass B: s, p, c of each row from the final m and n, and of each
    // column of an off-diagonal tile (i != j there)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + mi * 16 + g + 8 * h;
        const float mr = sm.m[0][r], rnr = sm.rn[0][r];
        const int gi = r0 + r;
        float s = 0.f, p = 0.f, c = 0.f;
        if (row_ok >> (2 * mi + h) & 1u) {
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              if (col_ok >> (2 * ni + b) & 1u) {
                const float lh = (acc[mi][ni][2 * h + b] - mr) * rnr;
                const bool same = row_lab[mi][h] == col_lab[ni][b];
                const bool not_self = gi != c0 + wc + ni * 8 + 2 * t + b;
                if (neg_mode ? !same : not_self) s += __expf(lh);
                if (same && not_self) {
                  p += lh;
                  c += 1.f;
                }
              }
        }
        s = row_lanes_sum(s);
        p = row_lanes_sum(p);
        c = row_lanes_sum(c);
        if (t == 0) {
          sm.red_row[wn][r][0] = s;
          sm.red_row[wn][r][1] = p;
          sm.red_row[wn][r][2] = c;
        }
      }
    if (two_sided) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int cc = wc + ni * 8 + 2 * t + b;
          const float mc = sm.m[1][cc], rnc = sm.rn[1][cc];
          float s = 0.f, p = 0.f, c = 0.f;
          if (col_ok >> (2 * ni + b) & 1u) {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (row_ok >> (2 * mi + h) & 1u) {
                  const float lh = (acc[mi][ni][2 * h + b] - mc) * rnc;
                  const bool same = row_lab[mi][h] == col_lab[ni][b];
                  if (!neg_mode || !same) s += __expf(lh);
                  if (same) {
                    p += lh;
                    c += 1.f;
                  }
                }
          }
          s = col_lanes_sum(s);
          p = col_lanes_sum(p);
          c = col_lanes_sum(c);
          if (g == 0) {
            sm.red_col[wm][cc][0] = s;
            sm.red_col[wm][cc][1] = p;
            sm.red_col[wm][cc][2] = c;
          }
        }
    }
  }
  __syncthreads();

  // one partial a (row, column tile) side, the warps summed in order
  if (tid < TILE) {
    const int i = r0 + tid;
    if (i < N) {
      float f[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        f[q] = sm.red_row[0][tid][q];
#pragma unroll
        for (int w = 1; w < WARPS_N; ++w) f[q] += sm.red_row[w][tid][q];
      }
      const size_t at = (size_t)J * N + i;
      if (PASS == PASS_A) {
        scratch[at] = sm.tmax[0][tid];
        scratch[plane + at] = f[0];
        scratch[2 * plane + at] = f[1];
        scratch[3 * plane + at] = f[2];
      } else {
        scratch[at] = f[0];
        scratch[plane + at] = f[1];
        scratch[2 * plane + at] = f[2];
      }
    }
  } else if (two_sided) {
    const int cc = tid - TILE;
    const int j = c0 + cc;
    if (j < N) {
      float f[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        f[q] = sm.red_col[0][cc][q];
#pragma unroll
        for (int w = 1; w < WARPS_M; ++w) f[q] += sm.red_col[w][cc][q];
      }
      const size_t at = (size_t)I * N + j;
      if (PASS == PASS_A) {
        scratch[at] = sm.tmax[1][cc];
        scratch[plane + at] = f[0];
        scratch[2 * plane + at] = f[1];
        scratch[3 * plane + at] = f[2];
      } else {
        scratch[at] = f[0];
        scratch[plane + at] = f[1];
        scratch[2 * plane + at] = f[2];
      }
    }
  }
}

// m and n of each row from its pass-A partials, merged in tile order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_a_kernel(const float* __restrict__ scratch, int N, float* __restrict__ m_out,
                float* __restrict__ n_out) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= N) return;
  const int nt = (N + TILE - 1) / TILE;
  const size_t plane = (size_t)nt * N;
  float M = NEG_BIG, S1 = 0.f, S2 = 0.f, K = 0.f;
#pragma unroll 4
  for (int tj = 0; tj < nt; ++tj) {
    const size_t at = (size_t)tj * N + i;
    const float mb = scratch[at], s1b = scratch[plane + at];
    const float s2b = scratch[2 * plane + at], kb = scratch[3 * plane + at];
    if (kb == 0.f) continue;
    if (K == 0.f) {
      M = mb;
      S1 = s1b;
      S2 = s2b;
      K = kb;
      continue;
    }
    const float mn = fmaxf(M, mb);
    const float da = M - mn, db = mb - mn;
    S2 = (S2 + da * (2.f * S1 + K * da)) + (s2b + db * (2.f * s1b + kb * db));
    S1 = (S1 + K * da) + (s1b + kb * db);
    K += kb;
    M = mn;
  }
  m_out[i] = K > 0.f ? M : NEG_BIG;
  n_out[i] = fmaxf(sqrtf(S2), 1e-12f);
}

// s, p, c of each row: its pass-B partials summed in tile order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_b_kernel(const float* __restrict__ scratch, int N, float* __restrict__ s_out,
                float* __restrict__ p_out, float* __restrict__ c_out) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= N) return;
  const int nt = (N + TILE - 1) / TILE;
  const size_t plane = (size_t)nt * N;
  float s = 0.f, p = 0.f, c = 0.f;
#pragma unroll 4
  for (int tj = 0; tj < nt; ++tj) {
    const size_t at = (size_t)tj * N + i;
    s += scratch[at];
    p += scratch[plane + at];
    c += scratch[2 * plane + at];
  }
  s_out[i] = s;
  p_out[i] = p;
  c_out[i] = c;
}

template <int PASS>
int launch_tiles(const void* z, const void* labels, const void* valid, int N, int D,
                 float inv_temp, int neg_mode, const void* m, const void* n,
                 void* scratch, cudaStream_t stream) {
  const size_t bytes = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nt = (N + TILE - 1) / TILE;
  const long long blocks = nt * (nt + 1) / 2;
  tile_kernel<PASS><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const float*>(z), static_cast<const int*>(labels),
      static_cast<const int*>(valid), N, D, inv_temp, neg_mode,
      static_cast<const float*>(m), static_cast<const float*>(n),
      static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of a K3 call, `step` 0..3 in order: pass A (z, labels, valid
// -> scratch), reduce A (scratch -> m = out0, n = out1), pass B (z, labels,
// valid, m, n -> scratch), reduce B (scratch -> s = out0, p = out1, c =
// out2). z (N, D) f32 16-byte aligned, labels and 0/1 valid int32, all
// contiguous on the device; scratch holds 4 * ceil(N / 128) * N f32; unused
// pointers may be null. Returns a cudaError_t code: 0 when the launch was
// accepted.
int dcss_row_stats(int step, const void* z, const void* labels, const void* valid, int N,
                   int D, float inv_temp, int neg_mode, const void* m, const void* n,
                   void* scratch, void* out0, void* out1, void* out2, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned reduce_blocks = (unsigned)((N + REDUCE_THREADS - 1) / REDUCE_THREADS);
  switch (step) {
    case PASS_A:
      return launch_tiles<PASS_A>(z, labels, valid, N, D, inv_temp, neg_mode, m, n, scratch,
                                  st);
    case REDUCE_A:
      reduce_a_kernel<<<reduce_blocks, REDUCE_THREADS, 0, st>>>(
          static_cast<const float*>(scratch), N, static_cast<float*>(out0),
          static_cast<float*>(out1));
      return (int)cudaGetLastError();
    case PASS_B:
      return launch_tiles<PASS_B>(z, labels, valid, N, D, inv_temp, neg_mode, m, n, scratch,
                                  st);
    case REDUCE_B:
      reduce_b_kernel<<<reduce_blocks, REDUCE_THREADS, 0, st>>>(
          static_cast<const float*>(scratch), N, static_cast<float*>(out0),
          static_cast<float*>(out1), static_cast<float*>(out2));
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
