// Pixel contrast's positive sweep (K4) for Hopper (sm_90a): only the
// same-label column tiles of the label-sorted rows, on split-TF32 tensor
// cores.
//
// Over the logits l_ij = z_i . z_j / tau of N embeddings Z (N, D) f32, with
// pos_ij = valid_i & valid_j & (label_i == label_j) & (i != j), and given
// K3's neg_mode row stats (m, n, s) (csrc/row_stats.cu), with
// lhat_ij = (l_ij - m_i) / n_i:
//   q_i = sum over pos of [lhat_ij - log(exp(lhat_ij) + s_i)]
//   c_i = #pos
// Rows with no positive (invalid, or alone in their label) get q = c = 0.
//
// Replaces the TPU kernel doubly_contrastive_semseg_tpu/ops/
// contrastive_pallas.py:510 pixel_contrast_loss_pallas (its fourth sweep,
// _pc_kernel :172, called at :463), and sweep 4 of csrc/contrastive.cu,
// which ported it first and walked all N^2 pairs on CUDA cores; that sweep
// stays only as the yardstick the tools time this kernel against
// (ops/contrastive.py::_dense_pos_sweep).
//
// Bound: operations. Only positive pairs count: sum(c_i) dot products of
// D multiply-adds. At N = 8192, D = 128, 19 labels and 10 % of the rows
// invalid that is 2.86 M ordered pairs, 0.73 GFLOP f32: 0.0044 ms as
// three TF32 tensor-core products (0.011 on CUDA cores); Z is 4 MB, 0.0013
// ms of memory.
//
// Design, three launches a call:
// - Layout (layout_kernel): key_i = label_i, or 2^40 for an invalid row
//   (above every int32 label), sorted stably: perm and the sorted keys,
//   exactly as torch.sort(keys, stable=True) gives them (its plain
//   version), without a host sync. Rows of one label are contiguous and
//   invalid rows come last. Each row's place is the number of rows before
//   it in (key, index) order, counted against every other row: one 64-bit
//   compare a pair of the unique composite (33-bit order-preserving key <<
//   31 | index). N^2 compares in one launch, where the library's stable
//   radix sort of int64 keys takes 25 (histogram, scan, 8 one-sweep
//   passes, their memsets, copies) and about 3x the time at N = 8192; the
//   compares stay far below the sweep's and K3's N^2 D work at every N.
//   32 rows a block, one a lane; its 8 warps split the columns, staged 2048
//   at a time; integer partials, so the order is fixed.
// - Sweep (pos_sweep_kernel): row tiles of 32 sorted rows, 4 blocks of 4
//   warps each. A tile's valid rows are a prefix (a tile with none exits at
//   once); warps 0 and 1 find its column range by a 32-way warp search of
//   the sorted keys (32 probes a round, about 3 rounds at N = 8192): from
//   the start of the first row's label segment to the end of the last
//   valid row's. The range is contiguous; it is cut into tiles of 64
//   columns, and block sp of the row tile visits tiles sp, sp + 4, ... and
//   no other column: about 388 + 32 columns a row at N = 8192 with 19
//   labels, instead of N. 32-row tiles keep the overhang small; the 4-way
//   split gives about 924 blocks at N = 8192, which the block scheduler
//   spreads over the 132 SMs, so a tile that straddles two labels (twice
//   the columns) no longer sets the time alone.
// - Products: K3's split-TF32 mma.sync m16n8k8 (hi = tf32(x), lo =
//   tf32(x - hi); lo*hi + hi*lo + hi*hi, the small ones first), so K4's
//   logits come from the same arithmetic as the m and n K3 gives; they
//   differ only in the order the tensor cores sum in. Each item (a column
//   tile's chunk of 32 of D) stages the tile's columns and the block's 32
//   rows, gathered through perm by cp.async, into a ring of two buffers,
//   one item ahead, with the tile's keys on its first chunk; all
//   zero-filled past N and past D (D % 8 != 0 included). So shared memory
//   (28 KB) does not grow with D, and any D >= 1 runs (the DeepLab family's
//   pixel contrast: D = 320 to 2048). The first design held the rows'
//   whole D (266 KB at D = 2048, more than a block has); at D = 128 on an
//   H100 it was 1-4 % faster (PERF.md, K4). Rows are 4 mod 32 floats
//   apart, so fragment loads are free of bank conflicts. A warp holds 16
//   rows x 32 columns.
// - Epilogue: lhat = (l - m_i) * (1 / n_i) and lhat - __logf(__expf(lhat)
//   + s_i), kept on positives by a select; |lhat| <= 1 there. c is an
//   exact integer count. Each lane sums its columns tile by tile, the 4
//   lanes of a row by shuffles (xor 1, then xor 2), then the block's two
//   column warps in order: one partial a (row, block) into scratch.
// - Reduce (reduce_kernel): each row's 4 partials in block order, written
//   to the caller's row order (0 for an invalid row). No atomics: two calls
//   on the same inputs give bitwise-equal outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;                   // sorted rows a block takes
constexpr int COLS = 64;                   // columns of a tile
constexpr int SPLIT = 4;                   // blocks a row tile: every 4th column tile each
constexpr int THREADS = 128;
constexpr int WARP_M = 16, WARP_N = 32;    // logits a warp holds
constexpr int NT = WARP_N / 8;             // mma tiles a warp, along columns
constexpr int KC = 32;                     // D a column buffer stages
constexpr int LDS = KC + 4;                // staged column stride, floats
constexpr long long INVALID_KEY = 1LL << 40;
constexpr int LAYOUT_ROWS = 32;            // rows a layout block places, one a lane
constexpr int LAYOUT_THREADS = 256;        // its warps split the columns
constexpr int LAYOUT_CHUNK = 2048;         // composite keys it stages at a time
constexpr int REDUCE_THREADS = 256;

static_assert(ROWS == 32, "one lane a row of the tile");
static_assert((ROWS / WARP_M) * (COLS / WARP_N) * 32 == THREADS, "the block's warp grid");

struct Shared {
  float zc[2][COLS * LDS];                // [buffer] a column chunk
  float zr[2][ROWS * LDS];                // [buffer] the rows' chunk
  long long ckey[2][COLS];                // [tile parity] its keys
  float rm[ROWS], rrn[ROWS], rs[ROWS];    // the rows' m, 1 / n, s
  float red_q[2][ROWS];                   // [column warp] a row's partial
  int red_c[2][ROWS];
  int range[2];                           // the row tile's columns [begin, end)
};

static_assert(sizeof(Shared) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
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

// The first index in [lo, hi) whose sorted key is >= target, or hi, by one
// warp: each round probes 32 evenly spaced keys and keeps the gap between
// the last probe below the target and the first at or above it.
__device__ int warp_lower_bound(const long long* __restrict__ keys, long long target, int lo,
                                int hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool ge = p >= hi || __ldg(keys + p) >= target;
    const unsigned ball = __ballot_sync(0xffffffffu, ge);
    if (ball == 0u) {            // every probe is below the target
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ball) - 1;
    if (f == 0) return lo;
    hi = min(lo + f * step, hi);
    lo += (f - 1) * step + 1;
  }
  return lo;
}

// Stages D [k0, k0 + KC) of the sorted rows [first, first + NR) into dst
// (stride LDS); zeros past N and past D.
template <int NR>
__device__ __forceinline__ void stage_chunk(float* dst, const float* __restrict__ z,
                                            const long long* __restrict__ perm, int N, int D,
                                            int first, int k0) {
  if ((D & 3) == 0) {
    constexpr int QUADS = KC / 4;
    for (int idx = threadIdx.x; idx < NR * QUADS; idx += THREADS) {
      const int r = idx / QUADS, q = idx % QUADS;
      const int j = first + r, k = k0 + 4 * q;
      const bool ok = j < N && k < D;
      cp_async16(dst + r * LDS + 4 * q, ok ? z + (size_t)perm[j] * D + k : z, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < NR * KC; idx += THREADS) {
      const int r = idx / KC, kk = idx % KC;
      const int j = first + r, k = k0 + kk;
      const bool ok = j < N && k < D;
      cp_async4(dst + r * LDS + kk, ok ? z + (size_t)perm[j] * D + k : z, ok);
    }
  }
}

// Stages D [k0, k0 + KC) of the sorted columns [c0, c0 + COLS) into buffer
// buf (and, on a tile's first chunk, their keys into parity par); zeros
// past N and past D. A key past N is 0: the epilogue masks it.
__device__ __forceinline__ void stage_cols(Shared& sm, int buf, int par, bool keys_too,
                                           const float* __restrict__ z,
                                           const long long* __restrict__ perm,
                                           const long long* __restrict__ keys, int N, int D,
                                           int c0, int k0) {
  stage_chunk<COLS>(sm.zc[buf], z, perm, N, D, c0, k0);
  if (keys_too && threadIdx.x < COLS) {
    const int j = c0 + threadIdx.x;
    cp_async8(&sm.ckey[par][threadIdx.x], j < N ? keys + j : keys, j < N);
  }
}

// Row i's place in a stable sort by key: (key', i) with key' = label ^ 2^31
// as unsigned (order-preserving) for a valid row, 2^32 for an invalid one;
// unique, as i < 2^31.
__device__ __forceinline__ unsigned long long sort_place_key(
    const int* __restrict__ labels, const unsigned char* __restrict__ valid, int i) {
  const unsigned long long k =
      valid[i] ? (unsigned long long)((unsigned)labels[i] ^ 0x80000000u) : (1ull << 32);
  return (k << 31) | (unsigned long long)(unsigned)i;
}

// keys_out[p] and perm_out[p] for each row i at its place p = #{j : (key_j,
// j) < (key_i, i)}; the block's 8 warps count against 1/8 of each staged
// chunk each, and their counts add in warp order.
__global__ void __launch_bounds__(LAYOUT_THREADS)
layout_kernel(const int* __restrict__ labels, const unsigned char* __restrict__ valid, int N,
              long long* __restrict__ keys_out, long long* __restrict__ perm_out) {
  __shared__ unsigned long long chunk[LAYOUT_CHUNK];
  __shared__ int part[LAYOUT_THREADS / 32][LAYOUT_ROWS];
  constexpr int SLICE = LAYOUT_CHUNK / (LAYOUT_THREADS / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * LAYOUT_ROWS + lane;
  const unsigned long long ki = i < N ? sort_place_key(labels, valid, i) : ~0ull;
  int cnt = 0;
  for (int c0 = 0; c0 < N; c0 += LAYOUT_CHUNK) {
    __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < LAYOUT_CHUNK; t += LAYOUT_THREADS)
      chunk[t] = c0 + t < N ? sort_place_key(labels, valid, c0 + t) : ~0ull;
    __syncthreads();
    const unsigned long long* slice = chunk + warp * SLICE;
#pragma unroll 8
    for (int t = 0; t < SLICE; ++t) cnt += slice[t] < ki ? 1 : 0;
  }
  part[warp][lane] = cnt;
  __syncthreads();
  if (warp == 0 && i < N) {
    int p = 0;
#pragma unroll
    for (int w = 0; w < LAYOUT_THREADS / 32; ++w) p += part[w][lane];
    keys_out[p] = valid[i] ? (long long)labels[i] : INVALID_KEY;
    perm_out[p] = i;
  }
}

// Block (row tile b, split sp): the partial q and c of the tile's 32 sorted
// rows over the column tiles u = sp, sp + SPLIT, ... of its range.
// Accumulator element e of mma tile ni is row g + 8 (e >> 1) of the warp's
// 16 and column 8 ni + 2 t + (e & 1) of its 32.
__global__ void __launch_bounds__(THREADS, 4)
pos_sweep_kernel(const float* __restrict__ z, const long long* __restrict__ perm,
                 const long long* __restrict__ keys, const float* __restrict__ m_in,
                 const float* __restrict__ n_in, const float* __restrict__ s_in, int N, int D,
                 float inv_temp, float* __restrict__ part) {
  __shared__ __align__(16) Shared sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sp = blockIdx.x % SPLIT;
  const int r0 = (blockIdx.x / SPLIT) * ROWS;

  // 1. the tile's valid rows, a prefix (invalid keys sort last); every warp
  //    holds the tile's keys, one a lane. A tile with none has no partials:
  //    the reduce gives its rows 0.
  const long long k_lane = r0 + lane < N ? keys[r0 + lane] : INVALID_KEY;
  const unsigned valid_rows = __ballot_sync(0xffffffffu, k_lane < INVALID_KEY);
  if (valid_rows == 0u) return;
  const int n_valid = __popc(valid_rows);

  // 2. the column range and the rows' stats
  if (warp == 0) {
    const long long first = __shfl_sync(0xffffffffu, k_lane, 0);
    const int b = warp_lower_bound(keys, first, 0, r0);
    if (lane == 0) sm.range[0] = b;
  } else if (warp == 1) {
    const long long last = __shfl_sync(0xffffffffu, k_lane, n_valid - 1);
    const int e = warp_lower_bound(keys, last + 1, r0 + n_valid, N);
    if (lane == 0) sm.range[1] = e;
  } else if (warp == 2) {
    const int i = r0 + lane;
    const bool in = i < N;
    const long long o = in ? perm[i] : 0;
    sm.rm[lane] = in ? m_in[o] : 0.f;
    sm.rrn[lane] = in ? 1.f / n_in[o] : 0.f;
    sm.rs[lane] = in ? s_in[o] : 0.f;
  }
  __syncthreads();

  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  long long rkey[2];
  bool rok[2];
  int ri[2];
  float rm[2], rrn[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * WARP_M + g + 8 * h;
    rkey[h] = __shfl_sync(0xffffffffu, k_lane, r);
    rok[h] = r < n_valid;
    ri[h] = r0 + r;
    rm[h] = sm.rm[r];
    rrn[h] = sm.rrn[r];
    rs[h] = sm.rs[r];
  }

  // 3. the block's column tiles: begin + (sp + SPLIT * u) * COLS for u = 0,
  //    1, ...; each in nchunks chunks of D (items), its columns and the
  //    block's rows staged one item ahead
  const int begin = sm.range[0], end = sm.range[1];
  const int ntiles = (end - begin + COLS - 1) / COLS;
  const int my_tiles = ntiles > sp ? (ntiles - sp + SPLIT - 1) / SPLIT : 0;
  const int nchunks = (D + KC - 1) / KC;
  const int items = my_tiles * nchunks;
  float q[2] = {0.f, 0.f};
  int c[2] = {0, 0};
  float acc[NT][4];

  if (items > 0) {
    stage_cols(sm, 0, 0, true, z, perm, keys, N, D, begin + sp * COLS, 0);
    stage_chunk<ROWS>(sm.zr[0], z, perm, N, D, r0, 0);
  }
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    const int u = it / nchunks, ch = it % nchunks, buf = it & 1;
    const int c0 = begin + (sp + SPLIT * u) * COLS;
    if (it + 1 < items) {
      const int u1 = (it + 1) / nchunks, ch1 = (it + 1) % nchunks;
      stage_cols(sm, buf ^ 1, u1 & 1, ch1 == 0, z, perm, keys, N, D,
                 begin + (sp + SPLIT * u1) * COLS, ch1 * KC);
      stage_chunk<ROWS>(sm.zr[buf ^ 1], z, perm, N, D, r0, ch1 * KC);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    if (ch == 0) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    }
    const float* A = sm.zr[buf] + wm * WARP_M * LDS;
    const float* B = sm.zc[buf] + wn * WARP_N * LDS;
    const int ksteps = min(KC / 8, (D - ch * KC + 7) / 8);
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks < ksteps) {
        const int k = 8 * ks + t;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const float* bp = B + (ni * 8 + g) * LDS + k;
          split_tf32(bp[0], bh[ni][0], bl[ni][0]);
          split_tf32(bp[4], bh[ni][1], bl[ni][1]);
        }
        const float* ap = A + g * LDS + k;
        uint32_t ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * LDS], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * LDS + 4], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          mma_tf32(acc[ni], al, bh[ni]);
          mma_tf32(acc[ni], ah, bl[ni]);
          mma_tf32(acc[ni], ah, bh[ni]);
        }
      }
    }

    if (ch == nchunks - 1) {  // the tile's positives
      const long long* ck = sm.ckey[u & 1];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = wn * WARP_N + ni * 8 + 2 * t + b;
          const int j = c0 + col;
          const long long kj = ck[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // without a branch: every lane the same code
            const bool pos = rok[h] && j < N && kj == rkey[h] && j != ri[h];
            const float lh = (acc[ni][2 * h + b] * inv_temp - rm[h]) * rrn[h];
            const float term = lh - __logf(__expf(lh) + rs[h]);
            q[h] += pos ? term : 0.f;
            c[h] += pos ? 1 : 0;
          }
        }
    }
    __syncthreads();  // the buffer is refilled two items on
  }

  // 4. a row's partial: its 4 lanes, then the two column warps in order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q[h] += __shfl_xor_sync(0xffffffffu, q[h], 1);
    q[h] += __shfl_xor_sync(0xffffffffu, q[h], 2);
    c[h] += __shfl_xor_sync(0xffffffffu, c[h], 1);
    c[h] += __shfl_xor_sync(0xffffffffu, c[h], 2);
    if (t == 0) {
      const int r = wm * WARP_M + g + 8 * h;
      sm.red_q[wn][r] = q[h];
      sm.red_c[wn][r] = c[h];
    }
  }
  __syncthreads();
  if (tid < ROWS && r0 + tid < N) {
    part[(size_t)sp * N + r0 + tid] = sm.red_q[0][tid] + sm.red_q[1][tid];
    part[(size_t)(SPLIT + sp) * N + r0 + tid] = (float)(sm.red_c[0][tid] + sm.red_c[1][tid]);
  }
}

// q and c of each sorted row, its SPLIT partials summed in split order (0
// for an invalid row, whose tile may have written none), to the caller's
// row order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const float* __restrict__ part, const long long* __restrict__ perm,
              const long long* __restrict__ keys, int N, float* __restrict__ q_out,
              float* __restrict__ c_out) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= N) return;
  float q = 0.f, c = 0.f;
  if (keys[i] < INVALID_KEY) {
#pragma unroll
    for (int sp = 0; sp < SPLIT; ++sp) {
      q += part[(size_t)sp * N + i];
      c += part[(size_t)(SPLIT + sp) * N + i];
    }
  }
  const long long o = perm[i];
  q_out[o] = q;
  c_out[o] = c;
}

}  // namespace

extern "C" {

// K4's layout: int32 labels and 0/1 uint8 validity (N,) -> the int64 sorted
// keys (label, or 2^40 for an invalid row) and perm (N,), as a stable sort
// gives them. All contiguous on the device. Returns a cudaError_t code: 0
// when the launch was accepted.
int dcss_pos_sweep_layout(const void* labels, const void* valid, int N, void* keys, void* perm,
                          void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + LAYOUT_ROWS - 1) / LAYOUT_ROWS);
  layout_kernel<<<blocks, LAYOUT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), static_cast<const unsigned char*>(valid), N,
      static_cast<long long*>(keys), static_cast<long long*>(perm));
  return (int)cudaGetLastError();
}

// K4 over z (N, D) f32, 16-byte aligned, given the layout step's int64
// perm and sorted keys (label, or 2^40 for an invalid row; ascending) and
// the (N,) f32 row stats m, n, s of the caller's rows: the sweep, then the
// reduce of its partials (scratch: 2 * 4 * N f32) into q and c (N,) f32 in
// the caller's row order. All contiguous on the device. Returns a
// cudaError_t code: 0 when both launches were accepted.
int dcss_pos_sweep(const void* z, const void* perm, const void* keys, const void* m,
                   const void* n, const void* s, int N, int D, float inv_temp, void* scratch,
                   void* q, void* c, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((N + ROWS - 1) / ROWS * SPLIT);
  pos_sweep_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const float*>(z), static_cast<const long long*>(perm),
      static_cast<const long long*>(keys), static_cast<const float*>(m),
      static_cast<const float*>(n), static_cast<const float*>(s), N, D, inv_temp,
      static_cast<float*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((N + REDUCE_THREADS - 1) / REDUCE_THREADS), REDUCE_THREADS, 0,
                  st>>>(static_cast<const float*>(scratch),
                        static_cast<const long long*>(perm),
                        static_cast<const long long*>(keys), N, static_cast<float*>(q),
                        static_cast<float*>(c));
  return (int)cudaGetLastError();
}

const char* dcss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
