// K2: the packed-grid encoder over its vertex table in place, forward and
// the two ends of the table-gradient backward, for Hopper (sm_90a).
//
// The packed layout (ops/packed_grid.py) reads the 8 corners of a point's
// cell at level l from one packed row P_l[slot] = concat_c V_l[(slot + o_c)
// mod T_l], o_c = dx * res^2 + dy * res + dz for the corners (dx, dy, dz)
// with dz fastest. The TPU builds P_l (8 rolls of V_l) because its gather
// engine pays per row; K2 reads the same 8 rows of V in place, so no packed
// table is built on the card. It replaces, on the card, the packed path's
// `pack_table` rolls and `cat`, the K2p row gathers and the trilinear
// einsum (dregnerf_tpu/ops/packed_grid.py::pack_table and packed_encode
// over scripts/perf/probe_pallas_gather.py's gather):
//
//   packed_grid_fwd:    out[p, l, :] = sum_c w_c(p, l) * V_l[(slot + o_c) mod T_l, :]
//   packed_grid_rows:   slots[l, p] = slot(p, l); rows[l, p, c, :] = w_c(p, l) * dout[p, l, :]
//   packed_grid_unpack: dV_l[s, :] = sum_c G_l[(s - o_c) mod T_l, c, :]
//
// Between the last two the caller sums each level's rows into G_l [T_l, 8F]
// with the accumulator its grad_accum names (K1, K1p or the run-length
// backward), exactly as it summed the packed table's gradient before; the
// unpack is the transpose of pack_table's placement.
//
// The cell and slot are packed_encode's: x clipped to [0, 1]; pos = x * scale
// + 0.5 rounded after the product and after the sum (no fused multiply-add);
// the floor as int32, clamped to [0, res - 2]; lin = x * res^2 + y * res + z
// in int64, masked to 2^k - 1 (which leaves a dense level's lin < res^3 <=
// 2^k as it is). Weights are products of frac or 1 - frac over the axes, x
// first; the blend and the unpack sum the 8 corners in order in f32.
//
// What bounds it on the H100: the forward's 8 row reads of 4F bytes per
// (point, level), 8.4 M a training step at L4F8, random at fine levels (the
// V of L4F8 is 50 MB, about the L2); the bytes it must move are the
// positions and the encoding, N * (12 + 4LF). The rows pass writes
// N * L * 32F bytes (268 MB at L4F8 and 2^18 points), the unpack reads each
// level's G once (32F bytes a table row) and writes dV.
//
// Design: one thread per (point, level) in the forward, a block of 32
// points' L levels with the level fastest, so a warp writes whole encoding
// rows and at coarse levels neighbouring points' reads of one row coalesce;
// rows of F floats move as float4 (F % 4 == 0) or float2. The rows pass has
// one thread per (point, corner) of a level (blockIdx.y), so a warp writes 4
// points' 8F-float rows as one contiguous kilobyte. The unpack has one
// thread per row of dV: for each corner a warp reads 32 consecutive rows'
// 4F-byte slice, whole sectors. No atomics: the results do not depend on
// the launch. Level constants come by value in the launch's parameters,
// from host arrays (PackedGridConfig's), so a CUDA graph records them.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32

struct Levels {
  float scale[MAX_LEVELS];
  int max_cell[MAX_LEVELS];           // res - 2
  long long res[MAX_LEVELS];
  long long rows[MAX_LEVELS];         // T_l
  long long first[MAX_LEVELS + 1];    // the level's first row in V
  long long corner[MAX_LEVELS][8];    // o_c mod T_l
  long long mask;                     // 2^k - 1
};

struct Grads {
  const float* level[MAX_LEVELS];     // G_l [T_l, 8F]
};

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = q.x; v[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) v[i] = __ldg(p + i);
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) p[i] = v[i];
  }
}

// The slot of point p's cell at level l, and the fractions of its 3 axes.
__device__ __forceinline__ long long cell_slot(const float* __restrict__ x, int64_t p,
                                               const Levels& lv, int l, float frac[3]) {
  long long cell[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float u = fminf(fmaxf(__ldg(x + 3 * p + d), 0.f), 1.f);
    const float pos = __fadd_rn(__fmul_rn(u, lv.scale[l]), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    cell[d] = min(max((int)fl, 0), lv.max_cell[l]);
  }
  const long long res = lv.res[l];
  return (cell[0] * res * res + cell[1] * res + cell[2]) & lv.mask;
}

// Corner c's trilinear weight: c = dx * 4 + dy * 2 + dz.
__device__ __forceinline__ float corner_weight(int c, const float frac[3]) {
  const float wx = (c & 4) ? frac[0] : __fsub_rn(1.f, frac[0]);
  const float wy = (c & 2) ? frac[1] : __fsub_rn(1.f, frac[1]);
  const float wz = (c & 1) ? frac[2] : __fsub_rn(1.f, frac[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

template <int F>
__global__ void __launch_bounds__(1024)
    packed_grid_fwd(const float* __restrict__ x, const float* __restrict__ table,
                    float* __restrict__ out, int64_t n, Levels lv) {
  const int l = threadIdx.x, L = blockDim.x;
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= n) return;
  float frac[3];
  const long long slot = cell_slot(x, p, lv, l, frac);
  const long long rows = lv.rows[l];
  const float* tab = table + lv.first[l] * F;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    long long s = slot + lv.corner[l][c];
    if (s >= rows) s -= rows;
    float v[F];
    load_row<F>(tab + s * F, v);
    const float w = corner_weight(c, frac);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
  }
  store_row<F>(out + (p * L + l) * F, acc);
}

template <int F>
__global__ void __launch_bounds__(256)
    packed_grid_rows(const float* __restrict__ x, const float* __restrict__ dout,
                     int32_t* __restrict__ slots, float* __restrict__ rows, int64_t n,
                     int L, Levels lv) {
  const int l = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 8) return;
  const int64_t p = t >> 3;
  const int c = (int)(t & 7);
  float frac[3];
  const long long slot = cell_slot(x, p, lv, l, frac);
  const float w = corner_weight(c, frac);
  float g[F];
  load_row<F>(dout + (p * L + l) * F, g);
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = __fmul_rn(w, g[f]);
  store_row<F>(rows + ((int64_t)l * n + p) * (8 * F) + c * F, g);
  if (c == 0) slots[(int64_t)l * n + p] = (int32_t)slot;
}

template <int F>
__global__ void __launch_bounds__(256)
    packed_grid_unpack(Grads gl, float* __restrict__ dv, int L, Levels lv) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= lv.first[L]) return;
  int l = 0;
  while (r >= lv.first[l + 1]) ++l;
  const long long s = r - lv.first[l], rows = lv.rows[l];
  const float* G = gl.level[l];
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    long long t = s - lv.corner[l][c];
    if (t < 0) t += rows;
    float v[F];
    load_row<F>(G + t * (8 * F) + c * F, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], v[f]);
  }
  store_row<F>(dv + r * F, acc);
}

static int fill_levels(Levels* lv, int n_levels, int log2_t, const float* scales,
                       const int32_t* res, const int64_t* rows) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || log2_t < 1 || log2_t > 31) {
    return (int)cudaErrorInvalidValue;
  }
  lv->mask = (1LL << log2_t) - 1;
  lv->first[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long r = res[l], t = rows[l];
    if (r < 2 || t < 1) return (int)cudaErrorInvalidValue;
    lv->scale[l] = scales[l];
    lv->max_cell[l] = (int)(r - 2);
    lv->res[l] = r;
    lv->rows[l] = t;
    lv->first[l + 1] = lv->first[l] + t;
    for (int c = 0; c < 8; ++c) {
      lv->corner[l][c] = (((c >> 2) & 1) * r * r + ((c >> 1) & 1) * r + (c & 1)) % t;
    }
  }
  return 0;
}

#define DISPATCH_F(F_VALUE, ...)          \
  switch (F_VALUE) {                      \
    case 1: { constexpr int F = 1; __VA_ARGS__; break; }  \
    case 2: { constexpr int F = 2; __VA_ARGS__; break; }  \
    case 4: { constexpr int F = 4; __VA_ARGS__; break; }  \
    case 8: { constexpr int F = 8; __VA_ARGS__; break; }  \
    case 16: { constexpr int F = 16; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;           \
  }

extern "C" {

// x: [n, 3] f32; table (V): [sum T_l, F] f32; out: [n, n_levels, F] f32.
// scales [n_levels] f32, res [n_levels] int32 and rows (T_l) [n_levels]
// int64 are host arrays (PackedGridConfig's). Launches on `stream` and
// returns the first CUDA error (0 on success).
int packed_grid_fwd_f32(const void* x, const void* table, void* out, long long n,
                        int n_levels, int n_features, int log2_t, const void* scales,
                        const void* res, const void* rows, void* stream) {
  Levels lv;
  const int err = fill_levels(&lv, n_levels, log2_t, (const float*)scales,
                              (const int32_t*)res, (const int64_t*)rows);
  if (err || n <= 0) return err;
  const int per_block = n_levels >= 256 ? 1 : 256 / n_levels;
  const dim3 block(n_levels, per_block);
  const unsigned int blocks = (unsigned int)((n + per_block - 1) / per_block);
  DISPATCH_F(n_features, packed_grid_fwd<F><<<blocks, block, 0, (cudaStream_t)stream>>>(
                             (const float*)x, (const float*)table, (float*)out, n, lv));
  return (int)cudaGetLastError();
}

// dout: [n, n_levels, F] f32; slots: [n_levels, n] int32 and rows:
// [n_levels, n, 8F] f32, written. The rest as in packed_grid_fwd_f32.
int packed_grid_rows_f32(const void* x, const void* dout, void* slots, void* rows_out,
                         long long n, int n_levels, int n_features, int log2_t,
                         const void* scales, const void* res, const void* rows,
                         void* stream) {
  Levels lv;
  const int err = fill_levels(&lv, n_levels, log2_t, (const float*)scales,
                              (const int32_t*)res, (const int64_t*)rows);
  if (err || n <= 0) return err;
  const dim3 grid((unsigned int)((n * 8 + 255) / 256), n_levels);
  DISPATCH_F(n_features, packed_grid_rows<F><<<grid, 256, 0, (cudaStream_t)stream>>>(
                             (const float*)x, (const float*)dout, (int32_t*)slots,
                             (float*)rows_out, n, n_levels, lv));
  return (int)cudaGetLastError();
}

// grads: a host array of n_levels device pointers, level l's G_l
// [T_l, 8F] f32; dv: [sum T_l, F] f32, written. The rest as in
// packed_grid_fwd_f32.
int packed_grid_unpack_f32(const void* grads, void* dv, int n_levels, int n_features,
                           int log2_t, const void* scales, const void* res,
                           const void* rows, void* stream) {
  Levels lv;
  const int err = fill_levels(&lv, n_levels, log2_t, (const float*)scales,
                              (const int32_t*)res, (const int64_t*)rows);
  if (err) return err;
  Grads gl;
  for (int l = 0; l < n_levels; ++l) gl.level[l] = ((const float* const*)grads)[l];
  const long long total = lv.first[n_levels];
  const unsigned int blocks = (unsigned int)((total + 255) / 256);
  DISPATCH_F(n_features, packed_grid_unpack<F><<<blocks, 256, 0, (cudaStream_t)stream>>>(
                             gl, (float*)dv, n_levels, lv));
  return (int)cudaGetLastError();
}

}  // extern "C"
