// K6: the multiresolution xor-hash grid encoder (Instant-NGP's), forward
// and table-gradient backward, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package computes this encoder in XLA
// (dregnerf_tpu/ops/hash_encoding.py). Its plain PyTorch version
// (ops/hash_encoding.py::hash_encode_plain) builds [N, L, 8] int64 rows and
// f32 weights, gathers [N, L, 8, F] features and leaves the backward to
// autograd's sort-based index scatter; K6 does each direction in one launch.
//
//   hash_grid_fwd_f32: out[p, l, :] = sum_c w_c(p, l) * table[row_c(p, l), :]
//   hash_grid_bwd_f32: grad[row_c(p, l), :] += w_c(p, l) * dout[p, l, :]
//
// for the 8 corners c of every (point p, level l), F = 2 features. A
// corner's row equals hash_corners' bit for bit: pos = x * scale + 0.5
// rounded after the product and after the sum (no fused multiply-add),
// corners clamped to [0, res - 1], dense levels (res^3 <= T) indexed
// x + y*res + z*res^2, the others hashed (x * 1 ^ y * 2654435761 ^
// z * 805459861 in uint32) and masked to T - 1, plus the level's offset
// l * T. The level scales, resolutions and dense flags are the caller's
// (HashGridConfig), passed in each launch. Weights are products of frac or
// 1 - frac over the axes, x first. Everything is f32.
//
// What bounds it on the H100: the corner rows, 8 random 8-byte reads (or
// atomic adds) per (point, level), 2^18 * 16 * 8 = 33.5 M a training step,
// the same number of L2 sector accesses at fine levels, where each sample
// falls in a cell of its own and the hash scatters neighbouring cells over
// the level's 4 MB. Streamed bytes (positions, the encoding, its gradient)
// are a small part. In the backward, coarse levels add the contention of
// atomics: level 0 has 4,096 rows and every sample adds to 8 of them.
//
// Design: a block is 32 consecutive points times the L levels (blockDim
// (32, L)), so each warp holds 32 consecutive points of one level. Marched
// samples come ray by ray, so at coarse levels neighbouring lanes share
// corners: their reads of one row coalesce into one request, and in the
// backward each corner's adds are summed over each run of lanes with the
// same row (a segmented sum with warp shuffles, skipped when no two
// neighbours share a row), so one atomic per run reaches L2 (`atomicAdd`
// on float2, sm_90 and CUDA 12.1 or newer). The encoding and its gradient
// pass through shared memory, so that a block reads and writes its
// 32 * L * 2 floats as one contiguous, coalesced run. Summation order in
// the backward varies from run to run (atomics): the table gradient agrees
// with a sequential sum to f32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12010
#error "hash_grid.cu needs CUDA 12.1 or newer (float2 atomicAdd on sm_90)"
#endif

#define MAX_LEVELS 32
#define FULL_MASK 0xffffffffu

struct Levels {
  float scale[MAX_LEVELS];
  unsigned int res[MAX_LEVELS];
  unsigned int dense[MAX_LEVELS];
};

// The 8 corner rows (within the level) and weights of point x at one level.
__device__ __forceinline__ void corners(const float* __restrict__ x, int64_t p,
                                        float scale, unsigned int res,
                                        bool dense, unsigned int mask,
                                        unsigned int rows[8], float w[8]) {
  unsigned int lo[3], hi[3];
  float frac[3];
  const float top = (float)(res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(__ldg(x + 3 * p + d), scale), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    lo[d] = (unsigned int)fminf(fmaxf(fl, 0.f), top);
    hi[d] = (unsigned int)fminf(fmaxf(__fadd_rn(fl, 1.f), 0.f), top);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool bx = c & 4, by = c & 2, bz = c & 1;
    const unsigned int cx = bx ? hi[0] : lo[0];
    const unsigned int cy = by ? hi[1] : lo[1];
    const unsigned int cz = bz ? hi[2] : lo[2];
    rows[c] = dense ? cx + cy * res + cz * res * res
                    : ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) &
                          mask;
    const float wx = bx ? frac[0] : __fsub_rn(1.f, frac[0]);
    const float wy = by ? frac[1] : __fsub_rn(1.f, frac[1]);
    const float wz = bz ? frac[2] : __fsub_rn(1.f, frac[2]);
    w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
}

__global__ void __launch_bounds__(1024)
    hash_grid_fwd(const float* __restrict__ x, const float2* __restrict__ table,
                  float2* __restrict__ out, int64_t n, int log2_t, Levels lv) {
  extern __shared__ float2 tile[];  // [32][L + 1]
  const int lane = threadIdx.x, l = threadIdx.y, L = blockDim.y;
  const int64_t p0 = (int64_t)blockIdx.x * 32, p = p0 + lane;
  float2 acc = make_float2(0.f, 0.f);
  if (p < n) {
    unsigned int rows[8];
    float w[8];
    corners(x, p, lv.scale[l], lv.res[l], lv.dense[l] != 0,
            (1u << log2_t) - 1u, rows, w);
    const float2* tab = table + ((int64_t)l << log2_t);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 v = __ldg(tab + rows[c]);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], v.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], v.y));
    }
  }
  tile[lane * (L + 1) + l] = acc;
  __syncthreads();
  const int64_t count = (n - p0 < 32 ? n - p0 : 32) * L;
  for (int i = l * 32 + lane; i < count; i += 32 * L) {
    out[p0 * L + i] = tile[(i / L) * (L + 1) + i % L];
  }
}

__global__ void __launch_bounds__(1024)
    hash_grid_bwd(const float* __restrict__ x, const float2* __restrict__ dout,
                  float2* __restrict__ grad, int64_t n, int log2_t, Levels lv) {
  extern __shared__ float2 tile[];  // [32][L + 1]
  const int lane = threadIdx.x, l = threadIdx.y, L = blockDim.y;
  const int64_t p0 = (int64_t)blockIdx.x * 32, p = p0 + lane;
  const int64_t count = (n - p0 < 32 ? n - p0 : 32) * L;
  for (int i = l * 32 + lane; i < count; i += 32 * L) {
    tile[(i / L) * (L + 1) + i % L] = dout[p0 * L + i];
  }
  __syncthreads();
  const bool valid = p < n;
  unsigned int rows[8];
  float w[8];
  if (valid) {
    corners(x, p, lv.scale[l], lv.res[l], lv.dense[l] != 0,
            (1u << log2_t) - 1u, rows, w);
  }
  const float2 g = valid ? tile[lane * (L + 1) + l] : make_float2(0.f, 0.f);
  float2* gl = grad + ((int64_t)l << log2_t);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // a lane past n takes a row no corner has (rows are below 2^31)
    const unsigned int r = valid ? rows[c] : FULL_MASK;
    float vx = valid ? __fmul_rn(w[c], g.x) : 0.f;
    float vy = valid ? __fmul_rn(w[c], g.y) : 0.f;
    const unsigned int next = __shfl_down_sync(FULL_MASK, r, 1);
    const unsigned int tails =
        __ballot_sync(FULL_MASK, lane == 31 || next != r);
    bool head = true;
    if (tails != FULL_MASK) {  // some run of equal rows: sum it into its head
      const unsigned int prev = __shfl_up_sync(FULL_MASK, r, 1);
      head = lane == 0 || prev != r;
      const int end = __ffs(tails & (FULL_MASK << lane)) - 1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ox = __shfl_down_sync(FULL_MASK, vx, off);
        const float oy = __shfl_down_sync(FULL_MASK, vy, off);
        if (lane + off <= end) {
          vx += ox;
          vy += oy;
        }
      }
    }
    if (valid && head) atomicAdd(gl + r, make_float2(vx, vy));
  }
}

static int fill_levels(Levels* lv, int n_levels, const float* scales,
                       const int32_t* res, const int32_t* dense) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_levels; ++l) {
    lv->scale[l] = scales[l];
    lv->res[l] = (unsigned int)res[l];
    lv->dense[l] = (unsigned int)dense[l];
  }
  return 0;
}

extern "C" {

// x: [n, 3] f32; table: [n_levels << log2_t, 2] f32; out: [n, n_levels, 2]
// f32. scales [n_levels] f32, res and dense [n_levels] int32 are host
// arrays (HashGridConfig's). Launches on `stream` and returns the first
// CUDA error (0 on success).
int hash_grid_fwd_f32(const void* x, const void* table, void* out, long long n,
                      int n_levels, int log2_t, const void* scales,
                      const void* res, const void* dense, void* stream) {
  Levels lv;
  const int err = fill_levels(&lv, n_levels, (const float*)scales,
                              (const int32_t*)res, (const int32_t*)dense);
  if (err || n <= 0) return err;
  const dim3 block(32, n_levels);
  const long long blocks = (n + 31) / 32;
  const size_t smem = 32 * (n_levels + 1) * sizeof(float2);
  hash_grid_fwd<<<(unsigned int)blocks, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (float2*)out, n, log2_t, lv);
  return (int)cudaGetLastError();
}

// dout: [n, n_levels, 2] f32; grad: [n_levels << log2_t, 2] f32, added
// into (the caller zeroes it). The rest as in hash_grid_fwd_f32.
int hash_grid_bwd_f32(const void* x, const void* dout, void* grad, long long n,
                      int n_levels, int log2_t, const void* scales,
                      const void* res, const void* dense, void* stream) {
  Levels lv;
  const int err = fill_levels(&lv, n_levels, (const float*)scales,
                              (const int32_t*)res, (const int32_t*)dense);
  if (err || n <= 0) return err;
  const dim3 block(32, n_levels);
  const long long blocks = (n + 31) / 32;
  const size_t smem = 32 * (n_levels + 1) * sizeof(float2);
  hash_grid_bwd<<<(unsigned int)blocks, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)dout, (float2*)grad, n, log2_t, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
