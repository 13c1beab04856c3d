// K1: f32 sum-scatter of rows into a table, for Hopper (sm_90a).
//
// Replaces dregnerf_tpu/ops/pallas_scatter.py::bucketed_scatter_add (the
// Pallas kernel `_bucketed_kernel`): out[idx[i], :] += src[i, :], with out
// a fresh zero table allocated by the caller. It is the table-gradient
// backward of every packed-grid encoder level (grad_accum="pallas").
//
// What bounds it on the H100: memory traffic. Per call it reads
// N * (4 + 4W) bytes of idx and src, does N * W f32 read-modify-writes in
// the table (resolved in L2 by the atomic units), and the caller zeroes
// table_rows * 4W bytes. The encoder tables of levels 1-3 (2^19 rows of
// 64 floats, 128 MB each) do not fit in the 50 MB L2, so scattered atomics
// into them miss L2 and go to HBM in 32-byte sectors.
//
// Design: the TPU kernel sorted rows by table shard and accumulated each
// shard in VMEM, because a TPU scatter is a serial row loop. Hopper has
// f32 atomics in L2, so no sort is needed: one thread per (row, group of
// 4 floats) loads a float4 of src (coalesced, 16 bytes a thread) and adds
// it to the table with one vector atomic (`atomicAdd` on float4, sm_90 and
// CUDA 12.1 or newer). Rows whose
// index lies outside [0, table_rows) are skipped. Summation order varies
// from run to run (atomics), so results agree with a sequential sum to
// f32 rounding, not bit for bit.
//
// Later work (not here): sort by slot or aggregate equal slots within a
// warp (marched samples are ray-coherent, so coarse levels repeat slots),
// or fuse the scatter into the 8-corner vertex gradient directly.
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12010
#error "scatter_add.cu needs CUDA 12.1 or newer (float4 atomicAdd on sm_90)"
#endif

__global__ void scatter_add_rows_f32x4(const int32_t* __restrict__ idx,
                                       const float4* __restrict__ src,
                                       float* __restrict__ out,
                                       int64_t n_rows, int groups,
                                       int64_t table_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * groups) return;
  const int64_t row = t / groups;
  const int g = (int)(t - row * groups);
  const int32_t slot = __ldg(idx + row);
  if (slot < 0 || (int64_t)slot >= table_rows) return;
  const float4 v = src[t];
  float* dst = out + ((int64_t)slot * groups + g) * 4;
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

extern "C" {

// idx: [n_rows] int32; src: [n_rows, width] f32 (width % 4 == 0, 16-byte
// aligned); out: [table_rows, width] f32, zeroed by the caller. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int scatter_add_f32(const void* idx, const void* src, void* out,
                    long long n_rows, int width, long long table_rows,
                    void* stream) {
  const int groups = width / 4;
  const long long total = n_rows * (long long)groups;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  scatter_add_rows_f32x4<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float4*)src, (float*)out, n_rows, groups,
      table_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
