// K1: f32 sum-scatter of rows into a table, for Hopper (sm_90a).
//
// Replaces dregnerf_tpu/ops/pallas_scatter.py::bucketed_scatter_add (the
// Pallas kernel `_bucketed_kernel`): out[idx[i], :] += src[i, :], with out
// a fresh zero table allocated by the caller. It is the table-gradient
// backward of every packed-grid encoder level (grad_accum="pallas").
//
// What bounds it on the H100: memory traffic. Per call it reads
// N * (4 + 4W) bytes of idx and src, does N * W f32 read-modify-writes in
// the table (resolved in L2 by the atomic units), and zeroes
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
// Alternative rows: a caller may pass a second row set and a one-byte flag
// on the device; when the flag is nonzero the kernel scatters the second
// set instead. The run-length backward uses this in place of JAX's
// `lax.cond` between its run sums and the direct scatter, with no host
// read and no copy of either set. The grid is sized for the first set and
// strides over the second when that is longer.
//
// The C entry shares K1p's signature (scatter_add_bf16.cu), whose optional
// device row count K1 does not take: it must be null. The table is zeroed
// here, on the same stream, before the launch.
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
                                       int64_t n_rows,
                                       const int32_t* __restrict__ alt_idx,
                                       const float4* __restrict__ alt_src,
                                       int64_t alt_rows,
                                       const uint8_t* __restrict__ take_alt,
                                       float* __restrict__ out, int groups,
                                       int64_t table_rows) {
  if (take_alt != nullptr && *take_alt) {
    idx = alt_idx;
    src = alt_src;
    n_rows = alt_rows;
  }
  const int64_t total = n_rows * groups;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / groups;
    const int g = (int)(t - row * groups);
    const int32_t slot = __ldg(idx + row);
    if (slot < 0 || (int64_t)slot >= table_rows) continue;
    const float4 v = src[t];
    float* dst = out + ((int64_t)slot * groups + g) * 4;
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  }
}

extern "C" {

// idx: [n_rows] int32; src: [n_rows, width] f32 (width % 4 == 0, 16-byte
// aligned); row_count: null (cudaErrorInvalidValue otherwise); alt_idx,
// alt_src, alt_rows: the alternative rows, alike, and take_alt: a device
// byte that picks them when nonzero (all three may be null and 0 when
// there is no alternative); out: [table_rows, width] f32, zeroed here.
// Launches on `stream` and returns the first CUDA error (0 on success).
int scatter_add_f32(const void* idx, const void* src, long long n_rows,
                    const void* row_count, const void* alt_idx, const void* alt_src,
                    long long alt_rows, const void* take_alt, void* out,
                    int width, long long table_rows, void* stream) {
  if (row_count != nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)table_rows * (size_t)width * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int groups = width / 4;
  if (take_alt == nullptr) alt_rows = 0;
  const long long rows = n_rows > 0 ? n_rows : alt_rows;
  const long long total = rows * (long long)groups;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  scatter_add_rows_f32x4<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float4*)src, n_rows,
      (const int32_t*)alt_idx, (const float4*)alt_src, alt_rows,
      (const uint8_t*)take_alt, (float*)out, groups, table_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
