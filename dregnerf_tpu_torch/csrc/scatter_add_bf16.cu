// K1p: bf16-accumulating sum-scatter of rows into a table, for Hopper (sm_90a).
//
// Replaces scripts/perf/probe_pallas_scatter.py::pallas_scatter_add (the
// Pallas kernel `_kernel`): out[idx[i], :] += bf16(src[i, :]) with a bf16
// add, out a fresh bf16 zero table allocated by the caller. It is the
// table-gradient backward of every packed-grid encoder level under
// grad_accum "bf16" and "sorted_bf16", and the scatter of the run sums at
// run-length-compressed levels under "bf16" (ops/packed_grid.py).
//
// What bounds it on the H100: memory traffic. Per call it reads
// N * (4 + 4W) bytes of idx and src, does N * W / 2 bf16x2 read-modify-
// writes in the table (resolved in L2 by the atomic units), and the caller
// zeroes table_rows * 2W bytes. The 2^19-row tables of levels 1-3 are
// 64 MB in bf16, more than the 50 MB L2, so scattered atomics into them
// miss L2.
//
// Design: the TPU kernel kept a table shard in VMEM and added rows one at
// a time, because a TPU scatter is a serial row loop. Hopper adds bf16
// pairs atomically in L2: one thread per (row, pair of features) loads a
// float2 of src, rounds it to bf16 with `__float22bfloat162_rn` (as JAX's
// astype), and adds it with one `atomicAdd` on `__nv_bfloat162`. Each add
// rounds the exact sum to bf16 once, as the serial bf16 scatter does, but
// the atomics take the adds of one slot in a varying order, so the result
// agrees with the serial one within the rounding of each add, not bit for
// bit. Rows whose index lies outside [0, table_rows) are skipped (the
// run-length backward pads its unused runs with such an index).
//
// Alternative rows: as in scatter_add.cu, a second row set and a one-byte
// device flag that picks it, so the run-length backward chooses between
// its run sums and the direct scatter on the device (JAX's `lax.cond`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void scatter_add_rows_bf16x2(const int32_t* __restrict__ idx,
                                        const float2* __restrict__ src,
                                        int64_t n_rows,
                                        const int32_t* __restrict__ alt_idx,
                                        const float2* __restrict__ alt_src,
                                        int64_t alt_rows,
                                        const uint8_t* __restrict__ take_alt,
                                        __nv_bfloat162* __restrict__ out,
                                        int pairs, int64_t table_rows) {
  if (take_alt != nullptr && *take_alt) {
    idx = alt_idx;
    src = alt_src;
    n_rows = alt_rows;
  }
  const int64_t total = n_rows * pairs;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / pairs;
    const int p = (int)(t - row * pairs);
    const int32_t slot = __ldg(idx + row);
    if (slot < 0 || (int64_t)slot >= table_rows) continue;
    const __nv_bfloat162 v = __float22bfloat162_rn(src[t]);
    atomicAdd(out + (int64_t)slot * pairs + p, v);
  }
}

extern "C" {

// idx: [n_rows] int32; src: [n_rows, width] f32 (width even, 8-byte
// aligned); alt_idx, alt_src, alt_rows: the alternative rows, alike, and
// take_alt: a device byte that picks them when nonzero (all three may be
// null and 0 when there is no alternative); out: [table_rows, width]
// bf16, zeroed by the caller. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int scatter_add_bf16(const void* idx, const void* src, long long n_rows,
                     const void* alt_idx, const void* alt_src,
                     long long alt_rows, const void* take_alt, void* out,
                     int width, long long table_rows, void* stream) {
  const int pairs = width / 2;
  if (take_alt == nullptr) alt_rows = 0;
  const long long rows = n_rows > 0 ? n_rows : alt_rows;
  const long long total = rows * (long long)pairs;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  scatter_add_rows_bf16x2<<<(unsigned int)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float2*)src, n_rows,
      (const int32_t*)alt_idx, (const float2*)alt_src, alt_rows,
      (const uint8_t*)take_alt, (__nv_bfloat162*)out, pairs, table_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
