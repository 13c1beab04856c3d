// K2p: row gather out[i, :] = table[idx[i], :], for Hopper (sm_90a).
//
// Replaces scripts/perf/probe_pallas_gather.py::make_gather.<gather> (the
// Pallas kernel that copies one table row per DMA, 16 in flight). It is the
// forward of every packed-grid encoder level: one [8F]-float row per
// (point, level), in training, occupancy updates, rendering and voxel
// extraction (ops/packed_grid.py).
//
// What bounds it on the H100: memory traffic, N * 4 bytes of idx, N * 4W
// bytes of table rows read and N * 4W bytes written. The 1 MB table of
// level 0 stays in the 50 MB L2; the 128 MB tables of levels 1-3 do not,
// so their rows come from HBM in 32-byte sectors (a 256-byte row is eight
// whole sectors, so no byte fetched is wasted).
//
// Design: the TPU kernel overlapped per-row DMAs because its gather engine
// has a per-row cost. On Hopper a warp's loads are coalesced: one thread
// per (row, 4 floats) reads a float4 of the row (the 16 threads of a
// 64-float row read its 256 bytes together) and writes it with one 16-byte
// store, so the output is written in full contiguous lines. `idx` goes
// through the read-only cache (`__ldg`): the 16 threads of a row read the
// same index. Callers pass slots in [0, table_rows) by construction; a
// slot outside that range writes a zero row instead of reading out of
// bounds.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_rows_f32x4(const float4* __restrict__ table,
                                  const int32_t* __restrict__ idx,
                                  float4* __restrict__ out, int64_t n_rows,
                                  int groups, int64_t table_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * groups) return;
  const int64_t row = t / groups;
  const int g = (int)(t - row * groups);
  const int32_t slot = __ldg(idx + row);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (slot >= 0 && (int64_t)slot < table_rows) {
    v = __ldg(table + (int64_t)slot * groups + g);
  }
  out[t] = v;
}

extern "C" {

// table: [table_rows, width] f32; idx: [n_rows] int32; out: [n_rows, width]
// f32 (width % 4 == 0, 16-byte aligned). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int gather_rows_f32(const void* table, const void* idx, void* out,
                    long long n_rows, int width, long long table_rows,
                    void* stream) {
  const int groups = width / 4;
  const long long total = n_rows * (long long)groups;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_rows_f32x4<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const float4*)table, (const int32_t*)idx, (float4*)out, n_rows, groups,
      table_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
