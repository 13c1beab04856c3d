// K1p: bf16-accumulating sum-scatter of rows into a table, for Hopper (sm_90a).
//
// Replaces scripts/perf/probe_pallas_scatter.py::pallas_scatter_add (the
// Pallas kernel `_kernel`): out[idx[i], :] += bf16(src[i, :]) with a bf16
// add, out a fresh bf16 zero table. It is the table-gradient backward of
// every packed-grid encoder level under grad_accum "bf16" and
// "sorted_bf16", and the scatter of the run sums at run-length-compressed
// levels under "bf16" (ops/packed_grid.py).
//
// What bounds it on the H100: memory traffic, and the count of atomic
// operations in L2. Per call it reads N * (4 + 4W) bytes of idx and src and
// writes table_rows * 2W bytes of table; the 2^19-row tables of levels 1-3
// are 64 MB in bf16, more than the 50 MB L2. A first version issued one
// 4-byte atomicAdd on __nv_bfloat162 per (row, feature pair), 8.4 M L2
// atomics per call at N = 2^18, W = 64, and reached 0.37 of its bytes
// bound, where K1 (scatter_add.cu), with 16-byte float4 atomics and twice
// the table bytes, reached 0.52: the atomics' count, not the bytes, held
// it back.
//
// Design: one thread owns 8 consecutive features of a row. It loads them
// with two 16-byte loads of src (streaming: src is read once, the table's
// lines are the ones worth keeping in L2), rounds them to four bf16 pairs
// with `__float22bfloat162_rn` (as JAX's astype), and adds them with ONE
// 16-byte vector reduction, `red.global.add.noftz.v4.bf16x2` (PTX ISA 8.1,
// sm_90): 2.1 M L2 operations per call instead of 8.4 M. Eight threads
// cover a 64-wide row, one 128-byte line; a warp covers 4 rows and its
// loads of src are contiguous. The reduction adds element by element, so
// every table element still gets one bf16-rounded add per source row, as
// in the serial bf16 scatter, only in another order within a slot: the
// result agrees with the serial one within the rounding of each add, not
// bit for bit. Equal slots are deliberately NOT pre-summed in f32 first:
// that rounds once per group instead of once per row, another function.
// Rows whose index lies outside [0, table_rows) are skipped (the
// run-length backward pads its unused runs with such an index).
//
// Launch: a grid-stride loop over min(ceil(work / 256), SMs x resident
// blocks per SM) blocks, the occupancy read once per device. An optional
// int64 row count on the device (the run-length backward's run count)
// bounds the rows walked, clamped to the buffer's rows, so the kernel stops
// at the real runs instead of walking every padded one, with no host read.
// The table is zeroed here, on the same stream, before the launch.
//
// Alternative rows: as in scatter_add.cu, a second row set and a one-byte
// device flag that picks it, so the run-length backward chooses between
// its run sums and the direct scatter on the device (JAX's `lax.cond`).
// The row count applies to the first set only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#if CUDART_VERSION < 12010
#error "scatter_add_bf16.cu needs CUDA 12.1 or newer (PTX ISA 8.1 vector red on sm_90)"
#endif

static constexpr int kThreads = 256;
static constexpr int kMaxDevices = 64;

static __device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(a, b));
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

// dst[0:8] += bf16(lo, hi), one 16-byte reduction in L2 (dst 16-byte aligned)
static __device__ __forceinline__ void red_add_bf16x8(__nv_bfloat16* dst, float4 lo, float4 hi) {
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
               :
               : "l"(dst), "r"(bf16x2_bits(lo.x, lo.y)), "r"(bf16x2_bits(lo.z, lo.w)),
                 "r"(bf16x2_bits(hi.x, hi.y)), "r"(bf16x2_bits(hi.z, hi.w))
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
scatter_add_rows_bf16x8(const int32_t* __restrict__ idx, const float4* __restrict__ src,
                        int64_t n_rows, const int64_t* __restrict__ row_count,
                        const int32_t* __restrict__ alt_idx,
                        const float4* __restrict__ alt_src, int64_t alt_rows,
                        const uint8_t* __restrict__ take_alt,
                        __nv_bfloat16* __restrict__ out, int octets, int64_t table_rows) {
  if (take_alt != nullptr && *take_alt) {
    idx = alt_idx;
    src = alt_src;
    n_rows = alt_rows;
  } else if (row_count != nullptr) {
    const int64_t count = *row_count;
    n_rows = count < 0 ? 0 : (count < n_rows ? count : n_rows);
  }
  const int64_t total = n_rows * octets;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / octets;
    const int32_t slot = __ldg(idx + row);
    if (slot < 0 || (int64_t)slot >= table_rows) continue;
    const float4 lo = __ldcs(src + 2 * t);
    const float4 hi = __ldcs(src + 2 * t + 1);
    red_add_bf16x8(out + ((int64_t)slot * octets + (t - row * octets)) * 8, lo, hi);
  }
}

// SMs x resident blocks of scatter_add_rows_bf16x8 per SM, on the current
// device (computed once a device)
static cudaError_t resident_blocks(long long* blocks) {
  static long long cached[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_add_rows_bf16x8,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cached[device] = *blocks;
  return cudaSuccess;
}

extern "C" {

// idx: [n_rows] int32; src: [n_rows, width] f32 (width % 8 == 0, 16-byte
// aligned); row_count: null, or a device int64 that bounds the rows of
// (idx, src) scattered (clamped to [0, n_rows]); alt_idx, alt_src,
// alt_rows: the alternative rows, alike, and take_alt: a device byte that
// picks them when nonzero (all three may be null and 0 when there is no
// alternative); out: [table_rows, width] bf16 (16-byte aligned), zeroed
// here. Launches on `stream` and returns the first CUDA error (0 on
// success).
int scatter_add_bf16(const void* idx, const void* src, long long n_rows,
                     const void* row_count, const void* alt_idx, const void* alt_src,
                     long long alt_rows, const void* take_alt, void* out, int width,
                     long long table_rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)table_rows * (size_t)width * sizeof(__nv_bfloat16), s);
  if (err != cudaSuccess) return (int)err;
  const int octets = width / 8;
  if (take_alt == nullptr) alt_rows = 0;
  const long long rows = n_rows > alt_rows ? n_rows : alt_rows;
  const long long work = rows * (long long)octets;
  if (work <= 0) return (int)cudaSuccess;
  long long blocks = 0;
  err = resident_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  const long long wanted = (work + kThreads - 1) / kThreads;
  if (wanted < blocks) blocks = wanted;
  scatter_add_rows_bf16x8<<<(unsigned int)blocks, kThreads, 0, s>>>(
      (const int32_t*)idx, (const float4*)src, n_rows, (const int64_t*)row_count,
      (const int32_t*)alt_idx, (const float4*)alt_src, alt_rows, (const uint8_t*)take_alt,
      (__nv_bfloat16*)out, octets, table_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
