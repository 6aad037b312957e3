// Frame-ring row gather for Hopper (sm_90a): out[i, :] = frames[ids[i], :].
//
// Replaces the TPU kernel apex_tpu/ops/gather.py:_pallas_gather (body
// _gather_kernel), which streamed one ring row per grid step through
// Mosaic's pipeline with the ids scalar-prefetched into SMEM.
//
// Bound: device-memory bytes.  The work is a pure copy, N * row_bytes read
// and N * row_bytes written (plus 4 bytes of id per row).  On the learner's
// main path (B = 512, stack 4, 84x84 u8 rows of 7056 B) each call moves
// 2048 rows: 14.4 MB in, 14.4 MB out, two calls per step (obs, next_obs),
// so 28.9 MB read + 28.9 MB written per step: about 17 us at an H100 SXM's
// published 3.35 TB/s.  chip_smoke.py computes the bound from the card it
// runs on and prints it beside the measured time.
//
// Design: one block per output row.  Each block loads its own id (in place
// of the TPU's scalar prefetch) and its threads copy the row with the
// widest access the row allows: 16-byte vectors when the row's bytes and
// both base pointers are 16-byte aligned (7056 = 16 * 441), else 4-byte
// words (for example 42 * 42 = 1764-byte rows, and f32 rows), else single
// bytes.  Neighbouring threads touch neighbouring addresses, so every warp
// access is coalesced.  Each thread issues kUnroll loads through the
// read-only path (__ldg) before its first store, so a 7056-byte row is one
// round of 4 loads in flight per thread (128 * 4 * 16 B >= 7056 B) rather
// than four dependent load-store trips.
//
// An id outside [0, n_rows) traps: the launch fails at the next
// synchronisation instead of reading memory outside the ring.  Checking the
// ids on the host would cost a device-to-host copy per call.
//
// C ABI for ctypes: the function returns cudaGetLastError() after the
// launch; the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ frames, const int32_t* __restrict__ ids,
                   V* __restrict__ out, int64_t n_rows, int64_t row_elems) {
  const int64_t row = blockIdx.x;
  const int64_t src = static_cast<int64_t>(__ldg(ids + row));
  if (src < 0 || src >= n_rows) __trap();
  const V* in_row = frames + src * row_elems;
  V* out_row = out + row * row_elems;
  for (int64_t base = threadIdx.x; base < row_elems;
       base += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * kThreads;
      if (j < row_elems) v[u] = __ldg(in_row + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * kThreads;
      if (j < row_elems) out_row[j] = v[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* frames, const int32_t* ids, void* out,
                   int64_t n, int64_t n_rows, int64_t row_bytes,
                   cudaStream_t stream) {
  gather_rows_kernel<V><<<static_cast<unsigned int>(n), kThreads, 0, stream>>>(
      static_cast<const V*>(frames), ids, static_cast<V*>(out), n_rows,
      row_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

}  // namespace

extern "C" int apex_gather_rows(const void* frames, const void* ids, void* out,
                                int64_t n, int64_t n_rows, int64_t row_bytes,
                                void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* id = static_cast<const int32_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && aligned(frames, 16) && aligned(out, 16)) {
    return static_cast<int>(launch<uint4>(frames, id, out, n, n_rows, row_bytes, s));
  }
  if (row_bytes % 4 == 0 && aligned(frames, 4) && aligned(out, 4)) {
    return static_cast<int>(launch<uint32_t>(frames, id, out, n, n_rows, row_bytes, s));
  }
  return static_cast<int>(launch<uint8_t>(frames, id, out, n, n_rows, row_bytes, s));
}
