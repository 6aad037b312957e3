// Frame-ring gathers for Hopper (sm_90a).
//
//   apex_gather_rows:   out[i, :] = frames[ids[i], :]
//   apex_gather_stacks: out[n, p, s, c] = frames[ids[n, s], p * C + c]
//                       (the (N, H, W, S*C) frame stacks the learner reads,
//                       oldest frame first; P = H*W pixels of C channels)
//
// Replaces the TPU kernel apex_tpu/ops/gather.py:_pallas_gather (body
// _gather_kernel), which streamed one ring row per grid step through
// Mosaic's pipeline with the ids scalar-prefetched into SMEM, together
// with the moveaxis/reshape that apex_tpu/replay/frame_pool.py:
// _gather_stacks applied to its rows.
//
// DESIGN NOTE
//
// Bound: device-memory bytes.  Both functions are copies: each gathered
// row is read once and written once, plus 4 bytes of id per row.  The
// learner step gathers obs and next_obs in one call: ids [1024, 4] over a
// 2^20-row ring of 7056-byte (84x84 u8) rows, 57 819 136 B in all, which is
// 0.01726 ms at an H100 SXM's published 3.35 TB/s.  chip_smoke.py computes
// the bound for the card it runs on.
//
// What held the first version (one 128-thread block per row, 16-byte
// register copies, one gather_rows call each for obs and next_obs) back,
// as measured on an NVIDIA H100 80GB HBM3 at 700 W (ncu does not run
// there; the times come from chip_smoke.py, whose --parent option times
// an earlier checkout's gather_rows beside this one; PERF.md has them):
// 1. Two dependent DRAM round trips per row (its id, then its row) in 2048
//    one-shot blocks.  Not what kept it behind index_select: with the L2
//    cache flushed before every timed call the first kernel and
//    index_select take about the same time at N = 2048.  The gap measured
//    before came from the order of the timed calls.  This
//    design still removes the dependency: a persistent grid (SM count x
//    resident CTAs per SM, from the device's attributes and the occupancy
//    calculator) gives each CTA a contiguous range of rows or samples; the
//    CTA stages all its ids in shared memory with one coalesced load; then
//    one thread keeps the rows in flight through the Tensor Memory
//    Accelerator, a 1-D bulk copy (cp.async.bulk, global -> shared) per
//    row into a ring of stages, completion counted in bytes on one
//    mbarrier per stage.
// 2. A second pass over the batch's bytes.  The movedim/reshape after the
//    gather was a view for one-channel frames, not a copy.  The second pass
//    was the loss's torch.cat of obs and next_obs (28.9 MB read and
//    written, about 115 us of each step on the card).  gather_stacks writes
//    the contiguous (N, H, W, S*C) batch itself, obs and next_obs as the
//    two halves of one tensor, and the loss reads that tensor without a
//    cat.  The stack is interleaved in shared memory: a stage holds the S
//    rows of one sample.  For u8 frames with C = 1 and S = 4 each thread
//    reads one 32-bit word (4 pixels) from each of the 4 rows (consecutive
//    words across the warp: no bank conflicts), transposes the 4x4 bytes
//    with __byte_perm and writes the 16 bytes of (pixel, stack) with one
//    st.global.  Other channel widths interleave 4- or 1-byte elements.
// 3. Two launches per step.  The replay concatenates the obs and next_obs
//    id tables and calls gather_stacks once.
//
// Result at the step's shape, ids [1024, 4], on an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py; PERF.md has the runs): 0.0225 ms, 0.77 of the
// bound, against 0.087 ms for index_select plus the re-layout copy.
// gather_rows alone, at N = 2048, takes 0.0145 ms against 0.0132 ms for
// index_select and 0.0133 ms for the first kernel; at N = 4096 it is level
// with index_select and 6% behind the first kernel.  The cost is in the
// bulk copy's path through shared memory: a row passes the staged ids, a
// barrier, the whole row's bulk copy and its wait before its first store,
// and at 2048 rows, one wave of short-lived CTAs, that latency is not
// hidden.  No caller of gather_rows is on the learner's path.
//
// The bytes leave shared memory through 16-byte st.global by all threads
// of the CTA.  Bulk shared -> global stores driven by one thread were
// tried and were slower for rows and no faster for stacks, where they also
// need an interleaved staging buffer.
//
// Stages and CTAs: a step's 1024 samples over 132 SMs are about 8 samples
// (32 rows, 226 KB) per SM.  kStages = 4 stages of one sample (113 KB) per
// CTA lets two CTAs reside on an SM (228 KB of shared memory), and puts
// every one of a CTA's 4 samples in flight at launch: more stages would
// sit empty at this shape, fewer would queue a CTA's last samples behind
// its first.  Builds with 2, 3 or 6 stages, 128 or 512 threads, or one CTA
// per SM timed within the spread of this one.  The grid is the SM count
// times the resident CTAs the occupancy calculator allows; both, and the
// opt-in shared memory, are read once per device and stage size.
//
// Rows that bulk copies cannot take (row bytes not a multiple of 16, a
// ring or output base that is not 16-byte aligned, a stage larger than
// shared memory) go through register paths picked from the alignment:
// 4-byte words where the row (gather_rows) or the channel group
// (gather_stacks) and both base pointers are 4-byte aligned, else bytes.
//
// An id outside [0, n_rows) traps: the launch fails at the next
// synchronisation instead of reading memory outside the ring.  Checking
// the ids on the host would cost a device-to-host copy per call.
//
// C ABI for ctypes: each entry point returns cudaGetLastError() after its
// launch; the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kRegThreads = 128;        // register paths
constexpr int kUnroll = 4;
constexpr int kThreads = 256;           // bulk path
constexpr int kStages = 4;              // most stages per bulk CTA
constexpr int kMaxIds = 1024;           // most ids one CTA stages
constexpr int64_t kMaxTx = (1 << 20) - 1;   // mbarrier transaction bytes
constexpr int kMaxDevices = 64;

// -- PTX: mbarriers and 1-D bulk copies -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` (a multiple of 16) counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copy `count` ids into shared memory (one coalesced pass), trapping on an
// id outside the ring.
__device__ __forceinline__ void stage_ids(const int32_t* __restrict__ ids,
                                          int32_t* sid, int count,
                                          int64_t n_rows) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int32_t id = __ldg(ids + i);
    if (id < 0 || id >= n_rows) __trap();
    sid[i] = id;
  }
}

// -- bulk path ----------------------------------------------------------------

// How a stage of S staged rows becomes the sample's output bytes.
enum Layout {
  kCopy = 0,     // rows back to back already: gather_rows, S = 1, vectors
  kU8x4 = 1,     // u8, C = 1, S = 4: 4x4 byte transpose
  kWords = 2,    // interleave 4-byte elements
  kBytes = 3,    // interleave bytes
};

// Interleave one sample from its S staged rows (row r at src + r*row_bytes)
// into (pixel, stack, channel) order, element type V.
template <typename V>
__device__ __forceinline__ void interleave(const uint8_t* src, uint8_t* dst,
                                           int s, uint32_t row_bytes,
                                           uint32_t chan_bytes) {
  const V* in = reinterpret_cast<const V*>(src);
  V* o = reinterpret_cast<V*>(dst);
  const uint32_t cu = chan_bytes / sizeof(V);
  const uint32_t row_units = row_bytes / sizeof(V);
  const uint32_t group = s * cu;
  const uint32_t total = s * row_units;
  for (uint32_t e = threadIdx.x; e < total; e += blockDim.x) {
    const uint32_t p = e / group;
    const uint32_t r = e - p * group;
    const uint32_t st = r / cu;
    o[e] = in[st * row_units + p * cu + (r - st * cu)];
  }
}

// u8, C = 1, S = 4: word q of the 4 rows holds pixels 4q..4q+3 of each
// frame; the output's 16 bytes at 16q are those pixels' 4-frame stacks.
__device__ __forceinline__ void interleave_u8x4(const uint8_t* src,
                                                uint8_t* dst,
                                                uint32_t row_bytes) {
  const uint32_t words = row_bytes / 4;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(src);
  uint4* o = reinterpret_cast<uint4*>(dst);
  for (uint32_t q = threadIdx.x; q < words; q += blockDim.x) {
    const uint32_t a = w[q], b = w[q + words];
    const uint32_t c = w[q + 2 * words], d = w[q + 3 * words];
    const uint32_t ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
    const uint32_t ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
    const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
    const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
    o[q] = make_uint4(__byte_perm(ab_lo, cd_lo, 0x5410),   // a0 b0 c0 d0
                      __byte_perm(ab_lo, cd_lo, 0x7632),   // a1 b1 c1 d1
                      __byte_perm(ab_hi, cd_hi, 0x5410),
                      __byte_perm(ab_hi, cd_hi, 0x7632));
  }
}

template <int kLayout>
__device__ __forceinline__ void write_sample(const uint8_t* src, uint8_t* dst,
                                             int s, uint32_t row_bytes,
                                             uint32_t chan_bytes) {
  if (kLayout == kCopy) {
    const uint4* w = reinterpret_cast<const uint4*>(src);
    uint4* o = reinterpret_cast<uint4*>(dst);
    for (uint32_t q = threadIdx.x; q < s * row_bytes / 16; q += blockDim.x) {
      o[q] = w[q];
    }
  } else if (kLayout == kU8x4) {
    interleave_u8x4(src, dst, row_bytes);
  } else if (kLayout == kWords) {
    interleave<uint32_t>(src, dst, s, row_bytes, chan_bytes);
  } else {
    interleave<uint8_t>(src, dst, s, row_bytes, chan_bytes);
  }
}

// Persistent CTA over samples [first, first + count) of S rows each.
// Shared memory: `stages` stages of S rows, one mbarrier per stage, the
// staged ids.  Thread 0 issues the bulk loads; the stage of sample j is
// refilled with sample j + stages once every thread is done with it.
template <int kLayout>
__global__ void __launch_bounds__(kThreads)
bulk_kernel(const uint8_t* __restrict__ frames,
            const int32_t* __restrict__ ids, uint8_t* __restrict__ out,
            int64_t n, int s, int64_t n_rows, uint32_t row_bytes,
            uint32_t chan_bytes, int stages, int per_cta) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t stage_bytes = s * row_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + int64_t(stages) *
                                                         stage_bytes);
  int32_t* sid = reinterpret_cast<int32_t*>(bar + stages);
  const int64_t first = int64_t(blockIdx.x) * per_cta;
  const int count = static_cast<int>(n - first < per_cta ? n - first : per_cta);
  if (count <= 0) return;
  stage_ids(ids + first * s, sid, count * s, n_rows);
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto load = [&](int j) {
    const int k = j % stages;
    uint8_t* dst = smem + int64_t(k) * stage_bytes;
    mbar_expect_tx(bar + k, stage_bytes);
    for (int r = 0; r < s; ++r) {
      bulk_load(dst + int64_t(r) * row_bytes,
                frames + int64_t(sid[j * s + r]) * row_bytes, row_bytes,
                bar + k);
    }
  };
  if (threadIdx.x == 0) {
    for (int j = 0; j < count && j < stages; ++j) load(j);
  }
  for (int j = 0; j < count; ++j) {
    const int k = j % stages;
    mbar_wait(bar + k, (j / stages) & 1);
    write_sample<kLayout>(smem + int64_t(k) * stage_bytes,
                          out + (first + j) * int64_t(stage_bytes), s,
                          row_bytes, chan_bytes);
    __syncthreads();                   // every thread is done with stage k
    if (threadIdx.x == 0 && j + stages < count) load(j + stages);
  }
}

// -- register paths -----------------------------------------------------------

template <typename V>
__global__ void __launch_bounds__(kRegThreads)
rows_reg_kernel(const V* __restrict__ frames, const int32_t* __restrict__ ids,
                V* __restrict__ out, int64_t n_rows, int64_t row_elems) {
  const int64_t row = blockIdx.x;
  const int64_t src = static_cast<int64_t>(__ldg(ids + row));
  if (src < 0 || src >= n_rows) __trap();
  const V* in_row = frames + src * row_elems;
  V* out_row = out + row * row_elems;
  for (int64_t base = threadIdx.x; base < row_elems;
       base += kRegThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * kRegThreads;
      if (j < row_elems) v[u] = __ldg(in_row + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * kRegThreads;
      if (j < row_elems) out_row[j] = v[u];
    }
  }
}

// One block per sample; element type V (a 4-byte word or a byte).
template <typename V>
__global__ void __launch_bounds__(kRegThreads)
stacks_reg_kernel(const V* __restrict__ frames,
                  const int32_t* __restrict__ ids, V* __restrict__ out,
                  int s, int64_t n_rows, int64_t row_units, int64_t cu) {
  extern __shared__ int32_t sid_reg[];
  const int64_t sample = blockIdx.x;
  stage_ids(ids + sample * s, sid_reg, s, n_rows);
  __syncthreads();
  const int64_t group = s * cu;
  const int64_t total = s * row_units;
  V* o = out + sample * total;
  for (int64_t e = threadIdx.x; e < total; e += kRegThreads) {
    const int64_t p = e / group;
    const int64_t r = e - p * group;
    const int64_t st = r / cu;
    o[e] = __ldg(frames + int64_t(sid_reg[st]) * row_units + p * cu +
                 (r - st * cu));
  }
}

// -- host side ---------------------------------------------------------------

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

struct DeviceInfo {
  int sms = 0;        // streaming multiprocessors
  int smem_max = 0;   // opt-in dynamic shared memory per block
};

// The attributes of device `dev`, read once.
cudaError_t device_info(int dev, DeviceInfo* info) {
  static std::mutex mu;
  static DeviceInfo cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& d = cache[dev];
  if (d.sms == 0) {
    DeviceInfo got;
    cudaError_t err = cudaDeviceGetAttribute(
        &got.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&got.smem_max,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    d = got;
  }
  *info = d;
  return cudaSuccess;
}

// How many CTAs of bulk_kernel<kLayout> with `smem` bytes of dynamic
// shared memory reside on one SM of device `dev`: computed once per
// (device, smem), when the kernel is first allowed that much.
template <int kLayout>
cudaError_t resident_ctas(int dev, size_t smem, int* resident) {
  struct Seen {
    int dev;
    size_t smem;
    int resident;
  };
  constexpr int kSeen = 32;
  static std::mutex mu;
  static size_t allowed[kMaxDevices];   // the kernel's smem limit per device
  static Seen seen[kSeen];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  const int cached = n_seen < kSeen ? n_seen : kSeen;
  for (int i = 0; i < cached; ++i) {
    if (seen[i].dev == dev && seen[i].smem == smem) {
      *resident = seen[i].resident;
      return cudaSuccess;
    }
  }
  auto kernel = bulk_kernel<kLayout>;
  cudaError_t err;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  seen[n_seen++ % kSeen] = Seen{dev, smem, *resident};
  return cudaSuccess;
}

// Bulk launch over n samples of s rows: returns cudaErrorNotSupported, and
// launches nothing, when the rows or bases are not 16-byte aligned or a
// stage does not fit in shared memory.
template <int kLayout>
cudaError_t launch_bulk(const void* frames, const int32_t* ids, void* out,
                        int64_t n, int s, int64_t n_rows, int64_t row_bytes,
                        int64_t chan_bytes, cudaStream_t stream) {
  const int64_t stage_bytes = s * row_bytes;
  if (row_bytes % 16 != 0 || !aligned(frames, 16) || !aligned(out, 16) ||
      stage_bytes > kMaxTx || s > kMaxIds) {
    return cudaErrorNotSupported;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  DeviceInfo card;
  if (err == cudaSuccess) err = device_info(dev, &card);
  if (err != cudaSuccess) return err;
  // ids for what one CTA per SM would take; a larger grid needs no more
  int64_t ids_cap = (n + card.sms - 1) / card.sms;
  if (ids_cap > kMaxIds / s) ids_cap = kMaxIds / s;
  const int64_t ids_bytes = (ids_cap * s * 4 + 15) / 16 * 16;
  int64_t stages = (card.smem_max - ids_bytes - 8 * kStages) / stage_bytes;
  if (stages > kStages) stages = kStages;
  if (stages < 1) return cudaErrorNotSupported;
  const size_t smem = stages * (stage_bytes + 8) + ids_bytes;

  int resident = 0;
  err = resident_ctas<kLayout>(dev, smem, &resident);
  if (err != cudaSuccess) return err;
  if (resident == 0) return cudaErrorNotSupported;
  const int64_t ctas = int64_t(card.sms) * resident;
  int64_t per_cta = (n + ctas - 1) / ctas;
  if (per_cta > ids_cap) per_cta = ids_cap;
  const int64_t grid = (n + per_cta - 1) / per_cta;
  bulk_kernel<kLayout><<<static_cast<unsigned int>(grid), kThreads, smem,
                         stream>>>(
      static_cast<const uint8_t*>(frames), ids, static_cast<uint8_t*>(out),
      n, s, n_rows, static_cast<uint32_t>(row_bytes),
      static_cast<uint32_t>(chan_bytes), static_cast<int>(stages),
      static_cast<int>(per_cta));
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_rows_reg(const void* frames, const int32_t* ids, void* out,
                            int64_t n, int64_t n_rows, int64_t row_bytes,
                            cudaStream_t stream) {
  rows_reg_kernel<V><<<static_cast<unsigned int>(n), kRegThreads, 0,
                       stream>>>(
      static_cast<const V*>(frames), ids, static_cast<V*>(out), n_rows,
      row_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

// n samples of s rows back to back (s = 1: a row gather)
cudaError_t gather_copy(const void* frames, const int32_t* ids, void* out,
                        int64_t n, int s, int64_t n_rows, int64_t row_bytes,
                        cudaStream_t stream) {
  const cudaError_t err = launch_bulk<kCopy>(frames, ids, out, n, s, n_rows,
                                             row_bytes, row_bytes, stream);
  if (err != cudaErrorNotSupported) return err;
  if (row_bytes % 4 == 0 && aligned(frames, 4) && aligned(out, 4)) {
    return launch_rows_reg<uint32_t>(frames, ids, out, n * s, n_rows,
                                     row_bytes, stream);
  }
  return launch_rows_reg<uint8_t>(frames, ids, out, n * s, n_rows, row_bytes,
                                  stream);
}

template <typename V>
cudaError_t launch_stacks_reg(const void* frames, const int32_t* ids,
                              void* out, int64_t n, int s, int64_t n_rows,
                              int64_t row_bytes, int64_t chan_bytes,
                              cudaStream_t stream) {
  const int64_t v = sizeof(V);
  stacks_reg_kernel<V><<<static_cast<unsigned int>(n), kRegThreads,
                         s * sizeof(int32_t), stream>>>(
      static_cast<const V*>(frames), ids, static_cast<V*>(out), s, n_rows,
      row_bytes / v, chan_bytes / v);
  return cudaGetLastError();
}

}  // namespace

extern "C" int apex_gather_rows(const void* frames, const void* ids, void* out,
                                int64_t n, int64_t n_rows, int64_t row_bytes,
                                void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gather_copy(frames, static_cast<const int32_t*>(ids),
                                      out, n, 1, n_rows, row_bytes,
                                      static_cast<cudaStream_t>(stream)));
}

// ids [n, s]; each frame is `pixels` pixels of `chan_bytes` bytes.
extern "C" int apex_gather_stacks(const void* frames, const void* ids,
                                  void* out, int64_t n, int64_t s,
                                  int64_t n_rows, int64_t pixels,
                                  int64_t chan_bytes, void* stream) {
  const int64_t row_bytes = pixels * chan_bytes;
  if (n <= 0 || s <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  if (n * s > 0x7fffffffLL || s > kMaxIds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* id = static_cast<const int32_t*>(ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int si = static_cast<int>(s);
  // one frame per sample, or one pixel per frame: a sample's stack is its
  // rows back to back
  if (s == 1 || pixels == 1) {
    return static_cast<int>(
        gather_copy(frames, id, out, n, si, n_rows, row_bytes, st));
  }
  cudaError_t err;
  if (chan_bytes == 1 && s == 4) {
    err = launch_bulk<kU8x4>(frames, id, out, n, si, n_rows, row_bytes,
                             chan_bytes, st);
  } else if (chan_bytes % 4 == 0) {
    err = launch_bulk<kWords>(frames, id, out, n, si, n_rows, row_bytes,
                              chan_bytes, st);
  } else {
    err = launch_bulk<kBytes>(frames, id, out, n, si, n_rows, row_bytes,
                              chan_bytes, st);
  }
  if (err != cudaErrorNotSupported) return static_cast<int>(err);
  if (chan_bytes % 4 == 0 && aligned(frames, 4) && aligned(out, 4)) {
    return static_cast<int>(launch_stacks_reg<uint32_t>(
        frames, id, out, n, si, n_rows, row_bytes, chan_bytes, st));
  }
  return static_cast<int>(launch_stacks_reg<uint8_t>(
      frames, id, out, n, si, n_rows, row_bytes, chan_bytes, st));
}
