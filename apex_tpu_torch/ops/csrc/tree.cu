// Prioritized replay's segment-tree update for Hopper (sm_90a).
//
//   apex_tree_update: sum[C + idx[i]] = min[C + idx[i]] = values[i] for
//                     i < K, then every ancestor of those leaves,
//                     sum[p] = sum[2p] + sum[2p+1] and
//                     min[p] = minimum(min[2p], min[2p+1]), level by level
//                     up to the root (node 1)
//
// Replaces no TPU kernel: the JAX package updates its trees with plain jnp
// scatters and gathers that XLA fuses into one program with the rest of
// the learner step.  Run eagerly, the same loop
// (apex_tpu_torch/ops/tree.py:_propagate) costs about 8 launches a level,
// 16 levels at a capacity of 2^16, about 130 launches a tree and 260 an
// update of both trees; the learner step makes two such updates (ingest
// and priority write-back), about 45% of its launches.  This kernel makes
// each update one launch.
//
// DESIGN NOTE
//
// Bound: latency.  At the learner's shapes (K = 64 leaves at ingest, 512
// at the priority write-back, capacity 2^16) the kernel moves a few tens
// of kilobytes, far under a microsecond of device-memory time.  What it
// waits on is the chain of depth = log2(C) dependent levels: a level reads
// the children its predecessor wrote, so each level costs one round trip
// to L1/L2 for the children, the add or minimum, the store and a barrier.
//
// One block.  The levels must run in order over every leaf, which needs a
// barrier between levels across all threads that touch them.  Inside one
// block that is __syncthreads(), whose ordering covers global memory for
// the block's threads: a store before it is visible to every load after
// it.  Across blocks it would take a grid-wide sync (cooperative launch)
// or one launch per level, the cost this kernel removes.  One block of up
// to 1024 threads takes a whole write-back (K = 512) in one pass; a larger
// K grid-strides, each thread taking leaves i, i + blockDim, ... at every
// level, so any K works.  A level's 2-4 loads per thread are issued
// before its stores (the sum and min trees are not declared disjoint, so
// the compiler would otherwise keep a store of one tree ahead of the loads
// of the other).
//
// Duplicates.  The invariant of ops/tree.py holds here too: duplicate
// indices carry equal values (pad rows of a chunk repeat the last real row
// with its priority; a transition sampled twice gets one priority per
// batch row from the same inputs).  Two threads that share a leaf write the
// same value, and two that share a parent at some level recompute it from
// the same finished children after the same barrier and write the same
// value.  The races are benign, as the loop's duplicate scatters are.
//
// Bit-exact with the loop.  A sum is one float add of the two children,
// rounded to nearest (__fadd_rn, never contracted into an FMA).  The
// minimum is torch.minimum's on the card: NaN (0x7fc00000) if either child
// is NaN, else fminf, which is what ::min(float, float) is in device code.
// Leaves hold the float32 values the wrapper passes in; the priority's
// power and the max-priority update stay in torch.  Every parent is a pure
// function of its children, so the trees equal the loop's bit for bit
// whatever the order in which the threads run.
//
// Indices are int32 or int64 as given (no host-side widening copy).  An
// index outside [0, C) traps: the launch fails at the next synchronisation
// instead of writing outside the tree, as the torch scatter's device
// assert does.  A null tree pointer skips that tree (update_sum and
// update_min alone).
//
// Measured at capacity 2^16, both trees, on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py's kernel phase, and torch.profiler for the warm
// figures; PERF.md's kernel table):
//   K = 64 (an ingest):  0.0125-0.0416 ms with the L2 flushed before each
//     launch, 5.2-5.4 us warm; the loop it replaces, 262 launches,
//     0.61 ms of device time flushed (0.36 warm) and 2.9-3.7 ms of host
//     time a call.
//   K = 512 (a write-back): 0.0195-0.0200 ms flushed, 13.4-13.6 us warm;
//     the loop 0.80 ms of device time flushed (0.55 warm), 2.4-3.9 ms of
//     host time.
// The wrapper's host time is 24-42 us a call.  The bytes bound (inputs
// read once, distinct nodes written once, at 3.35 TB/s) is under 12 ns:
// the kernel's time is its 17 dependent steps (the leaves and 16 levels),
// warm about 0.3 us a step at K = 64 and 0.8 us at K = 512.
//
// C ABI for ctypes: the entry point returns cudaGetLastError() after its
// launch; the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// torch.minimum for float on the card
__device__ __forceinline__ float torch_minimum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

template <typename Index>
__global__ void __launch_bounds__(kMaxThreads)
tree_update_kernel(float* sum_tree, float* min_tree,
                   const Index* __restrict__ idx,
                   const float* __restrict__ values, int64_t k,
                   int64_t capacity, int depth) {
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
    const int64_t leaf = static_cast<int64_t>(idx[i]);
    if (leaf < 0 || leaf >= capacity) __trap();
    const float v = values[i];
    if (sum_tree) sum_tree[capacity + leaf] = v;
    if (min_tree) min_tree[capacity + leaf] = v;
  }
  for (int level = 1; level <= depth; ++level) {
    __syncthreads();                    // the level below is finished
    for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
      const int64_t p = (capacity + static_cast<int64_t>(idx[i])) >> level;
      float s0 = 0.f, s1 = 0.f, m0 = 0.f, m1 = 0.f;
      if (sum_tree) { s0 = sum_tree[2 * p]; s1 = sum_tree[2 * p + 1]; }
      if (min_tree) { m0 = min_tree[2 * p]; m1 = min_tree[2 * p + 1]; }
      if (sum_tree) sum_tree[p] = __fadd_rn(s0, s1);
      if (min_tree) min_tree[p] = torch_minimum(m0, m1);
    }
  }
}

}  // namespace

extern "C" int apex_tree_update(float* sum_tree, float* min_tree,
                                const void* idx, int64_t idx_bytes,
                                const float* values, int64_t k,
                                int64_t capacity, int64_t depth,
                                cudaStream_t stream) {
  if (k <= 0 || capacity <= 0 || depth < 0 || (!sum_tree && !min_tree)) {
    return cudaErrorInvalidValue;
  }
  const int threads = static_cast<int>(
      k >= kMaxThreads ? kMaxThreads : (k + 31) / 32 * 32);
  const int d = static_cast<int>(depth);
  if (idx_bytes == 8) {
    tree_update_kernel<int64_t><<<1, threads, 0, stream>>>(
        sum_tree, min_tree, static_cast<const int64_t*>(idx), values, k,
        capacity, d);
  } else if (idx_bytes == 4) {
    tree_update_kernel<int32_t><<<1, threads, 0, stream>>>(
        sum_tree, min_tree, static_cast<const int32_t*>(idx), values, k,
        capacity, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
