// Leadership ordering on Hopper (sm_90a): the hand-written port of the
// Pallas TPU kernel kafka_assigner_tpu/ops/pallas_leadership.py::_kernel
// (wrapper leadership_order_pallas), which computes the reference's
// computePreferenceLists (KafkaAssignmentStrategy.java:202-302):
//
//   topics in order, partitions in order; for each slot r of a partition
//   with `count` candidates: m = max(count - r, 1), start = jhash % m,
//   rot = (rank of the candidate among the remaining, by broker index,
//   + start) % m; the slot takes the minimum key counters[cand][r]*m + rot
//   and, when r < count, adds one to that counter. Rows with count 0 or a
//   partial count write -1 in their empty slots.
//
// What bounds it: not bytes (about 6 MB at the 200k-partition config, a few
// microseconds at 3.35 TB/s) but the dependent chain — every slot reads the
// counter the previous slot may have written, across partitions and topics.
// So the design keeps that chain as short as the card allows:
//   - ONE warp walks the whole batch in ONE launch (the Pallas grid's
//     sequential blocks and the per-topic scan become one loop);
//   - one lane per candidate (RF <= 32): the rank is RF warp shuffles, the
//     argmin is __reduce_min_sync plus a ballot for the first lane holding
//     the minimum (the reference's lowest-index tie-break), and lane 0 does
//     the counter read-modify-write;
//   - the (N_pad, RF) int32 counter slab lives in shared memory (dynamic,
//     opted in above 48 KB); a slab over the opt-in limit uses a
//     global-memory variant of the same kernel (template argument);
//   - the next row's candidates and count are loaded before the current row
//     is ordered, so their global-memory latency leaves the chain.
//
// Indices follow the JAX reference: a gather index is clamped into the slab
// and an out-of-range counter update is dropped.
//
// Plain C interface (loaded with ctypes); the wrapper in ops/leadership.py
// allocates every output and checks shapes and types.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

template <bool kSharedSlab>
__global__ void __launch_bounds__(32, 1) leadership_kernel(
    const int* __restrict__ cand,     // (B, P, RF)
    const int* __restrict__ count,    // (B, P)
    const int* __restrict__ jhashes,  // (B,)
    int* counters,                    // (N_pad, RF), updated in place
    int* __restrict__ ordered,        // (B, P, RF)
    int b, int p, int rf, int n_pad) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const int slab_len = n_pad * rf;
  int* slab = kSharedSlab ? smem : counters;
  if (kSharedSlab) {
    for (int i = lane; i < slab_len; i += 32) slab[i] = counters[i];
    __syncwarp();
  }

  const long long rows = (long long)b * p;
  int next_cnt = rows > 0 ? count[0] : 0;
  int next_c = (rows > 0 && lane < rf) ? cand[lane] : 0;
  int topic = 0, in_topic = 0;
  for (long long row = 0; row < rows; ++row) {
    const int cnt_row = next_cnt;
    const int c = next_c;
    if (row + 1 < rows) {  // prefetch the next row off the chain
      next_cnt = count[row + 1];
      next_c = lane < rf ? cand[(row + 1) * rf + lane] : 0;
    }
    const int jh = jhashes[topic];
    const int gather_row = min(max(c, 0), n_pad - 1);
    bool remaining = lane < rf && lane < cnt_row;

    for (int r = 0; r < rf; ++r) {
      const int m = max(cnt_row - r, 1);
      const int start = jh % m;
      // Rank among the remaining candidates, by broker index ascending.
      const unsigned rem = __ballot_sync(kFull, remaining);
      int k = 0;
      for (int j = 0; j < rf; ++j) {
        const int cj = __shfl_sync(kFull, c, j);
        k += (int)(((rem >> j) & 1u) && cj < c);
      }
      int key = kBig;
      if (remaining) key = slab[gather_row * rf + r] * m + (k + start) % m;
      // Keys are >= 0, so the unsigned minimum is the signed one.
      const unsigned min_key = __reduce_min_sync(kFull, (unsigned)key);
      const int choice =
          __ffs(__ballot_sync(kFull, (unsigned)key == min_key)) - 1;
      const int chosen = __shfl_sync(kFull, c, choice);
      if (lane == 0) {
        const bool valid = r < cnt_row;
        ordered[row * rf + r] = valid ? chosen : -1;
        if (valid && chosen < n_pad) slab[max(chosen, 0) * rf + r] += 1;
      }
      __syncwarp();  // lane 0's counter write is visible to the next slot
      remaining = remaining && lane != choice;
    }
    if (++in_topic == p) {
      in_topic = 0;
      ++topic;
    }
  }

  if (kSharedSlab) {
    __syncwarp();
    for (int i = lane; i < slab_len; i += 32) counters[i] = slab[i];
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on the current device.
int ka_smem_optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// One launch orders the whole batch. `counters` holds the slab before the
// call and after it. Returns the launch's cudaError_t (0 on success).
int ka_leadership_order(const int* cand, const int* count, const int* jhashes,
                        int* counters, int* ordered, int b, int p, int rf,
                        int n_pad, int use_global_slab, void* stream) {
  if (rf < 1 || rf > 32 || n_pad < 1 || b < 0 || p < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_global_slab) {
    leadership_kernel<false><<<1, 32, 0, s>>>(cand, count, jhashes, counters,
                                              ordered, b, p, rf, n_pad);
  } else {
    const int bytes = n_pad * rf * (int)sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        leadership_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    leadership_kernel<true><<<1, 32, bytes, s>>>(cand, count, jhashes, counters,
                                                 ordered, b, p, rf, n_pad);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
